"""Engine telemetry embedded into reports.

Reference parity: mythril/laser/execution_info.py:4-11 — engines expose
``ExecutionInfo`` objects whose ``as_dict`` payloads are merged into the
jsonv2 report meta (mythril/analysis/report.py:319-320).  This build ships
two concrete infos: engine totals and solver statistics.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Dict


class ExecutionInfo(ABC):
    @abstractmethod
    def as_dict(self) -> Dict:
        """Dictionary merged into the report's ``mythril_execution_info``."""


class EngineStatsInfo(ExecutionInfo):
    """Totals from one symbolic-execution run."""

    def __init__(self, laser) -> None:
        self.total_states = laser.total_states
        self.executed_instructions = laser.executed_instruction_count

    def as_dict(self) -> Dict:
        return {
            "total_states": self.total_states,
            "executed_instructions": self.executed_instructions,
        }


class SolverStatsInfo(ExecutionInfo):
    """Snapshot of the process-wide solver counters."""

    def as_dict(self) -> Dict:
        from mythril_tpu_torch.smt.solver import SolverStatistics

        return SolverStatistics().as_dict()


class FrontierStatsInfo(ExecutionInfo):
    """Where device-resident execution stopped and why (parks by opcode
    prioritize the next device handlers; see frontier/stats.py)."""

    def as_dict(self) -> Dict:
        from mythril_tpu_torch.frontier.stats import FrontierStatistics

        return {"frontier": FrontierStatistics().as_dict()}
