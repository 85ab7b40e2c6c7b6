"""Engine telemetry embedded into reports.

Reference parity: mythril/laser/execution_info.py:4-11 — engines expose
``ExecutionInfo`` objects whose ``as_dict`` payloads are merged into the
jsonv2 report meta (mythril/analysis/report.py:319-320).  This build ships
engine totals, solver statistics, the link calibration of the ``auto``
probe backend and the frontier's counters, each in the JAX package's report
shape (its keys and its rounding), so that the two packages' reports
compare field by field.
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

        stats = SolverStatistics()
        return {
            "solver_query_count": stats.query_count,
            "solver_time_s": round(stats.solver_time, 3),
            "probe_hits": stats.probe_hits,
            "cdcl_calls": stats.cdcl_calls,
            # completeness boundary: prune decisions taken on UNKNOWN
            "unknown_as_unsat": stats.unknown_as_unsat,
        }


class CalibrationInfo(ExecutionInfo):
    """Measured dispatch RTT and the break-evens rescaled from it; nothing
    when no decision for the card measured it (a CPU run)."""

    def as_dict(self) -> Dict:
        from mythril_tpu_torch.support.calibration import telemetry

        cal = telemetry()
        return {"calibration": cal} if cal else {}


class FrontierStatsInfo(ExecutionInfo):
    """Where device-resident execution stopped and why (parks by opcode
    prioritize the next device handlers; see frontier/stats.py)."""

    def as_dict(self) -> Dict:
        from mythril_tpu_torch.frontier.stats import FrontierStatistics

        stats = FrontierStatistics().as_dict()
        # the JAX package's keys: the port's two error counters stay out
        return {"frontier": {k: v for k, v in stats.items()
                             if k not in ("replay_errors", "commit_errors")}}
