"""Instruction-coverage plugin + coverage-driven search strategy.

Reference parity: mythril/laser/plugin/plugins/coverage/coverage_plugin.py:47-101
and coverage_strategy.py:6-41.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Tuple

from mythril_tpu_torch.core.state.global_state import GlobalState
from mythril_tpu_torch.core.strategy.basic import BasicSearchStrategy
from mythril_tpu_torch.plugins.interface import LaserPlugin, PluginBuilder

log = logging.getLogger(__name__)


class InstructionCoverage(LaserPlugin):
    """Tracks a per-bytecode coverage bitmap via the execute_state hook."""

    def __init__(self):
        self.coverage: Dict[str, Tuple[int, List[bool]]] = {}
        self.tx_id = 0

    def initialize(self, symbolic_vm) -> None:
        self.coverage = {}
        self.tx_id = 0
        # expose the instance: the device frontier merges its visited-pc
        # bitmap here (it executes instructions without execute_state hooks)
        symbolic_vm.coverage_plugin = self

        def execute_state_hook(global_state: GlobalState):
            code = global_state.environment.code.bytecode.hex()
            if code not in self.coverage:
                total = len(global_state.environment.code.instruction_list)
                self.coverage[code] = (total, [False] * max(total, 1))
            pc = global_state.mstate.pc
            if 0 <= pc < len(self.coverage[code][1]):
                self.coverage[code][1][pc] = True
            else:
                # an out-of-range pc (execution fell off the end of the
                # instruction list, or a corrupt jump) used to be clamped
                # onto the LAST instruction, silently inflating its
                # coverage; count it instead so the anomaly is visible
                from mythril_tpu_torch.observability.exploration import (
                    get_exploration_ledger,
                )

                get_exploration_ledger().record_pc_overflow()

        def stop_sym_exec_hook():
            from mythril_tpu_torch.observability.exploration import (
                get_exploration_ledger,
            )
            from mythril_tpu_torch.support.support_utils import get_code_hash

            led = get_exploration_ledger()
            for code, (total, seen) in self.coverage.items():
                covered = sum(seen)
                pct = 100.0 * covered / total if total else 0.0
                log.info(
                    "Achieved %.2f%% coverage for code: %s...",
                    pct,
                    code[:40],
                )
                # end-of-run coverage also lands in the exploration ledger
                # (per-codehash gauge -> Prometheus / --metrics-out), not
                # just this log line
                led.record_instr(
                    get_code_hash(code), total,
                    [i for i, hit in enumerate(seen) if hit],
                )

        def start_sym_trans_hook():
            self.tx_id += 1

        symbolic_vm.register_laser_hooks("execute_state", execute_state_hook)
        symbolic_vm.register_laser_hooks("stop_sym_exec", stop_sym_exec_hook)
        symbolic_vm.register_laser_hooks("start_sym_trans", start_sym_trans_hook)

    def record_visited(self, code_hex: str, total: int, indices) -> None:
        """Merge externally-observed instruction indices (the device frontier
        executes without per-instruction hooks).  Device execution is
        speculative — forks later proven UNSAT still mark their pcs — so
        frontier coverage may read slightly above strict sat-reachable
        coverage, matching its states-executed accounting."""
        entry = self.coverage.setdefault(code_hex, (total, [False] * max(total, 1)))
        seen = entry[1]
        oob = 0
        for i in indices:
            if 0 <= int(i) < len(seen):
                seen[int(i)] = True
            else:
                oob += 1
        if oob:
            from mythril_tpu_torch.observability.exploration import (
                get_exploration_ledger,
            )

            get_exploration_ledger().record_pc_overflow(oob)

    def get_coverage(self) -> Dict[str, float]:
        return {
            code: (100.0 * sum(seen) / total if total else 0.0)
            for code, (total, seen) in self.coverage.items()
        }


class CoverageStrategy(BasicSearchStrategy):
    """Prefer states whose pc is not yet covered (reference coverage_strategy.py)."""

    def __init__(self, super_strategy: BasicSearchStrategy, coverage_plugin: InstructionCoverage):
        self.super_strategy = super_strategy
        self.coverage_plugin = coverage_plugin
        super().__init__(super_strategy.work_list, super_strategy.max_depth)

    def get_strategic_global_state(self) -> GlobalState:
        for i, state in enumerate(self.work_list):
            if not self._is_covered(state):
                return self.work_list.pop(i)
        return self.super_strategy.get_strategic_global_state()

    def _is_covered(self, global_state: GlobalState) -> bool:
        code = global_state.environment.code.bytecode.hex()
        if code not in self.coverage_plugin.coverage:
            return False
        _, seen = self.coverage_plugin.coverage[code]
        pc = global_state.mstate.pc
        # out-of-range pc: never executed, so never covered — clamping to
        # the last instruction made an OOB state look covered whenever the
        # tail instruction was
        if not 0 <= pc < len(seen):
            return False
        return seen[pc]


class CoveragePluginBuilder(PluginBuilder):
    name = "coverage"

    def __call__(self, *args, **kwargs) -> LaserPlugin:
        return InstructionCoverage()
