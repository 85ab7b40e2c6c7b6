"""Concolic strategy: follow a recorded trace, flip chosen branches.

Reference parity: mythril/laser/ethereum/strategy/concolic.py:21-133 — the
strategy walks states along a recorded (pc, tx_id) trace; at each requested
JUMPI address it negates the last path constraint and solves for inputs that
flip the branch; halts when every requested branch has been flipped.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Tuple

from mythril_tpu_torch.core.state.annotation import StateAnnotation
from mythril_tpu_torch.core.state.global_state import GlobalState
from mythril_tpu_torch.core.strategy.basic import CriterionSearchStrategy
from mythril_tpu_torch.exceptions import UnsatError
from mythril_tpu_torch.smt import Not

log = logging.getLogger(__name__)


class TraceAnnotation(StateAnnotation):
    """Cumulative (pc, tx_id) trace of this path (reference :21)."""

    def __init__(self, trace=None):
        self.trace: List[Tuple[int, str]] = trace or []

    @property
    def persist_over_calls(self) -> bool:
        return True

    def __copy__(self):
        return TraceAnnotation(list(self.trace))


class ConcolicStrategy(CriterionSearchStrategy):
    def __init__(self, work_list, max_depth, trace, flip_branch_addresses):
        super().__init__(work_list, max_depth)
        self.trace: List[Tuple[int, str]] = trace
        self.flip_branch_addresses: List[int] = flip_branch_addresses
        self.results: Dict[int, Dict] = {}

    def check_completion_criterion(self) -> None:
        if len(self.flip_branch_addresses) == len(self.results):
            self.set_criterion_satisfied()

    def get_strategic_global_state(self) -> GlobalState:
        while self.work_list:
            state = self.work_list.pop()
            annotations = state.get_annotations(TraceAnnotation)
            annotation = annotations[0] if annotations else TraceAnnotation()
            if not annotations:
                state.annotate(annotation)

            instr = state.get_current_instruction()
            tx = state.current_transaction
            annotation.trace.append((instr["address"], tx.id if tx else "?"))

            # does this state still follow the recorded trace?
            if annotation.trace != self.trace[: len(annotation.trace)]:
                # deviated: if the deviation point is a requested flip, solve it
                deviation_addr = annotation.trace[-2][0] if len(annotation.trace) >= 2 else None
                if (
                    deviation_addr in self.flip_branch_addresses
                    and deviation_addr not in self.results
                ):
                    self._solve_flip(state, deviation_addr)
                continue
            return state
        raise StopIteration

    def _solve_flip(self, state: GlobalState, address: int) -> None:
        from mythril_tpu_torch.analysis.solver import get_transaction_sequence

        try:
            self.results[address] = get_transaction_sequence(
                state, state.world_state.constraints
            )
            log.info("flipped branch at %d", address)
        except UnsatError:
            log.info("branch at %d cannot be flipped", address)
            self.results[address] = {}
        self.check_completion_criterion()
