"""Loop-bound strategy extension: skip states that loop past the bound.

Reference parity: mythril/laser/ethereum/strategy/extensions/bounded_loops.py:27-143
— per-state JUMPDEST trace annotation, repeating-suffix detection via rolling
hash, creation txs get max(8, bound).
"""

from __future__ import annotations

import logging
from typing import List

from mythril_tpu_torch.core.state.annotation import StateAnnotation
from mythril_tpu_torch.core.state.global_state import GlobalState
from mythril_tpu_torch.core.strategy.basic import BasicSearchStrategy
from mythril_tpu_torch.core.transaction.transaction_models import ContractCreationTransaction

log = logging.getLogger(__name__)


class JumpdestCountAnnotation(StateAnnotation):
    """Trace of (source, destination) jump pairs along this path."""

    def __init__(self):
        self._reached_count = {}
        self.trace: List[int] = []

    def __copy__(self):
        out = JumpdestCountAnnotation()
        out._reached_count = dict(self._reached_count)
        out.trace = list(self.trace)
        return out

    @property
    def persist_over_calls(self) -> bool:
        return False


class BoundedLoopsStrategy(BasicSearchStrategy):
    """Wraps another strategy; drops states whose loop count exceeds the bound."""

    def __init__(self, super_strategy: BasicSearchStrategy, loop_bound: int = 3, **kwargs):
        self.super_strategy = super_strategy
        self.bound = loop_bound
        super().__init__(super_strategy.work_list, super_strategy.max_depth)

    @staticmethod
    def calculate_hash(i: int, j: int, trace: List[int]) -> int:
        """Order-independent hash of trace window [i, j) (reference :50)."""
        key = 0
        size = 0
        for itr in range(i, j):
            key |= trace[itr] << ((itr - i) % 64)
            size += 1
        return key

    @staticmethod
    def count_key(trace: List[int], key: int, start: int, size: int) -> int:
        """Count consecutive repetitions of the suffix cycle (reference :60-83)."""
        count = 1
        i = start
        while i >= 0:
            if BoundedLoopsStrategy.calculate_hash(i, i + size, trace) != key:
                break
            count += 1
            i -= size
        return count

    @staticmethod
    def get_loop_count(trace: List[int]) -> int:
        """Longest-suffix-cycle repetition count (reference :85-103)."""
        found = False
        for i in range(len(trace) - 3, 0, -1):
            if trace[i] == trace[-2] and trace[i + 1] == trace[-1]:
                found = True
                break
        if found:
            key = BoundedLoopsStrategy.calculate_hash(i + 1, len(trace) - 1, trace)
            size = len(trace) - i - 2
            if size == 0:
                return 0
            return BoundedLoopsStrategy.count_key(trace, key, i + 1 - size, size)
        return 0

    def get_strategic_global_state(self) -> GlobalState:
        while True:
            state = self.super_strategy.get_strategic_global_state()
            annotations = state.get_annotations(JumpdestCountAnnotation)
            if not annotations:
                annotation = JumpdestCountAnnotation()
                state.annotate(annotation)
            else:
                annotation = annotations[0]

            cur_instr = state.get_current_instruction()
            annotation.trace.append(cur_instr["address"])

            if len(annotation.trace) < 4:
                return state
            # only bother with analysis at loop heads
            count = self.get_loop_count(annotation.trace)
            is_creation = isinstance(
                state.current_transaction, ContractCreationTransaction
            )
            bound = max(8, self.bound) if is_creation else self.bound
            if count > bound:
                log.debug(
                    "loop bound %d exceeded at address %d; skipping state",
                    bound,
                    cur_instr["address"],
                )
                if not self.work_list:
                    raise StopIteration
                continue
            return state

    def run_check(self) -> bool:
        return self.super_strategy.run_check()
