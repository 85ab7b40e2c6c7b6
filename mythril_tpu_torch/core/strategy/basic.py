"""Work-list search strategies.

Reference parity: mythril/laser/ethereum/strategy/__init__.py:6-44 and
basic.py:10-65 (DFS/BFS/uniform-random/depth-weighted-random) and
beam.py:7-31 (beam over annotation ``search_importance``).
"""

from __future__ import annotations

import random
from typing import List

from mythril_tpu_torch.core.state.global_state import GlobalState


class BasicSearchStrategy:
    """Iterator protocol over the engine's work list."""

    def __init__(self, work_list: List[GlobalState], max_depth: int, **kwargs):
        self.work_list = work_list
        self.max_depth = max_depth

    def __iter__(self):
        return self

    def get_strategic_global_state(self) -> GlobalState:
        raise NotImplementedError

    def run_check(self) -> bool:
        return True

    def __next__(self) -> GlobalState:
        while True:
            if not self.work_list or not self.run_check():
                raise StopIteration
            state = self.get_strategic_global_state()
            if state.mstate.depth >= self.max_depth:
                continue
            return state


class DepthFirstSearchStrategy(BasicSearchStrategy):
    def get_strategic_global_state(self) -> GlobalState:
        return self.work_list.pop()


class BreadthFirstSearchStrategy(BasicSearchStrategy):
    def get_strategic_global_state(self) -> GlobalState:
        return self.work_list.pop(0)


class ReturnRandomNaivelyStrategy(BasicSearchStrategy):
    def __init__(self, work_list, max_depth, **kwargs):
        super().__init__(work_list, max_depth)
        self.rng = random.Random(0xC0FFEE)

    def get_strategic_global_state(self) -> GlobalState:
        return self.work_list.pop(self.rng.randrange(len(self.work_list)))


class ReturnWeightedRandomStrategy(BasicSearchStrategy):
    """Deeper states get proportionally higher selection weight."""

    def __init__(self, work_list, max_depth, **kwargs):
        super().__init__(work_list, max_depth)
        self.rng = random.Random(0xC0FFEE)

    def get_strategic_global_state(self) -> GlobalState:
        weights = [s.mstate.depth + 1 for s in self.work_list]
        idx = self.rng.choices(range(len(self.work_list)), weights=weights, k=1)[0]
        return self.work_list.pop(idx)


class BeamSearch(BasicSearchStrategy):
    """Keep only the ``beam_width`` most important states each selection.

    Importance = sum of annotation ``search_importance``
    (reference beam.py:7-31).
    """

    def __init__(self, work_list, max_depth, beam_width: int = 8, **kwargs):
        super().__init__(work_list, max_depth)
        self.beam_width = beam_width

    @staticmethod
    def beam_priority(state: GlobalState) -> int:
        return sum(a.search_importance for a in state._annotations)

    def sort_and_eliminate_states(self) -> None:
        self.work_list.sort(key=self.beam_priority, reverse=True)
        del self.work_list[self.beam_width :]

    def get_strategic_global_state(self) -> GlobalState:
        self.sort_and_eliminate_states()
        return self.work_list.pop(0)


class CriterionSearchStrategy(BasicSearchStrategy):
    """Halts the search when a criterion is satisfied (reference __init__.py:33)."""

    def __init__(self, work_list, max_depth, **kwargs):
        super().__init__(work_list, max_depth)
        self._satisfied_criterion = False

    def run_check(self) -> bool:
        return not self._satisfied_criterion

    def set_criterion_satisfied(self) -> None:
        self._satisfied_criterion = True
