"""State-annotation protocol: trace metadata carried on paths.

Reference parity: mythril/laser/ethereum/state/annotation.py:10-75.
Annotations ride on GlobalState copies; flags control persistence across
world states and message calls, and ``search_importance`` feeds beam search.
"""

from __future__ import annotations


class StateAnnotation:
    @property
    def persist_to_world_state(self) -> bool:
        return False

    @property
    def persist_over_calls(self) -> bool:
        return False

    @property
    def search_importance(self) -> int:
        return 1


class MergeableStateAnnotation(StateAnnotation):
    """Annotation that knows how to merge with a sibling during state merging."""

    def check_merge_annotation(self, other) -> bool:
        raise NotImplementedError

    def merge_annotation(self, other):
        raise NotImplementedError


class NoCopyAnnotation(StateAnnotation):
    """Annotation shared (not copied) across forks."""

    def __copy__(self):
        return self

    def __deepcopy__(self, _):
        return self
