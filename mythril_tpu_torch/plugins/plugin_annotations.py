"""Annotations shared by the built-in plugins.

Reference parity: mythril/laser/plugin/plugins/plugin_annotations.py:13-123.
"""

from __future__ import annotations

from typing import Dict, List, Set

from mythril_tpu_torch.core.state.annotation import MergeableStateAnnotation, StateAnnotation


class MutationAnnotation(StateAnnotation):
    """Set on states that performed a state mutation (SSTORE/CALL)."""

    @property
    def persist_over_calls(self) -> bool:
        return True


class DependencyAnnotation(MergeableStateAnnotation):
    """Storage read/write footprints per transaction (dependency pruning)."""

    def __init__(self):
        self.storage_loaded: Set = set()
        self.storage_written: Dict[int, Set] = {}
        self.has_call: bool = False
        self.path: List[int] = [0]
        self.blocks_seen: Set[int] = set()

    def __copy__(self):
        out = DependencyAnnotation()
        out.storage_loaded = set(self.storage_loaded)
        out.storage_written = {k: set(v) for k, v in self.storage_written.items()}
        out.has_call = self.has_call
        out.path = list(self.path)
        out.blocks_seen = set(self.blocks_seen)
        return out

    def get_storage_write_cache(self, iteration: int) -> Set:
        return self.storage_written.setdefault(iteration, set())

    def extend_storage_write_cache(self, iteration: int, value) -> None:
        self.storage_written.setdefault(iteration, set()).add(value)

    def check_merge_annotation(self, other: "DependencyAnnotation") -> bool:
        return self.has_call == other.has_call and self.path == other.path

    def merge_annotation(self, other: "DependencyAnnotation"):
        merged = DependencyAnnotation()
        merged.storage_loaded = self.storage_loaded | other.storage_loaded
        merged.storage_written = {
            k: self.storage_written.get(k, set()) | other.storage_written.get(k, set())
            for k in set(self.storage_written) | set(other.storage_written)
        }
        merged.has_call = self.has_call
        merged.path = list(self.path)
        merged.blocks_seen = self.blocks_seen | other.blocks_seen
        return merged


class WSDependencyAnnotation(MergeableStateAnnotation):
    """Stack of dependency annotations across the transaction sequence."""

    def __init__(self):
        self.annotations_stack: List[DependencyAnnotation] = []

    def __copy__(self):
        out = WSDependencyAnnotation()
        out.annotations_stack = [a.__copy__() for a in self.annotations_stack]
        return out

    def check_merge_annotation(self, other: "WSDependencyAnnotation") -> bool:
        return len(self.annotations_stack) == len(other.annotations_stack)

    def merge_annotation(self, other: "WSDependencyAnnotation"):
        merged = WSDependencyAnnotation()
        merged.annotations_stack = [
            a.merge_annotation(b)
            for a, b in zip(self.annotations_stack, other.annotations_stack)
        ]
        return merged
