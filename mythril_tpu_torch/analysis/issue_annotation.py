"""Annotation persisting confirmed issues across world states / calls.

Reference parity: mythril/analysis/issue_annotation.py:9-34.
"""

from __future__ import annotations

from typing import List

from mythril_tpu_torch.analysis.report import Issue
from mythril_tpu_torch.core.state.annotation import StateAnnotation
from mythril_tpu_torch.smt import Bool


class IssueAnnotation(StateAnnotation):
    def __init__(self, conditions: List[Bool], issue: Issue, detector):
        self.conditions = conditions
        self.issue = issue
        self.detector = detector

    @property
    def persist_to_world_state(self) -> bool:
        return True

    @property
    def persist_over_calls(self) -> bool:
        return True

    def persist_to_world_state_annotation(self) -> bool:
        return True

    def __copy__(self):
        return self
