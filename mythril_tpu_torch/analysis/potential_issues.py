"""Deferred issues: modules park constraints, the engine solves once per tx end.

Reference parity: mythril/analysis/potential_issues.py:82-126 — modules create
PotentialIssue records (no model yet) on a state annotation;
check_potential_issues solves each at transaction end, converting the solvable
ones into confirmed Issues with concrete transaction sequences.  The
annotation's search_importance (10 x #issues) steers beam search (:61-62).
"""

from __future__ import annotations

import logging
from functools import lru_cache
from typing import List

from mythril_tpu_torch.analysis.report import Issue
from mythril_tpu_torch.analysis.solver import get_transaction_sequence
from mythril_tpu_torch.core.state.annotation import StateAnnotation
from mythril_tpu_torch.core.state.global_state import GlobalState
from mythril_tpu_torch.exceptions import UnsatError

log = logging.getLogger(__name__)


class PotentialIssue:
    def __init__(
        self,
        contract: str,
        function_name: str,
        address: int,
        swc_id: str,
        title: str,
        bytecode,
        detector,
        severity: str = "Medium",
        description_head: str = "",
        description_tail: str = "",
        constraints=None,
    ):
        self.contract = contract
        self.function_name = function_name
        self.address = address
        self.swc_id = swc_id
        self.title = title
        self.bytecode = bytecode
        self.severity = severity
        self.description_head = description_head
        self.description_tail = description_tail
        self.detector = detector
        self.constraints = constraints or []


class PotentialIssuesAnnotation(StateAnnotation):
    def __init__(self):
        self.potential_issues: List[PotentialIssue] = []

    @property
    def search_importance(self) -> int:
        return 10 * len(self.potential_issues)

    def __copy__(self):
        # shared across forks on purpose: issues park once per program point
        return self


def get_potential_issues_annotation(global_state: GlobalState) -> PotentialIssuesAnnotation:
    for annotation in global_state.get_annotations(PotentialIssuesAnnotation):
        return annotation
    annotation = PotentialIssuesAnnotation()
    global_state.annotate(annotation)
    return annotation


def check_potential_issues(global_state: GlobalState) -> None:
    """Called by the engine at outermost transaction end (svm counterpart of
    reference svm.py:423).

    Each parked issue is confirmed by its own exploit synthesis (model +
    input minimization); the JAX package's shared CDCL gate over all parked
    issues needs the native CDCL tier, which the port does not carry yet."""
    from mythril_tpu_torch.support.time_handler import time_handler

    annotation = get_potential_issues_annotation(global_state)
    if time_handler.time_remaining() <= 0:
        # budget exhausted: leave everything parked.  Confirmation solving
        # runs inside harvest/walker replay, which the engine's per-
        # iteration deadline checks cannot interrupt — without this guard a
        # single wide harvest full of terminal paths overran the execution
        # timeout by minutes of session blasting (bectoken: 501s wall on a
        # 120s budget).  Partial-result discipline: issues confirmed before
        # the deadline are already in detector.issues.
        return
    # the detector's (address, bytecode-hash) cache is the reference's
    # dedup discipline (module/base.py:70-95, checked at analyze time);
    # multiple paths park the same program point before the first
    # confirmation lands, so re-check here — each duplicate skipped is a
    # full exploit-synthesis solve saved
    pending: List[PotentialIssue] = []
    for p in annotation.potential_issues:
        key = (p.address, get_bytecode_hash(p.bytecode))
        if key in p.detector.cache:
            continue
        pending.append(p)
    unsolved: List[PotentialIssue] = []
    for potential_issue in pending:
        if time_handler.time_remaining() <= 0:
            # deadline landed mid-sweep: everything not yet confirmed
            # stays parked (same partial-result discipline as the
            # entry guard)
            unsolved.append(potential_issue)
            continue
        key = (
            potential_issue.address,
            get_bytecode_hash(potential_issue.bytecode),
        )
        if key in potential_issue.detector.cache:
            continue  # confirmed earlier in this same sweep
        try:
            transaction_sequence = get_transaction_sequence(
                global_state,
                global_state.world_state.constraints
                + potential_issue.constraints,
            )
        except UnsatError:
            unsolved.append(potential_issue)
            continue
        potential_issue.detector.cache.add(
            (
                potential_issue.address,
                get_bytecode_hash(potential_issue.bytecode),
            )
        )
        potential_issue.detector.issues.append(
            Issue(
                contract=potential_issue.contract,
                function_name=potential_issue.function_name,
                address=potential_issue.address,
                title=potential_issue.title,
                bytecode=potential_issue.bytecode,
                swc_id=potential_issue.swc_id,
                gas_used=(
                    global_state.mstate.min_gas_used,
                    global_state.mstate.max_gas_used,
                ),
                description_head=potential_issue.description_head,
                description_tail=potential_issue.description_tail,
                severity=potential_issue.severity,
                transaction_sequence=transaction_sequence,
            )
        )
    annotation.potential_issues = unsolved


@lru_cache(maxsize=512)
def _code_hash_memo(bytecode) -> str:
    from mythril_tpu_torch.support.support_utils import get_code_hash

    return get_code_hash(bytecode)


def get_bytecode_hash(bytecode) -> str:
    # every tx-end sweep keys each parked issue by this hash; keccak over
    # the full runtime bytecode is far too expensive to recompute per issue
    if bytecode is None:
        return ""
    return _code_hash_memo(
        bytecode if isinstance(bytecode, (str, bytes)) else str(bytecode)
    )
