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

    The sat/unsat GATE over all parked issues runs as ONE batched sweep
    first (the sets share the whole path prefix — union model replay and
    merged dispatch resolve most), so the per-issue exploit synthesis
    (model + input minimization) is paid only for the satisfiable ones."""
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
    gate, session, enable_map = _gate_issues(global_state, pending)
    try:
        for idx, (potential_issue, feasible) in enumerate(zip(pending, gate)):
            if time_handler.time_remaining() <= 0:
                # deadline landed mid-sweep: everything not yet confirmed
                # stays parked (same partial-result discipline as the
                # entry guard)
                unsolved.append(potential_issue)
                continue
            if not feasible:
                # an UNKNOWN here degrades exactly like a failed solve
                # below: the issue stays parked, retried at a later tx end
                unsolved.append(potential_issue)
                continue
            key = (
                potential_issue.address,
                get_bytecode_hash(potential_issue.bytecode),
            )
            if key in potential_issue.detector.cache:
                continue  # confirmed earlier in this same sweep
            # confirmation pipelining: gate members answer their exploit
            # synthesis (initial solve + every minimization bound query)
            # under assumptions on the gate's live session — the path
            # condition is blasted ONCE per tx-end sweep, not once per
            # issue (the round-4 double payment; cf. reference
            # analysis/solver.py:51-101, one Optimize per issue)
            gi = enable_map.get(idx) if session is not None else None
            try:
                transaction_sequence = get_transaction_sequence(
                    global_state,
                    global_state.world_state.constraints
                    + potential_issue.constraints,
                    session=session if gi is not None else None,
                    session_enable=(gi,) if gi is not None else (),
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
    finally:
        if session is not None:
            session.close()
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


def _gate_issues(global_state: GlobalState, issues: List[PotentialIssue]):
    """sat/unsat gate over all parked issues at FULL solver budget.

    All issues at one transaction end share the whole path prefix, so the
    gate blasts ``path ∪ sanity bounds ∪ all issue constraints`` ONCE into
    an incremental CDCL session with per-issue enable literals and answers
    each issue as a solve-under-assumptions (learned clauses shared).
    Exact UNSATs skip the expensive exploit synthesis; SAT models are
    validated exactly; anything undecidable here (UNKNOWN, unsupported
    structure, wide-mul overflow encodings, no native library) passes
    through True to the full per-issue solve — the gate can only SAVE
    work, never lose recall beyond what the full solve itself would.

    Returns ``(gate, session, enable_map)``: the session is the LIVE
    blasted formula (or None), built with the exploit-synthesis sanity
    bounds in its base and the minimization objectives registered in
    get_transaction_sequence's exact order, so each feasible member's
    confirmation runs on it under assumptions instead of re-blasting.
    The CALLER owns (and must close) the returned session."""
    gate = [True] * len(issues)
    if len(issues) < 2:
        # a lone issue keeps the classic path: its confirmation solve
        # builds (at most) one session itself, and the cheap tiers may
        # answer it with no blast at all
        return gate, None, {}
    from mythril_tpu_torch.native import bitblast
    from mythril_tpu_torch.smt.concrete_eval import evaluate
    from mythril_tpu_torch.smt.solver import SolverStatistics
    from mythril_tpu_torch.support.support_args import args
    from mythril_tpu_torch.support.time_handler import time_handler

    if not bitblast.available():
        return gate, None, {}
    from mythril_tpu_torch.analysis.solver import _set_minimisation_constraints
    from mythril_tpu_torch.core.state.constraints import Constraints

    path_raws = list(global_state.world_state.constraints.get_all_raw())
    # the confirmation solve operates under calldata-size/callvalue sanity
    # bounds and minimizes (calldatasize, callvalue) per transaction
    # (analysis/solver.py) — bake BOTH into the shared session so bound
    # queries are pure assumptions.  Gating under the same sanity bounds is
    # consistent: an issue satisfiable only beyond them would fail its full
    # confirmation solve anyway (which always adds them).
    sanity, minimize = _set_minimisation_constraints(
        global_state.world_state.transaction_sequence,
        Constraints(),
        [],
        5000,
        global_state.world_state,
    )
    sanity_raws = [c.raw if hasattr(c, "raw") else c for c in sanity]
    objective_raws = [m.raw if hasattr(m, "raw") else m for m in minimize]
    path_raws = path_raws + sanity_raws
    issue_raws = [
        [c.raw if hasattr(c, "raw") else c for c in p.constraints]
        for p in issues
    ]
    # one enable-guarded conjunct per issue (land folds multi-term lists)
    from mythril_tpu_torch.smt import terms as T

    # wide-mul overflow encodings included: the session blasts select
    # congruence lazily (bb_extend refinement), so the Dadda 512-bit
    # multiply no longer exceeds the clause budget — SWC-101 confirmations,
    # the most expensive class, now share the gate like everything else.
    # Should the full blast STILL overflow a budget, retry without the
    # wide-mul members rather than losing the gate for every issue.
    def _wide_mul(t) -> bool:
        return any(
            x.op == "bvmul" and T.is_bv_sort(x.sort) and x.width > 256
            for x in T.topo_order([t])
        )

    folded_all = [
        T.land(*raws) if raws else T.boolval(True) for raws in issue_raws
    ]
    attempts = [list(range(len(folded_all)))]
    narrow = [i for i in attempts[0] if not _wide_mul(folded_all[i])]
    if len(narrow) < len(folded_all):
        attempts.append(narrow)
    session = None
    members: List[int] = []
    for candidate_members in attempts:
        if len(candidate_members) < 2:
            return gate, None, {}
        try:
            session = bitblast.OptimizeSession(
                path_raws,
                objectives=objective_raws,
                guarded=[folded_all[i] for i in candidate_members],
            )
            members = candidate_members
            break
        except bitblast.Unsupported:
            continue
    if session is None:
        return gate, None, {}
    guarded = [folded_all[i] for i in members]
    enable_map = {i: gi for gi, i in enumerate(members)}
    try:
        for gi, i in enumerate(members):
            if time_handler.time_remaining() <= 0:
                break  # deadline mid-gate: the rest pass through True
            # the OVERALL analysis deadline is re-read per query: one hard
            # issue must not spend the whole remaining budget N times over
            budget_s = max(0.05, min(
                args.solver_timeout / 1000.0,
                max(time_handler.time_remaining(), 0) / 2,
            ))
            SolverStatistics().cdcl_calls += 1
            status, asg = session.solve([], budget_s, enable=[gi])
            if status == bitblast.UNSAT:
                gate[i] = False
            elif status == bitblast.SAT and asg is not None:
                # exact validation, as for every native SAT model; a valid
                # model is remembered so the full solve's replay tier hits
                conj = path_raws + [guarded[gi]]
                try:
                    vals = evaluate(conj, asg)
                    if all(vals[c] for c in conj):
                        from mythril_tpu_torch.smt.solver import remember_model

                        remember_model(conj, asg)
                except Exception:
                    pass  # full solve decides from scratch
    except Exception:
        session.close()
        raise
    return gate, session, enable_map
