"""Cooperative corpus analysis: many contracts, one device frontier.

The reference analyzes a corpus strictly sequentially — one contract, one
full symbolic execution, next contract (reference mythril/mythril/
mythril_analyzer.py:138-175).  On a device that serializes exactly the axis
the hardware wants to batch: each small contract's frontier is too narrow
to amortize segment dispatches, so per-contract runs stay host-bound.

This driver instead runs the per-contract transaction loops in LOCKSTEP:

  1. every contract's analysis is constructed (plugins, hooks, world state)
     but deferred (``SymExecWrapper(defer_exec=True)``);
  2. per transaction round, every live analysis seeds its work list
     (``seed_message_call``) and the combined seed set — one code identity
     per contract — executes as ONE wide multi-code frontier batch
     (``frontier.engine.drain_lasers``): the corpus is the batch axis, and
     the adaptive controller's scheduler orders the codes' seeds;
  3. each analysis then drains its residual work list through its own host
     engine (parked paths, frontier-ineligible states) and closes the round
     (plugin signals, open-state reseeding) exactly as ``LaserEVM.
     _execute_transactions`` does;
  4. issues are grouped per contract by the distinct address each analysis
     ran at.

Semantics per contract are unchanged — the frontier parks anything it
cannot run and each laser's host engine finishes it — only the scheduling
across contracts differs.

``run_cooperative_batch`` is the long-lived-service entry point layered on
the same lockstep core: per-job fault isolation (one tenant's exception or
solver blow-up fails only that job's result, the rest of the batch
completes), per-request frontier segment tagging for trace correlation, and
per-job issue attribution that hands each job its error alongside its
issues.  ``analyze_cooperative`` keeps the original batch-tool contract
(exceptions propagate, two-tuple return).

The port's copy of ``mythril_tpu/analysis/cooperative.py``.  What differs:

* ``device`` (default the CUDA card; ``"cpu"`` for the plain PyTorch
  kernels) is the batch's device: every wrapper, the lockstep rounds'
  open-state prune and the frontier run on it.
* A device fault (``device.is_device_fault``: no card, a kernel that did
  not build, launch or run, an allocation the card refused) is never
  isolated to one job: it leaves the batch at whichever stage it struck.
* Nothing falls back to the host engines when the frontier raises: the
  exception leaves the batch (the JAX package logs it and lets every host
  engine continue).
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from mythril_tpu_torch.device import DeviceLike, is_device_fault, resolve
from mythril_tpu_torch.support.support_args import args
from mythril_tpu_torch.support.time_handler import time_handler

log = logging.getLogger(__name__)

#: default spacing of per-contract analysis addresses (issues group by address)
BASE_ADDRESS = 0x0901D12E


def analyze_cooperative(
    jobs: Sequence[Tuple[str, bytes]],
    transaction_count: int = 2,
    modules: Optional[List[str]] = None,
    strategy: str = "bfs",
    execution_timeout: int = 60,
    base_address: int = BASE_ADDRESS,
    caps=None,
    device: DeviceLike = None,
):
    """Analyze ``jobs`` (name, runtime bytecode) cooperatively.

    Returns ``(issues_by_name, total_states)``.  Every contract gets its own
    laser/plugins/hooks at a distinct address; recall semantics match
    sequential per-contract analysis.  The first error of any job
    propagates.
    """
    issues_by_name, errors_by_name, total_states = run_cooperative_batch(
        jobs,
        transaction_count=transaction_count,
        modules=modules,
        strategy=strategy,
        execution_timeout=execution_timeout,
        base_address=base_address,
        caps=caps,
        isolate_errors=False,
        device=device,
    )
    assert not errors_by_name  # isolate_errors=False re-raises instead
    return issues_by_name, total_states


def run_cooperative_batch(
    jobs: Sequence[Tuple[str, bytes]],
    transaction_count: int = 2,
    modules: Optional[List[str]] = None,
    strategy: str = "bfs",
    execution_timeout: int = 60,
    base_address: int = BASE_ADDRESS,
    caps=None,
    isolate_errors: bool = True,
    request_tags: Optional[Sequence[str]] = None,
    request_flow_cb: Optional[Callable[[], None]] = None,
    device: DeviceLike = None,
) -> Tuple[Dict[str, List], Dict[str, str], int]:
    """Lockstep-analyze ``jobs`` with per-job fault isolation.

    Returns ``(issues_by_name, errors_by_name, total_states)``.  A job whose
    construction, seeding, host continuation or finalization raises lands in
    ``errors_by_name`` (name -> one-line description) and drops out of later
    rounds; every other job runs to completion untouched — the multi-tenant
    isolation contract of the analysis service.  A device fault is not one
    job's: it propagates, as does every error with ``isolate_errors=False``
    (the original ``analyze_cooperative`` behavior), and so does an error of
    the shared frontier drain.

    ``request_tags`` (parallel to ``jobs``) label this batch's frontier
    segments so a shared wide device segment is attributable to the requests
    riding it (``frontier.segment`` spans carry ``requests=...``).
    ``request_flow_cb`` (a zero-arg callable, or None) is handed to the
    frontier and invoked once inside the first segment span actually
    dispatched — the service's trace-flow join point (see
    ``frontier.engine.drain_lasers``).
    """
    from mythril_tpu_torch.analysis.security import retrieve_callback_issues
    from mythril_tpu_torch.analysis.symbolic import SymExecWrapper, analysis_device
    from mythril_tpu_torch.core.transaction import symbolic as sym_tx
    from mythril_tpu_torch.frontier.engine import drain_lasers, reset_isolation_gauges
    from mythril_tpu_torch.smt.solver import check_satisfiable_batch
    from mythril_tpu_torch.support.support_utils import get_code_hash

    device = resolve(device)
    reset_isolation_gauges()
    errors_by_name: Dict[str, str] = {}

    def _fail(name: str, stage: str, exc: BaseException) -> None:
        if not isolate_errors or is_device_fault(exc):
            raise exc
        log.warning("job %r failed during %s: %s", name, stage, exc,
                    exc_info=True)
        errors_by_name.setdefault(name, f"{stage}: {exc!r}")

    addresses = [base_address + 0x10000 * i for i in range(len(jobs))]
    # --coverage-target needs a live coverage feed to measure the bar
    # against: the device frontier merges its visited planes into the
    # ledger, but the host path only feeds it through the instruction
    # coverage plugin — enable it when a bar is set and the frontier is
    # off, or the stop verdict could never latch
    host_coverage = bool(getattr(args, "coverage_target", None)) \
        and not bool(args.frontier)
    with analysis_device(device):
        wrappers: List[Tuple[str, int, object]] = []  # (name, addr, wrapper)
        for (name, code), addr in zip(jobs, addresses):
            try:
                w = SymExecWrapper(
                    code,
                    address=addr,
                    strategy=strategy,
                    transaction_count=transaction_count,
                    execution_timeout=execution_timeout,
                    modules=modules,
                    defer_exec=True,
                    enable_coverage_strategy=host_coverage,
                    device=device,
                )
            except Exception as e:
                _fail(name, "construction", e)
                continue
            wrappers.append((name, addr, w))

        # the global wall-clock budget covers the whole batch: the lockstep
        # rounds interleave contracts, so per-contract budgets do not partition
        time_handler.start_execution(execution_timeout * max(1, len(jobs)))
        t0 = time.time()
        for _name, _addr, w in wrappers:
            w.laser._fire("start_sym_exec")
            w.laser.time = t0
            w.laser.open_states = [w.deferred_world_state]
            w.laser.executed_transactions = True

        use_frontier = bool(args.frontier)
        # pin ONE segment-program bucket for the whole sweep: later rounds see
        # fewer live codes, and a shrunken bucket would build a new program
        # shape mid-run
        bucket_floor = None
        if use_frontier and wrappers:
            from mythril_tpu_torch.frontier.code import bucket_hint, bucket_hint_classes

            lists = [
                w.deferred_world_state[addr].code.instruction_list
                for _name, addr, w in wrappers
            ]
            if args.code_paging:
                # per-class floors: each size class keeps its own pinned
                # program, so a creation-heavy outlier does not inflate the
                # floor every small code pads to
                bucket_floor = bucket_hint_classes(lists)
            else:
                bucket_floor = bucket_hint(lists)
        failed: set = set()
        for round_idx in range(transaction_count):
            live = []
            for name, addr, w in wrappers:
                if name in failed:
                    continue
                laser = w.laser
                if not laser.open_states:
                    continue
                try:
                    # batched open-state prune (core/svm.py _execute_transactions)
                    if not args.sparse_pruning:
                        flags = check_satisfiable_batch(
                            [s.constraints.get_all_raw() for s in laser.open_states],
                            device=device,
                        )
                        laser.open_states = [
                            s for s, ok in zip(laser.open_states, flags) if ok
                        ]
                    if not laser.open_states:
                        continue
                    laser._fire("start_sym_trans")
                    sym_tx.seed_message_call(laser, addr)
                except Exception as e:
                    _fail(name, f"seeding round {round_idx}", e)
                    failed.add(name)
                    laser.open_states = []
                    continue
                live.append((name, w))
            if not live:
                break
            log.info(
                "cooperative round %d: %d live contracts, %d seeds",
                round_idx,
                len(live),
                sum(len(w.laser.work_list) for _n, w in live),
            )
            if use_frontier:
                # the whole corpus round as one wide multi-code segment batch;
                # an error here is the shared device's, never one job's
                drain_lasers(
                    [w.laser for _n, w in live], caps=caps,
                    bucket_floor=bucket_floor,
                    tags=request_tags,
                    flow_cb=request_flow_cb,
                )
            for name, w in live:
                # host continuation: parked paths + frontier-ineligible states.
                # A tenant whose host engine blows up (solver exception, plugin
                # bug) fails ALONE: its work list is abandoned, everyone else's
                # round closes normally.
                try:
                    w.laser.exec()
                    w.laser._fire("stop_sym_trans")
                except Exception as e:
                    _fail(name, f"host continuation round {round_idx}", e)
                    failed.add(name)
                    w.laser.open_states = []
                    w.laser.work_list.clear()

        benchmark_base = args.benchmark_path
        try:
            for n, (name, _addr, w) in enumerate(wrappers):
                try:
                    w.laser._fire("stop_sym_exec")
                    if benchmark_base and len(wrappers) > 1:
                        # one series file per contract (the facade's convention)
                        # instead of silent overwrites
                        args.benchmark_path = f"{benchmark_base}.{n}"
                    w.finalize()
                except Exception as e:
                    _fail(name, "finalization", e)
                    failed.add(name)
        finally:
            args.benchmark_path = benchmark_base

        # callback issues accumulated across ALL contracts: group by the code
        # hash every issue carries (Issue.bytecode_hash; Issue.address is the
        # instruction address, not the account).  Identical bytecode under two
        # names shares its issues — the per-code issue cache deduplicates
        # detection, so both names must see the findings.
        by_hash: Dict[str, List] = {}
        for issue in retrieve_callback_issues(modules):
            by_hash.setdefault(issue.bytecode_hash, []).append(issue)
        issues_by_name = {
            name: by_hash.get(get_code_hash(code), [])
            for (name, code) in jobs
            if name not in errors_by_name
        }
    total_states = sum(w.laser.total_states for _n, _a, w in wrappers)
    return issues_by_name, errors_by_name, total_states
