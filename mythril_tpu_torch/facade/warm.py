"""Warm-process facade: reusable flag propagation + per-request scoping.

``MythrilAnalyzer`` was written for one-shot processes: its constructor
copies CLI args into the global flag object, arms the caches, and the
process exits after one report.  The analysis service needs exactly that
propagation WITHOUT constructing an analyzer per request — the process
stays warm and only the per-request telemetry/detector scope resets
between batches.  This module is the shared half:

* ``apply_analyzer_args`` — copies the facade's args onto the global flag
  object and arms both persistent caches: the query cache and the kernel
  build cache (the JAX package's XLA compilation cache).
* ``resolve_cache_root`` — one directory pins both caches.
* ``reset_analysis_scope`` — the scope sweep that makes each service
  batch behave like a fresh process: non-persistent metrics, detector
  issue lists, and the process-wide (address, bytecode_hash) detection
  caches are cleared; the SMT query cache, interned terms, and built
  kernel libraries deliberately stay warm (their reuse is sound by
  construction — validated hits only).
* ``WorkerContext`` — the explicit owner of one worker's engine-global
  lifecycle, and of its device: the daemon's inline worker thread or one
  pool worker *process* owns exactly one, and every batch it runs goes to
  that device.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Dict, Optional, Tuple

from mythril_tpu_torch.device import DeviceLike, resolve
from mythril_tpu_torch.support.support_args import PROBE_BACKENDS, args

__all__ = [
    "WorkerContext",
    "apply_analyzer_args",
    "reset_analysis_scope",
    "resolve_cache_root",
]


def resolve_cache_root(cache_root: Optional[str]) -> Tuple[Optional[str], Optional[str]]:
    """Map ``--cache-root DIR`` to ``(query_cache_dir, compile_cache_dir)``.

    One directory configures all persistence: the SMT query cache lands
    under ``DIR/querycache`` and the kernel build cache under
    ``DIR/kernels`` (the JAX package's XLA cache: ``DIR/xla``).  Explicit
    ``--query-cache-dir`` / ``--compile-cache-dir`` flags win over the
    derived paths.
    """
    if not cache_root:
        return None, None
    root = os.path.abspath(os.path.expanduser(cache_root))
    return os.path.join(root, "querycache"), os.path.join(root, "kernels")


def apply_analyzer_args(cmd_args) -> None:
    """Propagate facade args onto the global flag object and arm caches.

    Mirrors the reference's copy-into-singleton pattern
    (mythril/mythril/mythril_analyzer.py:63-70).
    """
    args.solver_timeout = cmd_args.solver_timeout
    args.execution_timeout = cmd_args.execution_timeout
    args.create_timeout = cmd_args.create_timeout
    args.call_depth_limit = cmd_args.call_depth_limit
    args.loop_bound = cmd_args.loop_bound
    args.unconstrained_storage = cmd_args.unconstrained_storage
    args.sparse_pruning = cmd_args.sparse_pruning
    args.solver_log = cmd_args.solver_log
    args.enable_iprof = cmd_args.enable_iprof
    args.benchmark_path = cmd_args.benchmark_path
    args.checkpoint_path = cmd_args.checkpoint_file
    args.resume_from = cmd_args.resume_from
    if cmd_args.probe_backend not in PROBE_BACKENDS:
        raise ValueError(
            f"probe backend {cmd_args.probe_backend!r}: the port has {', '.join(PROBE_BACKENDS)}"
        )
    args.probe_backend = cmd_args.probe_backend
    if args.probe_backend == "cdcl":
        # forced-exact mode without the native solver would answer every
        # query UNKNOWN and silently prune the whole state space
        from mythril_tpu_torch.native import bitblast

        if not bitblast.available():
            raise RuntimeError(
                "--probe-backend cdcl requires the native CDCL solver "
                "(mythril_tpu_torch/native); it is not available in this build"
            )
    args.frontier = cmd_args.frontier
    args.frontier_width = cmd_args.frontier_width
    args.frontier_force = cmd_args.frontier_force
    args.frontier_mesh = cmd_args.frontier_mesh
    args.query_cache = cmd_args.query_cache
    args.staticpass = cmd_args.staticpass
    args.staticpass_interproc = cmd_args.staticpass_interproc
    args.code_paging = cmd_args.code_paging
    args.code_page_budget = cmd_args.code_page_budget
    args.prefilter = cmd_args.prefilter
    args.devsolver = cmd_args.devsolver
    args.pipeline = cmd_args.pipeline
    args.solver_workers = cmd_args.solver_workers
    args.harvest_workers = cmd_args.harvest_workers
    args.adaptive = cmd_args.adaptive
    args.coverage_target = cmd_args.coverage_target
    from mythril_tpu_torch import devsolver

    devsolver.configure(bit_budget=cmd_args.devsolver_bit_budget, iters=cmd_args.devsolver_iters)
    args.heartbeat_out = cmd_args.heartbeat_out
    args.heartbeat_interval = cmd_args.heartbeat_interval
    args.flight_recorder = cmd_args.flight_recorder
    args.history_dir = cmd_args.history_dir
    args.watchdog_deadline = cmd_args.watchdog_deadline
    # --cache-root pins both persistent caches under one directory;
    # explicit per-cache flags win over the derived paths
    args.cache_root = cmd_args.cache_root
    derived_qc, derived_kernels = resolve_cache_root(args.cache_root)
    args.query_cache_dir = cmd_args.query_cache_dir or derived_qc
    args.compile_cache_dir = cmd_args.compile_cache_dir or derived_kernels
    from mythril_tpu_torch.querycache import configure as _configure_query_cache

    _configure_query_cache(enabled=args.query_cache, cache_dir=args.query_cache_dir)
    # the kernel build cache: the flag, else the variable, else the default
    # (the JAX package arms its XLA cache whenever its kernels are imported)
    from mythril_tpu_torch import enable_persistent_compilation_cache

    enable_persistent_compilation_cache(args.compile_cache_dir)


class WorkerContext:
    """Explicit per-worker handle on the engine's process-global state.

    One worker (the daemon's inline thread, or one pool worker process)
    constructs exactly one context and routes every engine-global touch
    through it: flag-object configuration (``configure``), the per-batch
    scope sweep (``reset_scope``), issue-sink installation
    (``sink_scope``), the host-probe flag flip (``probe_scope``) and
    abstract-pre-filter accounting (``prefilter_delta``).  Nothing here
    is thread-safe by design — the context IS the single-ownership
    contract the old implicit globals only implied.

    The port's context also owns the worker's device (``device``: None is
    the CUDA card and raises ``NoCudaDevice`` without one; ``"cpu"`` runs
    the plain PyTorch kernels): the service passes it to every batch and
    probe the worker runs.
    """

    def __init__(self, analyzer_args, device: DeviceLike = None):
        #: the AnalyzerArgs-shaped namespace this worker was armed with
        self.analyzer_args = analyzer_args
        self.device = resolve(device)
        self.configured = False

    def configure(self) -> "WorkerContext":
        """Arm the global flag object + caches for this worker process."""
        apply_analyzer_args(self.analyzer_args)
        self.configured = True
        return self

    def reset_scope(self) -> None:
        """Per-batch sweep: next analysis behaves like a fresh process."""
        reset_analysis_scope()

    def sink_scope(self, sink):
        """Install an issue sink for the scope of one analysis."""
        from mythril_tpu_torch.analysis.module.base import issue_sink_scope

        return issue_sink_scope(sink)

    @contextlib.contextmanager
    def probe_scope(self):
        """Host-first probe configuration: frontier off, host probe
        backend — restored on exit.  (The probe's tighter execution
        timeout travels as an explicit ``run_cooperative_batch``
        argument, not through the flag object.)"""
        saved = (args.frontier, args.probe_backend)
        args.frontier = False
        args.probe_backend = "host"
        try:
            yield
        finally:
            args.frontier, args.probe_backend = saved

    @contextlib.contextmanager
    def prefilter_delta(self, out: Dict[str, int]):
        """Measure this scope's abstract pre-filter activity into ``out``
        (keys ``evaluated``/``killed``) — the scoped counters reset per
        batch, so callers that outlive the batch need the delta."""
        from mythril_tpu_torch.observability.metrics import get_registry

        reg = get_registry()
        e0 = reg.counter("prefilter.evaluated").value
        k0 = reg.counter("prefilter.killed").value
        try:
            yield out
        finally:
            out["evaluated"] = out.get("evaluated", 0) + max(
                reg.counter("prefilter.evaluated").value - e0, 0
            )
            out["killed"] = out.get("killed", 0) + max(
                reg.counter("prefilter.killed").value - k0, 0
            )

    @contextlib.contextmanager
    def devsolver_delta(self, out: Dict[str, int]):
        """Measure this scope's device-SAT-tier activity into ``out``
        (keys ``admitted``/``decided_sat``/``decided_unsat``/``unknown``/
        ``model_validation_failures``) — scoped counters reset per batch,
        same contract as ``prefilter_delta``."""
        from mythril_tpu_torch.observability.metrics import get_registry

        reg = get_registry()
        names = ("admitted", "decided_sat", "decided_unsat", "unknown",
                 "model_validation_failures")
        base = {n: reg.counter("devsolver." + n).value for n in names}
        try:
            yield out
        finally:
            for n in names:
                out[n] = out.get(n, 0) + max(
                    reg.counter("devsolver." + n).value - base[n], 0
                )

    @contextlib.contextmanager
    def exploration_delta(self, out: Dict[str, Any]):
        """Measure this scope's exploration-ledger activity into ``out``:
        per-class terminated-path deltas (``terminated`` dict +
        ``terminated_total``), ``pc_overflow``, and the scope-end
        per-contract ``coverage_pct``.  Like ``prefilter_delta``, the
        ledger resets per analysis scope, so callers that outlive the
        batch (the daemon's persistent mirrors, pool-worker done
        payloads) need the delta."""
        from mythril_tpu_torch.observability.exploration import (
            get_exploration_ledger,
        )

        led = get_exploration_ledger()
        t0 = led.terminated()
        o0 = led.pc_overflow
        try:
            yield out
        finally:
            t1 = led.terminated()
            term = out.setdefault("terminated", {})
            for cls, n in t1.items():
                d = max(n - t0.get(cls, 0), 0)
                if d:
                    term[cls] = term.get(cls, 0) + d
            out["terminated_total"] = sum(term.values())
            out["pc_overflow"] = out.get("pc_overflow", 0) + max(
                led.pc_overflow - o0, 0
            )
            # coverage is a level, not a flow: report the scope-end view
            # (keyed by codehash so the daemon can attribute per request)
            cov = led.coverage()
            out["coverage_pct"] = {
                h: c["instruction_pct"] for h, c in cov.items()
            }
            out["coverage_pct_reachable"] = {
                h: c["instruction_pct_reachable"] for h, c in cov.items()
            }

    @contextlib.contextmanager
    def adaptive_delta(self, out: Dict[str, Any]):
        """Measure this scope's adaptive-controller activity into ``out``
        (keys ``plans``/``resteered_slots``/``requeued_paths``/
        ``flips_planned``/``flips_hit``/``plateau_stops``, plus the
        scope-end ``coverage_stop`` verdict when --coverage-target
        latched one) — scoped counters reset per batch, same contract as
        ``prefilter_delta``."""
        from mythril_tpu_torch.observability.metrics import get_registry

        reg = get_registry()
        names = ("plans", "resteered_slots", "requeued_paths",
                 "flips_planned", "flips_hit", "plateau_stops")
        base = {n: reg.counter("adaptive." + n).value for n in names}
        try:
            yield out
        finally:
            for n in names:
                out[n] = out.get(n, 0) + max(
                    reg.counter("adaptive." + n).value - base[n], 0
                )
            from mythril_tpu_torch.adaptive import get_adaptive_controller

            stop = get_adaptive_controller().stop_state()
            if stop:
                out["coverage_stop"] = stop

    def stats(self) -> Dict[str, Any]:
        """Worker-local engine-global sizes (heartbeat payload)."""
        from mythril_tpu_torch.smt.terms import intern_table_size

        return {"interned_terms": intern_table_size()}


def reset_analysis_scope() -> None:
    """Make the next analysis in this process behave like a fresh one.

    Clears per-analysis telemetry (non-persistent metrics, which resets
    the FrontierStatistics/SolverStatistics facades), detector issue
    lists, and the process-wide (address, bytecode_hash) detection
    caches — without the caches sweep a daemon batch would silently
    suppress re-detection of anything a previous batch already flagged.
    Deliberately does NOT drop the SMT query cache, the interned-term
    tables, or built kernel libraries: keeping those warm across requests
    is the service's entire point, and their reuse is validated-sound.
    """
    from mythril_tpu_torch.analysis.module.loader import ModuleLoader
    from mythril_tpu_torch.analysis.security import reset_callback_modules
    from mythril_tpu_torch.observability import reset_analysis_metrics

    reset_analysis_metrics()
    reset_callback_modules()
    for module in ModuleLoader().get_detection_modules():
        module.cache.clear()
