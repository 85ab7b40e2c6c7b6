"""Flag propagation shared by the facade's entry points.

* ``apply_analyzer_args`` — copies the facade's args onto the global flag
  object and arms both persistent caches: the query cache and the kernel
  build cache (the JAX package's XLA compilation cache).
* ``resolve_cache_root`` — one directory pins both caches.

The JAX package's ``facade/warm.py`` also holds the analysis service's
per-worker scope (``WorkerContext``, ``reset_analysis_scope``), which comes
with the service (ROADMAP Queue A item 13.4).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

from mythril_tpu_torch.support.support_args import PROBE_BACKENDS, args

__all__ = ["apply_analyzer_args", "resolve_cache_root"]


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
