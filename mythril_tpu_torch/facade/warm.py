"""Flag propagation shared by the facade's entry points.

The JAX package's ``facade/warm.py`` also arms the XLA compilation cache,
derives both caches' directories from ``--cache-root`` and holds the
analysis service's per-worker scope (``WorkerContext``,
``reset_analysis_scope``); the port carries ``apply_analyzer_args``, for
the flags its ``Args`` has, and configures the query cache from them.
The rest comes with ROADMAP Queue A item 13.
"""

from __future__ import annotations

from mythril_tpu_torch.support.support_args import PROBE_BACKENDS, args

__all__ = ["apply_analyzer_args"]


def apply_analyzer_args(cmd_args) -> None:
    """Propagate facade args onto the global flag object.

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
    args.query_cache_dir = cmd_args.query_cache_dir
    from mythril_tpu_torch.querycache import configure as _configure_query_cache

    _configure_query_cache(enabled=args.query_cache, cache_dir=args.query_cache_dir)
