"""Global analysis flags the port reads.

The subset of ``mythril_tpu/support/support_args.py``'s ``Args`` that the
port consults, with the JAX package's defaults: the engine's limits and
switches, the probe solver's flags, the device frontier's, and the
packed-code paging flags that ``frontier/code.py`` reads.
``probe_backend``: ``"auto"`` (the default, as in the JAX package)
evaluates a query's candidates on the device only when the device is the
card and the query's DAG size times its candidate count reaches
``device_probe_threshold`` (rescaled to the card's measured round trip by
``support/calibration.py``), on the host otherwise; ``"device"`` always
evaluates candidate batches with the tape VM (the CUDA kernel on the card,
its plain PyTorch version on the CPU) and plays the role of the JAX
package's forced ``"jax"`` backend; ``"host"`` never dispatches and
evaluates candidates with the exact host evaluator only; ``"cdcl"`` is the
forced exact mode: every query that the cheap tiers leave open goes to the
native CDCL solver alone.
``prefilter`` and ``devsolver`` are the solver's known-bits prefilter (tier
0.58) and device SAT tier (tier 0.65), on by default as in the JAX package;
``devsolver_bit_budget`` and ``devsolver_iters`` are the devsolver's budgets,
read by ``devsolver.decide_batch`` and set through ``devsolver.configure``.
``staticpass`` and ``staticpass_interproc`` are the static pre-analysis
(``staticpass/``: the detector gate, the hook elision and the event
pruning of the frontier's tables) and its interprocedural layer;
``query_cache`` and ``query_cache_dir`` the solver's query cache
(``querycache/``) and its disk store.  ``pipeline``, ``solver_workers``
and ``harvest_workers`` are the pipelined frontier, its feasibility pool
and the harvest's replay pool; ``adaptive`` the adaptive controller
(``adaptive/``) and ``coverage_target`` its ``--coverage-target`` bar.
All on by default (no disk store, no coverage bar), with the JAX package's
worker counts.

``checkpoint_path`` and ``resume_from`` are the frontier checkpoint
(``support/checkpoint.py``) written after every transaction and the one a
run resumes from; ``compile_cache_dir`` and ``cache_root`` relocate the
kernel build cache (``ops/_build.py``; ``cache_root`` also derives the
query cache's directory, ``facade/warm.py``); ``heartbeat_out``,
``heartbeat_interval``, ``flight_recorder``, ``watchdog_deadline`` and
``history_dir`` are the health surfaces' settings (``observability/``).

``device`` is the analysis-scoped device: ``SymExecWrapper`` resolves it
once and sets it for the run (restoring it after), and the solver calls
that have no laser at hand (path-condition checks, the pruner plugins,
issue confirmation) pass it on.  None outside an analysis: the CUDA card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

PROBE_BACKENDS = ("auto", "device", "host", "cdcl")


@dataclass
class Args:
    solver_timeout: int = 10000  # ms, per query
    execution_timeout: int = 86400  # s, whole run
    create_timeout: int = 10  # s, creation tx
    call_depth_limit: int = 3
    loop_bound: int = 3
    unconstrained_storage: bool = False
    sparse_pruning: bool = False
    solver_log: Optional[str] = None
    use_integer_module: bool = True
    enable_iprof: bool = False
    # write the benchmark plugin's series (JSON + SVG chart) to this path
    benchmark_path: Optional[str] = None
    # frontier checkpointing
    checkpoint_path: Optional[str] = None
    resume_from: Optional[str] = None
    # deterministic replay only: GAS pushes the exact remaining gas instead
    # of a fresh symbol (never symbolic runs)
    concrete_gas: bool = False
    # one seed per function-table entry plus a complement seed per
    # symbolic transaction (core/transaction/symbolic.seed_message_call)
    multi_selector_seeding: bool = False
    probe_candidates: int = 48
    probe_rounds: int = 4
    probe_backend: str = "auto"  # auto | device | host | cdcl
    # the auto backend's break-even: a query goes to the card when its DAG
    # size x candidates reaches this (host evaluation below it is faster
    # than one round trip); calibration rescales it to the measured link
    device_probe_threshold: int = 600_000
    # the abstract known-bits + interval prefilter (absdomain/): tier 0.58
    prefilter: bool = True
    # the batched-DPLL device SAT tier (devsolver/): tier 0.65
    devsolver: bool = True
    devsolver_bit_budget: int = 64
    devsolver_iters: int = 2048
    # static bytecode pre-analysis (staticpass/) and its interprocedural
    # layer; the issue set is identical either way
    staticpass: bool = True
    staticpass_interproc: bool = True
    # the solver's query cache (querycache/): the in-process tiers run
    # whenever query_cache is True; a dir adds the disk store
    query_cache: bool = True
    query_cache_dir: Optional[str] = None
    # the synchronous device frontier (frontier/engine.py): message-call
    # transactions run as segments of frontier_width paths
    frontier: bool = False
    frontier_width: int = 64
    # bypass the a-priori narrow gate (engine._device_worthwhile)
    frontier_force: bool = False
    # the device mesh (parallel/): where a mesh on the analysis device spans
    # more than one device (every visible card), the frontier's slot batch
    # is padded to a multiple of the device count and path-sharded (the
    # runner's injection, rebalance, pulls and replays per slot block) and
    # the probe's lowering batches spread over the devices; --no-mesh is the
    # single-device escape hatch.  One card: no mesh either way
    frontier_mesh: bool = True
    # packed-code paging (frontier/code.py page_budget): a code whose
    # instruction axis exceeds the budget keeps only a resident window
    code_paging: bool = True
    code_page_budget: int = 2048
    # time the device compute of the first productive segment into
    # FrontierStatistics().microbench (engine._run_microbench)
    frontier_microbench: bool = False
    # the pipelined frontier (frontier/pipeline.py): chained segment
    # dispatches overlap the host's harvest, and the harvest's feasibility
    # checks run in a background pool of solver_workers threads; the issue
    # set is identical to the synchronous loop's (--no-pipeline)
    pipeline: bool = True
    solver_workers: int = 2
    # harvest replay threads (frontier/harvest.py HarvestExecutor): a
    # laser's replays on one worker, commits in slot order; 0 = serial
    harvest_workers: int = 4
    # coverage-guided adaptive exploration (adaptive/): the feedback
    # controller that re-steers frontier dispatch slots at uncovered
    # reachable edges and resurrects budget-parked paths when slots free;
    # the issue set is identical either way (--no-adaptive)
    adaptive: bool = True
    # stop exploring once reachable instruction coverage reaches this
    # percent (or every explored code plateaus below it); None explores
    # to the transaction and time budget
    coverage_target: Optional[float] = None
    # the kernel build cache's directory (ops/_build.py build_dir); None:
    # MYTHRIL_TPU_COMPILATION_CACHE, else mythril_tpu_torch/_build
    compile_cache_dir: Optional[str] = None
    # one directory for both persistent caches: the query cache under
    # <root>/querycache, the kernel build cache under <root>/kernels
    # (facade/warm.resolve_cache_root); explicit per-cache flags win
    cache_root: Optional[str] = None
    # the health surfaces (observability/): heartbeat JSONL of sampled
    # queue depths, sampler period, flight-recorder bundle directory, the
    # watchdog deadline (seconds without a completed segment before a hang
    # bundle is dumped; None disables the watchdog) and the metrics history
    heartbeat_out: Optional[str] = None
    heartbeat_interval: float = 0.5
    flight_recorder: Optional[str] = None
    watchdog_deadline: Optional[float] = None
    history_dir: Optional[str] = None
    device: Optional[torch.device] = None


args = Args()
