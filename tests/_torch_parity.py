"""Helpers shared by the tests that hold mythril_tpu_torch against mythril_tpu.

The two packages have separate term interners, so terms cross between them
the way the port's ``serialize.from_jax_dump`` documents: dump on the JAX
side, rebuild on the port side.  Candidate assignments are rebuilt the same
way.  ``jax_same_tiers`` configures the JAX solver to run the probe tiers the
port carried before its native CDCL (tape-VM probe forced on, no query
cache, no pre-filter, no device bit-blast tier, no native CDCL), and
``port_no_cdcl`` switches the port's CDCL off the same way, so the records
made under it still hold; ``jax_cdcl_tiers`` is the same with native CDCL
left on.  ``jax_engine_config_tiers`` adds the known-bits prefilter and the
devsolver; ``port_no_tiers`` switches the port's two off, as every older
record was made.  ``jax_engine_config_defaults`` adds the static pass, its
interprocedural layer and the query cache, the tier set the port carries
now; ``port_no_host_tiers`` switches the port's three off, as every older
record was made.  ``jax_engine_config_pipeline`` adds the pipelined
frontier (two feasibility workers, four replay workers), the JAX package's
default engine on one device without the adaptive controller;
``port_no_pipeline`` runs the port's synchronous loop with a serial
harvest, as every older record was made.
"""

from __future__ import annotations

import contextlib
from typing import List, Sequence

import pytest


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for each test, the old count restored after.
    Tier-1 runs six xdist workers, and each worker's intra-op pool would
    wait on the others' over the CPU's many small ops (a whole analysis took
    up to 50 times its time alone).  Every ``tests/test_torch_*.py`` imports
    this fixture, which makes it autouse there."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def to_port(jax_terms: Sequence) -> List:
    from mythril_tpu.smt.serialize import dump_terms
    from mythril_tpu_torch.smt.serialize import from_jax_dump

    return from_jax_dump(dump_terms(list(jax_terms)))


def to_port_assignment(asg, jax_to_port: dict):
    """A JAX ``Assignment`` over the port's terms (``jax_to_port``: term map)."""
    from mythril_tpu_torch.smt.concrete_eval import ArrayValue, Assignment

    out = Assignment()
    for v, val in asg.scalars.items():
        out.scalars[jax_to_port[v]] = val
    for av, arr in asg.arrays.items():
        out.arrays[jax_to_port[av]] = ArrayValue(
            arr.backing, arr.default, arr.salt, arr.range_bits
        )
    return out


@contextlib.contextmanager
def _jax_tiers(cdcl: bool, tiers: bool = False, query_cache: bool = False):
    from mythril_tpu.native import bitblast
    from mythril_tpu.querycache import configure, get_query_cache
    from mythril_tpu.smt.solver import clear_model_cache
    from mythril_tpu.support.support_args import args

    saved = (args.probe_backend, args.prefilter, args.devsolver, args.query_cache)
    saved_qc = get_query_cache().enabled
    saved_available = bitblast.available
    args.probe_backend, args.prefilter, args.devsolver, args.query_cache = (
        "jax", tiers, tiers, query_cache,
    )
    configure(enabled=query_cache)
    if not cdcl:
        bitblast.available = lambda: False
    clear_model_cache()
    try:
        yield
    finally:
        (args.probe_backend, args.prefilter, args.devsolver, args.query_cache) = saved
        configure(enabled=saved_qc)
        bitblast.available = saved_available
        clear_model_cache()


def jax_same_tiers():
    """The JAX solver restricted to the port's probe tiers without native
    CDCL, caches cleared."""
    return _jax_tiers(cdcl=False)


def jax_cdcl_tiers():
    """``jax_same_tiers`` with the JAX package's native CDCL left on."""
    return _jax_tiers(cdcl=True)


def jax_solver_tiers():
    """``jax_cdcl_tiers`` with the JAX package's known-bits prefilter and
    devsolver on: the solver tiers the port carries now."""
    return _jax_tiers(cdcl=True, tiers=True)


@contextlib.contextmanager
def port_no_cdcl():
    """The port's native CDCL switched off (``bitblast.available`` returns
    False), as ``jax_same_tiers`` does on the JAX side."""
    from mythril_tpu_torch.native import bitblast

    saved = bitblast.available
    bitblast.available = lambda: False
    try:
        yield
    finally:
        bitblast.available = saved


@contextlib.contextmanager
def port_no_tiers():
    """The port's known-bits prefilter and devsolver switched off, as the
    JAX package ran for every record made before they were ported."""
    from mythril_tpu_torch.support.support_args import args

    saved = (args.prefilter, args.devsolver)
    args.prefilter = args.devsolver = False
    try:
        yield
    finally:
        args.prefilter, args.devsolver = saved


@contextlib.contextmanager
def port_no_host_tiers():
    """The port's static pass (and its interprocedural layer) and query
    cache switched off, as the JAX package ran for every record made
    before they were ported (``JAX_ENGINE_ARGS``, ``_jax_tiers``)."""
    from mythril_tpu_torch.querycache import configure, get_query_cache
    from mythril_tpu_torch.support.support_args import args

    saved = (args.staticpass, args.staticpass_interproc, args.query_cache)
    saved_qc = get_query_cache().enabled
    args.staticpass = args.staticpass_interproc = args.query_cache = False
    configure(enabled=False)
    try:
        yield
    finally:
        args.staticpass, args.staticpass_interproc, args.query_cache = saved
        configure(enabled=saved_qc)


@contextlib.contextmanager
def port_no_pipeline():
    """The port's synchronous frontier loop with a serial harvest
    (``--no-pipeline --harvest-workers 0``), as the JAX package ran for
    every record made before the pipeline was ported
    (``JAX_ENGINE_ARGS``)."""
    from mythril_tpu_torch.support.support_args import args

    saved = (args.pipeline, args.harvest_workers)
    args.pipeline, args.harvest_workers = False, 0
    try:
        yield
    finally:
        args.pipeline, args.harvest_workers = saved


@contextlib.contextmanager
def port_no_adaptive():
    """The port's adaptive controller switched off (``--no-adaptive``), as
    the JAX package ran for every record made before the controller was
    ported (``JAX_ENGINE_ARGS``, ``PIPELINE_PINS``)."""
    from mythril_tpu_torch.support.support_args import args

    saved = args.adaptive
    args.adaptive = False
    try:
        yield
    finally:
        args.adaptive = saved


@contextlib.contextmanager
def port_probe_backend(backend: str = "device"):
    """The port's ``args.probe_backend`` set to ``backend``: "device", the
    counterpart of the JAX pin ``"jax"``, for every record made before the
    port's default became "auto"."""
    from mythril_tpu_torch.support.support_args import args

    saved = args.probe_backend
    args.probe_backend = backend
    try:
        yield
    finally:
        args.probe_backend = saved


def port_uncalibrated():
    """The port's link calibration as a JAX run under ``JAX_PLATFORMS=cpu``
    leaves it (taken, nothing measured, nothing rescaled), so a run on the
    card keeps the uncalibrated break-evens its CPU recording was made
    with."""
    return port_calibration(done=True)


@contextlib.contextmanager
def port_calibration(done: bool):
    """The port's link calibration taken with nothing measured (``done``),
    or not taken yet, as at a process's start (the next decision for the
    card measures); the break-evens it rescales at their defaults either
    way; the calibration state and the break-evens as they were on exit."""
    from mythril_tpu_torch.frontier import engine
    from mythril_tpu_torch.support import calibration
    from mythril_tpu_torch.support.support_args import args

    saved = dict(calibration._state)
    constants = (args.device_probe_threshold, engine._MIN_STATIC_JUMPIS, engine._MIN_SEED_WIDTH)
    calibration._state.clear()
    calibration._state.update({"done": done, "rtt_ms": None, "applied": {}})
    args.device_probe_threshold = calibration._ANCHOR_PROBE_THRESHOLD
    engine._MIN_STATIC_JUMPIS, engine._MIN_SEED_WIDTH = calibration._ANCHOR_MIN_STATIC_JUMPIS, 8
    try:
        yield
    finally:
        calibration._state.clear()
        calibration._state.update(saved)
        args.device_probe_threshold, engine._MIN_STATIC_JUMPIS, engine._MIN_SEED_WIDTH = constants


@contextlib.contextmanager
def port_device_backend(cdcl: bool = False, tiers: bool = False, defaults: bool = False):
    """The port's solver with the device probe on and its caches cleared;
    its native CDCL off unless ``cdcl``, its prefilter and devsolver off
    unless ``tiers``, its static pass and query cache off unless
    ``defaults``; its frontier synchronous (``port_no_pipeline``) and
    without the adaptive controller (``port_no_adaptive``); uncalibrated
    (``port_uncalibrated``)."""
    from mythril_tpu_torch.smt.solver import clear_model_cache

    clear_model_cache()
    try:
        with contextlib.ExitStack() as stack:
            stack.enter_context(port_probe_backend("device"))
            stack.enter_context(port_uncalibrated())
            if not cdcl:
                stack.enter_context(port_no_cdcl())
            if not tiers:
                stack.enter_context(port_no_tiers())
            if not defaults:
                stack.enter_context(port_no_host_tiers())
            stack.enter_context(port_no_pipeline())
            stack.enter_context(port_no_adaptive())
            yield
    finally:
        clear_model_cache()


# ---------------------------------------------------------------------------
# whole analyses: the JAX package and the port on the same contract
# ---------------------------------------------------------------------------

# the JAX package's flags that the port's engine has no counterpart for,
# set to the values the port behaves as
JAX_ENGINE_ARGS = dict(
    pipeline=False, frontier_mesh=False, adaptive=False, staticpass=False,
    staticpass_interproc=False, harvest_workers=0,
)


# the JAX package's host tiers that ``jax_engine_config_defaults`` leaves on
DEFAULT_ON = ("staticpass", "staticpass_interproc")
# ... and the engine settings ``jax_engine_config_pipeline`` adds: the JAX
# package's defaults
PIPELINE_ON = dict(pipeline=True, harvest_workers=4, solver_workers=2)


@contextlib.contextmanager
def _jax_engine(cdcl: bool, tiers: bool = False, defaults: bool = False,
                pipeline: bool = False, adaptive: bool = False):
    from mythril_tpu.support.support_args import args

    saved = {k: getattr(args, k) for k in (*JAX_ENGINE_ARGS, *PIPELINE_ON)}
    with _jax_tiers(cdcl, tiers, query_cache=defaults):
        for k, v in JAX_ENGINE_ARGS.items():
            setattr(args, k, True if defaults and k in DEFAULT_ON else v)
        if pipeline:
            for k, v in PIPELINE_ON.items():
                setattr(args, k, v)
        args.adaptive = adaptive
        try:
            yield
        finally:
            for k, v in saved.items():
                setattr(args, k, v)


def jax_engine_config():
    """The JAX package held to the port's configuration without native
    CDCL: ``jax_same_tiers`` and ``JAX_ENGINE_ARGS``, saved and restored."""
    return _jax_engine(cdcl=False)


def jax_engine_config_cdcl():
    """``jax_engine_config`` with the JAX package's native CDCL left on
    (``jax_cdcl_tiers``)."""
    return _jax_engine(cdcl=True)


def jax_engine_config_tiers():
    """``jax_engine_config_cdcl`` with the JAX package's known-bits
    prefilter and devsolver on (its default budgets)."""
    return _jax_engine(cdcl=True, tiers=True)


def jax_engine_config_defaults():
    """``jax_engine_config_tiers`` with the JAX package's static pass, its
    interprocedural layer and its query cache (in process, no disk store)
    on; the pipeline, mesh, adaptive controller and harvest workers stay
    off."""
    return _jax_engine(cdcl=True, tiers=True, defaults=True)


def jax_engine_config_pipeline():
    """``jax_engine_config_defaults`` with the JAX package's pipelined
    frontier on, two feasibility-pool workers and four harvest replay
    workers (``PIPELINE_ON``, its defaults); the mesh and the adaptive
    controller stay off."""
    return _jax_engine(cdcl=True, tiers=True, defaults=True, pipeline=True)


def jax_engine_config_adaptive(pipeline: bool = True):
    """``jax_engine_config_pipeline`` (or, with ``pipeline`` False,
    ``jax_engine_config_defaults``) with the JAX package's adaptive
    controller on, its default; the mesh stays off."""
    return _jax_engine(cdcl=True, tiers=True, defaults=True, pipeline=pipeline, adaptive=True)


# the pipelined runner's counters (the JAX package's ``pipeline.*``
# metrics, the port's ``frontier.pipeline.COUNTERS``)
PIPELINE_COUNTERS = (
    "segments_pipelined", "overlap_segments", "overlap_s", "bubble_s", "carried_slots",
    "corrected_slots", "delta_pulls", "delta_pull_bytes", "pool_submitted",
    "pool_inflight_dedup", "pool_prefilter_kills", "pool_unsat_rollbacks", "orphan_rollbacks",
    "reinject_queued", "reinjected", "adaptive_parked",
)


def reset_pipeline_counters(base: str) -> None:
    if base == "mythril_tpu":
        from mythril_tpu.observability import get_registry

        get_registry().reset(prefix="pipeline.")
        return
    import importlib

    importlib.import_module(f"{base}.frontier.pipeline").reset_counters()


def pipeline_counters(base: str) -> dict:
    """``PIPELINE_COUNTERS`` of ``base`` (the prefix left out)."""
    if base == "mythril_tpu":
        from mythril_tpu.observability import get_registry

        reg = get_registry()
        return {n: reg.counter(f"pipeline.{n}").value or 0 for n in PIPELINE_COUNTERS}
    import importlib

    counters = importlib.import_module(f"{base}.frontier.pipeline").COUNTERS
    return {n: counters[n] for n in PIPELINE_COUNTERS}


TIER_COUNTERS = {
    "prefilter": ("evaluated", "killed", "fallthrough"),
    "devsolver": ("admitted", "decided_sat", "decided_unsat", "unknown",
                  "model_validation_failures"),
}


def _tier_module(base: str, tier: str):
    import importlib

    return importlib.import_module(f"{base}.{'absdomain' if tier == 'prefilter' else tier}")


def reset_tier_counters(base: str) -> None:
    """Zero the prefilter's and the devsolver's counters of ``base``: the
    port's module integers, the JAX package's registry counters."""
    if base == "mythril_tpu":
        from mythril_tpu.observability import get_registry

        for tier in TIER_COUNTERS:
            get_registry().reset(prefix=f"{tier}.")
        return
    for tier in TIER_COUNTERS:
        _tier_module(base, tier).reset_counters()


def tier_counters(base: str) -> dict:
    """{"prefilter": {...}, "devsolver": {...}} of ``base`` (``TIER_COUNTERS``)."""
    if base == "mythril_tpu":
        from mythril_tpu.observability import get_registry

        reg = get_registry()
        return {tier: {n: int(reg.counter(f"{tier}.{n}").value or 0) for n in names}
                for tier, names in TIER_COUNTERS.items()}
    return {tier: {n: getattr(_tier_module(base, tier), n) for n in names}
            for tier, names in TIER_COUNTERS.items()}


def reset_host_tier_counters(base: str) -> None:
    """Zero the ``staticpass.*`` and ``querycache.*`` counters of ``base``:
    the port's module state, the JAX package's registry counters."""
    import importlib

    if base == "mythril_tpu":
        from mythril_tpu.observability import get_registry

        for prefix in ("staticpass.", "querycache."):
            get_registry().reset(prefix=prefix)
        return
    importlib.import_module(f"{base}.staticpass").reset_counters()
    importlib.import_module(f"{base}.querycache.cache").reset_counters()


# counters that measure time, not work: never compared
TIMED = ("wall_time_s",)


def staticpass_counters(base: str) -> dict:
    """The ``staticpass.*`` counters of ``base`` that are not zero, the
    prefix left out (the timed ones too), with ``gate_disabled`` as
    {reason: count}."""
    if base == "mythril_tpu":
        from mythril_tpu.observability import get_registry

        snap = get_registry().snapshot(prefix="staticpass.")
        snap.pop("staticpass.reachable_edge_pct", None)
        disabled = snap.pop("staticpass.gate_disabled", {}) or {}
        counts = {k.split(".", 1)[1]: v for k, v in snap.items()}
    else:
        import importlib

        sp = importlib.import_module(f"{base}.staticpass")
        counts, disabled = dict(sp.COUNTERS), dict(sp.GATE_DISABLED)
    out = {k: v for k, v in sorted(counts.items()) if v and k not in TIMED}
    out["gate_disabled"] = {k: v for k, v in sorted(disabled.items()) if v}
    return out


def querycache_counters(base: str) -> dict:
    """The ``querycache.*`` counters of ``base`` (every name, the prefix
    left out)."""
    import importlib

    cache = importlib.import_module(f"{base}.querycache.cache")
    if base == "mythril_tpu":
        from mythril_tpu.observability import get_registry

        reg = get_registry()
        return {n.split(".", 1)[1]: int(reg.counter(n).value or 0) for n in cache._COUNTERS}
    return dict(cache.COUNTERS)


# the adaptive controller's counters (``adaptive.*`` in both registries)
ADAPTIVE_COUNTERS = ("plans", "resteered_slots", "requeued_paths", "flips_planned",
                     "flips_hit", "plateau_stops", "coverage_stops")


def adaptive_counters(base: str) -> dict:
    import importlib

    reg = importlib.import_module(f"{base}.observability.metrics").get_registry()
    return {n: int(reg.counter(f"adaptive.{n}").value or 0) for n in ADAPTIVE_COUNTERS}


def exploration_state(base: str) -> dict:
    """``base``'s exploration ledger after a run, without what depends on
    the clock: its ``snapshot()`` (``meta()`` and the bitmaps as index
    lists) with ``solver_hotspots``, whose order and seconds are timings,
    replaced by ``hotspot_queries``, every point's query count.  -> also
    ``stop``, the adaptive controller's latched coverage stop (None)."""
    import importlib

    ledger = importlib.import_module(f"{base}.observability.exploration")
    reg = importlib.import_module(f"{base}.observability.metrics").get_registry()
    controller = importlib.import_module(f"{base}.adaptive").get_adaptive_controller()
    snap = ledger.get_exploration_ledger().snapshot()
    snap.pop("solver_hotspots")
    counts = reg.labeled_counter("exploration.solver_hotspot_n", label_name="point").snapshot()
    snap["hotspot_queries"] = {k: int(v) for k, v in sorted(counts.items())}
    snap["stop"] = controller.stop_state()
    return snap


def issue_key(issue) -> tuple:
    return (issue.swc_id, issue.address, issue.function, issue.severity, issue.title)


def issue_summary(issues) -> list:
    """Per issue, sorted by key: [key..., number of transaction steps, the
    last step's 4-byte selector (None without calldata)]."""
    out = []
    for i in issues:
        steps = (i.transaction_sequence or {}).get("steps", [])
        data = steps[-1]["input"] if steps else "0x"
        out.append([*issue_key(i), len(steps), data[:10] if len(data) >= 10 else None])
    return sorted(out, key=lambda r: tuple(str(x) for x in r))


def _reset(base: str) -> None:
    """Clear every cache that carries state from one analysis to the next,
    and number transactions from 1 again, as a fresh process does: symbols
    are named by transaction id, so the two packages build the same terms
    only from the same id, whatever ran before in this process."""
    import importlib

    security = importlib.import_module(f"{base}.analysis.security")
    loader = importlib.import_module(f"{base}.analysis.module.loader")
    solver = importlib.import_module(f"{base}.smt.solver")
    absdomain = importlib.import_module(f"{base}.absdomain")
    devsolver = importlib.import_module(f"{base}.devsolver")
    admission = importlib.import_module(f"{base}.devsolver.admission")
    model = importlib.import_module(f"{base}.support.model")
    stats = importlib.import_module(f"{base}.frontier.stats")
    engine = importlib.import_module(f"{base}.frontier.engine")
    txs = importlib.import_module(f"{base}.core.transaction.transaction_models")
    staticpass = importlib.import_module(f"{base}.staticpass")
    querycache = importlib.import_module(f"{base}.querycache")

    security.reset_callback_modules()
    for m in loader.ModuleLoader().get_detection_modules():
        if hasattr(m, "cache"):
            m.cache.clear()
    solver.clear_model_cache()
    model._model_memo.clear()
    solver.SolverStatistics().reset()
    stats.FrontierStatistics().reset()
    for memo in ("_NARROW_CODES", "_SLOW_CODES", "_SLOW_SEGMENTS", "_WARM_PROGRAMS"):
        getattr(engine, memo).clear()
    txs.tx_id_manager.restart_counter()
    # the tiers' verdict memos and admission accounting outlive an analysis
    absdomain.reset_state()
    devsolver.reset_state()
    admission.reset_state()
    reset_tier_counters(base)
    # the static pass's summaries, report views and call graph, and the
    # query cache's in-process layers, outlive an analysis too
    staticpass.clear_cache()
    staticpass.reset_views()
    staticpass.get_callgraph().reset()
    querycache.reset_query_cache()
    reset_host_tier_counters(base)
    reset_pipeline_counters(base)
    # the metrics registry, the exploration ledger's bitmaps and the
    # adaptive controller's scope, as at the start of an analysis
    importlib.import_module(f"{base}.observability").reset_analysis_metrics()


@contextlib.contextmanager
def recording_dispatches(base: str, into: list):
    """Append ``{"in": input digests, "out": output digests, "seconds":
    the time the two digests took}`` to ``into`` for every segment dispatch
    of ``base``'s frontier engine, by wrapping
    the module attribute ``<base>.frontier.engine.cached_segment`` (the
    engine calls it by that name).  Calls off the recording thread (the
    JAX engine's floored-bucket precompile) are not dispatches."""
    import importlib
    import threading
    import time

    engine = importlib.import_module(f"{base}.frontier.engine")
    from mythril_tpu_torch.frontier import interop

    orig, owner = engine.cached_segment, threading.current_thread()

    def cached_segment(caps, *bucket, **kw):
        segment = orig(caps, *bucket, **kw)

        def recorded(state, arena, arena_len, visited, code, cfg, **kw):
            if threading.current_thread() is not owner:
                return segment(state, arena, arena_len, visited, code, cfg, **kw)
            t0 = time.perf_counter()
            digest_in = interop.input_digests(state, arena, arena_len, visited, code, cfg)
            t1 = time.perf_counter()
            out = segment(state, arena, arena_len, visited, code, cfg, **kw)
            t2 = time.perf_counter()
            digest_out = interop.output_digests(out)
            into.append({"in": digest_in, "out": digest_out,
                         "seconds": t1 - t0 + time.perf_counter() - t2})
            return out

        return recorded

    engine.cached_segment = cached_segment
    try:
        yield into
    finally:
        engine.cached_segment = orig


@contextlib.contextmanager
def counting_cdcl(base: str, into: dict):
    """Count into ``into`` what ``base``'s native CDCL answered: ``calls``
    (each ``bitblast.solve`` and ``OptimizeSession.solve``), ``seconds``
    spent in them, and ``timeouts``, the calls that came back UNKNOWN with
    their whole budget spent (the answer a slower or faster host can flip)."""
    import importlib
    import time

    bitblast = importlib.import_module(f"{base}.native.bitblast")
    into.update(calls=0, timeouts=0, seconds=0.0)

    def counted(fn, budget_of):
        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            dt = time.perf_counter() - t0
            into["calls"] += 1
            into["seconds"] += dt
            if out[0] == bitblast.UNKNOWN and dt >= budget_of(*a, **kw):
                into["timeouts"] += 1
            return out

        return wrapper

    solve, session_solve = bitblast.solve, bitblast.OptimizeSession.solve
    bitblast.solve = counted(solve, lambda conjuncts, timeout_s: timeout_s)
    bitblast.OptimizeSession.solve = counted(
        session_solve, lambda self, bounds, timeout_s, enable=(): timeout_s)
    try:
        yield into
    finally:
        bitblast.solve, bitblast.OptimizeSession.solve = solve, session_solve


def run_analysis(base: str, code: bytes, *, tx_count: int = 1, strategy: str = "dfs",
                 frontier: bool = False, force: bool = False, width: int = 64,
                 modules=None, timeout: int = 60, device="cpu", record: bool = True,
                 cdcl: bool = False, tiers: bool = False, defaults: bool = False,
                 pipeline: bool = False, adaptive: bool = False,
                 probe_backend: str = "device") -> dict:
    """One ``SymExecWrapper`` + ``fire_lasers`` run of package ``base``
    ("mythril_tpu" under ``jax_engine_config``, ``jax_engine_config_cdcl``
    or ``jax_engine_config_tiers``, or "mythril_tpu_torch" on ``device``,
    its native CDCL on only when ``cdcl``, its prefilter and devsolver only
    when ``tiers``, its static pass and query cache only when ``defaults``,
    its pipelined frontier and replay workers only when ``pipeline``, its
    adaptive controller only when ``adaptive``, its probe backend
    ``probe_backend`` and its calibration as the CPU recordings had it,
    ``port_uncalibrated``) with every cache cleared first.  -> {"issues", "summary",
    "dispatches" (digests, in order), "frontier" (the frontier's counters),
    "cdcl" (``SolverStatistics.cdcl_calls`` as "cdcl_calls", and
    ``counting_cdcl``'s counts), "tiers" (``tier_counters``), "staticpass"
    (``staticpass_counters``), "querycache" (``querycache_counters``),
    "pipeline" (``pipeline_counters``), "exploration"
    (``exploration_state``), "adaptive" (``adaptive_counters``), "seconds"
    (wall, the digests' time excluded)}"""
    import importlib
    import time

    args = importlib.import_module(f"{base}.support.support_args").args
    symbolic = importlib.import_module(f"{base}.analysis.symbolic")
    security = importlib.import_module(f"{base}.analysis.security")
    stats = importlib.import_module(f"{base}.frontier.stats")
    solver = importlib.import_module(f"{base}.smt.solver")

    _reset(base)
    saved = (args.frontier, args.frontier_force, args.frontier_width)
    args.frontier, args.frontier_force, args.frontier_width = frontier, force, width
    port = base == "mythril_tpu_torch"
    kw = {"device": device} if port else {}
    dispatches: list = []
    native: dict = {}
    try:
        with contextlib.ExitStack() as stack:
            if record:
                stack.enter_context(recording_dispatches(base, dispatches))
            if port:
                stack.enter_context(port_probe_backend(probe_backend))
                stack.enter_context(port_uncalibrated())
            if port and not cdcl:
                stack.enter_context(port_no_cdcl())
            if port and not tiers:
                stack.enter_context(port_no_tiers())
            if port and not defaults:
                stack.enter_context(port_no_host_tiers())
            if port and not pipeline:
                stack.enter_context(port_no_pipeline())
            if port and not adaptive:
                stack.enter_context(port_no_adaptive())
            stack.enter_context(counting_cdcl(base, native))
            t0 = time.perf_counter()
            sym = symbolic.SymExecWrapper(
                bytes(code), address=0x0901D12E, strategy=strategy,
                transaction_count=tx_count, execution_timeout=timeout, modules=modules, **kw)
            issues = security.fire_lasers(sym, white_list=modules)
            seconds = time.perf_counter() - t0 - sum(d["seconds"] for d in dispatches)
    finally:
        args.frontier, args.frontier_force, args.frontier_width = saved
    fstats = stats.FrontierStatistics()
    return {
        "issues": issues,
        "summary": issue_summary(issues),
        "dispatches": dispatches,
        "frontier": {
            "segments": fstats.segments,
            "device_instructions": fstats.device_instructions,
            "device_paths": fstats.device_paths,
            "parks_by_reason": dict(fstats.parks_by_reason),
            "parks_by_opcode": dict(fstats.parks_by_opcode),
            "replay_errors": getattr(fstats, "replay_errors", 0),
            "commit_errors": getattr(fstats, "commit_errors", 0),
        },
        "cdcl": {"cdcl_calls": solver.SolverStatistics().cdcl_calls, **native},
        "tiers": tier_counters(base),
        "staticpass": staticpass_counters(base),
        "querycache": querycache_counters(base),
        "pipeline": pipeline_counters(base),
        "exploration": exploration_state(base),
        "adaptive": adaptive_counters(base),
        "seconds": seconds,
    }


# the contracts of tests/frontier/test_frontier_engine.py and
# kill_simple.bin-runtime: name -> (runtime hex, transactions, modules)
_DISPATCH = "60003560e01c6341c0e1b5146014576000" + "6000fd" + "5b"
_K0 = "290decd9548b62a8d60345a988386fc84ba6bc95484008f6362f93160ef3e563"


def engine_contracts() -> dict:
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(repo))
    import bench

    kill_simple = (repo / "tests" / "testdata" / "inputs" / "kill_simple.bin-runtime").read_text()
    return {
        "selfdestruct": (_DISPATCH + "33ff", 1, ["AccidentallyKillable"]),
        "clean": ("602a60005500", 1, None),
        "invalid": (_DISPATCH + "fe", 1, ["Exceptions"]),
        "tx_origin": (_DISPATCH + "323314601b5700" "5b00", 1, ["TxOrigin"]),
        "overflow": (_DISPATCH + "600435" "6001" "01" "6000" "55" "00", 1, ["IntegerArithmetics"]),
        "timestamp": (_DISPATCH + "426064" "11" "601c57" "00" "5b00", 1, ["PredictableVariables"]),
        "killbilly_2tx": (bench.KILLBILLY, 2, ["AccidentallyKillable"]),
        "parked_call": (_DISPATCH + "6000" "6000" "6000" "6000" "6064" "33" "61ffff" "f1" "00",
                        1, None),
        "mload_straddle": (_DISPATCH + "600035" "600052" "601051" "602257" "00" "5b33ff", 1,
                           ["AccidentallyKillable"]),
        "sha3_straddle": (_DISPATCH + "600035" "600052" "6020601020" "7f" + _K0
                          + "14" "15" "604757" "00" "5b33ff", 1, ["AccidentallyKillable"]),
        "kill_simple": (kill_simple.strip(), 2, None),
    }


# KillBilly (bench.KILLBILLY) with a dead span after its last instruction:
# a JUMPDEST no jump reaches, then an SSTORE, a JUMPI on calldata, and
# CALLER SELFDESTRUCT.  The static pass proves the span unreachable, so the
# frontier's tables drop its events (SSTORE, JUMPI and SELFDESTRUCT are
# events everywhere else) and its JUMPDEST's loop slot.
DEAD_SPAN = "5b" "6001" "6000" "55" "6000" "35" "6003" "57" "33" "ff" "00"


def dead_code_contract() -> str:
    """The runtime hex of KillBilly with ``DEAD_SPAN`` appended."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import bench

    return bench.KILLBILLY + DEAD_SPAN

