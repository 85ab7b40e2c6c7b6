"""The pipelined frontier (``mythril_tpu_torch/frontier/pipeline.py``)
against the JAX package's (``mythril_tpu/frontier/pipeline.py``).

Deterministic pieces, bit for bit on the same numpy-seeded inputs: the
correction ledger (the JAX ``tests/frontier/test_pipeline.py`` cases, run
on both packages), the feasibility pool's verdicts and in-flight dedup,
the chained dispatch's correction merge (``step._merge_corrections``) on seeded
states, and the delta pull against the full pull.

Whole analyses: ``tests/testdata/torch_engine_runs_pipeline.json`` holds
runs recorded from the JAX package under
``_torch_parity.jax_engine_config_pipeline`` (its default engine on one
device: the pipeline with two feasibility workers and four replay workers,
CDCL, the prefilter, the devsolver, the static pass and the query cache;
no mesh, no adaptive controller).  A pipelined run's dispatch sequence
depends on when the pool's verdicts land, so a run is held by its issue
summary and the invariant that a drain chains its dispatches
(``segments_pipelined > 0``); the counters are recorded beside it.  The
runs: ``bench_contracts``' ``etherstore_like`` (at widths 256 and 64) and
``rubixi_like`` (256), 2 transactions; ``kill_simple.bin-runtime`` at one
transaction and the storage-gated contract of the JAX pipeline tests
(``STORAGE_GATE``) at two, width 64, ``AccidentallyKillable`` only;
``bench._wide_contract(10)`` at 1024 and ``bench._largecode_contract(2400)``
at 256, one transaction.  Regenerate with

    JAX_PLATFORMS=cpu python tests/test_torch_pipeline.py --write [run label ...]

(each JAX analysis in a process of its own, three at a time, about ten
minutes).  Under pytest the port's pipelined engine on the CPU reproduces
the small runs' issues, and equals its own ``--no-pipeline`` run.
"""

from __future__ import annotations

import json
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from tests._torch_parity import _one_torch_thread  # noqa: E402,F401  (autouse fixture)
from tests import test_torch_engine_fixture as F  # noqa: E402

FIXTURE = REPO / "tests" / "testdata" / "torch_engine_runs_pipeline.json"
# the storage-gated selfdestruct of tests/frontier/test_pipeline.py: needs
# the two-transaction chain and recycles slots across pipelined segments
STORAGE_GATE = "60003560e01c6341c0e1b5146014576000" "6000fd" "5b" "600054600114601b5733ff5b00"
KILLABLE = ["AccidentallyKillable"]
# (name, width, transactions, modules)
RUNS = (
    ("etherstore_like", 256, 2, None),
    ("rubixi_like", 256, 2, None),
    ("etherstore_like", 64, 2, None),
    ("kill_simple", 64, 1, KILLABLE),
    ("storage_gate", 64, 2, KILLABLE),
    ("wide_contract_10", 1024, 1, None),
    ("largecode_contract_2400", 256, 1, None),
)
# replayed by the port on the CPU under pytest (label); the others on the
# card only (chip_smoke.py)
CPU_RUNS = ("kill_simple/64", "storage_gate/64", "etherstore_like/64")


def label(name: str, width: int) -> str:
    return f"{name}/{width}"


def code_of(name: str) -> bytes:
    if name == "storage_gate":
        return bytes.fromhex(STORAGE_GATE)
    return F.code_of(name)


# ---------------------------------------------------------------------------
# the recording
# ---------------------------------------------------------------------------


def _analyze(name: str, width: int, tx: int, modules) -> dict:
    from tests._torch_parity import jax_engine_config_pipeline, run_analysis

    with F.bounded_xla_programs(), jax_engine_config_pipeline():
        run = run_analysis("mythril_tpu", code_of(name), tx_count=tx, strategy=F.STRATEGY,
                           frontier=True, force=True, width=width, timeout=F.TIMEOUT,
                           modules=modules, record=False, tiers=True, defaults=True,
                           pipeline=True)
    return {"summary": run["summary"], "frontier_stats": run["frontier"],
            "pipeline": run["pipeline"], "jax_cpu_seconds": run["seconds"],
            "cdcl": run["cdcl"], "tiers": run["tiers"]}


def record(name: str, width: int, tx: int, modules) -> dict:
    import subprocess

    run = {"name": name, "code": code_of(name).hex(), "width": width, "transactions": tx,
           "strategy": F.STRATEGY, "modules": modules}
    out = subprocess.run(
        [sys.executable, __file__, "--analyze", name, str(width), str(tx),
         ",".join(modules or [])], capture_output=True, text=True, check=True, cwd=str(REPO))
    run.update(json.loads(out.stdout.strip().splitlines()[-1]))
    return run


def write_fixture(labels=()) -> list:
    """Record the runs of ``labels`` (all when empty), three at a time, and
    merge them into the fixture in the order of ``RUNS``."""
    from concurrent.futures import ThreadPoolExecutor

    todo = [r for r in RUNS if not labels or label(r[0], r[1]) in labels]
    with ThreadPoolExecutor(3) as pool:
        done = list(pool.map(lambda r: record(*r), todo))
    old = {label(r["name"], r["width"]): r for r in load_runs()} if FIXTURE.exists() else {}
    for run in done:
        old[label(run["name"], run["width"])] = run
        print(f"{label(run['name'], run['width'])}: {len(run['summary'])} issues, "
              f"{run['frontier_stats']['segments']} segments, {run['jax_cpu_seconds']:.1f} s, "
              f"pipeline {run['pipeline']}", flush=True)
    order = [label(n, w) for n, w, _t, _m in RUNS]
    FIXTURE.write_text(json.dumps({"runs": [old[k] for k in order if k in old]}, indent=1)
                       + "\n")
    return load_runs()


def load_runs() -> list:
    return F.load_runs(FIXTURE)


def run_of(lbl: str) -> dict:
    return next(r for r in load_runs() if label(r["name"], r["width"]) == lbl)


def run_port(run: dict, device, pipeline: bool = True, record: bool = False) -> dict:
    """One fixture run through the port's analysis on ``device`` with its
    defaults (the pipeline on unless ``pipeline`` is False: then the
    synchronous loop with a serial harvest, ``--no-pipeline
    --harvest-workers 0``)."""
    from tests._torch_parity import run_analysis

    return run_analysis("mythril_tpu_torch", bytes.fromhex(run["code"]),
                        tx_count=run["transactions"], strategy=run["strategy"],
                        frontier=True, force=True, width=run["width"], timeout=F.TIMEOUT,
                        modules=run["modules"], device=device, record=record, cdcl=True,
                        tiers=True, defaults=True, pipeline=pipeline)


def summary_differences(want: list, got: list) -> list:
    """Where two issue summaries differ: keys, step counts, and the selector
    wherever the issue's function names one (``F.check_run``'s rule)."""
    want_keys, got_keys = [r[:5] for r in want], [r[:5] for r in got]
    if got_keys != want_keys:
        return [f"issue keys {got_keys} != {want_keys}"]
    bad = []
    for w, g in zip(want, got):
        if w[5] != g[5]:
            bad.append(f"{w[:2]}: {g[5]} steps != {w[5]}")
        elif w[2] != "fallback" and w[6] != g[6]:
            bad.append(f"{w[:2]}: selector {g[6]} != {w[6]}")
    return bad


# the counters that depend on the dispatch sequence alone, not on when the
# pool's verdicts land: equal to the recording's when neither run rolled a
# path back (``rolled_back``)
DETERMINISTIC = ("segments_pipelined", "overlap_segments", "carried_slots", "corrected_slots",
                 "delta_pulls", "delta_pull_bytes", "reinject_queued", "reinjected")
ROLLBACKS = ("pool_prefilter_kills", "pool_unsat_rollbacks", "orphan_rollbacks")


def rolled_back(pipeline: dict) -> bool:
    return any(pipeline[k] for k in ROLLBACKS)


def check_run(run: dict, got: dict) -> list:
    """A pipelined run of the port against its recording: the issue
    summary, no replay or commit error, chained dispatches, and, when
    neither run rolled a path back, the segments and ``DETERMINISTIC``
    counters."""
    bad = summary_differences(run["summary"], got["summary"])
    for k in ("replay_errors", "commit_errors"):
        if got["frontier"][k]:
            bad.append(f"{k} {got['frontier'][k]}")
    if got["frontier"]["segments"] >= 2 and not got["pipeline"]["segments_pipelined"]:
        bad.append(f"{got['frontier']['segments']} segments, none chained")
    if not rolled_back(run["pipeline"]) and not rolled_back(got["pipeline"]):
        if got["frontier"]["segments"] != run["frontier_stats"]["segments"]:
            bad.append(f"segments {got['frontier']['segments']} != "
                       f"{run['frontier_stats']['segments']}")
        bad += [f"{k} {got['pipeline'][k]} != {run['pipeline'][k]}" for k in DETERMINISTIC
                if got["pipeline"][k] != run["pipeline"][k]]
    return bad


# ---------------------------------------------------------------------------
# one chained dispatch on a recorded dispatch (here on the CPU; on the card
# in tests/test_torch_cuda.py and chip_smoke.py)
# ---------------------------------------------------------------------------


def full_pull_bytes(st) -> int:
    """The bytes a full ``pull_harvest`` of numpy state ``st`` copies: every
    non-event field and the three scalars, and the events in the bucket
    covering max(ev_len)."""
    from mythril_tpu_torch.frontier import step

    B, EVT, EVW = st.events.shape
    n = sum(int(np.prod(getattr(st, f).shape)) for f in st._fields if f != "events") + 3
    max_ev = int(np.max(st.ev_len)) if B else 0
    return 4 * n + (4 * B * step.events_cap(max_ev, EVT) * EVW if max_ev > 0 else 0)


def chained_dispatch(d: dict, device, sync_debug: bool = False) -> dict:
    """Recorded dispatch ``d`` (``test_torch_frontier_fixture.iter_dispatches``)
    on ``device`` as a full dispatch, its full pull, a harvest's corrections
    on the mirror (every finished slot cleared, every pending fork resumed),
    then one segment chained on the device outputs (``step.chain_dispatch``,
    under ``torch.cuda.set_sync_debug_mode("error")`` when ``sync_debug``),
    and its delta pull against its full pull.  The same merge and the plain
    segment on CPU copies of the first segment's outputs are the reference.
    -> {"in", "plain_in": the merged state's digests on the device and on
    the CPU, "out", "plain_out": the chained segment's output digests,
    "delta_equal", "delta_bytes", "full_bytes", "corrected": slots}"""
    import torch

    from mythril_tpu_torch.frontier import interop, pipeline
    from mythril_tpu_torch.frontier import ops as O
    from mythril_tpu_torch.frontier import step
    from mythril_tpu_torch.frontier.state import FrontierState, clear_slot

    caps, cfg = d["caps"], step.CfgScalars(*d["cfg"])
    segment = step.cached_segment(caps, *d["bucket"], device=device)
    code = interop.code_to_torch(d["code"], device)
    out1 = segment(step.push_state(d["state"], device=device), interop.arena_to_torch(
        d["arena"], device), d["arena_len"], interop.visited_to_torch(d["visited"], device),
        code, cfg)
    mirror = step.pull_harvest(out1[0], out1[2], out1[3], out1[4])[0]
    mask = np.zeros(caps.B, bool)
    for s in range(caps.B):
        if mirror.seed[s] >= 0 and mirror.halt[s] == O.H_PENDING_FORK:
            mirror.halt[s], mask[s] = O.H_RUNNING, True
        elif mirror.seed[s] >= 0 and mirror.halt[s] != O.H_RUNNING:
            clear_slot(mirror, s)
            mask[s] = True
    merged = []
    plain_merge = step._merge_corrections

    def capture(prev, corr, m):
        merged.append(plain_merge(prev, corr, m))
        return merged[-1]

    if sync_debug:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
    step._merge_corrections = capture
    try:
        out2 = step.chain_dispatch(segment, out1, mirror, mask, code, cfg)
    finally:
        step._merge_corrections = plain_merge
        if sync_debug:
            torch.cuda.set_sync_debug_mode(0)
    digest_in = interop.input_digests(merged[0], out1[1], out1[2], out1[5], code, cfg)
    cpu = FrontierState(*[f.cpu() for f in out1[0]])
    plain_state = plain_merge(cpu, step.push_state(mirror, device="cpu"), torch.from_numpy(mask))
    code_cpu = interop.code_to_torch(d["code"], "cpu")
    plain_arena = type(out1[1])(*[x.cpu() for x in out1[1]])
    plain_in = interop.input_digests(plain_state, plain_arena, out1[2].cpu(), out1[5].cpu(),
                                     code_cpu, cfg)
    plain = step.segment_torch(plain_state, plain_arena, out1[2].cpu(), out1[5].cpu(), code_cpu,
                               cfg, caps)
    before = pipeline.COUNTERS["delta_pull_bytes"]
    delta = step.pull_harvest(out2[0], out2[2], out2[3], out2[4], prev=mirror)
    delta_bytes = pipeline.COUNTERS["delta_pull_bytes"] - before
    full = step.pull_harvest(out2[0], out2[2], out2[3], out2[4])
    equal = delta[1:] == full[1:] and all(
        np.array_equal(a, b) for a, b in zip(delta[0], full[0]))
    return {"in": digest_in, "plain_in": plain_in, "out": interop.output_digests(out2),
            "plain_out": interop.output_digests(plain), "delta_equal": equal,
            "delta_bytes": delta_bytes, "full_bytes": full_pull_bytes(full[0]),
            "corrected": int(mask.sum())}


def recorded_dispatch(name: str = "etherstore_like", index: int = 0) -> dict:
    """One dispatch of ``tests/testdata/torch_frontier_dispatches.npz``."""
    from tests.test_torch_frontier_fixture import iter_dispatches

    return next(d for n, i, d in iter_dispatches(keep=lambda n, i, _d: (n, i) == (name, index)))


def test_chained_dispatch_on_cpu_equals_merge_then_segment():
    got = chained_dispatch(recorded_dispatch(), "cpu")
    assert got["corrected"] > 0
    assert got["in"] == got["plain_in"] and got["out"] == got["plain_out"]
    assert got["delta_equal"] and 0 < got["delta_bytes"] < got["full_bytes"]


# ---------------------------------------------------------------------------
# the correction ledger (tests/frontier/test_pipeline.py, on both packages)
# ---------------------------------------------------------------------------

BASES = ("mythril_tpu", "mythril_tpu_torch")


def _pipeline(base: str):
    import importlib

    return importlib.import_module(f"{base}.frontier.pipeline")


def _pool(base: str, workers: int):
    """``base``'s feasibility pool; the port's solves on the CPU."""
    kw = {"device": "cpu"} if base == "mythril_tpu_torch" else {}
    return _pipeline(base).FeasibilityPool(workers, **kw)


def _ledger_state(led) -> tuple:
    return (led.corr_mask.tolist(), led.active_at.tolist(), led.device_owned.tolist(),
            led.next_dispatch, led.pulled)


@pytest.mark.parametrize("base", BASES)
def test_ledger_touch_rides_next_dispatch(base):
    led = _pipeline(base).CorrectionLedger(4)
    led.touch(1)
    assert led.corr_mask[1] and led.active_at[1] == 0
    mask = led.consume(np.array([0, 0, 0, 0]))
    assert mask[1] and mask.sum() == 1
    assert not led.corr_mask.any(), "mask must clear after consume"
    assert list(led.on_pull()) == []


@pytest.mark.parametrize("base", BASES)
def test_ledger_carry_until_active_dispatch_pulled(base):
    led = _pipeline(base).CorrectionLedger(4)
    led.consume(np.full(4, -1))
    led.touch(2)
    led.consume(np.full(4, -1))
    assert list(led.on_pull()) == [2]
    assert list(led.on_pull()) == []


@pytest.mark.parametrize("base", BASES)
def test_ledger_device_ownership_of_freed_slots(base):
    led = _pipeline(base).CorrectionLedger(4)
    led.touch(1)
    led.touch(2)
    led.consume(np.array([5, -1, 7, -1]))
    assert led.device_owned.tolist() == [False, True, False, False]
    led.release_owned()
    assert not led.device_owned.any()


@pytest.mark.parametrize("base", BASES)
def test_ledger_consume_all_marks_everything(base):
    led = _pipeline(base).CorrectionLedger(3)
    led.touch(0)
    led.consume_all()
    assert (led.active_at == 0).all() and not led.corr_mask.any()
    assert list(led.on_pull()) == []


@pytest.mark.parametrize("base", BASES)
def test_ledger_carry_forward_clears_events(base):
    import importlib

    state = importlib.import_module(f"{base}.frontier.state")
    caps = state.Caps(B=4)
    prev, new = state.empty_state(caps, 4), state.empty_state(caps, 4)
    prev.pc[1], prev.seed[1] = 42, 9
    new.pc[1], new.ev_len[1] = 7, 3
    led = _pipeline(base).CorrectionLedger(4)
    led.consume(np.full(4, -1))
    led.touch(1)
    led.consume(np.full(4, -1))
    assert led.carry_forward(new, prev) == 1
    assert new.pc[1] == 42 and new.seed[1] == 9 and new.ev_len[1] == 0


def test_ledger_seeded_protocol_equals_jax():
    """A seeded sequence of touches, consumes, pulls, carries and releases
    on both packages' ledgers: every field after every call equal, and the
    carried states equal."""
    from mythril_tpu.frontier import state as jst
    from mythril_tpu_torch.frontier import state as pst

    rng = np.random.default_rng(1401)
    B = 16
    leds = [_pipeline(b).CorrectionLedger(B) for b in BASES]
    caps = (jst.Caps(B=B), pst.Caps(B=B))
    for step in range(300):
        op = int(rng.integers(0, 6))
        seed = rng.integers(-1, 3, B).astype(np.int32)
        slot = int(rng.integers(0, B))
        outs = []
        for led, mod, cap in zip(leds, (jst, pst), caps):
            if op == 0:
                led.touch(slot)
                outs.append(None)
            elif op == 1:
                outs.append(led.consume(seed).tolist())
            elif op == 2:
                led.consume_all()
                outs.append(None)
            elif op == 3:
                outs.append(list(map(int, led.on_pull())))
            elif op == 4:
                r = np.random.default_rng(step)
                prev, new = mod.empty_state(cap, 4), mod.empty_state(cap, 4)
                for f_prev, f_new in zip(prev, new):
                    f_prev[...] = r.integers(-5, 50, f_prev.shape)
                    f_new[...] = r.integers(-5, 50, f_new.shape)
                n = led.carry_forward(new, prev)
                outs.append((n, [np.asarray(f).tolist() for f in new]))
            else:
                led.release_owned()
                outs.append(None)
        assert outs[0] == outs[1], f"step {step} op {op}"
        assert _ledger_state(leds[0]) == _ledger_state(leds[1]), f"step {step} op {op}"


# ---------------------------------------------------------------------------
# the feasibility pool
# ---------------------------------------------------------------------------


def _verdicts(base: str, cases, workers: int = 2) -> dict:
    """{slot: (ok, why)} from ``base``'s pool on ``cases`` [(slot, raws)]."""
    import importlib

    terms = importlib.import_module(f"{base}.smt.terms")
    pool = _pool(base, workers)
    try:
        for slot, raws in cases(terms):
            pool.submit(slot, f"rec{slot}", len(raws), raws, frozenset(t.tid for t in raws))
    finally:
        pool.shutdown()
    out = {slot: (ok, why) for slot, _rec, _n, ok, why in pool.drain()}
    assert pool.pending() == 0
    return out


def _pool_cases(terms):
    x = terms.var("pool_y", 256)
    yield 0, [terms.eq(x, terms.const(5, 256))]
    yield 1, [terms.eq(x, terms.const(1, 256)), terms.eq(x, terms.const(2, 256))]
    y = terms.var("pool_w", 256)
    yield 2, [terms.ult(y, terms.const(10, 256)), terms.ugt(y, terms.const(3, 256))]
    yield 3, [terms.ult(y, terms.const(3, 256)), terms.ugt(y, terms.const(3, 256))]


def test_pool_sat_and_unsat_verdicts_equal_jax():
    from tests._torch_parity import port_device_backend

    with port_device_backend(cdcl=True, tiers=True, defaults=True):
        port = _verdicts("mythril_tpu_torch", _pool_cases)
    jax = _verdicts("mythril_tpu", _pool_cases)
    assert port == jax
    assert {s: ok for s, (ok, _why) in port.items()} == {0: True, 1: False, 2: True, 3: False}


@pytest.mark.parametrize("base", BASES)
def test_pool_inflight_dedup_fans_out_one_solve(base):
    import importlib

    from tests._torch_parity import pipeline_counters, reset_pipeline_counters

    terms = importlib.import_module(f"{base}.smt.terms")
    reset_pipeline_counters(base)
    pool = _pool(base, 1)
    x = terms.var("pool_z", 256)
    raws = [terms.eq(x, terms.const(3, 256))]
    key = frozenset(t.tid for t in raws)
    try:
        with pool._solver_lock:
            pool.submit(0, "recA", 1, raws, key)
            pool.submit(1, "recB", 1, raws, key)
    finally:
        pool.shutdown()
    out = sorted((slot, ok) for slot, _rec, _n, ok, _why in pool.drain())
    assert out == [(0, True), (1, True)]
    got = pipeline_counters(base)
    assert (got["pool_inflight_dedup"], got["pool_submitted"]) == (1, 1)


@pytest.mark.parametrize("base", BASES)
def test_pool_prefilter_kill_reaches_every_waiter(base):
    from tests._torch_parity import pipeline_counters, reset_pipeline_counters

    reset_pipeline_counters(base)
    pool = _pool(base, 1)
    key = frozenset({1, 2})
    try:
        pool.submit(0, "recA", 1, [], key, verdict=False)
        pool.submit(1, "recB", 1, [], key, verdict=False)
    finally:
        pool.shutdown()
    out = sorted((slot, ok, why) for slot, _rec, _n, ok, why in pool.drain())
    assert out == [(0, False, "prefilter"), (1, False, "prefilter")]
    got = pipeline_counters(base)
    assert (got["pool_prefilter_kills"], got["pool_inflight_dedup"]) == (2, 1)


def _solve_errors():
    """What a worker's solve may raise from the card: the wrappers'
    ``DeviceError`` (no build, no launch), a torch ``RuntimeError`` (a
    faulting kernel surfacing at a read), a wrapper's shape refusal
    (``ValueError``) and an allocation failure."""
    import torch

    from mythril_tpu_torch.device import DeviceError

    return [DeviceError, RuntimeError, ValueError, torch.OutOfMemoryError]


@pytest.mark.parametrize("error", _solve_errors(), ids=lambda e: e.__name__)
def test_pool_solve_error_reaches_the_main_thread(error):
    """An exception raised inside a worker's solve is re-raised by the next
    ``drain`` on the calling thread; no verdict is invented for it (the
    synchronous prune lets the same exception through)."""
    from mythril_tpu_torch.frontier import pipeline
    from mythril_tpu_torch.smt import solver, terms

    def failing(*_a, **_kw):
        raise error("injected: the kernel did not launch")

    saved = solver.check_satisfiable_batch
    solver.check_satisfiable_batch = failing
    pool = pipeline.FeasibilityPool(workers=2)
    try:
        x = terms.var("pool_err", 256)
        raws = [terms.eq(x, terms.const(1, 256))]
        pool.submit(0, "rec", 1, raws, frozenset(t.tid for t in raws))
        pool._executor.shutdown(wait=True)
        with pytest.raises(error, match="injected"):
            pool.drain()
        assert pool.drain() == []
    finally:
        solver.check_satisfiable_batch = saved
        pool.shutdown()


@pytest.mark.parametrize("error", _solve_errors()[:2], ids=lambda e: e.__name__)
def test_pool_solve_error_makes_the_pipelined_run_raise(error):
    """A pipelined analysis whose feasibility worker meets an exception
    raises it on the calling thread (at the next harvest's drain or when the
    runner shuts the pool down); the run does not go on synchronously."""
    from mythril_tpu_torch.frontier import engine
    from mythril_tpu_torch.smt import solver, terms

    check, prune = solver.check_satisfiable_batch, engine.FrontierEngine._prune_running
    submitted = []

    def failing_on_workers(*a, **kw):
        if threading.current_thread().name.startswith("mythril-feas"):
            raise error("injected: the tape kernel did not launch")
        return check(*a, **kw)

    def prune_and_submit(self, st, records, walker, ev_seen, pipe=None):
        prune(self, st, records, walker, ev_seen, pipe)
        if pipe is not None and not submitted:
            x = terms.var("pool_fault", 256)
            raws = [terms.eq(x, terms.const(1, 256))]
            slot = next(s for s in range(self.caps.B) if records[s] is not None)
            pipe.pool.submit(slot, records[slot], 1, raws, frozenset(t.tid for t in raws))
            submitted.append(slot)

    solver.check_satisfiable_batch = failing_on_workers
    engine.FrontierEngine._prune_running = prune_and_submit
    try:
        with pytest.raises(error, match="injected"):
            run_port(run_of("storage_gate/64"), "cpu")
    finally:
        solver.check_satisfiable_batch = check
        engine.FrontierEngine._prune_running = prune
    assert submitted


def test_counters_lose_no_update_under_threads():
    """The pipeline's and the frontier's counters are incremented from the
    pool's and the replay pool's threads: 16 threads, a short switch
    interval, every increment counted."""
    import sys

    from mythril_tpu_torch.frontier import pipeline
    from mythril_tpu_torch.frontier.stats import FrontierStatistics

    stats = FrontierStatistics()
    pipeline.reset_counters()
    stats.reset()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def bump():
        for _ in range(2000):
            pipeline.count("corrected_slots")
            stats.count("device_paths")
            stats.record_bulk_park("batch-full")

    threads = [threading.Thread(target=bump) for _ in range(16)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert pipeline.COUNTERS["corrected_slots"] == stats.device_paths == 32000
    assert stats.parks_by_reason["batch-full"] == 32000
    pipeline.reset_counters()
    stats.reset()


# ---------------------------------------------------------------------------
# the chained dispatch's correction merge and the delta pull
# ---------------------------------------------------------------------------


def _seeded_state(caps, rng, loops: int = 4):
    from mythril_tpu.frontier.state import empty_state

    st = empty_state(caps, loops)
    for f in st:
        f[...] = rng.integers(-3, 200, f.shape)
    return st


def test_merge_corrections_equals_jax():
    import jax.numpy as jnp

    from mythril_tpu.frontier import step as jstep
    from mythril_tpu.frontier.state import Caps, FrontierState
    from mythril_tpu_torch.frontier import interop
    from mythril_tpu_torch.frontier import step as pstep

    rng = np.random.default_rng(1403)
    for B in (4, 16, 64):
        caps = Caps(B=B, EVT=8)
        prev, corr = _seeded_state(caps, rng), _seeded_state(caps, rng)
        mask = rng.random(B) < 0.4
        want = jstep._merge_corrections(FrontierState(*map(jnp.asarray, prev)),
                                        FrontierState(*map(jnp.asarray, corr)), jnp.asarray(mask))
        got = pstep._merge_corrections(interop.state_to_torch(prev, "cpu"),
                                       interop.state_to_torch(corr, "cpu"),
                                       pstep.upload(mask, "cpu"))
        for name, w, g in zip(FrontierState._fields, want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"B={B} {name}")


def _pulled_state(caps, rng):
    """A device-side state with halted, forked, event-carrying and grown
    slots, and a previous mirror stale where the device advanced."""
    from mythril_tpu.frontier import ops as O

    st = _seeded_state(caps, rng)
    B, EVT = caps.B, caps.EVT
    st.seed[:] = np.where(rng.random(B) < 0.8, rng.integers(0, 9, B), -1)
    st.halt[:] = np.where(rng.random(B) < 0.6, O.H_RUNNING, rng.integers(1, 6, B))
    st.ev_len[:] = np.where(rng.random(B) < 0.3, rng.integers(1, EVT + 3, B), 0)
    # a slot's events past its ev_len are the empty rows the push made
    st.events[np.arange(EVT)[None, :] >= st.ev_len[:, None]] = -1
    prev = _seeded_state(caps, rng)
    for name in st._fields:
        if name != "events":
            getattr(prev, name)[...] = getattr(st, name)
    grown = rng.random(B) < 0.3
    prev.cons_len[grown] = np.maximum(st.cons_len[grown] - 1, 0)
    prev.cons[grown] = -1
    finishing = (st.seed >= 0) & (st.halt != O.H_RUNNING)
    prev.stack[finishing] = -7
    prev.ev_len[:] = 0
    return st, prev


def test_delta_pull_equals_jax_and_the_full_pull():
    import jax.numpy as jnp

    from mythril_tpu.frontier import step as jstep
    from mythril_tpu.frontier.state import Caps, FrontierState
    from mythril_tpu.observability import get_registry
    from mythril_tpu_torch.frontier import interop
    from mythril_tpu_torch.frontier import pipeline
    from mythril_tpu_torch.frontier import step as pstep

    rng = np.random.default_rng(1404)
    for B, EVT in ((8, 8), (40, 40), (200, 140)):
        caps = Caps(B=B, EVT=EVT)
        st, prev = _pulled_state(caps, rng)
        scalars = (int(rng.integers(0, 1000)), int(rng.integers(0, 1000)), int(rng.integers(B)))
        get_registry().reset(prefix="pipeline.")
        pipeline.reset_counters()
        dev = FrontierState(*map(jnp.asarray, st))
        want = jstep.pull_harvest(dev, *scalars, prev=prev)
        full = pstep.pull_harvest(interop.state_to_torch(st, "cpu"), *scalars)
        got = pstep.pull_harvest(interop.state_to_torch(st, "cpu"), *scalars, prev=prev)
        assert got[1:] == want[1:] == full[1:]
        for name, w, g, f in zip(FrontierState._fields, want[0], got[0], full[0]):
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=f"B={B} {name} vs JAX")
            np.testing.assert_array_equal(g, f, err_msg=f"B={B} {name} vs the full pull")
        reg = get_registry()
        assert pipeline.COUNTERS["delta_pulls"] == reg.counter("pipeline.delta_pulls").value == 1
        assert (pipeline.COUNTERS["delta_pull_bytes"]
                == reg.counter("pipeline.delta_pull_bytes").value > 0)


def test_delta_pull_matches_full_pull():
    """tests/frontier/test_harvest.py's hand-built case, on the port."""
    from mythril_tpu_torch.frontier import interop
    from mythril_tpu_torch.frontier import ops as O
    from mythril_tpu_torch.frontier.state import Caps, empty_state
    from mythril_tpu_torch.frontier.step import pull_harvest, push_state

    caps = Caps(B=8)
    st = empty_state(caps, 4)
    for s in range(4):
        st.seed[s], st.halt[s], st.pc[s] = s, O.H_RUNNING, 10 + s
        st.stack[s, :2] = [100 + s, 200 + s]
        st.stack_len[s], st.cons[s, 0], st.cons_len[s] = 2, 7, 1
    st.halt[2] = O.H_STOP
    st.events[1, 0, :] = 5
    st.ev_len[1] = 1
    st.cons[3, 1], st.cons_len[3] = 9, 2
    dev = push_state(st, device="cpu")
    dev = dev._replace(events=interop.state_to_torch(st, "cpu").events,
                       ev_len=interop.state_to_torch(st, "cpu").ev_len)
    full = pull_harvest(dev, 17, 55, 3)
    prev = empty_state(caps, 4)
    for name, dst, src in zip(prev._fields, prev, full[0]):
        if name != "events":
            dst[...] = src
    prev.cons_len[3], prev.cons[3, 1], prev.stack[2], prev.ev_len[1] = 1, -1, -1, 0
    delta = pull_harvest(dev, 17, 55, 3, prev=prev)
    assert delta[1:] == full[1:]
    for name, a, b in zip(full[0]._fields, full[0], delta[0]):
        assert np.array_equal(a, b), name


# ---------------------------------------------------------------------------
# whole analyses
# ---------------------------------------------------------------------------


def test_fixture_holds_every_run():
    runs = load_runs()
    assert [(r["name"], r["width"], r["transactions"], r["modules"]) for r in runs] == \
        [(n, w, t, m) for n, w, t, m in RUNS]
    for r in runs:
        assert r["code"] == code_of(r["name"]).hex() and r["strategy"] == F.STRATEGY
        assert r["frontier_stats"]["replay_errors"] == 0 and r["cdcl"]["timeouts"] == 0
        # every drain chained its dispatches: a pipelined drain dispatches
        # at least twice, the second chained before the first was pulled
        assert r["frontier_stats"]["segments"] >= 2
        assert r["pipeline"]["segments_pipelined"] > 0
        assert r["pipeline"]["delta_pulls"] > 0
    by = {label(r["name"], r["width"]): r for r in runs}
    assert any(row[0] == "106" for row in by["kill_simple/64"]["summary"])
    assert any(row[0] == "106" for row in by["storage_gate/64"]["summary"])
    assert by["wide_contract_10/1024"]["summary"] and by["etherstore_like/256"]["summary"]


@pytest.mark.parametrize("lbl", CPU_RUNS)
def test_port_pipeline_reproduces_the_jax_pipeline_on_cpu(lbl):
    from mythril_tpu_torch.frontier.harvest import shutdown_replay_pool

    run = run_of(lbl)
    try:
        got = run_port(run, "cpu")
        sync = run_port(run, "cpu", pipeline=False)
    finally:
        shutdown_replay_pool()
    assert check_run(run, got) == []
    assert summary_differences(sync["summary"], got["summary"]) == []
    assert sync["pipeline"]["segments_pipelined"] == 0
    assert got["pipeline"]["delta_pulls"] > 0


def test_pipeline_threads_are_gone_after_a_run():
    """The runner shuts its feasibility pool down when the run ends."""
    run = run_of("kill_simple/64")
    before = {t.name for t in threading.enumerate()}
    run_port(run, "cpu")
    assert not any(t.name.startswith("mythril-feas") and t.name not in before
                   for t in threading.enumerate())


if __name__ == "__main__":
    if sys.argv[1:2] == ["--analyze"]:
        name, width, tx, modules = sys.argv[2:6]
        print(json.dumps(_analyze(name, int(width), int(tx), modules.split(",") if modules
                                  else None)))
        sys.exit(0)
    if "--write" not in sys.argv:
        sys.exit("usage: JAX_PLATFORMS=cpu python tests/test_torch_pipeline.py --write "
                 "[run label ...]")
    import os

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    written = write_fixture([a for a in sys.argv[1:] if a != "--write"])
    print(f"{FIXTURE}: {FIXTURE.stat().st_size} bytes, {len(written)} runs")
