"""The adaptive controller (``mythril_tpu_torch/adaptive/``) against the JAX
package's (``mythril_tpu/adaptive/``).

Pure pieces, exactly, on the same numpy-seeded inputs: the planner
(``build_plan`` on seeded ledger snapshots of 1 to 6 codes) and the
controller on a pinned clock (``time.monotonic`` monkeypatched in both
controller modules: the plan cache is throttled by the wall clock, so
``adaptive.plans``, the plateau history and the scheduler's weights depend
on the clock).  The JAX ``tests/adaptive/test_plan.py`` and
``test_controller.py`` cases run here on the port (their source with the
package renamed; the JAX package runs them in their own files).

Whole analyses: ``tests/testdata/torch_engine_runs_adaptive.json`` holds
runs recorded from the JAX package's default engine on one device with the
adaptive controller on (``_torch_parity.jax_engine_config_adaptive``):
``kill_simple.bin-runtime`` (1 transaction) and the storage-gated contract
of ``test_torch_pipeline`` (2) at width 64, ``bench_contracts``'
``etherstore_like`` and ``rubixi_like`` at 256 (2), each pipelined and with
``--no-pipeline`` (a serial harvest); the issue summary, the exploration
ledger (``_torch_parity.exploration_state``: ``meta()`` and the bitmaps,
the hotspots as query counts), and the ``adaptive.*``, frontier and
``pipeline.*`` counters.  Beside them, the three cooperative batches of
``bench.py`` ``adaptive_compare`` (``BATCHES``: ``exploit_mix`` at 2
transactions, ``wide_mix`` and ``loop_tail`` at 1; forced pipelined
frontier of 64 paths, ``loop_bound`` 600, the forced device probe), each
with the controller on and off, ``loop_tail`` also on under
``coverage_target`` 90: the issue sets, the segments, the ``adaptive.*``
counters and the latched ``stop_state()``.  Regenerate with

    JAX_PLATFORMS=cpu python tests/test_torch_adaptive.py --write [label ...]

(each JAX analysis in a process of its own, three at a time, about six
minutes).  Under pytest the port on the CPU reproduces the two small
contracts' runs (issues; on ``--no-pipeline`` the ledger's bitmaps and
termination classes; ``partition_ok``), the same issues with
``--no-adaptive`` and no plan, ``exploit_mix``'s issue sets with the
controller on and off, and the park pool's exactly-once rule under a
synthetic spill storm.  ``chip_smoke.py`` phase 8g runs every recorded run
and batch on the card.
"""

from __future__ import annotations

import contextlib
import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from tests._torch_parity import _one_torch_thread  # noqa: E402,F401  (autouse fixture)
from tests import test_torch_engine_fixture as F  # noqa: E402

FIXTURE = REPO / "tests" / "testdata" / "torch_engine_runs_adaptive.json"
KILLABLE = ["AccidentallyKillable"]
# (name, width, transactions, modules); each pipelined and --no-pipeline
RUNS = (
    ("kill_simple", 64, 1, KILLABLE),
    ("storage_gate", 64, 2, KILLABLE),
    ("etherstore_like", 256, 2, None),
    ("rubixi_like", 256, 2, None),
)
# replayed by the port on the CPU under pytest; the others on the card only
CPU_RUNS = ("kill_simple", "storage_gate")

# the contracts of bench.py adaptive_compare: a selector dispatch to
# CALLER;SELFDESTRUCT, a two-gate selfdestruct, and a dispatch to
# CALLER;SELFDESTRUCT falling through into a 511-iteration concrete counter
# loop ending in STOP (every instruction but the loop's exit STOP is covered
# after one iteration)
SUICIDE = "60003560e01c6341c0e1b51460145760006000fd5b33ff"
GATED = "60003580600a9010600c57005b80600514601c5780601414601c57005b33ff"
LOOP_TAIL = "60003560e01c6341c0e1b514601e5760005b600101806102001160115700" "5b33ff"
# name -> (jobs as (name, code name), transactions, coverage target of the
# steered run)
BATCHES = {
    "exploit_mix": ((("suicide", "suicide"), ("gated", "gated"), ("killbilly", "killbilly")),
                    2, None),
    "wide_mix": (tuple((f"wide{n}", f"wide_contract_{n}") for n in (3, 4, 5, 6)), 1, None),
    "loop_tail": ((("loop_tail", "loop_tail"), ("suicide", "suicide")), 1, 90.0),
}
# the batch replayed on the CPU under pytest (the smallest whose recording
# shows the scheduler steering)
CPU_BATCH = "exploit_mix"
COOPERATIVE_ARGS = dict(frontier=True, frontier_force=True, frontier_width=64, pipeline=True,
                        loop_bound=600)
COOPERATIVE_TIMEOUT = 120


def label(name: str, width: int, pipeline: bool) -> str:
    return f"{name}/{width}" + ("" if pipeline else "/no-pipeline")


def code_of(name: str) -> bytes:
    from tests.test_torch_pipeline import code_of as pipeline_code

    if name == "suicide":
        return bytes.fromhex(SUICIDE)
    if name == "gated":
        return bytes.fromhex(GATED)
    if name == "loop_tail":
        return bytes.fromhex(LOOP_TAIL)
    if name == "killbilly":
        import bench

        return bytes.fromhex(bench.KILLBILLY)
    if name.startswith("wide_contract_"):
        import bench

        return bench._wide_contract(int(name.rsplit("_", 1)[1]))
    return pipeline_code(name)


def batch_jobs(batch: str) -> list:
    return [(name, code_of(code)) for name, code in BATCHES[batch][0]]


# ---------------------------------------------------------------------------
# the recording
# ---------------------------------------------------------------------------


def _keep(run: dict) -> dict:
    return {"summary": run["summary"], "frontier_stats": run["frontier"],
            "pipeline": run["pipeline"], "exploration": run["exploration"],
            "adaptive": run["adaptive"], "tiers": run["tiers"], "cdcl": run["cdcl"],
            "jax_cpu_seconds": run["seconds"]}


def _analyze(name: str, width: int, tx: int, modules, pipeline: bool) -> dict:
    from tests._torch_parity import jax_engine_config_adaptive, run_analysis

    with F.bounded_xla_programs(), jax_engine_config_adaptive(pipeline):
        run = run_analysis("mythril_tpu", code_of(name), tx_count=tx, strategy=F.STRATEGY,
                           frontier=True, force=True, width=width, timeout=F.TIMEOUT,
                           modules=modules, record=False)
    return _keep(run)


def cooperative(base: str, batch: str, adaptive: bool, target=None, device=None) -> dict:
    """One cooperative batch of ``base`` ("mythril_tpu" under
    ``jax_engine_config_adaptive``, or the port on ``device`` with its
    defaults but the forced device probe, uncalibrated) with
    ``COOPERATIVE_ARGS``, the controller on or off and the
    coverage target, every cache cleared first -> the issue set (name,
    SWC, address, code hash per issue, sorted), the segments, the
    ``adaptive.*`` counters, the latched stop, the ``pipeline.*`` counters
    and the wall."""
    import importlib
    import time

    from tests._torch_parity import (
        _reset,
        adaptive_counters,
        pipeline_counters,
        port_probe_backend,
        port_uncalibrated,
    )

    args = importlib.import_module(f"{base}.support.support_args").args
    coop = importlib.import_module(f"{base}.analysis.cooperative")
    stats = importlib.import_module(f"{base}.frontier.stats")
    controller = importlib.import_module(f"{base}.adaptive").get_adaptive_controller()
    saved = {k: getattr(args, k) for k in (*COOPERATIVE_ARGS, "adaptive", "coverage_target")}
    _reset(base)
    for k, v in COOPERATIVE_ARGS.items():
        setattr(args, k, v)
    args.adaptive, args.coverage_target = adaptive, target
    kw = {} if base == "mythril_tpu" else {"device": device}
    try:
        with contextlib.ExitStack() as stack:
            if base != "mythril_tpu":  # the forced device probe, as recorded
                stack.enter_context(port_probe_backend("device"))
                stack.enter_context(port_uncalibrated())
            t0 = time.perf_counter()
            per_name, _states = coop.analyze_cooperative(
                batch_jobs(batch), transaction_count=BATCHES[batch][1],
                execution_timeout=COOPERATIVE_TIMEOUT, **kw)
            seconds = time.perf_counter() - t0
    finally:
        for k, v in saved.items():
            setattr(args, k, v)
    issues = sorted([name, i.swc_id, i.address, i.bytecode_hash]
                    for name, found in per_name.items() for i in found)
    return {"issues": issues, "segments": stats.FrontierStatistics().segments,
            "adaptive": adaptive_counters(base), "stop": controller.stop_state(),
            "pipeline": pipeline_counters(base), "seconds": seconds}


def cooperative_modes(batch: str) -> list:
    """(adaptive, coverage target) of each recorded run of ``batch``."""
    target = BATCHES[batch][2]
    return [(True, None), (False, None)] + ([(True, target)] if target else [])


def _cooperative_jax(batch: str, adaptive: bool, target) -> dict:
    from tests._torch_parity import jax_engine_config_adaptive

    with F.bounded_xla_programs(), jax_engine_config_adaptive(True):
        return cooperative("mythril_tpu", batch, adaptive, target)


def _subprocess(*argv) -> dict:
    import subprocess

    out = subprocess.run([sys.executable, __file__, *argv], capture_output=True, text=True,
                         check=True, cwd=str(REPO))
    return json.loads(out.stdout.strip().splitlines()[-1])


def record(name: str, width: int, tx: int, modules, pipeline: bool) -> dict:
    run = {"name": name, "code": code_of(name).hex(), "width": width, "transactions": tx,
           "strategy": F.STRATEGY, "modules": modules, "pipelined": pipeline}
    run.update(_subprocess("--analyze", name, str(width), str(tx), ",".join(modules or []),
                           str(int(pipeline))))
    return run


def record_batch(batch: str, adaptive: bool, target) -> dict:
    out = {"batch": batch, "steered": adaptive, "coverage_target": target}
    out.update(_subprocess("--cooperative", batch, str(int(adaptive)), str(target or "")))
    return out


def planned() -> list:
    """Every recording as (label, recorder, arguments), in order."""
    todo = [(label(n, w, p), record, (n, w, t, m, p)) for n, w, t, m in RUNS for p in (True, False)]
    for batch in BATCHES:
        for adaptive, target in cooperative_modes(batch):
            todo.append((batch_label(batch, adaptive, target), record_batch,
                         (batch, adaptive, target)))
    return todo


def batch_label(batch: str, adaptive: bool, target=None) -> str:
    return f"{batch}/{'adaptive' if adaptive else 'no-adaptive'}" + (
        f"/target-{target:g}" if target else "")


def write_fixture(labels=()) -> dict:
    """Record ``labels`` (all when empty), three at a time, and merge them
    into the fixture in the order of ``planned``."""
    from concurrent.futures import ThreadPoolExecutor

    todo = [p for p in planned() if not labels or p[0] in labels]
    with ThreadPoolExecutor(3) as pool:
        done = list(pool.map(lambda p: (p[0], p[1](*p[2])), todo))
    old = load_fixture() if FIXTURE.exists() else {}
    old = {**{label(r["name"], r["width"], r["pipelined"]): r for r in old.get("runs", ())},
           **{batch_label(r["batch"], r["steered"], r["coverage_target"]): r
              for r in old.get("cooperative", ())}}
    for lbl, got in done:
        old[lbl] = got
        print(f"{lbl}: {len(got.get('summary', got.get('issues', ())))} issues, adaptive "
              f"{got['adaptive']}, {got.get('jax_cpu_seconds', got.get('seconds')):.1f} s",
              flush=True)
    order = [p[0] for p in planned()]
    runs = [old[k] for k in order if k in old and "name" in old[k]]
    batches = [old[k] for k in order if k in old and "batch" in old[k]]
    FIXTURE.write_text(json.dumps({"runs": runs, "cooperative": batches}, indent=1) + "\n")
    return load_fixture()


def load_fixture() -> dict:
    return json.loads(FIXTURE.read_text())


def run_of(lbl: str) -> dict:
    return next(r for r in load_fixture()["runs"]
                if label(r["name"], r["width"], r["pipelined"]) == lbl)


def batch_of(batch: str, adaptive: bool, target=None) -> dict:
    return next(r for r in load_fixture()["cooperative"]
                if (r["batch"], r["steered"], r["coverage_target"]) == (batch, adaptive, target))


def run_port(run: dict, device, adaptive: bool = True, pipeline=None) -> dict:
    """One recorded run through the port's analysis on ``device`` with its
    defaults (the adaptive controller on unless ``adaptive`` is False; the
    pipeline as recorded unless ``pipeline`` says otherwise)."""
    from tests._torch_parity import run_analysis

    return run_analysis("mythril_tpu_torch", bytes.fromhex(run["code"]),
                        tx_count=run["transactions"], strategy=run["strategy"],
                        frontier=True, force=True, width=run["width"], timeout=F.TIMEOUT,
                        modules=run["modules"], device=device, record=False, cdcl=True,
                        tiers=True, defaults=True,
                        pipeline=run["pipelined"] if pipeline is None else pipeline,
                        adaptive=adaptive)


def check_run(run: dict, got: dict, adaptive: bool = True) -> list:
    """A run of the port against its recording: the issue summary, no
    replay or commit error, the ledger's partition; on ``--no-pipeline``
    (whose dispatch sequence does not depend on when the pool's verdicts
    land) the ledger's coverage bitmaps, coverage and termination classes;
    with ``--no-adaptive``, no plan and no resteered slot."""
    from tests.test_torch_pipeline import summary_differences

    bad = summary_differences(run["summary"], got["summary"])
    for k in ("replay_errors", "commit_errors"):
        if got["frontier"][k]:
            bad.append(f"{k} {got['frontier'][k]}")
    ex = got["exploration"]
    if not ex["partition_ok"]:
        bad.append("the ledger's termination classes do not partition its total")
    if not run["pipelined"]:
        want = run["exploration"]
        for k in ("bitmaps", "coverage", "terminated", "terminated_total", "pc_overflow"):
            if ex[k] != want[k]:
                bad.append(f"exploration {k} differs: {ex[k]} != {want[k]}"[:300])
    if not adaptive and (got["adaptive"]["plans"] or got["adaptive"]["resteered_slots"]):
        bad.append(f"--no-adaptive planned or steered: {got['adaptive']}")
    return bad


# ---------------------------------------------------------------------------
# the JAX package's own cases, run on the port
# ---------------------------------------------------------------------------


def port_cases(path: Path, name: str, subs=()) -> types.ModuleType:
    """The JAX test module at ``path`` with the package renamed, as a module
    of its own: its test functions and fixtures then run on the port.
    ``subs``: further (pattern, replacement) rewrites, applied in order
    after the rename (the device an entry point of the port runs on)."""
    import re

    src = re.sub(r"\bmythril_tpu(?!_torch)\b", "mythril_tpu_torch", path.read_text())
    for pattern, repl in subs:
        src, n = re.subn(pattern, repl, src)
        assert n, f"{path.name}: the rewrite {pattern!r} matched nothing"
    mod = types.ModuleType(name)
    mod.__file__ = str(path)
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


_PLAN = port_cases(REPO / "tests" / "adaptive" / "test_plan.py", "port_test_plan")
_CONTROLLER = port_cases(REPO / "tests" / "adaptive" / "test_controller.py",
                         "port_test_controller")
ctrl = _CONTROLLER.ctrl  # the JAX cases' fixture, on the port
for _mod, _prefix in ((_PLAN, "Plan"), (_CONTROLLER, "Controller")):
    for _name, _case in vars(_mod).items():
        if _name.startswith("Test") and isinstance(_case, type):
            globals()[f"TestPort{_prefix}{_name[4:]}"] = _case
del _mod, _prefix, _name, _case


# ---------------------------------------------------------------------------
# the planner on seeded ledger snapshots
# ---------------------------------------------------------------------------

def seeded_snapshot(rng: np.random.Generator, n_codes: int) -> dict:
    """``build_plan``'s inputs for ``n_codes`` codes: bitmaps with random
    executed planes (a code in three without reachability masks),
    histories, parked lists, interesting points and hotspot seconds."""
    bitmaps, history, points, hot = {}, {}, {}, {}
    for c in range(n_codes):
        h = "%064x" % int(rng.integers(1 << 62))
        n = int(rng.integers(4, 40))
        jumpi = rng.random(n) < 0.25
        masked = c % 3 != 2
        bitmaps[h] = {
            "total": n, "jumpis": int(jumpi.sum()),
            "instr": rng.random(n) < 0.6,
            "edge_taken": jumpi & (rng.random(n) < 0.5),
            "edge_fall": jumpi & (rng.random(n) < 0.5),
            "reach_instr": (rng.random(n) < 0.9) if masked else None,
            "reach_taken": (jumpi & (rng.random(n) < 0.8)) if masked else None,
            "reach_fall": (jumpi & (rng.random(n) < 0.8)) if masked else None,
        }
        history[h] = [float(x) for x in np.cumsum(rng.random(int(rng.integers(0, 9))))]
        if rng.random() < 0.7:
            points[h] = [{"addr": int(a), "score": float(rng.integers(1, 9))}
                         for a in rng.choice(n, size=min(n, 3), replace=False)]
        if rng.random() < 0.6:
            hot[h] = float(rng.random() * 3)
    parked = [(int(t), "budget_exhausted" if rng.random() < 0.7 else "loop_bound")
              for t in rng.integers(0, 20, size=int(rng.integers(0, 12)))]
    live = [int(t) for t in rng.integers(0, 20, size=3)]
    return {"bitmaps": bitmaps, "history": history, "parked": parked, "live": live,
            "points": points, "hotspot_s": hot}


def _plan(base: str, snap: dict):
    import importlib
    from dataclasses import asdict

    plan = importlib.import_module(f"{base}.adaptive.plan")
    out = asdict(plan.build_plan(snap["bitmaps"], history=snap["history"],
                                 parked=snap["parked"], live=snap["live"],
                                 points=snap["points"], hotspot_s=snap["hotspot_s"]))
    out["uncovered"] = {h: [a.tolist() if isinstance(a, np.ndarray) else a
                            for a in plan.uncovered_reachable(bm)]
                        for h, bm in snap["bitmaps"].items()}
    out["plateau"] = {h: plan.plateau_verdict(v) for h, v in snap["history"].items()}
    return out


@pytest.mark.parametrize("n_codes", range(1, 7))
def test_plan_equals_jax_on_seeded_snapshots(n_codes):
    rng = np.random.default_rng(1500 + n_codes)
    for _ in range(8):
        snap = seeded_snapshot(rng, n_codes)
        want, got = _plan("mythril_tpu", snap), _plan("mythril_tpu_torch", snap)
        assert got == want
        assert got["weights"] and abs(sum(got["weights"].values()) - 1.0) < 1e-9


# ---------------------------------------------------------------------------
# the controller on a pinned clock
# ---------------------------------------------------------------------------


class _Clock:
    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now


def _controller_trace(base: str, script: list, monkeypatch) -> list:
    """Run ``script`` (ledger updates and controller calls, in order) on a
    fresh controller and ledger of ``base`` with a private registry, the
    clock pinned (``time.monotonic`` in the controller module) -> every
    call's result, the plans and ``meta()``."""
    import importlib
    from dataclasses import asdict

    ctl_mod = importlib.import_module(f"{base}.adaptive.controller")
    metrics = importlib.import_module(f"{base}.observability.metrics")
    exploration = importlib.import_module(f"{base}.observability.exploration")
    args = importlib.import_module(f"{base}.support.support_args").args
    clock = _Clock()
    monkeypatch.setattr(ctl_mod.time, "monotonic", clock)
    monkeypatch.setattr(args, "adaptive", True)
    monkeypatch.setattr(args, "coverage_target", None)
    reg = metrics.MetricsRegistry()
    led = exploration.ExplorationLedger(registry=reg)
    ctrl = ctl_mod.AdaptiveController(registry=reg)
    monkeypatch.setattr(ctrl, "_ledger", lambda: led)
    out = []
    for op, *a in script:
        if op == "tick":
            clock.now += a[0]
        elif op == "planes":
            led.record_device_planes(*a)
        elif op == "static":
            led.register_static(*a)
        elif op == "solver":
            led.record_solver_time(*a)
        elif op == "points":
            ctrl.register_points(*a)
        elif op == "plan":
            out.append(("plan", asdict(ctrl.plan(force=a[0]))))
        elif op == "pick":
            out.append(("pick", ctrl.pick_seed(a[0])))
        elif op == "requeue":
            out.append(("requeue", ctrl.select_requeue(a[0], live=a[1], limit=a[2])))
        elif op == "stop":
            out.append(("stop", ctrl.coverage_stop(a[0]), ctrl.stop_state()))
        elif op == "flips":
            out.append(("flips", ctrl.flip_targets_for(a[0])))
    out.append(("meta", ctrl.meta()))
    return out


def controller_script(rng: np.random.Generator, n_codes: int, steps: int = 60) -> list:
    """A seeded sequence of ledger updates and controller calls over
    ``n_codes`` codes, the clock advanced between them."""
    codes = []
    for _ in range(n_codes):
        h = "%064x" % int(rng.integers(1 << 62))
        n = int(rng.integers(6, 30))
        jumpi = rng.random(n) < 0.3
        codes.append((h, n, jumpi))
    script = []
    for h, n, jumpi in codes:
        if rng.random() < 0.7:
            script.append(("static", h, rng.random(n) < 0.9, jumpi & (rng.random(n) < 0.8),
                           jumpi & (rng.random(n) < 0.8)))
        script.append(("points", h, [{"addr": int(a), "score": float(rng.integers(1, 9))}
                                     for a in rng.choice(n, size=2, replace=False)]))
    for _ in range(steps):
        h, n, jumpi = codes[int(rng.integers(len(codes)))]
        r = rng.random()
        if r < 0.3:
            planes = np.stack([rng.random(n) < 0.2, jumpi & (rng.random(n) < 0.2),
                               jumpi & (rng.random(n) < 0.2)])
            script.append(("planes", h, n, int(jumpi.sum()), planes))
        elif r < 0.4:
            script.append(("solver", "%s:%#x" % (h[:10], int(rng.integers(n))),
                           float(rng.integers(1, 50)) / 100))
        elif r < 0.6:
            queue = [codes[int(i)][0] for i in rng.integers(len(codes), size=int(rng.integers(1, 6)))]
            script.append(("pick", queue))
        elif r < 0.7:
            parked = [(int(t), "budget_exhausted" if rng.random() < 0.8 else "completed")
                      for t in rng.integers(0, 30, size=int(rng.integers(0, 8)))]
            script.append(("requeue", parked, [int(rng.integers(30))], int(rng.integers(1, 6))))
        elif r < 0.8:
            script.append(("stop", float(rng.choice([50.0, 80.0, 95.0, 100.0]))))
        elif r < 0.85:
            script.append(("flips", h))
        else:
            script.append(("plan", bool(rng.random() < 0.3)))
        script.append(("tick", float(rng.choice([0.01, 0.05, 0.2]))))
    return script


@pytest.mark.parametrize("n_codes", (1, 2, 3, 5))
def test_controller_equals_jax_on_a_pinned_clock(n_codes, monkeypatch):
    script = controller_script(np.random.default_rng(2600 + n_codes), n_codes)
    want = _controller_trace("mythril_tpu", script, monkeypatch)
    got = _controller_trace("mythril_tpu_torch", script, monkeypatch)
    assert got == want
    meta = got[-1][1]
    assert meta["plans"] > 0
    if n_codes > 1:
        assert any(op == "pick" and pos for op, pos, *_ in got)


# ---------------------------------------------------------------------------
# whole analyses
# ---------------------------------------------------------------------------


def test_fixture_holds_every_run():
    fx = load_fixture()
    assert [(r["name"], r["width"], r["transactions"], r["modules"], r["pipelined"])
            for r in fx["runs"]] == [(n, w, t, m, p) for n, w, t, m in RUNS for p in (True, False)]
    for r in fx["runs"]:
        assert r["code"] == code_of(r["name"]).hex() and r["summary"]
        assert r["exploration"]["partition_ok"] and r["exploration"]["terminated_total"] > 0
        assert r["exploration"]["bitmaps"] and r["frontier_stats"]["replay_errors"] == 0
    assert [(b["batch"], b["steered"], b["coverage_target"]) for b in fx["cooperative"]] == \
        [(b, a, t) for b in BATCHES for a, t in cooperative_modes(b)]
    steered = 0
    for batch in BATCHES:
        on, off = batch_of(batch, True), batch_of(batch, False)
        # steering reorders the work, never what is found
        assert on["issues"] == off["issues"] and on["issues"]
        assert off["adaptive"]["plans"] == off["adaptive"]["resteered_slots"] == 0
        steered += on["adaptive"]["resteered_slots"]
    assert steered > 0 and batch_of(CPU_BATCH, True)["adaptive"]["resteered_slots"] > 0
    # the coverage target latches a stop; it saves the JAX package no
    # segment: the device planes reach the ledger when a drain ends, and
    # loop_tail's one drain runs the loop to its end either way
    target = batch_of("loop_tail", True, 90.0)
    assert target["stop"] and target["stop"]["reason"] == "target"
    assert target["segments"] == batch_of("loop_tail", False)["segments"]
    assert target["issues"] == batch_of("loop_tail", False)["issues"]


@pytest.mark.parametrize("name", CPU_RUNS)
def test_port_reproduces_the_adaptive_recording_on_cpu(name):
    from mythril_tpu_torch.frontier.harvest import shutdown_replay_pool
    from tests.test_torch_pipeline import summary_differences

    try:
        got = run_port(run_of(label(name, 64, True)), "cpu")
        assert check_run(run_of(label(name, 64, True)), got) == []
        # --no-adaptive on the loop whose ledger is held exactly
        run = run_of(label(name, 64, False))
        for adaptive in (True, False):
            other = run_port(run, "cpu", adaptive=adaptive)
            assert check_run(run, other, adaptive=adaptive) == []
            assert summary_differences(got["summary"], other["summary"]) == []
    finally:
        shutdown_replay_pool()


@pytest.mark.parametrize("adaptive", (True, False))
def test_port_cooperative_batch_equals_jax_on_cpu(adaptive):
    want = batch_of(CPU_BATCH, adaptive)
    got = cooperative("mythril_tpu_torch", CPU_BATCH, adaptive, device="cpu")
    assert got["issues"] == want["issues"]
    if adaptive:
        assert got["adaptive"]["plans"] > 0 and got["adaptive"]["resteered_slots"] > 0
    else:
        assert got["adaptive"]["plans"] == got["adaptive"]["resteered_slots"] == 0


def test_cooperative_batch_propagates_one_jobs_error(monkeypatch):
    """A job whose host continuation raises fails the whole batch: no job's
    error is isolated from the others."""
    from mythril_tpu_torch.analysis.cooperative import analyze_cooperative
    from mythril_tpu_torch.core.svm import LaserEVM
    from mythril_tpu_torch.support.support_args import args
    from tests._torch_parity import _reset

    _reset("mythril_tpu_torch")
    monkeypatch.setattr(args, "frontier", False)
    exec_ = LaserEVM.exec
    calls = []

    def failing_second(self, *a, **kw):
        calls.append(self)
        if len(calls) == 2:
            raise RuntimeError("the second job's host engine failed")
        return exec_(self, *a, **kw)

    monkeypatch.setattr(LaserEVM, "exec", failing_second)
    with pytest.raises(RuntimeError, match="second job"):
        analyze_cooperative(batch_jobs(CPU_BATCH)[:2], transaction_count=1,
                            execution_timeout=COOPERATIVE_TIMEOUT, device="cpu")
    assert len(calls) == 2 and calls[0] is not calls[1]


# ---------------------------------------------------------------------------
# the park pool: exactly once
# ---------------------------------------------------------------------------


class _Laser:
    def __init__(self):
        self.work_list = []


class _Carrier:
    """A spilled state ``_mid_eligible`` accepts: pc inside its code, a
    short stack, no memory."""

    def __init__(self, i: int):
        from mythril_tpu_torch.core.state.memory import Memory

        self.i = i
        self.mstate = types.SimpleNamespace(pc=1, stack=[], memory=Memory())
        self.environment = types.SimpleNamespace(
            code=types.SimpleNamespace(instruction_list=[None] * 4), static=False)


def _runner(B: int):
    from mythril_tpu_torch.frontier.pipeline import PipelinedRunner
    from mythril_tpu_torch.frontier.state import Caps, empty_state

    runner = PipelinedRunner.__new__(PipelinedRunner)
    runner.caps = Caps(B=B)
    runner.st = empty_state(runner.caps, 4)
    runner.records = {s: None for s in range(B)}
    runner.reinject_q, runner.adaptive_parked, runner.seed_queue = [], [], []
    from mythril_tpu_torch.frontier.pipeline import CorrectionLedger

    runner.ledger = CorrectionLedger(B)
    return runner


@pytest.mark.parametrize("adaptive", (True, False))
def test_park_pool_holds_each_carrier_exactly_once(adaptive, monkeypatch):
    """A synthetic spill storm at B = 8 pushes past the re-injection
    queue's 2B: the next 4B spills wait in the park pool (with the
    controller on), the rest go to the host; the plan's requeue moves
    pooled carriers into the queue as slots free; the flush at the run's
    end hands every pooled carrier back.  Every carrier ends in exactly
    one place."""
    from mythril_tpu_torch.adaptive import get_adaptive_controller
    from mythril_tpu_torch.frontier import pipeline
    from mythril_tpu_torch.support.support_args import args

    monkeypatch.setattr(args, "adaptive", adaptive)
    pipeline.reset_counters()
    get_adaptive_controller().reset_scope()
    B, laser = 8, _Laser()
    runner = _runner(B)
    carriers = [_Carrier(i) for i in range(8 * B)]
    taken = [runner._park_sink(laser, None, c, {}) for c in carriers]

    def places():
        where = {}
        for name, items in (("queue", [c for _l, c in runner.reinject_q]),
                            ("pool", [c for _l, c in runner.adaptive_parked]),
                            ("host", laser.work_list)):
            for c in items:
                where.setdefault(c.i, []).append(name)
        return where

    pooled = 4 * B if adaptive else 0
    assert len(runner.reinject_q) == 2 * B and len(runner.adaptive_parked) == pooled
    assert sum(taken) == 2 * B + pooled
    assert pipeline.COUNTERS["adaptive_parked"] == pooled
    for c, ok in zip(carriers, taken):
        if not ok:  # the walker sends a refused spill to the host
            laser.work_list.append(c)
    assert all(len(v) == 1 for v in places().values()) and len(places()) == len(carriers)
    # a sync point with the queue drained and every slot free: the plan
    # names pooled carriers to requeue, at most as many as free slots
    runner.reinject_q = []
    runner._adaptive_requeue()
    moved = len(runner.reinject_q)
    assert moved == (B if adaptive else 0)
    assert len(runner.adaptive_parked) == pooled - moved
    for c in [c for _l, c in runner.reinject_q]:  # re-injected into slots
        c.i = -1 - c.i
    runner.reinject_q = []
    runner._flush_reinject_queue()
    assert runner.adaptive_parked == [] and runner.reinject_q == []
    where = places()
    assert all(v == ["host"] for v in where.values())
    assert len(where) == len(carriers) - 2 * B - moved


if __name__ == "__main__":
    import os

    if sys.argv[1:2] in (["--analyze"], ["--cooperative"]):
        if sys.argv[1] == "--analyze":
            name, width, tx, modules, pipeline = sys.argv[2:7]
            got = _analyze(name, int(width), int(tx), modules.split(",") if modules else None,
                           pipeline == "1")
        else:
            batch, adaptive, target = sys.argv[2:5]
            got = _cooperative_jax(batch, adaptive == "1", float(target) if target else None)
        print(json.dumps(got), flush=True)
        # the JAX package's worker threads outlive the run; leave without
        # tearing them down
        os._exit(0)
    if "--write" not in sys.argv:
        sys.exit("usage: JAX_PLATFORMS=cpu python tests/test_torch_adaptive.py --write "
                 "[label ...]")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    fixture = write_fixture([a for a in sys.argv[1:] if a != "--write"])
    print(f"{FIXTURE}: {FIXTURE.stat().st_size} bytes, {len(fixture['runs'])} runs, "
          f"{len(fixture['cooperative'])} cooperative runs")
