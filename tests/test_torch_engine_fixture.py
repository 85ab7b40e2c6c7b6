"""Whole analyses recorded from the JAX package, for the port on the card.

``tests/testdata/torch_engine_runs.json`` holds, per run, what the port's
analysis must reproduce without JAX (``chip_smoke.py``'s engine phase runs
it on the card): the bytecode hex, width, transaction count and strategy;
the issues (keys, transaction step counts, last-step selectors); for the
frontier runs every segment dispatch's input and output digests (one
sha256 each over ``interop.input_digests`` / ``output_digests``, beside the
output scalars) and the frontier's counters; the JAX package's wall time on
the CPU; and, for information only, the issue keys under the JAX package's
default tiers and engine (query cache, prefilter, devsolver, native CDCL,
pipeline, static pass), which the port does not all carry yet.

The runs: ``bench_contracts`` ``etherstore_like`` and ``rubixi_like`` at
width 256, 2 transactions, and ``bectoken_like`` at width 256, 1
transaction; ``bench._wide_contract(10)`` at width 1024 and
``bench._largecode_contract(2400)`` at width 256, 1 transaction;
``kill_simple.bin-runtime``, 2 transactions.  ``bectoken_like`` runs one
transaction because the JAX package cannot record two here: under the
port's tiers its tape VM runs on XLA's CPU backend, which takes the first
transaction's ``jax_cpu_seconds`` alone, and a two-transaction run passed
its execution timeout and then exhausted the process's memory maps.  Each runs with
the frontier forced (``frontier=True, frontier_force=True``) and the runs
in ``HOST_RUNS`` also with the host engine (``frontier=False``).  The JAX
package runs under ``jax_engine_config`` (the port's tiers and engine
configuration).  Regenerate with

    JAX_PLATFORMS=cpu python tests/test_torch_engine_fixture.py --write

Under pytest: the fixture holds every run, and the port's engine on the CPU
reproduces the smallest runs exactly.
"""

from __future__ import annotations

import contextlib
import json
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:  # run as a script (--write)
    sys.path.insert(0, str(REPO))
from tests._torch_parity import _one_torch_thread  # noqa: E402,F401  (autouse fixture)
FIXTURE = REPO / "tests" / "testdata" / "torch_engine_runs.json"

# (name, width, transactions)
RUNS = (
    ("bectoken_like", 256, 1),
    ("etherstore_like", 256, 2),
    ("rubixi_like", 256, 2),
    ("wide_contract_10", 1024, 1),
    ("largecode_contract_2400", 256, 1),
    ("kill_simple", 64, 2),
)
# runs that the host engine also analyzes (its JAX wall time on the CPU,
# written into the fixture, keeps chip_smoke.py's engine phase short)
HOST_RUNS = ("etherstore_like", "rubixi_like", "kill_simple")
STRATEGY = "bfs"
# no run may reach its execution timeout: a run cut by the clock cannot be
# repeated exactly (the JAX package's bectoken_like run takes the longest)
TIMEOUT = 3600
# the port's engine on the CPU replays these under pytest; the others run
# on the card only.  Of the two smallest bench_contracts runs only
# rubixi_like fits: its frontier run takes about 30 s on one CPU core, and
# etherstore_like's about 70 s (the plain segment at width 256 and the
# plain tape VM carry it)
CPU_RUNS = ("rubixi_like", "kill_simple")


def code_of(name: str) -> bytes:
    sys.path.insert(0, str(REPO))
    import bench
    import bench_contracts

    if name == "wide_contract_10":
        return bench._wide_contract(10)
    if name == "largecode_contract_2400":
        return bench._largecode_contract(2400)
    if name == "kill_simple":
        path = REPO / "tests" / "testdata" / "inputs" / "kill_simple.bin-runtime"
        return bytes.fromhex(path.read_text().strip())
    return getattr(bench_contracts, name)()


def digest(d: dict) -> str:
    """One sha256 over a digest dict (its JSON with sorted keys)."""
    import hashlib

    return hashlib.sha256(json.dumps(d, sort_keys=True).encode()).hexdigest()


def compact(dispatches) -> list:
    """``run_analysis``'s dispatch digests as the fixture stores them."""
    return [{"in": digest(d["in"]), "out": digest(d["out"]),
             **{k: d["out"][k] for k in ("arena_len", "n_exec", "max_live")}}
            for d in dispatches]


@contextlib.contextmanager
def bounded_xla_programs():
    """Drop the JAX package's compiled programs every 8 device evaluations.

    A long analysis compiles a program per conjunction the tape cannot
    express, and XLA maps memory for each; dropping them keeps the process
    under its memory-map limit (it only costs recompiles)."""
    import jax

    from mythril_tpu.ops import lowering
    from mythril_tpu.smt import solver

    evaluate, calls = solver._evaluate_candidates_device, [0]

    def bounded(*a, **kw):
        calls[0] += 1
        if calls[0] % 8 == 0:
            lowering._CACHE.clear()
            jax.clear_caches()
        return evaluate(*a, **kw)

    solver._evaluate_candidates_device = bounded
    try:
        yield
    finally:
        solver._evaluate_candidates_device = evaluate


def _analyze(name: str, width: int, tx: int, frontier: bool, same_tiers: bool) -> dict:
    """One JAX analysis for the fixture: under ``jax_engine_config`` when
    ``same_tiers``, else under the JAX package's defaults."""
    from tests._torch_parity import issue_key, jax_engine_config, run_analysis

    with bounded_xla_programs(), (
            jax_engine_config() if same_tiers else contextlib.nullcontext()):
        run = run_analysis("mythril_tpu", code_of(name), tx_count=tx, strategy=STRATEGY,
                           frontier=frontier, force=frontier, width=width, timeout=TIMEOUT,
                           record=same_tiers)
    if not same_tiers:
        return {"default_tiers_keys": sorted(list(issue_key(i)) for i in run["issues"])}
    return {"summary": run["summary"], "dispatches": compact(run["dispatches"]),
            "frontier_stats": run["frontier"], "jax_cpu_seconds": run["seconds"]}


def record(name: str, width: int, tx: int, frontier: bool) -> dict:
    """Both JAX analyses of one fixture run, each in a process of its own
    (XLA's compiled programs of one bectoken_like analysis already exhaust
    a process's memory maps)."""
    import subprocess

    run = {"name": name, "code": code_of(name).hex(), "width": width, "transactions": tx,
           "strategy": STRATEGY, "frontier": frontier}
    for same in (True, False):
        out = subprocess.run(
            [sys.executable, __file__, "--analyze", name, str(width), str(tx), str(int(frontier)),
             str(int(same))], capture_output=True, text=True, check=True, cwd=str(REPO))
        run.update(json.loads(out.stdout.strip().splitlines()[-1]))
    return run


def planned() -> list:
    """(name, width, transactions, frontier) of every fixture run, in order."""
    return [(n, w, t, f) for n, w, t in RUNS for f in ((True, False) if n in HOST_RUNS else (True,))]


def write_fixture(names=()) -> list:
    """Record the runs of ``names`` (all when empty) and merge them into the
    fixture, which keeps the order of ``planned()``; several writers may
    run at once on disjoint names."""
    import fcntl

    order = [(n, f) for n, _w, _t, f in planned()]
    for name, width, tx, frontier in planned():
        if names and name not in names:
            continue
        run = record(name, width, tx, frontier)
        print(f"{name} frontier={frontier}: {len(run['dispatches'])} dispatches, "
              f"{len(run['summary'])} issues, {run['jax_cpu_seconds']:.1f} s", flush=True)
        with open(FIXTURE.with_suffix(".lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            runs = load_runs() if FIXTURE.exists() else []
            runs = [r for r in runs if (r["name"], r["frontier"]) != (name, frontier)] + [run]
            runs.sort(key=lambda r: order.index((r["name"], r["frontier"])))
            FIXTURE.write_text(json.dumps({"runs": runs}, indent=1) + "\n")
    return load_runs()


def load_runs(path=FIXTURE) -> list:
    return json.loads(Path(path).read_text())["runs"]


def check_run(run: dict, got: dict) -> list:
    """What differs between a fixture run and ``run_analysis``'s result:
    issue keys, step counts, the selector wherever the issue's function
    names one, and for the frontier the dispatches and their digests."""
    bad = []
    want_keys = [r[:5] for r in run["summary"]]
    got_keys = [r[:5] for r in got["summary"]]
    if got_keys != want_keys:
        bad.append(f"issue keys {got_keys} != {want_keys}")
    else:
        for w, g in zip(run["summary"], got["summary"]):
            if w[5] != g[5]:
                bad.append(f"{w[:2]}: {g[5]} steps != {w[5]}")
            elif w[2] != "fallback" and w[6] != g[6]:
                bad.append(f"{w[:2]}: selector {g[6]} != {w[6]}")
    if run["frontier"]:
        got_d = compact(got["dispatches"])
        if len(got_d) != len(run["dispatches"]):
            bad.append(f"{len(got_d)} dispatches != {len(run['dispatches'])}")
        first = next((i for i, (a, b) in enumerate(zip(got_d, run["dispatches"])) if a != b), None)
        if first is not None:
            bad.append(f"dispatch {first} differs: {got_d[first]} != {run['dispatches'][first]}")
        for k in ("replay_errors", "commit_errors"):
            if got["frontier"][k]:
                bad.append(f"{k} {got['frontier'][k]}")
    return bad


def run_port(run: dict, device, record: bool = True) -> dict:
    """One fixture run through the port's analysis on ``device``
    (``record``: the dispatches' digests)."""
    from tests._torch_parity import run_analysis

    return run_analysis("mythril_tpu_torch", bytes.fromhex(run["code"]),
                        tx_count=run["transactions"], strategy=run["strategy"],
                        frontier=run["frontier"], force=run["frontier"], width=run["width"],
                        timeout=TIMEOUT, device=device, record=record)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


def test_fixture_holds_every_run():
    runs = load_runs()
    got = [(r["name"], r["width"], r["transactions"], r["frontier"]) for r in runs]
    assert got == planned()
    for r in runs:
        assert r["code"] and r["strategy"] == STRATEGY
        assert bool(r["dispatches"]) == r["frontier"]
        assert r["frontier_stats"]["replay_errors"] == 0
        assert "timeout" not in r["frontier_stats"]["parks_by_reason"]
        assert r["jax_cpu_seconds"] < TIMEOUT
    by = {(r["name"], r["frontier"]): r for r in runs}
    assert by[("wide_contract_10", True)]["dispatches"][0]["max_live"] == 1024
    assert any(row[0] == "106" for row in by[("kill_simple", True)]["summary"])


@pytest.mark.parametrize("name,frontier", [(n, f) for n in CPU_RUNS for f in (True, False)])
def test_port_reproduces_fixture_on_cpu(name, frontier):
    run = next(r for r in load_runs() if r["name"] == name and r["frontier"] == frontier)
    assert check_run(run, run_port(run, "cpu")) == []


if __name__ == "__main__":
    if sys.argv[1:2] == ["--analyze"]:
        sys.path.insert(0, str(REPO))
        name, width, tx, frontier, same = sys.argv[2:7]
        print(json.dumps(_analyze(name, int(width), int(tx), frontier == "1", same == "1")))
        sys.exit(0)
    if "--write" not in sys.argv:
        sys.exit("usage: JAX_PLATFORMS=cpu python tests/test_torch_engine_fixture.py --write "
                 "[run name ...]")
    import os

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(REPO))
    written = write_fixture([a for a in sys.argv[1:] if a != "--write"])
    print(f"{FIXTURE}: {FIXTURE.stat().st_size} bytes, {len(written)} runs")
