"""Whole analyses under the JAX package's default host tiers, recorded from it.

``tests/testdata/torch_engine_runs_defaults.json`` holds runs recorded under
``_torch_parity.jax_engine_config_defaults``: ``jax_engine_config_tiers``
(native CDCL, the known-bits prefilter and the devsolver) with the static
pass, its interprocedural layer and the query cache on, as the JAX package
runs by default; its pipeline, mesh, adaptive controller and harvest
workers stay off.  The runs: ``etherstore_like`` and ``rubixi_like``
(width 256), ``kill_simple``, ``killbilly_2tx`` (``bench.KILLBILLY``) and
``dead_code`` (``_torch_parity.dead_code_contract``: KillBilly with a dead
span the static pass prunes) at width 64, all at 2 transactions, each on
the forced frontier and on the host engine.  Per run, what the tiers
fixture records (the issues, every frontier dispatch's digests, the
frontier's counters, the JAX package's wall on the CPU, its CDCL counts,
the prefilter's and the devsolver's counters) and the two new counter sets
(``staticpass_counters``, ``querycache_counters``).  Regenerate with

    JAX_PLATFORMS=cpu python tests/test_torch_engine_defaults.py --write [run name ...]

(each JAX analysis in a process of its own, about five minutes in all).

Under pytest: the fixture holds every run, and the port's engine on the CPU,
with its defaults, reproduces ``kill_simple`` (frontier and host engine),
``rubixi_like`` (host engine) and ``dead_code`` (frontier) exactly, every
counter included.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from tests._torch_parity import _one_torch_thread  # noqa: E402,F401  (autouse fixture)
from tests import test_torch_engine_fixture as F  # noqa: E402
from tests import test_torch_engine_tiers as T  # noqa: E402

FIXTURE = REPO / "tests" / "testdata" / "torch_engine_runs_defaults.json"
# (name, width, transactions)
RUNS = (
    ("etherstore_like", 256, 2),
    ("rubixi_like", 256, 2),
    ("kill_simple", 64, 2),
    ("killbilly_2tx", 64, 2),
    ("dead_code", 64, 2),
)
# the port's engine on the CPU replays these under pytest (name, frontier)
CPU_RUNS = (("kill_simple", True), ("kill_simple", False), ("rubixi_like", False),
            ("dead_code", True))
label = T.label


def code_of(name: str) -> bytes:
    from tests._torch_parity import dead_code_contract

    if name == "killbilly_2tx":
        import bench

        return bytes.fromhex(bench.KILLBILLY)
    if name == "dead_code":
        return bytes.fromhex(dead_code_contract())
    return F.code_of(name)


def planned() -> list:
    """(name, width, transactions, frontier) of every run, in order."""
    return [(n, w, t, f) for n, w, t in RUNS for f in (True, False)]


def _analyze(name: str, width: int, tx: int, frontier: bool) -> dict:
    from tests._torch_parity import jax_engine_config_defaults, run_analysis

    with F.bounded_xla_programs(), jax_engine_config_defaults():
        run = run_analysis("mythril_tpu", code_of(name), tx_count=tx, strategy=F.STRATEGY,
                           frontier=frontier, force=frontier, width=width, timeout=F.TIMEOUT,
                           tiers=True, defaults=True)
    return {"summary": run["summary"], "dispatches": F.compact(run["dispatches"]),
            "frontier_stats": run["frontier"], "jax_cpu_seconds": run["seconds"],
            "cdcl": run["cdcl"], "tiers": run["tiers"], "staticpass": run["staticpass"],
            "querycache": run["querycache"]}


def record(name: str, width: int, tx: int, frontier: bool) -> dict:
    import subprocess

    run = {"name": name, "code": code_of(name).hex(), "width": width, "transactions": tx,
           "strategy": F.STRATEGY, "frontier": frontier}
    out = subprocess.run(
        [sys.executable, __file__, "--analyze", name, str(width), str(tx), str(int(frontier))],
        capture_output=True, text=True, check=True, cwd=str(REPO))
    run.update(json.loads(out.stdout.strip().splitlines()[-1]))
    return run


def write_fixture(names=()) -> list:
    """Record the runs of ``names`` (all when empty), three at a time, and
    merge them into the fixture in the order of ``planned()``."""
    from concurrent.futures import ThreadPoolExecutor

    todo = [p for p in planned() if not names or p[0] in names]
    with ThreadPoolExecutor(3) as pool:
        done = list(pool.map(lambda p: record(*p), todo))
    old = {label(r["name"], r["frontier"]): r for r in load_runs()} if FIXTURE.exists() else {}
    for (n, _w, _t, f), run in zip(todo, done):
        old[label(n, f)] = run
        print(f"{label(n, f)}: {len(run['dispatches'])} dispatches, {len(run['summary'])} "
              f"issues, {run['jax_cpu_seconds']:.1f} s, staticpass {run['staticpass']}, "
              f"querycache {run['querycache']}", flush=True)
    order = [label(n, f) for n, _w, _t, f in planned()]
    FIXTURE.write_text(json.dumps({"runs": [old[k] for k in order if k in old]}, indent=1) + "\n")
    return load_runs()


def load_runs() -> list:
    return F.load_runs(FIXTURE)


def run_port(run: dict, device, record: bool = True) -> dict:
    """One fixture run through the port's analysis on ``device`` with its
    defaults: native CDCL, the prefilter, the devsolver, the static pass and
    the query cache on."""
    from tests._torch_parity import run_analysis

    return run_analysis("mythril_tpu_torch", bytes.fromhex(run["code"]),
                        tx_count=run["transactions"], strategy=run["strategy"],
                        frontier=run["frontier"], force=run["frontier"], width=run["width"],
                        timeout=F.TIMEOUT, device=device, record=record, cdcl=True, tiers=True,
                        defaults=True)


def check_run(run: dict, got: dict) -> list:
    """``T.check_run`` (issues, dispatches, the tier counters) and the
    static pass's and the query cache's counters."""
    bad = T.check_run(run, got)
    for key in ("staticpass", "querycache"):
        if got[key] != run[key]:
            bad.append(f"{key} counters {got[key]} != {run[key]}")
    return bad


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


def test_fixture_holds_every_run():
    runs = load_runs()
    assert [(r["name"], r["width"], r["transactions"], r["frontier"]) for r in runs] == planned()
    by = {(r["name"], r["frontier"]): r for r in runs}
    for r in runs:
        assert r["code"] == code_of(r["name"]).hex() and r["strategy"] == F.STRATEGY
        assert bool(r["dispatches"]) == r["frontier"]
        assert r["frontier_stats"]["replay_errors"] == 0
        assert r["cdcl"]["timeouts"] == 0
        # the gate ran on every run and disabled itself on none
        assert r["staticpass"]["contracts"] >= 1 and r["staticpass"]["gate_disabled"] == {}
        assert r["querycache"]["lookups"] > 0
        # the analyses' issues do not depend on the host tiers
        assert any(row[0] == "106" for row in r["summary"]) == (r["name"] != "etherstore_like"
                                                                 and r["name"] != "rubixi_like")
    # the gate skipped modules and elided hooks; the dead span's events and
    # the frontier's hooks were pruned on the card's tables
    assert by[("etherstore_like", True)]["staticpass"]["modules_skipped"] > 0
    assert by[("dead_code", True)]["staticpass"]["events_pruned"] > 0
    assert by[("dead_code", True)]["staticpass"]["hooks_elided_device"] > 0
    # the query cache decided queries
    assert sum(r["querycache"]["exact_hits"] + r["querycache"]["core_hits"]
               + r["querycache"]["model_hits"] for r in runs) > 0


@pytest.mark.parametrize("name,frontier", CPU_RUNS)
def test_port_reproduces_defaults_fixture_on_cpu(name, frontier):
    run = next(r for r in load_runs() if r["name"] == name and r["frontier"] == frontier)
    got = run_port(run, "cpu")
    assert check_run(run, got) == []


if __name__ == "__main__":
    if sys.argv[1:2] == ["--analyze"]:
        name, width, tx, frontier = sys.argv[2:6]
        print(json.dumps(_analyze(name, int(width), int(tx), frontier == "1")))
        sys.exit(0)
    if "--write" not in sys.argv:
        sys.exit("usage: JAX_PLATFORMS=cpu python tests/test_torch_engine_defaults.py --write "
                 "[run name ...]")
    import os

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    written = write_fixture([a for a in sys.argv[1:] if a != "--write"])
    print(f"{FIXTURE}: {FIXTURE.stat().st_size} bytes, {len(written)} runs")
