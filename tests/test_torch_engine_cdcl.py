"""Whole analyses under native CDCL, recorded from the JAX package.

``tests/testdata/torch_engine_runs_cdcl.json`` holds the runs of
``tests/testdata/torch_engine_runs.json`` (``test_torch_engine_fixture.py``)
recorded again with the JAX package's native CDCL on
(``jax_engine_config_cdcl``): the exact tier 2 of ``solve_conjunction``, the
``cheap_exact`` cap on the probe, the CDCL-backed ``Optimize`` and the
transaction-end issue gate.  The port runs the same tiers with its own copy
of the C++ solver.  Per run: the issues, every frontier dispatch's digests,
the frontier's counters, the JAX package's wall on the CPU, its
``cdcl_calls`` and its CDCL answers (``counting_cdcl``: calls, seconds, and
``timeouts``, the answers that came back UNKNOWN with their budget spent),
and the issue keys under the JAX package's default tiers.  A run with a
recorded timeout cannot be held exactly: the CDCL budget is wall-clock time,
and the port's host is not the recorder's.

``bectoken_like`` runs one transaction (``BECTOKEN_TX``), as in the
no-CDCL fixture.  At two transactions, the bench shape, the JAX package's
run under the CDCL tiers had not finished after 61 minutes on an 8-core
CPU host (XLA held to one thread, beside the other recordings), past the
recorder's one-hour ``TIMEOUT``: its tape VM runs on XLA's CPU backend.
Its default-tier keys at two transactions are the same two SWC-101 issues
as at one.  Two recordings of the one-transaction run gave the same issues
and dispatch digests, with 52 and 48 CDCL calls and 7 timeouts each: the
CDCL budget is wall-clock time.  Regenerate with

    JAX_PLATFORMS=cpu python tests/test_torch_engine_cdcl.py --write [run name ...]

Under pytest: the fixture holds every run, the three bench contracts' keys
equal the JAX package's default-tier keys, and the port's engine on the CPU
reproduces ``kill_simple`` (frontier and host engine) and ``rubixi_like``
(host engine) exactly.
"""

from __future__ import annotations

import contextlib
import json
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from tests._torch_parity import _one_torch_thread  # noqa: E402,F401  (autouse fixture)
from tests import test_torch_engine_fixture as F  # noqa: E402

FIXTURE = REPO / "tests" / "testdata" / "torch_engine_runs_cdcl.json"
BECTOKEN_TX = 1
BENCH = ("bectoken_like", "etherstore_like", "rubixi_like")
# the port's engine on the CPU replays these under pytest (name, frontier)
CPU_RUNS = (("kill_simple", True), ("kill_simple", False), ("rubixi_like", False))


def planned() -> list:
    """(name, width, transactions, frontier) of every run, in order."""
    return [(n, w, BECTOKEN_TX if n == "bectoken_like" else t, f)
            for n, w, t, f in F.planned()]


def _analyze(name: str, width: int, tx: int, frontier: bool, default_tiers: bool) -> dict:
    """One JAX analysis: under ``jax_engine_config_cdcl``, or under the JAX
    package's defaults when ``default_tiers``."""
    from tests._torch_parity import issue_key, jax_engine_config_cdcl, run_analysis

    with F.bounded_xla_programs(), (
            contextlib.nullcontext() if default_tiers else jax_engine_config_cdcl()):
        run = run_analysis("mythril_tpu", F.code_of(name), tx_count=tx, strategy=F.STRATEGY,
                           frontier=frontier, force=frontier, width=width, timeout=F.TIMEOUT,
                           record=not default_tiers)
    if default_tiers:
        return {"default_tiers_keys": sorted(list(issue_key(i)) for i in run["issues"])}
    return {"summary": run["summary"], "dispatches": F.compact(run["dispatches"]),
            "frontier_stats": run["frontier"], "jax_cpu_seconds": run["seconds"],
            "cdcl": run["cdcl"]}


def record(name: str, width: int, tx: int, frontier: bool) -> dict:
    """One run, each JAX analysis in a process of its own; the default-tier
    keys come from the no-CDCL fixture where it has the same run."""
    import subprocess

    run = {"name": name, "code": F.code_of(name).hex(), "width": width, "transactions": tx,
           "strategy": F.STRATEGY, "frontier": frontier}
    same = [r for r in F.load_runs() if (r["name"], r["width"], r["transactions"],
                                         r["frontier"]) == (name, width, tx, frontier)]
    for default in ((False,) if same else (False, True)):
        out = subprocess.run(
            [sys.executable, __file__, "--analyze", name, str(width), str(tx),
             str(int(frontier)), str(int(default))],
            capture_output=True, text=True, check=True, cwd=str(REPO))
        run.update(json.loads(out.stdout.strip().splitlines()[-1]))
    if same:
        run["default_tiers_keys"] = same[0]["default_tiers_keys"]
    return run


def write_fixture(names=()) -> list:
    """Record the runs of ``names`` (all when empty) and merge them into the
    fixture in the order of ``planned()``; writers on disjoint names may run
    at once."""
    import fcntl

    order = [(n, f) for n, _w, _t, f in planned()]
    for name, width, tx, frontier in planned():
        if names and name not in names:
            continue
        run = record(name, width, tx, frontier)
        print(f"{name} frontier={frontier}: {len(run['dispatches'])} dispatches, "
              f"{len(run['summary'])} issues, {run['jax_cpu_seconds']:.1f} s, "
              f"cdcl {run['cdcl']}", flush=True)
        with open(FIXTURE.with_suffix(".lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            runs = load_runs() if FIXTURE.exists() else []
            runs = [r for r in runs if (r["name"], r["frontier"]) != (name, frontier)] + [run]
            runs.sort(key=lambda r: order.index((r["name"], r["frontier"])))
            FIXTURE.write_text(json.dumps({"runs": runs}, indent=1) + "\n")
    return load_runs()


def load_runs() -> list:
    return F.load_runs(FIXTURE)


def default_keys_match(run: dict, summary: list) -> bool:
    """Whether ``summary``'s issue keys are the run's JAX default-tier keys."""
    return sorted(tuple(k[:5]) for k in summary) == sorted(map(tuple, run["default_tiers_keys"]))


def run_port(run: dict, device, record: bool = True) -> dict:
    """One fixture run through the port's analysis on ``device``, its native
    CDCL on."""
    from tests._torch_parity import run_analysis

    return run_analysis("mythril_tpu_torch", bytes.fromhex(run["code"]),
                        tx_count=run["transactions"], strategy=run["strategy"],
                        frontier=run["frontier"], force=run["frontier"], width=run["width"],
                        timeout=F.TIMEOUT, device=device, record=record, cdcl=True)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


def test_fixture_holds_every_run():
    runs = load_runs()
    assert [(r["name"], r["width"], r["transactions"], r["frontier"]) for r in runs] == planned()
    for r in runs:
        assert r["code"] == F.code_of(r["name"]).hex() and r["strategy"] == F.STRATEGY
        assert bool(r["dispatches"]) == r["frontier"]
        assert r["frontier_stats"]["replay_errors"] == 0
        assert r["jax_cpu_seconds"] < F.TIMEOUT
        assert r["cdcl"]["cdcl_calls"] > 0
    # the CDCL tiers close the gap to the JAX package's default tiers
    for r in runs:
        if r["name"] in BENCH:
            assert default_keys_match(r, r["summary"]), r["name"]


@pytest.mark.parametrize("name,frontier", CPU_RUNS)
def test_port_reproduces_cdcl_fixture_on_cpu(name, frontier):
    run = next(r for r in load_runs() if r["name"] == name and r["frontier"] == frontier)
    assert run["cdcl"]["timeouts"] == 0
    got = run_port(run, "cpu")
    assert F.check_run(run, got) == []
    assert got["cdcl"]["cdcl_calls"] > 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--analyze"]:
        name, width, tx, frontier, default = sys.argv[2:7]
        print(json.dumps(_analyze(name, int(width), int(tx), frontier == "1", default == "1")))
        sys.exit(0)
    if "--write" not in sys.argv:
        sys.exit("usage: JAX_PLATFORMS=cpu python tests/test_torch_engine_cdcl.py --write "
                 "[run name ...]")
    import os

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    written = write_fixture([a for a in sys.argv[1:] if a != "--write"])
    print(f"{FIXTURE}: {FIXTURE.stat().st_size} bytes, {len(written)} runs")
