"""Whole analyses under the known-bits prefilter and the devsolver, recorded
from the JAX package.

``tests/testdata/torch_engine_runs_tiers.json`` holds runs recorded under
``_torch_parity.jax_engine_config_tiers``: ``jax_engine_config_cdcl`` with
the JAX package's default-on prefilter (tier 0.58) and devsolver (tier 0.65)
on, at their default budgets.  The runs: ``kill_simple`` (width 64),
``rubixi_like`` and ``etherstore_like`` (width 256), 2 transactions, each on
the forced frontier and on the host engine.  Per run: the issues, every
frontier dispatch's digests, the frontier's counters, the JAX package's wall
on the CPU, its CDCL counts, and the two tiers' counters (``tier_counters``:
the prefilter's fresh evaluations, kills and fallthroughs; the devsolver's
admitted queries, SAT and UNSAT decisions, unknowns and failed model
validations).  On the CPU the JAX package runs both tiers' host twins,
``domains.eval_kb_host`` and ``kernel.run_host``.

``tests/testdata/torch_tier_kernels.npz`` holds every input the two device
programs took in those runs (each known-bits pack and each DPLL plane), with
the outputs as sha256 digests (``kb_digest``, ``dpll_digest``);
``chip_smoke.py`` runs each through the port's kernels on the card.
Regenerate both with

    JAX_PLATFORMS=cpu python tests/test_torch_engine_tiers.py --write [run name ...]

(each JAX analysis in a process of its own, about five minutes in all).

Under pytest: the fixtures hold every run, the recorded kernel inputs replay
through the port's plain versions to the recorded digests, and the port's
engine on the CPU reproduces ``kill_simple`` (frontier and host engine) and
``rubixi_like`` (host engine) exactly, tier counters included.
"""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from tests._torch_parity import _one_torch_thread  # noqa: E402,F401  (autouse fixture)
from tests import test_torch_engine_fixture as F  # noqa: E402

FIXTURE = REPO / "tests" / "testdata" / "torch_engine_runs_tiers.json"
KERNELS = REPO / "tests" / "testdata" / "torch_tier_kernels.npz"
NAMES = ("etherstore_like", "rubixi_like", "kill_simple")
BENCH = ("etherstore_like", "rubixi_like")
# the port's engine on the CPU replays these under pytest (name, frontier)
CPU_RUNS = (("kill_simple", True), ("kill_simple", False), ("rubixi_like", False))


def planned() -> list:
    """(name, width, transactions, frontier) of every run, in order."""
    return [r for r in F.planned() if r[0] in NAMES]


def label(name: str, frontier: bool) -> str:
    return f"{name}/{'frontier' if frontier else 'host'}"


def kb_digest(km, kv, refuted) -> str:
    """sha256 over a known-bits pass's outputs: km and kv as uint32
    [N, R, 16], refuted as uint8 [R]."""
    h = hashlib.sha256()
    for a, dt in ((km, np.uint32), (kv, np.uint32), (refuted, np.uint8)):
        h.update(np.ascontiguousarray(np.asarray(a).astype(dt, copy=False)).tobytes())
    return h.hexdigest()


def dpll_digest(status, assign) -> str:
    """sha256 over a DPLL run's outputs: status int8 [Q], assign int8 [Q, V]."""
    h = hashlib.sha256()
    for a in (status, assign):
        h.update(np.ascontiguousarray(np.asarray(a).astype(np.int8, copy=False)).tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# recording (JAX side, one process per run)
# ---------------------------------------------------------------------------


def _kb_record(pack, km, kv, refuted) -> dict:
    nodes = sorted(pack.overrides)
    r = pack.n_rows
    okm = np.zeros((len(nodes), r, 16), np.uint32)
    okv = np.zeros((len(nodes), r, 16), np.uint32)
    for j, node in enumerate(nodes):
        okm[j], okv[j] = pack.overrides[node][2], pack.overrides[node][3]
    return {"op": pack.op, "w": pack.w, "a0": pack.a0, "a1": pack.a1, "a2": pack.a2,
            "x0": pack.x0, "x1": pack.x1, "wm": pack.wm, "cl": pack.c_limbs,
            "ov_nodes": np.asarray(nodes, np.int32), "okm": okm, "okv": okv,
            "n_rows": np.int32(r), "digest": kb_digest(km, kv, refuted)}


def _capturing(into: dict):
    """Wrap the JAX package's two host twins so each call's inputs and output
    digest are appended to ``into["kb"]`` and ``into["dpll"]``."""
    import contextlib

    from mythril_tpu.absdomain import domains
    from mythril_tpu.devsolver import kernel

    eval_kb, run_host = domains.eval_kb_host, kernel.run_host

    def eval_kb_host(pack):
        km, kv, refuted = eval_kb(pack)
        into["kb"].append(_kb_record(pack, km, kv, refuted))
        return km, kv, refuted

    def run_host_recorded(plane, max_iters):
        status, assign = run_host(plane, max_iters)
        into["dpll"].append({"lits": plane.lits, "dec": plane.dec,
                             "n_vars": np.int32(plane.n_vars), "n_q": np.int32(plane.n_q),
                             "max_iters": np.int32(max_iters),
                             "digest": dpll_digest(status, assign)})
        return status, assign

    @contextlib.contextmanager
    def patched():
        domains.eval_kb_host, kernel.run_host = eval_kb_host, run_host_recorded
        try:
            yield into
        finally:
            domains.eval_kb_host, kernel.run_host = eval_kb, run_host

    return patched()


def _analyze(name: str, width: int, tx: int, frontier: bool, kernels_out: str) -> dict:
    from tests._torch_parity import jax_engine_config_tiers, run_analysis

    captured = {"kb": [], "dpll": []}
    with F.bounded_xla_programs(), jax_engine_config_tiers(), _capturing(captured):
        run = run_analysis("mythril_tpu", F.code_of(name), tx_count=tx, strategy=F.STRATEGY,
                           frontier=frontier, force=frontier, width=width, timeout=F.TIMEOUT,
                           tiers=True)
    arrays = {}
    for kind, recs in captured.items():
        for i, rec in enumerate(recs):
            for k, v in rec.items():
                arrays[f"{kind}{i}_{k}"] = np.asarray(v)
    np.savez_compressed(kernels_out, **arrays)
    return {"summary": run["summary"], "dispatches": F.compact(run["dispatches"]),
            "frontier_stats": run["frontier"], "jax_cpu_seconds": run["seconds"],
            "cdcl": run["cdcl"], "tiers": run["tiers"],
            "kb_passes": len(captured["kb"]), "dpll_planes": len(captured["dpll"])}


def record(name: str, width: int, tx: int, frontier: bool, kernels_out: str) -> dict:
    import subprocess

    run = {"name": name, "code": F.code_of(name).hex(), "width": width, "transactions": tx,
           "strategy": F.STRATEGY, "frontier": frontier}
    out = subprocess.run(
        [sys.executable, __file__, "--analyze", name, str(width), str(tx), str(int(frontier)),
         kernels_out], capture_output=True, text=True, check=True, cwd=str(REPO))
    run.update(json.loads(out.stdout.strip().splitlines()[-1]))
    return run


def _merge_kernels(per_run: dict) -> None:
    """Write ``KERNELS`` from {run label: that run's npz}, in ``planned()``
    order: keys ``kb{j}_{field}`` / ``dpll{j}_{field}`` numbered over all
    runs, and ``kb_run`` / ``dpll_run`` (the run's index in ``runs``)."""
    labels = [label(n, f) for n, _w, _t, f in planned()]
    out, runs_of = {}, {"kb": [], "dpll": []}
    for idx, lab in enumerate(labels):
        if lab not in per_run:
            continue
        with np.load(per_run[lab]) as z:
            for kind in ("kb", "dpll"):
                i = 0
                while f"{kind}{i}_digest" in z:
                    j = len(runs_of[kind])
                    for key in z.files:
                        if key.startswith(f"{kind}{i}_"):
                            out[f"{kind}{j}_{key[len(f'{kind}{i}_'):]}"] = z[key]
                    runs_of[kind].append(idx)
                    i += 1
    out["runs"] = np.asarray(labels)
    out["kb_run"] = np.asarray(runs_of["kb"], np.int32)
    out["dpll_run"] = np.asarray(runs_of["dpll"], np.int32)
    np.savez_compressed(KERNELS, **out)


def _split_kernels() -> dict:
    """``KERNELS`` back into {run label: {"kb": [...], "dpll": [...]}}."""
    out = {}
    for kind, recs in load_kernels().items():
        for rec in recs:
            out.setdefault(rec["run"], {"kb": [], "dpll": []})[kind].append(rec)
    return out


def write_fixture(names=()) -> list:
    """Record the runs of ``names`` (all when empty), in parallel, and merge
    them into both fixtures in the order of ``planned()``."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    todo = [p for p in planned() if not names or p[0] in names]
    tmp = tempfile.mkdtemp(prefix="tiers-")

    def npz_of(name, frontier):
        return f"{tmp}/{label(name, frontier).replace('/', '-')}.npz"

    with ThreadPoolExecutor(3) as pool:
        done = list(pool.map(lambda p: record(*p, kernels_out=npz_of(p[0], p[3])), todo))
    old = {label(r["name"], r["frontier"]): r for r in load_runs()} if FIXTURE.exists() else {}
    per_run = {}
    if KERNELS.exists():
        for lab, recs in _split_kernels().items():
            path = f"{tmp}/old-{lab.replace('/', '-')}.npz"
            np.savez_compressed(path, **{f"{kind}{i}_{k}": np.asarray(v)
                                        for kind in ("kb", "dpll")
                                        for i, rec in enumerate(recs[kind])
                                        for k, v in rec.items() if k != "run"})
            per_run[lab] = path
    for (n, _w, _t, f), run in zip(todo, done):
        lab = label(n, f)
        old[lab] = run
        per_run[lab] = npz_of(n, f)
        print(f"{lab}: {len(run['dispatches'])} dispatches, {len(run['summary'])} issues, "
              f"{run['jax_cpu_seconds']:.1f} s, tiers {run['tiers']}, {run['kb_passes']} "
              f"known-bits passes, {run['dpll_planes']} DPLL planes", flush=True)
    order = [label(n, f) for n, _w, _t, f in planned()]
    FIXTURE.write_text(json.dumps({"runs": [old[k] for k in order if k in old]}, indent=1) + "\n")
    _merge_kernels(per_run)
    return load_runs()


def load_runs() -> list:
    return F.load_runs(FIXTURE)


def load_kernels() -> dict:
    """{"kb": [...], "dpll": [...]}: each recorded call as a dict of its
    arrays, with "digest" (str) and "run" (its run label)."""
    out = {"kb": [], "dpll": []}
    with np.load(KERNELS) as z:
        runs = [str(r) for r in z["runs"]]
        for kind in out:
            for j, run_idx in enumerate(z[f"{kind}_run"]):
                prefix = f"{kind}{j}_"
                rec = {k[len(prefix):]: z[k] for k in z.files if k.startswith(prefix)}
                rec["digest"] = str(rec["digest"])
                rec["run"] = runs[int(run_idx)]
                out[kind].append(rec)
    return out


def kb_pack(rec: dict):
    """A recorded known-bits input as the port's ``PackedBatch`` (only the
    fields the known-bits pass reads)."""
    from mythril_tpu_torch.absdomain.tape import PackedBatch

    p = PackedBatch(int(rec["n_rows"]))
    p.n_nodes = len(rec["op"])
    for k in ("op", "w", "a0", "a1", "a2", "x0", "x1", "wm"):
        setattr(p, k, rec[k])
    p.c_limbs = rec["cl"]
    p.overrides = {int(n): (None, None, rec["okm"][j], rec["okv"][j])
                   for j, n in enumerate(rec["ov_nodes"])}
    return p


def dpll_plane(rec: dict):
    from mythril_tpu_torch.devsolver.kernel import Plane

    return Plane(rec["lits"], rec["dec"], int(rec["n_q"]), int(rec["n_vars"]))


def run_port(run: dict, device, record: bool = True) -> dict:
    """One fixture run through the port's analysis on ``device``, its native
    CDCL, prefilter and devsolver on."""
    from tests._torch_parity import run_analysis

    return run_analysis("mythril_tpu_torch", bytes.fromhex(run["code"]),
                        tx_count=run["transactions"], strategy=run["strategy"],
                        frontier=run["frontier"], force=run["frontier"], width=run["width"],
                        timeout=F.TIMEOUT, device=device, record=record, cdcl=True, tiers=True)


def check_run(run: dict, got: dict) -> list:
    """``F.check_run`` and the tier counters."""
    bad = F.check_run(run, got)
    if got["tiers"] != run["tiers"]:
        bad.append(f"tier counters {got['tiers']} != {run['tiers']}")
    return bad


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


def test_fixture_holds_every_run():
    runs = load_runs()
    assert [(r["name"], r["width"], r["transactions"], r["frontier"]) for r in runs] == planned()
    kernels = load_kernels()
    for r in runs:
        assert r["code"] == F.code_of(r["name"]).hex() and r["strategy"] == F.STRATEGY
        assert bool(r["dispatches"]) == r["frontier"]
        assert r["frontier_stats"]["replay_errors"] == 0
        # real traffic reaches both device programs on the bench contracts
        # (kill_simple's frontier run decides every query before tier 0.58)
        if r["name"] in BENCH:
            assert r["kb_passes"] > 0 and r["dpll_planes"] > 0
            assert r["tiers"]["prefilter"]["evaluated"] > 0
            assert r["tiers"]["devsolver"]["admitted"] > 0
        lab = label(r["name"], r["frontier"])
        assert sum(k["run"] == lab for k in kernels["kb"]) == r["kb_passes"]
        assert sum(k["run"] == lab for k in kernels["dpll"]) == r["dpll_planes"]


def test_recorded_known_bits_packs_replay_through_the_plain_version():
    from mythril_tpu_torch.absdomain import domains

    recs = load_kernels()["kb"]
    for rec in recs:
        km, kv, refuted = domains.eval_kb_torch(kb_pack(rec), "cpu")
        assert kb_digest(km.numpy().view(np.uint32), kv.numpy().view(np.uint32),
                         refuted.numpy()) == rec["digest"], rec["run"]


def test_recorded_dpll_planes_replay_through_the_plain_version():
    from mythril_tpu_torch.devsolver import kernel

    recs = load_kernels()["dpll"]
    # one plane per run: the plain driver takes a few hundred steps each
    firsts = {rec["run"]: rec for rec in reversed(recs)}
    for rec in firsts.values():
        status, assign = kernel.run_torch(dpll_plane(rec), int(rec["max_iters"]), "cpu")
        assert dpll_digest(status.numpy(), assign.numpy()) == rec["digest"], rec["run"]


@pytest.mark.parametrize("name,frontier", CPU_RUNS)
def test_port_reproduces_tiers_fixture_on_cpu(name, frontier):
    run = next(r for r in load_runs() if r["name"] == name and r["frontier"] == frontier)
    assert run["cdcl"]["timeouts"] == 0
    got = run_port(run, "cpu")
    assert check_run(run, got) == []


if __name__ == "__main__":
    if sys.argv[1:2] == ["--analyze"]:
        name, width, tx, frontier, kernels_out = sys.argv[2:7]
        print(json.dumps(_analyze(name, int(width), int(tx), frontier == "1", kernels_out)))
        sys.exit(0)
    if "--write" not in sys.argv:
        sys.exit("usage: JAX_PLATFORMS=cpu python tests/test_torch_engine_tiers.py --write "
                 "[run name ...]")
    import os

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    written = write_fixture([a for a in sys.argv[1:] if a != "--write"])
    print(f"{FIXTURE}: {FIXTURE.stat().st_size} bytes, {len(written)} runs; "
          f"{KERNELS}: {KERNELS.stat().st_size} bytes")
