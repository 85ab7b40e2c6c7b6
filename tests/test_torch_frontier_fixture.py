"""Real frontier dispatches, recorded from the JAX engine, replayed through the port.

``tests/testdata/torch_frontier_dispatches.npz`` holds every segment
dispatch the JAX frontier engine made (``--frontier``, forced, no pipeline,
host probe, one device) on these runs:

* ``bench._wide_contract(10)`` at width 1024, 1 tx (1024 concurrent paths);
* ``bench_contracts.bectoken_like``, ``etherstore_like`` and ``rubixi_like``
  at width 256 (``bench.py``'s production width), 2 tx;
* ``bench._largecode_contract(2400)`` at width 256, 1 tx, a code past the
  default page budget of 2048 instructions (paged, ``pbase`` column).

For each dispatch it stores the inputs: caps, bucket, the state's
non-event fields (the engine pushes empty event buffers, ``push_state``),
the arena rows ``[0, arena_len)`` (the rows above are ``HostArena``'s
initial fill, checked while recording), ``visited``, the stacked code
tables and cfg; and of the outputs only digests (``interop.output_digests``)
and the scalars.  Regenerate it with

    JAX_PLATFORMS=cpu python tests/test_torch_frontier_fixture.py --write

While the engine runs, a runtime wrapper of the module attribute
``mythril_tpu.frontier.engine.cached_segment`` (the engine calls it by that
name) records each call of the segment it returns; the JAX package is not
edited.

Under pytest, the port's plain segment replays the recorded dispatches on
the CPU and must match every digest.  ``chip_smoke.py`` replays all of them
through the CUDA kernel.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:  # run as a script (--write)
    sys.path.insert(0, str(REPO))
from tests._torch_parity import _one_torch_thread  # noqa: E402,F401  (autouse fixture)
FIXTURE = REPO / "tests" / "testdata" / "torch_frontier_dispatches.npz"

# (name, width, transactions)
RUNS = (
    ("wide_contract_10", 1024, 1),
    ("bectoken_like", 256, 2),
    ("etherstore_like", 256, 2),
    ("rubixi_like", 256, 2),
    ("largecode_contract_2400", 256, 1),
)
MAX_BYTES = 8 << 20


def _code(name: str) -> bytes:
    sys.path.insert(0, str(REPO))
    import bench
    import bench_contracts

    if name == "wide_contract_10":
        return bench._wide_contract(10)
    if name == "largecode_contract_2400":
        return bench._largecode_contract(2400)
    return getattr(bench_contracts, name)()


def _record(name: str, width: int, tx_count: int):
    """Run the JAX engine on one contract; -> list of dispatch records."""
    import mythril_tpu.frontier.engine as E
    from mythril_tpu.analysis.security import fire_lasers, reset_callback_modules
    from mythril_tpu.analysis.symbolic import SymExecWrapper
    from mythril_tpu.frontier.state import FrontierState
    from mythril_tpu.support.support_args import args

    from mythril_tpu_torch.frontier import interop

    records = []
    orig = E.cached_segment

    def cached_segment(caps, *bucket):
        segment = orig(caps, *bucket)

        def recorded(state, arena, arena_len, visited, code, cfg):
            out = segment(state, arena, arena_len, visited, code, cfg)
            n = int(arena_len)
            cols = [np.asarray(x) for x in arena]
            # above arena_len: HostArena's initial fill, not stored
            assert (cols[0][n:] == 0).all() and (cols[1][n:] == -1).all()
            assert (cols[2][n:] == -1).all() and (cols[3][n:] == -1).all()
            assert (cols[4][n:] == 0).all() and (cols[5][n:] == 0).all()
            assert not cols[6][n:].any() and cols[0].shape[0] == caps.ARENA
            st = {f: np.asarray(getattr(state, f)) for f in FrontierState._fields}
            # push_state rebuilds the event buffers empty on the device
            assert (st["events"] == -1).all() and (st["ev_len"] == 0).all()
            records.append({
                "caps": {f: getattr(caps, f) for f in caps.__dataclass_fields__},
                "bucket": [int(b) for b in bucket],
                "arena_len": n,
                "cfg": [int(np.asarray(x)) for x in cfg],
                "state": {f: x for f, x in st.items() if f not in ("events", "ev_len")},
                "arena": [c[:n] for c in cols],
                "visited": np.asarray(visited),
                "code": [np.asarray(x) for x in code],
                "digests": interop.output_digests(out),
            })
            return out

        return recorded

    saved = {k: getattr(args, k) for k in (
        "frontier", "frontier_force", "pipeline", "probe_backend", "frontier_width",
        "frontier_mesh")}
    E.cached_segment = cached_segment
    try:
        args.frontier, args.frontier_force, args.pipeline = True, True, False
        args.probe_backend, args.frontier_width, args.frontier_mesh = "host", width, False
        reset_callback_modules()
        from mythril_tpu.analysis.module.loader import ModuleLoader

        for m in ModuleLoader().get_detection_modules():
            if hasattr(m, "cache"):
                m.cache.clear()
        sym = SymExecWrapper(_code(name), address=0x0901D12E, strategy="bfs",
                             transaction_count=tx_count, execution_timeout=300)
        issues = fire_lasers(sym)
    finally:
        E.cached_segment = orig
        for k, v in saved.items():
            setattr(args, k, v)
    return records, sorted({i.swc_id for i in issues})


def write_fixture() -> dict:
    meta, arrays = {"runs": []}, {}
    for name, width, tx in RUNS:
        records, swcs = _record(name, width, tx)
        run = {"name": name, "width": width, "transactions": tx, "issues_swc": swcs,
               "recorded": len(records), "dispatches": []}
        for i, rec in enumerate(records):
            key = f"{name}/{i}"
            for f, x in rec["state"].items():
                arrays[f"{key}/state/{f}"] = x
            for j, x in enumerate(rec["arena"]):
                arrays[f"{key}/arena/{j}"] = x
            arrays[f"{key}/visited"] = rec["visited"]
            for j, x in enumerate(rec["code"]):
                arrays[f"{key}/code/{j}"] = x
            run["dispatches"].append({k: rec[k] for k in ("caps", "bucket", "arena_len", "cfg",
                                                          "digests")})
        meta["runs"].append(run)
        print(f"{name}: {len(records)} dispatches, issues {swcs}", flush=True)
    np.savez_compressed(FIXTURE, meta=np.frombuffer(json.dumps(meta).encode(), np.uint8),
                        **arrays)
    return meta


# ---------------------------------------------------------------------------
# reading the fixture (tests and chip_smoke.py)
# ---------------------------------------------------------------------------


def load_meta(path=FIXTURE) -> dict:
    with np.load(path) as data:
        return json.loads(bytes(data["meta"]).decode())


def window_base_max(data, run: str, i: int) -> int:
    """The largest page-window base of a dispatch's codes (``data``: the
    opened fixture)."""
    return int(data[f"{run}/{i}/code/10"].max())


def iter_dispatches(path=FIXTURE, keep=None):
    """Yield (run name, index, dispatch) in order, one at a time (a 1024-wide
    dispatch's arena alone is 11 MB).
    A dispatch is a dict with the numpy inputs in the JAX layout (``state``,
    ``arena`` as 7 full columns, ``arena_len``, ``visited``, ``code``,
    ``cfg``), ``caps``, ``bucket`` and the recorded ``digests``.
    ``keep(run name, index, data)`` filters, ``data`` the opened file."""
    from mythril_tpu_torch.frontier import ops as O
    from mythril_tpu_torch.frontier import state as S
    from mythril_tpu_torch.frontier.arena import HostArena

    with np.load(path) as data:
        meta = json.loads(bytes(data["meta"]).decode())
        for run in meta["runs"]:
            for i, d in enumerate(run["dispatches"]):
                if keep is not None and not keep(run["name"], i, data):
                    continue
                key = f"{run['name']}/{i}"
                caps = S.Caps(**d["caps"])
                fields = {f: data[f"{key}/state/{f}"] for f in S.FrontierState._fields
                          if f not in ("events", "ev_len")}
                fields["events"] = np.full((caps.B, caps.EVT, O.EV_W), -1, np.int32)
                fields["ev_len"] = np.zeros(caps.B, np.int32)
                # rows above arena_len: HostArena's initial fill
                cols = [np.array(x) for x in HostArena(caps.ARENA).device_arrays()]
                for j, col in enumerate(cols):
                    col[:d["arena_len"]] = data[f"{key}/arena/{j}"]
                yield run["name"], i, dict(
                    d, caps=caps, state=S.FrontierState(**fields), arena=cols,
                    visited=data[f"{key}/visited"],
                    code=[data[f"{key}/code/{j}"] for j in range(11)],
                )


def replay(dispatch, device="cpu"):
    """One recorded dispatch through the port's segment for ``device`` (the
    plain version on the CPU, the kernel on ``cuda``) -> its digests."""
    from mythril_tpu_torch.frontier import interop
    from mythril_tpu_torch.frontier.step import cached_segment

    segment = cached_segment(dispatch["caps"], *dispatch["bucket"], device=device)
    out = segment(*interop.inputs_from_numpy(
        dispatch["state"], dispatch["arena"], dispatch["arena_len"], dispatch["visited"],
        dispatch["code"], dispatch["cfg"], device))
    return interop.output_digests(out)


def mismatches(got: dict, want: dict):
    return sorted(k for k in want if got.get(k) != want[k])


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


def test_fixture_holds_the_recorded_runs():
    meta = load_meta()
    by_run = {r["name"]: r for r in meta["runs"]}
    assert [r[0] for r in RUNS] == list(by_run)
    for name, width, tx in RUNS:
        assert by_run[name]["recorded"] == len(by_run[name]["dispatches"]) > 0
        assert {d["caps"]["B"] for d in by_run[name]["dispatches"]} == {width}
    assert by_run["wide_contract_10"]["issues_swc"] == ["106"]
    assert by_run["wide_contract_10"]["dispatches"][0]["digests"]["max_live"] == 1024
    # the paged code: a dispatch with its window past the code's start
    with np.load(FIXTURE) as data:
        assert any(window_base_max(data, "largecode_contract_2400", i) > 0
                   for i in range(by_run["largecode_contract_2400"]["recorded"]))
    assert FIXTURE.stat().st_size < MAX_BYTES


# The largecode run is 352 dispatches, most of them one path that faults at
# once; the CPU replays its first 8 and the one with a window base past 0,
# and every dispatch of the other runs.  chip_smoke.py replays all of them.
LARGECODE_FIRST = 8


def cpu_subset(name: str, i: int, data) -> bool:
    return (name != "largecode_contract_2400" or i < LARGECODE_FIRST
            or window_base_max(data, name, i) > 0)


@pytest.mark.parametrize("run", [r[0] for r in RUNS])
def test_plain_segment_matches_jax_digests(run):
    n = 0
    for name, i, d in iter_dispatches(keep=lambda name, i, data: name == run and cpu_subset(name, i, data)):
        assert mismatches(replay(d), d["digests"]) == [], f"{name} dispatch {i}"
        n += 1
    assert n > 0


if __name__ == "__main__":
    if "--write" not in sys.argv:
        sys.exit("usage: JAX_PLATFORMS=cpu python tests/test_torch_frontier_fixture.py --write")
    sys.path.insert(0, str(REPO))
    import os

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    written = write_fixture()
    print(json.dumps({r["name"]: r["recorded"] for r in written["runs"]}))
    print(f"{FIXTURE}: {FIXTURE.stat().st_size} bytes")
    if FIXTURE.stat().st_size > MAX_BYTES:
        sys.exit(f"fixture over {MAX_BYTES} bytes")
