"""The port's pod scaling against the JAX package's (``tests/frontier/
test_pod.py``), exactly (integers and bools, tolerance 0): the slot <->
shard ownership math, the sync-point rebalance planner and free-slot
choice, the correction ledger's exactly-once spill and re-inject, the
frontier segment on a mesh, and the pod parity run, on the port's mesh of 8
logical shards of the CPU (``parallel.mesh.logical_shards``) where the JAX
package runs on the 8 virtual CPU devices ``tests/conftest.py`` forces.

The pod parity recording ``tests/testdata/torch_pod_runs.json`` (the JAX
package's storage-gated 2-transaction runs and one run of ``bench.py``'s
wide contract, on its 8 devices, at its default tiers, pipelined, with and
without the mesh) is regenerated with

    JAX_PLATFORMS=cpu python tests/test_torch_pod.py --write

(about five minutes).
"""

import json
import os
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from tests._torch_parity import _one_torch_thread  # noqa: E402,F401  (autouse fixture)

RECORD = REPO / "tests" / "testdata" / "torch_pod_runs.json"

# the storage-gated selfdestruct of test_pod_parity_multi_tx_storage_gate
# (tests/frontier/test_frontier_engine.py's DISPATCH and the gate): the
# kill() exploit needs the 2-transaction chain
_DISPATCH = "60003560e01c6341c0e1b5146014576000" + "6000fd" + "5b"
STORAGE_GATE = _DISPATCH + "600054600114601b5733ff5b00"
MODULES = ["AccidentallyKillable"]
# the JAX test's width, and one the 8 devices do not divide (4 pad slots a
# frontier run)
WIDTHS = (64, 60)
N_DEV = 8
# bench.py's wide contract of 7 branches (128 paths at width 64: the
# spills re-injected at sync points give the rebalance live paths to move)
WIDE = "wide7"


def contract(name: str):
    """-> (runtime hex, transactions, modules) of a recorded pod run."""
    if name == WIDE:
        import bench

        return bench._wide_contract(7).hex(), 1, MODULES
    return STORAGE_GATE, 2, MODULES


def _both(name: str, *args, **kw):
    """``name`` of the port's ``frontier.pipeline`` or ``parallel.mesh``
    called on ``args``, held equal to the JAX package's."""
    import mythril_tpu.frontier.pipeline as jpipe
    import mythril_tpu.parallel.mesh as jmesh
    import mythril_tpu_torch.frontier.pipeline as ppipe
    import mythril_tpu_torch.parallel.mesh as pmesh

    jfn = getattr(jpipe, name, None) or getattr(jmesh, name)
    pfn = getattr(ppipe, name, None) or getattr(pmesh, name)
    got, want = pfn(*args, **kw), jfn(*args, **kw)
    if isinstance(got, np.ndarray):
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want
    return got


# ---------------------------------------------------------------------------
# slot <-> device ownership math
# ---------------------------------------------------------------------------


def test_pad_batch_rounds_up_to_device_multiple():
    assert _both("pad_batch", 64, 8) == 64
    assert _both("pad_batch", 65, 8) == 72
    assert _both("pad_batch", 1, 8) == 8
    assert _both("pad_batch", 7, 1) == 7  # single shard: no padding
    assert _both("pad_batch", 0, 8) == 0


def test_shard_size_requires_even_split():
    from mythril_tpu_torch.parallel.mesh import shard_size

    assert _both("shard_size", 64, 8) == 8
    with pytest.raises(AssertionError):
        shard_size(65, 8)


def test_slot_shard_contiguous_blocks():
    # 16 slots over 4 shards: [0..3]->0, [4..7]->1, ...
    assert [_both("slot_shard", s, 16, 4) for s in range(16)] == [
        0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3
    ]
    np.testing.assert_array_equal(_both("shard_slots", 16, 4), np.repeat(np.arange(4), 4))


def test_shard_slots_matches_slot_shard():
    B, n = 64, 8
    vec = _both("shard_slots", B, n)
    for s in range(B):
        assert vec[s] == _both("slot_shard", s, B, n)


# ---------------------------------------------------------------------------
# rebalance planner
# ---------------------------------------------------------------------------


def _masks(live_slots, free_slots, B):
    live = np.zeros(B, bool)
    free = np.zeros(B, bool)
    live[list(live_slots)] = True
    free[list(free_slots)] = True
    return live, free


def test_plan_rebalance_spills_hot_shard_to_idle():
    # shard 0 holds 4 live paths, shard 1 is idle with free slots
    live, free = _masks(range(4), range(4, 8), 8)
    # youngest (highest-slot) live paths spill first; stops when balanced
    assert _both("plan_rebalance", live, free, 2) == [3, 2]


def test_plan_rebalance_balanced_is_noop():
    live, free = _masks([0, 1, 4, 5], [2, 3, 6, 7], 8)
    assert _both("plan_rebalance", live, free, 2) == []


def test_plan_rebalance_no_free_receivers_is_noop():
    # hot shard exists but nobody can receive: all other slots occupied
    live, free = _masks(range(8), [], 8)
    assert _both("plan_rebalance", live, free, 2) == []


def test_plan_rebalance_one_off_imbalance_is_noop():
    # difference of 1 is not worth a sync point
    live, free = _masks([0, 1, 4], [5, 6, 7], 8)
    assert _both("plan_rebalance", live, free, 2) == []


def test_plan_rebalance_respects_max_moves():
    live, free = _masks(range(8), range(8, 16), 16)
    assert _both("plan_rebalance", live, free, 2, max_moves=2) == [7, 6]


def test_plan_rebalance_single_shard_is_noop():
    live, free = _masks(range(4), range(4, 8), 8)
    assert _both("plan_rebalance", live, free, 1) == []


def test_plan_rebalance_indivisible_batch_is_noop():
    live, free = _masks(range(3), range(3, 7), 7)
    assert _both("plan_rebalance", live, free, 2) == []


def test_choose_free_slot_prefers_idle_shard():
    # shard 0 loaded, shard 1 idle: injection goes to shard 1's first free
    live, free = _masks([0, 1, 2], [3, 4, 5, 6, 7], 8)
    assert _both("choose_free_slot", free, live, 2) == 4


def test_choose_free_slot_single_shard_is_first_free():
    # the pre-pod scan: first free slot regardless of load
    live, free = _masks([0, 1, 2], [3, 4, 5, 6, 7], 8)
    assert _both("choose_free_slot", free, live, 1) == 3


def test_choose_free_slot_no_free_returns_none():
    live, free = _masks(range(8), [], 8)
    assert _both("choose_free_slot", free, live, 2) is None


def test_choose_free_slot_skips_full_idle_shard():
    # shard 1 has fewest live paths but no reclaimable slot (all device-
    # owned); fall through to the next-coolest shard with a free slot
    live, free = _masks([0], [1, 2, 3], 8)
    assert _both("choose_free_slot", free, live, 2) == 1


# ---------------------------------------------------------------------------
# ledger exactly-once under spill + re-inject
# ---------------------------------------------------------------------------


def test_ledger_exactly_once_spill_reinject():
    """A rebalance spill (touch src) + re-injection (touch dst) ride the
    NEXT dispatch exactly once, on the port's ledger as on the JAX one."""
    from mythril_tpu.frontier.pipeline import CorrectionLedger as JaxLedger
    from mythril_tpu_torch.frontier.pipeline import CorrectionLedger

    seen = []
    for ledger in (CorrectionLedger(8), JaxLedger(8)):
        host_seed = np.full(8, -1, np.int64)
        host_seed[[0, 1, 2, 3]] = 1  # live paths on shard 0
        ledger.consume_all()  # dispatch 0: full push
        # rebalance at a sync point: spill slot 3 (freed), re-inject into 4
        ledger.touch(3)
        host_seed[3] = -1
        ledger.touch(4)
        host_seed[4] = 1
        mask = ledger.consume(host_seed)
        assert mask[3] and mask[4]
        assert mask.sum() == 2
        # the freed spill source becomes device-owned (fork grants may land)
        assert ledger.device_owned[3]
        assert not ledger.device_owned[4]
        # exactly-once: nothing pends for the next dispatch
        again = ledger.consume(host_seed)
        assert again.sum() == 0
        # pull of dispatch 0: both touched slots are newer than that output,
        # so the host view is carried forward (no stale device overwrite)
        first = ledger.on_pull()
        assert set(first.tolist()) == {3, 4}
        # pull of dispatch 1: the device is authoritative again
        second = ledger.on_pull()
        assert second.size == 0
        ledger.release_owned()
        assert not ledger.device_owned.any()
        seen.append([mask.tolist(), again.tolist(), sorted(first.tolist()), second.tolist()])
    assert seen[0] == seen[1]


# ---------------------------------------------------------------------------
# the segment on a mesh
# ---------------------------------------------------------------------------


def test_frontier_segment_shards_over_path_axis():
    """``__graft_entry__._frontier_example(8)`` (one path per device), the
    JAX package's segment on its 8-device mesh, converted to the port's
    state: the port's mesh segment (the partitioned segment over the
    blocks ``shard_frontier_inputs`` places, one per logical shard), its
    unsharded segment and the JAX segment agree field by field, and the
    arena length and step count too."""
    import jax

    import __graft_entry__ as graft

    from mythril_tpu.parallel import make_frontier_mesh as jax_mesh
    from mythril_tpu.parallel import shard_frontier_inputs as jax_shard
    from mythril_tpu_torch.frontier import interop
    from mythril_tpu_torch.frontier.state import Caps
    from mythril_tpu_torch.frontier.step import cached_segment
    from mythril_tpu_torch.parallel import make_frontier_mesh, shard_frontier_inputs
    from mythril_tpu_torch.parallel.mesh import logical_shards, mesh_devices

    assert jax.device_count() == N_DEV, "conftest should pin 8 virtual CPU devices"
    segment, (st, dev_arena, arena_len, visited, code_dev, cfg) = graft._frontier_example(N_DEV)
    arena_cols = [np.asarray(a) for a in dev_arena]
    code_cols = [np.asarray(x) for x in code_dev]
    jst, jarena, jvis, jcode = jax_shard(st, dev_arena, visited, code_dev,
                                         jax_mesh(path_size=N_DEV))
    jout = segment(jst, jarena, arena_len, jvis, jcode, cfg)
    want = interop.outputs_to_numpy(jout)

    caps = Caps(B=N_DEV)
    bucket = (1, code_cols[0].shape[1], code_cols[3].shape[1], st.loops.shape[1])
    port_segment = cached_segment(caps, *bucket, device="cpu")
    inputs = interop.inputs_from_numpy(st, arena_cols, arena_len, visited, code_cols, cfg, "cpu")
    single = interop.outputs_to_numpy(port_segment(*inputs))
    with logical_shards(N_DEV):
        mesh = make_frontier_mesh(mesh_devices("cpu"), path_size=N_DEV)
        pst, parena, pvis, pcode = shard_frontier_inputs(
            st, inputs[1], visited, inputs[4], mesh)
        assert len(pst.blocks) == N_DEV
        sharded = interop.outputs_to_numpy(
            port_segment(pst, parena, int(arena_len), pvis, pcode, inputs[5]))
    assert mesh.shape == {"path": N_DEV, "cand": 1}
    assert want[3] > 0 and want[2] > 0
    for got in (single, sharded):
        for a, b in zip(got, want):
            if isinstance(b, dict):  # the state's fields, the arena's columns
                assert a.keys() == b.keys()
                for name in b:
                    np.testing.assert_array_equal(a[name], b[name],
                                                  err_msg=f"field {name} diverged")
            else:  # arena_len, n_exec, max_live, visited
                np.testing.assert_array_equal(a, b)
    # every fork was granted into a free slot (batch had room): the live
    # half seeded JUMPIs, each granting a child into the free half
    assert (sharded[0]["seed"] >= 0).sum() == 2 * (N_DEV // 2)


# ---------------------------------------------------------------------------
# a device fault in the rebalance's replay
# ---------------------------------------------------------------------------


def _rebalancing_runner(replay):
    """A runner's state for ``PipelinedRunner._rebalance``: 8 slots over 2
    shards, paths running in slots 0-3 (shard 0), shard 1 free; the
    walker's ``replay`` is ``replay``."""
    from mythril_tpu_torch.frontier import ops as O
    from mythril_tpu_torch.frontier.pipeline import CorrectionLedger, PipelinedRunner
    from mythril_tpu_torch.frontier.records import PathRecord
    from mythril_tpu_torch.frontier.state import Caps, empty_state

    caps = Caps(B=8)
    st = empty_state(caps, 4)
    records = {s: None for s in range(8)}
    for s in range(4):
        st.seed[s], st.halt[s], st.pc[s] = 0, O.H_RUNNING, 10 + s
        records[s] = PathRecord(seed_idx=0)
    committed = []
    runner = types.SimpleNamespace(
        caps=caps, st=st, records=records, n_shards=2, ev_seen=np.zeros(8, np.int64),
        ledger=CorrectionLedger(8),
        walker=types.SimpleNamespace(replay=replay, commit=committed.append))
    runner._slot_masks = types.MethodType(PipelinedRunner._slot_masks, runner)
    return runner, types.MethodType(PipelinedRunner._rebalance, runner), committed


@pytest.mark.parametrize("fault", ["device_error", "out_of_memory"])
def test_rebalance_device_fault_reaches_the_caller(fault):
    """A device fault raised in the rebalance's replay is the device failing
    the run: it reaches the caller, where the JAX package's handler (a
    plain ``except Exception``) would log it as one path's failure."""
    from mythril_tpu_torch.device import DeviceError

    error = (DeviceError("segment launch failed") if fault == "device_error"
             else torch.OutOfMemoryError("CUDA out of memory"))

    def replay(rec):
        raise error

    _runner, rebalance, committed = _rebalancing_runner(replay)
    with pytest.raises(type(error)) as raised:
        rebalance()
    assert raised.value is error and committed == []


def test_rebalance_plain_error_costs_only_its_path():
    """A plain ``RuntimeError`` in one spilled path's replay costs that path
    alone: both planned spills (slots 3 and 2, as ``plan_rebalance`` plans
    them) leave their slots, the other's commit runs, the ledger carries
    both, the paths in slots 0-1 keep running."""
    from mythril_tpu_torch.frontier import ops as O

    def replay(rec):
        if rec.final["pc"] == 13:
            raise RuntimeError("replay failed on one path")

    runner, rebalance, committed = _rebalancing_runner(replay)
    spilled = [runner.records[3], runner.records[2]]
    assert rebalance() is True
    assert committed == [spilled[1]]
    assert all(r.final["halt"] == O.H_PARK for r in spilled)
    assert [runner.records[s] is None for s in range(4)] == [False, False, True, True]
    assert runner.st.seed.tolist()[:4] == [0, 0, -1, -1]
    assert runner.ledger.corr_mask.tolist() == [False, False, True, True] + [False] * 4


# ---------------------------------------------------------------------------
# end-to-end parity: sharded-pipelined vs single-device-pipelined
# ---------------------------------------------------------------------------


def mesh_counters(base: str) -> dict:
    """The counters of a pod run: the mesh's devices, the runner's shards,
    the padded slots, the delta pulls' bytes by shard, and, which a run's
    timing can move, ``segments_pipelined`` and the rebalance's syncs and
    moved slots."""
    import importlib

    reg = importlib.import_module(f"{base}.observability.metrics").get_registry()
    stats = importlib.import_module(f"{base}.frontier.stats").FrontierStatistics()
    by_shard = reg.snapshot(prefix="pipeline.").get("pipeline.delta_pull_bytes_by_shard") or {}
    return {
        "mesh_devices": int(stats.mesh_devices or 0),
        "mesh_shards": int(reg.gauge("pipeline.mesh_shards").value or 0),
        "mesh_pad_slots": int(reg.counter("frontier.mesh_pad_slots").value or 0),
        "segments_pipelined": int(reg.counter("pipeline.segments_pipelined").value or 0),
        "pull_shards": sorted(by_shard),
        "pull_bytes_by_shard": {k: int(v) for k, v in sorted(by_shard.items())},
        "rebalance_syncs": int(reg.counter("pipeline.rebalance_syncs").value or 0),
        "rebalanced_slots": int(reg.counter("pipeline.rebalanced_slots").value or 0),
    }


def _analyze(base: str, width: int, mesh: bool, device="cpu", pipeline: bool = True,
             name: str = "storage_gate") -> dict:
    """The contract ``name`` (the storage-gated one, 2 transactions, or
    ``WIDE``), pipelined (or with ``pipeline`` False the synchronous loop)
    with the frontier forced at ``width``, every default tier of ``base``
    on, the mesh on or off, the port on ``device`` (None: the card) ->
    {"summary", **mesh_counters}."""
    import importlib

    from tests._torch_parity import reset_pipeline_counters, run_analysis

    args = importlib.import_module(f"{base}.support.support_args").args
    reg = importlib.import_module(f"{base}.observability.metrics").get_registry()
    saved = args.frontier_mesh
    args.frontier_mesh = mesh
    reg.gauge("pipeline.mesh_shards").set(0)
    reset_pipeline_counters(base)
    port = base == "mythril_tpu_torch"
    kw = dict(cdcl=True, tiers=True, defaults=True, pipeline=pipeline, adaptive=True,
              probe_backend="auto", device=device) if port else {}
    code, tx_count, modules = contract(name)
    try:
        run = run_analysis(base, bytes.fromhex(code), tx_count=tx_count, frontier=True,
                           force=True, width=width, modules=modules, timeout=120,
                           record=False, **kw)
    finally:
        args.frontier_mesh = saved
    return {"summary": run["summary"], **mesh_counters(base)}


@pytest.fixture(scope="module")
def recorded() -> dict:
    return json.loads(RECORD.read_text())["runs"]


@pytest.mark.parametrize("width", WIDTHS)
def test_pod_parity_multi_tx_storage_gate(recorded, width):
    """Sharded-pipelined vs single-device-pipelined on the storage-gated
    selfdestruct (2-tx chain), on the port's 8-shard mesh: the issue keys
    equal to each other and to the JAX package's runs on its 8 devices (the
    recording), and the mesh run's counters equal to the JAX mesh run's:
    8 mesh devices, 8 runner shards, the padded slots, a chained dispatch
    (``segments_pipelined`` > 0), 8 per-shard pull keys; the ``--no-mesh``
    run has none of them."""
    from mythril_tpu_torch.parallel.mesh import logical_shards

    rec = recorded[f"storage_gate/{width}"]
    assert rec["jax_devices"] == N_DEV
    with logical_shards(N_DEV):
        sharded = _analyze("mythril_tpu_torch", width, mesh=True)
        single = _analyze("mythril_tpu_torch", width, mesh=False)
    assert sharded["summary"] == single["summary"] == rec["mesh"]["summary"] == (
        rec["no_mesh"]["summary"])
    assert len(sharded["summary"]) == 1
    # the per-shard pull bytes too: no path of this contract is rolled back,
    # so its delta pulls are the recording's (as test_torch_pipeline holds
    # a run's delta-pull bytes where no path was rolled back)
    for key in ("mesh_devices", "mesh_shards", "mesh_pad_slots", "pull_shards",
                "pull_bytes_by_shard"):
        assert sharded[key] == rec["mesh"][key], key
    assert sharded["mesh_devices"] == sharded["mesh_shards"] == N_DEV
    assert (sharded["mesh_pad_slots"] > 0) == (width % N_DEV > 0)
    assert sharded["pull_shards"] == [f"shard{k}" for k in range(N_DEV)]
    assert sharded["segments_pipelined"] > 0 and rec["mesh"]["segments_pipelined"] > 0
    assert {k: single[k] for k in ("mesh_devices", "mesh_shards", "mesh_pad_slots",
                                   "pull_shards")} == {
        "mesh_devices": 0, "mesh_shards": 0, "mesh_pad_slots": 0, "pull_shards": []}
    assert sum(sharded["pull_bytes_by_shard"].values()) > 0
    assert single["segments_pipelined"] > 0


def test_synchronous_loop_on_the_mesh_finds_the_recorded_issue(recorded):
    """``--no-pipeline`` composes with the mesh: the synchronous loop on the
    8-shard mesh pads the width (60 -> 64) and builds the mesh, and finds the
    recorded issue keys; it has no runner, so no runner shards and no
    per-shard pulls."""
    from mythril_tpu_torch.parallel.mesh import logical_shards

    rec = recorded["storage_gate/60"]
    with logical_shards(N_DEV):
        run = _analyze("mythril_tpu_torch", 60, mesh=True, pipeline=False)
    assert run["summary"] == rec["mesh"]["summary"]
    assert (run["mesh_devices"], run["mesh_shards"], run["segments_pipelined"],
            run["pull_shards"]) == (N_DEV, 0, 0, [])
    assert run["mesh_pad_slots"] == rec["mesh"]["mesh_pad_slots"]


def test_pod_rebalance_moves_paths_across_shards(recorded):
    """``bench.py``'s wide contract of 7 branches pipelined at 64 on the
    8-shard mesh: 128 paths spill and re-inject, the rebalance moves live
    paths from hot shards at sync points (the JAX package's run on its 8
    devices moved some too), and the issue keys are the recording's."""
    from mythril_tpu_torch.parallel.mesh import logical_shards

    rec = recorded[f"{WIDE}/64"]
    assert rec["mesh"]["rebalance_syncs"] > 0 and rec["mesh"]["rebalanced_slots"] > 0
    with logical_shards(N_DEV):
        run = _analyze("mythril_tpu_torch", 64, mesh=True, name=WIDE)
    assert run["summary"] == rec["mesh"]["summary"] == rec["no_mesh"]["summary"]
    assert run["mesh_devices"] == run["mesh_shards"] == N_DEV
    assert run["rebalance_syncs"] > 0 and run["rebalanced_slots"] > 0


def _write() -> None:
    """Record the JAX package's pod runs (this process: 8 virtual CPU
    devices, as tests/conftest.py forces them)."""
    import jax

    assert jax.device_count() == N_DEV
    runs = {}
    for name, width in [("storage_gate", w) for w in WIDTHS] + [(WIDE, 64)]:
        runs[f"{name}/{width}"] = {
            "width": width, "jax_devices": jax.device_count(),
            "mesh": _analyze("mythril_tpu", width, mesh=True, name=name),
            "no_mesh": _analyze("mythril_tpu", width, mesh=False, name=name),
        }
        print(name, width, runs[f"{name}/{width}"], flush=True)
    RECORD.write_text(json.dumps({
        "contracts": {name: contract(name) for name in ("storage_gate", WIDE)}, "runs": runs,
    }, indent=1) + "\n")


if __name__ == "__main__":
    if "--write" in sys.argv:
        flags = os.environ.get("XLA_FLAGS", "")
        os.environ["XLA_FLAGS"] = f"{flags} --xla_force_host_platform_device_count={N_DEV}"
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax

        jax.config.update("jax_platforms", "cpu")
        _write()
        os._exit(0)
