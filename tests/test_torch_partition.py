"""The frontier segment partitioned over slot blocks, on the CPU, exactly
(integers and bools, tolerance 0).

``step.segment_partitioned_torch`` is the plain version of the partitioned
kernel: each block's paths step on their own block, the fork grant ranks
every block's keys together and takes free slots of any block, and a child's
row is copied from its parent's block into its own.  On 2, 4 and 8 logical
shards of the CPU (each block a ``ShardedState`` block in allocations of its
own) it must give the unsharded plain segment's outputs and the JAX
package's: the segment on its 8 virtual devices for ``__graft_entry__``'s
mesh example (as ``tests/test_torch_pod.py`` holds the mesh), the JAX
segment for the targeted cases of ``tests/_torch_frontier_cases.py``
``partition_cases`` (a child in another shard's block, more wanting paths
than free slots across shards, ``SEL_COVERAGE``, shards with no live path,
the arena's stop, fork rounds over every block).  The transfers of a
sharded state (the push by blocks, the full and delta pulls, the chained
dispatch's per-block merge) equal the unsharded ones.  The kernel's shard
executor, built by g++, runs the same cases in
``tests/test_torch_csrc_host.py``; the launches run on a card
(``tests/test_torch_cuda.py -k partition``, ``chip_smoke.py`` phase 8m).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mythril_tpu_torch.frontier import interop
from mythril_tpu_torch.frontier import ops as PO
from mythril_tpu_torch.frontier import step as PS
from mythril_tpu_torch.frontier.state import FrontierState
from tests._torch_parity import _one_torch_thread  # noqa: E402,F401  (autouse fixture)
from tests import _torch_frontier_cases as cases
from tests._torch_frontier_cases import assert_same

SHARDS = (2, 4, 8)
PARTITION = cases.partition_cases()
N_DEV = 8


def shard(state: FrontierState, n: int) -> PS.ShardedState:
    """The whole batch's tensors cut into ``n`` blocks of their own."""
    bs = state.pc.shape[0] // n
    return PS.ShardedState([FrontierState(*[f[k * bs:(k + 1) * bs].clone() for f in state])
                            for k in range(n)])


def _inputs(case):
    return interop.inputs_from_numpy(case["state"], case["arena"], case["arena_len"],
                                     case["visited"], case["code"], case["cfg"], "cpu")


def run_plain(case):
    return interop.outputs_to_numpy(PS.segment_torch(*_inputs(case), case.get("caps", cases.CAPS)))


def run_partitioned(case, n):
    inputs = _inputs(case)
    out = PS.segment_partitioned_torch(shard(inputs[0], n), *inputs[1:],
                                       case.get("caps", cases.CAPS))
    assert isinstance(out[0], PS.ShardedState) and len(out[0].blocks) == n
    return interop.outputs_to_numpy(out)


@pytest.mark.parametrize("name", sorted(PARTITION))
def test_partitioned_segment_equals_the_unsharded_and_jax(name):
    from tests.test_torch_frontier_segment import run_jax

    case = PARTITION[name]
    want = run_jax(case)
    assert_same(run_plain(case), want)
    for n in SHARDS:
        try:
            assert_same(run_partitioned(case, n), want)
        except AssertionError as e:
            raise AssertionError(f"{n} shards: {e}") from None


def _children(case, out):
    """(parent slot, child slot) of every fork granted in the segment: the
    E_FORK events whose child slot is set."""
    st = out[0]
    pairs = []
    for b in range(len(st["pc"])):
        for e in st["events"][b, : st["ev_len"][b]]:
            if e[0] == PO.E_FORK and e[12] >= 0:
                pairs.append((b, int(e[12])))
    return pairs


def test_the_cases_cross_blocks():
    """Each case does what its name says on the unsharded segment."""
    B = cases.CAPS.B
    out = {name: run_plain(case) for name, case in PARTITION.items()}
    # children land in another shard's block at every shard count
    pairs = _children(PARTITION["child_in_another_block"], out["child_in_another_block"])
    assert pairs and all(p < B // 2 <= c for p, c in pairs)
    # more wanting paths than free slots: some forks pend
    st = out["scarcity_across_shards"][0]
    assert (st["halt"] == PO.H_PENDING_FORK).sum() > 0
    assert PARTITION["coverage_across_shards"]["cfg"][4] == PS.SEL_COVERAGE
    assert (out["coverage_across_shards"][0]["halt"] == PO.H_PENDING_FORK).sum() > 0
    # the first block has no running path at the start
    st0 = PARTITION["shards_with_no_live_path"]["state"]
    assert not ((st0.halt[: B // 2] == PO.H_RUNNING) & (st0.seed[: B // 2] >= 0)).any()
    # the arena's stop ends the loop before K steps
    arena_len = out["arena_stop"][2]
    assert arena_len + 4 * cases.CAPS.R > cases.CAPS.ARENA - 4 * cases.CAPS.R
    assert out["arena_stop"][3] < 4 * cases.CAPS.K
    # the fork rounds fill every block
    assert (out["fork_rounds"][0]["seed"] >= 0).all()


@pytest.mark.parametrize("seed", range(4))
def test_partitioned_segment_random_batches(seed):
    case = cases.random_case(700 + seed)
    want = run_plain(case)
    for n in SHARDS:
        assert_same(run_partitioned(case, n), want)


def test_partitioned_segment_blocks_of_several_kernel_blocks():
    """Two shards of 129 slots: each block spans two of the kernel's blocks
    of 128 lanes, the second with one slot; forks fill both shards."""
    case = cases.width_case(258, 0)
    want = run_plain(case)
    assert_same(run_partitioned(case, 2), want)
    assert (want[0]["seed"] >= 0).all()


def test_partitioned_segment_on_the_jax_mesh_example():
    """``__graft_entry__._frontier_example(8)`` through the JAX package's
    segment on its 8-device mesh (GSPMD), and through the port's
    partitioned segment on 2, 4 and 8 logical shards of the CPU."""
    import jax

    import __graft_entry__ as graft

    from mythril_tpu.parallel import make_frontier_mesh as jax_mesh
    from mythril_tpu.parallel import shard_frontier_inputs as jax_shard
    from mythril_tpu_torch.frontier.state import Caps

    assert jax.device_count() == N_DEV, "conftest should pin 8 virtual CPU devices"
    segment, (st, dev_arena, arena_len, visited, code_dev, cfg) = graft._frontier_example(N_DEV)
    jst, jarena, jvis, jcode = jax_shard(st, dev_arena, visited, code_dev,
                                         jax_mesh(path_size=N_DEV))
    want = interop.outputs_to_numpy(segment(jst, jarena, arena_len, jvis, jcode, cfg))
    inputs = interop.inputs_from_numpy(st, [np.asarray(a) for a in dev_arena], arena_len,
                                       visited, [np.asarray(x) for x in code_dev], cfg, "cpu")
    for n in SHARDS:
        out = PS.segment_partitioned_torch(shard(inputs[0], n), *inputs[1:], Caps(B=N_DEV))
        assert_same(interop.outputs_to_numpy(out), want)
    assert want[3] > 0 and (want[0]["seed"] >= 0).sum() == N_DEV


def test_the_mesh_segment_takes_a_sharded_state():
    """``cached_segment``'s segment runs the partitioned plain version on a
    ``ShardedState`` of CPU blocks, and the CUDA wrapper refuses CPU
    tensors."""
    case = PARTITION["child_in_another_block"]
    inputs = _inputs(case)
    segment = PS.cached_segment(cases.CAPS, *cases.BUCKET, device="cpu")
    got = segment(shard(inputs[0], 4), *inputs[1:])
    assert isinstance(got[0], PS.ShardedState)
    assert_same(interop.outputs_to_numpy(got), run_plain(case))
    with pytest.raises(ValueError, match="CUDA tensors"):
        PS.segment_partitioned(shard(inputs[0], 2), *inputs[1:], cases.CAPS)
    with pytest.raises(ValueError, match="do not make"):
        PS.segment_partitioned_torch(shard(inputs[0], 2), *inputs[1:],
                                     PS.Caps(**{**cases.CAPS.__dict__, "B": 16}))


# ---------------------------------------------------------------------------
# the transfers of a sharded state
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", SHARDS)
def test_sharded_pulls_equal_the_unsharded(n):
    """Full and delta pulls of a state pushed by blocks equal those of the
    same state pushed whole, the delta pull's bytes and per-shard bytes
    too."""
    from mythril_tpu_torch.frontier import pipeline
    from mythril_tpu_torch.frontier.state import Caps
    from mythril_tpu_torch.observability.metrics import get_registry
    from tests.test_torch_pipeline import _pulled_state

    rng = np.random.default_rng(2100 + n)
    caps = Caps(B=40, EVT=40)
    st, prev = _pulled_state(caps, rng)
    whole = interop.state_to_torch(st, "cpu")
    blocks = shard(whole, n)
    scalars = (int(rng.integers(0, 1000)), int(rng.integers(0, 1000)), 7)
    full_w, full_s = PS.pull_harvest(whole, *scalars), PS.pull_harvest(blocks, *scalars)
    got = {}
    for label, state in (("whole", whole), ("blocks", blocks)):
        get_registry().reset(prefix="pipeline.")
        pipeline.reset_counters()
        out = PS.pull_harvest(state, *scalars, prev=prev, shards=n)
        by_shard = get_registry().snapshot(prefix="pipeline.").get(
            "pipeline.delta_pull_bytes_by_shard")
        got[label] = (out, pipeline.COUNTERS["delta_pull_bytes"], by_shard)
    assert full_s[1:] == full_w[1:] == got["whole"][0][1:] == got["blocks"][0][1:]
    for name, a, b, c, d in zip(FrontierState._fields, full_w[0], full_s[0], got["whole"][0][0],
                                got["blocks"][0][0]):
        for x in (b, c, d):
            np.testing.assert_array_equal(x, a, err_msg=name)
    assert got["whole"][1:] == got["blocks"][1:]
    # pushed by blocks, each block holds its slots
    pushed = PS.push_state(full_w[0], device="cpu", devices=["cpu"] * n)
    assert len(pushed.blocks) == n
    np.testing.assert_array_equal(pushed.pc.numpy(), full_w[0].pc)


def test_sharded_chained_dispatch_equals_the_unsharded():
    """A chained dispatch on a sharded segment's outputs (each block's
    corrections merged on its own) equals the same chain unsharded."""
    case = PARTITION["fork_rounds"]
    inputs = _inputs(case)
    caps, cfg = cases.CAPS, inputs[5]._replace(k_limit=5)
    segment = PS.cached_segment(caps, *cases.BUCKET, device="cpu")
    first_w = segment(inputs[0], *inputs[1:5], cfg)
    first_s = segment(shard(inputs[0], 4), *inputs[1:5], cfg)
    host, *_ = PS.pull_harvest(first_w[0], *first_w[2:5])
    mask = np.zeros(caps.B, bool)
    mask[[1, 6]] = True
    host.pc[1], host.halt[6] = host.pc[1] + 1, PO.H_STOP
    got_w = PS.chain_dispatch(segment, first_w, host, mask, inputs[4], cfg)
    got_s = PS.chain_dispatch(segment, first_s, host, mask, inputs[4], cfg)
    assert isinstance(got_s[0], PS.ShardedState)
    assert_same(interop.outputs_to_numpy(got_s), interop.outputs_to_numpy(got_w))
