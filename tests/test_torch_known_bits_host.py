"""The known-bits kernel's own code on the CPU: its level plan, the cross-limb
steps of its half-warp, and its whole pass, bit for bit (tolerance 0:
integer parity).

``absdomain/device.py`` ``level_plan`` orders a tape's nodes by dependency
level; it is held here as a permutation whose levels respect every child and
are as shallow as the tape allows.  ``csrc/known_bits.cuh`` is
``__host__ __device__``: ``csrc/host_check.cpp`` builds it with a host C++
compiler, its 16 lanes a loop (``mk_kb_steps_host`` exposes the votes,
shuffles and carries; ``mk_known_bits_host`` runs the pass row by row, the
block's 32 half-warps the last first, with the row's shared memory a
poisoned host array).  The steps are held against Python integers at widths
1-512, the pass against the plain version ``domains.eval_kb_plain`` and
the JAX package's host twin ``domains.eval_kb_host`` on seeded tapes (every
op code, missing children, children at or after their node, overrides) on
both routes, and on the recorded packs of
``tests/testdata/torch_tier_kernels.npz`` against their stored digests.
"""

import numpy as np
import pytest
import torch

from mythril_tpu.absdomain import domains as jd
from mythril_tpu.absdomain import tape as jtape
from mythril_tpu_torch.absdomain import device as kb_device
from mythril_tpu_torch.absdomain import domains as kb_domains
from mythril_tpu_torch.absdomain import tape as kb_tape
from tests import _torch_tier_cases as tier_cases
from tests import test_torch_engine_tiers as tiers
from tests.test_torch_csrc_host import _host_known_bits, host_lib  # noqa: F401  (fixture)

FULL = (1 << 512) - 1


def _limbs(x: int) -> np.ndarray:
    return np.array([(x >> (32 * i)) & 0xFFFFFFFF for i in range(16)], np.uint32)


def _int(limbs) -> int:
    return sum(int(v) << (32 * i) for i, v in enumerate(limbs))


def _check_plan(children, plan) -> None:
    n = len(children)
    order, levels = plan.order, plan.levels
    assert sorted(order.tolist()) == list(range(n))
    assert levels[0] == 0 and levels[-1] == n and np.all(np.diff(levels) > 0)
    level_of = np.empty(n, np.int64)
    for lv in range(plan.n_levels):
        level_of[order[levels[lv]:levels[lv + 1]]] = lv
    for i, kids in enumerate(np.asarray(children).tolist()):
        read = [c for c in kids if 0 <= c < i]
        assert all(level_of[c] < level_of[i] for c in read), i
        # as shallow as the tape allows: one level above its deepest child
        assert level_of[i] == (max(level_of[c] for c in read) + 1 if read else 0), i


@pytest.mark.parametrize("seed,n_nodes", [(1, 1), (2, 64), (3, 512), (4, 4096)])
def test_level_plan_orders_seeded_tapes(seed, n_nodes):
    f = tier_cases.random_kb_fields(seed, n_nodes, 1)
    children = np.stack([f["a0"], f["a1"], f["a2"]], 1)
    _check_plan(children, kb_device.level_plan(children))


def test_level_plan_orders_recorded_packs():
    for rec in tiers.load_kernels()["kb"]:
        pack = tiers.kb_pack(rec)
        plan = kb_device.pack_plan(pack)
        _check_plan(np.stack([pack.a0, pack.a1, pack.a2], 1), plan)
        assert np.array_equal(plan.packed(), np.concatenate([plan.order, plan.levels]))


def test_level_plan_edges():
    # a child at or after its node orders nothing; a missing one neither
    plan = kb_device.level_plan([[-1, -1, -1], [0, 1, 2], [-5, 0, 1]])
    assert plan.order.tolist() == [0, 1, 2] and plan.levels.tolist() == [0, 1, 2, 3]
    assert kb_device.level_plan(np.zeros((0, 3), np.int32)).levels.tolist() == [0]
    with pytest.raises(ValueError, match="child index 3 of 3"):
        kb_device.level_plan([[-1, -1, -1], [0, 3, -1], [1, 0, -1]])


def test_shared_memory_route_cut():
    """The row's values stay in shared memory up to about 1000 nodes (232 B
    a node), and the global route's staged records fit at the tape's 4096."""
    assert kb_device.smem_words(1, 1, True) == 10 + 2 + 16 + 48
    assert kb_device.smem_words(556, 39, False) == 556 * 10 + 40
    assert kb_device.in_smem(556, 39) and kb_device.in_smem(1000, 45)
    assert not kb_device.in_smem(1002, 31) and not kb_device.in_smem(4096, 45)
    assert 4 * kb_device.smem_words(4096, 60, False) <= kb_device.SMEM_BUDGET


def _values(rng, width: int, n: int):
    """n values below 2^width, with carry and shift hazards among them."""
    out = [(1 << width) - 1, 1, 0, 1 << (width - 1), ((1 << width) - 1) ^ 1]
    while len(out) < n:
        v = int.from_bytes(rng.bytes(64), "little") & ((1 << width) - 1)
        if rng.random() < 0.3:  # runs of all-ones limbs
            v |= ((1 << (32 * int(rng.integers(1, 16)))) - 1) & ((1 << width) - 1)
        out.append(v)
    return out


@pytest.mark.parametrize("width", [1, 8, 31, 32, 33, 64, 160, 255, 256, 257, 480, 511, 512])
def test_cross_limb_steps_match_integers(host_lib, width):  # noqa: F811
    """mk_kb_steps_host: add, sub, shl, lshr, the votes, the bit length,
    the compare and the broadcast bit, against Python integers."""
    rng = np.random.default_rng(width)
    xs, ys = _values(rng, width, 24), _values(rng, width, 24)[::-1]
    shifts = [0, 1, 31, 32, 33, 255, 511, 512, 1023] + [int(s) for s in rng.integers(0, 600, 6)]
    out = np.zeros(70, np.uint32)
    for n, (x, y) in enumerate(zip(xs + [FULL], ys + [FULL])):
        s = shifts[n % len(shifts)]
        pos = int(rng.integers(-512, 512))
        xl, yl = _limbs(x), _limbs(y)
        host_lib.mk_kb_steps_host(xl.ctypes.data, yl.ctypes.data, s, pos, out.ctypes.data)
        assert _int(out[0:16]) == (x + y) & FULL
        assert _int(out[16:32]) == (x - y) & FULL
        assert _int(out[32:48]) == (x << s) & FULL
        assert _int(out[48:64]) == x >> s
        li = pos >> 5
        bit = 32 * (li + 16 if li < 0 else li) + (pos & 31)
        assert out[64:70].tolist() == [x == FULL, x != 0, x.bit_length(), x < y, x == y,
                                       (x >> bit) & 1], (x, y, s, pos)


def _forward_children(fields: dict, seed: int) -> dict:
    """The fields with some children pointing at or after their node, which
    the plain version reads before they are written (zeros)."""
    rng = np.random.default_rng(seed)
    n = len(fields["op"])
    out = {**fields, **{k: fields[k].copy() for k in ("a1", "a2")}}
    for i in rng.choice(n, size=max(1, n // 16), replace=False):
        out["a1" if rng.random() < 0.5 else "a2"][i] = int(rng.integers(i, n))
    return out


@pytest.mark.parametrize("smem", [True, False])
@pytest.mark.parametrize("seed,n_nodes,n_rows,forward", [
    (31, 64, 1, False), (32, 300, 2, False), (33, 512, 16, False), (34, 96, 64, False),
    (35, 200, 3, True), (36, 512, 2, True)])
def test_host_pass_matches_plain_and_host_twin(host_lib, smem, seed, n_nodes,  # noqa: F811
                                              n_rows, forward):
    """The whole pass on either route against eval_kb_plain and the JAX
    package's eval_kb_host."""
    fields = tier_cases.random_kb_fields(seed, n_nodes, n_rows)
    if forward:
        fields = _forward_children(fields, seed)
    inputs = kb_domains.kb_inputs(tier_cases.kb_pack(fields, kb_tape), "cpu")
    got = _host_known_bits(host_lib, *inputs, n_rows, smem=smem)
    want = kb_domains.eval_kb_plain(*inputs, n_rows)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    km, kv, refuted = jd.eval_kb_host(tier_cases.kb_pack(fields, jtape))
    assert np.array_equal(got[0].numpy().view(np.uint32), np.asarray(km, np.uint32))
    assert np.array_equal(got[1].numpy().view(np.uint32), np.asarray(kv, np.uint32))
    assert np.array_equal(got[2].numpy(), np.asarray(refuted, bool))


@pytest.mark.parametrize("start", [1, 2, 3])
def test_host_pass_matches_recorded_digests(host_lib, start):  # noqa: F811
    """Every 4th recorded pack from ``start``, on the global route (the
    shared-memory route takes those from 0 in test_torch_csrc_host.py), and
    the largest on both: the stored digest of the JAX host twin's output."""
    recs = tiers.load_kernels()["kb"]
    largest = max(range(len(recs)), key=lambda i: tiers.kb_pack(recs[i]).n_nodes)
    for n, rec in enumerate(recs):
        if n % 4 != start and n != largest:
            continue
        inputs = kb_domains.kb_inputs(tiers.kb_pack(rec), "cpu")
        for smem in (False, True) if n == largest else (False,):
            km, kv, refuted = _host_known_bits(host_lib, *inputs, int(rec["n_rows"]), smem=smem)
            assert tiers.kb_digest(km.numpy().view(np.uint32), kv.numpy().view(np.uint32),
                                   refuted.numpy()) == rec["digest"], (rec["run"], n)
