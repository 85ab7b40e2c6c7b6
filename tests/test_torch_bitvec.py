"""Parity: the port's limb algebra (mythril_tpu_torch/ops/bitvec.py) against
the JAX package's (mythril_tpu/ops/bitvec.py), bit for bit.

Both sides get the same words: the edge cases of tests/ops/test_bitvec.py
plus random words from a seeded numpy generator, packed once into limbs by
the JAX package's ``from_ints`` and handed over as numpy arrays.  Every
comparison is exact (tolerance 0), and each result is also held against
Python big-int semantics (x/0 == 0, truncated signed division, saturating
shifts, modular exponentiation).
"""

import numpy as np
import pytest
import torch

from mythril_tpu.ops import bitvec as jbv
from mythril_tpu_torch.ops import bitvec as tbv
from mythril_tpu_torch.smt.terms import mask, to_signed
from tests._torch_parity import _one_torch_thread  # noqa: E402,F401  (autouse fixture)

WIDTHS = [8, 16, 24, 64, 160, 256]


def _words(width: int, n: int, seed: int):
    rng = np.random.default_rng(seed * 1000 + width)
    edge = [0, 1, 2, 7, 9, (1 << width) - 1, (1 << width) - 3,
            1 << (width - 1), (1 << (width - 1)) - 1]
    rnd = [int.from_bytes(rng.bytes(32), "little") for _ in range(n)]
    small = [int(v) for v in rng.integers(0, 256, 4)]
    return [mask(v, width) for v in edge + rnd + small]


def _pairs(width: int, n: int = 12):
    xs = _words(width, n, 1)
    ys = list(reversed(_words(width, n, 2)))
    return xs, ys


def _both(values, width):
    """The same words as a JAX limb array and a port limb tensor."""
    arr = jbv.from_ints(values, width)
    return arr, torch.from_numpy(np.asarray(arr).astype(np.int64))


def _same(jax_out, port_out, width):
    want = np.asarray(jax_out).astype(np.int64)
    got = port_out.numpy()
    np.testing.assert_array_equal(got, want)
    return tbv.to_ints(port_out, width)


def _sdiv(x, y, w):
    if y == 0:
        return 0
    sx, sy = to_signed(x, w), to_signed(y, w)
    q = abs(sx) // abs(sy)
    return -q if (sx < 0) != (sy < 0) else q


def _srem(x, y, w):
    if y == 0:
        return 0
    sx, sy = to_signed(x, w), to_signed(y, w)
    r = abs(sx) % abs(sy)
    return -r if sx < 0 else r


BINOPS = {
    "add": lambda x, y, w: x + y,
    "sub": lambda x, y, w: x - y,
    "mul": lambda x, y, w: x * y,
    "and_": lambda x, y, w: x & y,
    "or_": lambda x, y, w: x | y,
    "xor": lambda x, y, w: x ^ y,
    "udiv": lambda x, y, w: 0 if y == 0 else x // y,
    "urem": lambda x, y, w: 0 if y == 0 else x % y,
    "sdiv": _sdiv,
    "srem": _srem,
}


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("op", sorted(BINOPS))
def test_binop_matches_jax(op, width):
    xs, ys = _pairs(width)
    ja, ta = _both(xs, width)
    jb, tb = _both(ys, width)
    got = _same(getattr(jbv, op)(ja, jb, width), getattr(tbv, op)(ta, tb, width), width)
    assert got == [mask(BINOPS[op](x, y, width), width) for x, y in zip(xs, ys)]


@pytest.mark.parametrize("width", WIDTHS)
def test_roundtrip_not_neg(width):
    xs = _words(width, 12, 3)
    ja, ta = _both(xs, width)
    assert tbv.to_ints(tbv.from_ints(xs, width), width) == xs
    np.testing.assert_array_equal(tbv.from_ints_np(xs, width), np.asarray(ja))
    assert _same(jbv.not_(ja, width), tbv.not_(ta, width), width) == [mask(~x, width) for x in xs]
    assert _same(jbv.neg(ja, width), tbv.neg(ta, width), width) == [mask(-x, width) for x in xs]


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("op", ["ult", "ule", "eq", "slt", "sle"])
def test_compare_matches_jax(op, width):
    xs, ys = _pairs(width)
    xs, ys = xs + xs[:4], ys + xs[:4]  # equal pairs too
    ja, ta = _both(xs, width)
    jb, tb = _both(ys, width)
    extra = (width,) if op in ("slt", "sle") else ()
    want = np.asarray(getattr(jbv, op)(ja, jb, *extra))
    got = getattr(tbv, op)(ta, tb, *extra).numpy()
    np.testing.assert_array_equal(got, want)
    py = {
        "ult": lambda x, y: x < y, "ule": lambda x, y: x <= y, "eq": lambda x, y: x == y,
        "slt": lambda x, y: to_signed(x, width) < to_signed(y, width),
        "sle": lambda x, y: to_signed(x, width) <= to_signed(y, width),
    }[op]
    assert list(got) == [py(x, y) for x, y in zip(xs, ys)]


@pytest.mark.parametrize("width", [8, 24, 64, 256])
@pytest.mark.parametrize("op", ["shl", "lshr", "ashr"])
def test_shift_matches_jax(op, width):
    xs = _words(width, 8, 4)
    shifts = [0, 1, 7, 15, 16, 17, width - 1, width, width + 3, 2 * width, 1 << 100]
    shifts = [mask(s, width) for s in shifts if s < (1 << width)] + [(1 << width) - 1]
    pairs = [(x, s) for s in shifts for x in xs]
    ja, ta = _both([p[0] for p in pairs], width)
    js, ts = _both([p[1] for p in pairs], width)
    got = _same(getattr(jbv, op)(ja, js, width), getattr(tbv, op)(ta, ts, width), width)
    py = {
        "shl": lambda x, s: mask(x << s, width) if s < width else 0,
        "lshr": lambda x, s: x >> s if s < width else 0,
        "ashr": lambda x, s: mask(to_signed(x, width) >> min(s, width - 1), width),
    }[op]
    assert got == [py(x, s) for x, s in pairs]


@pytest.mark.parametrize("width", [8, 64, 256])
def test_bvexp_matches_jax(width):
    xs = [0, 1, 2, 3, 10, 255, (1 << width) - 1] + _words(width, 2, 5)[-3:]
    es = [0, 1, 2, 3, 17, width, (1 << width) - 1]
    pairs = [(x, e) for x in xs for e in es]
    ja, ta = _both([p[0] for p in pairs], width)
    je, te = _both([p[1] for p in pairs], width)
    got = _same(jbv.bvexp(ja, je, width), tbv.bvexp(ta, te, width), width)
    assert got == [pow(x, e, 1 << width) for x, e in pairs]


def test_width_changes_match_jax():
    xs = _words(256, 8, 6)
    ja, ta = _both(xs, 256)
    _same(jbv.resize(ja, 256, 64), tbv.resize(ta, 256, 64), 64)
    _same(jbv.resize(ja, 256, 512), tbv.resize(ta, 256, 512), 512)
    small = [0, 1, 0x7F, 0x80, 0xFF]
    js, ts = _both(small, 8)
    assert _same(jbv.sext_to(js, 8, 256), tbv.sext_to(ts, 8, 256), 256) == [
        mask(to_signed(v, 8), 256) for v in small
    ]
    for hi, lo in [(255, 0), (255, 248), (7, 0), (131, 4), (40, 33)]:
        w = hi - lo + 1
        assert _same(jbv.extract_bits(ja, hi, lo, 256), tbv.extract_bits(ta, hi, lo, 256), w) == [
            (x >> lo) & ((1 << w) - 1) for x in xs
        ]
    ys = list(reversed(xs))
    jb, tb = _both(ys, 256)
    assert _same(jbv.concat_bits(ja, jb, 256, 256), tbv.concat_bits(ta, tb, 256, 256), 512) == [
        (x << 256) | y for x, y in zip(xs, ys)
    ]
    jc, tc = _both([0x5], 3)
    jd, td = _both([0x1F], 5)
    assert _same(jbv.concat_bits(jc, jd, 3, 5), tbv.concat_bits(tc, td, 3, 5), 8) == [0xBF]


def test_mux_and_sign_bit_match_jax():
    xs = [0, 1, 1 << 255, (1 << 256) - 1]
    ja, ta = _both(xs, 256)
    jb, tb = _both(list(reversed(xs)), 256)
    cond = np.array([True, False, True, False])
    _same(jbv.mux(cond, ja, jb), tbv.mux(torch.from_numpy(cond), ta, tb), 256)
    np.testing.assert_array_equal(
        tbv.sign_bit(ta, 256).numpy(), np.asarray(jbv.sign_bit(ja, 256)).astype(np.int64)
    )
