"""Tape VM cases shared by the parity tests and ``chip_smoke.py``.

Each case function takes a term module (``mythril_tpu.smt.terms`` or the port's
copy, whose API is the same) and returns ``(conjuncts, bv_vars,
array_vars)``.  ``FAMILIES`` holds one conjunction per op family of the
tape VM, so that each of its 20 op codes runs; ``widen`` appends a chain
that pushes any of them onto the large profile.  ``random_assignments``
draws candidate values from a seeded numpy generator: small values, values
near the 256-bit shift limit, small negatives and full-width words.

This module imports neither JAX nor the JAX package.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

LARGE_CHAIN = 60  # add/mul pairs: 120 steps, past the small profile's 96


def _vars(T, tag):
    x = T.var(f"tc_{tag}_x", 256)
    y = T.var(f"tc_{tag}_y", 256)
    z = T.var(f"tc_{tag}_z", 64)
    return x, y, z


def _c(T, v, w=256):
    return T.const(v, w)


def fam_add(T):
    x, y, z = _vars(T, "add")
    return [T.eq(T.add(x, y), _c(T, 100)), T.ult(T.add(z, _c(T, 7, 64)), _c(T, 9, 64))], [x, y, z], []


def fam_sub(T):
    x, y, z = _vars(T, "sub")
    return [T.ult(T.sub(x, y), y), T.sle(T.neg(z), z)], [x, y, z], []


def fam_mul(T):
    x, y, z = _vars(T, "mul")
    return [T.ult(T.mul(x, _c(T, 3)), y), T.eq(T.mul(x, y), T.mul(y, y))], [x, y, z], []


def fam_udiv(T):
    x, y, z = _vars(T, "udiv")
    return [T.eq(T.udiv(x, y), _c(T, 2)), T.ult(T.udiv(z, _c(T, 3, 64)), z)], [x, y, z], []


def fam_urem(T):
    x, y, z = _vars(T, "urem")
    return [T.eq(T.urem(x, _c(T, 7)), _c(T, 3)), T.ult(T.urem(y, x), _c(T, 5))], [x, y, z], []


def fam_sdiv(T):
    x, y, z = _vars(T, "sdiv")
    return [T.eq(T.sdiv(x, y), _c(T, 2)), T.slt(T.sdiv(z, _c(T, 3, 64)), z)], [x, y, z], []


def fam_srem(T):
    x, y, z = _vars(T, "srem")
    return [T.eq(T.srem(x, y), T.sub(x, y)), T.slt(T.srem(z, _c(T, 5, 64)), _c(T, 1, 64))], [x, y, z], []


def fam_exp(T):
    x, y, z = _vars(T, "exp")
    return [T.ule(y, T.bvexp(_c(T, 2), x)), T.ult(T.bvexp(x, y), _c(T, 1 << 200))], [x, y, z], []


def fam_and(T):
    x, y, z = _vars(T, "and")
    p, q = T.bool_var("tc_and_p"), T.bool_var("tc_and_q")
    return [T.eq(T.band(x, y), _c(T, 0x10)), T.land(p, q, T.ult(x, y))], [x, y, z, p, q], []


def fam_or(T):
    x, y, z = _vars(T, "or")
    p, q = T.bool_var("tc_or_p"), T.bool_var("tc_or_q")
    return [T.eq(T.band(x, y), T.bor(x, T.bnot(y))), T.lor(p, q)], [x, y, z, p, q], []


def fam_xor(T):
    x, y, z = _vars(T, "xor")
    p, q = T.bool_var("tc_xor_p"), T.bool_var("tc_xor_q")
    return [T.ult(T.bxor(x, y), x), T.lxor(p, q), T.lnot(p)], [x, y, z, p, q], []


def fam_shl(T):
    x, y, z = _vars(T, "shl")
    return [T.eq(T.shl(x, y), _c(T, 0x80)), T.eq(T.shl(x, y), _c(T, 0)),
            T.eq(T.concat2(T.extract(31, 0, x), T.extract(31, 0, y)), _c(T, 0xDEADBEEF_12345678, 64))], [x, y, z], []


def fam_lshr(T):
    x, y, z = _vars(T, "lshr")
    return [T.eq(T.lshr(x, _c(T, 4)), _c(T, 1)), T.ult(T.lshr(x, y), y),
            T.eq(T.lshr(y, x), _c(T, 0)),
            T.eq(T.extract(200, 8, x), T.extract(192, 0, y))], [x, y, z], []


def fam_ashr(T):
    x, y, z = _vars(T, "ashr")
    return [T.ult(T.ashr(x, y), x), T.slt(T.ashr(z, _c(T, 3, 64)), _c(T, 0, 64)),
            T.ult(T.sext(T.extract(7, 0, x), 248), x)], [x, y, z], []


def fam_eq(T):
    x, y, z = _vars(T, "eq")
    return [T.eq(x, y), T.eq(T.sext(z, 32), T.zext(z, 32))], [x, y, z], []


def fam_ult(T):
    x, y, z = _vars(T, "ult")
    return [T.ult(x, y), T.ule(z, _c(T, 5, 64)), T.sle(T.extract(63, 0, x), z)], [x, y, z], []


def fam_ite(T):
    x, y, z = _vars(T, "ite")
    p = T.bool_var("tc_ite_p")
    return [T.eq(T.ite(p, x, _c(T, 7)), _c(T, 7)),
            T.ult(T.ite(T.ult(x, y), y, x), _c(T, 1 << 255))], [x, y, z, p], []


def fam_select(T):
    x, y, z = _vars(T, "select")
    a = T.array_var("tc_select_a", 256, 256)
    stored = T.store(T.store(a, _c(T, 5), _c(T, 42)), x, _c(T, 9))
    return [
        T.eq(T.select(stored, _c(T, 5)), _c(T, 42)),
        T.eq(T.select(stored, x), _c(T, 9)),
        T.ult(T.select(a, _c(T, 0)), _c(T, 50)),
        T.eq(T.select(a, x), T.select(stored, _c(T, 7))),
        T.ult(T.select(a, y), _c(T, 1 << 128)),
    ], [x, y, z], [a]


def fam_keccak32(T):
    x, y, z = _vars(T, "k32")
    return [T.ult(_c(T, 0), T.keccak(x)),
            T.ult(T.keccak(T.keccak(y)), T.keccak(x))], [x, y, z], []


def fam_keccak64(T):
    x, y, z = _vars(T, "k64")
    h = T.keccak(T.concat2(x, y))
    return [T.eq(T.extract(255, 248, h), T.extract(255, 248, T.keccak(T.concat2(y, x)))),
            T.ult(h, T.bnot(_c(T, 0))),
            T.ult(T.keccak(T.concat2(h, x)), h)], [x, y, z], []


FAMILIES: Dict[str, Callable] = {
    "add": fam_add, "sub": fam_sub, "mul": fam_mul, "udiv": fam_udiv,
    "urem": fam_urem, "sdiv": fam_sdiv, "srem": fam_srem, "exp": fam_exp,
    "and": fam_and, "or": fam_or, "xor": fam_xor, "shl": fam_shl,
    "lshr": fam_lshr, "ashr": fam_ashr, "eq": fam_eq, "ult": fam_ult,
    "ite": fam_ite, "select": fam_select, "keccak32": fam_keccak32,
    "keccak64": fam_keccak64,
}

# the tape op code each family exists to run (tape_vm.OP_* order)
FAMILY_OP = {name: i for i, name in enumerate(FAMILIES)}

WIDE_LIVE = 220  # values generated before any is read by the reduction


def case_wide_live(T):
    """``WIDE_LIVE`` values all live at once, then folded by ULT/ITE pairs
    (large profile): the port's slot file needs more than 200 slots, past
    what a block of 32 candidates holds in shared memory."""
    x, y, _z = _vars(T, "wide")
    vals = [x]
    for _ in range(WIDE_LIVE):
        vals.append(T.add(vals[-1], y))
    # a left fold from the last value: every reduction step depends on the
    # whole chain, so in any order of the tape all values are live at once
    acc, rest = vals[-1], vals[-2::-1]
    while len(rest) >= 3:
        a, b, c, *rest = rest
        acc = T.ite(T.ult(acc, a), b, c)
    for v in rest:
        acc = T.bxor(acc, v)
    return [T.ult(acc, _c(T, 1 << 255))], [x, y], []


def case_keccak_live(T):
    """Values defined before the first keccak step and read after the second,
    so the port's kernel spills them across both."""
    x, y, z = _vars(T, "klive")
    a, b = T.add(x, y), T.mul(x, _c(T, 3))
    h1 = T.keccak(a)
    c = T.add(h1, b)
    h2 = T.keccak(T.concat2(c, a))
    return [T.ult(T.add(h2, a), b), T.eq(T.sub(b, a), T.add(h1, c)),
            T.ult(T.add(z, _c(T, 1, 64)), T.extract(63, 0, h2))], [x, y, z], []


def case_leaf_roots(T):
    """Roots on leaf rows (a boolean variable, the constant true) and roots
    whose row is final at the tape's first steps, ahead of a long chain."""
    x, y, z = _vars(T, "lroot")
    p = T.bool_var("tc_lroot_p")
    acc = x
    for k in range(30):
        acc = T.add(T.mul(acc, y), _c(T, k + 1))
    return [p, T.true(), T.ult(x, y), T.eq(T.band(x, _c(T, 1)), _c(T, 0)),
            T.ult(acc, y), T.lnot(p)], [x, y, z, p], []


# cases for the port's slot plan (ops/tape_vm.py TapePlan) beyond the op families
SLOT_CASES: Dict[str, Callable] = {
    "wide_live": case_wide_live, "keccak_live": case_keccak_live,
    "leaf_roots": case_leaf_roots,
}


def widen(T, conjuncts, bv_vars):
    """Append a 120-step add/mul chain so the tape needs the large profile."""
    x = bv_vars[0]
    acc = x
    for k in range(LARGE_CHAIN):
        acc = T.add(T.mul(acc, T.const(k + 3, 256)), x)
    return list(conjuncts) + [T.ult(T.const(1, 256), acc)]


def build(T, family: str, large: bool = False):
    conj, bv_vars, arrays = {**FAMILIES, **SLOT_CASES}[family](T)
    if large:
        conj = widen(T, conj, bv_vars)
    return conj, bv_vars, arrays


def random_assignments(T, ce, bv_vars, array_vars, seed: int, n: int):
    """``n`` candidate assignments (``ce``: a concrete_eval module)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        asg = ce.Assignment()
        for v in bv_vars:
            if v.sort is T.BOOL:
                asg.scalars[v] = bool(rng.random() < 0.5)
                continue
            w = v.width
            choice = rng.random()
            if choice < 0.2:
                val = int(rng.integers(0, 6))
            elif choice < 0.35:
                val = int(rng.integers(250, 262))
            elif choice < 0.5:
                val = T.mask(-int(rng.integers(1, 6)), w)
            else:
                val = int.from_bytes(rng.bytes(32), "little")
            asg.scalars[v] = T.mask(val, w)
        for av in array_vars:
            backing = {
                # keys 1..6: index 0 always reads the default, and fewer
                # keys than table rows leave invalid (zero-index) rows
                int(rng.integers(1, 7)): T.mask(int.from_bytes(rng.bytes(32), "little"), av.sort[2])
                for _ in range(int(rng.integers(0, 5)))
            }
            asg.arrays[av] = ce.ArrayValue(backing, default=int(rng.integers(0, 256)))
        out.append(asg)
    return out
