"""Lowering cases shared by the parity tests and ``chip_smoke.py``.

Each case function takes a term module (``mythril_tpu.smt.terms`` or the
port's copy, whose API is the same) and a width, and returns
``(conjuncts, bv_vars, array_vars)``; ``FAMILIES`` holds one per op family
of the lowering's node table, so that every record op runs at every width
of ``WIDTHS`` (the top limb at 1, 7, 8, 17, 255, 257 and 520 bits; limb
boundaries at 16, 160, 256, 264 and 512).  ``random_assignments`` draws
candidate values from a seeded numpy generator: zero and small values (so
division by zero), values around the width (shift amounts), small negatives
and full-width words; array tables with a chosen number of keys.
``load_recorded`` reads ``tests/testdata/torch_lowering_cases.npz`` and its
term dump: every lowering dispatch the JAX package makes on the probe
fixture (``tests/test_torch_lowering.py --write``).

This module imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

TESTDATA = Path(__file__).resolve().parent / "testdata"
FIXTURE = TESTDATA / "torch_lowering_cases.npz"
FIXTURE_TERMS = TESTDATA / "torch_lowering_cases.json"
WIDTHS = (1, 7, 8, 16, 17, 160, 255, 256, 257, 264, 512, 520)


def _xyz(T, tag, w):
    return T.var(f"lc_{tag}_{w}_x", w), T.var(f"lc_{tag}_{w}_y", w), T.var(f"lc_{tag}_{w}_z", w)


def fam_arith(T, w):
    """add, sub, mul, neg, not, and, or, xor, the compares."""
    x, y, z = _xyz(T, "arith", w)
    vals = [T.add(x, y), T.sub(x, y), T.mul(x, y), T.neg(x), T.bnot(y), T.band(x, z),
            T.bor(x, y), T.bxor(y, z), T.mul(T.add(x, z), T.sub(y, z))]
    conj = [T.eq(v, z) for v in vals] + [T.ult(v, z) for v in vals[:4]]
    conj += [T.ule(x, y), T.slt(x, z), T.sle(y, x)]
    return conj, [x, y, z], []


def fam_div(T, w):
    """udiv, urem, sdiv, srem (by zero among the values), exp."""
    x, y, z = _xyz(T, "div", w)
    e = T.var(f"lc_div_{w}_e", min(w, 9))  # exponents below 512: a bounded loop
    e = T.zext(e, w - e.width) if e.width < w else e
    vals = [T.udiv(x, y), T.urem(x, y), T.sdiv(x, y), T.srem(x, y), T.bvexp(x, e),
            T.udiv(z, T.add(y, x))]
    return [T.eq(v, z) for v in vals] + [T.ult(vals[2], vals[3])], [x, y, z], []


def fam_shift(T, w):
    """shl, lshr, ashr by a symbolic amount of the word's width."""
    x, s, z = _xyz(T, "shift", w)
    vals = [T.shl(x, s), T.lshr(x, s), T.ashr(x, s), T.ashr(T.bnot(x), s)]
    return [T.eq(v, z) for v in vals] + [T.slt(vals[2], z)], [x, s, z], []


def fam_slice(T, w):
    """concat, extract across limb boundaries, zext, sext from odd widths."""
    x, y, z = _xyz(T, "slice", w)
    b7 = T.var(f"lc_slice_{w}_b7", 7)
    conj = [T.eq(T.extract(w + 6, 7, T.concat2(x, b7)), x),
            T.eq(T.concat2(b7, x), T.concat2(T.extract(6, 0, T.concat2(y, b7)), z))]
    for lo in sorted({0, 1, 3, 15, 16, 17, w // 2, w - 1}):
        if lo < w:
            hi = min(w - 1, lo + 12 + (w - lo) // 3)
            part = T.extract(hi, lo, x)
            conj.append(T.eq(T.zext(part, w - part.width) if part.width < w else part, y))
            if part.width < w:
                conj.append(T.eq(T.sext(part, w - part.width), z))
    conj.append(T.eq(T.sext(b7, w), T.zext(b7, w)) if w > 0 else T.true())
    if w >= 8:
        parts = [T.extract(w - 1 - 8 * i, w - 8 - 8 * i, x) for i in range(w // 8)]
        chain = parts[0]
        for p in parts[1:]:
            chain = T.concat2(chain, p)  # byte-built, odd byte offsets
        conj.append(T.eq(T.zext(chain, w - chain.width) if chain.width < w else chain, y))
    return conj, [x, y, z, b7], []


def fam_bool(T, w):
    """and, or, not, xor, bool equality, bool / bv / array ite."""
    x, y, z = _xyz(T, "bool", w)
    p, q = T.bool_var(f"lc_bool_{w}_p"), T.bool_var(f"lc_bool_{w}_q")
    arr = T.array_var(f"lc_bool_{w}_a", w, w)
    other = T.store(arr, x, y)
    pick = T.ite(p, arr, other)
    conj = [T.land(p, T.lnot(q), T.ult(x, y)), T.lor(T.eq(x, y), p, q), T.lxor(p, q),
            T.iff(p, T.ult(x, y)), T.eq(T.ite(q, x, y), z), T.ite(p, q, T.ult(z, x)),
            T.eq(T.select(pick, z), y)]
    return conj, [x, y, z, p, q], [arr]


def fam_array(T, w):
    """select over store chains, an ite of arrays, a constant array, the base
    table."""
    x, y, z = _xyz(T, "array", w)
    arr = T.array_var(f"lc_array_{w}_a", w, w)
    s1 = T.store(arr, T.const(5 % (1 << w), w), y)
    s2 = T.store(s1, x, T.const(77 % (1 << w), w))
    const = T.const_array(w, w, T.const(9 % (1 << w), w))
    mixed = T.ite(T.ult(x, z), s2, T.store(const, z, x))
    conj = [T.eq(T.select(s2, T.const(5 % (1 << w), w)), y), T.eq(T.select(s2, x), z),
            T.eq(T.select(arr, z), y), T.eq(T.select(mixed, y), x),
            T.ult(T.select(arr, x), T.select(s1, y))]
    return conj, [x, y, z], [arr]


def fam_keccak(T, w):
    """keccak of a w-bit word padded to bytes, of a 512-bit byte-built
    preimage, of a preimage longer than one rate block (1096 bits), and of
    a digest (two levels)."""
    x, y, z = _xyz(T, "keccak", w)
    wb = -(-w // 8) * 8
    xb = T.zext(x, wb - w) if wb > w else x
    pre = T.concat(*[T.extract(7, 0, T.add(xb, T.const(i, wb))) if wb >= 8 else xb
                     for i in range(64)])
    long = T.concat(T.zext(xb, 1096 - wb) if wb < 1096 else xb, T.const(3, 8))
    k1 = T.keccak(xb)
    k2 = T.keccak(pre)
    k3 = T.keccak(long)
    k4 = T.keccak(T.concat2(k1, k2))
    conj = [T.ult(k1, k2), T.eq(T.extract(15, 0, k3), T.extract(15, 0, k4)),
            T.ult(T.extract(w - 1, 0, k4) if w <= 256 else T.zext(k4, w - 256), z)]
    return conj, [x, y, z], []


FAMILIES = {
    "arith": fam_arith, "div": fam_div, "shift": fam_shift, "slice": fam_slice,
    "bool": fam_bool, "array": fam_array, "keccak": fam_keccak,
}


def wide(T, steps: int = 950):
    """A program whose values outgrow a block's shared memory (about 61,000
    rows, the kernel's global-arena route): a chain of 512-bit additions and
    xors, then a product, a table lookup and a keccak of its end."""
    x, y, z = _xyz(T, "wide", 512)
    arr = T.array_var("lc_wide_a", 256, 256)
    v = x
    for _ in range(steps):
        v = T.bxor(T.add(v, y), x)
    m = T.mul(v, z)
    conj = [T.ult(m, z), T.eq(T.select(arr, T.extract(255, 0, v)), T.extract(511, 256, m)),
            T.ult(T.keccak(T.concat2(v, T.extract(255, 0, y))), T.extract(255, 0, z))]
    return conj, [x, y, z], [arr]


def long_keccak(T, width: int = 2200):
    """Keccak of a preimage of three rate blocks, and of a digest of it."""
    x, y, z = _xyz(T, "longk", width)
    k1 = T.keccak(T.bxor(x, y))
    k2 = T.keccak(T.concat2(k1, T.extract(width - 1, 8, x)))
    return [T.ult(k1, T.extract(255, 0, z)), T.ult(k2, k1)], [x, y, z], []


def build(T, family: str, width: int):
    return FAMILIES[family](T, width)


def random_assignments(T, ce, bv_vars, array_vars, seed: int, n: int, keys: int = 6):
    """``n`` candidate assignments (``ce``: a concrete_eval module); each
    array gets up to 4 backing keys of ``keys`` possible ones (1..keys), so
    a batch's table has about ``keys`` rows."""
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
            if choice < 0.25:
                val = int(rng.integers(0, 6))
            elif choice < 0.4:
                val = w + int(rng.integers(-3, 4))
            elif choice < 0.55:
                val = T.mask(-int(rng.integers(1, 6)), w)
            else:
                val = int.from_bytes(rng.bytes(80), "little")
            asg.scalars[v] = T.mask(val, w)
        for av in array_vars:
            backing = {
                T.mask(int(rng.integers(1, keys + 1)), av.sort[1]):
                    T.mask(int.from_bytes(rng.bytes(80), "little"), av.sort[2])
                for _ in range(int(rng.integers(0, 5)))
            }
            asg.arrays[av] = ce.ArrayValue(backing, default=T.mask(int(rng.integers(0, 256)), av.sort[2]))
        out.append(asg)
    return out


def node_differences(compiled, arena, values) -> list:
    """Term ids whose value in a kernel's arena (``run_kernel``'s ``[rows,
    B]``) differs from the plain version's (``run_lowering_reference``'s
    ``values``): every bv and bool node the node table holds a row for."""
    import torch

    B = arena.shape[1]
    bad = []
    for tid, ref in compiled.program.ref_of.items():
        v = values.get(tid)
        if ref < 0 or v is None or isinstance(v, tuple):
            continue  # a constant of the pool, an array
        v = v.to(arena.device).long()
        v = v[:, None] if v.dim() == 1 else v
        if not torch.equal(arena[ref: ref + v.shape[-1]].T.long(), v.expand(B, -1)):
            bad.append(tid)
    return bad


def kernel_and_plain(compiled, inputs, launch):
    """Run the node table through ``launch`` (``run_kernel``) and the plain
    version on the same packed ``inputs`` -> (kernel truth, plain truth, the
    term ids whose values differ)."""
    import torch

    from mythril_tpu_torch.ops import lowering

    values: dict = {}
    want = lowering.run_lowering_reference(compiled, *inputs, values=values)
    B = inputs[1].shape[0]
    arena = torch.zeros((compiled.program.rows, B), dtype=torch.int32, device=inputs[1].device)
    got = lowering.run_kernel(compiled, *inputs, launch=launch, arena=arena)
    return got, want, node_differences(compiled, arena, values)


def load_recorded():
    """(metadata, arrays, port conjunctions): every recorded dispatch's
    packed inputs and JAX truth, its conjuncts rebuilt as port terms."""
    from mythril_tpu_torch.smt.serialize import from_jax_dump

    meta = json.loads(FIXTURE_TERMS.read_text())
    roots = from_jax_dump(meta["terms"])
    arrays = np.load(FIXTURE)
    conjs = [[roots[i] for i in d["conj"]] for d in meta["dispatches"]]
    return meta, arrays, conjs


def recorded_inputs(arrays, n: int, d: dict, device="cpu"):
    """The packed inputs of recorded dispatch ``n`` as int32 tensors."""
    import torch

    put = lambda k: torch.from_numpy(arrays[f"{n}_{k}"].astype(np.int32)).to(device)  # noqa: E731
    scalars = tuple(put(f"s{i}") for i in range(d["n_bv"]))
    tabs = tuple(tuple(put(f"t{i}_{f}") for f in ("idx", "val", "valid", "default"))
                 for i in range(d["n_arr"]))
    return scalars, put("bools"), tabs
