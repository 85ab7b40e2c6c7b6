"""Batched wide-word bitvector algebra in plain PyTorch.

The port's counterpart of ``mythril_tpu/ops/bitvec.py``: every bitvector of
width ``w`` is ``ceil(w / 16)`` little-endian 16-bit limbs on the last axis,
shape ``[..., L]``, held in ``int64`` (this torch build has no arithmetic,
shift or compare on ``uint32``, and a limb product fits in 32 bits, so a
column of partial products never leaves ``int64``).

Semantics match the host big-int evaluator (``smt/concrete_eval.py``)
exactly: x/0 == 0, truncated signed division, modular exponentiation, and
shifts that saturate (to zero or the sign fill) at ``s >= width``.

This module is the plain reference of ``csrc/bitvec.cuh``: the tape VM's
plain version (``ops/tape_vm.run_tape_reference``) evaluates every
arithmetic step through it, on the CPU in the tests and on the card in
``chip_smoke.py``.
"""

from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np
import torch

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1


def nlimbs(width: int) -> int:
    return -(-width // LIMB_BITS)


def _top_mask(width: int) -> int:
    """Mask for the most-significant limb (partial when width % 16 != 0)."""
    r = width % LIMB_BITS
    return LIMB_MASK if r == 0 else (1 << r) - 1


def mask_top(a: torch.Tensor, width: int) -> torch.Tensor:
    """Re-canonicalise: clear bits above ``width`` in the top limb."""
    tm = _top_mask(width)
    if tm == LIMB_MASK:
        return a
    out = a.clone()
    out[..., -1] &= tm
    return out


# ---------------------------------------------------------------------------
# Host <-> tensor conversion
# ---------------------------------------------------------------------------


def from_ints_np(values: Union[int, Sequence[int]], width: int) -> np.ndarray:
    """Python int(s) -> uint32 limb array [L] or [B, L] (the JAX layout)."""
    scalar = isinstance(values, int)
    vals = [values] if scalar else list(values)
    L = nlimbs(width)
    mask_w = (1 << width) - 1
    buf = b"".join((v & mask_w).to_bytes(L * 2, "little") for v in vals)
    out = np.frombuffer(buf, dtype="<u2").reshape(len(vals), L).astype(np.uint32)
    return out[0] if scalar else out


def from_ints(
    values: Union[int, Sequence[int]], width: int, device="cpu"
) -> torch.Tensor:
    """Python int(s) -> int64 limb tensor [L] or [B, L] on ``device``."""
    arr = from_ints_np(values, width).astype(np.int64)
    return torch.from_numpy(arr).to(device)


def to_ints(arr, width: int) -> List[int]:
    """Limb tensor or array [..., L] -> list of Python ints (flattened batch)."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    a = np.asarray(arr).astype(np.int64).reshape(-1, nlimbs(width))
    return [
        sum(int(a[b, i]) << (LIMB_BITS * i) for i in range(a.shape[1]))
        for b in range(a.shape[0])
    ]


# ---------------------------------------------------------------------------
# Carry machinery
# ---------------------------------------------------------------------------


def _carry_propagate(cols: torch.Tensor, width: int) -> torch.Tensor:
    """Columns of non-negative partial sums -> canonical 16-bit limbs."""
    L = nlimbs(width)
    out = []
    carry = torch.zeros_like(cols[..., 0])
    for i in range(L):
        s = cols[..., i] + carry
        out.append(s & LIMB_MASK)
        carry = s >> LIMB_BITS
    return mask_top(torch.stack(out, dim=-1), width)


def _bcast(a: torch.Tensor, b: torch.Tensor):
    return torch.broadcast_tensors(a, b)


def _one_cols(like: torch.Tensor) -> torch.Tensor:
    one = torch.zeros_like(like)
    one[..., 0] = 1
    return one


def add(a: torch.Tensor, b: torch.Tensor, width: int) -> torch.Tensor:
    return _carry_propagate(a + b, width)


def not_(a: torch.Tensor, width: int) -> torch.Tensor:
    return mask_top(a ^ LIMB_MASK, width)


def neg(a: torch.Tensor, width: int) -> torch.Tensor:
    return _carry_propagate((a ^ LIMB_MASK) + _one_cols(a), width)


def sub(a: torch.Tensor, b: torch.Tensor, width: int) -> torch.Tensor:
    a, b = _bcast(a, b)
    return _carry_propagate(a + (b ^ LIMB_MASK) + _one_cols(a), width)


def and_(a, b, width):
    return a & b


def or_(a, b, width):
    return a | b


def xor(a, b, width):
    return a ^ b


_DIAG_CACHE = {}


def _diag_index(L: int, device) -> torch.Tensor:
    """Flattened [L*L] column index i+j of each limb product (L = dropped)."""
    key = (L, str(device))
    idx = _DIAG_CACHE.get(key)
    if idx is None:
        ij = np.add.outer(np.arange(L), np.arange(L)).reshape(-1)
        idx = torch.from_numpy(np.minimum(ij, L)).to(device)
        _DIAG_CACHE[key] = idx
    return idx


def mul(a: torch.Tensor, b: torch.Tensor, width: int) -> torch.Tensor:
    """Low ``width`` bits of the product (EVM MUL): schoolbook columns, each
    a sum of < 2^32 limb products, then one carry pass."""
    L = nlimbs(width)
    a, b = _bcast(a, b)
    prod = (a[..., :, None] * b[..., None, :]).reshape(*a.shape[:-1], L * L)
    cols = torch.zeros((*a.shape[:-1], L + 1), dtype=a.dtype, device=a.device)
    idx = _diag_index(L, a.device).expand(*a.shape[:-1], L * L)
    cols.scatter_add_(-1, idx, prod)
    return _carry_propagate(cols[..., :L], width)


# ---------------------------------------------------------------------------
# Comparisons -> bool mask over batch dims
# ---------------------------------------------------------------------------


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.all(a == b, dim=-1)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return torch.all(a == 0, dim=-1)


def ult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lexicographic compare: the most-significant differing limb decides."""
    a, b = _bcast(a, b)
    ne = a != b
    pos = torch.arange(1, a.shape[-1] + 1, device=a.device)
    top = (ne * pos).argmax(dim=-1, keepdim=True)
    return torch.take_along_dim(a < b, top, dim=-1)[..., 0] & ne.any(dim=-1)


def ule(a, b):
    return ~ult(b, a)


def _flip_sign(a: torch.Tensor, width: int) -> torch.Tensor:
    """XOR the sign bit so unsigned compare gives signed order."""
    out = a.clone()
    out[..., -1] ^= 1 << ((width - 1) % LIMB_BITS)
    return out


def slt(a, b, width):
    return ult(_flip_sign(a, width), _flip_sign(b, width))


def sle(a, b, width):
    return ~slt(b, a, width)


def sign_bit(a: torch.Tensor, width: int) -> torch.Tensor:
    return (a[..., -1] >> ((width - 1) % LIMB_BITS)) & 1


# ---------------------------------------------------------------------------
# Shifts (per-batch symbolic amounts)
# ---------------------------------------------------------------------------


def _shift_amount(s: torch.Tensor, width: int) -> torch.Tensor:
    """Limb tensor -> shift amount per batch element, saturated at ``width``
    (any bit at or above 2^32 means s >= width for every width)."""
    big = torch.zeros(s.shape[:-1], dtype=torch.bool, device=s.device)
    for i in range(2, s.shape[-1]):
        big = big | (s[..., i] != 0)
    lo = s[..., 0].clone()
    if s.shape[-1] > 1:
        lo = lo | (s[..., 1] << LIMB_BITS)
    return torch.where(big | (lo > width), torch.full_like(lo, width), lo)


def _take_limb(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a[..., idx] with out-of-range limbs read as 0."""
    L = a.shape[-1]
    valid = (idx >= 0) & (idx < L)
    got = torch.take_along_dim(a, idx.clamp(0, L - 1), dim=-1)
    return torch.where(valid, got, torch.zeros_like(got))


def shl(a: torch.Tensor, s: torch.Tensor, width: int) -> torch.Tensor:
    """a << s, saturating to 0 at s >= width.  s is a limb tensor."""
    L = a.shape[-1]
    amt = _shift_amount(s, width)[..., None]
    q, r = amt // LIMB_BITS, amt % LIMB_BITS
    idx = torch.arange(L, device=a.device) - q
    lo = _take_limb(a, idx)
    lo1 = _take_limb(a, idx - 1)
    out = ((lo << r) | (lo1 >> (LIMB_BITS - r))) & LIMB_MASK
    out = torch.where(amt >= width, torch.zeros_like(out), out)
    return mask_top(out, width)


def lshr(a: torch.Tensor, s: torch.Tensor, width: int) -> torch.Tensor:
    L = a.shape[-1]
    amt = _shift_amount(s, width)[..., None]
    q, r = amt // LIMB_BITS, amt % LIMB_BITS
    idx = torch.arange(L, device=a.device) + q
    lo = _take_limb(a, idx)
    hi = _take_limb(a, idx + 1)
    out = ((lo >> r) | (hi << (LIMB_BITS - r))) & LIMB_MASK
    return torch.where(amt >= width, torch.zeros_like(out), out)


def ashr(a: torch.Tensor, s: torch.Tensor, width: int) -> torch.Tensor:
    """Arithmetic shift right: lshr plus a sign fill of the vacated bits."""
    sign = sign_bit(a, width).bool()[..., None]
    amt = _shift_amount(s, width)
    base = lshr(a, s, width)
    ones = mask_top(torch.full_like(a, LIMB_MASK), width)
    # fill = ones << (width - s): s == 0 -> no fill; s >= width -> all ones
    inv = width - torch.clamp(amt, max=width)
    fill = shl(ones, _u32_to_limbs(inv, width), width)
    fill = torch.where((amt >= width)[..., None], ones, fill)
    return torch.where(sign, base | fill, base)


def _u32_to_limbs(v: torch.Tensor, width: int) -> torch.Tensor:
    """Scalar per batch element (value < 2^32) -> limb tensor [..., L]."""
    L = nlimbs(width)
    parts = [v & LIMB_MASK, (v >> LIMB_BITS) & LIMB_MASK]
    while len(parts) < L:
        parts.append(torch.zeros_like(v))
    return torch.stack(parts[:L], dim=-1)


# ---------------------------------------------------------------------------
# Division / remainder (bit-serial restoring; EVM x/0 == 0)
# ---------------------------------------------------------------------------


def _udivmod(a: torch.Tensor, b: torch.Tensor, width: int):
    """Shift-subtract over ``width`` bits, most significant first.  After i
    bits the remainder is below 2^i, so the shift never loses a bit."""
    a, b = _bcast(a, b)
    L = a.shape[-1]
    q = torch.zeros_like(a)
    rem = torch.zeros_like(a)
    for i in range(width):
        bit_pos = width - 1 - i
        limb_i, bit_i = bit_pos // LIMB_BITS, bit_pos % LIMB_BITS
        abit = (a[..., limb_i] >> bit_i) & 1
        rem2 = torch.empty_like(rem)
        rem2[..., 0] = ((rem[..., 0] << 1) & LIMB_MASK) | abit
        if L > 1:
            rem2[..., 1:] = ((rem[..., 1:] << 1) & LIMB_MASK) | (
                rem[..., :-1] >> (LIMB_BITS - 1)
            )
        ge = ule(b, rem2)
        rem = torch.where(ge[..., None], sub(rem2, b, width), rem2)
        q[..., limb_i] |= ge.to(q.dtype) << bit_i
    bz = is_zero(b)[..., None]
    zero = torch.zeros_like(q)
    return torch.where(bz, zero, q), torch.where(bz, zero, rem)


def udiv(a, b, width):
    return _udivmod(a, b, width)[0]


def urem(a, b, width):
    return _udivmod(a, b, width)[1]


def _abs(a, width):
    s = sign_bit(a, width).bool()
    return torch.where(s[..., None], neg(a, width), a), s


def sdiv(a, b, width):
    """EVM-style truncated signed division; x / 0 == 0."""
    aa, sa = _abs(a, width)
    ab, sb = _abs(b, width)
    q = udiv(aa, ab, width)
    return torch.where((sa ^ sb)[..., None], neg(q, width), q)


def srem(a, b, width):
    """Truncated signed remainder (sign follows the dividend); x % 0 == 0."""
    aa, sa = _abs(a, width)
    ab, _ = _abs(b, width)
    r = urem(aa, ab, width)
    return torch.where(sa[..., None], neg(r, width), r)


# ---------------------------------------------------------------------------
# Modular exponentiation (EVM EXP)
# ---------------------------------------------------------------------------


def bvexp(a: torch.Tensor, e: torch.Tensor, width: int) -> torch.Tensor:
    """a ** e mod 2^width via square-and-multiply over e's bits."""
    a, e = _bcast(a, e)
    result = _one_cols(a)
    base = a
    for i in range(e.shape[-1] * LIMB_BITS):
        ebit = ((e[..., i // LIMB_BITS] >> (i % LIMB_BITS)) & 1).bool()
        result = torch.where(ebit[..., None], mul(result, base, width), result)
        base = mul(base, base, width)
    return result


# ---------------------------------------------------------------------------
# Width changes (static offsets — from concat/extract/zext/sext terms)
# ---------------------------------------------------------------------------


def resize(a: torch.Tensor, from_w: int, to_w: int) -> torch.Tensor:
    """Zero-extend or truncate to a new width."""
    Lf, Lt = nlimbs(from_w), nlimbs(to_w)
    if Lt <= Lf:
        return mask_top(a[..., :Lt], to_w)
    pad = torch.zeros((*a.shape[:-1], Lt - Lf), dtype=a.dtype, device=a.device)
    return torch.cat([mask_top(a, from_w), pad], dim=-1)


def _limb_pad(a: torch.Tensor, n: int) -> torch.Tensor:
    return torch.zeros((*a.shape[:-1], n), dtype=a.dtype, device=a.device)


def _shl_static(a: torch.Tensor, n: int, width: int) -> torch.Tensor:
    """``shl`` by a host-known amount: limb slices instead of gathers."""
    L = a.shape[-1]
    if n >= width:
        return torch.zeros_like(a)
    q, r = divmod(n, LIMB_BITS)
    x = torch.cat([_limb_pad(a, q), a[..., : L - q]], dim=-1)
    if r:
        prev = torch.cat([_limb_pad(a, 1), x[..., :-1]], dim=-1)
        x = ((x << r) | (prev >> (LIMB_BITS - r))) & LIMB_MASK
    return mask_top(x, width)


def _lshr_static(a: torch.Tensor, n: int, width: int) -> torch.Tensor:
    """``lshr`` by a host-known amount: limb slices instead of gathers."""
    if n >= width:
        return torch.zeros_like(a)
    q, r = divmod(n, LIMB_BITS)
    x = torch.cat([a[..., q:], _limb_pad(a, q)], dim=-1)
    if r:
        nxt = torch.cat([x[..., 1:], _limb_pad(a, 1)], dim=-1)
        x = ((x >> r) | (nxt << (LIMB_BITS - r))) & LIMB_MASK
    return x


def sext_to(a: torch.Tensor, from_w: int, to_w: int) -> torch.Tensor:
    s = sign_bit(a, from_w).bool()[..., None]
    low = resize(a, from_w, to_w)
    ones = mask_top(torch.full_like(low, LIMB_MASK), to_w)
    high = _shl_static(ones, from_w, to_w)
    return torch.where(s, low | high, low)


def extract_bits(a: torch.Tensor, hi: int, lo: int, from_w: int) -> torch.Tensor:
    """Static [hi:lo] slice (inclusive), result width hi-lo+1."""
    out_w = hi - lo + 1
    if lo % LIMB_BITS == 0:
        return mask_top(resize(a[..., lo // LIMB_BITS:], from_w - lo, out_w), out_w)
    return resize(_lshr_static(a, lo, from_w), from_w, out_w)


def concat_bits(hi: torch.Tensor, lo: torch.Tensor, hi_w: int, lo_w: int) -> torch.Tensor:
    """hi ++ lo, result width hi_w + lo_w."""
    out_w = hi_w + lo_w
    lo_r = resize(lo, lo_w, out_w)
    hi_r = resize(hi, hi_w, out_w)
    return lo_r | _shl_static(hi_r, lo_w, out_w)


def mux(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-batch select: cond is a bool mask over batch dims."""
    return torch.where(cond[..., None], a, b)
