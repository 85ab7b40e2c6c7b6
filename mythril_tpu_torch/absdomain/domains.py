"""Transfer functions over the prefilter's two sound abstract domains.

The port's counterpart of ``mythril_tpu/absdomain/domains.py``.

Unsigned intervals
    ``[lo, hi]`` per (node, row) in float64 with directed rounding: every
    arithmetic result is widened one ulp outward (``np.nextafter``), and
    integer constants float64 cannot represent are rounded outward at pack
    time.  The invariant is only ever ``lo <= v <= hi``.  This pass needs
    float64 and stays host numpy (``eval_iv_host``), as in the JAX package.

Known bits
    ``(km, kv)`` per (node, row): 16 limbs of 32 bits each; bit ``j`` of the
    value is known iff bit ``j`` of ``km`` is set, and then equals bit ``j``
    of ``kv``.  Invariants: ``kv & ~km == 0`` and bits at or above the
    node's width are known zero.  ``eval_kb_plain`` is the plain PyTorch
    version of the CUDA kernel (``csrc/known_bits.cu``): a loop over nodes,
    vectorised over rows, bit for bit the JAX package's host twin
    ``eval_kb_host``.  This build of torch has no uint32 arithmetic, so the
    limbs are held as int64 and every result is masked to 32 bits; inputs
    and outputs are int32 tensors of the uint32 bit patterns, the kernel's
    layout.

A transformer may always return a coarser element (top); it must never
exclude a value some concrete model can take.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from mythril_tpu_torch.absdomain.tape import LIMBS, PackedBatch
from mythril_tpu_torch.native.bitblast import (
    OP_CONST, OP_VAR, OP_EQ, OP_AND, OP_OR, OP_NOT, OP_XOR, OP_ITE,
    OP_ADD, OP_SUB, OP_MUL, OP_UDIV, OP_UREM, OP_SDIV, OP_SREM,
    OP_BAND, OP_BOR, OP_BXOR, OP_BNOT, OP_NEG, OP_SHL, OP_LSHR, OP_ASHR,
    OP_CONCAT, OP_EXTRACT, OP_ZEXT, OP_SEXT, OP_ULT, OP_ULE, OP_SLT, OP_SLE,
)

_ALL = 0xFFFFFFFF
_INF = np.inf
NODE_W = 8  # int32 fields of a node record: op, w, a0, a1, a2, x0, x1, override slot


# ---------------------------------------------------------------------------
# Known bits: the plain PyTorch version of the kernel
# ---------------------------------------------------------------------------


class _Node:
    """One node's scalars (host ints) and its width mask and constant
    ([16] int64 limbs) on the evaluation's device."""

    __slots__ = ("w", "x1", "wa", "wb", "wm", "cl")

    def __init__(self, w, x1, wa, wb, wm, cl):
        self.w, self.x1, self.wa, self.wb, self.wm, self.cl = w, x1, wa, wb, wm, cl


def _inv(x):
    """The 32-bit complement of limbs held in int64."""
    return x ^ _ALL


def _fully_known(km):
    return (km == _ALL).all(dim=-1)


def _limb_range(like):
    return torch.arange(LIMBS, dtype=torch.int64, device=like.device)


def _bool_out(p, like, decided, value):
    """A bool node: bit 0 known iff ``decided``, then equal to ``value``."""
    z = torch.zeros_like(like)
    km = (z + _inv(p.wm)) | torch.where(decided[:, None], z + p.wm, z)
    kv = torch.where((decided & value)[:, None], z + p.wm, z)
    return km, kv


def _kb_top(p, A, B, C):
    z = torch.zeros_like(A[0])
    return z + _inv(p.wm), z


def _kb_const(p, A, B, C):
    z = torch.zeros_like(A[0])
    return z + _ALL, z + p.cl


def _kb_band(p, A, B, C):
    (ka, va), (kb, vb) = A, B
    km = (ka & kb) | (ka & _inv(va)) | (kb & _inv(vb))
    return km, va & vb & km


def _kb_bor(p, A, B, C):
    (ka, va), (kb, vb) = A, B
    km = (ka & kb) | (ka & va) | (kb & vb)
    return km, (va | vb) & km


def _kb_bxor(p, A, B, C):
    (ka, va), (kb, vb) = A, B
    km = ka & kb
    return km, (va ^ vb) & km


def _kb_bnot(p, A, B, C):
    ka, va = A
    return ka, _inv(va) & ka & p.wm


def _ripple_add(va, vb, carry_in: int):
    """512-bit add over the limb axis: a 33-bit sum per limb in int64."""
    carry = torch.full_like(va[..., 0], carry_in)
    out = []
    for i in range(LIMBS):
        s = va[..., i] + vb[..., i] + carry
        out.append(s & _ALL)
        carry = s >> 32
    return torch.stack(out, dim=-1)


def _kb_fullknown(p, A, B, value):
    """Known exactly where both operands are fully pinned, else top."""
    fully = (_fully_known(A[0]) & _fully_known(B[0]))[:, None]
    z = torch.zeros_like(A[0])
    km = torch.where(fully, z + _ALL, z + _inv(p.wm))
    kv = torch.where(fully, value & p.wm, z)
    return km, kv & km


def _bitlen32(v):
    """Per-limb bit length (0..32) via smear + SWAR popcount, wrapping at
    32 bits as the uint32 original does."""
    v = v | (v >> 1)
    v = v | (v >> 2)
    v = v | (v >> 4)
    v = v | (v >> 8)
    v = v | (v >> 16)
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & _ALL) >> 24


def _pbits(km, kv):
    """[rows] exact max bit length of the value: ``v <= 2**_pbits - 1``."""
    x = _inv(km & _inv(kv))  # possibly-one bits
    per = torch.where(x != 0, _bitlen32(x) + _limb_range(x) * 32, torch.zeros_like(x))
    return per.max(dim=-1).values


def _mask_below(n, like):
    """Mask of the bits strictly below ``n`` (an int or one per row),
    broadcast against ``like``."""
    base = _limb_range(like) * 32
    n = torch.as_tensor(n, dtype=torch.int64, device=like.device)
    k = (n[..., None] - base).clamp(0, 32)
    partial = (1 << (k & 31)) - 1
    return torch.zeros_like(like) + torch.where(k >= 32, torch.full_like(k, _ALL), partial)


def _mask_ge(n, like):
    return _inv(_mask_below(n, like))


def _kb_add(p, A, B, C):
    km, kv = _kb_fullknown(p, A, B, _ripple_add(A[1], B[1], 0))
    # leading zeros: a + b < 2^(max(pa, pb) + 1)
    thr = torch.maximum(_pbits(*A), _pbits(*B)) + 1
    return km | _mask_ge(thr, A[0]), kv


def _kb_sub(p, A, B, C):
    return _kb_fullknown(p, A, B, _ripple_add(A[1], _inv(B[1]), 1))


def _kb_mul(p, A, B, C):
    """With a <= 2^pa - 1 and b <= 2^pb - 1, ab == 0 when either is 0,
    ab <= 2^pb - 1 when pa <= 1 (and symmetrically), ab < 2^(pa+pb)."""
    pa, pb = _pbits(*A), _pbits(*B)
    thr = torch.where((pa == 0) | (pb == 0), torch.zeros_like(pa),
                      torch.where(pa <= 1, pb, torch.where(pb <= 1, pa, pa + pb)))
    z = torch.zeros_like(A[0])
    return (z + _inv(p.wm)) | _mask_ge(thr, A[0]), z


def _kb_div_rem(p, A, B, C):
    """udiv/urem never exceed the dividend: its leading zeros carry."""
    z = torch.zeros_like(A[0])
    return (z + _inv(p.wm)) | _mask_ge(_pbits(*A), A[0]), z


def _kb_neg(p, A, B, C):
    fully = _fully_known(A[0])[:, None]
    val = _ripple_add(_inv(A[1]), torch.zeros_like(A[1]), 1)
    z = torch.zeros_like(A[0])
    km = torch.where(fully, z + _ALL, z + _inv(p.wm))
    kv = torch.where(fully, val & p.wm, z)
    return km, kv & km


def _limb_ult(va, vb):
    """Exact (a < b, a == b) from fully known limbs, high to low."""
    lt = torch.zeros(va.shape[:-1], dtype=torch.bool, device=va.device)
    eq = torch.ones(va.shape[:-1], dtype=torch.bool, device=va.device)
    for i in reversed(range(LIMBS)):
        lt = lt | (eq & (va[..., i] < vb[..., i]))
        eq = eq & (va[..., i] == vb[..., i])
    return lt, eq


def _kb_eq(p, A, B, C):
    (ka, va), (kb, vb) = A, B
    conflict = ((ka & kb & (va ^ vb)) != 0).any(dim=-1)
    must_true = _fully_known(ka) & _fully_known(kb) & ~conflict
    return _bool_out(p, ka, conflict | must_true, must_true)


def _kb_ult(p, A, B, C):
    both = _fully_known(A[0]) & _fully_known(B[0])
    lt, _eq = _limb_ult(A[1], B[1])
    return _bool_out(p, A[0], both, lt)


def _kb_ule(p, A, B, C):
    both = _fully_known(A[0]) & _fully_known(B[0])
    lt, eq = _limb_ult(A[1], B[1])
    return _bool_out(p, A[0], both, lt | eq)


def _kb_ite(p, A, B, C):
    ck = (A[0][..., 0] & 1) != 0
    cv = (A[1][..., 0] & 1) != 0
    kmj = B[0] & C[0] & _inv(B[1] ^ C[1])
    kvj = B[1] & kmj
    then, els = (ck & cv)[:, None], (ck & ~cv)[:, None]
    km = torch.where(then, B[0], torch.where(els, C[0], kmj))
    kv = torch.where(then, B[1], torch.where(els, C[1], kvj))
    return km, kv


def _shift_amount(B):
    """(fully known?, clamped shift): any amount >= 1024 acts as 1023."""
    known = _fully_known(B[0])
    high = (B[1][..., 1:] != 0).any(dim=-1)
    s = torch.where(high, torch.full_like(B[1][..., 0], 1023), B[1][..., 0])
    return known, s.clamp(max=1023)


def _shift_gather(v, idx):
    """v's limb at each idx, zero where idx is off the 16 limbs."""
    inside = (idx >= 0) & (idx < LIMBS)
    got = torch.gather(v, -1, idx.clamp(0, LIMBS - 1))
    return torch.where(inside, got, torch.zeros_like(got))


def _limb_lshr(v, s):
    ls, bs = s >> 5, (s & 31)[:, None]
    idx = _limb_range(v)[None, :] + ls[:, None]
    v0, v1 = _shift_gather(v, idx), _shift_gather(v, idx + 1)
    back = (32 - bs) & 31
    return (v0 >> bs) | torch.where(bs > 0, (v1 << back) & _ALL, torch.zeros_like(v1))


def _limb_shl(v, s):
    ls, bs = s >> 5, (s & 31)[:, None]
    idx = _limb_range(v)[None, :] - ls[:, None]
    v0, v1 = _shift_gather(v, idx), _shift_gather(v, idx - 1)
    back = (32 - bs) & 31
    return ((v0 << bs) & _ALL) | torch.where(bs > 0, v1 >> back, torch.zeros_like(v1))


def _kb_shl(p, A, B, C):
    known, s = _shift_amount(B)
    zero = known & (s >= p.w)
    km_s = _inv(_limb_shl(_inv(A[0]), s)) | _inv(p.wm)
    kv_s = _limb_shl(A[1], s) & p.wm & km_s
    z = torch.zeros_like(A[0])
    km = torch.where(zero[:, None], z + _ALL, torch.where(known[:, None], km_s, z + _inv(p.wm)))
    kv = torch.where(zero[:, None], z, torch.where(known[:, None], kv_s, z))
    return km, kv


def _lshr_pair(p, A, known, s):
    zero = known & (s >= p.w)
    km_s = _inv(_limb_lshr(_inv(A[0]), s)) | _inv(p.wm)
    kv_s = _limb_lshr(A[1], s) & p.wm & km_s
    z = torch.zeros_like(A[0])
    km = torch.where(zero[:, None], z + _ALL, torch.where(known[:, None], km_s, z + _inv(p.wm)))
    kv = torch.where(zero[:, None], z, torch.where(known[:, None], kv_s, z))
    return km, kv


def _kb_lshr(p, A, B, C):
    known, s = _shift_amount(B)
    return _lshr_pair(p, A, known, s)


def _bit_at(arr, pos: int):
    """Bit ``pos`` of each row (numpy's take: a limb index of -16..-1 counts
    from the top)."""
    li = pos >> 5
    return ((arr[..., li + LIMBS if li < 0 else li] >> (pos & 31)) & 1) != 0


def _kb_ashr(p, A, B, C):
    # sound only when the sign bit is provably 0 (then ashr == lshr)
    ok = (_bit_at(A[0], p.w - 1) & ~_bit_at(A[1], p.w - 1))[:, None]
    known, s = _shift_amount(B)
    km_s, kv_s = _lshr_pair(p, A, known, s)
    z = torch.zeros_like(A[0])
    return torch.where(ok, km_s, z + _inv(p.wm)), torch.where(ok, kv_s, z)


def _kb_concat(p, A, B, C):
    low = _mask_below(p.wb, A[0])
    s = torch.full_like(A[0][..., 0], p.wb)
    km = (_inv(_limb_shl(_inv(A[0]), s)) & _inv(low)) | (B[0] & low) | _inv(p.wm)
    kv = ((_limb_shl(A[1], s) & _inv(low)) | (B[1] & low)) & p.wm & km
    return km, kv


def _kb_extract(p, A, B, C):
    s = torch.full_like(A[0][..., 0], p.x1 & _ALL)
    km = _inv(_limb_lshr(_inv(A[0]), s)) | _inv(p.wm)
    kv = _limb_lshr(A[1], s) & p.wm & km
    return km, kv


def _kb_zext(p, A, B, C):
    return A  # bits above the old width are already known zero


def _kb_sext(p, A, B, C):
    below = _mask_below(p.wa, A[0])
    sk = _bit_at(A[0], p.wa - 1)[:, None]
    sv = _bit_at(A[1], p.wa - 1)[:, None]
    ext = p.wm & _inv(below)
    z = torch.zeros_like(A[0])
    km = (A[0] & below) | _inv(p.wm) | torch.where(sk, ext, z)
    kv = ((A[1] & below) | torch.where(sk & sv, ext, z)) & km
    return km, kv


KB_KERNELS = {
    OP_CONST: _kb_const,
    OP_VAR: _kb_top,
    OP_EQ: _kb_eq,
    OP_AND: _kb_band,
    OP_OR: _kb_bor,
    OP_NOT: _kb_bnot,
    OP_XOR: _kb_bxor,
    OP_ITE: _kb_ite,
    OP_ADD: _kb_add,
    OP_SUB: _kb_sub,
    OP_MUL: _kb_mul,
    OP_UDIV: _kb_div_rem,
    OP_UREM: _kb_div_rem,
    OP_SDIV: _kb_top,
    OP_SREM: _kb_top,
    OP_BAND: _kb_band,
    OP_BOR: _kb_bor,
    OP_BXOR: _kb_bxor,
    OP_BNOT: _kb_bnot,
    OP_NEG: _kb_neg,
    OP_SHL: _kb_shl,
    OP_LSHR: _kb_lshr,
    OP_ASHR: _kb_ashr,
    OP_CONCAT: _kb_concat,
    OP_EXTRACT: _kb_extract,
    OP_ZEXT: _kb_zext,
    OP_SEXT: _kb_sext,
    OP_ULT: _kb_ult,
    OP_ULE: _kb_ule,
    OP_SLT: _kb_top,
    OP_SLE: _kb_top,
}


def _bits32(a: np.ndarray) -> np.ndarray:
    """uint32 limbs as int32 bit patterns."""
    return np.ascontiguousarray(a, dtype=np.uint32).view(np.int32)


def kb_inputs(pack: PackedBatch, device) -> Tuple[torch.Tensor, ...]:
    """The known-bits pass's inputs as the kernel takes them, on ``device``:
    nodes [N, 8] int32 (op, w, a0, a1, a2, x0, x1, override slot or -1), wm
    and cl [N, 16], okm and okv [n_ov, R, 16] (int32 bit patterns), the
    overrides in node order."""
    n, r = pack.n_nodes, pack.n_rows
    ov_nodes = sorted(pack.overrides)
    nodes = np.full((n, NODE_W), -1, np.int32)
    for j, field in enumerate((pack.op, pack.w, pack.a0, pack.a1, pack.a2, pack.x0, pack.x1)):
        nodes[:, j] = field
    nodes[ov_nodes, 7] = np.arange(len(ov_nodes), dtype=np.int32)
    okm = np.zeros((len(ov_nodes), r, LIMBS), np.uint32)
    okv = np.zeros((len(ov_nodes), r, LIMBS), np.uint32)
    for j, node in enumerate(ov_nodes):
        okm[j], okv[j] = pack.overrides[node][2], pack.overrides[node][3]
    return tuple(torch.from_numpy(a).to(device) for a in (
        nodes, _bits32(pack.wm), _bits32(pack.c_limbs), _bits32(okm), _bits32(okv)))


def _u32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int64) & _ALL


def _as_int32(t: torch.Tensor) -> torch.Tensor:
    return torch.where(t >= 1 << 31, t - (1 << 32), t).to(torch.int32)


def eval_kb_plain(nodes, wm, cl, okm, okv, n_rows: int):
    """The plain version of the known-bits kernel on ``kb_inputs``' tensors,
    on their device -> (km, kv [N, R, 16] int32 bit patterns, refuted [R]
    bool).  A loop over nodes, vectorised over rows; a missing child reads
    zeros, as the JAX package's host twin does."""
    dev = nodes.device
    n, r = nodes.shape[0], n_rows
    recs = nodes.cpu().tolist()
    wm64, cl64, okm64, okv64 = _u32(wm), _u32(cl), _u32(okm), _u32(okv)
    km = torch.zeros((n, r, LIMBS), dtype=torch.int64, device=dev)
    kv = torch.zeros_like(km)
    refuted = torch.zeros(r, dtype=torch.bool, device=dev)
    zero = torch.zeros((r, LIMBS), dtype=torch.int64, device=dev)

    def child(j):
        return (km[j], kv[j]) if j >= 0 else (zero, zero)

    for i, (op, w, a0, a1, a2, _x0, x1, ov) in enumerate(recs):
        p = _Node(w, x1, recs[a0][1] if a0 >= 0 else 0, recs[a1][1] if a1 >= 0 else 0,
                  wm64[i], cl64[i])
        k, v = KB_KERNELS.get(op, _kb_top)(p, child(a0), child(a1), child(a2))
        if ov >= 0:
            om, ovv = okm64[ov], okv64[ov]
            refuted |= ((k & om & (v ^ ovv)) != 0).any(dim=-1)
            k = k | om
            v = (v | ovv) & k
        km[i], kv[i] = k, v
    return _as_int32(km), _as_int32(kv), refuted


def eval_kb_torch(pack: PackedBatch, device):
    """The plain known-bits pass of ``pack`` on ``device`` -> (km, kv [N, R,
    16] int32 bit patterns, refuted [R] bool); bit for bit the JAX package's
    ``domains.eval_kb_host``."""
    return eval_kb_plain(*kb_inputs(pack, device), pack.n_rows)


# Interval pass (host-only: needs float64)
# ---------------------------------------------------------------------------


def _up(x):
    return np.nextafter(x, _INF)


def _dn(x):
    return np.nextafter(x, -_INF)


_WB_CACHE: Dict[int, Tuple[float, float, float, float]] = {}


def _wbounds(w: int) -> Tuple[float, float, float, float]:
    """(under(2^w-1), over(2^w-1), 2^w exact, 2^(w-1) exact) for width w."""
    got = _WB_CACHE.get(w)
    if got is None:
        full = (1 << w) - 1
        f = float(full)
        fu = f if int(f) <= full else float(np.nextafter(f, -_INF))
        fo = f if int(f) >= full else float(np.nextafter(f, _INF))
        got = (fu, fo, float(1 << w), float(1 << (w - 1)) if w else 0.5)
        _WB_CACHE[w] = got
    return got


def eval_iv_host(pack: PackedBatch) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Numpy interval pass: one loop over nodes, vectorized over rows."""
    n, r = pack.n_nodes, pack.n_rows
    lo = np.zeros((n, r), np.float64)
    hi = np.zeros((n, r), np.float64)
    refuted = np.zeros(r, bool)
    W = np.where

    # top*top at 512 bits overflows float64 to inf; the wrap guards
    # (`ph <= fu`) treat that as "widen to full range", which is sound —
    # silence the transient overflow/invalid warnings
    with np.errstate(all="ignore"):
        return _eval_iv_loop(pack, lo, hi, refuted, W)


def _eval_iv_loop(pack, lo, hi, refuted, W):
    n, r = pack.n_nodes, pack.n_rows
    for i in range(n):
        op = int(pack.op[i])
        w = int(pack.w[i])
        a0, a1, a2 = int(pack.a0[i]), int(pack.a1[i]), int(pack.a2[i])
        fu, fo, p2, half = _wbounds(w)
        if op == OP_CONST:
            l_, h_ = np.full(r, pack.c_lo[i]), np.full(r, pack.c_hi[i])
        elif op == OP_VAR:
            l_, h_ = np.zeros(r), np.full(r, fo)
        else:
            la, ha = lo[a0], hi[a0]
            lb = lo[a1] if a1 >= 0 else None
            hb = hi[a1] if a1 >= 0 else None
            if op == OP_EQ:
                mf = (ha < lb) | (hb < la)
                mt = (la == ha) & (lb == hb) & (la == lb)
                l_, h_ = W(mt, 1.0, 0.0), W(mf, 0.0, 1.0)
            elif op == OP_AND:
                l_, h_ = np.minimum(la, lb), np.minimum(ha, hb)
            elif op == OP_OR:
                l_, h_ = np.maximum(la, lb), np.maximum(ha, hb)
            elif op == OP_NOT:
                l_, h_ = 1.0 - ha, 1.0 - la
            elif op == OP_XOR:
                pinned = (la == ha) & (lb == hb)
                v = ((la >= 0.5) != (lb >= 0.5)).astype(np.float64)
                l_, h_ = W(pinned, v, 0.0), W(pinned, v, 1.0)
            elif op == OP_ITE:
                lt, ht = lo[a1], hi[a1]
                le, he = lo[a2], hi[a2]
                ct, cf = la >= 1.0, ha <= 0.0
                l_ = W(ct, lt, W(cf, le, np.minimum(lt, le)))
                h_ = W(ct, ht, W(cf, he, np.maximum(ht, he)))
            elif op == OP_ADD:
                sh = _up(ha + hb)
                nw = sh <= fu
                l_, h_ = W(nw, _dn(la + lb), 0.0), W(nw, sh, fo)
            elif op == OP_SUB:
                nw = la >= hb
                l_, h_ = W(nw, _dn(la - hb), 0.0), W(nw, _up(ha - lb), fo)
            elif op == OP_MUL:
                ph = _up(ha * hb)
                nw = ph <= fu
                l_, h_ = W(nw, _dn(la * lb), 0.0), W(nw, ph, fo)
            elif op == OP_UDIV:
                l_ = np.zeros(r)
                h_ = W(lb >= 1.0, _up(ha / np.maximum(lb, 1.0)), ha)
            elif op == OP_UREM:
                l_ = np.zeros(r)
                h_ = W(lb >= 1.0, np.minimum(ha, hb), ha)
            elif op == OP_BAND:
                l_, h_ = np.zeros(r), np.minimum(ha, hb)
            elif op == OP_BOR:
                l_ = np.maximum(la, lb)
                h_ = np.minimum(fo, _up(ha + hb))
            elif op == OP_BXOR:
                l_, h_ = np.zeros(r), np.minimum(fo, _up(ha + hb))
            elif op == OP_BNOT:
                l_, h_ = _dn(fu - ha), _up(fo - la)
            elif op == OP_NEG:
                l_ = W(la >= 1.0, _dn(p2 - ha), 0.0)
                h_ = np.minimum(fo, W(ha <= 0.0, 0.0, _up(p2 - la)))
            elif op in (OP_SHL, OP_LSHR, OP_ASHR):
                sk = lb == hb  # shift amount pinned to one (exact) float
                k = np.minimum(lb, 1100.0)
                pw = np.power(2.0, k)
                big = lb >= float(w)
                if op == OP_SHL:
                    ph = _up(ha * pw)
                    nw = ph <= fu
                    l_ = W(sk, W(big, 0.0, W(nw, _dn(la * pw), 0.0)), 0.0)
                    h_ = W(sk, W(big, 0.0, W(nw, ph, fo)), fo)
                else:
                    shr_l = np.maximum(0.0, _dn(la / pw) - 1.0)
                    shr_h = np.minimum(_up(ha / pw), ha)
                    ok = sk & ((op == OP_LSHR) | (ha < half))
                    l_ = W(ok, W(big, 0.0, shr_l), 0.0)
                    h_ = W(ok, W(big, 0.0, shr_h), fo)
            elif op == OP_CONCAT:
                pwl = float(1 << int(pack.w[a1]))
                l_ = _dn(la * pwl + lb)
                h_ = _up(ha * pwl + hb)
            elif op == OP_EXTRACT:
                hi_bit, lo_bit = int(pack.x0[i]), int(pack.x1[i])
                in_range = ha < float(1 << (hi_bit + 1))
                if lo_bit == 0:
                    l_, h_ = W(in_range, la, 0.0), W(in_range, ha, fo)
                else:
                    plo = float(1 << lo_bit)
                    l_ = W(in_range, np.maximum(0.0, _dn(la / plo) - 1.0), 0.0)
                    h_ = W(in_range, _up(ha / plo), fo)
            elif op == OP_ZEXT:
                l_, h_ = la, ha
            elif op == OP_SEXT:
                in_half = _wbounds(int(pack.w[a0]))[3]
                pos = ha < in_half
                l_, h_ = W(pos, la, 0.0), W(pos, ha, fo)
            elif op == OP_ULT:
                l_, h_ = W(ha < lb, 1.0, 0.0), W(la >= hb, 0.0, 1.0)
            elif op == OP_ULE:
                l_, h_ = W(ha <= lb, 1.0, 0.0), W(la > hb, 0.0, 1.0)
            else:  # SDIV/SREM/SLT/SLE and anything unmodeled: top
                l_, h_ = np.zeros(r), np.full(r, fo)

        l_ = np.maximum(l_, 0.0)
        h_ = np.minimum(h_, fo)
        ov = pack.overrides.get(i)
        if ov is not None:
            olo, ohi, _okm, _okv = ov
            l_ = np.maximum(l_, olo)
            h_ = np.minimum(h_, ohi)
            refuted |= l_ > h_
            h_ = np.maximum(h_, l_)
        lo[i], hi[i] = l_, h_
    return lo, hi, refuted


# ---------------------------------------------------------------------------
# Verdicts
# ---------------------------------------------------------------------------

_WEIGHTS = 2.0 ** (32.0 * np.arange(LIMBS, dtype=np.float64))


def verdicts(pack: PackedBatch, lo: np.ndarray, hi: np.ndarray,
             km: np.ndarray, kv: np.ndarray,
             refuted: np.ndarray) -> np.ndarray:
    """Combine both domains into one UNSAT-proof bit per row.

    A row is refuted when (a) its harvested narrowings were contradictory,
    (b) any node's interval/known-bits elements have empty intersection, or
    (c) any of its asserted roots is must-false in either domain.
    """
    # cross-domain consistency: the kb element bounds the value from below
    # (unknown bits zero) and above (unknown bits one); 16 float adds cost
    # at most 16 ulps, widened outward before comparing
    lo_kb = (kv.astype(np.float64) * _WEIGHTS).sum(axis=-1)
    hi_bits = kv | (~km & pack.wm[:, None, :])
    hi_kb = (hi_bits.astype(np.float64) * _WEIGHTS).sum(axis=-1)
    lo_kb = lo_kb - 16.0 * np.spacing(lo_kb)
    hi_kb = hi_kb + 16.0 * np.spacing(hi_kb)
    cross = (lo_kb > hi) | (hi_kb < lo)
    out = refuted | cross.any(axis=0) | pack.row_refuted

    # exact re-check of every harvested demand: float64 cannot separate
    # 2^w - 1 from 2^w, but the known-bits element and the harvested range
    # are both exact integers, so compare them as such
    for node, entries in pack.ov_exact.items():
        wm_int = 0
        for li in range(LIMBS):
            wm_int |= int(pack.wm[node, li]) << (32 * li)
        for row, lo_i, hi_i in entries:
            if out[row]:
                continue
            kv_i = 0
            km_i = 0
            for li in range(LIMBS):
                kv_i |= int(kv[node, row, li]) << (32 * li)
                km_i |= int(km[node, row, li]) << (32 * li)
            hi_kb_i = kv_i | (~km_i & wm_int)
            if hi_kb_i < lo_i or kv_i > hi_i:
                out[row] = True

    must_false = (hi < 0.5) | (((km[..., 0] & 1) != 0) & ((kv[..., 0] & 1) == 0))
    for r in range(pack.n_rows):
        if out[r]:
            continue
        roots = pack.row_roots[r]
        if roots and must_false[roots, r].any():
            out[r] = True
    return out
