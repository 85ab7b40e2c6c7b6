"""Pack a batch of constraint rows onto one shared abstract-evaluation tape.

The pre-filter reuses ``native/bitblast.py``'s serialization wholesale: the
UNION of every row's conjuncts is serialized once (interned terms make
sibling rows share their entire path prefix, so the union tape is barely
larger than the widest single row), and each row keeps only the list of tape
nodes it actually asserts.  Evaluation then runs one pass over the tape with
a row axis — the whole frontier batch at once.

Every abstraction the serializer applies (mux-chain ``select`` rewrite,
fresh variables for base-array selects / keccak / apply, dropped select
congruence under ``lazy_selects=True``) only ever ADDS behaviors, so
bottom-by-abstraction at any asserted root proves the ORIGINAL row UNSAT.

Alongside the tape this module harvests per-row *narrowing overrides* —
exact integer range pins read off the row's own conjuncts (``x == c``,
``cnt <= 1``), mirroring ``smt/intervals.py``'s harvest — and converts them
to the dual-domain representation (directed-rounded float64 bounds plus
common-prefix known bits).  Overrides are met into the evaluation at the
overridden node for that row only.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from mythril_tpu_torch.native import bitblast
from mythril_tpu_torch.native.bitblast import OP_CONST, Unsupported
from mythril_tpu_torch.smt import terms
from mythril_tpu_torch.smt.terms import Term

# 32-bit limbs; 16 limbs cover every width the engine emits (mul/overflow
# demands build 512-bit intermediates).  Wider tapes fall through.
LIMBS = 16
MAX_WIDTH = 32 * LIMBS
U32 = np.uint32
_ALL = U32(0xFFFFFFFF)

# Conservative node budget for one packed batch: far below the blaster's
# 200k cap — the pre-filter must stay a near-free pass, and anything this
# large is better spent in the exact tiers.
MAX_NODES = 4096


def _f_under(v: int) -> float:
    """Largest float64 <= v (directed rounding for interval lower bounds)."""
    f = float(v)
    return f if int(f) <= v else float(np.nextafter(f, -np.inf))


def _f_over(v: int) -> float:
    """Smallest float64 >= v."""
    f = float(v)
    return f if int(f) >= v else float(np.nextafter(f, np.inf))


def _limbs_of(v: int) -> np.ndarray:
    out = np.zeros(LIMBS, U32)
    for i in range(LIMBS):
        out[i] = (v >> (32 * i)) & 0xFFFFFFFF
    return out


def width_mask(w: int) -> np.ndarray:
    """Per-limb mask of the bits below ``w``."""
    out = np.zeros(LIMBS, U32)
    for i in range(LIMBS):
        base = 32 * i
        if w >= base + 32:
            out[i] = _ALL
        elif w > base:
            out[i] = U32((1 << (w - base)) - 1)
    return out


class _RowRefuted(Exception):
    """Harvested narrowings for one row are mutually exclusive."""


class PackedBatch:
    """One serialized union tape plus per-row assertion/override data."""

    def __init__(self, n_rows: int):
        self.n_rows = n_rows
        self.n_nodes = 0
        # tape node arrays, all [N]-indexed
        self.op = np.zeros(0, np.int32)
        self.w = np.zeros(0, np.int32)
        self.a0 = np.zeros(0, np.int32)
        self.a1 = np.zeros(0, np.int32)
        self.a2 = np.zeros(0, np.int32)
        self.x0 = np.zeros(0, np.int32)
        self.x1 = np.zeros(0, np.int32)
        self.wm = np.zeros((0, LIMBS), U32)     # width masks
        self.c_limbs = np.zeros((0, LIMBS), U32)  # OP_CONST payloads
        self.c_lo = np.zeros(0, np.float64)
        self.c_hi = np.zeros(0, np.float64)
        # per-row asserted root nodes
        self.row_roots: List[List[int]] = [[] for _ in range(n_rows)]
        # rows refuted already at harvest time (contradictory narrowings)
        self.row_refuted = np.zeros(n_rows, bool)
        # node -> (olo[R], ohi[R], okm[R,L], okv[R,L]) narrowing overrides
        self.overrides: Dict[int, Tuple[np.ndarray, np.ndarray,
                                        np.ndarray, np.ndarray]] = {}
        # node -> [(row, lo, hi)] exact integer bounds for the same
        # narrowings: float64 cannot represent values like 2^256-1, so the
        # verdict pass re-checks each harvested demand against the exact
        # known-bits element with python-int arithmetic
        self.ov_exact: Dict[int, List[Tuple[int, int, int]]] = {}


def _override_slot(pack: PackedBatch, node: int):
    ov = pack.overrides.get(node)
    if ov is None:
        r = pack.n_rows
        ov = (
            np.zeros(r, np.float64),
            np.full(r, np.inf, np.float64),
            np.zeros((r, LIMBS), U32),
            np.zeros((r, LIMBS), U32),
        )
        pack.overrides[node] = ov
    return ov


def _apply_narrowing(pack: PackedBatch, row: int, node: int, w: int,
                     ranges: Dict[int, Tuple[int, int]]) -> None:
    """Install one row's final integer range for ``node`` into the pack."""
    lo, hi = ranges[node]
    olo, ohi, okm, okv = _override_slot(pack, node)
    olo[row] = _f_under(lo)
    ohi[row] = _f_over(hi)
    # every value in [lo, hi] shares the bits above the highest differing
    # bit of the bounds: those bits are KNOWN for this row
    k = (lo ^ hi).bit_length()
    known = ((1 << w) - 1) & ~((1 << k) - 1)
    okm[row] = _limbs_of(known)
    okv[row] = _limbs_of(lo & known)
    pack.ov_exact.setdefault(node, []).append((row, lo, hi))


def _harvest_row(conjuncts: Sequence[Term],
                 narrow) -> None:
    """``smt/intervals.py``-style range harvest over one row's conjuncts."""
    for c in conjuncts:
        _harvest(c, True, narrow)


def _signed(v: int, w: int) -> int:
    return v - (1 << w) if v >= (1 << (w - 1)) else v


def _harvest(t: Term, want: bool, narrow) -> None:
    op = t.op
    if op == "const" and t.sort is terms.BOOL:
        if bool(t.aux) != want:
            raise _RowRefuted
        return
    if op == "and" and want:
        for a in t.args:
            _harvest(a, True, narrow)
        return
    if op == "or" and not want:
        # De Morgan: Not(a | b | ...) == Not(a) & Not(b) & ...
        for a in t.args:
            _harvest(a, False, narrow)
        return
    if op == "not":
        _harvest(t.args[0], not want, narrow)
        return
    if op == "xor":
        # boolean xor against a constant is (possibly negated) assertion
        # of the other side: x ^ true == Not(x)
        a, b = t.args
        if a.sort is terms.BOOL:
            if a.op == "const":
                _harvest(b, want != bool(a.aux), narrow)
            elif b.op == "const":
                _harvest(a, want != bool(b.aux), narrow)
        return
    if op == "eq":
        a, b = t.args
        if a.sort is terms.BOOL:
            # boolean equality against a constant asserts the other side
            # (negated for eq(x, false) / Not(eq(x, true)))
            if a.op == "const":
                _harvest(b, want == bool(a.aux), narrow)
            elif b.op == "const":
                _harvest(a, want == bool(b.aux), narrow)
            return
        if not terms.is_bv_sort(a.sort):
            return
        if want:
            if a.is_const:
                narrow(b, a.value, a.value)
            elif b.is_const:
                narrow(a, b.value, b.value)
        return
    if op in ("ult", "ule"):
        a, b = t.args
        strict = op == "ult"
        if want:
            if a.is_const and not b.is_const:
                narrow(b, a.value + (1 if strict else 0), (1 << b.width) - 1)
            elif b.is_const and not a.is_const:
                narrow(a, 0, b.value - (1 if strict else 0))
        else:
            # Not(a < b) == b <= a; Not(a <= b) == b < a
            if b.is_const and not a.is_const:
                narrow(a, b.value + (0 if strict else 1), (1 << a.width) - 1)
            elif a.is_const and not b.is_const:
                narrow(b, 0, a.value - (0 if strict else 1))
        return
    if op in ("slt", "sle"):
        # signed comparisons pin one side only when the satisfying set is
        # a single unsigned interval (the two's-complement wraparound
        # splits the other polarity into a union the domain cannot hold)
        a, b = t.args
        strict = op == "slt"
        if not want:
            # Not(a <s b) == b <=s a ; Not(a <=s b) == b <s a
            a, b = b, a
            strict = not strict
        if not terms.is_bv_sort(a.sort):
            return
        w = a.width
        half, full = 1 << (w - 1), 1 << w
        if b.is_const and not a.is_const:
            # signed(a) < upper (strict normal form)
            upper = _signed(b.value, w) + (0 if strict else 1)
            if upper <= 0:
                # wholly inside the negative half: [half, upper-1 mod 2^w]
                narrow(a, half, (upper - 1) % full)
        elif a.is_const and not b.is_const:
            # signed(b) >= lower
            lower = _signed(a.value, w) + (1 if strict else 0)
            if lower >= 0:
                # wholly inside the non-negative half
                narrow(b, lower, half - 1)
        return


def pack(rows: Sequence[Sequence[Term]],
         max_nodes: int = MAX_NODES) -> PackedBatch:
    """Serialize the union of ``rows`` and build per-row assertion data.

    Raises ``bitblast.Unsupported`` when the union carries structure the
    abstract tape cannot express (array equality, >512-bit nodes, node
    budget blown) — callers treat that as fallthrough, never as a verdict.
    """
    union: List[Term] = []
    seen: set = set()
    for row in rows:
        for c in row:
            if c.tid not in seen:
                seen.add(c.tid)
                union.append(c)

    tape = bitblast.serialize(union, lazy_selects=True)
    n = len(tape.records)
    if n > max_nodes:
        raise Unsupported("prefilter tape too large (%d nodes)" % n)

    p = PackedBatch(len(rows))
    p.n_nodes = n
    p.node_of = dict(tape.node_of)  # tid -> node (differential tests)
    rec = np.asarray(tape.records, np.int64).reshape(n, 7)
    p.op = rec[:, 0].astype(np.int32)
    p.w = rec[:, 1].astype(np.int32)
    p.a0 = rec[:, 2].astype(np.int32)
    p.a1 = rec[:, 3].astype(np.int32)
    p.a2 = rec[:, 4].astype(np.int32)
    p.x0 = rec[:, 5].astype(np.int32)
    p.x1 = rec[:, 6].astype(np.int32)
    if int(p.w.max(initial=0)) > MAX_WIDTH:
        raise Unsupported("node wider than %d bits" % MAX_WIDTH)

    p.wm = np.zeros((n, LIMBS), U32)
    p.c_limbs = np.zeros((n, LIMBS), U32)
    p.c_lo = np.zeros(n, np.float64)
    p.c_hi = np.zeros(n, np.float64)
    consts = bytes(tape.consts)
    for i in range(n):
        w = int(p.w[i])
        p.wm[i] = width_mask(w)
        if p.op[i] == OP_CONST:
            off, nb = int(p.x0[i]), int(p.x1[i])
            v = int.from_bytes(consts[off:off + nb], "little") & ((1 << w) - 1)
            p.c_limbs[i] = _limbs_of(v)
            p.c_lo[i] = _f_under(v)
            p.c_hi[i] = _f_over(v)

    for r, row in enumerate(rows):
        p.row_roots[r] = [tape.node_of[c.tid] for c in row]
        ranges: Dict[int, Tuple[int, int]] = {}
        widths: Dict[int, int] = {}

        def narrow(t: Term, lo: int, hi: int) -> None:
            node = tape.node_of.get(t.tid)
            if node is None:
                return
            w = t.width if terms.is_bv_sort(t.sort) else 1
            lo, hi = max(lo, 0), min(hi, (1 << w) - 1)
            cur = ranges.get(node)
            if cur is not None:
                lo, hi = max(lo, cur[0]), min(hi, cur[1])
            if lo > hi:
                raise _RowRefuted
            ranges[node] = (lo, hi)
            widths[node] = w

        try:
            _harvest_row(row, narrow)
        except _RowRefuted:
            p.row_refuted[r] = True
            continue
        for node in ranges:
            _apply_narrowing(p, r, node, widths[node], ranges)
    return p
