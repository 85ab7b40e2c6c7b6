"""Copy of ``mythril_tpu/smt/intervals.py`` for the PyTorch port.

Interval-bound refutation: a cheap exact-UNSAT tier.

Unsigned [lo, hi] ranges are computed bottom-up over the term DAG, narrowed
by range constraints harvested from the conjunction itself (``cnt <= 1``,
``x == const``...).  If any conjunct is impossible under the ranges — or a
term's harvested ranges are disjoint — the conjunction is UNSAT.

Soundness: ranges are valid in EVERY model (they come from asserted
conjuncts or from structural arithmetic bounds), and satisfiability of a
comparison is checked against independent ranges, an over-approximation of
the true (correlated) feasible set.  A refutation here is therefore exact.

This tier exists for queries like a loop-exit path that pins ``cnt <= 1``
conjoined with an overflow demand ``cnt * value >= 2^256``: bit-blasting
the 512-bit multiply costs seconds, while interval propagation sees
``hi(product) = 1 * (2^256 - 1) < 2^256`` instantly.  The reference gets
this from Z3's preprocessing/theory layers (mythril/support/model.py:15-63
delegates wholesale); here it sits between constant folding (tier 0) and
the directed probe.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from mythril_tpu_torch.smt import terms
from mythril_tpu_torch.smt.terms import Term

Range = Tuple[int, int]


class _Refuted(Exception):
    """A term's constraints are mutually exclusive."""


def _full(w: int) -> Range:
    return (0, (1 << w) - 1)


def _bool_and(a: Range, b: Range) -> Range:
    return (min(a[0], b[0]) if (a[0] and b[0]) else 0, 1 if (a[1] and b[1]) else 0)


def refute(conjuncts: Sequence[Term]) -> bool:
    """True iff interval analysis PROVES the conjunction unsatisfiable."""
    overrides: Dict[int, Range] = {}

    def narrow(t: Term, lo: int, hi: int) -> None:
        w = t.width if terms.is_bv_sort(t.sort) else 1
        lo, hi = max(lo, 0), min(hi, (1 << w) - 1)
        cur = overrides.get(t.tid)
        if cur is not None:
            lo, hi = max(lo, cur[0]), min(hi, cur[1])
        if lo > hi:
            raise _Refuted
        overrides[t.tid] = (lo, hi)

    try:
        for c in conjuncts:
            _harvest(c, True, narrow)
        rng: Dict[int, Range] = {}
        for t in terms.topo_order(list(conjuncts)):
            rng[t.tid] = _eval(t, rng, overrides)
        for c in conjuncts:
            if rng[c.tid] == (0, 0):
                return True
    except _Refuted:
        return True
    except Exception:
        return False  # analysis must never misreport; bail conservatively
    return False


def _harvest(t: Term, want: bool, narrow) -> None:
    """Collect range constraints from a conjunct wanted ``want``."""
    op = t.op
    if op == "and" and want:
        for a in t.args:
            _harvest(a, True, narrow)
        return
    if op == "not":
        _harvest(t.args[0], not want, narrow)
        return
    if op == "eq":
        a, b = t.args
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
                hi = b.value - (1 if strict else 0)
                narrow(a, 0, hi)
        else:
            # Not(a < b) == b <= a; Not(a <= b) == b < a
            if b.is_const and not a.is_const:
                narrow(a, b.value + (0 if strict else 1), (1 << a.width) - 1)
            elif a.is_const and not b.is_const:
                narrow(b, 0, a.value - (0 if strict else 1))
        return


def _eval(t: Term, rng: Dict[int, Range], overrides: Dict[int, Range]) -> Range:
    op = t.op
    if terms.is_array_sort(t.sort):
        return (0, 0)  # arrays carry no scalar range; selects use range sort
    w = t.width if terms.is_bv_sort(t.sort) else 1
    full = (1 << w) - 1
    a = t.args

    def R(x: Term) -> Range:
        return rng[x.tid]

    if op == "const":
        v = int(t.aux) if t.sort is not terms.BOOL else (1 if t.aux else 0)
        out = (v, v)
    elif op == "zext":
        out = R(a[0])
    elif op == "sext":
        iw = a[0].width
        ilo, ihi = R(a[0])
        out = (ilo, ihi) if ihi < (1 << (iw - 1)) else (0, full)
    elif op == "concat":
        hl, hh = R(a[0])
        ll, lh = R(a[1])
        wl = a[1].width
        out = ((hl << wl) + ll, (hh << wl) + lh)
    elif op == "bvadd":
        (la, ha), (lb, hb) = R(a[0]), R(a[1])
        out = (la + lb, ha + hb) if ha + hb <= full else (0, full)
    elif op == "bvmul":
        (la, ha), (lb, hb) = R(a[0]), R(a[1])
        out = (la * lb, ha * hb) if ha * hb <= full else (0, full)
    elif op == "bvsub":
        (la, ha), (lb, hb) = R(a[0]), R(a[1])
        out = (la - hb, ha - lb) if la >= hb else (0, full)
    elif op == "bvand":
        (_, ha), (_, hb) = R(a[0]), R(a[1])
        out = (0, min(ha, hb))
    elif op == "bvor":
        (la, ha), (lb, hb) = R(a[0]), R(a[1])
        out = (max(la, lb), min(full, ha + hb))
    elif op in ("bvudiv", "bvurem"):
        out = (0, R(a[0])[1])
    elif op == "bvlshr" and a[1].is_const:
        k = min(a[1].value, w)
        la, ha = R(a[0])
        out = (la >> k, ha >> k)
    elif op == "bvshl" and a[1].is_const:
        k = min(a[1].value, w)
        la, ha = R(a[0])
        out = (la << k, ha << k) if (ha << k) <= full else (0, full)
    elif op == "ite":
        c = R(a[0])
        if c == (1, 1):
            out = R(a[1])
        elif c == (0, 0):
            out = R(a[2])
        else:
            (la, ha), (lb, hb) = R(a[1]), R(a[2])
            out = (min(la, lb), max(ha, hb))
    elif op == "ult":
        (la, ha), (lb, hb) = R(a[0]), R(a[1])
        out = (1, 1) if ha < lb else ((0, 0) if la >= hb else (0, 1))
    elif op == "ule":
        (la, ha), (lb, hb) = R(a[0]), R(a[1])
        out = (1, 1) if ha <= lb else ((0, 0) if la > hb else (0, 1))
    elif op == "eq" and terms.is_bv_sort(a[0].sort):
        (la, ha), (lb, hb) = R(a[0]), R(a[1])
        if ha < lb or hb < la:
            out = (0, 0)
        elif la == ha == lb == hb:
            out = (1, 1)
        else:
            out = (0, 1)
    elif op == "and":
        out = (1, 1)
        for x in a:
            out = _bool_and(out, R(x))
    elif op == "or":
        lo = max(R(x)[0] for x in a)
        hi = max(R(x)[1] for x in a)
        out = (lo, hi)
    elif op == "not":
        lo, hi = R(a[0])
        out = (1 - hi, 1 - lo)
    else:
        out = (0, full)

    ov = overrides.get(t.tid)
    if ov is not None:
        lo, hi = max(out[0], ov[0]), min(out[1], ov[1])
        if lo > hi:
            raise _Refuted
        out = (lo, hi)
    return out
