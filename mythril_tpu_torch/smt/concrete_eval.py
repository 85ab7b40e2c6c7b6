"""Copy of ``mythril_tpu/smt/concrete_eval.py`` for the PyTorch port.

Exact host-side evaluation of term DAGs under a concrete assignment.

This is the ground-truth semantics of the IR.  Used for:
  * validating satisfying assignments proposed by the TPU probe solver before
    they are ever surfaced as models (keeps probing sound);
  * reifying concrete transaction inputs for exploit reports (the counterpart
    of model-eval in the reference, mythril/analysis/solver.py:184-213);
  * differential testing of the JAX lowering and the C++ bit-blaster.

Arrays are evaluated with real read-over-write semantics; base symbolic arrays
read from a per-array backing dict (default value for absent keys), so a single
consistent array interpretation is enforced — unlike the per-select free
variables the probe uses internally (Ackermann-style), which is why validation
here is required.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

from mythril_tpu_torch.ops.keccak import keccak256_int
from mythril_tpu_torch.smt import terms
from mythril_tpu_torch.smt.terms import Term, mask, to_signed


class ArrayValue:
    """Concrete array interpretation: sparse backing + default.

    ``salt`` (candidate diversification): when nonzero, reads of ABSENT keys
    return a deterministic pseudo-random value derived from (salt, idx)
    instead of ``default``.  All-zero defaults make distinct symbolic reads
    collide (two array elements hashing to the same storage slot), hiding
    models that need distinctness; salted candidates explore those.  The
    function is pure, so validation under the same assignment is exact."""

    __slots__ = ("backing", "default", "salt", "range_bits")

    def __init__(
        self,
        backing: Dict[int, int] | None = None,
        default: int = 0,
        salt: int = 0,
        range_bits: int = 0,
    ):
        self.backing = dict(backing or {})
        self.default = default
        self.salt = salt
        self.range_bits = range_bits

    def read(self, idx: int) -> int:
        v = self.backing.get(idx)
        if v is not None:
            return v
        if self.salt:
            h = (idx * 0x9E3779B97F4A7C15 + self.salt * 0xBF58476D1CE4E5B9) & (
                (1 << 64) - 1
            )
            h ^= h >> 31
            return h & ((1 << self.range_bits) - 1 if self.range_bits else 0xFF)
        return self.default

    def write(self, idx: int, val: int) -> "ArrayValue":
        out = ArrayValue(self.backing, self.default, self.salt, self.range_bits)
        out.backing[idx] = val
        return out


class Assignment:
    """Concrete interpretation of free symbols.

    ``scalars``: var term -> int (bitvec) or bool
    ``arrays``:  array_var term -> ArrayValue
    ``ufs``:     (sig, concrete arg tuple) -> int, for 'apply' terms
    Missing entries default to 0 / empty array (completion), recorded so the
    caller can see which defaults were used.
    """

    def __init__(self, scalars=None, arrays=None, ufs=None):
        self.scalars: Dict[Term, int] = dict(scalars or {})
        self.arrays: Dict[Term, ArrayValue] = dict(arrays or {})
        self.ufs: Dict[tuple, int] = dict(ufs or {})

    def scalar(self, t: Term):
        v = self.scalars.get(t)
        if v is None:
            v = False if t.sort is terms.BOOL else 0
            self.scalars[t] = v
        return v

    def array(self, t: Term) -> ArrayValue:
        v = self.arrays.get(t)
        if v is None:
            v = ArrayValue()
            self.arrays[t] = v
        return v


def evaluate(roots: Iterable[Term], asg: Assignment) -> Dict[Term, object]:
    """Evaluate every term reachable from ``roots``; returns {term: value}.

    Bitvec values are ints, bools are Python bools, arrays are ArrayValue.
    """
    val: Dict[int, object] = {}
    for t in terms.topo_order(roots):
        val[t.tid] = _eval_node(t, val, asg)
    return {r: val[r.tid] for r in roots}


def evaluate_one(root: Term, asg: Assignment):
    return evaluate([root], asg)[root]


def _eval_node(t: Term, val, asg: Assignment):
    op = t.op
    a = t.args
    if op == "const":
        return t.aux
    if op == "var":
        return asg.scalar(t)
    if op == "array_var":
        return asg.array(t)
    if op == "const_array":
        return ArrayValue(default=val[a[0].tid])

    if op in _BINOPS:
        return _BINOPS[op](val[a[0].tid], val[a[1].tid], t.width)
    if op == "bvnot":
        return mask(~val[a[0].tid], t.width)
    if op == "bvneg":
        return mask(-val[a[0].tid], t.width)
    if op == "concat":
        return (val[a[0].tid] << a[1].width) | val[a[1].tid]
    if op == "extract":
        hi, lo = t.aux
        return mask(val[a[0].tid] >> lo, hi - lo + 1)
    if op == "zext":
        return val[a[0].tid]
    if op == "sext":
        return mask(to_signed(val[a[0].tid], a[0].width), t.width)

    if op == "eq":
        return val[a[0].tid] == val[a[1].tid]
    if op == "ult":
        return val[a[0].tid] < val[a[1].tid]
    if op == "ule":
        return val[a[0].tid] <= val[a[1].tid]
    if op == "slt":
        return to_signed(val[a[0].tid], a[0].width) < to_signed(val[a[1].tid], a[1].width)
    if op == "sle":
        return to_signed(val[a[0].tid], a[0].width) <= to_signed(val[a[1].tid], a[1].width)

    if op == "and":
        return all(val[x.tid] for x in a)
    if op == "or":
        return any(val[x.tid] for x in a)
    if op == "not":
        return not val[a[0].tid]
    if op == "xor":
        return bool(val[a[0].tid]) != bool(val[a[1].tid])
    if op == "ite":
        return val[a[1].tid] if val[a[0].tid] else val[a[2].tid]

    if op == "store":
        return val[a[0].tid].write(val[a[1].tid], val[a[2].tid])
    if op == "select":
        return val[a[0].tid].read(val[a[1].tid])

    if op == "keccak":
        return keccak256_int(val[a[0].tid], a[0].width // 8)
    if op == "apply":
        key = (t.aux, tuple(val[x.tid] for x in a))
        return asg.ufs.setdefault(key, 0)
    raise NotImplementedError(f"concrete_eval: op {op}")


def _div(x, y, w):
    return 0 if y == 0 else x // y


def _sdiv(x, y, w):
    if y == 0:
        return 0
    xs, ys = to_signed(x, w), to_signed(y, w)
    q = abs(xs) // abs(ys)
    if (xs < 0) != (ys < 0):
        q = -q
    return mask(q, w)


def _rem(x, y, w):
    return 0 if y == 0 else x % y


def _srem(x, y, w):
    if y == 0:
        return 0
    xs, ys = to_signed(x, w), to_signed(y, w)
    r = abs(xs) % abs(ys)
    if xs < 0:
        r = -r
    return mask(r, w)


_BINOPS = {
    "bvadd": lambda x, y, w: mask(x + y, w),
    "bvsub": lambda x, y, w: mask(x - y, w),
    "bvmul": lambda x, y, w: mask(x * y, w),
    "bvudiv": _div,
    "bvsdiv": _sdiv,
    "bvurem": _rem,
    "bvsrem": _srem,
    "bvand": lambda x, y, w: x & y,
    "bvor": lambda x, y, w: x | y,
    "bvxor": lambda x, y, w: x ^ y,
    "bvshl": lambda x, y, w: mask(x << y, w) if y < w else 0,
    "bvlshr": lambda x, y, w: x >> y if y < w else 0,
    "bvashr": lambda x, y, w: mask(to_signed(x, w) >> min(y, w - 1), w),
    "bvexp": lambda x, y, w: pow(x, y, 1 << w),
}
