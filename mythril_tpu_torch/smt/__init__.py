"""Public SMT API of the PyTorch port (a copy of ``mythril_tpu/smt/__init__.py``;
solving goes to ``mythril_tpu_torch.smt.solver``, whose ``Solver`` takes
``device``).

Public SMT API — the single seam the rest of the framework talks through.

API parity with the reference's Z3 wrapper layer (mythril/laser/smt/__init__.py:1-29,
bitvec.py, bool.py, array.py, function.py, bitvec_helper.py:30-240): the same
class names, helper names and annotation (taint) propagation semantics, but the
backing representation is this framework's own hash-consed term IR
(mythril_tpu/smt/terms.py) instead of z3 ExprRefs, and solving is routed to the
TPU probe + native CDCL stack instead of Z3 (mythril_tpu/smt/solver.py).

Annotations: every operator result carries the union of its operands'
annotation sets (reference: mythril/laser/smt/expression.py:10, bitvec.py:72) —
this is the taint channel the detection modules rely on.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Set, Union

from mythril_tpu_torch.smt import terms
from mythril_tpu_torch.smt.terms import Term


class Expression:
    """Base wrapper: a term plus a set of annotations (taint labels)."""

    __slots__ = ("raw", "annotations")

    def __init__(self, raw: Term, annotations: Optional[Iterable] = None):
        self.raw = raw
        self.annotations: Set = set(annotations) if annotations else set()

    def annotate(self, annotation) -> None:
        self.annotations.add(annotation)

    def get_annotations(self, annotation_type: type) -> List:
        return [a for a in self.annotations if isinstance(a, annotation_type)]

    def __hash__(self):
        return hash(self.raw)

    def __repr__(self):
        return repr(self.raw)


def _union(*exprs) -> Set:
    out: Set = set()
    for e in exprs:
        if isinstance(e, Expression):
            out |= e.annotations
    return out


class Bool(Expression):
    @property
    def is_true(self) -> bool:
        return self.raw.op == "const" and self.raw.aux is True

    @property
    def is_false(self) -> bool:
        return self.raw.op == "const" and self.raw.aux is False

    @property
    def value(self) -> Optional[bool]:
        return bool(self.raw.aux) if self.raw.op == "const" else None

    def __and__(self, other: "Bool") -> "Bool":
        return And(self, other)

    def __or__(self, other: "Bool") -> "Bool":
        return Or(self, other)

    def __invert__(self) -> "Bool":
        return Not(self)

    def __eq__(self, other):  # type: ignore[override]
        if not isinstance(other, Bool):
            return NotImplemented
        return Bool(terms.iff(self.raw, other.raw), _union(self, other))

    def __ne__(self, other):  # type: ignore[override]
        if not isinstance(other, Bool):
            return NotImplemented
        return Bool(terms.lxor(self.raw, other.raw), _union(self, other))

    def __hash__(self):
        return hash(self.raw)

    def __bool__(self):
        # Matches z3-python ergonomics closely enough: concrete bools collapse.
        if self.raw.op == "const":
            return bool(self.raw.aux)
        raise TypeError("symbolic Bool has no concrete truth value")

    def substitute(self, mapping) -> "Bool":
        raw_map = {k.raw: v.raw for k, v in mapping.items()}
        return Bool(terms.substitute(self.raw, raw_map), set(self.annotations))


class BitVec(Expression):
    """256-bit-centric bitvector wrapper with full operator overloading.

    Width-mismatched equality pads the narrower side with zeros, mirroring the
    reference's 512-bit sha3-operand special case (mythril/laser/smt/bitvec.py:16-22).
    """

    def size(self) -> int:
        return self.raw.width

    @property
    def symbolic(self) -> bool:
        return not self.raw.is_const

    @property
    def value(self) -> Optional[int]:
        return self.raw.value if self.raw.is_const else None

    # -- arithmetic ---------------------------------------------------------
    def __add__(self, other):
        other = _coerce(other, self.size())
        return BitVec(terms.add(self.raw, other.raw), _union(self, other))

    __radd__ = __add__

    def __sub__(self, other):
        other = _coerce(other, self.size())
        return BitVec(terms.sub(self.raw, other.raw), _union(self, other))

    def __rsub__(self, other):
        other = _coerce(other, self.size())
        return BitVec(terms.sub(other.raw, self.raw), _union(self, other))

    def __mul__(self, other):
        other = _coerce(other, self.size())
        return BitVec(terms.mul(self.raw, other.raw), _union(self, other))

    __rmul__ = __mul__

    def __truediv__(self, other):
        """Signed division (z3 ``/`` semantics, as in the reference)."""
        other = _coerce(other, self.size())
        return BitVec(terms.sdiv(self.raw, other.raw), _union(self, other))

    def __mod__(self, other):
        """Signed remainder (z3 ``%`` is srem on bitvecs)."""
        other = _coerce(other, self.size())
        return BitVec(terms.srem(self.raw, other.raw), _union(self, other))

    def __and__(self, other):
        other = _coerce(other, self.size())
        return BitVec(terms.band(self.raw, other.raw), _union(self, other))

    __rand__ = __and__

    def __or__(self, other):
        other = _coerce(other, self.size())
        return BitVec(terms.bor(self.raw, other.raw), _union(self, other))

    __ror__ = __or__

    def __xor__(self, other):
        other = _coerce(other, self.size())
        return BitVec(terms.bxor(self.raw, other.raw), _union(self, other))

    __rxor__ = __xor__

    def __invert__(self):
        return BitVec(terms.bnot(self.raw), set(self.annotations))

    def __neg__(self):
        return BitVec(terms.neg(self.raw), set(self.annotations))

    def __lshift__(self, other):
        other = _coerce(other, self.size())
        return BitVec(terms.shl(self.raw, other.raw), _union(self, other))

    def __rshift__(self, other):
        """Arithmetic shift right (z3 ``>>``); use LShR for logical."""
        other = _coerce(other, self.size())
        return BitVec(terms.ashr(self.raw, other.raw), _union(self, other))

    # -- comparisons (signed, like z3 python) -------------------------------
    def __lt__(self, other) -> Bool:
        other = _coerce(other, self.size())
        return Bool(terms.slt(self.raw, other.raw), _union(self, other))

    def __gt__(self, other) -> Bool:
        other = _coerce(other, self.size())
        return Bool(terms.sgt(self.raw, other.raw), _union(self, other))

    def __le__(self, other) -> Bool:
        other = _coerce(other, self.size())
        return Bool(terms.sle(self.raw, other.raw), _union(self, other))

    def __ge__(self, other) -> Bool:
        other = _coerce(other, self.size())
        return Bool(terms.sge(self.raw, other.raw), _union(self, other))

    def __eq__(self, other) -> Bool:  # type: ignore[override]
        if other is None:
            return Bool(terms.false())
        other = _coerce(other, self.size())
        a, b = _pad_pair(self.raw, other.raw)
        return Bool(terms.eq(a, b), _union(self, other))

    def __ne__(self, other) -> Bool:  # type: ignore[override]
        if other is None:
            return Bool(terms.true())
        other = _coerce(other, self.size())
        a, b = _pad_pair(self.raw, other.raw)
        return Bool(terms.ne(a, b), _union(self, other))

    def __hash__(self):
        return hash(self.raw)


def _coerce(x, width: int) -> BitVec:
    if isinstance(x, BitVec):
        return x
    if isinstance(x, int):
        return BitVec(terms.const(x, width))
    raise TypeError(f"cannot coerce {type(x)} to BitVec")


def _pad_pair(a: Term, b: Term):
    if a.width == b.width:
        return a, b
    if a.width < b.width:
        a = terms.zext(a, b.width - a.width)
    else:
        b = terms.zext(b, a.width - b.width)
    return a, b


class BitVecFunc(BitVec):
    """Kept for API parity; hash applications are real ``keccak`` terms here."""


class BaseArray:
    pass


class Array(BaseArray):
    """Named symbolic array store (reference smt/array.py:45)."""

    def __init__(self, name: str, domain: int, value_range: int, raw: Optional[Term] = None):
        self.raw = raw if raw is not None else terms.array_var(name, domain, value_range)
        self.domain = domain
        self.range = value_range

    def __getitem__(self, item: BitVec) -> BitVec:
        return BitVec(terms.select(self.raw, item.raw), set(item.annotations))

    def __setitem__(self, key: BitVec, value) -> None:
        value = _coerce(value, self.range)
        self.raw = terms.store(self.raw, key.raw, value.raw)


class K(BaseArray):
    """Constant-default array (reference smt/array.py:60)."""

    def __init__(self, domain: int, value_range: int, value: Union[int, BitVec]):
        value = _coerce(value, value_range)
        self.raw = terms.const_array(domain, value_range, value.raw)
        self.domain = domain
        self.range = value_range

    def __getitem__(self, item: BitVec) -> BitVec:
        return BitVec(terms.select(self.raw, item.raw), set(item.annotations))

    def __setitem__(self, key: BitVec, value) -> None:
        value = _coerce(value, self.range)
        self.raw = terms.store(self.raw, key.raw, value.raw)


class Function:
    """N-ary uninterpreted function (reference smt/function.py:7)."""

    def __init__(self, name: str, domain: List[int], value_range: int):
        self.name = name
        self.domain = domain
        self.range = value_range

    def __call__(self, *args: BitVec) -> BitVec:
        anns = _union(*args)
        return BitVec(
            terms.apply_func(self.name, self.range, *[a.raw for a in args]), anns
        )


# ---------------------------------------------------------------------------
# Helper functions (reference bitvec_helper.py / bool.py surface)
# ---------------------------------------------------------------------------


def If(cond, a, b):
    if isinstance(cond, bool):
        cond = Bool(terms.boolval(cond))
    if isinstance(a, int) and isinstance(b, BitVec):
        a = _coerce(a, b.size())
    if isinstance(b, int) and isinstance(a, BitVec):
        b = _coerce(b, a.size())
    anns = _union(cond, a, b)
    if isinstance(a, Bool):
        return Bool(terms.ite(cond.raw, a.raw, b.raw), anns)
    return BitVec(terms.ite(cond.raw, a.raw, b.raw), anns)


def UGT(a: BitVec, b) -> Bool:
    b = _coerce(b, a.size())
    return Bool(terms.ugt(a.raw, b.raw), _union(a, b))


def UGE(a: BitVec, b) -> Bool:
    b = _coerce(b, a.size())
    return Bool(terms.uge(a.raw, b.raw), _union(a, b))


def ULT(a: BitVec, b) -> Bool:
    b = _coerce(b, a.size())
    return Bool(terms.ult(a.raw, b.raw), _union(a, b))


def ULE(a: BitVec, b) -> Bool:
    b = _coerce(b, a.size())
    return Bool(terms.ule(a.raw, b.raw), _union(a, b))


def SLT(a: BitVec, b) -> Bool:
    b = _coerce(b, a.size())
    return Bool(terms.slt(a.raw, b.raw), _union(a, b))


def SGT(a: BitVec, b) -> Bool:
    b = _coerce(b, a.size())
    return Bool(terms.sgt(a.raw, b.raw), _union(a, b))


def Concat(*args) -> BitVec:
    if len(args) == 1 and isinstance(args[0], list):
        args = tuple(args[0])
    anns = _union(*args)
    return BitVec(terms.concat(*[a.raw for a in args]), anns)


def Extract(high: int, low: int, bv: BitVec) -> BitVec:
    return BitVec(terms.extract(high, low, bv.raw), set(bv.annotations))


def UDiv(a: BitVec, b) -> BitVec:
    b = _coerce(b, a.size())
    return BitVec(terms.udiv(a.raw, b.raw), _union(a, b))


def URem(a: BitVec, b) -> BitVec:
    b = _coerce(b, a.size())
    return BitVec(terms.urem(a.raw, b.raw), _union(a, b))


def SRem(a: BitVec, b) -> BitVec:
    b = _coerce(b, a.size())
    return BitVec(terms.srem(a.raw, b.raw), _union(a, b))


def SDiv(a: BitVec, b) -> BitVec:
    b = _coerce(b, a.size())
    return BitVec(terms.sdiv(a.raw, b.raw), _union(a, b))


def LShR(a: BitVec, b) -> BitVec:
    b = _coerce(b, a.size())
    return BitVec(terms.lshr(a.raw, b.raw), _union(a, b))


def Exp(a: BitVec, b) -> BitVec:
    b = _coerce(b, a.size())
    return BitVec(terms.bvexp(a.raw, b.raw), _union(a, b))


def Keccak(data: BitVec) -> BitVec:
    return BitVec(terms.keccak(data.raw), set(data.annotations))


def Sum(*args: BitVec) -> BitVec:
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


def ZeroExt(extra: int, a: BitVec) -> BitVec:
    return BitVec(terms.zext(a.raw, extra), set(a.annotations))


def SignExt(extra: int, a: BitVec) -> BitVec:
    return BitVec(terms.sext(a.raw, extra), set(a.annotations))


def And(*args: Bool) -> Bool:
    return Bool(terms.land(*[a.raw for a in args]), _union(*args))


def Or(*args: Bool) -> Bool:
    return Bool(terms.lor(*[a.raw for a in args]), _union(*args))


def Not(a: Bool) -> Bool:
    return Bool(terms.lnot(a.raw), set(a.annotations))


def Xor(a: Bool, b: Bool) -> Bool:
    return Bool(terms.lxor(a.raw, b.raw), _union(a, b))


def Implies(a: Bool, b: Bool) -> Bool:
    return Bool(terms.implies(a.raw, b.raw), _union(a, b))


def is_true(a: Bool) -> bool:
    return a.is_true


def is_false(a: Bool) -> bool:
    return a.is_false


def simplify(e):
    """Terms fold eagerly at construction, so simplify is (almost) the identity.

    Kept for reference API parity (mythril/laser/smt/expression.py:63); callers
    rely on it to canonicalize memory/storage indices, which hash-consing
    already guarantees.
    """
    return e


# Overflow predicates (reference bitvec_helper.py:196-227)


def BVAddNoOverflow(a: BitVec, b, signed: bool) -> Bool:
    b = _coerce(b, a.size())
    w = a.size()
    ax, bx = (terms.sext(a.raw, 1), terms.sext(b.raw, 1)) if signed else (
        terms.zext(a.raw, 1),
        terms.zext(b.raw, 1),
    )
    s = terms.add(ax, bx)
    if signed:
        # overflow iff the (w+1)-bit sum is not representable in w bits
        lo = terms.const((1 << (w + 1)) - (1 << (w - 1)), w + 1)  # -2^(w-1)
        hi = terms.const((1 << (w - 1)) - 1, w + 1)
        ok = terms.land(terms.sle(lo, s), terms.sle(s, hi))
    else:
        ok = terms.ule(s, terms.const((1 << w) - 1, w + 1))
    return Bool(ok, _union(a, b))


def BVSubNoUnderflow(a: BitVec, b, signed: bool) -> Bool:
    b = _coerce(b, a.size())
    w = a.size()
    if signed:
        ax, bx = terms.sext(a.raw, 1), terms.sext(b.raw, 1)
        d = terms.sub(ax, bx)
        lo = terms.const((1 << (w + 1)) - (1 << (w - 1)), w + 1)
        hi = terms.const((1 << (w - 1)) - 1, w + 1)
        ok = terms.land(terms.sle(lo, d), terms.sle(d, hi))
    else:
        ok = terms.uge(a.raw, b.raw)
    return Bool(ok, _union(a, b))


def BVMulNoOverflow(a: BitVec, b, signed: bool) -> Bool:
    b = _coerce(b, a.size())
    w = a.size()
    if signed:
        ax, bx = terms.sext(a.raw, w), terms.sext(b.raw, w)
        p = terms.mul(ax, bx)
        lo = terms.const((1 << (2 * w)) - (1 << (w - 1)), 2 * w)
        hi = terms.const((1 << (w - 1)) - 1, 2 * w)
        ok = terms.land(terms.sle(lo, p), terms.sle(p, hi))
    else:
        ax, bx = terms.zext(a.raw, w), terms.zext(b.raw, w)
        p = terms.mul(ax, bx)
        ok = terms.ule(p, terms.const((1 << w) - 1, 2 * w))
    return Bool(ok, _union(a, b))


# ---------------------------------------------------------------------------
# Symbol factory (reference smt/__init__.py:37-154)
# ---------------------------------------------------------------------------


class SymbolFactory:
    @staticmethod
    def BitVecVal(value: int, size: int, annotations=None) -> BitVec:
        return BitVec(terms.const(value, size), annotations)

    @staticmethod
    def BitVecSym(name: str, size: int, annotations=None) -> BitVec:
        return BitVec(terms.var(name, size), annotations)

    @staticmethod
    def BoolVal(value: bool, annotations=None) -> Bool:
        return Bool(terms.boolval(value), annotations)

    @staticmethod
    def BoolSym(name: str, annotations=None) -> Bool:
        return Bool(terms.bool_var(name), annotations)


symbol_factory = SymbolFactory()

from mythril_tpu_torch.smt.solver import (  # noqa: E402  (re-export, reference smt/__init__ parity)
    Model,
    Optimize,
    Solver,
    SolverStatistics,
    SAT,
    UNKNOWN,
    UNSAT,
)
