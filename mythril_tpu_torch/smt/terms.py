"""Copy of ``mythril_tpu/smt/terms.py`` for the PyTorch port, which imports
nothing of ``mythril_tpu``; only the keccak import is repointed.

Hash-consed bitvector/bool/array term IR — the framework's SMT core.

This replaces the reference's Z3 wrapper layer (mythril/laser/smt/*) with an
in-house intermediate representation designed for TPU lowering: every term is an
immutable, interned DAG node; concrete subterms constant-fold eagerly so purely
concrete execution never builds symbolic residue.  The same DAG has three
consumers:

  * the host big-int evaluator (``mythril_tpu/smt/concrete_eval.py``) — exact
    semantics, used for witness validation and differential testing;
  * the JAX lowering (``mythril_tpu/ops/lowering.py``) — batched evaluation of
    the DAG over many candidate assignments on TPU (the probe solver);
  * the C++ bit-blaster (``mythril_tpu/native/``) — exact sat/unsat.

Reference parity: the op surface mirrors mythril/laser/smt/bitvec_helper.py:30-240
and mythril/laser/smt/array.py, but keccak is a first-class operator (evaluated
concretely by every backend) instead of an uninterpreted function with interval
axioms (reference: mythril/laser/ethereum/function_managers/keccak_function_manager.py).
"""

from __future__ import annotations

import itertools
import threading
from typing import Dict, Iterable, Optional, Tuple, Union

# ---------------------------------------------------------------------------
# Sorts
# ---------------------------------------------------------------------------

BOOL = "bool"


def bv(width: int) -> Tuple[str, int]:
    return ("bv", width)


def array_sort(dom: int, rng: int) -> Tuple[str, int, int]:
    return ("arr", dom, rng)


def is_bv_sort(s) -> bool:
    return isinstance(s, tuple) and s[0] == "bv"


def is_array_sort(s) -> bool:
    return isinstance(s, tuple) and s[0] == "arr"


def mask(value: int, width: int) -> int:
    return value & ((1 << width) - 1)


def to_signed(value: int, width: int) -> int:
    value = mask(value, width)
    if value >= 1 << (width - 1):
        value -= 1 << width
    return value


# ---------------------------------------------------------------------------
# Term node
# ---------------------------------------------------------------------------

_term_counter = itertools.count()


class Term:
    """One interned node of the expression DAG.

    ``op``   operation name (see OPS below)
    ``sort`` BOOL | ("bv", w) | ("arr", dw, rw)
    ``args`` child terms
    ``aux``  non-term payload: constant value, variable name, (hi, lo), ...
    """

    __slots__ = ("op", "sort", "args", "aux", "tid", "_hashkey", "__weakref__")

    def __init__(self, op, sort, args, aux, hashkey):
        self.op = op
        self.sort = sort
        self.args = args
        self.aux = aux
        self.tid = next(_term_counter)
        self._hashkey = hashkey

    # Terms are interned: identity == structural equality.
    def __hash__(self):
        return hash(self._hashkey)

    def __eq__(self, other):
        return self is other

    @property
    def width(self) -> int:
        assert is_bv_sort(self.sort), f"not a bitvector: {self.op}"
        return self.sort[1]

    @property
    def is_const(self) -> bool:
        return self.op == "const"

    @property
    def value(self) -> int:
        assert self.op == "const"
        return self.aux

    def __repr__(self):
        if self.op == "const":
            if self.sort is BOOL:
                return "true" if self.aux else "false"
            return f"0x{self.aux:x}#{self.sort[1]}"
        if self.op in ("var", "array_var"):
            return f"{self.aux}"
        inner = " ".join(repr(a) for a in self.args)
        if self.aux is not None:
            return f"({self.op}[{self.aux}] {inner})"
        return f"({self.op} {inner})"


# Interning table.  Keyed by (op, sort, child tids, aux).
_INTERN: Dict[tuple, Term] = {}
# Interning must be race-free: equality is term identity (``self is
# other``), so two threads materializing the same key concurrently would
# mint two Terms with distinct tids and silently break every identity
# check and solver memo downstream.  Double-checked: the hit path stays
# lock-free (dict reads are atomic under the GIL), only a miss locks.
_INTERN_LOCK = threading.Lock()


def _mk(op, sort, args=(), aux=None) -> Term:
    if isinstance(sort, list):
        sort = tuple(sort)
    key = (op, sort, tuple(a.tid for a in args), aux)
    t = _INTERN.get(key)
    if t is None:
        with _INTERN_LOCK:
            t = _INTERN.get(key)
            if t is None:
                t = Term(op, sort, tuple(args), aux, key)
                _INTERN[key] = t
    return t


def intern_table_size() -> int:
    return len(_INTERN)


def clear_intern_table() -> None:
    """Drop all interned terms (tests / long-running corpus scans)."""
    _INTERN.clear()
    # also release the memoized walks so dropped terms can be collected
    _TOPO_CACHE.clear()


# ---------------------------------------------------------------------------
# Constructors: constants and variables
# ---------------------------------------------------------------------------


def const(value: int, width: int) -> Term:
    return _mk("const", bv(width), aux=mask(int(value), width))


def true() -> Term:
    return _mk("const", BOOL, aux=True)


def false() -> Term:
    return _mk("const", BOOL, aux=False)


def boolval(b: bool) -> Term:
    return true() if b else false()


def var(name: str, width: int) -> Term:
    return _mk("var", bv(width), aux=name)


def bool_var(name: str) -> Term:
    return _mk("var", BOOL, aux=name)


def array_var(name: str, dom: int, rng: int) -> Term:
    return _mk("array_var", array_sort(dom, rng), aux=name)


def const_array(dom: int, rng: int, default: Term) -> Term:
    """K combinator: array mapping every index to ``default``.

    Reference: mythril/laser/smt/array.py:60 (class K).
    """
    assert is_bv_sort(default.sort) and default.width == rng
    return _mk("const_array", array_sort(dom, rng), (default,))


# ---------------------------------------------------------------------------
# Bitvector operations (eager constant folding + light algebraic rewrites)
# ---------------------------------------------------------------------------


def _c2(a: Term, b: Term) -> bool:
    return a.op == "const" and b.op == "const"


def add(a: Term, b: Term) -> Term:
    w = a.width
    assert b.width == w
    if _c2(a, b):
        return const(a.value + b.value, w)
    if a.is_const and a.value == 0:
        return b
    if b.is_const and b.value == 0:
        return a
    # canonical order for commutative op: const on the left
    if b.is_const and not a.is_const:
        a, b = b, a
    return _mk("bvadd", bv(w), (a, b))


def sub(a: Term, b: Term) -> Term:
    w = a.width
    assert b.width == w
    if _c2(a, b):
        return const(a.value - b.value, w)
    if b.is_const and b.value == 0:
        return a
    if a is b:
        return const(0, w)
    return _mk("bvsub", bv(w), (a, b))


def mul(a: Term, b: Term) -> Term:
    w = a.width
    assert b.width == w
    if _c2(a, b):
        return const(a.value * b.value, w)
    for x, y in ((a, b), (b, a)):
        if x.is_const:
            if x.value == 0:
                return const(0, w)
            if x.value == 1:
                return y
    if b.is_const and not a.is_const:
        a, b = b, a
    return _mk("bvmul", bv(w), (a, b))


def udiv(a: Term, b: Term) -> Term:
    w = a.width
    if _c2(a, b):
        return const(0 if b.value == 0 else a.value // b.value, w)
    if b.is_const and b.value == 1:
        return a
    return _mk("bvudiv", bv(w), (a, b))


def sdiv(a: Term, b: Term) -> Term:
    w = a.width
    if _c2(a, b):
        if b.value == 0:
            return const(0, w)
        x, y = to_signed(a.value, w), to_signed(b.value, w)
        # EVM-style truncated division
        q = abs(x) // abs(y)
        if (x < 0) != (y < 0):
            q = -q
        return const(q, w)
    return _mk("bvsdiv", bv(w), (a, b))


def urem(a: Term, b: Term) -> Term:
    w = a.width
    if _c2(a, b):
        return const(0 if b.value == 0 else a.value % b.value, w)
    return _mk("bvurem", bv(w), (a, b))


def srem(a: Term, b: Term) -> Term:
    w = a.width
    if _c2(a, b):
        if b.value == 0:
            return const(0, w)
        x, y = to_signed(a.value, w), to_signed(b.value, w)
        r = abs(x) % abs(y)
        if x < 0:
            r = -r
        return const(r, w)
    return _mk("bvsrem", bv(w), (a, b))


def band(a: Term, b: Term) -> Term:
    w = a.width
    if _c2(a, b):
        return const(a.value & b.value, w)
    for x, y in ((a, b), (b, a)):
        if x.is_const:
            if x.value == 0:
                return const(0, w)
            if x.value == (1 << w) - 1:
                return y
    if a is b:
        return a
    if b.is_const and not a.is_const:
        a, b = b, a
    return _mk("bvand", bv(w), (a, b))


def bor(a: Term, b: Term) -> Term:
    w = a.width
    if _c2(a, b):
        return const(a.value | b.value, w)
    for x, y in ((a, b), (b, a)):
        if x.is_const:
            if x.value == 0:
                return y
            if x.value == (1 << w) - 1:
                return const((1 << w) - 1, w)
    if a is b:
        return a
    if b.is_const and not a.is_const:
        a, b = b, a
    return _mk("bvor", bv(w), (a, b))


def bxor(a: Term, b: Term) -> Term:
    w = a.width
    if _c2(a, b):
        return const(a.value ^ b.value, w)
    if a is b:
        return const(0, w)
    for x, y in ((a, b), (b, a)):
        if x.is_const and x.value == 0:
            return y
    if b.is_const and not a.is_const:
        a, b = b, a
    return _mk("bvxor", bv(w), (a, b))


def bnot(a: Term) -> Term:
    w = a.width
    if a.is_const:
        return const(~a.value, w)
    if a.op == "bvnot":
        return a.args[0]
    return _mk("bvnot", bv(w), (a,))


def neg(a: Term) -> Term:
    w = a.width
    if a.is_const:
        return const(-a.value, w)
    return _mk("bvneg", bv(w), (a,))


def shl(a: Term, b: Term) -> Term:
    w = a.width
    if _c2(a, b):
        return const(0 if b.value >= w else a.value << b.value, w)
    if b.is_const and b.value == 0:
        return a
    return _mk("bvshl", bv(w), (a, b))


def lshr(a: Term, b: Term) -> Term:
    w = a.width
    if _c2(a, b):
        return const(0 if b.value >= w else a.value >> b.value, w)
    if b.is_const and b.value == 0:
        return a
    return _mk("bvlshr", bv(w), (a, b))


def ashr(a: Term, b: Term) -> Term:
    w = a.width
    if _c2(a, b):
        x = to_signed(a.value, w)
        s = min(b.value, w - 1) if b.value >= 0 else w - 1
        return const(x >> s, w)
    if b.is_const and b.value == 0:
        return a
    return _mk("bvashr", bv(w), (a, b))


def bvexp(a: Term, b: Term) -> Term:
    """Modular exponentiation a**b mod 2^w.

    The reference models EXP with an uninterpreted ``Power`` function plus
    eagerly-asserted concrete axioms (exponent_function_manager.py:11-66); here
    it is a real operator every backend evaluates exactly.
    """
    w = a.width
    if _c2(a, b):
        return const(pow(a.value, b.value, 1 << w), w)
    if a.is_const and a.value == 1:
        return const(1, w)
    if b.is_const and b.value == 0:
        return const(1, w)
    if b.is_const and b.value == 1:
        return a
    return _mk("bvexp", bv(w), (a, b))


def concat2(a: Term, b: Term) -> Term:
    """a is the high part, b the low part (z3 convention)."""
    w = a.width + b.width
    if _c2(a, b):
        return const((a.value << b.width) | b.value, w)
    # Fuse adjacent extracts of the same base term
    if (
        a.op == "extract"
        and b.op == "extract"
        and a.args[0] is b.args[0]
        and a.aux[1] == b.aux[0] + 1
    ):
        return extract(a.aux[0], b.aux[1], a.args[0])
    return _mk("concat", bv(w), (a, b))


def concat(*parts: Term) -> Term:
    parts_l = list(parts)
    out = parts_l[0]
    for p in parts_l[1:]:
        out = concat2(out, p)
    return out


def extract(hi: int, lo: int, a: Term) -> Term:
    """Bits hi..lo inclusive (z3 argument order, reference bitvec_helper Extract)."""
    w = hi - lo + 1
    assert 0 <= lo <= hi < a.width, (hi, lo, a.width)
    if w == a.width:
        return a
    if a.is_const:
        return const(a.value >> lo, w)
    if a.op == "extract":
        return extract(a.aux[1] + hi, a.aux[1] + lo, a.args[0])
    if a.op == "concat":
        hi_part, lo_part = a.args
        if hi < lo_part.width:
            return extract(hi, lo, lo_part)
        if lo >= lo_part.width:
            return extract(hi - lo_part.width, lo - lo_part.width, hi_part)
    if a.op == "zext":
        inner = a.args[0]
        if hi < inner.width:
            return extract(hi, lo, inner)
        if lo >= inner.width:
            return const(0, w)
    return _mk("extract", bv(w), (a,), (hi, lo))


def zext(a: Term, extra: int) -> Term:
    if extra == 0:
        return a
    w = a.width + extra
    if a.is_const:
        return const(a.value, w)
    return _mk("zext", bv(w), (a,), extra)


def sext(a: Term, extra: int) -> Term:
    if extra == 0:
        return a
    w = a.width + extra
    if a.is_const:
        return const(to_signed(a.value, a.width), w)
    return _mk("sext", bv(w), (a,), extra)


# ---------------------------------------------------------------------------
# Predicates
# ---------------------------------------------------------------------------


def eq(a: Term, b: Term) -> Term:
    if a.sort is BOOL and b.sort is BOOL:
        return iff(a, b)
    assert a.sort == b.sort, (a.sort, b.sort)
    if a is b:
        return true()
    if _c2(a, b):
        return boolval(a.value == b.value)
    if b.is_const and not a.is_const:
        a, b = b, a
    # eq(const, ite(c, x, y)) with constant branches folds to c / ¬c — this is
    # the `If(cond, 1, 0) == 0` pattern every comparison+JUMPI produces
    if a.is_const and b.op == "ite":
        c, x, y = b.args
        if x.is_const and y.is_const:
            ex, ey = a.value == x.value, a.value == y.value
            if ex and ey:
                return true()
            if ex:
                return c
            if ey:
                return lnot(c)
            return false()
    return _mk("eq", BOOL, (a, b))


def ne(a: Term, b: Term) -> Term:
    return lnot(eq(a, b))


def ult(a: Term, b: Term) -> Term:
    if a is b:
        return false()
    if _c2(a, b):
        return boolval(a.value < b.value)
    if b.is_const and b.value == 0:
        return false()
    return _mk("ult", BOOL, (a, b))


def ule(a: Term, b: Term) -> Term:
    if a is b:
        return true()
    if _c2(a, b):
        return boolval(a.value <= b.value)
    return _mk("ule", BOOL, (a, b))


def ugt(a: Term, b: Term) -> Term:
    return ult(b, a)


def uge(a: Term, b: Term) -> Term:
    return ule(b, a)


def slt(a: Term, b: Term) -> Term:
    if a is b:
        return false()
    if _c2(a, b):
        return boolval(to_signed(a.value, a.width) < to_signed(b.value, b.width))
    return _mk("slt", BOOL, (a, b))


def sle(a: Term, b: Term) -> Term:
    if a is b:
        return true()
    if _c2(a, b):
        return boolval(to_signed(a.value, a.width) <= to_signed(b.value, b.width))
    return _mk("sle", BOOL, (a, b))


def sgt(a: Term, b: Term) -> Term:
    return slt(b, a)


def sge(a: Term, b: Term) -> Term:
    return sle(b, a)


# ---------------------------------------------------------------------------
# Boolean connectives
# ---------------------------------------------------------------------------


def land(*xs: Term) -> Term:
    flat = []
    for x in xs:
        if x.op == "const":
            if not x.aux:
                return false()
            continue
        if x.op == "and":
            flat.extend(x.args)
        else:
            flat.append(x)
    # dedupe preserving order
    seen, out = set(), []
    for x in flat:
        if x.tid not in seen:
            seen.add(x.tid)
            out.append(x)
    if not out:
        return true()
    if len(out) == 1:
        return out[0]
    return _mk("and", BOOL, tuple(out))


def lor(*xs: Term) -> Term:
    flat = []
    for x in xs:
        if x.op == "const":
            if x.aux:
                return true()
            continue
        if x.op == "or":
            flat.extend(x.args)
        else:
            flat.append(x)
    seen, out = set(), []
    for x in flat:
        if x.tid not in seen:
            seen.add(x.tid)
            out.append(x)
    if not out:
        return false()
    if len(out) == 1:
        return out[0]
    return _mk("or", BOOL, tuple(out))


def lnot(a: Term) -> Term:
    if a.op == "const":
        return boolval(not a.aux)
    if a.op == "not":
        return a.args[0]
    # push negation through comparisons: Not(a<b) == b<=a
    if a.op == "ult":
        return ule(a.args[1], a.args[0])
    if a.op == "ule":
        return ult(a.args[1], a.args[0])
    if a.op == "slt":
        return sle(a.args[1], a.args[0])
    if a.op == "sle":
        return slt(a.args[1], a.args[0])
    return _mk("not", BOOL, (a,))


def lxor(a: Term, b: Term) -> Term:
    if _c2(a, b):
        return boolval(bool(a.aux) != bool(b.aux))
    if a is b:
        return false()
    return _mk("xor", BOOL, (a, b))


def iff(a: Term, b: Term) -> Term:
    return lnot(lxor(a, b))


def implies(a: Term, b: Term) -> Term:
    return lor(lnot(a), b)


def ite(c: Term, a: Term, b: Term) -> Term:
    assert c.sort is BOOL
    assert a.sort == b.sort
    if c.op == "const":
        return a if c.aux else b
    if a is b:
        return a
    return _mk("ite", a.sort, (c, a, b))


# ---------------------------------------------------------------------------
# Arrays
# ---------------------------------------------------------------------------


def store(arr: Term, idx: Term, val: Term) -> Term:
    assert is_array_sort(arr.sort)
    _, dw, rw = arr.sort
    assert idx.width == dw and val.width == rw
    return _mk("store", arr.sort, (arr, idx, val))


def select(arr: Term, idx: Term) -> Term:
    assert is_array_sort(arr.sort)
    _, dw, rw = arr.sort
    assert idx.width == dw
    # read-over-write simplification where indices are decidable
    a = arr
    while a.op == "store":
        base, k, v = a.args
        if k is idx:
            return v
        if k.is_const and idx.is_const:
            if k.value == idx.value:
                return v
            a = base
            continue
        break
    if a.op == "const_array":
        return a.args[0]
    if a is not arr and a.op != "store":
        arr = a
    return _mk("select", bv(rw), (arr, idx))


# ---------------------------------------------------------------------------
# Keccak + uninterpreted functions
# ---------------------------------------------------------------------------


def keccak(data: Term) -> Term:
    """keccak256 of a byte-aligned bitvector, as a first-class 256-bit op."""
    assert data.width % 8 == 0
    if data.is_const:
        from mythril_tpu_torch.ops.keccak import keccak256_int

        return const(keccak256_int(data.value, data.width // 8), 256)
    return _mk("keccak", bv(256), (data,))


def apply_func(name: str, out_width: int, *args: Term) -> Term:
    """Generic uninterpreted function application (reference smt/function.py:7)."""
    sig = (name, tuple(a.width for a in args), out_width)
    return _mk("apply", bv(out_width), tuple(args), sig)


# ---------------------------------------------------------------------------
# DAG utilities
# ---------------------------------------------------------------------------


# Root-set -> post-order list.  Hash-consed DAGs make the walk a pure
# function of the root tids, and the solver's cheap tiers re-walk the SAME
# conjunction once per cached model — measured at ~40% of wide-frontier
# harvest time before memoization.  Terms are interned for process lifetime
# (see _INTERN), so holding them here adds no retention.
_TOPO_CACHE: Dict[tuple, list] = {}
_TOPO_CACHE_MAX = 1024


def topo_order(roots: Iterable[Term]):
    """Post-order (children first) over the DAG reachable from roots.

    Returns a memoized tuple (immutable: the cache is shared across
    callers, and a mutation would corrupt unrelated queries)."""
    roots = tuple(roots)
    key = tuple(r.tid for r in roots)
    cached = _TOPO_CACHE.get(key)
    if cached is not None:
        return cached
    seen = set()
    out = []
    stack = [(r, False) for r in roots]
    while stack:
        node, done = stack.pop()
        if done:
            out.append(node)
            continue
        if node.tid in seen:
            continue
        seen.add(node.tid)
        stack.append((node, True))
        for a in node.args:
            if a.tid not in seen:
                stack.append((a, False))
    if len(_TOPO_CACHE) >= _TOPO_CACHE_MAX:
        _TOPO_CACHE.clear()
    out = tuple(out)
    _TOPO_CACHE[key] = out
    return out


def free_vars(roots: Iterable[Term]):
    """All var/array_var leaves reachable from roots, in deterministic order."""
    out = []
    for t in topo_order(roots):
        if t.op in ("var", "array_var"):
            out.append(t)
    return out


def substitute(root: Term, mapping: Dict[Term, Term]) -> Term:
    """Rebuild ``root`` with leaves (or arbitrary subterms) replaced."""
    cache: Dict[int, Term] = {t.tid: r for t, r in mapping.items()}

    order = topo_order([root])
    for t in order:
        if t.tid in cache:
            continue
        if not t.args:
            cache[t.tid] = t
            continue
        new_args = tuple(cache[a.tid] for a in t.args)
        if all(n is o for n, o in zip(new_args, t.args)):
            cache[t.tid] = t
        else:
            cache[t.tid] = rebuild(t.op, t.sort, new_args, t.aux)
    return cache[root.tid]


def rebuild(op: str, sort, args: Tuple[Term, ...], aux) -> Term:
    """Re-apply a node's constructor so folding/rewrites fire on new children."""
    if op == "bvadd":
        return add(*args)
    if op == "bvsub":
        return sub(*args)
    if op == "bvmul":
        return mul(*args)
    if op == "bvudiv":
        return udiv(*args)
    if op == "bvsdiv":
        return sdiv(*args)
    if op == "bvurem":
        return urem(*args)
    if op == "bvsrem":
        return srem(*args)
    if op == "bvand":
        return band(*args)
    if op == "bvor":
        return bor(*args)
    if op == "bvxor":
        return bxor(*args)
    if op == "bvnot":
        return bnot(*args)
    if op == "bvneg":
        return neg(*args)
    if op == "bvshl":
        return shl(*args)
    if op == "bvlshr":
        return lshr(*args)
    if op == "bvashr":
        return ashr(*args)
    if op == "bvexp":
        return bvexp(*args)
    if op == "concat":
        return concat2(*args)
    if op == "extract":
        return extract(aux[0], aux[1], args[0])
    if op == "zext":
        return zext(args[0], aux)
    if op == "sext":
        return sext(args[0], aux)
    if op == "eq":
        return eq(*args)
    if op == "ult":
        return ult(*args)
    if op == "ule":
        return ule(*args)
    if op == "slt":
        return slt(*args)
    if op == "sle":
        return sle(*args)
    if op == "and":
        return land(*args)
    if op == "or":
        return lor(*args)
    if op == "not":
        return lnot(*args)
    if op == "xor":
        return lxor(*args)
    if op == "ite":
        return ite(*args)
    if op == "store":
        return store(*args)
    if op == "select":
        return select(*args)
    if op == "keccak":
        return keccak(*args)
    if op == "apply":
        return apply_func(aux[0], aux[2], *args)
    if op == "const_array":
        return const_array(sort[1], sort[2], args[0])
    return _mk(op, sort, args, aux)
