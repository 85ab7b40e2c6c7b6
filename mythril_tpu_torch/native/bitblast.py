"""Tier-2 exact solving: serialize term DAGs to the native CDCL bit-blaster.

Role (see mythril_tpu_torch/smt/solver.py): the probe answers most queries; this
tier supplies what probing cannot — exact UNSAT verdicts (stronger pruning
with zero recall loss) and models for hard SAT instances.  The reference
delegates the same questions to Z3 (mythril/laser/smt/solver/solver.py:51-66).

Abstractions applied before blasting, all sound for UNSAT (they only ever
ADD behaviors):
  * ``select`` over ``store``/``ite``/``const_array`` chains is rewritten
    into mux chains (same rewrite the device lowering performs);
  * base-array ``select``s, ``keccak``s and uninterpreted ``apply``s become
    fresh variables with Ackermann congruence constraints
    (equal arguments => equal results);
  * ``bvexp`` expands by square-and-multiply for constant exponents /
    power-of-two bases and is rejected otherwise.
SAT answers are therefore *candidates*: the caller validates the
reconstructed model with the exact concrete evaluator before trusting it
(solver.py does this), so keccak's abstraction can never produce a wrong SAT,
and UNSAT of the abstraction implies UNSAT of the original formula.

Keccak is additionally refined by CEGAR (the lazy analogue of the eager
hash axioms the reference installs via keccak_function_manager,
mythril/laser/ethereum/function_managers/keccak_function_manager.py): when
a candidate model assigns a keccak site a value different from the REAL
hash of its concretely-evaluated input, ``input == v => output ==
keccak(v)`` is asserted and the formula re-solved — so queries whose
verdict depends on hash semantics (hash-distinctness UNSAT proofs, models
routing through storage slots) converge to exact answers instead of
burning their budget on host-validation failures.
"""

from __future__ import annotations

import ctypes
import logging
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from mythril_tpu_torch.ops.keccak import keccak256_int
from mythril_tpu_torch.smt import terms
from mythril_tpu_torch.smt.concrete_eval import ArrayValue, Assignment, evaluate
from mythril_tpu_torch.smt.terms import Term

log = logging.getLogger(__name__)

SAT, UNSAT, UNKNOWN = "sat", "unsat", "unknown"

(
    OP_CONST, OP_VAR, OP_EQ, OP_AND, OP_OR, OP_NOT, OP_XOR, OP_ITE,
    OP_ADD, OP_SUB, OP_MUL, OP_UDIV, OP_UREM, OP_SDIV, OP_SREM,
    OP_BAND, OP_BOR, OP_BXOR, OP_BNOT, OP_NEG, OP_SHL, OP_LSHR, OP_ASHR,
    OP_CONCAT, OP_EXTRACT, OP_ZEXT, OP_SEXT, OP_ULT, OP_ULE, OP_SLT, OP_SLE,
) = range(31)

_BINOP = {
    "bvadd": OP_ADD, "bvsub": OP_SUB, "bvmul": OP_MUL, "bvudiv": OP_UDIV,
    "bvurem": OP_UREM, "bvsdiv": OP_SDIV, "bvsrem": OP_SREM,
    "bvand": OP_BAND, "bvor": OP_BOR, "bvxor": OP_BXOR,
    "bvshl": OP_SHL, "bvlshr": OP_LSHR, "bvashr": OP_ASHR,
    "ult": OP_ULT, "ule": OP_ULE, "slt": OP_SLT, "sle": OP_SLE,
    "xor": OP_XOR,
}

_MAX_NODES = 200_000


class Unsupported(Exception):
    """DAG contains structure the native tier cannot express exactly."""


_lib = None
_lib_tried = False


def _load():
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    from mythril_tpu_torch.native.build import library_path

    path = library_path()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
        lib.bb_solve.restype = ctypes.c_int32
        lib.bb_solve.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.c_double,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ]
        lib.bb_open.restype = ctypes.c_void_p
        lib.bb_open.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ]
        lib.bb_solve_assume.restype = ctypes.c_int32
        lib.bb_solve_assume.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.c_double,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ]
        lib.bb_close.restype = None
        lib.bb_close.argtypes = [ctypes.c_void_p]
        lib.bb_extend.restype = ctypes.c_int32
        lib.bb_extend.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ]
        _lib = lib
    except OSError as e:
        log.warning("native library failed to load: %s", e)
    return _lib


def available() -> bool:
    return _load() is not None


# ---------------------------------------------------------------------------
# Serialization
# ---------------------------------------------------------------------------


class _Tape:
    def __init__(self):
        self.records: List[Tuple[int, int, int, int, int, int, int]] = []
        self.consts = bytearray()
        # original Term -> tape node id
        self.node_of: Dict[int, int] = {}
        # fresh var bookkeeping, in tape order: (kind, payload)
        #   ("scalar", term) | ("select", array_term, idx_term)
        #   | ("keccak", input_term) | ("apply", term)
        self.var_meta: List[tuple] = []
        # Ackermann groups
        self.selects: Dict[int, List[Tuple[int, int, Term]]] = {}  # arr tid -> [(idx node, var node, idx term)]
        self.keccaks: List[Tuple[int, int, Term]] = []  # (input node, var node, input term)
        self.applies: Dict[tuple, List[Tuple[List[int], int]]] = {}
        self.roots: List[int] = []

    def emit(self, op, width, a0=-1, a1=-1, a2=-1, x0=0, x1=0) -> int:
        self.records.append((op, width, a0, a1, a2, x0, x1))
        if len(self.records) > _MAX_NODES:
            raise Unsupported("tape too large")
        return len(self.records) - 1

    def const(self, value: int, width: int) -> int:
        nbytes = (width + 7) // 8
        off = len(self.consts)
        self.consts += int(value).to_bytes(nbytes, "little")
        return self.emit(OP_CONST, width, x0=off, x1=nbytes)

    def fresh(self, width: int, meta: tuple) -> int:
        node = self.emit(OP_VAR, width)
        self.var_meta.append(meta)
        return node


def _width(t: Term) -> int:
    return 1 if t.sort is terms.BOOL else t.width


def _lower_select(tape: _Tape, arr: Term, idx_node: int, idx_term: Term) -> int:
    """select(arr, idx) -> tape node, flattening store/ite chains."""
    rng_w = arr.sort[2]
    if arr.op == "store":
        base, s_idx, s_val = arr.args
        below = _lower_select(tape, base, idx_node, idx_term)
        hit = tape.emit(OP_EQ, 1, _node(tape, s_idx), idx_node)
        return tape.emit(OP_ITE, rng_w, hit, _node(tape, s_val), below)
    if arr.op == "ite":
        c, a, b = arr.args
        then = _lower_select(tape, a, idx_node, idx_term)
        els = _lower_select(tape, b, idx_node, idx_term)
        return tape.emit(OP_ITE, rng_w, _node(tape, c), then, els)
    if arr.op == "const_array":
        return _node(tape, arr.args[0])
    if arr.op == "array_var":
        var = tape.fresh(rng_w, ("select", arr, idx_term))
        tape.selects.setdefault(arr.tid, []).append((idx_node, var, idx_term))
        return var
    raise Unsupported(f"array op {arr.op}")


def _node(tape: _Tape, t: Term) -> int:
    return tape.node_of[t.tid]


def _serialize_node(tape: _Tape, t: Term) -> Optional[int]:
    op, a = t.op, t.args
    if op in ("array_var", "const_array", "store"):
        return None  # handled structurally at their select sites
    if op == "ite" and terms.is_array_sort(t.sort):
        return None  # consumed by select flattening
    w = _width(t)
    if op == "const":
        if t.sort is terms.BOOL:
            return tape.const(1 if t.aux else 0, 1)
        return tape.const(t.aux, w)
    if op == "var":
        return tape.fresh(w, ("scalar", t))
    if op == "select":
        return _lower_select(tape, a[0], _node(tape, a[1]), a[1])
    if op == "eq":
        if terms.is_array_sort(a[0].sort):
            raise Unsupported("array equality")
        return tape.emit(OP_EQ, 1, _node(tape, a[0]), _node(tape, a[1]))
    if op in ("and", "or"):
        code = OP_AND if op == "and" else OP_OR
        node = _node(tape, a[0])
        for x in a[1:]:
            node = tape.emit(code, 1, node, _node(tape, x))
        return node
    if op == "not":
        return tape.emit(OP_NOT, 1, _node(tape, a[0]))
    if op == "ite":
        return tape.emit(
            OP_ITE, w, _node(tape, a[0]), _node(tape, a[1]), _node(tape, a[2])
        )
    if op == "bvnot":
        return tape.emit(OP_BNOT, w, _node(tape, a[0]))
    if op == "bvneg":
        return tape.emit(OP_NEG, w, _node(tape, a[0]))
    if op == "concat":
        return tape.emit(OP_CONCAT, w, _node(tape, a[0]), _node(tape, a[1]))
    if op == "extract":
        hi, lo = t.aux
        return tape.emit(OP_EXTRACT, w, _node(tape, a[0]), x0=hi, x1=lo)
    if op == "zext":
        return tape.emit(OP_ZEXT, w, _node(tape, a[0]))
    if op == "sext":
        return tape.emit(OP_SEXT, w, _node(tape, a[0]))
    if op == "bvexp":
        return _serialize_exp(tape, t)
    if op == "keccak":
        var = tape.fresh(256, ("keccak", a[0]))
        tape.keccaks.append((_node(tape, a[0]), var, a[0]))
        return var
    if op == "apply":
        var = tape.fresh(w, ("apply", t))
        key = (t.aux, len(a))
        tape.applies.setdefault(key, []).append(
            ([_node(tape, x) for x in a], var)
        )
        return var
    code = _BINOP.get(op)
    if code is not None:
        return tape.emit(code, w, _node(tape, a[0]), _node(tape, a[1]))
    raise Unsupported(f"op {op}")


def _serialize_exp(tape: _Tape, t: Term) -> int:
    base, expo = t.args
    w = t.width
    if expo.is_const:
        e = expo.value
        if e > 64:
            raise Unsupported("huge constant exponent")
        result = tape.const(1, w)
        b = _node(tape, base)
        for bit in reversed(range(max(1, e.bit_length()))):
            result = tape.emit(OP_MUL, w, result, result)
            if (e >> bit) & 1:
                result = tape.emit(OP_MUL, w, result, b)
        return result
    if base.is_const and base.value != 0 and (base.value & (base.value - 1)) == 0:
        # (2^k)^e == 1 << (k*e), but k*e must be computed WITHOUT wrapping:
        # guard on e < ceil(w/k) (above which the true result is 0); inside
        # the guard k*e < w so the w-bit multiply is exact.
        k = base.value.bit_length() - 1
        if k == 0:  # base == 1
            return tape.const(1, w)
        bound = (w + k - 1) // k
        e_node = _node(tape, expo)
        e_small = tape.emit(OP_ULT, 1, e_node, tape.const(bound, w))
        shift = (
            tape.emit(OP_MUL, w, tape.const(k, w), e_node)
            if k != 1
            else e_node
        )
        shifted = tape.emit(OP_SHL, w, tape.const(1, w), shift)
        return tape.emit(OP_ITE, w, e_small, shifted, tape.const(0, w))
    raise Unsupported("bvexp with symbolic base and exponent")


def _add_congruence(tape: _Tape, pairs: List[Tuple[List[int], int]]):
    """For every pair of sites: args equal => results equal."""
    for i in range(len(pairs)):
        for j in range(i + 1, len(pairs)):
            _add_congruence_pair(tape, pairs[i], pairs[j])


def _add_congruence_pair(
    tape: _Tape, a: Tuple[List[int], int], b: Tuple[List[int], int]
):
    args_i, var_i = a
    args_j, var_j = b
    eqs = [tape.emit(OP_EQ, 1, x, y) for x, y in zip(args_i, args_j)]
    all_eq = eqs[0]
    for e in eqs[1:]:
        all_eq = tape.emit(OP_AND, 1, all_eq, e)
    out_eq = tape.emit(OP_EQ, 1, var_i, var_j)
    na = tape.emit(OP_NOT, 1, all_eq)
    tape.roots.append(tape.emit(OP_OR, 1, na, out_eq))


def _add_keccak_value(tape: _Tape, site: int, inp_val: int, true_hash: int):
    """Assert ``input == inp_val => output == keccak(inp_val)`` for one
    keccak site — a tautology of the real hash function (sound to add), and
    the lazy analogue of Z3's eager hash-value axioms: only the input values
    an actual model proposes ever get their hash pinned."""
    inp_node, var_node, inp_term = tape.keccaks[site]
    eq_in = tape.emit(OP_EQ, 1, inp_node, tape.const(inp_val, _width(inp_term)))
    eq_out = tape.emit(OP_EQ, 1, var_node, tape.const(true_hash, 256))
    tape.roots.append(
        tape.emit(OP_OR, 1, tape.emit(OP_NOT, 1, eq_in), eq_out)
    )


def _norm_idx(t: Term) -> Tuple[Optional[int], int]:
    """(base term id, constant offset) so provably-distinct indices can skip
    congruence: word reads are 32 selects at ``base + j`` — all C(32,2)
    pairwise constraints are identically true and need no clauses."""
    if t.is_const:
        return (None, t.value)
    if t.op == "bvadd":
        a, b = t.args
        if a.is_const:
            return (b.tid, a.value)
        if b.is_const:
            return (a.tid, b.value)
    return (t.tid, 0)


def _provably_distinct(t1: Term, t2: Term) -> bool:
    b1, o1 = _norm_idx(t1)
    b2, o2 = _norm_idx(t2)
    return b1 == b2 and o1 != o2


def _add_select_congruence(tape: _Tape) -> None:
    """Eager pairwise congruence for base-array selects, skipping pairs
    whose indices can never collide (same symbolic base, different constant
    offset — the dominant case for byte-addressed calldata/memory words)."""
    for sites in tape.selects.values():
        for i in range(len(sites)):
            for j in range(i + 1, len(sites)):
                idx_i, var_i, t_i = sites[i]
                idx_j, var_j, t_j = sites[j]
                if _provably_distinct(t_i, t_j):
                    continue
                _add_congruence_pair(tape, ([idx_i], var_i), ([idx_j], var_j))


def serialize(
    conjuncts: Sequence[Term],
    extra: Sequence[Term] = (),
    lazy_selects: bool = False,
) -> _Tape:
    """Serialize ``conjuncts`` as roots; ``extra`` terms (e.g. optimization
    objectives) are included in the DAG walk without being asserted.

    ``lazy_selects``: emit NO select-congruence constraints.  Dropping them
    only ADDS behaviors, so UNSAT stays sound; SAT models may violate
    congruence and must be refined (see ``solve``'s CEGAR loop).  Engine
    queries carry hundreds of select sites whose eager O(n^2) pairs blow
    the clause budget — refinement typically needs a handful of pairs."""
    tape = _Tape()
    for t in terms.topo_order(list(conjuncts) + list(extra)):
        node = _serialize_node(tape, t)
        if node is not None:
            tape.node_of[t.tid] = node
    tape.roots.extend(_node(tape, c) for c in conjuncts)
    if not lazy_selects:
        _add_select_congruence(tape)
    if tape.keccaks:
        _add_congruence(tape, [([inp], var) for inp, var, _ in tape.keccaks])
    for sites in tape.applies.values():
        _add_congruence(tape, sites)
    return tape


# ---------------------------------------------------------------------------
# Model reconstruction
# ---------------------------------------------------------------------------


def _rebuild_assignment(
    tape: _Tape, model: bytes
) -> Tuple[Assignment, List[Tuple[int, int, int]], List[Tuple[int, int, int]]]:
    """Parse packed VAR bits, then resolve array/UF sites in topo order.

    Tape order IS topo order of the original DAG, so by the time a select's
    value is installed every sub-select inside its index expression has
    already been written into the ArrayValue backing — concrete evaluation
    of the index under the partial assignment is exact.

    Returns (assignment, violations, kec_mismatches):

    * ``violations`` lists select-site pairs ``(arr_tid, site_i, site_j)``
      that read the SAME concrete index but were assigned DIFFERENT values
      — possible only under lazy congruence
      (``serialize(..., lazy_selects=True)``); the CEGAR loop in ``solve``
      asserts exactly those pairs and re-solves.
    * ``kec_mismatches`` lists keccak sites ``(site, input_value, true_hash)``
      whose input evaluates concretely under the assignment but whose model
      value differs from the REAL keccak256 of that input.  The CEGAR loop
      asserts ``input == value => output == keccak(value)`` — a fact of the
      actual hash function, so soundness is untouched — and re-solves; the
      refined model then carries real hash values (and hash-distinctness of
      distinct concrete inputs follows for free), closing the queries whose
      verdict depends on hash semantics instead of burning their budget on
      host-validation failures.
    """
    values: List[int] = []
    off = 0
    for op, width, *_ in tape.records:
        if op != OP_VAR:
            continue
        nbytes = (width + 7) // 8
        values.append(int.from_bytes(model[off : off + nbytes], "little"))
        off += nbytes
    asg = Assignment()
    deferred = []  # (kind, payload, value) resolved in tape order
    for (meta, value) in zip(tape.var_meta, values):
        kind = meta[0]
        if kind == "scalar":
            t = meta[1]
            asg.scalars[t] = bool(value) if t.sort is terms.BOOL else value
        else:
            deferred.append((meta, value))
    violations: List[Tuple[int, int, int]] = []
    kec_mismatches: List[Tuple[int, int, int]] = []
    site_no: Dict[int, int] = {}
    kec_site = 0
    writer: Dict[Tuple[int, int], Tuple[int, int]] = {}
    for meta, value in deferred:
        kind = meta[0]
        if kind == "select":
            _, arr, idx_term = meta
            si = site_no.get(arr.tid, 0)
            site_no[arr.tid] = si + 1
            idx_val = evaluate([idx_term], asg)[idx_term]
            prev = writer.get((arr.tid, idx_val))
            if prev is not None:
                if prev[1] != value:
                    violations.append((arr.tid, prev[0], si))
                continue  # first writer's value stands
            writer[(arr.tid, idx_val)] = (si, value)
            asg.arrays.setdefault(arr, ArrayValue()).backing[idx_val] = value
        elif kind == "apply":
            t = meta[1]
            arg_vals = tuple(evaluate([x], asg)[x] for x in t.args)
            asg.ufs[(t.aux, arg_vals)] = value
        elif kind == "keccak":
            # NOT installed in asg — validation recomputes real hashes.
            # Instead, compare the model's value against the true hash of
            # the concretely-evaluated input (evaluate() resolves nested
            # keccaks to their REAL hashes, so chained sites converge in
            # one refinement round each).
            si, kec_site = kec_site, kec_site + 1
            inp = meta[1]
            try:
                inp_val = evaluate([inp], asg)[inp]
            except NotImplementedError:
                continue
            true_hash = keccak256_int(inp_val, _width(inp) // 8)
            if value != true_hash:
                kec_mismatches.append((si, inp_val, true_hash))
    return asg, violations, kec_mismatches


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def _run_solver(lib, tape: _Tape, timeout_s: float) -> Tuple[int, bytes]:
    rec = np.asarray(tape.records, dtype=np.int32).reshape(-1)
    consts = np.frombuffer(bytes(tape.consts) or b"\x00", dtype=np.uint8)
    roots = np.asarray(tape.roots, dtype=np.int32)
    model_size = sum(
        (w + 7) // 8 for op, w, *_ in tape.records if op == OP_VAR
    )
    model = np.zeros(max(1, model_size), dtype=np.uint8)
    status = lib.bb_solve(
        rec.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(tape.records),
        consts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(consts),
        roots.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(roots),
        float(timeout_s),
        model.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(model),
    )
    return status, model.tobytes()


# Refinement rounds are cheap (a re-blast costs well under a second at
# engine query sizes) and byte-addressed aliasing chains legitimately need
# several: a wrapped-pointer UNSAT proof on the BECToken shape converges in
# 5 rounds / ~4s where eager congruence exceeded the clause budget outright.
_CEGAR_ROUNDS = 12

# Keccak value refinement is value-ENUMERATING: a query whose hash demand
# no input can meet proposes a fresh input every round, so it must be
# bounded separately (distinctness proofs and chained hashes converge in
# 1-2 rounds; past this cap the answer degrades to UNKNOWN exactly as the
# pre-CEGAR code did after one round).
_KECCAK_ROUNDS = 3


def _model_validates(conjuncts: Sequence[Term], asg: Assignment) -> bool:
    """Evaluate the conjunction under the model with REAL keccak semantics.

    A model whose keccak CNF values are fake but whose real-hash evaluation
    still satisfies every conjunct is a perfectly good model (the formula
    never observed the fake values) — returning it immediately keeps the
    pre-CEGAR fast path; refinement only runs when hash semantics actually
    bite."""
    try:
        vals = evaluate(list(conjuncts), asg)
        return all(vals[c] for c in conjuncts)
    except Exception:
        return False


def solve(
    conjuncts: Sequence[Term], timeout_s: float
) -> Tuple[str, Optional[Assignment]]:
    """Exact solve; returns (status, assignment-or-None).

    Select congruence is LAZY (CEGAR): the first blast asserts none of the
    O(n^2) select-congruence pairs (sound for UNSAT — dropping constraints
    only adds behaviors); when a SAT model assigns different values to two
    selects whose indices evaluate equal, exactly those pairs are asserted
    and the formula re-solved.  Engine-scale queries carry hundreds of
    select sites; eager congruence used to exceed the clause budget, while
    refinement virtually always needs zero or a handful of pairs.

    SAT models are reconstructed but NOT validated here — the caller owns
    validation (mythril_tpu_torch/smt/solver.py re-checks with concrete_eval).
    """
    import time as _time

    lib = _load()
    if lib is None or timeout_s <= 0:
        return UNKNOWN, None
    deadline = _time.perf_counter() + timeout_s
    refine: List[Tuple[int, int, int]] = []
    kec_refine: List[Tuple[int, int, int]] = []
    kec_done: set = set()
    kec_rounds = 0
    try:
        # one serialization: the tape is append-only, so refinement rounds
        # just add congruence pairs to the same records/roots
        tape = serialize(conjuncts, lazy_selects=True)
    except Unsupported as e:
        log.debug("native tier: %s", e)
        return UNKNOWN, None
    for _round in range(_CEGAR_ROUNDS):
        try:
            for arr_tid, i, j in refine:
                sites = tape.selects.get(arr_tid)
                if sites is None or i >= len(sites) or j >= len(sites):
                    continue
                idx_i, var_i, _ = sites[i]
                idx_j, var_j, _ = sites[j]
                _add_congruence_pair(tape, ([idx_i], var_i), ([idx_j], var_j))
            for site, inp_val, true_hash in kec_refine:
                _add_keccak_value(tape, site, inp_val, true_hash)
        except Unsupported as e:
            # tape cap reached mid-refinement: degrade instead of raising
            # into the engine query (the session path does the same)
            log.debug("refinement hit tape cap: %s", e)
            return UNKNOWN, None
        refine, kec_refine = [], []
        remaining = deadline - _time.perf_counter()
        if remaining <= 0:
            return UNKNOWN, None
        status, model = _run_solver(lib, tape, remaining)
        if status == 0:
            return UNSAT, None
        if status != 1:
            return UNKNOWN, None
        try:
            asg, violations, kec_mm = _rebuild_assignment(tape, model)
        except Exception as e:  # reconstruction must never crash the solver
            log.debug("native model reconstruction failed: %s", e)
            return UNKNOWN, None
        # an already-asserted (site, input) pair cannot recur with a wrong
        # value in a model of the CNF; the guard protects the loop anyway
        kec_mm = [
            m for m in kec_mm if (m[0], m[1]) not in kec_done
        ]
        if not violations and not kec_mm:
            return SAT, asg
        if not violations and kec_mm and _model_validates(conjuncts, asg):
            return SAT, asg  # fake hash values were never observed
        # the keccak cap counts only PURE keccak rounds: a round that also
        # refines select congruence is productive regardless of whether the
        # model proposed a fresh hash input alongside
        if kec_mm and not violations:
            kec_rounds += 1
            if kec_rounds > _KECCAK_ROUNDS:
                return UNKNOWN, None
        # violated pairs are by construction not yet asserted (an asserted
        # pair cannot be violated by a model of the CNF)
        refine = violations
        kec_refine = kec_mm
        kec_done.update((m[0], m[1]) for m in kec_mm)
    return UNKNOWN, None


# ---------------------------------------------------------------------------
# Incremental session: bound refinement for Optimize
# ---------------------------------------------------------------------------


class OptimizeSession:
    """Blast a conjunction ONCE and answer many objective-bound queries.

    For each objective the tape gains a fresh bound vector ``M`` plus enable
    booleans wired as ``en_le => obj <= M``, ``en_ge => M <= obj``,
    ``en_eq => obj == M``; a query assumes one enable literal and M's bits.
    The CDCL state (learned clauses, activity, phases) persists across
    queries, so the Optimize binary search pays circuit construction once
    instead of once per bound — the z3-incremental-optimize analogue the
    reference gets from ``z3.Optimize`` (mythril/analysis/solver.py:216-256).

    ``guarded`` terms are additionally compiled behind per-term enable
    literals (``en_i => guarded[i]``): one blast serves a whole family of
    sibling queries that differ by one conjunct each — the transaction-end
    issue-confirmation gate, where every parked issue shares the full path
    prefix (analysis/potential_issues.py).

    UNSAT answers are exact (abstractions only add behaviors, see module
    docstring); SAT models must be validated by the caller exactly like
    ``solve``'s.
    """

    def __init__(
        self,
        conjuncts: Sequence[Term],
        objectives: Sequence[Term] = (),
        guarded: Sequence[Term] = (),
    ):
        lib = _load()
        if lib is None:
            raise Unsupported("native library unavailable")
        # select congruence is lazy here too: engine-scale conjunctions
        # (wide-mul overflow encodings + hundreds of select sites) exceed
        # the clause budget eagerly; violated pairs are appended to the
        # LIVE session via bb_extend, keeping all learned clauses
        tape = serialize(
            conjuncts,
            extra=list(objectives) + list(guarded),
            lazy_selects=True,
        )
        self._conjuncts = list(conjuncts)
        self._objectives = list(objectives)
        self._guarded = list(guarded)
        self._controls = []  # per objective: (m_node, width, {op: en_node})
        for i, obj in enumerate(objectives):
            w = obj.width
            obj_node = tape.node_of[obj.tid]
            m_var = terms.var(f"__optimize_bound_{i}", w)
            m_node = tape.fresh(w, ("scalar", m_var))
            ens = {}
            for op_name, cmp_node in (
                ("le", tape.emit(OP_ULE, 1, obj_node, m_node)),
                ("ge", tape.emit(OP_ULE, 1, m_node, obj_node)),
                ("eq", tape.emit(OP_EQ, 1, obj_node, m_node)),
            ):
                en_var = terms.var(f"__optimize_en_{op_name}_{i}", 1)
                en_node = tape.fresh(1, ("scalar", en_var))
                not_en = tape.emit(OP_NOT, 1, en_node)
                tape.roots.append(tape.emit(OP_OR, 1, not_en, cmp_node))
                ens[op_name] = en_node
            self._controls.append((m_node, w, ens))
        self._guards = []  # per guarded term: its enable node
        for i, g in enumerate(guarded):
            g_node = tape.node_of[g.tid]
            en_var = terms.var(f"__guard_en_{i}", 1)
            en_node = tape.fresh(1, ("scalar", en_var))
            not_en = tape.emit(OP_NOT, 1, en_node)
            tape.roots.append(tape.emit(OP_OR, 1, not_en, g_node))
            self._guards.append(en_node)
        self._tape = tape
        rec = np.asarray(tape.records, dtype=np.int32).reshape(-1)
        consts = np.frombuffer(bytes(tape.consts) or b"\x00", dtype=np.uint8)
        roots = np.asarray(tape.roots, dtype=np.int32)
        self._model_size = sum(
            (w + 7) // 8 for op, w, *_ in tape.records if op == OP_VAR
        )
        self._lib = lib
        self._handle = lib.bb_open(
            rec.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(tape.records),
            consts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            len(consts),
            roots.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(roots),
        )
        if not self._handle:
            raise Unsupported("session open failed")

    def solve(
        self,
        bounds: Sequence[Tuple[int, str, int]],
        timeout_s: float,
        enable: Sequence[int] = (),
    ) -> Tuple[str, Optional[Assignment]]:
        """Solve under objective bounds [(obj_index, 'le'|'ge'|'eq', value)]
        and with the given guarded terms enabled (indices into ``guarded``).

        Congruence-violating models trigger in-place refinement (violated
        pairs appended to the live session via bb_extend) and a re-solve
        within the same timeout.  Returns (status, assignment-or-None); SAT
        models are congruence-clean but otherwise unvalidated (caller
        validates with the exact evaluator, as for ``solve``)."""
        import time as _time

        if self._handle is None:
            return UNKNOWN, None
        deadline = _time.perf_counter() + timeout_s
        kec_done: set = set()
        kec_rounds = 0
        for _round in range(_CEGAR_ROUNDS):
            remaining = deadline - _time.perf_counter()
            if remaining <= 0:
                return UNKNOWN, None
            status, asg, violations, kec_mm = self._solve_once(
                bounds, remaining, enable
            )
            kec_mm = [m for m in kec_mm if (m[0], m[1]) not in kec_done]
            if status != SAT or (not violations and not kec_mm):
                return status, asg
            if (
                not violations
                and kec_mm
                and self._query_validates(asg, bounds, enable)
            ):
                return SAT, asg  # fake hash values were never observed
            if kec_mm and not violations:  # pure keccak rounds only
                kec_rounds += 1
                if kec_rounds > _KECCAK_ROUNDS:
                    return UNKNOWN, None
            kec_done.update((m[0], m[1]) for m in kec_mm)
            ext = self._extend_refinements(violations, kec_mm)
            if ext == 0:
                return UNSAT, None  # refinement constraints closed the formula
            if ext != 1:
                return UNKNOWN, None
        return UNKNOWN, None

    def _query_validates(self, asg, bounds, enable) -> bool:
        """Real-keccak validation of THIS query: base conjuncts, the enabled
        guarded terms, and the assumed objective bounds must all hold."""
        checks = list(self._conjuncts) + [self._guarded[i] for i in enable]
        if not _model_validates(checks, asg):
            return False
        try:
            for idx, op_name, value in bounds:
                obj = self._objectives[idx]
                got = evaluate([obj], asg)[obj]
                if op_name == "le" and not got <= value:
                    return False
                if op_name == "ge" and not got >= value:
                    return False
                if op_name == "eq" and got != value:
                    return False
        except Exception:
            return False
        return True

    def _solve_once(
        self,
        bounds: Sequence[Tuple[int, str, int]],
        timeout_s: float,
        enable: Sequence[int],
    ):
        assume: List[int] = []
        for gi in enable:
            assume.append((self._guards[gi] << 16) | 1)
        for idx, op_name, value in bounds:
            m_node, w, ens = self._controls[idx]
            assume.append((ens[op_name] << 16) | 1)
            for bit in range(w):
                assume.append(
                    (m_node << 16) | (bit << 1) | ((value >> bit) & 1)
                )
        arr = np.asarray(assume, dtype=np.int64)
        model = np.zeros(max(1, self._model_size), dtype=np.uint8)
        status = self._lib.bb_solve_assume(
            self._handle,
            arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(arr),
            float(timeout_s),
            model.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            len(model),
        )
        if status == 0:
            return UNSAT, None, (), ()
        if status != 1:
            return UNKNOWN, None, (), ()
        try:
            asg, violations, kec_mm = _rebuild_assignment(
                self._tape, model.tobytes()
            )
            return SAT, asg, violations, kec_mm
        except Exception as e:
            log.debug("session model reconstruction failed: %s", e)
            return UNKNOWN, None, (), ()

    def _extend_refinements(self, violations, kec_mm=()) -> int:
        """Append refinement constraints (select-congruence pairs and/or
        keccak value implications) to the live native session.  The tape is
        append-only; only the delta records and delta roots cross the
        boundary (const offsets are absolute into the full consts buffer,
        which is re-passed).  Returns the bb_extend status: 1 ok, 0 formula
        now unsat, -1 unusable."""
        rec_mark = len(self._tape.records)
        root_mark = len(self._tape.roots)
        try:
            for arr_tid, i, j in violations:
                sites = self._tape.selects.get(arr_tid)
                if not sites or i >= len(sites) or j >= len(sites):
                    continue
                idx_i, var_i, _ = sites[i]
                idx_j, var_j, _ = sites[j]
                _add_congruence_pair(
                    self._tape, ([idx_i], var_i), ([idx_j], var_j)
                )
            for site, inp_val, true_hash in kec_mm:
                _add_keccak_value(self._tape, site, inp_val, true_hash)
        except Unsupported as e:
            # tape cap reached mid-refinement: the callers treat -1 as
            # UNKNOWN and degrade; an exception here would abort the whole
            # transaction-end issue sweep
            log.debug("session refinement hit tape cap: %s", e)
            return -1
        n_new = len(self._tape.records) - rec_mark
        new_roots = self._tape.roots[root_mark:]
        if n_new == 0 and not new_roots:
            return -1
        delta = np.asarray(
            self._tape.records[rec_mark:], dtype=np.int32
        ).reshape(-1)
        consts = np.frombuffer(
            bytes(self._tape.consts) or b"\x00", dtype=np.uint8
        )
        roots = np.asarray(new_roots, dtype=np.int32)
        return self._lib.bb_extend(
            self._handle,
            delta.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n_new,
            consts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            len(consts),
            roots.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(roots),
        )

    def close(self) -> None:
        if self._handle is not None:
            self._lib.bb_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # pragma: no cover - GC safety net
        try:
            self.close()
        except Exception:
            pass
