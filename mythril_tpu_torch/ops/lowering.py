"""Per-conjunction lowering: a term DAG evaluated over a batch of candidates.

The port's counterpart of ``mythril_tpu/ops/lowering.py``.  The solver
(``smt/solver.py``) sends it every conjunction the tape VM refuses
(``TapeUnsupported``: a tape too long, a keccak preimage the tape cannot
take, a wide constant), as the JAX package does.  The JAX package compiles
each such DAG into one jitted function; here the DAG is compiled once into a
flat node table (``LoweringProgram``) that one hand-written kernel walks:

* ``run_lowering`` on CUDA tensors launches ``csrc/lowering.cu`` (one
  thread per candidate walks the node table, values in a limb-major arena
  in device memory) and, for keccak nodes, ``csrc/keccak_f1600.cu``;
* ``run_lowering_reference`` is the plain PyTorch version: JAX's ``run``
  written on ``ops/bitvec.py``, node by node over the DAG.  ``run_lowering``
  takes it for CPU tensors.

Values are 16-bit limbs at each term's own width (``ops/bitvec.py``'s
layout), bools one limb holding 0 or 1.  Semantics are those of
``smt/concrete_eval.py``.  Arrays: a select over a store chain becomes a mux
chain down to the base array, whose lookup reads a per-candidate finite
table (idx/val/valid rows and a default), the ``ArrayValue`` model.

Refusals are decided here, when the DAG is compiled: ``compile_conjunction``
raises ``LoweringUnsupported`` for an uninterpreted ``apply`` (JAX's
``_collect``) and for what JAX's trace fails on at the first evaluation: an
equality of arrays, and any op ``_lower_node`` does not list.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mythril_tpu_torch.device import resolve
from mythril_tpu_torch.ops import bitvec as bv
from mythril_tpu_torch.ops import keccak_torch
from mythril_tpu_torch.smt import terms
from mythril_tpu_torch.smt.terms import Term


class LoweringUnsupported(Exception):
    """DAG contains a node the device evaluator cannot express."""


# the ops ``_lower_node`` lowers (array-sorted ones build a structure)
_LOWERED_OPS = {
    "bvadd", "bvsub", "bvmul", "bvudiv", "bvsdiv", "bvurem", "bvsrem", "bvexp",
    "bvand", "bvor", "bvxor", "bvnot", "bvneg", "bvshl", "bvlshr", "bvashr",
    "concat", "extract", "zext", "sext", "eq", "ult", "ule", "slt", "sle",
    "and", "or", "not", "xor", "keccak", "const", "const_array", "store", "select", "ite",
}


# ---------------------------------------------------------------------------
# Compiled object
# ---------------------------------------------------------------------------


class CompiledConjunction:
    """A conjunction compiled for batched evaluation.

    Call :meth:`evaluate_batch` with a list of Assignments and a device;
    returns a ``[B, C]`` bool matrix (candidate x conjunct truth)."""

    def __init__(self, conjuncts: Sequence[Term], bv_vars: List[Term],
                 bool_vars: List[Term], array_vars: List[Term]):
        self.conjuncts = list(conjuncts)
        self.bv_vars = bv_vars
        self.bool_vars = bool_vars
        self.array_vars = array_vars
        self._program: Optional[LoweringProgram] = None

    @property
    def program(self) -> "LoweringProgram":
        """The kernel's node table, assembled at first use."""
        if self._program is None:
            self._program = LoweringProgram(self)
        return self._program

    def evaluate_batch(self, assignments, device=None) -> np.ndarray:
        """[B, C] truth matrix for the given candidate assignments, on
        ``device`` (None: the CUDA card)."""
        scalars, bools, tabs = pack_assignments(self, assignments, resolve(device))
        return run_lowering(self, scalars, bools, tabs).cpu().numpy()


# ---------------------------------------------------------------------------
# Compilation
# ---------------------------------------------------------------------------


def _collect(conjuncts: Sequence[Term]):
    """Free variables in deterministic (topo) order + lowerability check."""
    bv_vars: List[Term] = []
    bool_vars: List[Term] = []
    array_vars: List[Term] = []
    for t in terms.topo_order(conjuncts):
        if t.op == "apply":
            raise LoweringUnsupported("uninterpreted function application")
        if t.op == "var":
            (bool_vars if t.sort is terms.BOOL else bv_vars).append(t)
        elif t.op == "array_var":
            array_vars.append(t)
        elif t.op not in _LOWERED_OPS:
            raise LoweringUnsupported(f"op {t.op}")
        elif t.op == "eq" and terms.is_array_sort(t.args[0].sort):
            raise LoweringUnsupported("array equality")
    return bv_vars, bool_vars, array_vars


def compile_conjunction(conjuncts: Sequence[Term]) -> CompiledConjunction:
    """The batched evaluator for ``And(conjuncts)``; raises
    ``LoweringUnsupported`` for a DAG the JAX package's lowering cannot
    evaluate."""
    conjuncts = list(conjuncts)
    return CompiledConjunction(conjuncts, *_collect(conjuncts))


# ---------------------------------------------------------------------------
# Packing candidate assignments into device tensors
# ---------------------------------------------------------------------------


def _round_up(n: int, m: int) -> int:
    return max(m, ((n + m - 1) // m) * m)


def pack_assignments(compiled: CompiledConjunction, assignments, device="cpu") -> tuple:
    """Assignment objects -> (scalars, bools, array_tabs), the fields of the
    JAX package's ``pack_assignments`` as int32 torch tensors on ``device``:
    one ``[B, L]`` limb tensor per bv var, the bools ``[B, max(1, n)]``, and
    per array (idx ``[B, K, Ld]``, val ``[B, K, Lr]``, valid ``[B, K]``,
    default ``[B, Lr]``).

    Array tables take the union of backing keys across the batch per array
    (padded to a multiple of 8 rows, at least 8); every candidate gets its
    own value column, defaulting per its ArrayValue."""
    B = len(assignments)
    put = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(device)  # noqa: E731
    scalars = []
    for v in compiled.bv_vars:
        vals = [int(asg.scalars.get(v, 0)) for asg in assignments]
        scalars.append(put(bv.from_ints_np(vals, v.width).reshape(B, bv.nlimbs(v.width))))
    bools = np.zeros((B, max(1, len(compiled.bool_vars))), np.int32)
    for i, v in enumerate(compiled.bool_vars):
        for b, asg in enumerate(assignments):
            bools[b, i] = bool(asg.scalars.get(v, False))

    array_tabs = []
    for av in compiled.array_vars:
        dom_w, rng_w = av.sort[1], av.sort[2]
        keys = sorted({k for asg in assignments
                       for k in getattr(asg.arrays.get(av), "backing", {})})
        K = _round_up(len(keys), 8)
        Ld, Lr = bv.nlimbs(dom_w), bv.nlimbs(rng_w)
        idx = np.zeros((B, K, Ld), np.uint32)
        valn = np.zeros((B, K, Lr), np.uint32)
        valid = np.zeros((B, K), np.int32)
        arrs = [asg.arrays.get(av) for asg in assignments]
        defaults = [int(a.default) if a is not None else 0 for a in arrs]
        default = bv.from_ints_np(defaults, rng_w).reshape(B, Lr)
        if keys:
            idx[:, : len(keys)] = bv.from_ints_np(keys, dom_w)[None]
            valid[:, : len(keys)] = 1
            for k, key in enumerate(keys):
                vals = [int((a.backing if a is not None else {}).get(key, d))
                        for a, d in zip(arrs, defaults)]
                valn[:, k] = bv.from_ints_np(vals, rng_w)
        array_tabs.append(tuple(put(x) for x in (idx, valn, valid, default)))
    return tuple(scalars), put(bools), tuple(array_tabs)


# ---------------------------------------------------------------------------
# The plain version: JAX's ``run`` on ops/bitvec.py
# ---------------------------------------------------------------------------


def run_lowering_reference(compiled: CompiledConjunction, scalars, bools, array_tabs,
                           values: Optional[dict] = None) -> torch.Tensor:
    """Plain PyTorch evaluation of the DAG -> truth [B, C] bool.

    Node by node in topological order, each over the whole batch; constants
    stay one row, expanded over the batch as views.  ``values``: a dict that
    receives every bv node's [B, L] int64 limbs and every bool node's [B]
    bool, by term id, for checks."""
    B = bools.shape[0]
    dev = bools.device
    val: Dict[int, object] = {} if values is None else values
    for i, v in enumerate(compiled.bv_vars):
        val[v.tid] = scalars[i].to(torch.int64)
    for i, v in enumerate(compiled.bool_vars):
        val[v.tid] = bools[:, i] != 0
    for i, v in enumerate(compiled.array_vars):
        val[v.tid] = ("base", tuple(x.to(torch.int64) for x in array_tabs[i]))

    def select(arr_repr, idx):
        kind = arr_repr[0]
        if kind == "store":
            _, parent, s_idx, s_val = arr_repr
            return bv.mux(bv.eq(idx, s_idx), s_val, select(parent, idx))
        if kind == "ite":
            _, cond, a_repr, b_repr = arr_repr
            return bv.mux(cond, select(a_repr, idx), select(b_repr, idx))
        if kind == "const":
            return arr_repr[1]
        # JAX's mux over the K rows, the last hit winning, in one pass
        t_idx, t_val, t_valid, t_default = arr_repr[1]
        hit = (t_valid != 0) & (t_idx == idx[:, None, :]).all(dim=-1)  # [B, K]
        rank = torch.arange(1, hit.shape[1] + 1, device=hit.device)
        last = (hit * rank).argmax(dim=-1)
        chosen = t_val[torch.arange(hit.shape[0], device=hit.device), last]
        return bv.mux(hit.any(dim=-1), chosen, t_default)

    for t in terms.topo_order(compiled.conjuncts):
        if t.op in ("var", "array_var"):
            continue
        val[t.tid] = _lower_node(t, val, select, B, dev)
    cols = [val[c.tid].expand(B) for c in compiled.conjuncts]
    return torch.stack(cols, dim=-1) if cols else torch.zeros((B, 0), dtype=torch.bool, device=dev)


_ARITH = {
    "bvadd": bv.add, "bvsub": bv.sub, "bvmul": bv.mul, "bvudiv": bv.udiv,
    "bvsdiv": bv.sdiv, "bvurem": bv.urem, "bvsrem": bv.srem, "bvexp": bv.bvexp,
    "bvand": bv.and_, "bvor": bv.or_, "bvxor": bv.xor, "bvshl": bv.shl,
    "bvlshr": bv.lshr, "bvashr": bv.ashr,
}


def _lower_node(t: Term, val, select, B: int, dev):
    op, a = t.op, t.args
    w = t.width if terms.is_bv_sort(t.sort) else None
    x = [val[c.tid] for c in a]
    if op == "const":
        if t.sort is terms.BOOL:
            return torch.tensor(bool(t.aux), device=dev).expand(B)
        return bv.from_ints(t.aux, w, dev).expand(B, bv.nlimbs(w))
    if op == "const_array":
        return ("const", x[0])
    if op == "store":
        return ("store", *x)
    if op == "select":
        return select(x[0], x[1])
    if op == "ite":
        if terms.is_array_sort(t.sort):
            return ("ite", *x)
        if t.sort is terms.BOOL:
            return torch.where(x[0], x[1], x[2])
        return bv.mux(x[0], x[1], x[2])
    if op in _ARITH:
        return _ARITH[op](x[0], x[1], w)
    if op == "bvnot":
        return bv.not_(x[0], w)
    if op == "bvneg":
        return bv.neg(x[0], w)
    if op == "concat":
        return bv.concat_bits(x[0], x[1], a[0].width, a[1].width)
    if op == "extract":
        hi, lo = t.aux
        return bv.extract_bits(x[0], hi, lo, a[0].width)
    if op == "zext":
        return bv.resize(x[0], a[0].width, w)
    if op == "sext":
        return bv.sext_to(x[0], a[0].width, w)
    if op == "eq":
        if a[0].sort is terms.BOOL:
            return x[0] == x[1]
        return bv.eq(x[0], x[1])
    if op == "ult":
        return bv.ult(x[0], x[1])
    if op == "ule":
        return bv.ule(x[0], x[1])
    if op == "slt":
        return bv.slt(x[0], x[1], a[0].width)
    if op == "sle":
        return bv.sle(x[0], x[1], a[0].width)
    if op in ("and", "or"):
        out = x[0]
        for y in x[1:]:
            out = (out & y) if op == "and" else (out | y)
        return out
    if op == "not":
        return ~x[0]
    if op == "xor":
        return x[0] ^ x[1]
    if op == "keccak":
        plain = keccak_torch.keccak_f1600_reference
        return keccak_torch.keccak256(x[0], a[0].width, permute=plain)
    raise LoweringUnsupported(f"op {op}")


# ---------------------------------------------------------------------------
# Port-only: the node table the kernel walks
# ---------------------------------------------------------------------------

(
    LOP_ADD, LOP_SUB, LOP_MUL, LOP_UDIV, LOP_UREM, LOP_SDIV, LOP_SREM, LOP_EXP,
    LOP_AND, LOP_OR, LOP_XOR, LOP_NOT, LOP_NEG, LOP_SHL, LOP_LSHR, LOP_ASHR,
    LOP_CONCAT, LOP_EXTRACT, LOP_ZEXT, LOP_SEXT,
    LOP_EQ, LOP_ULT, LOP_ULE, LOP_SLT, LOP_SLE, LOP_ITE, LOP_LOOKUP, LOP_KECCAK,
) = range(28)

# record columns: op, result width, result row, operand refs a b c, the
# widths of a and b, aux0 (extract lo, table id), aux1 (extract hi), pad
REC_INTS = 12
(R_OP, R_W, R_OUT, R_A, R_B, R_C, R_WA, R_WB, R_AUX0, R_AUX1) = range(10)
# scratch rows a record of these ops uses, in multiples of its limb count
_SCRATCH = {LOP_UDIV: 1, LOP_UREM: 0, LOP_SDIV: 3, LOP_SREM: 3, LOP_EXP: 2}

_BIN = {
    "bvadd": LOP_ADD, "bvsub": LOP_SUB, "bvmul": LOP_MUL, "bvudiv": LOP_UDIV,
    "bvurem": LOP_UREM, "bvsdiv": LOP_SDIV, "bvsrem": LOP_SREM, "bvexp": LOP_EXP,
    "bvand": LOP_AND, "bvor": LOP_OR, "bvxor": LOP_XOR, "bvshl": LOP_SHL,
    "bvlshr": LOP_LSHR, "bvashr": LOP_ASHR, "ult": LOP_ULT, "ule": LOP_ULE,
    "slt": LOP_SLT, "sle": LOP_SLE, "eq": LOP_EQ,
}


def _pool_ref(offset: int) -> int:
    return -1 - offset


class LoweringProgram:
    """Port-only: a compiled conjunction as the flat node table that
    ``csrc/lowering.cu`` walks, one thread per candidate.

    A value is a *ref*: a row of the arena ``[rows, B]`` int32 (limb ``i``
    of the value at row ``ref + i``), or, when negative, ``-1 - offset``
    into the constant pool (limb ``i`` at ``pool[offset + i]``).  Constants
    live once in the pool and are never broadcast over the batch.  Rows:
    the bv variables' limbs, then the bools (one row each), then one block
    of ``nlimbs(width)`` rows per record, then the scratch rows of
    division and exponentiation (from ``scratch_row``, shared by every
    such record: one thread runs its records one after another).

    ``rec`` ``[n, REC_INTS]``: op code, result width, result row, operand
    refs a, b, c, the widths of a and b, aux0 (extract's lo, a lookup's
    table), aux1 (extract's hi).  JAX's trace-time select recursion is
    unrolled here: a select over a store becomes EQ + ITE records, over an
    array ite an ITE of the two branches' selects, over a constant array
    the default's ref, over a base array one LOOKUP record; a select of the
    same array at the same index is emitted once.  Bool ops are the bv ops
    at width 1.

    Keccak nodes split the table into segments, one kernel launch each:
    every record has a level (a keccak node one above its operands, any
    other the highest of its operands'), records are ordered by level, and
    between the launches of levels ``l - 1`` and ``l`` the wrapper hashes
    the keccak nodes of level ``l``.  ``segments``: per level, ``(r_begin,
    r_end)`` of its records and the keccak records hashed before it.  The
    last launch writes the truth of ``roots``."""

    def __init__(self, compiled: CompiledConjunction):
        self.conjuncts = compiled.conjuncts
        pool: List[int] = []
        pool_of: Dict[Tuple[int, int], int] = {}
        ref_of: Dict[int, int] = {}
        level: Dict[int, int] = {}
        rows = 0
        for v in compiled.bv_vars:
            ref_of[v.tid], rows = rows, rows + bv.nlimbs(v.width)
        for v in compiled.bool_vars:
            ref_of[v.tid], rows = rows, rows + 1
        self.n_input_rows = rows
        recs: List[List[int]] = []
        rec_level: List[int] = []
        scratch = 0
        arrays: Dict[int, tuple] = {
            v.tid: ("base", i) for i, v in enumerate(compiled.array_vars)}
        selected: Dict[Tuple[int, int], int] = {}

        def const(value: int, width: int) -> int:
            key = (value, width)
            if key not in pool_of:
                pool_of[key] = _pool_ref(len(pool))
                pool.extend(bv.from_ints_np(value, width).astype(np.int64).tolist())
            return pool_of[key]

        def emit(op, w, a=0, b=0, c=0, wa=0, wb=0, aux0=0, aux1=0, reads=()) -> int:
            nonlocal rows, scratch
            out = rows
            rows += bv.nlimbs(w)
            recs.append([op, w, out, a, b, c, wa, wb, aux0, aux1, 0, 0])
            lvl = max((level.get(r, 0) for r in reads), default=0)
            lvl += op == LOP_KECCAK
            level[out] = lvl
            rec_level.append(lvl)
            scratch = max(scratch, _SCRATCH.get(op, 0) * bv.nlimbs(w))
            return out

        def select(arr: Term, idx: int, dom_w: int, rng_w: int) -> int:
            key = (arr.tid, idx)
            if key in selected:
                return selected[key]
            kind = arrays[arr.tid]
            if kind[0] == "store":
                _, parent, s_idx, s_val = kind
                below = select(parent, idx, dom_w, rng_w)
                hit = emit(LOP_EQ, 1, idx, s_idx, wa=dom_w, reads=(idx, s_idx))
                out = emit(LOP_ITE, rng_w, hit, s_val, below, reads=(hit, s_val, below))
            elif kind[0] == "ite":
                _, cond, x, y = kind
                then = select(x, idx, dom_w, rng_w)
                els = select(y, idx, dom_w, rng_w)
                out = emit(LOP_ITE, rng_w, cond, then, els, reads=(cond, then, els))
            elif kind[0] == "const":
                out = kind[1]
            else:
                out = emit(LOP_LOOKUP, rng_w, idx, wa=dom_w, aux0=kind[1], reads=(idx,))
            selected[key] = out
            return out

        for t in terms.topo_order(self.conjuncts):
            op, a = t.op, t.args
            if op in ("var", "array_var"):
                continue
            if op == "const_array":
                arrays[t.tid] = ("const", ref_of[a[0].tid])
                continue
            if op == "store":
                arrays[t.tid] = ("store", a[0], ref_of[a[1].tid], ref_of[a[2].tid])
                continue
            if op == "ite" and terms.is_array_sort(t.sort):
                arrays[t.tid] = ("ite", ref_of[a[0].tid], a[1], a[2])
                continue
            if op == "const":
                ref_of[t.tid] = const(int(t.aux), t.width if terms.is_bv_sort(t.sort) else 1)
                continue
            if op == "select":
                dom_w, rng_w = a[0].sort[1], a[0].sort[2]
                ref_of[t.tid] = select(a[0], ref_of[a[1].tid], dom_w, rng_w)
                continue
            refs = [ref_of[c.tid] for c in a]
            w = t.width if terms.is_bv_sort(t.sort) else 1
            wa = a[0].width if terms.is_bv_sort(a[0].sort) else 1
            if op in ("and", "or"):
                code, out = (LOP_AND if op == "and" else LOP_OR), refs[0]
                for r in refs[1:]:
                    out = emit(code, 1, out, r, reads=(out, r))
                ref_of[t.tid] = out
                continue
            if op == "ite":
                code, kw = LOP_ITE, {}
            elif op in _BIN:
                code, kw = _BIN[op], {"wa": wa}
            elif op == "xor":
                code, kw = LOP_XOR, {}
            elif op in ("not", "bvnot"):
                code, kw = LOP_NOT, {}
            elif op == "bvneg":
                code, kw = LOP_NEG, {}
            elif op == "concat":
                code, kw = LOP_CONCAT, {"wa": wa, "wb": a[1].width}
            elif op == "extract":
                code, kw = LOP_EXTRACT, {"wa": wa, "aux0": t.aux[1], "aux1": t.aux[0]}
            elif op in ("zext", "sext"):
                code, kw = (LOP_ZEXT if op == "zext" else LOP_SEXT), {"wa": wa}
            elif op == "keccak":
                code, kw = LOP_KECCAK, {"wa": wa}
            else:
                raise LoweringUnsupported(f"op {op}")
            ref_of[t.tid] = emit(code, w, *refs, **kw, reads=refs)

        self.scratch_row = rows
        self.rows = rows + scratch
        self.roots = np.asarray([ref_of[c.tid] for c in self.conjuncts], np.int32)
        self.pool = np.asarray(pool or [0], np.int64).astype(np.int32)
        self.ref_of = ref_of
        n_levels = max(rec_level, default=0) + 1
        # by level; within a level its keccak records first (their operands
        # lie on lower levels), the others in topological order
        is_keccak = [r[R_OP] == LOP_KECCAK for r in recs]
        order = sorted(range(len(recs)), key=lambda i: (rec_level[i], not is_keccak[i], i))
        self.rec = np.asarray([recs[i] for i in order], np.int32).reshape(-1, REC_INTS)
        self.segments: List[Tuple[int, int, List[int]]] = []
        at = 0
        for lvl in range(n_levels):
            keccaks = []
            while at < len(order) and rec_level[order[at]] == lvl and is_keccak[order[at]]:
                keccaks.append(at)
                at += 1
            begin = at
            while at < len(order) and rec_level[order[at]] == lvl:
                at += 1
            self.segments.append((begin, at, keccaks))
        self._device: Dict[str, torch.Tensor] = {}

    def device_arrays(self, device) -> Tuple[torch.Tensor, int, int]:
        """``rec``, ``pool`` and ``roots`` in one int32 tensor on ``device``,
        uploaded once, with the pool's and the roots' int32 offsets."""
        key = str(torch.device(device))
        if key not in self._device:
            host = np.concatenate([self.rec.ravel(), self.pool, self.roots]).astype(np.int32)
            self._device[key] = torch.from_numpy(host).to(device)
        return self._device[key], self.rec.size, self.rec.size + self.pool.size


# ---------------------------------------------------------------------------
# The kernel launch
# ---------------------------------------------------------------------------

# kernel launches of csrc/lowering.cu (one per segment)
launches = 0


class LowerArgs(ctypes.Structure):
    """Mirror of ``mk::low::LowerArgs`` in ``csrc/lowering.cuh``."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "rec", "pool", "roots", "tab_meta", "tabs", "arena", "truth",
    )] + [(name, ctypes.c_int32) for name in (
        "B", "r_begin", "r_end", "C", "scratch", "write_truth",
    )]


TAB_META = 8  # per table: offsets of idx, val, valid, default in tabs; K, Ld, Lr; pad

_arenas: Dict[Tuple[str, int], torch.Tensor] = {}
_arena_lock = threading.Lock()


def arena_for(device, n: int) -> torch.Tensor:
    """An int32 buffer of at least ``n`` elements on ``device``, allocated
    once per (device, power-of-two size bucket) and reused."""
    bucket = max(1 << 16, 1 << max(0, n - 1).bit_length())
    key = (str(torch.device(device)), bucket)
    buf = _arenas.get(key)
    if buf is None:
        buf = _arenas[key] = torch.empty(bucket, dtype=torch.int32, device=device)
    return buf[:n]


def _check_inputs(compiled: CompiledConjunction, scalars, bools, array_tabs) -> int:
    B = bools.shape[0]
    dev = bools.device
    want = [(f"scalar {i}", s, (B, bv.nlimbs(v.width))) for i, (s, v) in
            enumerate(zip(scalars, compiled.bv_vars))]
    want.append(("bools", bools, (B, max(1, len(compiled.bool_vars)))))
    if len(scalars) != len(compiled.bv_vars) or len(array_tabs) != len(compiled.array_vars):
        raise ValueError("inputs do not match the compiled conjunction's variables")
    for i, (tab, av) in enumerate(zip(array_tabs, compiled.array_vars)):
        K = tab[0].shape[1] if tab[0].dim() == 3 else -1
        Ld, Lr = bv.nlimbs(av.sort[1]), bv.nlimbs(av.sort[2])
        want += [(f"table {i} {name}", x, shape) for name, x, shape in zip(
            ("idx", "val", "valid", "default"), tab, ((B, K, Ld), (B, K, Lr), (B, K), (B, Lr)))]
    for name, x, shape in want:
        if x.device != dev or x.dtype != torch.int32 or tuple(x.shape) != shape:
            raise ValueError(f"{name}: expected int32 {shape} on {dev}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    return B


def run_segments(compiled: CompiledConjunction, scalars, bools, array_tabs, *, launch,
                 permute=None, arena: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Drive the node table as the kernel runs it: the inputs copied into
    the arena's first rows, one ``launch(LowerArgs)`` per segment, and the
    keccak nodes between segments hashed by ``keccak_torch.keccak256``
    (``permute``: the keccak-f[1600] it uses on ``[N, 25, 4]`` int32
    states, such as ``keccak_cuda.keccak_f1600``; default the public
    ``keccak_torch.keccak_f1600``).  ``arena``: ``[rows, B]`` int32 to use (and
    keep, for checks), else a pooled buffer.  -> truth [B, C] bool."""
    prog = compiled.program
    B = bools.shape[0]
    dev = bools.device
    C = len(compiled.conjuncts)
    truth = torch.empty((B, C), dtype=torch.bool, device=dev)
    if B == 0:
        return truth
    if arena is None:
        arena = arena_for(dev, prog.rows * B).view(prog.rows, B)
    elif tuple(arena.shape) != (prog.rows, B) or arena.dtype != torch.int32:
        raise ValueError(f"arena: expected int32 {(prog.rows, B)}")
    inputs = [s.T for s in scalars] + [bools[:, : len(compiled.bool_vars)].T]
    if prog.n_input_rows:
        arena[: prog.n_input_rows] = torch.cat(inputs, dim=0)
    parts = []
    meta = np.zeros((max(1, len(array_tabs)), TAB_META), np.int64)
    at = 0
    for i, tab in enumerate(array_tabs):
        for j, x in enumerate(tab):
            meta[i, j] = at
            at += x.numel()
            parts.append(x.reshape(-1))
        meta[i, 4:7] = (tab[0].shape[1], tab[0].shape[2], tab[1].shape[2])
    tabs = torch.cat(parts) if parts else torch.zeros(1, dtype=torch.int32, device=dev)
    tab_meta = torch.from_numpy(meta).to(dev)
    table, pool_at, roots_at = prog.device_arrays(dev)
    base = table.data_ptr()
    largs = LowerArgs(base, base + 4 * pool_at, base + 4 * roots_at, tab_meta.data_ptr(),
                      tabs.data_ptr(), arena.data_ptr(), truth.data_ptr(),
                      B, 0, 0, C, prog.scratch_row, 0)
    for n, (begin, end, keccaks) in enumerate(prog.segments):
        for r in keccaks:
            _hash_node(prog, arena, prog.rec[r], permute)
        largs.r_begin, largs.r_end = begin, end
        largs.write_truth = int(n == len(prog.segments) - 1)
        launch(largs)
    return truth


def _rows(prog: LoweringProgram, arena: torch.Tensor, ref: int, L: int) -> torch.Tensor:
    """The [L, B] limbs of ``ref``: arena rows, or a pool constant expanded."""
    if ref >= 0:
        return arena[ref: ref + L]
    at = -1 - ref
    const = torch.from_numpy(prog.pool[at: at + L].copy()).to(arena.device)
    return const[:, None].expand(L, arena.shape[1])


def _hash_node(prog: LoweringProgram, arena: torch.Tensor, rec, permute) -> None:
    wa = int(rec[R_WA])
    data = _rows(prog, arena, int(rec[R_A]), bv.nlimbs(wa)).T
    if permute is not None:  # a kernel's entry: [N, 25, 4] int32 states
        kernel = permute
        permute = lambda st: kernel(st.to(torch.int32).contiguous()).to(st.dtype)  # noqa: E731
    digest = keccak_torch.keccak256(data, wa, permute=permute)
    arena[int(rec[R_OUT]): int(rec[R_OUT]) + 16] = digest.T.to(torch.int32)


def _run_lowering_cuda(compiled: CompiledConjunction, scalars, bools, array_tabs,
                       arena: Optional[torch.Tensor] = None) -> torch.Tensor:
    from mythril_tpu_torch.ops import _build, keccak_cuda

    dev = bools.device
    lib = _build.load()

    def launch(largs):
        global launches
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(lib.mk_lowering(ctypes.byref(largs), stream), "lowering")
        launches += 1

    with _arena_lock, torch.cuda.device(dev):
        truth = run_segments(compiled, scalars, bools, array_tabs, launch=launch,
                             permute=keccak_cuda.keccak_f1600, arena=arena)
        # the pooled arena is reused by the next call: finish before handing it on
        torch.cuda.current_stream(dev).synchronize()
    return truth


def run_lowering(compiled: CompiledConjunction, scalars, bools, array_tabs,
                 arena: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Evaluate the conjunction over a packed candidate batch -> truth
    [B, C] bool.  CUDA tensors launch the kernels (or raise); CPU tensors
    take the plain version.  Arguments are ``pack_assignments``' tuple.
    CUDA only: ``arena``, a ``[rows, B]`` int32 tensor that receives every
    node's value (see ``run_segments``)."""
    _check_inputs(compiled, scalars, bools, array_tabs)
    if bools.is_cuda:
        return _run_lowering_cuda(compiled, scalars, bools, array_tabs, arena=arena)
    if arena is not None:
        raise ValueError("arena receives the CUDA kernel's values; the plain version keeps its own")
    return run_lowering_reference(compiled, scalars, bools, array_tabs)


# ---------------------------------------------------------------------------
# Compile cache (terms are interned: tid tuples are stable keys)
# ---------------------------------------------------------------------------

_CACHE: Dict[tuple, CompiledConjunction] = {}
_CACHE_CAP = 512


def compile_cached(conjuncts: Sequence[Term]) -> CompiledConjunction:
    key = tuple(c.tid for c in conjuncts)
    hit = _CACHE.get(key)
    if hit is None:
        if len(_CACHE) >= _CACHE_CAP:
            _CACHE.clear()
        hit = compile_conjunction(conjuncts)
        _CACHE[key] = hit
    return hit
