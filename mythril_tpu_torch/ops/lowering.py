"""Per-conjunction lowering: a term DAG evaluated over a batch of candidates.

The port's counterpart of ``mythril_tpu/ops/lowering.py``.  The solver
(``smt/solver.py``) sends it every conjunction the tape VM refuses
(``TapeUnsupported``: a tape too long, a keccak preimage the tape cannot
take, a wide constant), as the JAX package does.  The JAX package compiles
each such DAG into one jitted function; here the DAG is compiled once into a
flat node table (``LoweringProgram``) that one hand-written kernel walks:

* ``run_lowering`` on CUDA tensors launches ``csrc/lowering.cu`` once (a
  block per candidate walks the node table level by level, a record's limbs
  across a warp's lanes, the candidate's values in shared memory, keccak
  nodes hashed inside);
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
# widths of a and b, aux0 (extract lo, table id), aux1 (extract hi), the
# first scratch row, pad
REC_INTS = 12
(R_OP, R_W, R_OUT, R_A, R_B, R_C, R_WA, R_WB, R_AUX0, R_AUX1, R_SCR) = range(11)
# scratch rows a record of these ops uses, in multiples of its limb count
_SCRATCH = {LOP_UDIV: 1, LOP_SDIV: 3, LOP_SREM: 3, LOP_EXP: 2}

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
    ``csrc/lowering.cu`` walks, level by level.

    A value is a *ref*: a row of the arena ``[rows, B]`` int32 (limb ``i``
    of the value at row ``ref + i``), or, when negative, ``-1 - offset``
    into the constant pool (limb ``i`` at ``pool[offset + i]``).  Constants
    live once in the pool and are never broadcast over the batch.  Rows:
    the bv variables' limbs, then the bools (one row each), then one block
    of ``nlimbs(width)`` rows per record, followed, for division and
    exponentiation, by the record's own scratch rows (records of one level
    run at once).

    ``rec`` ``[n, REC_INTS]``: op code, result width, result row, operand
    refs a, b, c, the widths of a and b, aux0 (extract's lo, a lookup's
    table), aux1 (extract's hi), the first scratch row.  JAX's trace-time
    select recursion is unrolled here: a select over a store becomes EQ +
    ITE records, over an array ite an ITE of the two branches' selects,
    over a constant array the default's ref, over a base array one LOOKUP
    record; a select of the same array at the same index is emitted once.
    Bool ops are the bv ops at width 1.

    Every record has a dependency level, one above the highest level of the
    records it reads (inputs and constants are level 0), keccak records
    like any other; records are ordered by level (``rec_level``), and
    ``levels`` holds the ``n_levels + 1`` offsets of each level's first
    record, so that the records of one level can run at once and the level
    count is the longest chain.  The kernel writes the truth of ``roots``
    after the last level."""

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
            nonlocal rows
            out = rows
            rows += bv.nlimbs(w)
            scr = rows if op in _SCRATCH else 0
            rows += _SCRATCH.get(op, 0) * bv.nlimbs(w)
            recs.append([op, w, out, a, b, c, wa, wb, aux0, aux1, scr, 0])
            level[out] = 1 + max((level.get(r, 0) for r in reads), default=0)
            rec_level.append(level[out])
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

        self.rows = rows
        self.roots = np.asarray([ref_of[c.tid] for c in self.conjuncts], np.int32)
        self.pool = np.asarray(pool or [0], np.int64).astype(np.int32)
        self.ref_of = ref_of
        order = sorted(range(len(recs)), key=lambda i: (rec_level[i], i))
        self.rec = np.asarray([recs[i] for i in order], np.int32).reshape(-1, REC_INTS)
        self.rec_level = np.asarray([rec_level[i] for i in order], np.int32)
        self.n_levels = int(self.rec_level.max()) if len(order) else 0
        self.levels = np.searchsorted(
            self.rec_level, np.arange(1, self.n_levels + 2)).astype(np.int32)
        self._device: Dict[str, torch.Tensor] = {}

    def device_arrays(self, device) -> Tuple[torch.Tensor, int, int, int]:
        """``rec``, ``levels``, ``pool`` and ``roots`` in one int32 tensor on
        ``device``, uploaded once per device that launches the program (the
        sharded probe launches it on each device of a mesh), with the int32
        offsets of the last three."""
        key = str(torch.device(device))
        if key not in self._device:
            host = np.concatenate([self.rec.ravel(), self.levels, self.pool, self.roots])
            self._device[key] = torch.from_numpy(host.astype(np.int32)).to(device)
        at = np.cumsum([self.rec.size, self.levels.size, self.pool.size])
        return self._device[key], int(at[0]), int(at[1]), int(at[2])


# ---------------------------------------------------------------------------
# The kernel launch
# ---------------------------------------------------------------------------

# kernel launches of csrc/lowering.cu (one per call), in all and by device
# ("cuda:0": n; the sharded probe launches once per mesh block)
launches = 0
launches_by_device: Dict[str, int] = {}


class LowerArgs(ctypes.Structure):
    """Mirror of ``mk::low::LowerArgs`` in ``csrc/lowering.cuh``."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "rec", "level", "pool", "roots", "inputs", "tabs", "arena", "truth",
    )] + [(name, ctypes.c_int32) for name in (
        "B", "C", "n_rec", "n_levels", "rows", "n_pool", "n_in", "n_tab", "smem_words", "in_smem",
    )]


IN_COLS = 4  # per input: pointer, ints per candidate, limbs, first row
TAB_COLS = 8  # per table: idx, val, valid, default pointers; K, Ld, Lr; staged offset
# dynamic shared memory a block may take on Hopper (227 KB): a program whose
# values, pool, table rows and node table need more keeps its values in the
# global arena
SMEM_BUDGET = 232448


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
        if (x.device != dev or x.dtype != torch.int32 or tuple(x.shape) != shape
                or not x.is_contiguous()):
            raise ValueError(f"{name}: expected int32 {shape} on {dev}, contiguous; got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    return B


def run_kernel(compiled: CompiledConjunction, scalars, bools, array_tabs, *, launch,
               arena: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Drive the node table as the kernel runs it: one ``launch(LowerArgs)``
    over the packed inputs where they lie (a table of their pointers,
    uploaded once per call).  The route: the candidate's values, the pool,
    its table rows and the node table in shared memory when they fit
    ``SMEM_BUDGET``, else the values in a ``[rows, B]`` int32 arena in
    device memory.
    ``arena``: such a tensor that receives every node's value on either
    route (for checks).  -> truth [B, C] bool."""
    prog = compiled.program
    B = bools.shape[0]
    dev = bools.device
    truth = torch.empty((B, len(compiled.conjuncts)), dtype=torch.bool, device=dev)
    if B == 0:
        return truth
    if arena is not None and (tuple(arena.shape) != (prog.rows, B) or arena.dtype != torch.int32
                              or arena.device != dev or not arena.is_contiguous()):
        raise ValueError(f"arena: expected int32 {(prog.rows, B)} on {dev}, contiguous")
    desc = []
    for x, v in zip(scalars, compiled.bv_vars):
        L = bv.nlimbs(v.width)
        desc += [x.data_ptr(), L, L, prog.ref_of[v.tid]]
    if compiled.bool_vars:
        desc += [bools.data_ptr(), bools.shape[1], len(compiled.bool_vars),
                 prog.ref_of[compiled.bool_vars[0].tid]]
    n_in = len(desc) // IN_COLS
    staged = prog.rows + prog.pool.size
    for idx, val, valid, default in array_tabs:
        K, Ld, Lr = idx.shape[1], idx.shape[2], val.shape[2]
        desc += [idx.data_ptr(), val.data_ptr(), valid.data_ptr(), default.data_ptr(),
                 K, Ld, Lr, staged]
        staged += K * (Ld + Lr + 1) + Lr
    staged += prog.levels.size + prog.rec.size
    in_smem = 4 * staged <= SMEM_BUDGET
    if not in_smem and arena is None:
        arena = torch.empty((prog.rows, B), dtype=torch.int32, device=dev)
    meta = torch.from_numpy(np.asarray(desc or [0], np.int64)).to(dev)
    table, level_at, pool_at, roots_at = prog.device_arrays(dev)
    base, mp = table.data_ptr(), meta.data_ptr()
    launch(LowerArgs(base, base + 4 * level_at, base + 4 * pool_at, base + 4 * roots_at,
                     mp, mp + 8 * IN_COLS * n_in, None if arena is None else arena.data_ptr(),
                     truth.data_ptr(), B, truth.shape[1], len(prog.rec), prog.n_levels, prog.rows,
                     prog.pool.size, n_in, len(array_tabs), staged, int(in_smem)))
    return truth


def _run_lowering_cuda(compiled: CompiledConjunction, scalars, bools, array_tabs,
                       arena: Optional[torch.Tensor] = None) -> torch.Tensor:
    from mythril_tpu_torch.ops import _build

    dev = bools.device
    lib = _build.load()

    def launch(largs):
        global launches
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(lib.mk_lowering(ctypes.byref(largs), stream), "lowering")
        launches += 1
        launches_by_device[str(dev)] = launches_by_device.get(str(dev), 0) + 1

    with torch.cuda.device(dev):
        return run_kernel(compiled, scalars, bools, array_tabs, launch=launch, arena=arena)


def run_lowering(compiled: CompiledConjunction, scalars, bools, array_tabs,
                 arena: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Evaluate the conjunction over a packed candidate batch -> truth
    [B, C] bool.  CUDA tensors launch the kernel (or raise); CPU tensors
    take the plain version.  Arguments are ``pack_assignments``' tuple.
    CUDA only: ``arena``, a ``[rows, B]`` int32 tensor that receives every
    node's value (see ``run_kernel``)."""
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
