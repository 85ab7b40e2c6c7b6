"""Tape VM: one interpreter evaluates any constraint conjunction.

The port's counterpart of ``mythril_tpu/ops/tape_vm.py``.  A conjunction is
assembled on the host into a tape (opcode, operand rows, width masks) by
``TapeProgram`` — carried over unchanged, so both packages produce the same
tensors — and a batch of candidate assignments is evaluated against it:

* ``run_tape`` on CUDA tensors launches ``csrc/tape_vm.cu`` (one thread per
  candidate) and, for keccak steps, ``csrc/keccak_f1600.cu``;
* ``run_tape_reference`` is the plain PyTorch version: a Python loop over
  the tape's host-known op codes calling ``ops/bitvec.py`` and
  ``keccak_torch.keccak256``, with no device sync per step.  ``run_tape``
  takes it for CPU tensors.

All values are 256-bit words as 16 limbs of 16 bits, zero-extended from
their semantic width; narrower semantics come from desugaring plus a
per-step result mask, exactly as in the JAX package.  Unsupported structure
raises ``TapeUnsupported``; the solver then evaluates candidates on the host.
The JAX warm-up machinery has no counterpart: there is no XLA compile, and
the kernels are built once by ``ops/_build.py``.
"""

from __future__ import annotations

import ctypes
import heapq
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from mythril_tpu_torch.ops import bitvec as bv
from mythril_tpu_torch.ops import keccak_torch
from mythril_tpu_torch.smt import terms
from mythril_tpu_torch.smt.terms import Term

L = 16  # limbs per word (256 bits as 16x16-bit limbs in u32)

(
    OP_ADD, OP_SUB, OP_MUL, OP_UDIV, OP_UREM, OP_SDIV, OP_SREM, OP_EXP,
    OP_AND, OP_OR, OP_XOR, OP_SHL, OP_LSHR, OP_ASHR,
    OP_EQ, OP_ULT, OP_ITE, OP_SELECT, OP_KECCAK32, OP_KECCAK64,
) = range(20)


class TapeUnsupported(Exception):
    """Conjunction shape the tape VM cannot express; candidates go to the host."""


# Profiles: (T steps, V leaf slots, A arrays, K table rows, R roots)
_PROFILES = (
    ("small", 96, 24, 3, 8, 24),
    ("large", 384, 72, 6, 24, 72),
)
_BATCH_BUCKETS = (64, 256)


# ---------------------------------------------------------------------------
# Host-side tape assembly
# ---------------------------------------------------------------------------


class TapeProgram:
    """A conjunction assembled into tape tensors (numpy, device-ready)."""

    def __init__(self, conjuncts: Sequence[Term]):
        self.conjuncts = list(conjuncts)
        self.leaf_vars: List[Term] = []  # creation order == leaf-row order
        self.bv_vars: List[Term] = []
        self.bool_vars: List[Term] = []
        self.array_vars: List[Term] = []
        self._row_of: Dict[int, int] = {}  # term tid -> reg row
        self._const_rows: Dict[int, int] = {}  # value -> leaf row
        self._leaf_consts: List[int] = []  # leaf row -> const value
        self._var_rows: Dict[int, int] = {}  # var tid -> leaf row
        self.ops: List[Tuple[int, int, int, int, int, int]] = []  # op,a0,a1,a2,aux,wmask_width
        self.root_rows: List[int] = []
        self._build()

    # -- leaf management ----------------------------------------------------
    def _const(self, value: int) -> int:
        row = self._const_rows.get(value)
        if row is None:
            row = len(self._leaf_consts)
            self._leaf_consts.append(value)
            self._const_rows[value] = row
        return row

    @property
    def n_leaves(self) -> int:
        return len(self._leaf_consts) + len(self.leaf_vars)

    def _var_row(self, t: Term) -> int:
        row = self._var_rows.get(t.tid)
        if row is None:
            # var leaf rows sit above all const rows; the const count grows
            # while building, so store a placeholder (-1 - ordinal) that
            # finalize resolves once the const pool is complete
            row = -(1 + len(self.leaf_vars))
            self.leaf_vars.append(t)
            if t.sort is terms.BOOL:
                self.bool_vars.append(t)
            else:
                self.bv_vars.append(t)
            self._var_rows[t.tid] = row
        return row

    # -- op emission ---------------------------------------------------------
    def _emit(self, op: int, a0: int, a1: int = 0, a2: int = 0, aux: int = 0,
              width: int = 256) -> int:
        self.ops.append((op, a0, a1, a2, aux, width))
        if len(self.ops) > _PROFILES[-1][1]:
            raise TapeUnsupported("tape too long")
        # computed rows live above ALL leaf rows; encode as offset + big base
        return _STEP_BASE + len(self.ops) - 1

    def _build(self):
        for t in terms.topo_order(self.conjuncts):
            op = t.op
            if op in ("array_var", "const_array", "store"):
                if op == "array_var":
                    self.array_vars.append(t)
                    if len(self.array_vars) > _PROFILES[-1][3]:
                        raise TapeUnsupported("too many arrays")
                continue
            if op == "ite" and terms.is_array_sort(t.sort):
                continue
            if terms.is_bv_sort(t.sort) and t.width > 256:
                # wide terms (keccak preimage concats) are consumed
                # structurally by _lower_keccak; any other consumer will
                # fail the _r lookup and raise TapeUnsupported
                continue
            self._row_of[t.tid] = self._lower(t)
        for c in self.conjuncts:
            self.root_rows.append(self._row_of[c.tid])
        if len(self.root_rows) > _PROFILES[-1][5]:
            raise TapeUnsupported("too many roots")

    def _r(self, t: Term) -> int:
        row = self._row_of.get(t.tid)
        if row is None:
            raise TapeUnsupported(f"consumer of unlowered term {t.op}")
        return row

    def _lower(self, t: Term) -> int:
        op, a = t.op, t.args
        if op == "const":
            if t.sort is terms.BOOL:
                return self._const(1 if t.aux else 0)
            if t.width > 256:
                raise TapeUnsupported("wide constant")
            return self._const(t.aux)
        if op == "var":
            return self._var_row(t)
        if op == "select":
            return self._lower_select(a[0], self._r(a[1]))
        if op == "keccak":
            return self._lower_keccak(t)
        if op == "apply":
            raise TapeUnsupported("uninterpreted function")

        w = t.width if terms.is_bv_sort(t.sort) else 1

        if op == "and" or op == "or":
            code = OP_AND if op == "and" else OP_OR
            row = self._r(a[0])
            for x in a[1:]:
                row = self._emit(code, row, self._r(x), width=1)
            return row
        if op == "not":
            return self._emit(OP_XOR, self._r(a[0]), self._const(1), width=1)
        if op == "xor" and t.sort is terms.BOOL:
            return self._emit(OP_XOR, self._r(a[0]), self._r(a[1]), width=1)
        if op == "eq":
            if terms.is_array_sort(a[0].sort):
                raise TapeUnsupported("array equality")
            return self._emit(OP_EQ, self._r(a[0]), self._r(a[1]), width=1)
        if op == "ite":
            return self._emit(
                OP_ITE, self._r(a[0]), self._r(a[1]), self._r(a[2]), width=w
            )
        if op == "ult":
            return self._emit(OP_ULT, self._r(a[0]), self._r(a[1]), width=1)
        if op == "ule":
            lt = self._emit(OP_ULT, self._r(a[1]), self._r(a[0]), width=1)
            return self._emit(OP_XOR, lt, self._const(1), width=1)
        if op in ("slt", "sle"):
            wa = a[0].width
            sb = self._const(1 << (wa - 1))
            fa = self._emit(OP_XOR, self._r(a[0]), sb, width=wa)
            fb = self._emit(OP_XOR, self._r(a[1]), sb, width=wa)
            if op == "slt":
                return self._emit(OP_ULT, fa, fb, width=1)
            lt = self._emit(OP_ULT, fb, fa, width=1)
            return self._emit(OP_XOR, lt, self._const(1), width=1)

        if op == "bvnot":
            return self._emit(
                OP_XOR, self._r(a[0]), self._const(terms.mask(-1, w)), width=w
            )
        if op == "bvneg":
            return self._emit(OP_SUB, self._const(0), self._r(a[0]), width=w)
        if op == "zext":
            return self._r(a[0])  # invariant: regs are zero-extended already
        if op == "sext":
            return self._sign_extend(self._r(a[0]), a[0].width, w)
        if op == "extract":
            hi, lo = t.aux
            if lo == 0:
                # masking alone suffices; reuse the operand row via OR 0
                return self._emit(OP_OR, self._r(a[0]), self._const(0), width=w)
            return self._emit(
                OP_LSHR, self._r(a[0]), self._const(lo), width=w
            )
        if op == "concat":
            shifted = self._emit(
                OP_SHL, self._r(a[0]), self._const(a[1].width), width=w
            )
            return self._emit(OP_OR, shifted, self._r(a[1]), width=w)
        if op == "bvashr":
            ext = self._sign_extend(self._r(a[0]), w, 256)
            return self._emit(OP_ASHR, ext, self._r(a[1]), width=w)
        if op in ("bvsdiv", "bvsrem"):
            ea = self._sign_extend(self._r(a[0]), w, 256)
            eb = self._sign_extend(self._r(a[1]), w, 256)
            code = OP_SDIV if op == "bvsdiv" else OP_SREM
            return self._emit(code, ea, eb, width=w)
        simple = {
            "bvadd": OP_ADD, "bvsub": OP_SUB, "bvmul": OP_MUL,
            "bvudiv": OP_UDIV, "bvurem": OP_UREM, "bvexp": OP_EXP,
            "bvand": OP_AND, "bvor": OP_OR, "bvxor": OP_XOR,
            "bvshl": OP_SHL, "bvlshr": OP_LSHR,
        }
        code = simple.get(op)
        if code is None:
            raise TapeUnsupported(f"op {op}")
        return self._emit(code, self._r(a[0]), self._r(a[1]), width=w)

    def _sign_extend(self, row: int, from_w: int, to_w: int) -> int:
        if from_w >= to_w:
            return row
        sign = self._emit(OP_LSHR, row, self._const(from_w - 1), width=1)
        ext_bits = terms.mask(-1, to_w) ^ terms.mask(-1, from_w)
        extended = self._emit(
            OP_OR, row, self._const(ext_bits), width=to_w
        )
        return self._emit(OP_ITE, sign, extended, row, width=to_w)

    def _lower_select(self, arr: Term, idx_row: int) -> int:
        rng_w = arr.sort[2]
        if rng_w > 256 or arr.sort[1] > 256:
            raise TapeUnsupported("wide array sorts")
        if arr.op == "store":
            base, s_idx, s_val = arr.args
            below = self._lower_select(base, idx_row)
            hit = self._emit(OP_EQ, self._r(s_idx), idx_row, width=1)
            return self._emit(
                OP_ITE, hit, self._r(s_val), below, width=rng_w
            )
        if arr.op == "ite":
            c, x, y = arr.args
            then = self._lower_select(x, idx_row)
            els = self._lower_select(y, idx_row)
            return self._emit(
                OP_ITE, self._r(c), then, els, width=rng_w
            )
        if arr.op == "const_array":
            return self._r(arr.args[0])
        if arr.op == "array_var":
            slot = next(
                i for i, av in enumerate(self.array_vars) if av.tid == arr.tid
            )
            return self._emit(OP_SELECT, idx_row, aux=slot, width=rng_w)
        raise TapeUnsupported(f"array op {arr.op}")

    def _lower_keccak(self, t: Term) -> int:
        inp = t.args[0]
        if inp.width == 256:
            return self._emit(OP_KECCAK32, self._r(inp), width=256)
        if inp.width == 512 and inp.op == "concat":
            hi, lo = inp.args
            if hi.width == 256 and lo.width == 256:
                return self._emit(
                    OP_KECCAK64, self._r(lo), self._r(hi), width=256
                )
        raise TapeUnsupported(f"keccak input width {inp.width}")

    # -- finalize into padded tensors ---------------------------------------
    def finalize(self, profile) -> Optional[dict]:
        """Resolve rows against a profile; None if the profile is too small."""
        name, T, V, A, K, R = profile
        n_consts = len(self._leaf_consts)
        if (
            len(self.ops) > T
            or self.n_leaves > V
            or len(self.array_vars) > A
            or len(self.root_rows) > R
        ):
            return None

        def resolve(row: int) -> int:
            if row >= _STEP_BASE:
                return V + (row - _STEP_BASE)
            if row < 0:
                return n_consts + (-row - 1)  # var placeholder
            return row  # const leaf

        op = np.zeros(T, np.int32)
        a0 = np.zeros(T, np.int32)
        a1 = np.zeros(T, np.int32)
        a2 = np.zeros(T, np.int32)
        aux = np.zeros(T, np.int32)
        wmask = np.zeros((T, L), np.uint32)
        for i, (o, x0, x1, x2, ax, w) in enumerate(self.ops):
            op[i] = o
            a0[i] = resolve(x0)
            a1[i] = resolve(x1)
            a2[i] = resolve(x2)
            aux[i] = ax
            wmask[i] = bv.from_ints_np(terms.mask(-1, w), 256)
        root_rows = np.zeros(R, np.int32)
        root_valid = np.zeros(R, bool)
        for i, row in enumerate(self.root_rows):
            root_rows[i] = resolve(row)
            root_valid[i] = True
        leaf_consts = np.zeros((V, L), np.uint32)
        for i, v in enumerate(self._leaf_consts):
            leaf_consts[i] = bv.from_ints_np(v, 256)
        return {
            "profile": name,
            "shape": (T, V, A, K, R),
            "op": op, "a0": a0, "a1": a1, "a2": a2, "aux": aux,
            "wmask": wmask, "root_rows": root_rows, "root_valid": root_valid,
            "leaf_consts": leaf_consts, "n_consts": n_consts,
        }


_STEP_BASE = 1 << 20


# ---------------------------------------------------------------------------
# The interpreter: plain version and kernel launch
# ---------------------------------------------------------------------------

# kernel launches of csrc/tape_vm.cu (one per tape segment)
launches = 0

_KECCAK_OPS = (OP_KECCAK32, OP_KECCAK64)


def run_tape_reference(
    leaf_vals,  # [B, V, L] limbs (consts + var values)
    tab_idx,  # [B, A, K, L]
    tab_val,  # [B, A, K, L]
    tab_valid,  # [B, A, K] bool
    tab_default,  # [B, A, L]
    op, a0, a1, a2, aux,  # [T] int
    wmask,  # [T, L]
    root_rows,  # [R] int
    root_valid,  # [R] bool
    *, T: int, V: int, A: int, K: int, R: int, n_steps: Optional[int] = None,
    return_regs: bool = False,
):
    """Plain PyTorch tape interpreter -> truth [B, R] bool.

    Steps past ``n_steps`` are the profile's padding (ADD of row 0 masked to
    zero) and write rows no root reads, so they are skipped.  With
    ``return_regs`` it returns ``(truth, regs)``, the register file
    [V+T, B, 16] int64 whose first V + n_steps rows the kernel's must equal."""
    n = T if n_steps is None else n_steps
    codes = [np.asarray(x.cpu()).tolist() for x in (op, a0, a1, a2, aux)]
    dev = leaf_vals.device
    B = leaf_vals.shape[0]
    regs = torch.zeros((V + T, B, L), dtype=torch.int64, device=dev)
    regs[:V] = leaf_vals.to(torch.int64).permute(1, 0, 2)
    wm = wmask.to(torch.int64)
    t_idx = tab_idx.to(torch.int64)
    t_val = tab_val.to(torch.int64)
    t_ok = tab_valid.bool()
    t_def = tab_default.to(torch.int64)
    plain = keccak_torch.keccak_f1600_reference

    def to_word(flag):  # [B] bool -> [B, L] 0/1 word
        out = torch.zeros((B, L), dtype=torch.int64, device=dev)
        out[:, 0] = flag.to(torch.int64)
        return out

    def select(x, slot):
        hit = (t_idx[:, slot] == x[:, None, :]).all(-1) & t_ok[:, slot]  # [B, K]
        chosen = (t_val[:, slot] * hit[..., None]).sum(dim=1)
        return torch.where(hit.any(-1)[:, None], chosen, t_def[:, slot])

    for t in range(n):
        o, i0, i1, i2, slot = (c[t] for c in codes)
        x, y, z = regs[i0], regs[i1], regs[i2]
        if o == OP_ADD:
            res = bv.add(x, y, 256)
        elif o == OP_SUB:
            res = bv.sub(x, y, 256)
        elif o == OP_MUL:
            res = bv.mul(x, y, 256)
        elif o == OP_UDIV:
            res = bv.udiv(x, y, 256)
        elif o == OP_UREM:
            res = bv.urem(x, y, 256)
        elif o == OP_SDIV:
            res = bv.sdiv(x, y, 256)
        elif o == OP_SREM:
            res = bv.srem(x, y, 256)
        elif o == OP_EXP:
            res = bv.bvexp(x, y, 256)
        elif o == OP_AND:
            res = x & y
        elif o == OP_OR:
            res = x | y
        elif o == OP_XOR:
            res = x ^ y
        elif o == OP_SHL:
            res = bv.shl(x, y, 256)
        elif o == OP_LSHR:
            res = bv.lshr(x, y, 256)
        elif o == OP_ASHR:
            res = bv.ashr(x, y, 256)
        elif o == OP_EQ:
            res = to_word(bv.eq(x, y))
        elif o == OP_ULT:
            res = to_word(bv.ult(x, y))
        elif o == OP_ITE:
            res = bv.mux((x != 0).any(-1), y, z)
        elif o == OP_SELECT:
            res = select(x, slot)
        elif o == OP_KECCAK32:
            res = keccak_torch.keccak256(x, 256, permute=plain)
        elif o == OP_KECCAK64:
            # x = low 256 bits, y = high 256 bits; limbs little-endian
            res = keccak_torch.keccak256(torch.cat([x, y], dim=-1), 512, permute=plain)
        else:
            raise ValueError(f"unknown tape op {o}")
        regs[V + t] = res & wm[t]
    rows = root_rows.to(device=dev, dtype=torch.int64)
    truth = (regs[rows] != 0).any(-1)  # [R, B]
    truth = truth | ~root_valid.to(dev).bool()[:, None]
    return (truth.T, regs) if return_regs else truth.T


def _check_cuda_args(tensors: dict, B: int, T: int, V: int, A: int, K: int, R: int):
    """The tensors the kernel reads: on one CUDA device, their shape and
    type, contiguous and 16-byte aligned.  (The tape itself reaches the
    kernel through its ``TapePlan``.)"""
    want = {
        "leaf_vals": ((B, V, L), torch.int32), "tab_idx": ((B, A, K, L), torch.int32),
        "tab_val": ((B, A, K, L), torch.int32), "tab_valid": ((B, A, K), torch.uint8),
        "tab_default": ((B, A, L), torch.int32),
    }
    dev = tensors["leaf_vals"].device
    for name, (shape, dtype) in want.items():
        x = tensors[name]
        if x.device != dev or not x.is_cuda:
            raise ValueError(f"{name} must be on {dev}, got {x.device}")
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"{name}: expected {shape} {dtype}, got {tuple(x.shape)} {x.dtype}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _check_tape(host: Dict[str, np.ndarray], n: int, V: int, T: int, A: int, R: int) -> None:
    """Host-side bounds of every row the kernel will read."""
    rows = V + T
    for name in ("a0", "a1", "a2"):
        col = host[name][:n]
        if col.size and (col.min() < 0 or col.max() >= rows):
            raise ValueError(f"tape operand {name} out of range [0, {rows})")
    sel = host["aux"][:n][host["op"][:n] == OP_SELECT]
    if sel.size and (sel.min() < 0 or sel.max() >= A):
        raise ValueError(f"select slot out of range [0, {A})")
    rr = host["root_rows"][:R]
    if rr.size and (rr.min() < 0 or rr.max() >= rows):
        raise ValueError(f"root row out of range [0, {rows})")


# operands each op reads (0: a0, 1: a1, 2: a2); the others are not read
_OPERANDS = {OP_ITE: (0, 1, 2), OP_SELECT: (0,), OP_KECCAK32: (0,)}

# TapePlan.rec columns: op, the three operands' slots, aux (select slot), the
# result's slot (-1: nothing reads it), roots [root_lo, root_hi) of
# root_order that this step's result decides, then the width mask as four
# uint64_t (eight int32)
REC_INTS = 16
# a root decided before any step (TapePlan.pre): a slot, or constant 0 / 1
PRE_ZERO, PRE_ONE = -1, -2


class Segment(NamedTuple):
    """One kernel launch of a tape: plain steps [t_begin, t_end), the keccak
    step squeezed first and the one absorbed last (-1: none), and the
    spilled slots reloaded first and stored last, the leaves and the
    tables loaded first, each as (offset, count) into ``TapePlan.live`` /
    ``.leaves`` / ``.tables``."""

    t_begin: int
    t_end: int
    squeeze: int
    absorb: int
    live_in: Tuple[int, int]
    live_out: Tuple[int, int]
    leaves: Tuple[int, int]
    tables: Tuple[int, int]


def _pad4(a: np.ndarray) -> np.ndarray:
    return np.concatenate([a.ravel(), np.zeros(-a.size % 4, np.int32)]).astype(np.int32)


class TapePlan:
    """Port-only: how the kernel runs a tape's first ``n`` steps with its
    values in an on-chip slot file (``csrc/tape_vm.cu``).

    Built from ``TapeProgram.finalize``'s tensors, which it leaves as they
    are.  Slots ``[0, S)`` of a candidate: first the step results that a
    later step reads, a slot reused only after its value's last read; then
    the leaves the tape reads, from ``leaf_base``, each loaded at the start
    of every segment that reads it; then, for each array a SELECT step reads,
    K + 1 slots: its table's K index words and the mask of its valid rows,
    loaded like the leaves (a SELECT's z operand names the first of them);
    then, if an operand names a row not yet written (which reads as zero), a
    slot holding zero.  An operand the op does not read names slot 0.  A
    root's truth is written as soon as its row is final, so a value that
    only roots read needs no slot; roots no step decides (invalid, on a
    leaf, or on a row past ``n``) are ``pre``.  Keccak
    steps split the tape into segments (one kernel launch each); the slots
    live across a keccak step are spilled to device memory at the segment's
    end and reloaded at the next one's start.

    Arrays (int32): ``rec`` [n, REC_INTS]; ``root_order`` [R]; ``pre``
    [n_pre, 2], (root, leaf slot or PRE_*); ``leaves`` [., 2], (slot, leaf
    row) pairs, and ``tables`` [., 2], (first slot, array) pairs, each
    segment's list padded to an even length; ``live``, the spilled slots of
    every keccak boundary, concatenated.  ``segments``: ``Segment`` tuples,
    the lists as ``(offset, count)`` into ``leaves`` and ``tables`` (in
    pairs) and ``live``."""

    def __init__(self, tape: Dict[str, np.ndarray], n: int, V: int, T: int, A: int, K: int,
                 R: int):
        _check_tape(tape, n, V, T, A, R)
        op = [int(o) for o in tape["op"][:n]]
        srcs = [[int(tape[k][t]) for k in ("a0", "a1", "a2")] for t in range(n)]
        reads = []  # per step: the rows it reads, None for an operand it ignores
        for t in range(n):
            used = _OPERANDS.get(op[t], (0, 1))
            reads.append([srcs[t][j] if j in used else None for j in range(3)])
        last_read: Dict[int, int] = {}
        for t in range(n):
            for row in reads[t]:
                if row is not None and V <= row < V + t:
                    last_read[row] = t

        slot = [-1] * n
        free: List[int] = []
        S = 0
        for t in range(n):
            for row in set(reads[t]):  # operands are read before the result is written
                if row is not None and last_read.get(row) == t:
                    heapq.heappush(free, slot[row - V])
            if V + t in last_read:
                if free:
                    slot[t] = heapq.heappop(free)
                else:
                    slot[t], S = S, S + 1

        pre_roots, roots = [], [[] for _ in range(n)]
        for r in range(R):
            row = int(tape["root_rows"][r])
            if bool(tape["root_valid"][r]) and V <= row < V + n:
                roots[row - V].append(r)
            else:
                pre_roots.append((r, row if tape["root_valid"][r] else None))
        leaves = sorted({row for rs in reads for row in rs if row is not None and row < V}
                        | {row for _, row in pre_roots if row is not None and row < V})
        self.leaf_base = S
        leaf_slot = {row: S + i for i, row in enumerate(leaves)}
        S += len(leaves)
        arrays = sorted({int(tape["aux"][t]) for t in range(n) if op[t] == OP_SELECT})
        table_slot = {a: S + i * (K + 1) for i, a in enumerate(arrays)}
        S += len(arrays) * (K + 1)
        needs_zero = any(row is not None and row >= V + t
                         for t, rs in enumerate(reads) for row in rs)
        self.zero_slot = S if needs_zero else -1
        S += needs_zero
        self.n, self.S, self.slot = n, S, slot

        def src(row, t):
            if row is None:  # not read
                return 0
            if row < V:
                return leaf_slot[row]
            return self.zero_slot if row >= V + t else slot[row - V]

        pre = [(r, PRE_ONE if row is None else leaf_slot[row] if row < V else PRE_ZERO)
               for r, row in pre_roots]
        self.pre = np.asarray(pre, np.int32).reshape(-1, 2)
        order = [r for r, _ in pre_roots]
        rec = np.zeros((n, REC_INTS), np.int32)
        limbs = tape["wmask"][:n].astype(np.uint32).reshape(n, 8, 2)
        rec[:, 8:] = (limbs[..., 0] | (limbs[..., 1] << 16)).view(np.int32)
        for t in range(n):
            lo = len(order)
            order += roots[t]
            rec[t, :8] = (op[t], *(src(row, t) for row in reads[t]), int(tape["aux"][t]),
                          slot[t], lo, len(order))
            if op[t] == OP_SELECT:  # z names the array's table
                rec[t, 3] = table_slot[int(tape["aux"][t])]
        self.rec = rec
        self.root_order = np.asarray(order, np.int32)

        keccak = [t for t in range(n) if op[t] in _KECCAK_OPS]
        live: List[int] = []
        bounds = []
        for k in keccak:
            spilled = sorted(slot[row - V] for row, last in last_read.items()
                             if row < V + k and last > k)
            bounds.append((len(live), len(spilled)))
            live += spilled
        self.live = np.asarray(live, np.int32)
        self.n_spill = max((c for _, c in bounds), default=0)
        spans, begin = [], 0
        for k in keccak:
            spans.append((begin, k))
            begin = k + 1
        spans.append((begin, n))
        lists: Dict[str, List[Tuple[int, int]]] = {"leaves": [], "tables": []}

        def add(name, pairs):  # -> (offset, count); each list from a 16-byte boundary
            out = lists[name]
            span = (len(out), len(pairs))
            out += pairs + [(0, 0)] * (len(pairs) % 2)
            return span

        self.segments = []
        for j, (begin, end) in enumerate(spans):
            absorb = keccak[j] if j < len(keccak) else -1
            rows = {row for t in range(begin, max(end, absorb + 1)) for row in reads[t]
                    if row is not None and row < V}
            if j == 0:
                rows |= {row for _, row in pre_roots if row is not None and row < V}
            used = sorted({int(tape["aux"][t]) for t in range(begin, end) if op[t] == OP_SELECT})
            self.segments.append(Segment(
                begin, end, keccak[j - 1] if j else -1, absorb,
                bounds[j - 1] if j else (0, 0), bounds[j] if j < len(keccak) else (0, 0),
                add("leaves", [(leaf_slot[row], row) for row in sorted(rows)]),
                add("tables", [(table_slot[a], a) for a in used])))
        self.leaves = np.asarray(lists["leaves"], np.int32).reshape(-1, 2)
        self.tables = np.asarray(lists["tables"], np.int32).reshape(-1, 2)
        self._device: Dict[str, Tuple[torch.Tensor, Dict[str, int]]] = {}

    def device_arrays(self, device) -> Tuple[torch.Tensor, Dict[str, int]]:
        """``rec``, ``root_order``, ``pre``, ``leaves``, ``tables`` and
        ``live`` in one int32 tensor on ``device`` (each part from a 16-byte
        boundary), uploaded once, and each part's byte offset."""
        key = str(torch.device(device))
        if key not in self._device:
            parts = {"rec": self.rec, "root_order": self.root_order, "pre": self.pre,
                     "leaves": self.leaves, "tables": self.tables, "live": self.live}
            offsets, at = {}, 0
            for name, a in parts.items():
                offsets[name] = 4 * at
                at += _pad4(a).size
            host = np.concatenate([_pad4(a) for a in parts.values()])
            self._device[key] = (torch.from_numpy(host).to(device), offsets)
        return self._device[key]


def run_segments(
    leaf_vals, tab_idx, tab_val, tab_valid, tab_default,
    op, a0, a1, a2, aux, wmask, root_rows, root_valid,
    *, T: int, V: int, A: int, K: int, R: int, plan: TapePlan, segment, permute,
    regs: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Drive the tape as the kernel runs it: one segment per run of plain
    steps, split at keccak steps.  The tape itself comes from ``plan``; of
    the tape tensors only the leaves and the tables are read here.
    ``segment(TapeArgs)`` runs one segment (``mk_tape_vm_segment``);
    ``permute(kstate)`` is keccak-f[1600] on the absorbed [B, 25, 4] states.
    ``regs``: a [V+T, 16, B] int32 tensor that receives every leaf and every
    step's value, for checks; the kernel itself keeps none.  Returns truth
    [B, R] bool."""
    from mythril_tpu_torch.ops import _build

    B = leaf_vals.shape[0]
    dev = leaf_vals.device
    if regs is not None:
        if tuple(regs.shape) != (V + T, L, B) or regs.dtype != torch.int32 or not regs.is_contiguous():
            raise ValueError(f"regs: expected contiguous {(V + T, L, B)} int32")
        regs[:V] = leaf_vals.permute(1, 2, 0)
    truth = torch.empty((B, R), dtype=torch.bool, device=dev)
    arr, off = plan.device_arrays(dev)
    base = arr.data_ptr()
    keccak = len(plan.segments) > 1
    kstate = torch.empty((B, 25, 4), dtype=torch.int32, device=dev) if keccak else None
    spill = (torch.empty((plan.n_spill, 4, B), dtype=torch.int64, device=dev)
             if plan.n_spill else None)
    ptr = lambda x: x.data_ptr() if x is not None else None  # noqa: E731
    targs = _build.TapeArgs(
        base + off["rec"], base + off["root_order"], base + off["pre"], None, None,
        ptr(leaf_vals), ptr(tab_idx), ptr(tab_val), ptr(tab_valid), ptr(tab_default),
        ptr(kstate), ptr(spill), None, None, ptr(truth), ptr(regs),
        V, T, A, K, R, B, plan.S, 0, 0, plan.zero_slot, len(plan.pre),
    )
    live, leaves, tables = base + off["live"], base + off["leaves"], base + off["tables"]
    for seg in plan.segments:
        targs.t_begin, targs.t_end = seg.t_begin, seg.t_end
        targs.squeeze_step, targs.absorb_step = seg.squeeze, seg.absorb
        targs.leaves, targs.n_leaf = leaves + 8 * seg.leaves[0], seg.leaves[1]
        targs.tables, targs.n_table = tables + 8 * seg.tables[0], seg.tables[1]
        targs.live_in, targs.n_live_in = live + 4 * seg.live_in[0], seg.live_in[1]
        targs.live_out, targs.n_live_out = live + 4 * seg.live_out[0], seg.live_out[1]
        segment(targs)
        targs.n_pre = 0  # the first segment decides the roots no step decides
        if seg.absorb >= 0:
            kstate = permute(kstate)
            targs.kstate = kstate.data_ptr()
    return truth


def _run_tape_cuda(*args, T: int, V: int, A: int, K: int, R: int, n_steps: int,
                   plan: Optional[TapePlan] = None,
                   regs: Optional[torch.Tensor] = None) -> torch.Tensor:
    from mythril_tpu_torch.ops import _build, keccak_cuda

    names = ("leaf_vals", "tab_idx", "tab_val", "tab_valid", "tab_default", "op",
             "a0", "a1", "a2", "aux", "wmask", "root_rows", "root_valid")
    tensors = dict(zip(names, args))
    _check_cuda_args(tensors, args[0].shape[0], T, V, A, K, R)
    if plan is None:
        plan = TapePlan({k: tensors[k].cpu().numpy() for k in names[5:]}, n_steps, V, T, A, K, R)
    elif plan.n != n_steps:
        raise ValueError(f"plan covers {plan.n} steps, not {n_steps}")
    dev = args[0].device
    lib = _build.load()

    def segment(targs):
        global launches
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(lib.mk_tape_vm_segment(ctypes.byref(targs), stream), "tape_vm")
        launches += 1

    with torch.cuda.device(dev):
        return run_segments(*args, T=T, V=V, A=A, K=K, R=R, plan=plan, segment=segment,
                            permute=keccak_cuda.keccak_f1600, regs=regs)


def run_tape(*args, T: int, V: int, A: int, K: int, R: int,
             n_steps: Optional[int] = None,
             plan: Optional[TapePlan] = None,
             regs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Evaluate the tape over a candidate batch -> truth [B, R] bool.

    CUDA tensors launch the kernels (or raise); CPU tensors take the plain
    version.  Arguments are ``TapeCompiled.pack_args``'s tuple.  CUDA only:
    ``plan``, the tape's ``TapePlan`` over ``n_steps`` (``TapeCompiled.plan``;
    else built here from the tape tensors); ``regs``, a register file to
    receive every step's value, see ``run_segments``."""
    n = T if n_steps is None else n_steps
    if args[0].is_cuda:
        return _run_tape_cuda(*args, T=T, V=V, A=A, K=K, R=R, n_steps=n, plan=plan, regs=regs)
    if regs is not None:
        raise ValueError("regs receives the CUDA kernel's values; the plain version keeps its own")
    return run_tape_reference(*args, T=T, V=V, A=A, K=K, R=R, n_steps=n)


# ---------------------------------------------------------------------------
# Public adapter (mirrors the JAX package's TapeCompiled)
# ---------------------------------------------------------------------------


class TapeCompiled:
    """Evaluate a conjunction over candidate batches via the shared VM."""

    def __init__(self, program: TapeProgram, tensors: dict):
        self.program = program
        self.tensors = tensors
        self.conjuncts = program.conjuncts
        self.bv_vars = program.bv_vars
        self.bool_vars = program.bool_vars
        self.array_vars = program.array_vars
        self._plan: Optional[TapePlan] = None

    @property
    def n_steps(self) -> int:
        return len(self.program.ops)

    @property
    def plan(self) -> TapePlan:
        """The kernel's slot plan of this tape, built at first use."""
        if self._plan is None:
            T, V, A, K, R = self.tensors["shape"]
            self._plan = TapePlan(self.tensors, self.n_steps, V, T, A, K, R)
        return self._plan

    def evaluate_batch(self, assignments, device) -> np.ndarray:
        args, (T, V, A, K, R) = self.pack_args(assignments, device)
        plan = self.plan if args[0].is_cuda else None
        truth = run_tape(*args, T=T, V=V, A=A, K=K, R=R, n_steps=self.n_steps, plan=plan)
        return truth.cpu().numpy()[: len(assignments), : len(self.conjuncts)]

    def pack_host(self, assignments) -> Tuple[tuple, tuple]:
        """Candidate assignments -> the interpreter's inputs as numpy arrays
        (the JAX package's ``pack_args`` layout) + the profile shape."""
        t = self.tensors
        T, V, A, K, R = t["shape"]
        B_real = len(assignments)
        B = next((b for b in _BATCH_BUCKETS if b >= B_real), None)
        if B is None:
            B = ((B_real + 255) // 256) * 256

        leaf_vals = np.tile(t["leaf_consts"][None], (B, 1, 1))
        n_consts = t["n_consts"]
        n = len(assignments)
        for vi, var in enumerate(self.program.leaf_vars):
            vals = [int(asg.scalars.get(var, 0)) for asg in assignments]
            leaf_vals[:n, n_consts + vi] = bv.from_ints_np(vals, 256)

        tab_idx = np.zeros((B, A, K, L), np.uint32)
        tab_val = np.zeros((B, A, K, L), np.uint32)
        tab_valid = np.zeros((B, A, K), bool)
        tab_default = np.zeros((B, A, L), np.uint32)
        for ai, av in enumerate(self.program.array_vars):
            keys = sorted(
                {
                    k
                    for asg in assignments
                    for k in getattr(asg.arrays.get(av), "backing", {})
                }
            )[:K]
            arrs = [asg.arrays.get(av) for asg in assignments]
            defaults = [int(a.default) if a is not None else 0 for a in arrs]
            tab_default[:n, ai] = bv.from_ints_np(defaults, 256)
            if keys:
                tab_idx[:, ai, : len(keys)] = bv.from_ints_np(keys, 256)[None]
                tab_valid[:n, ai, : len(keys)] = True
                for ki, k in enumerate(keys):
                    vals = [
                        int(a.backing.get(k, d)) if a is not None else 0
                        for a, d in zip(arrs, defaults)
                    ]
                    tab_val[:n, ai, ki] = bv.from_ints_np(vals, 256)

        host = (
            leaf_vals, tab_idx, tab_val, tab_valid, tab_default,
            t["op"], t["a0"], t["a1"], t["a2"], t["aux"], t["wmask"],
            t["root_rows"], t["root_valid"],
        )
        return host, (T, V, A, K, R)

    def pack_args(self, assignments, device) -> Tuple[tuple, tuple]:
        """``pack_host``'s arrays as torch tensors on ``device``: limbs and
        indices int32, flags uint8 (the kernel's types)."""
        host, shape = self.pack_host(assignments)
        args = tuple(
            torch.from_numpy(
                np.ascontiguousarray(x, dtype=np.uint8 if x.dtype == bool else np.int32)
            ).to(device)
            for x in host
        )
        return args, shape


_CACHE: Dict[tuple, TapeCompiled] = {}
_CACHE_CAP = 4096


def compile_tape(conjuncts: Sequence[Term]) -> TapeCompiled:
    """Assemble (and cache) the tape for a conjunction.

    Raises TapeUnsupported when the DAG exceeds every profile or contains
    structure the VM cannot express.
    """
    key = tuple(c.tid for c in conjuncts)
    hit = _CACHE.get(key)
    if hit is not None:
        return hit
    program = TapeProgram(conjuncts)
    tensors = None
    for profile in _PROFILES:
        tensors = program.finalize(profile)
        if tensors is not None:
            break
    if tensors is None:
        raise TapeUnsupported("exceeds every profile")
    compiled = TapeCompiled(program, tensors)
    if len(_CACHE) >= _CACHE_CAP:
        _CACHE.clear()
    _CACHE[key] = compiled
    return compiled
