"""The device segment: K lockstep instruction steps over the batch.

The port of ``mythril_tpu/frontier/step.py``: one call executes up to
``caps.K`` EVM instructions for every live path of the frontier.  Each step
has two phases, as in the JAX program:

  1. per path: decode against the page window, pop up to 7 operands,
     dispatch one of the 33 handler families (``ops.F_*``), fold constants
     with the 256-bit limb algebra, write up to R new arena rows, record an
     event, ask for a fork;
  2. over the batch: coverage planes, arena row reservation by live rank,
     the row scatter, the fork grant into free slots (a stable rank by the
     ``SEL_*`` score), the child copy, the branch updates and E_FORK events.

The loop stops after ``min(cfg.k_limit, caps.K)`` steps, when no path is
live, or when the arena has no room for ``n_live * R`` more rows.

Two implementations compute the same outputs bit for bit:

* ``segment_torch``, the plain PyTorch version: the JAX program's dataflow
  written out over a batch dimension (every handler computed for every path,
  then selected by family, with the same clamps and drops).  The CPU tests
  hold it against the JAX segment, and ``chip_smoke.py`` holds the kernel
  against it on the card.
* ``segment_cuda``, the CUDA kernel ``csrc/frontier_segment.cu``: one
  cooperative launch runs the whole loop on the card (``frontier_segment.cuh``).

On a mesh the state is partitioned over the path axis (``ShardedState``:
slot block k on the mesh's k-th device) and two more implementations take
it, again bit for bit the same: ``segment_partitioned``, the kernel's shard
form (one launch per card over its block, the fork grant's ranks and free
slots across cards on every step, a barrier in the first card's memory;
one launch holding every block for logical shards of one card), and
``segment_partitioned_torch``, its plain version, block by block.

``cached_segment(..., device=None)`` returns a ``segment`` with the JAX
signature; it runs the kernel on CUDA tensors and the plain version only on
CPU tensors, which the caller asks for with ``device="cpu"``, in the
partitioned form when it is given a ``ShardedState``.  The synchronous transfers
(``push_state``, ``pull_harvest``, ``pull_arena_rows``, ``push_arena_rows``)
are plain torch.  Indexing follows XLA's rules, which the code spells out:
a gather clamps its index into bounds (a negative index wraps once first),
and a ``mode="drop"`` scatter drops an index outside the bounds.  int32
arithmetic wraps.
"""

from __future__ import annotations

import ctypes
import dataclasses
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from mythril_tpu_torch import device as _device
from mythril_tpu_torch.frontier import ops as O
from mythril_tpu_torch.frontier.code import CTX_ADDRESS, CTX_BALANCES, CTX_SEED, CTX_STORAGE
from mythril_tpu_torch.frontier.state import Caps, FrontierState
from mythril_tpu_torch.observability import deviceplane as _devplane
from mythril_tpu_torch.observability import tracer as _otrace
from mythril_tpu_torch.ops import bitvec as bv

I32 = torch.int32
INT32_MAX = (1 << 31) - 1


class ArenaDev(NamedTuple):
    op: torch.Tensor  # [T] int32
    a: torch.Tensor  # [T] int32
    b: torch.Tensor  # [T] int32
    c: torch.Tensor  # [T] int32
    width: torch.Tensor  # [T] int32
    val: torch.Tensor  # [T, 16] int32 holding 16-bit limbs (JAX: uint32)
    isconst: torch.Tensor  # [T] bool


class NewRows(NamedTuple):
    """R rows a path may write this step ([B, R], val [B, R, 16])."""

    op: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor
    width: torch.Tensor
    val: torch.Tensor
    isconst: torch.Tensor


class Fork(NamedTuple):
    want: torch.Tensor  # [B] bool
    target: torch.Tensor  # instruction index of the taken branch
    dest_row: torch.Tensor
    word_row: torch.Tensor
    cond_row: torch.Tensor  # bool row for the taken constraint
    ncond_row: torch.Tensor  # bool row for the fall-through constraint


class CodeDev(NamedTuple):
    """Per-instruction dispatch tables with a leading [C] code axis (see the
    JAX package's ``CodeDev``); every path indexes them by its code id."""

    fam: torch.Tensor  # [C, N] int32
    aux: torch.Tensor  # [C, N] int32
    arity: torch.Tensor  # [C, N] int32
    gmin: torch.Tensor  # [C, N] int32
    gmax: torch.Tensor  # [C, N] int32
    event: torch.Tensor  # [C, N] bool
    jumpmap: torch.Tensor  # [C, ADDR_CAP] int32
    loopid: torch.Tensor  # [C, N] int32
    concskip: torch.Tensor  # [C, N] bool
    valgate: torch.Tensor  # [C, N] bool
    pbase: torch.Tensor  # [C] int32 resident-window start per code


class CfgScalars(NamedTuple):
    """Run-config scalars (plain ints: no rebuild on change)."""

    max_depth: int
    loop_bound: int  # 0 disables the bound
    row_zero: int  # arena row of const 0
    row_one: int  # arena row of const 1
    sel_mode: int  # fork-grant priority under slot scarcity (SEL_*)
    k_limit: int = 1 << 30  # per-segment step limit (<= caps.K)


# fork-grant selection modes (cfg.sel_mode)
SEL_NONE = 0  # slot order
SEL_DEEP = 1  # deepest parents first
SEL_SHALLOW = 2  # shallowest parents first
SEL_COVERAGE = 3  # forks targeting not-yet-visited code first
SEL_BEAM = 4  # highest beam score first


# ---------------------------------------------------------------------------
# XLA's indexing and int32 rules, in torch
# ---------------------------------------------------------------------------


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wrap."""
    return (((x.long() + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(I32)


def _gidx(i: torch.Tensor, n: int) -> torch.Tensor:
    """A gather index as XLA takes it: a negative index wraps once, then the
    index is clamped into [0, n)."""
    i = i.long()
    return torch.where(i < 0, i + n, i).clamp(0, n - 1)


def _sidx(i: torch.Tensor, n: int):
    """A scatter index as XLA takes it: (wrapped index, in-bounds mask)."""
    i = i.long()
    i = torch.where(i < 0, i + n, i)
    return i, (i >= 0) & (i < n)


def _floordiv(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def _sel(m: torch.Tensor, a, b):
    """where(m, a, b) with a [B] mask broadcast over trailing dims."""
    a = torch.as_tensor(a, device=m.device)
    b = torch.as_tensor(b, device=m.device)
    nd = max(a.dim(), b.dim())
    return torch.where(m.reshape(m.shape + (1,) * (nd - 1)), a, b)


def _memgas(size: torch.Tensor) -> torch.Tensor:
    w = _floordiv(size, 32)
    return 3 * w + _floordiv(_wrap32(w.long() * w.long()), 512)


# ---------------------------------------------------------------------------
# the plain segment
# ---------------------------------------------------------------------------

_BIN_FOLDS = {
    O.A_ADD: lambda x, y: bv.add(x, y, 256),
    O.A_SUB: lambda x, y: bv.sub(x, y, 256),
    O.A_MUL: lambda x, y: bv.mul(x, y, 256),
    O.A_AND: lambda x, y: bv.and_(x, y, 256),
    O.A_OR: lambda x, y: bv.or_(x, y, 256),
    O.A_XOR: lambda x, y: bv.xor(x, y, 256),
    O.A_SHL: lambda x, y: bv.shl(x, y, 256),
    O.A_LSHR: lambda x, y: bv.lshr(x, y, 256),
    O.A_ASHR: lambda x, y: bv.ashr(x, y, 256),
}

_MUTABLE = ("pc", "halt", "stack", "stack_len", "mem_addr", "mem_val", "mem_len", "mem_size",
            "sto_key", "sto_val", "sto_len", "ctx", "cons", "cons_len", "gas_min", "gas_max",
            "depth", "loops")


def _path_step(st: FrontierState, ids, arena: ArenaDev, code: CodeDev, cfg: CfgScalars,
               caps: Caps):
    """One step of every path (the JAX ``path_step`` under ``vmap``).
    -> (new state, rows [B, R], fork)."""
    R, STK, MEM, STO, CON, EVT = caps.R, caps.STK, caps.MEM, caps.STO, caps.CON, caps.EVT
    dev = st.pc.device
    B = st.pc.shape[0]
    C, N = code.fam.shape
    T = arena.op.shape[0]
    A = code.jumpmap.shape[1]
    NL = st.loops.shape[1]
    ar = torch.arange(B, device=dev)
    i32 = lambda v: torch.full((B,), v, dtype=I32, device=dev)  # noqa: E731

    cid = st.code_id.clamp(0, C - 1).long()
    rel = st.pc - code.pbase[cid]
    infault = (rel < 0) | (rel >= N)
    pc = rel.clamp(0, N - 1).long()
    fam = torch.where(infault, i32(O.F_PAGEFAULT), code.fam[cid, pc])
    aux = code.aux[cid, pc]
    arity = torch.where(infault, i32(0), code.arity[cid, pc])
    running = (st.halt == O.H_RUNNING) & (st.seed >= 0)
    row_zero, row_one = i32(cfg.row_zero), i32(cfg.row_one)

    pops = torch.stack([
        torch.where(j < arity, st.stack[ar, (st.stack_len - 1 - j).clamp(0, STK - 1).long()], i32(-1))
        for j in range(7)
    ], 1)  # [B, 7]
    underflow = st.stack_len < arity
    pop_c = torch.where(pops >= 0, arena.isconst[pops.clamp(0, T - 1).long()],
                        torch.zeros_like(pops, dtype=torch.bool))
    pop_v = arena.val[pops.clamp(0, T - 1).long()].long()  # [B, 7, 16] limbs

    def conc_from(c, v):
        small = c & (v[:, 2:].amax(1) == 0) & (v[:, 1] < 16)
        return small, _wrap32(v[:, 0] | (v[:, 1] << 16))

    ok_addr0, addr0 = conc_from(pop_c[:, 0], pop_v[:, 0])
    ok_addr1, addr1 = conc_from(pop_c[:, 1], pop_v[:, 1])
    jidx0 = code.jumpmap[cid, addr0.clamp(0, A - 1).long()]
    valid0 = (addr0 < A) & (jidx0 >= 0)
    lid_pc = code.loopid[cid, pc]

    def zrows(fill_abc=-1):
        z = torch.zeros((B, R), dtype=I32, device=dev)
        return NewRows(op=z, a=z + fill_abc, b=z + fill_abc, c=z + fill_abc, width=z,
                       val=torch.zeros((B, R, 16), dtype=torch.long, device=dev),
                       isconst=torch.zeros((B, R), dtype=torch.bool, device=dev))

    rows0 = zrows()
    no_fork = Fork(want=torch.zeros(B, dtype=torch.bool, device=dev), target=i32(0),
                   dest_row=i32(-1), word_row=i32(-1), cond_row=i32(-1), ncond_row=i32(-1))

    def set_row(rows, k, op, a=-1, b=-1, c=-1, width=256, val=None, isconst=False):
        cols = {}
        for name, v in (("op", op), ("a", a), ("b", b), ("c", c), ("width", width),
                        ("isconst", isconst)):
            col = getattr(rows, name).clone()
            col[:, k] = torch.as_tensor(v, device=dev).to(col.dtype)
            cols[name] = col
        vals = rows.val
        if val is not None:
            vals = vals.clone()
            vals[:, k] = val
        return NewRows(val=vals, **cols)

    def sel_tree(m, a, b):
        return type(a)(*[_sel(m, x, y) for x, y in zip(a, b)])

    # an Out is (state fields dict, rows, fork, res); fields absent from the
    # dict are the incoming state's
    def out(fields=None, rows=rows0, fork=no_fork, res=None):
        return (dict(fields or {}), rows, fork, i32(-1) if res is None else res)

    def halted(kind):
        return out({"halt": i32(kind)})

    def guard(good, o, kind=O.H_PARK):
        """where(good, o, halted(kind)) over the whole Out."""
        fields, rows, fork, res = o
        g = {k: _sel(good, v, getattr(st, k)) for k, v in fields.items()}
        g["halt"] = _sel(good, fields.get("halt", st.halt), i32(kind))
        return (g, sel_tree(good, rows, rows0), sel_tree(good, fork, no_fork),
                _sel(good, res, i32(-1)))

    def push1(stack, length, row):
        ok = length < STK
        i = length.clamp(0, STK - 1).long()
        stack = stack.clone()
        stack[ar, i] = torch.where(ok, row, stack[ar, i])
        return stack, length + 1, ok

    def pushed(rows, row, res=None):
        stack, length, ok = push1(st.stack, st.stack_len - arity, row)
        return out({"stack": stack, "stack_len": length}, rows=rows,
                   res=row if res is None else res), ok

    def set_at(x, idx, v, mask=None):
        x = x.clone()
        if mask is None:
            x[ar, idx.long()] = v
        else:
            x[ar, idx.long()] = torch.where(mask, v, x[ar, idx.long()])
        return x

    def ctx_at(k):
        return st.ctx[ar, _gidx(torch.as_tensor(k, device=dev).expand(B), st.ctx.shape[1])]

    live_mem = torch.arange(MEM, device=dev)[None, :] < st.mem_len[:, None]

    def mem_lookup(addr):
        hit = (st.mem_addr == addr[:, None]) & live_mem
        return hit.any(1), st.mem_val[ar, hit.int().argmax(1)]

    def mem_overlap_miss(addr):
        d = st.mem_addr - addr[:, None]
        near = (torch.abs(d) < 32) & live_mem
        exact = (st.mem_addr == addr[:, None]) & live_mem
        return (near & ~exact).any(1)

    def mem_gas(fields, addr, size):
        size0 = fields.get("mem_size", st.mem_size)
        new_size = torch.maximum(size0, _floordiv(addr + size + 31, 32) * 32)
        cost = _memgas(new_size) - _memgas(size0)
        f = dict(fields)
        f.update(mem_size=new_size, gas_min=fields.get("gas_min", st.gas_min) + cost,
                 gas_max=fields.get("gas_max", st.gas_max) + cost)
        return f

    limb0 = lambda x: torch.nn.functional.pad(x.long()[:, None], (0, 15))  # noqa: E731

    # ----- handlers ------------------------------------------------------

    def h_park():
        return halted(O.H_PARK)

    def h_page_fault():
        return halted(O.H_PAGE_FAULT)

    def h_stop():
        return halted(O.H_STOP)

    def h_push_checked():
        o, ok = pushed(rows0, aux)
        return guard(ok, o)

    def h_dup():
        row = st.stack[ar, (st.stack_len - aux).clamp(0, STK - 1).long()]
        stack, length, ok = push1(st.stack, st.stack_len, row)
        return guard(ok, out({"stack": stack, "stack_len": length}, res=row))

    def h_swap():
        i = (st.stack_len - 1).clamp(0, STK - 1).long()
        j = (st.stack_len - 1 - aux).clamp(0, STK - 1).long()
        a, b = st.stack[ar, i], st.stack[ar, j]
        stack = st.stack.clone()
        stack[ar, i] = b
        stack[ar, j] = a
        return out({"stack": stack})

    def h_pop():
        return out({"stack_len": st.stack_len - 1})

    def h_binop():
        opc = aux & 0xFF
        swap = (aux & 256) != 0
        p0, p1 = pops[:, 0], pops[:, 1]
        left, right = torch.where(swap, p1, p0), torch.where(swap, p0, p1)
        foldable = torch.zeros(B, dtype=torch.bool, device=dev)
        for k in _BIN_FOLDS:
            foldable = foldable | (opc == k)
        both_const = pop_c[:, 0] & pop_c[:, 1] & foldable
        lv = _sel(swap, pop_v[:, 1], pop_v[:, 0])
        rv = _sel(swap, pop_v[:, 0], pop_v[:, 1])
        folded = torch.zeros((B, 16), dtype=torch.long, device=dev)
        for k, fn in _BIN_FOLDS.items():
            folded = _sel(opc == k, fn(lv, rv), folded)
        rows_c = set_row(rows0, 0, O.A_CONST, val=folded, isconst=True)
        rows_s = set_row(rows0, 0, opc, a=left, b=right)
        o, ok = pushed(sel_tree(both_const, rows_c, rows_s), ids[:, 0])
        return guard(ok, o)

    def h_cmp():
        p0, p1 = pops[:, 0], pops[:, 1]
        both_const = pop_c[:, 0] & pop_c[:, 1]
        lv, rv = pop_v[:, 0], pop_v[:, 1]
        t = torch.zeros(B, dtype=torch.bool, device=dev)
        for k, fn in (
            (O.A_ULT, lambda: bv.ult(lv, rv)),
            (O.A_UGT, lambda: bv.ult(rv, lv)),
            (O.A_SLT, lambda: bv.slt(lv, rv, 256)),
            (O.A_SGT, lambda: bv.slt(rv, lv, 256)),
            (O.A_EQ, lambda: bv.eq(lv, rv)),
        ):
            t = torch.where(aux == k, fn(), t)
        const_row = torch.where(t, row_one, row_zero)
        rows_s = set_row(rows0, 0, aux, a=p0, b=p1, width=0)
        rows_s = set_row(rows_s, 1, O.A_ITEW, a=ids[:, 0], b=row_one, c=row_zero)
        res_row = torch.where(both_const, const_row, ids[:, 1])
        o, ok = pushed(sel_tree(both_const, rows0, rows_s), res_row)
        return guard(ok, o)

    def h_iszero():
        is_c = pop_c[:, 0]
        const_row = torch.where(bv.is_zero(pop_v[:, 0]), row_one, row_zero)
        rows_s = set_row(rows0, 0, O.A_EQZ, a=pops[:, 0], width=0)
        rows_s = set_row(rows_s, 1, O.A_ITEW, a=ids[:, 0], b=row_one, c=row_zero)
        res_row = torch.where(is_c, const_row, ids[:, 1])
        o, ok = pushed(sel_tree(is_c, rows0, rows_s), res_row)
        return guard(ok, o)

    def h_not():
        is_c = pop_c[:, 0]
        rows_c = set_row(rows0, 0, O.A_CONST, val=bv.not_(pop_v[:, 0], 256), isconst=True)
        rows_s = set_row(rows0, 0, O.A_NOT, a=pops[:, 0])
        o, ok = pushed(sel_tree(is_c, rows_c, rows_s), ids[:, 0])
        return guard(ok, o)

    def h_envpush():
        o, ok = pushed(rows0, ctx_at(aux))
        return guard(ok, o)

    def h_calldataload():
        rows = set_row(rows0, 0, O.A_CDLOAD, a=pops[:, 0], b=ctx_at(CTX_SEED))
        o, ok = pushed(rows, ids[:, 0])
        return guard(ok, o)

    def h_balance():
        rows = set_row(rows0, 0, O.A_SELECT, a=ctx_at(CTX_BALANCES), b=pops[:, 0])
        o, ok = pushed(rows, ids[:, 0])
        return guard(ok, o)

    def h_selfbalance():
        rows = set_row(rows0, 0, O.A_SELECT, a=ctx_at(CTX_BALANCES), b=ctx_at(CTX_ADDRESS))
        o, ok = pushed(rows, ids[:, 0])
        return guard(ok, o)

    def h_gaspush():
        rows = set_row(rows0, 0, O.A_VARF, a=pc)
        o, ok = pushed(rows, ids[:, 0])
        return guard(ok, o)

    def h_msize():
        size = st.mem_size.long() & 0xFFFFFFFF
        val = torch.zeros((B, 16), dtype=torch.long, device=dev)
        val[:, 0], val[:, 1] = size & 0xFFFF, size >> 16
        o, ok = pushed(set_row(rows0, 0, O.A_CONST, val=val, isconst=True), ids[:, 0])
        return guard(ok, o)

    def h_mload():
        any_hit, val_row = mem_lookup(addr0)
        row = torch.where(any_hit, val_row, row_zero)
        f = mem_gas({}, addr0, 32)
        stack, length, ok = push1(st.stack, st.stack_len - 1, row)
        f.update(stack=stack, stack_len=length)
        good = ok_addr0 & ok & ~mem_overlap_miss(addr0)
        return guard(good, out(f, res=row))

    def h_mstore():
        exact = (st.mem_addr == addr0[:, None]) & live_mem
        overlap = mem_overlap_miss(addr0)
        any_exact = exact.any(1)
        idx = torch.where(any_exact, exact.int().argmax(1).to(I32), st.mem_len)
        ok_cap = idx < MEM
        ic = idx.clamp(0, MEM - 1)
        f = {"mem_addr": set_at(st.mem_addr, ic, addr0), "mem_val": set_at(st.mem_val, ic, pops[:, 1]),
             "mem_len": torch.where(any_exact, st.mem_len, st.mem_len + 1),
             "stack_len": st.stack_len - 2}
        f = mem_gas(f, addr0, 32)
        return guard(ok_addr0 & ~overlap & ok_cap, out(f))

    def h_sha3():
        off, ln = addr0, addr1
        words = _floordiv(ln + 31, 32)
        good = ok_addr0 & ok_addr1 & (ln > 0) & (torch.remainder(ln, 32) == 0) & (words <= 4)
        w_rows = []
        for w in range(4):
            hit, vr = mem_lookup(off + 32 * w)
            w_rows.append(torch.where(hit, vr, row_zero))
            good = good & torch.where(words > w, ~mem_overlap_miss(off + 32 * w),
                                      torch.ones_like(good))
        rows, cur, cur_w = rows0, w_rows[0], i32(256)
        for w in range(1, 4):
            need = words > w
            rows = sel_tree(need, set_row(rows, w - 1, O.A_CONCAT, a=cur, b=w_rows[w],
                                          width=cur_w + 256), rows)
            cur = torch.where(need, ids[:, w - 1], cur)
            cur_w = torch.where(need, cur_w + 256, cur_w)
        rows = set_row(rows, 3, O.A_KECCAK, a=cur, width=256)
        sha_gas = 30 + 6 * words
        f = mem_gas({"gas_min": st.gas_min + sha_gas, "gas_max": st.gas_max + sha_gas}, off, ln)
        stack, length, ok = push1(st.stack, st.stack_len - 2, ids[:, 3])
        f.update(stack=stack, stack_len=length)
        return guard(good & ok, out(f, rows=rows, res=ids[:, 3]))

    live_sto = torch.arange(STO, device=dev)[None, :] < st.sto_len[:, None]

    def h_sload():
        key = pops[:, 0]
        hit = (st.sto_key == key[:, None]) & live_sto
        any_hit = hit.any(1)
        hit_val = st.sto_val[ar, hit.int().argmax(1)]
        rows = set_row(rows0, 0, O.A_SELECT, a=ctx_at(CTX_STORAGE), b=key)
        res = torch.where(any_hit, hit_val, ids[:, 0])
        idx = st.sto_len
        ok_cap = any_hit | (idx < STO)
        ic = idx.clamp(0, STO - 1)
        f = {"sto_key": set_at(st.sto_key, ic, key, ~any_hit),
             "sto_val": set_at(st.sto_val, ic, ids[:, 0], ~any_hit),
             "sto_len": torch.where(any_hit, st.sto_len, st.sto_len + 1)}
        stack, length, ok = push1(st.stack, st.stack_len - 1, res)
        f.update(stack=stack, stack_len=length)
        return guard(ok_cap & ok, out(f, rows=sel_tree(any_hit, rows0, rows), res=res))

    def h_sstore():
        key, val = pops[:, 0], pops[:, 1]
        rows = set_row(rows0, 0, O.A_STORE, a=ctx_at(CTX_STORAGE), b=key, c=val, width=0)
        hit = (st.sto_key == key[:, None]) & live_sto
        any_hit = hit.any(1)
        idx = torch.where(any_hit, hit.int().argmax(1).to(I32), st.sto_len)
        ic = idx.clamp(0, STO - 1)
        f = {"sto_key": set_at(st.sto_key, ic, key), "sto_val": set_at(st.sto_val, ic, val),
             "sto_len": torch.where(any_hit, st.sto_len, st.sto_len + 1),
             "ctx": set_at(st.ctx, torch.full((B,), CTX_STORAGE, device=dev), ids[:, 0]),
             "stack_len": st.stack_len - 2}
        return guard(idx < STO, out(f, rows=rows))

    def h_jump():
        f = {"pc": jidx0, "depth": st.depth + 1, "stack_len": st.stack_len - 1}
        return guard(ok_addr0 & valid0, out(f), O.H_INVALID)

    def h_jumpi():
        dest_row, word_row = pops[:, 0], pops[:, 1]
        word_const = pop_c[:, 1]
        truth = ~bv.is_zero(pop_v[:, 1])
        can_take = ok_addr0 & valid0
        rows = set_row(rows0, 0, O.A_NE, a=word_row, b=row_zero, width=0)
        rows = set_row(rows, 1, O.A_BNOT, a=ids[:, 0], width=0)
        cond_row, ncond_row = ids[:, 0], ids[:, 1]
        cl = st.cons_len.clamp(0, CON - 1)
        ok_cons = st.cons_len < CON
        park = i32(O.H_PARK)

        # concrete condition: one branch, no fork
        take = truth & can_take
        dead = truth & ~can_take
        ok = ok_cons | dead
        c_f = {
            "pc": torch.where(take, jidx0, st.pc + 1), "depth": st.depth + 1,
            "stack_len": st.stack_len - 2,
            "cons": _sel(dead, st.cons, set_at(st.cons, cl, torch.where(take, cond_row, ncond_row))),
            "cons_len": torch.where(dead, st.cons_len, st.cons_len + 1),
            "halt": torch.where(dead, i32(O.H_INVALID), st.halt),
        }
        c_f = {k: _sel(ok, v, park if k == "halt" else getattr(st, k)) for k, v in c_f.items()}

        # symbolic condition: pristine state when the taken side is viable
        fall = {"pc": st.pc + 1, "depth": st.depth + 1, "stack_len": st.stack_len - 2,
                "cons": set_at(st.cons, cl, ncond_row), "cons_len": st.cons_len + 1,
                "halt": st.halt}
        fall = {k: _sel(ok_cons, v, park if k == "halt" else getattr(st, k)) for k, v in fall.items()}
        s_f = {k: _sel(can_take, torch.where(ok_cons, st.halt, park) if k == "halt" else getattr(st, k), v)
               for k, v in fall.items()}
        fork = Fork(want=can_take & ok_cons, target=jidx0, dest_row=dest_row, word_row=word_row,
                    cond_row=cond_row, ncond_row=ncond_row)
        f = {k: _sel(word_const, c_f[k], s_f[k]) for k in c_f}
        return (f, rows, sel_tree(word_const, no_fork, fork), i32(-1))

    def h_jumpdest():
        tracked = lid_pc >= 0
        slot = lid_pc.clamp(min=0)
        count = st.loops[ar, _gidx(slot, NL)] + 1
        si, inb = _sidx(slot, NL)
        loops = st.loops.clone()
        m = tracked & inb
        loops[ar[m], si[m]] = count[m]
        over = tracked & (cfg.loop_bound > 0) & (count > cfg.loop_bound)
        return out({"loops": loops, "halt": torch.where(over, i32(O.H_LOOP), st.halt)})

    def h_log():
        return out({"stack_len": st.stack_len - arity})

    def h_return():
        return out({"halt": torch.where(aux == 1, i32(O.H_REVERT), i32(O.H_RETURN)),
                    "stack_len": st.stack_len - 2})

    def h_selfdestruct():
        return out({"halt": i32(O.H_SELFDESTRUCT), "stack_len": st.stack_len - 1})

    def h_invalid():
        return halted(O.H_INVALID)

    def h_signextend():
        b_c, x_c = pop_c[:, 0], pop_c[:, 1]
        bval, x = pop_v[:, 0], pop_v[:, 1]
        b_small = (bval[:, 1:].amax(1) == 0) & (bval[:, 0] < 31)
        bits = (8 * (bval[:, 0] + 1)) & 0xFFFFFFFF
        one = limb0(torch.ones(B, dtype=torch.long, device=dev))
        mask_m1 = bv.sub(bv.shl(one, limb0(bits), 256), one, 256)
        low = bv.and_(x, mask_m1, 256)
        sign_word = bv.lshr(x, limb0((bits - 1) & 0xFFFFFFFF), 256)
        neg = (sign_word[:, 0] & 1) == 1
        folded = _sel(neg, bv.or_(low, bv.not_(mask_m1, 256), 256), low)
        folded = _sel(b_small, folded, x)
        rows_c = set_row(rows0, 0, O.A_CONST, val=folded, isconst=True)
        rows_m = set_row(rows0, 0, O.A_SIGNEXT, a=pops[:, 0], b=pops[:, 1])
        o, ok = pushed(sel_tree(b_c & x_c, rows_c, rows_m), ids[:, 0])
        return guard(ok, o)

    def h_byte():
        both = pop_c[:, 0] & pop_c[:, 1]
        iv = pop_v[:, 0]
        small = (iv[:, 1:].amax(1) == 0) & (iv[:, 0] < 32)
        lo_bit = 8 * (31 - iv[:, 0].clamp(0, 31))
        shifted = bv.lshr(pop_v[:, 1], limb0(lo_bit), 256)
        folded = limb0(shifted[:, 0] & 0xFF)
        folded = _sel(small, folded, torch.zeros_like(folded))
        rows_c = set_row(rows0, 0, O.A_CONST, val=folded, isconst=True)
        rows_m = set_row(rows0, 0, O.A_BYTE, a=pops[:, 0], b=pops[:, 1])
        o, ok = pushed(sel_tree(both, rows_c, rows_m), ids[:, 0])
        return guard(ok, o)

    def h_addmod():
        rows = set_row(rows0, 0, aux, a=pops[:, 0], b=pops[:, 1], c=pops[:, 2])
        o, ok = pushed(rows, ids[:, 0])
        return guard(ok, o)

    handlers = [
        h_park, h_stop, h_push_checked, h_dup, h_swap, h_pop, h_binop, h_cmp, h_iszero,
        h_not, h_envpush, h_calldataload, h_balance, h_selfbalance, h_sha3, h_mload,
        h_mstore, h_sload, h_sstore, h_jump, h_jumpi, h_jumpdest, h_log, h_return,
        h_selfdestruct, h_invalid, h_gaspush, h_msize, h_signextend, h_byte, h_addmod,
        h_park, h_page_fault,
    ]
    famc = fam.clamp(0, len(handlers) - 1)

    # the switch: every handler for every path, selected by family
    fields = {k: getattr(st, k) for k in _MUTABLE}
    rows, fork, res = rows0, no_fork, i32(-1)
    for h_index, h in enumerate(handlers):
        m = famc == h_index
        if not bool(m.any()):
            continue
        f_h, rows_h, fork_h, res_h = h()
        for k, v in f_h.items():
            fields[k] = _sel(m, v, fields[k])
        rows, fork = sel_tree(m, rows_h, rows), sel_tree(m, fork_h, fork)
        res = _sel(m, res_h, res)

    # STATICCALL write protection, then underflow: base_out(halt=INVALID)
    write_viol = (st.static != 0) & ((fam == O.F_SSTORE) | (fam == O.F_LOG)
                                     | (fam == O.F_SELFDESTRUCT))
    for m in (write_viol, underflow):
        fields = {k: _sel(m, i32(O.H_INVALID) if k == "halt" else getattr(st, k), v)
                  for k, v in fields.items()}
        rows, fork, res = sel_tree(m, rows0, rows), sel_tree(m, no_fork, fork), _sel(m, i32(-1), res)

    s2 = fields
    pending = fork.want
    terminalish = s2["halt"] != O.H_RUNNING
    s2["pc"] = torch.where(pending | terminalish | (s2["pc"] != st.pc), s2["pc"], s2["pc"] + 1)
    skip_gas = terminalish | pending
    s2["gas_min"] = torch.where(skip_gas, s2["gas_min"], s2["gas_min"] + code.gmin[cid, pc])
    s2["gas_max"] = torch.where(skip_gas, s2["gas_max"], s2["gas_max"] + code.gmax[cid, pc])
    s2["halt"] = torch.where((s2["depth"] > cfg.max_depth) & (s2["halt"] == O.H_RUNNING),
                             i32(O.H_DEPTH), s2["halt"])

    # event emission
    halt2 = s2["halt"]
    is_jumpi = fam == O.F_JUMPI
    terminal_halt = ((halt2 == O.H_STOP) | (halt2 == O.H_RETURN) | (halt2 == O.H_REVERT)
                     | (halt2 == O.H_SELFDESTRUCT) | (halt2 == O.H_INVALID))
    kind = torch.where(is_jumpi, i32(O.E_FORK),
                       torch.where(terminal_halt, i32(O.E_TERMINAL), i32(O.E_HOOK)))
    all_conc = torch.ones(B, dtype=torch.bool, device=dev)
    for j in range(7):
        all_conc = all_conc & ((arity <= j) | pop_c[:, j])
    nonpanic = ~(pop_c[:, 1] & (pop_v[:, 1, 14] == 0x7B71) & (pop_v[:, 1, 15] == 0x4E48))
    emit = (code.event[cid, pc] & ~infault & ~pending & ~underflow
            & ~(code.concskip[cid, pc] & all_conc) & ~(code.valgate[cid, pc] & nonpanic)
            & (halt2 != O.H_PARK) & (halt2 != O.H_PAGE_FAULT) & (halt2 != O.H_DEPTH)
            & (halt2 != O.H_LOOP))
    died = halt2 == O.H_INVALID
    last_cons = s2["cons"][ar, (s2["cons_len"] - 1).clamp(0, CON - 1).long()]
    ev_ops = pops.clone()
    ev_ops[:, 2] = torch.where(is_jumpi & ~died, last_cons, pops[:, 2])
    res_slot = torch.where(is_jumpi, s2["pc"], res)
    extra_slot = torch.where(is_jumpi & died, i32(-3), i32(-1))
    payload = torch.cat([torch.stack([kind, st.pc, st.gas_min, st.gas_max], 1), ev_ops,
                         torch.stack([res_slot, extra_slot], 1)], 1).to(I32)
    ev_ok = st.ev_len < EVT
    el = st.ev_len.clamp(0, EVT - 1).long()
    w = emit & ev_ok
    events = st.events.clone()
    events[ar[w], el[w]] = payload[w]
    s2["events"] = events
    s2["ev_len"] = torch.where(w, st.ev_len + 1, st.ev_len)
    s2["halt"] = torch.where(emit & ~ev_ok & (halt2 == O.H_RUNNING), i32(O.H_PARK), halt2)

    # freeze non-running paths entirely
    final = FrontierState(**{
        k: _sel(running, s2[k], getattr(st, k)) if k in s2 else getattr(st, k)
        for k in FrontierState._fields
    })
    rows_out = sel_tree(running, rows, zrows(0))
    fork_out = Fork(*[torch.where(running, f, torch.zeros_like(f)) for f in fork])
    return final, rows_out, fork_out


def _batch_step(state: FrontierState, arena: ArenaDev, arena_len, n_exec, max_live, visited,
                code: CodeDev, cfg: CfgScalars, caps: Caps):
    """One lockstep step of the whole batch (the JAX ``batch_step``)."""
    R, CON, EVT = caps.R, caps.CON, caps.EVT
    dev = state.pc.device
    B = state.pc.shape[0]
    C, N = code.fam.shape
    Cv, Iv = visited.shape[1], visited.shape[2]
    T = arena.op.shape[0]
    ar = torch.arange(B, device=dev)
    i32 = lambda v: torch.full((B,), v, dtype=I32, device=dev)  # noqa: E731

    running = (state.halt == O.H_RUNNING) & (state.seed >= 0)
    n_live = int(running.sum())
    n_exec = _wrap32(torch.tensor(n_exec + n_live)).item()
    max_live = max(max_live, n_live)
    state = state._replace(steps=state.steps + running.to(I32))
    cid_live = state.code_id.clamp(0, Cv - 1).long()
    pc_or_oob = state.pc.clamp(0, Iv - 1).long()
    visited = visited.clone()
    visited[0, cid_live[running], pc_or_oob[running]] = True
    live_rank = torch.cumsum(running.to(I32), 0).to(I32) - 1
    bases = _wrap32(arena_len + live_rank.long() * R)
    ids = torch.where(running[:, None], _wrap32(bases[:, None].long() + torch.arange(R, device=dev)),
                      torch.full((B, R), caps.ARENA, dtype=I32, device=dev))
    new_state, rows, fork = _path_step(state, ids, arena, code, cfg, caps)

    # edge coverage, inline-resolved JUMPIs
    cidc = cid_live.clamp(max=C - 1)
    fam_here = code.fam[cidc, (state.pc - code.pbase[cidc]).clamp(0, N - 1).long()]
    inline_jumpi = (running & (fam_here == O.F_JUMPI) & ~fork.want
                    & (new_state.halt == O.H_RUNNING))
    nf_plane = torch.where(new_state.pc == state.pc + 1, 2, 1).long()
    m = inline_jumpi
    visited[nf_plane[m], cid_live[m], pc_or_oob[m]] = True

    # arena scatter (fresh disjoint rows; out-of-range ids drop)
    flat, inb = _sidx(ids.reshape(-1), T)
    arena = ArenaDev(*[
        x.index_put((flat[inb],), v.reshape((B * R,) + v.shape[2:])[inb].to(x.dtype))
        for x, v in zip(arena, rows)
    ])
    arena_len = _wrap32(torch.tensor(arena_len + n_live * R)).item()

    # fork grants
    buf_ok = new_state.ev_len < EVT
    want = fork.want & buf_ok
    free = new_state.seed < 0
    n_free = int(free.sum())
    target_pc = fork.target.clamp(0, Iv - 1).long()
    uncovered = ~visited[0, cid_live, target_pc]
    sel = cfg.sel_mode
    if sel == SEL_DEEP:
        score = state.depth
    elif sel == SEL_SHALLOW:
        score = -state.depth
    elif sel == SEL_COVERAGE:
        score = uncovered.to(I32) * (1 << 20) + state.depth
    elif sel == SEL_BEAM:
        score = state.score
    else:
        score = i32(0)
    sort_key = torch.where(want, -score, i32(INT32_MAX))
    order = torch.argsort(sort_key, stable=True)
    rank = torch.empty(B, dtype=torch.long, device=dev)
    rank[order] = ar
    granted = want & (rank < n_free)
    free_list = torch.argsort((~free).to(torch.uint8), stable=True)
    child_slot = torch.where(granted, free_list[rank.clamp(0, B - 1)], torch.full_like(rank, B))

    g = granted
    src = ar.clone()
    src[child_slot[g]] = ar[g]
    forked_into = torch.zeros(B, dtype=torch.bool, device=dev)
    forked_into[child_slot[g]] = True
    taken_pc = torch.zeros(B, dtype=I32, device=dev)
    taken_pc[child_slot[g]] = fork.target[g]
    cond_of_child = torch.zeros(B, dtype=I32, device=dev)
    cond_of_child[child_slot[g]] = fork.cond_row[g]

    s2 = {k: _sel(forked_into, v[src], v) for k, v in new_state._asdict().items()}
    touched = granted | forked_into
    jumpi_true = torch.where(forked_into, state.pc[src], state.pc)
    cid2 = s2["code_id"].clamp(0, C - 1).long()
    jumpi_pc = jumpi_true.clamp(0, Iv - 1).long()
    jumpi_rel = (jumpi_true - code.pbase[cid2]).clamp(0, N - 1).long()
    branch_pc = torch.where(forked_into, taken_pc, jumpi_true + 1)
    branch_row = torch.where(forked_into, cond_of_child, fork.ncond_row)
    edge_plane = torch.where(forked_into, 1, 2).long()
    m = touched & (cid2 < Cv)
    visited[edge_plane[m], cid2[m], jumpi_pc[m]] = True
    cl = s2["cons_len"].clamp(0, CON - 1).long()
    cons_set = s2["cons"].clone()
    cons_set[ar, cl] = branch_row
    s2.update(
        pc=torch.where(touched, branch_pc, s2["pc"]),
        depth=torch.where(touched, s2["depth"] + 1, s2["depth"]),
        stack_len=torch.where(touched, s2["stack_len"] - 2, s2["stack_len"]),
        gas_min=torch.where(touched, s2["gas_min"] + code.gmin[cid2, jumpi_rel], s2["gas_min"]),
        gas_max=torch.where(touched, s2["gas_max"] + code.gmax[cid2, jumpi_rel], s2["gas_max"]),
        cons=_sel(touched, cons_set, s2["cons"]),
        cons_len=torch.where(touched, s2["cons_len"] + 1, s2["cons_len"]),
        events=_sel(forked_into, torch.full_like(s2["events"], -1), s2["events"]),
        ev_len=torch.where(forked_into, i32(0), s2["ev_len"]),
        steps=torch.where(forked_into, i32(0), s2["steps"]),
        halt=torch.where(forked_into, i32(O.H_RUNNING), s2["halt"]),
    )
    denied = want & ~granted
    s2["halt"] = torch.where((fork.want & ~buf_ok) | denied, i32(O.H_PENDING_FORK), s2["halt"])
    payload = torch.stack([
        i32(O.E_FORK), state.pc, state.gas_min, state.gas_max, fork.dest_row, fork.word_row,
        fork.cond_row, fork.ncond_row, fork.target, i32(-1), i32(-1), i32(-1),
        torch.where(granted, child_slot.to(I32), i32(-1)),
    ], 1)
    el = s2["ev_len"].clamp(0, EVT - 1).long()
    ev_ok = s2["ev_len"] < EVT
    w = granted & ev_ok
    events = s2["events"].clone()
    events[ar[w], el[w]] = payload[w]
    s2.update(events=events, ev_len=torch.where(w, s2["ev_len"] + 1, s2["ev_len"]),
              halt=torch.where(granted & ~ev_ok, i32(O.H_PARK), s2["halt"]))
    return FrontierState(**s2), arena, arena_len, n_exec, max_live, visited


def segment_torch(state: FrontierState, arena: ArenaDev, arena_len, visited,
                  code: CodeDev, cfg: CfgScalars, caps: Caps):
    """The plain PyTorch segment; inputs are not modified.
    -> (state, arena, arena_len, n_exec, max_live, visited), the scalars as
    0-d int32 tensors."""
    _check_inputs(state, arena, visited, code, caps)
    dev = state.pc.device
    arena_len, n_exec, max_live, t = int(arena_len), 0, 0, 0
    k = min(int(cfg.k_limit), caps.K)
    while True:
        running = (state.halt == O.H_RUNNING) & (state.seed >= 0)
        n_live = int(running.sum())
        room = _wrap32(torch.tensor(arena_len + n_live * caps.R)).item() < caps.ARENA
        if not (t < k and n_live > 0 and room):
            break
        state, arena, arena_len, n_exec, max_live, visited = _batch_step(
            state, arena, arena_len, n_exec, max_live, visited, code, cfg, caps)
        t += 1
    scalar = lambda v: torch.tensor(v, dtype=I32, device=dev)  # noqa: E731
    return state, arena, scalar(arena_len), scalar(n_exec), scalar(max_live), visited


def _check_inputs(state, arena, visited, code, caps: Caps) -> None:
    B = caps.B
    if state.pc.shape != (B,) or state.stack.shape != (B, caps.STK) or \
            state.events.shape != (B, caps.EVT, O.EV_W) or state.cons.shape != (B, caps.CON):
        raise ValueError("state does not match caps")
    if caps.R < 4:
        raise ValueError("the segment needs caps.R >= 4 (SHA3 writes four rows)")
    if any(f.dtype != I32 for f in state):
        raise ValueError("state fields must be int32")
    if arena.val.shape != (arena.op.shape[0], 16) or arena.val.dtype != I32:
        raise ValueError("arena val must be [T, 16] int32")
    if visited.dim() != 3 or visited.shape[0] != 3 or visited.dtype != torch.bool:
        raise ValueError("visited must be [3, C, I] bool")
    if code.fam.dim() != 2 or code.pbase.shape != (code.fam.shape[0],):
        raise ValueError("code tables must be [C, N] with a [C] pbase")


# ---------------------------------------------------------------------------
# the segment partitioned over a mesh's path axis
# ---------------------------------------------------------------------------


class ShardedState:
    """A frontier state partitioned over a mesh's path axis: ``blocks[k]`` is
    a ``FrontierState`` of the batch's slot block k (``B / n`` slots), on
    its own device (shard k's card, or, for logical shards of one device,
    in allocations of its own beside the others).  A field read as an
    attribute (``state.pc``) is the whole batch's, gathered on the first
    block's device; the main path reads the blocks where they live."""

    __slots__ = ("blocks",)

    def __init__(self, blocks):
        self.blocks = tuple(blocks)
        if not self.blocks or len({b.pc.shape[0] for b in self.blocks}) != 1:
            raise ValueError("a sharded state needs blocks of one width")

    @property
    def devices(self) -> list:
        return [b.pc.device for b in self.blocks]

    @property
    def block_width(self) -> int:
        return int(self.blocks[0].pc.shape[0])

    def __getattr__(self, name):
        if name in FrontierState._fields:
            lead = self.blocks[0].pc.device
            return torch.cat([getattr(b, name).to(lead) for b in self.blocks])
        raise AttributeError(name)


def _partitioned_step(blocks, arena: ArenaDev, arena_len, n_exec, max_live, visited,
                      codes, cfg: CfgScalars, caps: Caps):
    """One lockstep step of the batch as the partitioned kernel takes it:
    each block's paths step on their block (arena rows at their global live
    rank), the fork grant ranks every block's keys together and takes free
    slots of any block, and a child's row is copied from its parent's block
    into its own.  The arena and the planes are the leader's (``arena``'s
    device); ``codes[k]`` is block k's device's copy of the code tables."""
    R, CON, EVT, B_s = caps.R, caps.CON, caps.EVT, int(blocks[0].pc.shape[0])
    n = len(blocks)
    lead = arena.op.device
    C, N = codes[0].fam.shape
    Cv, Iv = visited.shape[1], visited.shape[2]
    T = arena.op.shape[0]
    arena_of = [arena if st.pc.device == lead else ArenaDev(*[x.to(st.pc.device) for x in arena])
                for st in blocks]

    running = [(st.halt == O.H_RUNNING) & (st.seed >= 0) for st in blocks]
    live = [int(r.sum()) for r in running]
    n_live = sum(live)
    n_exec = _wrap32(torch.tensor(n_exec + n_live)).item()
    max_live = max(max_live, n_live)
    visited = visited.clone()
    pre, new, rows_of, fork_of = [], [], [], []
    before = 0
    for k, (st, run) in enumerate(zip(blocks, running)):
        dev, code = st.pc.device, codes[k]
        st = st._replace(steps=st.steps + run.to(I32))
        cid_live = st.code_id.clamp(0, Cv - 1).long()
        pc_or_oob = st.pc.clamp(0, Iv - 1).long()
        visited[0, cid_live[run].to(lead), pc_or_oob[run].to(lead)] = True
        live_rank = before + torch.cumsum(run.to(I32), 0).to(I32) - 1
        before += live[k]
        bases = _wrap32(arena_len + live_rank.long() * R)
        ids = torch.where(run[:, None],
                          _wrap32(bases[:, None].long() + torch.arange(R, device=dev)),
                          torch.full((B_s, R), caps.ARENA, dtype=I32, device=dev))
        new_st, rows, fork = _path_step(st, ids, arena_of[k], code, cfg, caps)
        # edge coverage, inline-resolved JUMPIs
        cidc = cid_live.clamp(max=C - 1)
        fam_here = code.fam[cidc, (st.pc - code.pbase[cidc]).clamp(0, N - 1).long()]
        m = run & (fam_here == O.F_JUMPI) & ~fork.want & (new_st.halt == O.H_RUNNING)
        nf_plane = torch.where(new_st.pc == st.pc + 1, 2, 1).long()
        visited[nf_plane[m].to(lead), cid_live[m].to(lead), pc_or_oob[m].to(lead)] = True
        pre.append(st)
        new.append(new_st)
        rows_of.append((ids, rows))
        fork_of.append(fork)
    # the arena scatter: every block's fresh rows (the dead slots' rows are
    # one row of zeros, the same from every block)
    cols = list(arena)
    for ids, rows in rows_of:
        flat, inb = _sidx(ids.reshape(-1).to(lead), T)
        cols = [x.index_put((flat[inb],), v.to(lead).reshape((-1,) + v.shape[2:])[inb].to(x.dtype))
                for x, v in zip(cols, rows)]
    arena = ArenaDev(*cols)
    arena_len = _wrap32(torch.tensor(arena_len + n_live * R)).item()

    # the fork grant over every block's keys, on the leader
    want_of, free_of = [], []
    keys = []
    for k in range(n):
        st, new_st, fork = pre[k], new[k], fork_of[k]
        want = fork.want & (new_st.ev_len < EVT)
        cid_live = st.code_id.clamp(0, Cv - 1).long()
        uncovered = ~visited[0, cid_live.to(lead), fork.target.clamp(0, Iv - 1).long().to(lead)]
        sel = cfg.sel_mode
        if sel == SEL_DEEP:
            score = st.depth.to(lead)
        elif sel == SEL_SHALLOW:
            score = -st.depth.to(lead)
        elif sel == SEL_COVERAGE:
            score = uncovered.to(I32) * (1 << 20) + st.depth.to(lead)
        elif sel == SEL_BEAM:
            score = st.score.to(lead)
        else:
            score = torch.zeros(B_s, dtype=I32, device=lead)
        keys.append(torch.where(want.to(lead), -score, torch.full_like(score, INT32_MAX)))
        want_of.append(want.to(lead))
        free_of.append((new_st.seed < 0).to(lead))
    B = n * B_s
    key = torch.cat(keys)
    free = torch.cat(free_of)
    n_free = int(free.sum())
    order = torch.argsort(key, stable=True)
    rank = torch.empty(B, dtype=torch.long, device=lead)
    rank[order] = torch.arange(B, device=lead)
    granted = torch.cat(want_of) & (rank < n_free)
    free_list = torch.argsort((~free).to(torch.uint8), stable=True)
    child = torch.where(granted, free_list[rank.clamp(0, B - 1)], torch.full_like(rank, B))
    parents = torch.nonzero(granted).flatten()
    kids = child[parents]

    out = []
    for j in range(n):
        st, new_st, fork = pre[j], new[j], fork_of[j]
        dev, code = st.pc.device, codes[j]
        ar = torch.arange(B_s, device=dev)
        i32 = lambda v: torch.full((B_s,), v, dtype=I32, device=dev)  # noqa: E731
        g = granted[j * B_s:(j + 1) * B_s].to(dev)
        s2 = dict(new_st._asdict())
        forked_into = torch.zeros(B_s, dtype=torch.bool, device=dev)
        jumpi_true = st.pc.clone()
        taken_pc = torch.zeros(B_s, dtype=I32, device=dev)
        cond_of_child = torch.zeros(B_s, dtype=I32, device=dev)
        # the children in this block: each copies its parent's row from the
        # parent's block
        mine = (kids >= j * B_s) & (kids < (j + 1) * B_s)
        for i in range(n):
            sel = mine & (parents >= i * B_s) & (parents < (i + 1) * B_s)
            if not bool(sel.any()):
                continue
            c = (kids[sel] - j * B_s).to(dev)
            p = (parents[sel] - i * B_s).to(pre[i].pc.device)
            for name, v in new[i]._asdict().items():
                s2[name] = s2[name].clone() if s2[name] is getattr(new_st, name) else s2[name]
                s2[name][c] = v[p].to(dev)
            forked_into[c] = True
            jumpi_true[c] = pre[i].pc[p].to(dev)
            taken_pc[c] = fork_of[i].target[p].to(dev)
            cond_of_child[c] = fork_of[i].cond_row[p].to(dev)
        touched = g | forked_into
        cid2 = s2["code_id"].clamp(0, C - 1).long()
        jumpi_pc = jumpi_true.clamp(0, Iv - 1).long()
        jumpi_rel = (jumpi_true - code.pbase[cid2]).clamp(0, N - 1).long()
        branch_pc = torch.where(forked_into, taken_pc, jumpi_true + 1)
        branch_row = torch.where(forked_into, cond_of_child, fork.ncond_row)
        edge_plane = torch.where(forked_into, 1, 2).long()
        m = touched & (cid2 < Cv)
        visited[edge_plane[m].to(lead), cid2[m].to(lead), jumpi_pc[m].to(lead)] = True
        cl = s2["cons_len"].clamp(0, CON - 1).long()
        cons_set = s2["cons"].clone()
        cons_set[ar, cl] = branch_row
        s2.update(
            pc=torch.where(touched, branch_pc, s2["pc"]),
            depth=torch.where(touched, s2["depth"] + 1, s2["depth"]),
            stack_len=torch.where(touched, s2["stack_len"] - 2, s2["stack_len"]),
            gas_min=torch.where(touched, s2["gas_min"] + code.gmin[cid2, jumpi_rel], s2["gas_min"]),
            gas_max=torch.where(touched, s2["gas_max"] + code.gmax[cid2, jumpi_rel], s2["gas_max"]),
            cons=_sel(touched, cons_set, s2["cons"]),
            cons_len=torch.where(touched, s2["cons_len"] + 1, s2["cons_len"]),
            events=_sel(forked_into, torch.full_like(s2["events"], -1), s2["events"]),
            ev_len=torch.where(forked_into, i32(0), s2["ev_len"]),
            steps=torch.where(forked_into, i32(0), s2["steps"]),
            halt=torch.where(forked_into, i32(O.H_RUNNING), s2["halt"]),
        )
        want = want_of[j].to(dev)
        buf_ok = new_st.ev_len < EVT
        s2["halt"] = torch.where((fork.want & ~buf_ok) | (want & ~g), i32(O.H_PENDING_FORK),
                                 s2["halt"])
        child_slot = child[j * B_s:(j + 1) * B_s].to(dev)
        payload = torch.stack([
            i32(O.E_FORK), st.pc, st.gas_min, st.gas_max, fork.dest_row, fork.word_row,
            fork.cond_row, fork.ncond_row, fork.target, i32(-1), i32(-1), i32(-1),
            torch.where(g, child_slot.to(I32), i32(-1)),
        ], 1)
        el = s2["ev_len"].clamp(0, EVT - 1).long()
        ev_ok = s2["ev_len"] < EVT
        w = g & ev_ok
        events = s2["events"].clone()
        events[ar[w], el[w]] = payload[w]
        s2.update(events=events, ev_len=torch.where(w, s2["ev_len"] + 1, s2["ev_len"]),
                  halt=torch.where(g & ~ev_ok, i32(O.H_PARK), s2["halt"]))
        out.append(FrontierState(**s2))
    return out, arena, arena_len, n_exec, max_live, visited


def segment_partitioned_torch(state: ShardedState, arena: ArenaDev, arena_len, visited,
                              code: CodeDev, cfg: CfgScalars, caps: Caps):
    """The plain PyTorch version of the partitioned segment, block by block
    (``_partitioned_step``); inputs are not modified.  The same outputs as
    ``segment_torch`` on the gathered batch, the state as a
    ``ShardedState`` on the blocks' devices, the scalars as 0-d int32
    tensors on the leader (``arena``'s device)."""
    _check_partitioned(state, arena, visited, code, caps)
    lead = arena.op.device
    blocks = list(state.blocks)
    codes = [CodeDev(*[x.to(b.pc.device) for x in code]) for b in blocks]
    arena_len, n_exec, max_live, t = int(arena_len), 0, 0, 0
    k = min(int(cfg.k_limit), caps.K)
    while True:
        n_live = sum(int(((b.halt == O.H_RUNNING) & (b.seed >= 0)).sum()) for b in blocks)
        room = _wrap32(torch.tensor(arena_len + n_live * caps.R)).item() < caps.ARENA
        if not (t < k and n_live > 0 and room):
            break
        blocks, arena, arena_len, n_exec, max_live, visited = _partitioned_step(
            blocks, arena, arena_len, n_exec, max_live, visited, codes, cfg, caps)
        t += 1
    scalar = lambda v: torch.tensor(v, dtype=I32, device=lead)  # noqa: E731
    return ShardedState(blocks), arena, scalar(arena_len), scalar(n_exec), scalar(max_live), visited


def _check_partitioned(state, arena, visited, code, caps: Caps) -> None:
    if not isinstance(state, ShardedState):
        raise ValueError("the partitioned segment takes a ShardedState")
    n = len(state.blocks)
    if n > MAX_SHARDS or caps.B != n * state.block_width:
        raise ValueError(f"{n} blocks of {state.block_width} slots do not make B={caps.B} "
                         f"(at most {MAX_SHARDS} shards)")
    for b in state.blocks:
        _check_inputs(b, arena, visited, code, dataclasses.replace(caps, B=state.block_width))


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------

_SCRATCH = ("free_list", "fkeys", "grants", "cnt", "out")
GRANT_W = 8  # int32 words of a grant record (mk::GRANT_W)
_DIMS = ("B", "STK", "MEM", "STO", "CON", "EVT", "R", "K", "ARENA", "NL", "T", "C", "N", "A",
         "Cv", "Iv", "max_depth", "loop_bound", "row_zero", "row_one", "sel_mode", "k_limit")
BLOCK = 128  # threads per block of the kernel, one path each
# mk_frontier_segment's refusals: a cooperative grid (B > 1024) that the card
# cannot hold resident (cudaErrorCooperativeLaunchTooLarge), and a cluster
# (128 < B <= 1024) that it cannot schedule
GRID_TOO_LARGE = 720
CLUSTER_REFUSED = -1


class FrontierArgs(ctypes.Structure):
    """Mirror of ``mk::SegArgs`` in ``csrc/frontier_segment.cuh`` (same order)."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        *FrontierState._fields, *("a_" + n for n in ArenaDev._fields), "visited",
        *CodeDev._fields, "code_rows", *_SCRATCH, "arena_len0",
    )] + [(n, ctypes.c_int) for n in _DIMS]


launches = 0  # launches of the CUDA segment kernel (one per segment call)


def code_rows(code: CodeDev) -> torch.Tensor:
    """The kernel's packed code row per instruction, [C, N, 8] int32: fam,
    aux, arity, gmin, gmax, loopid, flags (event | concskip << 1 | valgate
    << 2), 0 -- one 32-byte read decodes an instruction.  Derived from
    ``code``, which stays as the JAX package has it."""
    flags = code.event.to(I32) | code.concskip.to(I32) << 1 | code.valgate.to(I32) << 2
    return torch.stack([code.fam, code.aux, code.arity, code.gmin, code.gmax, code.loopid, flags,
                        torch.zeros_like(code.fam)], -1).contiguous()


def arena_len_word(arena_len, device) -> torch.Tensor:
    """The segment's starting arena length as a one-word int32 tensor on
    ``device``, which the kernel reads when it starts: a 0-d tensor there
    (a chained segment's predecessor's ``out[0]``) is taken as it is, so the
    host reads no device value; a host integer is filled in on the device,
    a launch and no copy."""
    if isinstance(arena_len, torch.Tensor):
        if arena_len.device != torch.device(device) or arena_len.dtype != I32 or \
                arena_len.numel() != 1:
            raise ValueError("arena_len must be one int32 word on the state's device")
        return arena_len.reshape(1)
    return torch.full((1,), int(arena_len), dtype=I32, device=device)


def kernel_args(state: FrontierState, arena: ArenaDev, arena_len, visited, code: CodeDev,
                cfg: CfgScalars, caps: Caps, fresh_state: bool = False):
    """The kernel's arguments over COPIES of the inputs, which it updates in
    place: -> (FrontierArgs, (state, arena, visited, out scalars), keepalive).
    ``fresh_state``: the state's tensors were made for this call and are
    read by nothing else (a chained dispatch's merge), so the kernel takes
    them without a copy.  ``arena_len`` is a host integer or a one-word
    int32 tensor on the state's device (``arena_len_word``).  Used by
    ``segment_cuda`` and by the host build of the kernel body."""
    _check_inputs(state, arena, visited, code, caps)
    if caps.B <= 0 or state.ctx.shape[1] != 16:
        raise ValueError("the kernel takes B >= 1 paths with a [B, 16] ctx")
    if not fresh_state:
        state = FrontierState(*[f.clone() for f in state])
    arena = ArenaDev(*[x.clone() for x in arena])
    visited = visited.clone()
    code = CodeDev(*[x.contiguous() for x in code])
    rows = code_rows(code)
    B, dev = caps.B, state.pc.device
    blocks = -(-B // BLOCK)
    size = {"fkeys": 2 * B, "grants": GRANT_W * B, "cnt": 2 * 4 * blocks, "out": 3}
    scratch = {n: torch.zeros(size.get(n, B), dtype=I32, device=dev) for n in _SCRATCH}
    scratch["grants"].fill_(-1)
    len0 = arena_len_word(arena_len, dev)
    args = FrontierArgs(
        *[f.data_ptr() for f in state], *[x.data_ptr() for x in arena], visited.data_ptr(),
        *[x.data_ptr() for x in code], rows.data_ptr(), *[scratch[n].data_ptr() for n in _SCRATCH],
        len0.data_ptr(),
        B, caps.STK, caps.MEM, caps.STO, caps.CON, caps.EVT, caps.R, caps.K, caps.ARENA,
        state.loops.shape[1], arena.op.shape[0], code.fam.shape[0], code.fam.shape[1],
        code.jumpmap.shape[1], visited.shape[1], visited.shape[2],
        cfg.max_depth, cfg.loop_bound, cfg.row_zero, cfg.row_one, cfg.sel_mode,
        min(int(cfg.k_limit), INT32_MAX),
    )
    return args, (state, arena, visited, scratch["out"]), (code, rows, scratch, len0)


def segment_cuda(state: FrontierState, arena: ArenaDev, arena_len, visited,
                 code: CodeDev, cfg: CfgScalars, caps: Caps, fresh_state: bool = False):
    """The segment as one launch of ``csrc/frontier_segment.cu``; inputs on
    a CUDA device, not modified (but the state's with ``fresh_state``, see
    ``kernel_args``).  ``arena_len`` may be a 0-d int32 tensor on the card.
    Same outputs as ``segment_torch``, the scalars as 0-d int32 tensors on
    the card; the host reads no device value.  Queued on the current
    stream.  Raises when the card cannot hold the launch shape B needs."""
    global launches
    if not state.pc.is_cuda:
        raise ValueError("segment_cuda takes CUDA tensors")
    from mythril_tpu_torch.ops import _build

    args, (state, arena, visited, out), keep = kernel_args(state, arena, arena_len, visited,
                                                           code, cfg, caps, fresh_state)
    lib = _build.load()
    with torch.cuda.device(state.pc.device):
        stream = torch.cuda.current_stream(state.pc.device).cuda_stream
        rc = lib.mk_frontier_segment(ctypes.byref(args), stream)
        if rc in (GRID_TOO_LARGE, CLUSTER_REFUSED):
            raise _build.KernelLaunchError(
                f"frontier_segment: the card cannot hold the launch B={caps.B} paths need "
                f"({launch_shape(lib, args)}); use a smaller frontier width")
        _build.check(rc, "frontier_segment")
    launches += 1
    del keep
    return state, arena, out[0], out[1], out[2], visited


def launch_shape(lib, args) -> dict:
    """The kernel's launch shape for these arguments: threads per block,
    blocks, cluster size (0 without a cluster) and how many such launches
    the card holds resident."""
    from mythril_tpu_torch.ops import _build

    vals = [ctypes.c_int() for _ in range(4)]
    rc = lib.mk_frontier_segment_shape(ctypes.byref(args), *map(ctypes.byref, vals))
    if rc != 0:
        raise _build.KernelLaunchError(
            f"frontier_segment: CUDA error {rc} querying the launch shape")
    return dict(zip(("block", "blocks", "cluster", "resident"), (v.value for v in vals)))


def max_paths(device, devices=None) -> int:
    """The widest segment (paths, B) that ``segment_cuda`` can launch on the
    CUDA ``device``: the card's own limit (``mk_frontier_max_paths``, from the
    cooperative grid's resident blocks), queried once per device by the
    library.  ``devices``, a mesh's cards (more than one): the widest batch
    the partitioned segment launches over them, one block each, the sum of
    their limits (``mk_frontier_shard_max_paths``).  Builds the kernels if
    needed."""
    from mythril_tpu_torch.ops import _build

    lib = _build.load()
    if devices is not None and len(set(devices)) > 1:
        total = 0
        for d in dict.fromkeys(devices):
            paths = ctypes.c_int()
            with torch.cuda.device(d):
                rc = lib.mk_frontier_shard_max_paths(ctypes.byref(paths))
            _build.check(rc, "frontier_segment_shards (the widest launch)")
            total += paths.value
        return total
    paths = ctypes.c_int()
    with torch.cuda.device(device):
        rc = lib.mk_frontier_max_paths(ctypes.byref(paths))
    if rc != 0:
        raise _build.KernelLaunchError(
            f"frontier_segment: CUDA error {rc} querying the widest launch")
    return paths.value


# ---------------------------------------------------------------------------
# the partitioned kernel's wrapper
# ---------------------------------------------------------------------------

MAX_SHARDS = 8  # mk::kMaxShards
# how long a card waits for the others at the partitioned segment's barrier
# before it traps (a launch failure, raised at the next blocking read)
BARRIER_TIMEOUT_S = 10.0


class ShardPtrs(ctypes.Structure):
    """Mirror of ``mk::ShardPtrs``: a block's state, then its copies of the
    batch-wide scratch."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        *FrontierState._fields, "free_list", "fkeys", "grants", "cnt")]


class ShardArgs(ctypes.Structure):
    """Mirror of ``mk::ShardArgs`` in ``csrc/frontier_segment.cuh``."""

    _fields_ = [("s", FrontierArgs), ("sh", ShardPtrs * MAX_SHARDS)] + [
        (n, ctypes.c_int) for n in ("n_shards", "Bs", "bps", "first", "n_here", "n_launches")
    ] + [("bar", ctypes.c_void_p), ("timeout_ns", ctypes.c_longlong)]


partitioned_launches = 0  # launches of the partitioned kernel (one per card and segment)
_BARRIERS: dict = {}  # leader device -> its [count, generation] barrier words
_PEERS: set = set()  # device sets whose peer access is on


def _barrier(lead: torch.device) -> torch.Tensor:
    """The leader's barrier words, made once per device (zero): a barrier
    leaves them at a count of 0, so every segment finds them ready."""
    if lead not in _BARRIERS:
        _BARRIERS[lead] = torch.zeros(2, dtype=I32, device=lead)
        # the other cards' launches must not find the words before the fill
        torch.cuda.synchronize(lead)
    return _BARRIERS[lead]


def enable_peer_access(devices) -> None:
    """Peer access between every pair of the distinct CUDA ``devices``
    (once per set).  Raises ``DeviceError`` naming ``--no-mesh`` when two
    of them cannot reach each other's memory."""
    from mythril_tpu_torch.ops import _build

    idx = tuple(sorted({torch.device(d).index for d in devices}))
    if len(idx) < 2 or idx in _PEERS:
        return
    lib = _build.load()
    devs = (ctypes.c_int * len(idx))(*idx)
    a, b = ctypes.c_int(-1), ctypes.c_int(-1)
    rc = lib.mk_frontier_enable_peers(devs, len(idx), ctypes.byref(a), ctypes.byref(b))
    if rc == -2:
        raise _device.DeviceError(
            f"cuda:{a.value} cannot reach the memory of cuda:{b.value}: the partitioned "
            "segment needs peer access between every pair of the mesh's cards; run with "
            "--no-mesh")
    _build.check(rc, "frontier_segment_shards (peer access)")
    _PEERS.add(idx)


def shard_args(state: ShardedState, arena: ArenaDev, arena_len, visited, code: CodeDev,
               cfg: CfgScalars, caps: Caps, fresh_state: bool = False, one_launch=None):
    """The partitioned kernel's arguments over COPIES of the inputs (but the
    state's with ``fresh_state``, as ``kernel_args``): each shard's scratch
    on its block's device, the arena, the planes, ``out`` and the starting
    arena length on the leader (``arena``'s device), the code tables copied
    to each device.  ``one_launch``: one launch holds every shard (logical
    shards of one device; the default when every block is on one device),
    else one launch per shard, each on its block's device, meeting at the
    leader's barrier.  -> ([(device, ShardArgs), ...], (state, arena,
    visited, out), keepalive).  Used by ``segment_partitioned`` and by the
    host build of the shard executor."""
    _check_partitioned(state, arena, visited, code, caps)
    blocks, n, Bs = list(state.blocks), len(state.blocks), state.block_width
    devices = [b.pc.device for b in blocks]
    lead = arena.op.device
    if devices[0] != lead or visited.device != lead:
        raise ValueError("the arena and the coverage planes must be on block 0's device")
    if one_launch is None:
        one_launch = len(set(devices)) == 1
    if not fresh_state:
        blocks = [FrontierState(*[f.clone() for f in b]) for b in blocks]
    arena = ArenaDev(*[x.clone() for x in arena])
    visited = visited.clone()
    codes, rows = {}, {}
    for d in devices:
        if d not in codes:
            codes[d] = CodeDev(*[x.to(d).contiguous() for x in code])
            rows[d] = code_rows(codes[d])
    bps = -(-Bs // BLOCK)
    sizes = {"free_list": caps.B, "fkeys": 2 * caps.B, "grants": GRANT_W * caps.B,
             "cnt": 2 * 4 * n * bps}
    scratch = []
    for d in devices:
        sc = {name: torch.zeros(size, dtype=I32, device=d) for name, size in sizes.items()}
        sc["grants"].fill_(-1)
        scratch.append(sc)
    out = torch.zeros(3, dtype=I32, device=lead)
    len0 = arena_len_word(arena_len, lead)
    sh = (ShardPtrs * MAX_SHARDS)()
    for k, (b, sc) in enumerate(zip(blocks, scratch)):
        sh[k] = ShardPtrs(*[f.data_ptr() for f in b], *[sc[name].data_ptr() for name in sizes])
    bar = None if one_launch else _barrier(lead)
    launches = []
    for first in ([0] if one_launch else range(n)):
        d = devices[first]
        c = codes[d]
        s = FrontierArgs(
            *[0] * len(FrontierState._fields), *[x.data_ptr() for x in arena], visited.data_ptr(),
            *[x.data_ptr() for x in c], rows[d].data_ptr(), 0, 0, 0, 0, out.data_ptr(),
            len0.data_ptr(),
            caps.B, caps.STK, caps.MEM, caps.STO, caps.CON, caps.EVT, caps.R, caps.K, caps.ARENA,
            blocks[0].loops.shape[1], arena.op.shape[0], c.fam.shape[0], c.fam.shape[1],
            c.jumpmap.shape[1], visited.shape[1], visited.shape[2],
            cfg.max_depth, cfg.loop_bound, cfg.row_zero, cfg.row_one, cfg.sel_mode,
            min(int(cfg.k_limit), INT32_MAX),
        )
        launches.append((d, ShardArgs(
            s, sh, n, Bs, bps, first, n if one_launch else 1, 1 if one_launch else n,
            bar.data_ptr() if bar is not None else None, int(BARRIER_TIMEOUT_S * 1e9))))
    keep = (codes, rows, scratch, len0, bar)
    return launches, (ShardedState(blocks), arena, visited, out), keep


def segment_partitioned(state: ShardedState, arena: ArenaDev, arena_len, visited,
                        code: CodeDev, cfg: CfgScalars, caps: Caps, fresh_state: bool = False,
                        launch=None):
    """The segment partitioned over the mesh's path axis on CUDA tensors:
    ``csrc/frontier_segment.cu``'s shard kernel, one cooperative launch per
    card over its block (each on that card's current stream, its launch
    error checked per card), or ONE launch holding every block when the
    blocks are logical shards of one card.  The arena, the planes and the
    scalars stay on the leader (block 0's card), where the harvest reads
    them; the outputs equal ``segment_cuda``'s on the gathered batch bit
    for bit.  Nothing waits: the host reads no device value.  ``launch``
    (the fault test only) launches those shards alone, one launch each,
    so the others never reach the barrier."""
    global partitioned_launches
    from mythril_tpu_torch.ops import _build

    if not all(d.type == "cuda" for d in state.devices):
        raise ValueError("segment_partitioned takes CUDA tensors")
    if len(set(state.devices)) not in (1, len(state.devices)):
        raise ValueError("the partitioned segment takes logical shards of one card or one "
                         "shard per card")
    lib = _build.load()
    if len(set(state.devices)) > 1:
        enable_peer_access(state.devices)
    launches, (st, arena, visited, out), keep = shard_args(
        state, arena, arena_len, visited, code, cfg, caps, fresh_state,
        one_launch=None if launch is None else False)
    if launch is not None:
        launches = [launches[k] for k in launch]
    for d, args in launches:
        with torch.cuda.device(d):
            rc = lib.mk_frontier_segment_shards(ctypes.byref(args),
                                                torch.cuda.current_stream(d).cuda_stream)
        if rc == GRID_TOO_LARGE:
            raise _build.KernelLaunchError(
                f"frontier_segment_shards: {d} cannot hold {args.n_here} blocks of "
                f"{args.Bs} paths resident; use a smaller frontier width")
        _build.check(rc, f"frontier_segment_shards on {d}")
        partitioned_launches += 1
    del keep
    return st, arena, out[0], out[1], out[2], visited


@lru_cache(maxsize=16)
def _cached(caps: Caps, code_cap: int, instr_cap: int, addr_cap: int, loops_cap: int):
    def segment(state, arena: ArenaDev, arena_len, visited, code: CodeDev,
                cfg: CfgScalars, fresh_state: bool = False):
        if isinstance(state, ShardedState):
            if state.blocks[0].pc.is_cuda:
                return segment_partitioned(state, arena, arena_len, visited, code, cfg, caps,
                                           fresh_state)
            return segment_partitioned_torch(state, arena, arena_len, visited, code, cfg, caps)
        if state.pc.is_cuda:
            return segment_cuda(state, arena, arena_len, visited, code, cfg, caps, fresh_state)
        return segment_torch(state, arena, arena_len, visited, code, cfg, caps)

    return segment


def cached_segment(caps: Caps, code_cap: int, instr_cap: int, addr_cap: int,
                   loops_cap: int, device=None):
    """The segment for (caps, size bucket), with the JAX signature
    ``segment(state, arena, arena_len, visited, code, cfg) -> (state, arena,
    arena_len, n_exec, max_live, visited)``: the kernel on CUDA tensors, the
    plain version on CPU tensors.  For a mesh (a ``ShardedState``, from
    ``push_state(..., devices=)`` or ``parallel.mesh.shard_frontier_inputs``)
    it is the partitioned segment: ``segment_partitioned`` on CUDA blocks,
    ``segment_partitioned_torch`` on CPU blocks.  ``fresh_state=True`` (a
    chained dispatch's merged state) lets the kernel take the state without
    a copy.  ``device=None`` means the CUDA card and raises ``NoCudaDevice`` without
    one; pass ``device="cpu"`` to run the plain version here."""
    _device.resolve(device)
    return _cached(caps, code_cap, instr_cap, addr_cap, loops_cap)


# ---------------------------------------------------------------------------
# Synchronous transfers (the engine's device interface): one packed copy of
# the state's non-event fields each way, the events pulled in a size bucket
# covering max(ev_len), arena rows in fixed chunks.  The JAX package packs
# to save link round trips and XLA compiles; here the packing saves copies.
# ---------------------------------------------------------------------------

ARENA_CHUNK = 8192  # rows per packed arena pull (22 int32 words per row)
REINJECT_CHUNK = 256  # rows per arena push
# events ([B, EVT, EV_W], the largest field) are drained every harvest: the
# push rebuilds them empty, the pull takes [B, cap, EV_W] for the smallest
# bucket covering max(ev_len), the whole buffer as the last resort
_EVENT_BUCKETS = (8, 32, 128)
_NON_EVENT = tuple(n for n in FrontierState._fields if n != "events")


def events_cap(max_ev: int, evt: int) -> int:
    return next((b for b in _EVENT_BUCKETS if max_ev <= b <= evt), evt)


def _pack_events(state: FrontierState, cap: int) -> torch.Tensor:
    return state.events[:, :cap, :].reshape(-1)


def upload(array: np.ndarray, device) -> torch.Tensor:
    """A host array onto ``device`` without a host wait: to the card from
    pinned memory, queued on the current stream (the caching host allocator
    keeps the pinned block until the copy has run); on the CPU the array's
    own memory."""
    x = torch.from_numpy(np.ascontiguousarray(array))
    if torch.device(device).type != "cuda":
        return x
    return x.pin_memory().to(device, non_blocking=True)


def push_state(state: FrontierState, device=None, devices=None):
    """Host numpy state -> tensors on ``device`` (the card unless "cpu"):
    one packed copy of the non-event fields, queued without a host wait
    (``upload``); the event buffers are made empty on the device (the
    harvest drains them every segment).  ``devices`` (a mesh's path axis,
    more than one entry): a ``ShardedState``, slot block k pushed to
    ``devices[k]`` the same way, on that device's current stream."""
    if devices is not None and len(devices) > 1:
        n = len(devices)
        B = int(np.asarray(state.pc).shape[0])
        if B % n:
            raise ValueError(f"{B} slots do not split over {n} shards")
        bs = B // n
        return ShardedState([
            push_state(FrontierState(*[np.asarray(f)[k * bs:(k + 1) * bs] for f in state]), d)
            for k, d in enumerate(devices)])
    dev = _device.resolve(device)
    if any(np.asarray(f).dtype != np.int32 for f in state):
        raise ValueError("packed state transfer assumes uniform int32 fields")
    flat = [np.asarray(getattr(state, n)).reshape(-1) for n in _NON_EVENT]
    buf = upload(np.concatenate(flat), dev)
    fields, off = {}, 0
    for n, x in zip(_NON_EVENT, flat):
        fields[n] = buf[off: off + x.size].view(np.asarray(getattr(state, n)).shape)
        off += x.size
    fields["events"] = torch.full(np.asarray(state.events).shape, -1, dtype=I32, device=dev)
    fields["ev_len"] = torch.zeros(np.asarray(state.ev_len).shape, dtype=I32, device=dev)
    return FrontierState(**fields)


def pull_harvest(state: FrontierState, arena_len, n_exec, max_live, prev=None, shards: int = 1):
    """Device -> host harvest.  -> (numpy FrontierState, arena_len, n_exec,
    max_live).  Reads on the current stream, and waits for it.

    ``prev=None`` (the synchronous loop, the pipeline's sync points): one
    packed copy of every non-event field and the three scalars, then the
    events in a bucket covering max(ev_len).

    ``prev`` set (the pipeline's steady state, the next dispatch already
    chained): a DELTA pull.  The harvest reads three things of a fresh
    mirror: the per-slot scalars, the 2-D rows of slots it finishes or
    prunes, and the new events.  So the pull ships the [B] fields (and the
    scalars) in one copy, then the rows of the dirty slots only (halted
    with a seed, events to drain, or a constraint list that grew since
    ``prev``: the list is append-only, and a recycled slot's mirror length
    is 0 after ``clear_slot``), and the events of the slots that have any;
    every other row is ``prev``'s.  Row and slot counts are padded to
    ``_SLOT_BUCKETS`` as in the JAX package, so the bytes counted in
    ``pipeline.COUNTERS`` (``delta_pulls``, ``delta_pull_bytes``) are its
    bytes.  ``shards > 1`` (a pipelined mesh run): the pulled bytes are also
    attributed per path-shard (slot blocks of B/shards) into the
    ``pipeline.delta_pull_bytes_by_shard`` labeled counter, as in the JAX
    package; gather-pad rows carry no slot and are left out, so the
    per-shard figures sum to slightly less than the total.

    This is the frontier's blocking device->host point: the pull's device
    time is stamped into the device plane's ``frontier.pull_device_s``
    series (CUDA events on the current stream, host clocks on the CPU;
    attributed to the caller's dispatch scope), and the stamps whose work
    has completed are published here.

    A ``ShardedState`` (a partitioned mesh run) is pulled block by block,
    each from its own device on that device's current stream, into the one
    host mirror of the whole batch; the bytes counted are the same as for
    the gathered batch.  A device fault the blocks' work left behind (a
    partitioned segment whose barrier trapped) is raised here as a
    ``DeviceError``."""
    stamp = _devplane.stamp_begin(_state_devices(state))
    out = _pull_harvest_impl(state, arena_len, n_exec, max_live, prev=prev, shards=shards)
    _devplane.stamp_end(stamp, "frontier.pull_device_s")
    _devplane.settle()
    return out


def _state_devices(state) -> list:
    return state.devices if isinstance(state, ShardedState) else [state.pc.device]


def _scalars(state, arena_len, n_exec, max_live) -> torch.Tensor:
    dev = _state_devices(state)[0]
    return torch.stack([torch.as_tensor(x, dtype=I32, device=dev).reshape(())
                        for x in (arena_len, n_exec, max_live)])


# Delta pulls pad their index vectors to these row counts (the JAX package
# does, so that its gathers compile a few times); the full batch width is
# the last resort
_SLOT_BUCKETS = (8, 32, 128)


def _bucketed(n: int, full: int) -> int:
    return next((b for b in _SLOT_BUCKETS if b >= n and b <= full), full)


def _pack_meta_1d(state: FrontierState, arena_len, n_exec, max_live) -> torch.Tensor:
    """Every [B] field flattened into one tensor, then the three scalars."""
    return torch.cat([f for f in state if f.dim() == 1]
                     + [_scalars(state, arena_len, n_exec, max_live)])


def _meta_1d_host(state, arena_len, n_exec, max_live) -> np.ndarray:
    """``_pack_meta_1d`` on the host; a sharded state's [B] fields come from
    every block (one copy each), the scalars from the leader."""
    if not isinstance(state, ShardedState):
        return _pack_meta_1d(state, arena_len, n_exec, max_live).cpu().numpy()
    parts = [torch.cat([f for f in b if f.dim() == 1]).cpu().numpy() for b in state.blocks]
    n1 = sum(1 for f in state.blocks[0] if f.dim() == 1)
    bs = state.block_width
    fields = [np.concatenate([p[i * bs:(i + 1) * bs] for p in parts]) for i in range(n1)]
    return np.concatenate(fields + [_scalars(state, arena_len, n_exec, max_live).cpu().numpy()])


def _by_block(state, idx: np.ndarray, gather) -> np.ndarray:
    """``gather(block, local rows)`` -> numpy, for the slots ``idx`` (sorted)
    of a sharded state, each from its block's device, in ``idx``'s order;
    the whole state's for a ``FrontierState``."""
    if not isinstance(state, ShardedState):
        return gather(state, torch.from_numpy(idx.astype(np.int64)).to(state.pc.device))
    bs = state.block_width
    out = []
    for k, b in enumerate(state.blocks):
        mine = idx[(idx >= k * bs) & (idx < (k + 1) * bs)] - k * bs
        if mine.size:
            out.append(gather(b, torch.from_numpy(mine.astype(np.int64)).to(b.pc.device)))
    return np.concatenate(out, axis=0)


def _pull_delta(state: FrontierState, arena_len, n_exec, max_live, prev, shards: int = 1):
    from mythril_tpu_torch.frontier import pipeline

    B, EVT, EVW = np.asarray(prev.events).shape
    names_1d = [n for n, f in zip(prev._fields, prev) if np.asarray(f).ndim == 1]
    names_2d = [n for n, f in zip(prev._fields, prev) if np.asarray(f).ndim == 2]
    buf = _meta_1d_host(state, arena_len, n_exec, max_live)
    fields, off = {}, 0
    for n in names_1d:
        fields[n] = buf[off: off + B].copy()
        off += B
    scalars = (int(buf[off]), int(buf[off + 1]), int(buf[off + 2]))
    pulled_bytes = buf.nbytes
    n_sh = max(1, int(shards))
    # [B] planes split evenly over the contiguous slot blocks; row and event
    # gathers attribute by the pulled slot's owning shard
    shard_bytes = np.full(n_sh, buf.nbytes // n_sh, np.int64)

    halt, seed = fields["halt"], fields["seed"]
    ev_len = np.minimum(fields["ev_len"], EVT)
    dirty = (((seed >= 0) & (halt != O.H_RUNNING)) | (ev_len > 0)
             | (fields["cons_len"] != prev.cons_len))
    idx = np.nonzero(dirty)[0].astype(np.int32)
    for n in names_2d:
        fields[n] = np.asarray(getattr(prev, n)).copy()
    if idx.size:
        # the rows padded to a bucket (the JAX package's gather width, which
        # the byte counts follow); a sharded state's come from each block
        cap_n = _bucketed(idx.size, B)
        widths = [fields[n].shape[1] for n in names_2d]
        pad = np.zeros(cap_n, np.int64)
        pad[: idx.size] = idx
        rows = _by_block(state, pad if not isinstance(state, ShardedState) else idx,
                         lambda b, i: torch.cat([f[i] for f in b if f.dim() == 2], 1).cpu().numpy())
        row_bytes = cap_n * sum(widths) * 4
        pulled_bytes += row_bytes
        np.add.at(shard_bytes, idx * n_sh // B, row_bytes // cap_n)
        off2 = 0
        for n, w in zip(names_2d, widths):
            fields[n][idx] = rows[: idx.size, off2: off2 + w]
            off2 += w

    events = np.full((B, EVT, EVW), -1, np.int32)
    ev_idx = np.nonzero(ev_len > 0)[0].astype(np.int32)
    if ev_idx.size:
        cap = events_cap(int(ev_len[ev_idx].max()), EVT)
        cap_m = _bucketed(ev_idx.size, B)
        pad = np.zeros(cap_m, np.int64)
        pad[: ev_idx.size] = ev_idx
        pulled = _by_block(state, pad if not isinstance(state, ShardedState) else ev_idx,
                           lambda b, i: b.events[i, :cap, :].cpu().numpy())
        events[ev_idx, :cap, :] = pulled[: ev_idx.size]
        ev_bytes = cap_m * cap * EVW * 4
        pulled_bytes += ev_bytes
        np.add.at(shard_bytes, ev_idx * n_sh // B, ev_bytes // cap_m)
    fields["events"] = events
    pipeline.count("delta_pulls")
    pipeline.count("delta_pull_bytes", pulled_bytes)
    if n_sh > 1:
        from mythril_tpu_torch.observability.metrics import get_registry

        by_shard = get_registry().labeled_counter("pipeline.delta_pull_bytes_by_shard")
        for k in range(n_sh):
            by_shard[f"shard{k}"] += int(shard_bytes[k])
    return (FrontierState(**fields), *scalars)


def _pull_harvest_impl(state, arena_len, n_exec, max_live, prev=None, shards: int = 1):
    if isinstance(state, ShardedState):
        try:
            if prev is not None:
                return _pull_delta(state, arena_len, n_exec, max_live, prev, shards)
            return _pull_full_sharded(state, arena_len, n_exec, max_live)
        except torch.AcceleratorError as e:
            raise _device.DeviceError(f"the partitioned segment failed on the card: {e}") from e
    if any(f.dtype != I32 for f in state):
        raise ValueError("packed state transfer assumes uniform int32 fields")
    if prev is not None:
        return _pull_delta(state, arena_len, n_exec, max_live, prev, shards)
    scalars = _scalars(state, arena_len, n_exec, max_live)
    buf = torch.cat([getattr(state, n).reshape(-1) for n in _NON_EVENT] + [scalars]).cpu().numpy()
    fields, off = {}, 0
    for n in _NON_EVENT:
        shape = tuple(getattr(state, n).shape)
        size = int(np.prod(shape))
        fields[n] = buf[off: off + size].reshape(shape).copy()
        off += size
    B, EVT, EVW = state.events.shape
    max_ev = int(fields["ev_len"].max()) if B else 0
    events = np.full((B, EVT, EVW), -1, np.int32)
    if max_ev > 0:
        cap = events_cap(max_ev, EVT)
        events[:, :cap, :] = _pack_events(state, cap).cpu().numpy().reshape(B, cap, EVW)
    fields["events"] = events
    return FrontierState(**fields), int(buf[off]), int(buf[off + 1]), int(buf[off + 2])


def _pull_full_sharded(state: ShardedState, arena_len, n_exec, max_live):
    """The full pull of a sharded state: each block's, from its device (its
    events in its own bucket: a slot's events past its ``ev_len`` are -1
    either way)."""
    parts = [_pull_harvest_impl(b, 0, 0, 0)[0] for b in state.blocks]
    fields = {n: np.concatenate([getattr(p, n) for p in parts]) for n in FrontierState._fields}
    scalars = _scalars(state, arena_len, n_exec, max_live).cpu().numpy()
    return FrontierState(**fields), int(scalars[0]), int(scalars[1]), int(scalars[2])


def _pack_arena_chunk(arena: ArenaDev, lo: int, chunk: int) -> torch.Tensor:
    sl = slice(lo, lo + chunk)
    return torch.cat([arena.op[sl], arena.a[sl], arena.b[sl], arena.c[sl], arena.width[sl],
                      arena.isconst[sl].to(I32), arena.val[sl].reshape(-1)])


def pull_arena_rows(dev_arena: ArenaDev, lo: int, hi: int):
    """Rows [lo, hi) as host numpy columns, one packed copy per chunk of
    ``ARENA_CHUNK`` rows.  -> (op, a, b, c, width, isconst as int32, val as
    [n, 16] uint32), as the JAX package returns them."""
    cols = [[] for _ in range(7)]
    cap = int(dev_arena.op.shape[0])
    C = min(ARENA_CHUNK, cap)
    pos = lo
    while pos < hi:
        eff = min(pos, max(0, cap - C))
        skip = pos - eff
        take = min(hi - pos, C - skip)
        buf = _pack_arena_chunk(dev_arena, eff, C).cpu().numpy()
        parts = [buf[k * C:(k + 1) * C] for k in range(6)]
        parts.append(buf[6 * C:].view(np.uint32).reshape(C, 16))
        for out, part in zip(cols, parts):
            out.append(part[skip: skip + take])
        pos += take
    return [np.concatenate(c) if len(c) > 1 else c[0] for c in cols]


def push_arena_rows(dev_arena: ArenaDev, host_arena, lo: int, hi: int) -> ArenaDev:
    """Write host arena rows [lo, hi) into the device arena, in chunks of
    ``REINJECT_CHUNK`` rows taken from the host mirror (rows below ``lo`` in
    a clamped chunk get their own mirror values, rows past ``hi`` the
    mirror's fill: both are what decoding already sees).  Unlike the JAX
    package, which returns new arrays, this writes into ``dev_arena``'s
    tensors and returns it: the one transfer that writes device memory in
    place.  Only at a pipeline sync point (no segment in flight, no pull
    pending), on a stream ordered after the last pull's."""
    cap = int(dev_arena.op.shape[0])
    C = min(REINJECT_CHUNK, cap)
    dev = dev_arena.op.device
    pos = lo
    while pos < hi:
        eff = min(pos, max(0, cap - C))
        sl = slice(eff, eff + C)
        for dst, src in zip(dev_arena, host_arena.device_arrays()):
            src = np.asarray(src[sl])
            if src.dtype == np.uint32:
                src = src.view(np.int32)
            dst[sl] = torch.from_numpy(np.ascontiguousarray(src)).to(dev)
        pos = eff + C
    return dev_arena


# ---------------------------------------------------------------------------
# Pipelined dispatch chaining (frontier/pipeline.py).  A chained dispatch
# takes the previous segment's device outputs as they are (the host reads
# none of them) and folds in the host's corrections (the slots the last
# harvest changed) with a per-slot select.  The event buffers start empty
# for every slot, as after a full push: the harvest drains them every
# segment.
# ---------------------------------------------------------------------------

# the fields the correction merge takes from the host; events and ev_len
# start empty on the device
_MERGE_FIELDS = tuple(n for n in FrontierState._fields if n not in ("events", "ev_len"))


def _merge_corrections(prev: FrontierState, corr: FrontierState, mask) -> FrontierState:
    """``corr``'s row where ``mask`` [B] is set, else ``prev``'s; events
    -1 and ev_len 0.  Every field a new tensor (one launch each), so the
    segment may take the result without a copy."""
    fields = {}
    for name, p in zip(prev._fields, prev):
        if name in _MERGE_FIELDS:
            m = mask.reshape((-1,) + (1,) * (p.dim() - 1))
            fields[name] = torch.where(m, getattr(corr, name), p)
    fields["events"] = torch.full_like(prev.events, -1)
    fields["ev_len"] = torch.zeros_like(prev.ev_len)
    return FrontierState(**fields)


def chain_dispatch(segment, prev_out, host_state: FrontierState, corr_mask: np.ndarray,
                   code_dev, cfg, segment_id: int = -1):
    """Dispatch the next segment on the previous segment's outputs.

    ``prev_out`` is the 6-tuple a segment call returned, possibly still
    being computed; ``host_state`` is the host mirror, whose rows are
    uploaded for the slots set in ``corr_mask`` (one packed ``push_state``
    copy and the mask, both queued from pinned memory) and merged over the
    device's own rows (``_merge_corrections``).  The segment starts from the
    previous segment's arena length in device memory.  Nothing here reads a
    device value on the host, so the call returns while the previous
    segment runs; everything is queued on the current stream, which must
    be the one the previous segment ran on.  The segment's device time is
    stamped into the device plane; ``segment_id`` (the runner's dispatch
    id) only annotates the ``frontier.chain_merge`` span.  A sharded state
    (a partitioned mesh run) merges each block on its own device, on that
    device's current stream."""
    out_state, dev_arena, out_len, _n_exec, _max_live, visited = prev_out
    with _otrace.span("frontier.chain_merge", cat="device",
                      segment=segment_id):
        if isinstance(out_state, ShardedState):
            # each block's corrections merged on its own device
            bs = out_state.block_width
            merged = []
            for k, b in enumerate(out_state.blocks):
                rows = slice(k * bs, (k + 1) * bs)
                corr = push_state(FrontierState(*[np.asarray(f)[rows] for f in host_state]),
                                  device=b.pc.device)
                mask = upload(np.asarray(corr_mask, dtype=bool)[rows], b.pc.device)
                merged.append(_merge_corrections(b, corr, mask))
            merged = ShardedState(merged)
        else:
            dev = out_state.pc.device
            corr = push_state(host_state, device=dev)
            mask = upload(np.asarray(corr_mask, dtype=bool), dev)
            merged = _merge_corrections(out_state, corr, mask)
        stamp = _devplane.stamp_begin(_state_devices(out_state))
        out = segment(merged, dev_arena, out_len, visited, code_dev, cfg, fresh_state=True)
        _devplane.stamp_end(stamp, "frontier.segment_device_s")
        return out
