"""Interprocedural value-set refinement over the static CFG.

The base :class:`~mythril_tpu_torch.staticpass.cfg.StaticCFG` resolves jump
targets only from constants pushed *within the same block*; anything
else fans out to every JUMPDEST.  This module runs a bounded fixpoint
of a value-set abstract interpreter over the whole frame instead:

* abstract value = ``None`` (unknown, ⊤) or a ``frozenset`` of at most
  :data:`VSET_CAP` concrete 256-bit values,
* abstract stack = list of abstract values tracked from the frame base
  (an EVM frame always enters at pc 0 with an empty stack, so heights
  are absolute),
* join = per-position value union (⊤ on overflow), with stacks of
  unequal height aligned from the top and truncated to the shorter one,
* transfer = PUSH/PC/DUP/SWAP/POP plus the constant folds solc's
  optimizer output needs (arithmetic, shifts, comparisons, ISZERO/NOT);
  every other opcode pops its arity and pushes ⊤.

The lattice is finite and the transfer monotone, so the fixpoint
terminates; a visit budget additionally bounds the worst case, and
exhaustion returns ``None`` so the caller falls back to the base CFG
(strictly coarser, never wrong).

The converged result is a :class:`RefinedFlow` that duck-types
``StaticCFG`` (``underflow_points`` and ``may_reach`` run on it
unchanged) but with *refined* successor lists: a JUMP whose destination
value-set is known gets edges only to those destinations, and a JUMPI
whose condition folds to all-zero / never-zero loses its taken / fall
edge.  Refinement only ever REMOVES edges relative to the base CFG —
the over-approximation contract every consumer relies on — and
``summarize`` double-checks that with an explicit reachability-subset
invariant before trusting the refinement.
"""

from __future__ import annotations

from typing import Callable, FrozenSet, List, Optional, Tuple

import numpy as np

from mythril_tpu_torch.staticpass.cfg import (
    _FOLD_BINOPS,
    _U256,
    E_DYN,
    E_FALL,
    E_JUMP,
    StaticCFG,
)

# abstract value: None = unknown (⊤), else a frozenset of concrete values
AbsVal = Optional[FrozenSet[int]]
AbsStack = List[AbsVal]

VSET_CAP = 8  # widest value-set before widening to ⊤
_STACK_CAP = 48  # deepest tracked stack; deeper entries are forgotten (⊤)
_VISIT_BUDGET_PER_BLOCK = 24
_VISIT_BUDGET_MIN = 512

# folds beyond cfg._FOLD_BINOPS that dispatch ladders and guard code use;
# same convention: first lambda arg is the value popped first (stack top)
_CMP_BINOPS = {
    "EQ": lambda a, b: 1 if a == b else 0,
    "LT": lambda a, b: 1 if a < b else 0,
    "GT": lambda a, b: 1 if a > b else 0,
    "DIV": lambda a, b: a // b if b else 0,
    "MOD": lambda a, b: a % b if b else 0,
}
_UNOPS = {
    "ISZERO": lambda a: 1 if a == 0 else 0,
    "NOT": lambda a: (~a) & _U256,
}


def _join_val(a: AbsVal, b: AbsVal) -> AbsVal:
    if a is None or b is None:
        return None
    if a == b:
        return a
    u = a | b
    return u if len(u) <= VSET_CAP else None


def _join_stack(old: Optional[AbsStack], new: AbsStack) -> Tuple[AbsStack, bool]:
    """Join ``new`` into ``old`` (None = not yet visited); returns the
    joined stack and whether it differs from ``old``."""
    if old is None:
        return list(new), True
    h = min(len(old), len(new))
    out: AbsStack = []
    changed = len(old) != h
    for j in range(h):
        v = _join_val(old[len(old) - h + j], new[len(new) - h + j])
        out.append(v)
        if v != old[len(old) - h + j]:
            changed = True
    return out, changed


def _peek(stk: AbsStack, k: int) -> AbsVal:
    """k-th value from the top (k=1 is top); ⊤ past the tracked region."""
    return stk[-k] if len(stk) >= k else None


def _fold2(name: str, va: AbsVal, vb: AbsVal) -> AbsVal:
    if va is None or vb is None:
        return None
    fn = _FOLD_BINOPS.get(name) or _CMP_BINOPS[name]
    out = set()
    for a in va:
        for b in vb:
            out.add(fn(a, b) & _U256)
            if len(out) > VSET_CAP:
                return None
    return frozenset(out)


def _step(t, i: int, stk: AbsStack) -> None:
    """Apply instruction ``i``'s transfer to ``stk`` in place."""
    name = t.names[i]
    if name.startswith("PUSH"):
        stk.append(frozenset({(t.arg[i] or 0) & _U256}))
    elif name == "PC":
        stk.append(frozenset({int(t.addr[i])}))
    elif name.startswith("DUP"):
        k = int(name[3:])
        stk.append(stk[-k] if len(stk) >= k else None)
    elif name.startswith("SWAP"):
        k = int(name[4:])
        if len(stk) < k + 1:
            stk[:0] = [None] * (k + 1 - len(stk))
        stk[-1], stk[-k - 1] = stk[-k - 1], stk[-1]
    elif name == "POP":
        if stk:
            stk.pop()
    elif name in _UNOPS:
        a = stk.pop() if stk else None
        stk.append(
            frozenset(_UNOPS[name](x) for x in a) if a is not None else None
        )
    elif name in _FOLD_BINOPS or name in _CMP_BINOPS:
        a = stk.pop() if stk else None
        b = stk.pop() if stk else None
        stk.append(_fold2(name, a, b))
    else:
        for _ in range(int(t.arity[i])):
            if stk:
                stk.pop()
        stk.extend([None] * int(t.pushes[i]))
    if len(stk) > _STACK_CAP:
        del stk[: len(stk) - _STACK_CAP]


def walk_block(
    tables,
    entry_stack: AbsStack,
    start: int,
    end: int,
    observer: Optional[Callable[[int, AbsStack], None]] = None,
) -> AbsStack:
    """Run the abstract transfer over instrs [start, end); ``observer``
    sees (instr_index, stack_before_instr) for each one."""
    stk = list(entry_stack)
    for i in range(start, end):
        if observer is not None:
            observer(i, stk)
        _step(tables, i, stk)
    return stk


def _jump_dest_blocks(flow, dest: AbsVal) -> Tuple[List[int], bool]:
    """(successor block ids, is_dyn_fan).  ⊤ destination keeps the base
    over-approximation (every JUMPDEST); constant members resolve to
    their JUMPDEST block or — if invalid — to nothing (the VM halts)."""
    t = flow.tables
    if dest is None:
        return list(dict.fromkeys(flow.jumpdest_blocks)), True
    out = []
    for d in dest:
        j = t.jumpdest_at_addr.get(int(d))
        if j is not None:
            out.append(int(flow.block_id[j]))
    return list(dict.fromkeys(out)), False


def _taken_dead(cond: AbsVal) -> bool:
    return cond is not None and all(c == 0 for c in cond)


def _fall_dead(cond: AbsVal) -> bool:
    return cond is not None and 0 not in cond


class RefinedFlow:
    """Refined CFG view: same blocks as the base :class:`StaticCFG`, but
    successor lists / static targets recomputed from converged value
    sets, plus the per-block entry stacks for downstream site capture
    (function summaries, call-site folding).  Duck-types ``StaticCFG``
    for ``underflow_points`` and ``may_reach``."""

    def __init__(self, cfg: StaticCFG, entry_stacks: List[Optional[AbsStack]]):
        self.tables = cfg.tables
        self.n_blocks = cfg.n_blocks
        self.block_start = cfg.block_start
        self.block_end = cfg.block_end
        self.block_id = cfg.block_id
        self.jumpdest_blocks = cfg.jumpdest_blocks
        self.entry_stacks = entry_stacks
        n = cfg.tables.n
        self.static_target = np.full(n, -1, np.int32)
        self.n_resolved = 0
        self.succ: List[List[int]] = [[] for _ in range(self.n_blocks)]
        self.succ_kind: List[List[str]] = [[] for _ in range(self.n_blocks)]
        self._build()

    def entry_stack(self, b: int) -> AbsStack:
        """Converged entry stack for block ``b``; an empty stack (every
        peek past it reads ⊤) when the fixpoint never reached it."""
        stk = self.entry_stacks[b] if 0 <= b < len(self.entry_stacks) else None
        return stk if stk is not None else []

    def _resolve_singleton(self, last: int, dest: AbsVal) -> None:
        if dest is not None and len(dest) == 1:
            j = self.tables.jumpdest_at_addr.get(int(next(iter(dest))))
            if j is not None:
                self.static_target[last] = j
                self.n_resolved += 1

    def _add(self, b: int, to: int, kind: str) -> None:
        self.succ[b].append(to)
        self.succ_kind[b].append(kind)

    def _build(self) -> None:
        t = self.tables
        for b in range(self.n_blocks):
            if self.entry_stacks[b] is None:
                continue  # never reached during the fixpoint
            s, e = int(self.block_start[b]), int(self.block_end[b])
            stk = walk_block(t, self.entry_stacks[b], s, e - 1)
            last = e - 1
            fall = b + 1 if b + 1 < self.n_blocks else None
            if t.is_terminator[last]:
                continue
            if t.is_jump[last]:
                dest = _peek(stk, 1)
                self._resolve_singleton(last, dest)
                dests, dyn = _jump_dest_blocks(self, dest)
                for d in dests:
                    self._add(b, d, E_DYN if dyn else E_JUMP)
            elif t.is_jumpi[last]:
                dest, cond = _peek(stk, 1), _peek(stk, 2)
                if not _taken_dead(cond):
                    self._resolve_singleton(last, dest)
                    dests, dyn = _jump_dest_blocks(self, dest)
                    for d in dests:
                        self._add(b, d, E_DYN if dyn else E_JUMP)
                if not _fall_dead(cond) and fall is not None:
                    self._add(b, fall, E_FALL)
            elif fall is not None:
                self._add(b, fall, E_FALL)

    # duck-typed StaticCFG surface
    def reachable_blocks(self, halting: Optional[np.ndarray] = None) -> np.ndarray:
        return StaticCFG.reachable_blocks(self, halting)

    def edge_list(self) -> List[Tuple[int, int, str]]:
        return StaticCFG.edge_list(self)


def refine(cfg: StaticCFG) -> Optional[RefinedFlow]:
    """Run the value-set fixpoint; None when the budget is exhausted
    (the caller keeps the base CFG — coarser but still sound)."""
    B = cfg.n_blocks
    if not B:
        return None
    t = cfg.tables
    budget = max(_VISIT_BUDGET_MIN, _VISIT_BUDGET_PER_BLOCK * B)
    entry: List[Optional[AbsStack]] = [None] * B
    entry[0] = []  # a frame always enters at pc 0 with an empty stack
    work = [0]
    inwork = [False] * B
    inwork[0] = True
    visits = 0
    while work:
        b = work.pop()
        inwork[b] = False
        visits += 1
        if visits > budget:
            return None
        s, e = int(cfg.block_start[b]), int(cfg.block_end[b])
        stk = walk_block(t, entry[b], s, e - 1)
        last = e - 1
        succs: List[int] = []
        if not t.is_terminator[last]:
            fall = b + 1 if b + 1 < B else None
            if t.is_jump[last]:
                succs, _ = _jump_dest_blocks(cfg, _peek(stk, 1))
            elif t.is_jumpi[last]:
                dest, cond = _peek(stk, 1), _peek(stk, 2)
                if not _taken_dead(cond):
                    succs, _ = _jump_dest_blocks(cfg, dest)
                    succs = list(succs)
                if not _fall_dead(cond) and fall is not None:
                    succs.append(fall)
            elif fall is not None:
                succs = [fall]
        if succs:
            _step(t, last, stk)  # exit stack (same for every successor)
            for nb in succs:
                joined, changed = _join_stack(entry[nb], stk)
                if changed:
                    entry[nb] = joined
                    if not inwork[nb]:
                        inwork[nb] = True
                        work.append(nb)
    return RefinedFlow(cfg, entry)
