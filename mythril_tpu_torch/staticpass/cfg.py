"""CFG recovery: basic blocks, static jump resolution, reachability.

Jump targets are resolved by constant-folding a bounded abstract stack of
push constants *within each block* (the `PUSHn dest JUMP[I]` idiom that
dominates solc output, plus simple arithmetic folds the optimizer emits).
Anything unresolved is over-approximated with edges to EVERY JUMPDEST, so
static reachability can only over-count — the soundness contract every
consumer relies on (issue sets must be identical with the pass on or off).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from mythril_tpu_torch.staticpass.tables import InstrTables

# abstract stack depth bound: values pushed below this are forgotten
# (reads past the known region return "unknown", never a wrong constant)
_ABS_STACK_CAP = 64

# edge kinds (report export maps these onto core.cfg.JumpType)
E_FALL = "fall"  # sequential flow / JUMPI false branch
E_JUMP = "jump"  # statically resolved JUMP/JUMPI target
E_DYN = "dyn"  # unresolved jump: over-approximated to all JUMPDESTs

_FOLD_BINOPS = {
    "ADD": lambda a, b: a + b,
    "SUB": lambda a, b: a - b,
    "MUL": lambda a, b: a * b,
    "AND": lambda a, b: a & b,
    "OR": lambda a, b: a | b,
    "XOR": lambda a, b: a ^ b,
    "SHL": lambda s, v: v << s if s < 512 else 0,
    "SHR": lambda s, v: v >> s if s < 512 else 0,
}
_U256 = (1 << 256) - 1


class StaticCFG:
    """Basic blocks over an InstrTables + successor lists per block."""

    def __init__(self, tables: InstrTables):
        t = self.tables = tables
        n = t.n

        # leaders: instr 0, every JUMPDEST, every instr after a block ender
        leader = np.zeros(n, bool)
        if n:
            leader[0] = True
            leader |= t.is_jumpdest
            ender = t.is_jump | t.is_jumpi | t.is_terminator
            leader[1:] |= ender[:-1]
        self.block_start = np.flatnonzero(leader).astype(np.int32)
        self.n_blocks = len(self.block_start)
        self.block_end = np.empty(self.n_blocks, np.int32)  # exclusive
        if self.n_blocks:
            self.block_end[:-1] = self.block_start[1:]
            self.block_end[-1] = n
        self.block_id = np.zeros(n, np.int32)
        for b in range(self.n_blocks):
            self.block_id[self.block_start[b]: self.block_end[b]] = b

        self.jumpdest_blocks: List[int] = [
            int(self.block_id[i]) for i in np.flatnonzero(t.is_jumpdest)
        ]
        # -1 or resolved target *instruction index* per JUMP/JUMPI
        self.static_target = np.full(n, -1, np.int32)
        self.n_resolved = 0
        # per block: successor block ids + edge kinds, parallel lists
        self.succ: List[List[int]] = [[] for _ in range(self.n_blocks)]
        self.succ_kind: List[List[str]] = [[] for _ in range(self.n_blocks)]
        self._build_edges()

    # -- abstract constant stack ---------------------------------------

    def _block_top_const(self, b: int) -> Optional[int]:
        """Constant on top of the abstract stack right before the block's
        final instruction (the would-be jump target), or None."""
        t = self.tables
        s, e = int(self.block_start[b]), int(self.block_end[b])
        stk: List[Optional[int]] = []
        for i in range(s, e - 1):
            name = t.names[i]
            if name.startswith("PUSH"):
                stk.append(t.arg[i] if t.arg[i] is not None else 0)
            elif name == "PC":
                stk.append(int(t.addr[i]))
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
            elif name in _FOLD_BINOPS and len(stk) >= 2 \
                    and stk[-1] is not None and stk[-2] is not None:
                a, bv = stk.pop(), stk.pop()
                stk.append(_FOLD_BINOPS[name](a, bv) & _U256)
            else:
                for _ in range(int(t.arity[i])):
                    if stk:
                        stk.pop()
                stk.extend([None] * int(t.pushes[i]))
            if len(stk) > _ABS_STACK_CAP:
                del stk[: len(stk) - _ABS_STACK_CAP]
        return stk[-1] if stk else None

    # -- edges ----------------------------------------------------------

    def _add_edge(self, b: int, to: int, kind: str) -> None:
        self.succ[b].append(to)
        self.succ_kind[b].append(kind)

    def _build_edges(self) -> None:
        t = self.tables
        for b in range(self.n_blocks):
            last = int(self.block_end[b]) - 1
            name = t.names[last]
            fall = b + 1 if b + 1 < self.n_blocks else None
            if t.is_terminator[last]:
                continue
            if not (t.is_jump[last] or t.is_jumpi[last]):
                if fall is not None:
                    self._add_edge(b, fall, E_FALL)
                continue
            target = self._block_top_const(b)
            if target is not None:
                dest = t.jumpdest_at_addr.get(int(target))
                if dest is not None:
                    self.static_target[last] = dest
                    self.n_resolved += 1
                    self._add_edge(b, int(self.block_id[dest]), E_JUMP)
                # resolved-but-invalid destination: the VM halts there,
                # so no jump edge at all
            else:
                for jb in self.jumpdest_blocks:
                    self._add_edge(b, jb, E_DYN)
            if t.is_jumpi[last] and fall is not None:
                self._add_edge(b, fall, E_FALL)

    # -- reachability ----------------------------------------------------

    def reachable_blocks(self, halting: Optional[np.ndarray] = None) -> np.ndarray:
        """Bool mask of blocks reachable from the entry block; a block
        flagged in ``halting`` is entered but contributes no successors
        (statically guaranteed underflow before its terminator)."""
        reach = np.zeros(self.n_blocks, bool)
        if not self.n_blocks:
            return reach
        stack = [0]
        reach[0] = True
        while stack:
            b = stack.pop()
            if halting is not None and halting[b]:
                continue
            for nb in self.succ[b]:
                if not reach[nb]:
                    reach[nb] = True
                    stack.append(nb)
        return reach

    def edge_list(self) -> List[Tuple[int, int, str]]:
        return [
            (b, to, kind)
            for b in range(self.n_blocks)
            for to, kind in zip(self.succ[b], self.succ_kind[b])
        ]
