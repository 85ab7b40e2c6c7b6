"""Abstract stack-height analysis: statically guaranteed underflows.

Per block, a fixpoint over the CFG propagates the MAXIMUM possible entry
stack height (join = max, capped at the EVM's 1024 limit).  If even that
maximum height underflows at some instruction, every path through the
block underflows there — the VM exceptionally halts, so the rest of the
block and its outgoing edges are statically dead.  Using the maximum is
what makes the proof sound: a lower real entry height only underflows
earlier.
"""

from __future__ import annotations

import numpy as np

from mythril_tpu_torch.staticpass.cfg import StaticCFG

_EVM_STACK_LIMIT = 1024


def underflow_points(cfg: StaticCFG) -> np.ndarray:
    """Per block: instruction index of the first statically guaranteed
    stack underflow, or -1.  Only meaningful for reachable blocks."""
    t = cfg.tables
    B = cfg.n_blocks
    entry_max = np.full(B, -1, np.int64)  # -1 = not yet visited
    under = np.full(B, -1, np.int32)
    if not B:
        return under
    entry_max[0] = 0  # a frame always starts with an empty stack

    def walk(b: int):
        """(first_underflow_instr or -1, exit_height or None)."""
        cur = int(entry_max[b])
        for i in range(int(cfg.block_start[b]), int(cfg.block_end[b])):
            if cur < int(t.arity[i]):
                return i, None
            cur = min(cur + int(t.delta[i]), _EVM_STACK_LIMIT)
        return -1, cur

    worklist = [0]
    while worklist:
        b = worklist.pop()
        u, exit_h = walk(b)
        if u >= 0:
            continue  # no exit: successors get nothing from this block
        for nb in cfg.succ[b]:
            if exit_h > entry_max[nb]:
                entry_max[nb] = exit_h
                worklist.append(nb)

    # final verdicts with the converged (over-approximate) entry heights
    for b in range(B):
        if entry_max[b] >= 0:
            under[b], _ = walk(b)
    return under
