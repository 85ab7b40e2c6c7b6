"""Static taint reachability: may_reach[source_bit] -> sink opcodes.

A stack/memory-agnostic over-approximation of the frontier's exact row-
graph taint (frontier/taint.py): a source's value can only influence an
instruction that executes *after* the source in some execution, and every
such instruction is CFG-reachable from the source instruction in the
over-approximate CFG.  Memory flows need no modelling — an MLOAD that
observes a tainted MSTORE executes after it, hence is in the closure.

Flows the CFG cannot order are handled by GLOBAL CHANNELS: once a bit
reaches an opcode that can smuggle data out of the current frame's
control order (storage writes, any call/create — re-entry runs this code
from pc 0 in a fresh frame; cross-transaction flows re-read storage), the
bit is escalated to "may reach every reachable sink".  RETURN/REVERT join
the channel set when a call-family op exists (returndata flows back to a
caller frame) and always for creation code (the returned runtime bytecode
itself is a channel — see ROADMAP "Known deviations").
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from mythril_tpu_torch.staticpass.cfg import StaticCFG

CALL_FAMILY = frozenset(
    {"CALL", "CALLCODE", "DELEGATECALL", "STATICCALL", "CREATE", "CREATE2"}
)
GLOBAL_CHANNELS = frozenset({"SSTORE"}) | CALL_FAMILY


def may_reach(
    cfg: StaticCFG,
    block_reach: np.ndarray,
    instr_reach: np.ndarray,
    halting: np.ndarray,
    source_opcodes: Dict[int, str],
    is_creation: bool = False,
) -> Tuple[Dict[int, frozenset], frozenset]:
    """(bit -> reachable-from-source opcode names, escalated bits).

    ``source_opcodes`` maps taint bits to their source opcode (the
    frontier/taint SOURCE_OPCODES registry).  Escalated bits map to every
    opcode on a reachable instruction.
    """
    t = cfg.tables
    all_ops = frozenset(
        t.names[i] for i in range(t.n) if instr_reach[i]
    )
    channels = set(GLOBAL_CHANNELS)
    if is_creation or (all_ops & CALL_FAMILY):
        channels |= {"RETURN", "REVERT"}

    out: Dict[int, frozenset] = {}
    escalated = set()
    for bit, src_op in source_opcodes.items():
        src_blocks = {
            int(cfg.block_id[i])
            for i in range(t.n)
            if instr_reach[i] and t.names[i] == src_op
        }
        if not src_blocks:
            out[bit] = frozenset()
            continue
        # forward closure over the pruned CFG (halting blocks emit nothing)
        seen = np.zeros(cfg.n_blocks, bool)
        stack = [b for b in src_blocks if block_reach[b]]
        for b in stack:
            seen[b] = True
        while stack:
            b = stack.pop()
            if halting[b]:
                continue
            for nb in cfg.succ[b]:
                if block_reach[nb] and not seen[nb]:
                    seen[nb] = True
                    stack.append(nb)
        ops = frozenset(
            t.names[i]
            for b in np.flatnonzero(seen)
            for i in range(int(cfg.block_start[b]), int(cfg.block_end[b]))
            if instr_reach[i]
        )
        if ops & channels:
            escalated.add(bit)
            ops = all_ops
        out[bit] = ops
    return out, frozenset(escalated)
