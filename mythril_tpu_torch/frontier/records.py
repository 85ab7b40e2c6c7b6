"""Host-side path lineage: the fork tree behind the device batch.

Slots in the device batch are recycled, so the host keeps one ``PathRecord``
per logical path: its parent link (which event in the parent's stream forked
it), its own accumulated event rows, and — once the path halts — a snapshot
of its final device state.  This is the host half of the fork bookkeeping the
reference does implicitly with Python object identity
(mythril/laser/ethereum/svm.py:296 work_list of forked GlobalStates).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class PathRecord:
    __slots__ = (
        "seed_idx",
        "parent",
        "fork_event_idx",
        "events",
        "final",
        "dead",
        "carrier",
        "carrier_pos",
        "children_by_event",
        "_pruned_at",
        "_submitted_at",
        "steps_seen",
        "_replay_err",
        "term_class",
    )

    def __init__(self, seed_idx: int, parent: Optional["PathRecord"] = None,
                 fork_event_idx: int = -1):
        self.seed_idx = seed_idx
        self.parent = parent
        self.fork_event_idx = fork_event_idx
        self.events: List[np.ndarray] = []
        self.final: Optional[dict] = None  # device-state snapshot at halt
        self.dead = False  # killed by a PluginSkipState / dead branch
        self.carrier = None  # host GlobalState advanced to carrier_pos
        self.carrier_pos = 0  # events processed so far
        self.children_by_event: Dict[int, "PathRecord"] = {}
        self._pruned_at = 0  # constraint count last proven satisfiable
        self._submitted_at = 0  # constraint count last sent to the pool
        self.steps_seen = 0  # device step count already attributed
        self._replay_err = None  # exception captured by a replay worker
        # exploration-ledger termination class, stamped exactly once when
        # the path stops exploring (observability/exploration.TERM_CLASSES);
        # None while the path lives or when it continues host-side
        self.term_class: Optional[str] = None


def snapshot_slot(st, slot: int) -> dict:
    """Copy the per-slot device state (numpy mirror) for final processing."""
    # carrier storage/constraints are rebuilt from event replay (code.py
    # _ALWAYS_EVENT); memory is NOT — most MSTOREs ship no event, so the
    # word table rides the snapshot and walker._restore_memory writes it
    # into the carrier before the terminal replay / park resume
    mem_len = int(st.mem_len[slot])
    return {
        "halt": int(st.halt[slot]),
        "pc": int(st.pc[slot]),
        "stack": st.stack[slot, : int(st.stack_len[slot])].copy(),
        "gas_min": int(st.gas_min[slot]),
        "gas_max": int(st.gas_max[slot]),
        "depth": int(st.depth[slot]),
        "mem_size": int(st.mem_size[slot]),
        "mem": list(
            zip(
                st.mem_addr[slot, :mem_len].tolist(),
                st.mem_val[slot, :mem_len].tolist(),
            )
        ),
    }
