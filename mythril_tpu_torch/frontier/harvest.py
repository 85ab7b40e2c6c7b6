"""The harvest: event ingestion, replay and slot-order commit.

The host side of every segment — drain device events into path records,
replay finished paths through the walker, recycle slots — in the JAX
package's serial sweep (its ``harvest_workers=0`` branch, the parity
baseline of its sharded executor):

1. **Vectorized event ingestion** (``ingest_events``): one NumPy batch
   decode over the event buffer; fork->child chains resolve with an
   iterative frontier over the newly created child slots, so each slot is
   scanned exactly once per harvest.
2. **Replay** of every finishing record, in slot order, through
   ``walker.replay``.  A record whose replay raises is dropped, as in the
   JAX package, and counted in ``FrontierStatistics.replay_errors``; a
   ``DeviceError`` (a kernel that did not build or launch) propagates.
3. **Commit**, in slot order: park routing (``walker.commit``), slot clears.
   A commit that raises is counted in ``FrontierStatistics.commit_errors``.

The replay pool of the JAX package (``harvest_workers > 0``) comes later.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

import numpy as np

from mythril_tpu_torch.device import DeviceError
from mythril_tpu_torch.frontier import ops as O
from mythril_tpu_torch.frontier.records import PathRecord, snapshot_slot
from mythril_tpu_torch.frontier.state import FrontierState, clear_slot
from mythril_tpu_torch.frontier.stats import FrontierStatistics
from mythril_tpu_torch.support.support_args import args

log = logging.getLogger(__name__)


def ingest_events(st: FrontierState, records: Dict[int, Optional[PathRecord]],
                  ev_seen: np.ndarray) -> int:
    """Append every unseen event row to its slot's record; create child
    records for granted forks.  Returns the number of rows ingested.

    Equivalent to the serial reference (slot-order scan, repeated until no
    new record appears) by construction: rows append to each record in
    per-slot k order, ``children_by_event`` keys are the parent-stream
    indices at append time, and a child created by a fork event joins the
    next frontier wave with ``ev_seen = 0`` — its same-segment events are
    scanned exactly once, just like the rescan would."""
    B, EVT, _EVW = st.events.shape
    ev_len = np.minimum(np.asarray(st.ev_len, np.int64), EVT)
    frontier = [s for s in range(B) if records[s] is not None]
    col = np.arange(EVT)
    ingested = 0
    while frontier:
        sel = np.zeros(B, bool)
        sel[frontier] = True
        want = sel[:, None] & (col >= ev_seen[:, None]) & (col < ev_len[:, None])
        slots, ks = np.nonzero(want)  # row-major: sorted by slot, then k
        # one batch gather copies every new row at once; iterating the
        # result yields per-event views of the copy (read-only downstream)
        rows = st.events[slots, ks]
        next_frontier: List[int] = []
        if slots.size:
            is_fork = (rows[:, O.EV_KIND] == O.E_FORK) & (rows[:, O.EV_EXTRA] >= 0)
            uniq, starts = np.unique(slots, return_index=True)
            bounds = np.append(starts, slots.size)
            for i, s in enumerate(uniq):
                lo, hi = int(bounds[i]), int(bounds[i + 1])
                rec = records[s]
                base = len(rec.events)
                rec.events.extend(rows[lo:hi])
                for j in np.flatnonzero(is_fork[lo:hi]):
                    ev_idx = base + int(j)
                    child_slot = int(rows[lo + j, O.EV_EXTRA])
                    child = PathRecord(
                        seed_idx=rec.seed_idx,
                        parent=rec,
                        fork_event_idx=ev_idx,
                    )
                    rec.children_by_event[ev_idx] = child
                    records[child_slot] = child
                    ev_seen[child_slot] = 0
                    next_frontier.append(child_slot)
            ingested += int(slots.size)
        ev_seen[frontier] = ev_len[frontier]
        frontier = next_frontier
    return ingested


def attribute_steps(st: FrontierState,
                    records: Dict[int, Optional[PathRecord]],
                    walker) -> None:
    """Per-laser total_states attribution from the device step counters,
    batch-computed (the host engine counts every state it steps; the device
    equivalent is instructions executed per path)."""
    B = st.steps.shape[0]
    active = [s for s in range(B) if records[s] is not None]
    if not active:
        return
    steps = np.asarray(st.steps)[active]
    seen = np.fromiter(
        (records[s].steps_seen for s in active), np.int64, len(active)
    )
    for i in np.flatnonzero(steps > seen):
        s = active[int(i)]
        rec = records[s]
        rec.steps_seen = int(steps[i])
        walker.lasers[rec.seed_idx].total_states += int(steps[i] - seen[i])


def harvest(engine, st: FrontierState, records, walker,
            ev_seen: np.ndarray) -> None:
    """Full harvest of one pulled segment: ingest -> solve -> replay ->
    commit."""
    caps = engine.caps
    stats = FrontierStatistics()

    ingest_events(st, records, ev_seen)
    attribute_steps(st, records, walker)

    # feasibility prune + mutation-check prefetch: batched solver work
    if not args.sparse_pruning:
        engine._prune_running(st, records, walker, ev_seen)
    engine._prefetch_mutation_checks(st, records, walker)

    # decide finishing slots in slot order: a pending-fork resume sees
    # exactly the slots already free plus earlier finishing slots
    halts = np.asarray(st.halt)
    free_cnt = sum(1 for s in range(caps.B) if records[s] is None)
    finishing: List[int] = []
    for slot in range(caps.B):
        rec = records[slot]
        if rec is None:
            continue
        halt = int(halts[slot])
        if halt == O.H_RUNNING:
            continue
        if halt == O.H_PENDING_FORK and free_cnt > 0:
            # slots freed this harvest: just resume next segment
            st.halt[slot] = O.H_RUNNING
            continue
        # batch saturated pending-forks spill to the host engine
        rec.final = snapshot_slot(st, slot)
        stats.device_paths += 1
        if halt == O.H_PENDING_FORK:
            rec.final["halt"] = O.H_PARK
            stats.record_bulk_park("batch-full")
        elif halt == O.H_PAGE_FAULT:
            # packed-code paging: the pc left the code's resident window.
            # Degrade to an ordinary park carrier (the host engine is
            # always correct) and tell the engine which window to fold in
            # at the next repack; past the code's fault budget, pin the
            # carrier host-side instead of re-injecting into another fault
            rec.final["halt"] = O.H_PARK
            rec.final["page_fault"] = True
            ok = engine._note_page_fault(
                int(np.asarray(st.code_id)[slot]),
                int(rec.final["pc"]),
            )
            if not ok:
                rec.final["semantic_park"] = True
                stats.semantic_parks += 1
            stats.record_bulk_park("page-fault")
        elif halt == O.H_PARK:
            pc = int(rec.final["pc"])
            names = walker.tables_for(rec).opcode_names
            stats.record_park(names[pc] if pc < len(names) else "?")
            # semantic park: re-injecting at this pc would immediately
            # re-park — the walker stamps the carrier so _mid_eligible
            # holds it host-side until the host steps past the pc
            rec.final["semantic_park"] = True
            stats.semantic_parks += 1
        finishing.append(slot)
        free_cnt += 1

    for slot in finishing:
        rec = records[slot]
        try:
            walker.replay(rec)
        except DeviceError:
            raise
        except Exception as e:
            rec._replay_err = e

    for slot in finishing:
        rec = records[slot]
        if rec._replay_err is not None:
            stats.replay_errors += 1
            log.warning(
                "frontier walker failed on a path: %s",
                rec._replay_err, exc_info=rec._replay_err,
            )
        else:
            try:
                walker.commit(rec)
            except DeviceError:
                raise
            except Exception as e:
                stats.commit_errors += 1
                log.warning("frontier walker failed on a path: %s", e,
                            exc_info=True)
        records[slot] = None
        clear_slot(st, slot)
        ev_seen[slot] = 0
