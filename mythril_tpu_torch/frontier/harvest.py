"""The harvest: event ingestion, the replay pool and the slot-order commit.

The host side of every segment — drain device events into path records,
replay finished paths through the walker, recycle slots — as the JAX
package's ``HarvestExecutor`` runs it:

1. **Vectorized event ingestion** (``ingest_events``): one NumPy batch
   decode over the event buffer; fork->child chains resolve with an
   iterative frontier over the newly created child slots, so each slot is
   scanned exactly once per harvest.
2. **Seed-affinity replay workers** (``HarvestExecutor``).  Terminal
   replays shard across a persistent thread pool (``args.harvest_workers``,
   4 by default; 0 replays inline, the serial escape hatch).  The shard key
   is (the slot's device shard, the laser owning ``rec.seed_idx``): a
   laser's subgroups replay on one worker, back to back in device order
   (``_replay_subgroups``), which is slot order, so no two workers touch
   the same LaserEVM or plugin state.  Without a mesh the device shard is
   0 for every slot.  Cross-laser shared state is guarded elsewhere: the
   solver memos (``smt/solver.py`` ``_cache_lock``), the term intern table
   (``smt/terms.py``), the frontier's counters; the walker's row bindings
   are per laser.  A replay that raises is dropped, as in the JAX package,
   and counted in ``FrontierStatistics.replay_errors``; a device fault
   (``device.is_device_fault``: a kernel that did not build, launch or
   run, or an allocation the card refused) is raised on the calling thread
   once every worker of the harvest has finished.
3. **Deterministic slot-order commit**, on the calling thread: pending-fork
   resume decisions, final-state snapshots, park stamps, walker ``commit``
   (park-sink routing), slot clears and the pipeline's correction-ledger
   touches.  A commit that raises is counted in
   ``FrontierStatistics.commit_errors``; a device fault propagates.  Issue sets and park stamps are
   the same with any number of workers.

``pipe`` is the pipelined runner when it drives the harvest: slot mutations
are reported to its correction ledger and feasibility checks go to its
background pool (``engine._prune_running``).  Every path that retires
through the commit is stamped with its termination class in the
exploration ledger (``classify_termination``), as in the JAX package, and
each phase has the JAX package's span and ``frontier.harvest.*_s``
histogram; a replay worker's span finishes the flow arrow its submit
started.
"""

from __future__ import annotations

import logging
import time
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Dict, List, Optional

import numpy as np

from mythril_tpu_torch.device import is_device_fault
from mythril_tpu_torch.frontier import ops as O
from mythril_tpu_torch.frontier.records import PathRecord, snapshot_slot
from mythril_tpu_torch.frontier.state import FrontierState, clear_slot
from mythril_tpu_torch.frontier.stats import FrontierStatistics
from mythril_tpu_torch.observability import tracer as _otrace
from mythril_tpu_torch.observability.exploration import get_exploration_ledger
from mythril_tpu_torch.observability.metrics import get_registry as _get_metrics
from mythril_tpu_torch.support.support_args import args

log = logging.getLogger(__name__)

# Termination attribution (observability/exploration.py): halt kind ->
# ledger class for paths retiring through the commit loop.  Parks
# (H_PARK / H_PENDING_FORK spills) are absent on purpose — those paths
# continue host-side and must not be stamped as terminated.
_TERMINAL_CLASS = {
    O.H_STOP: "completed",
    O.H_RETURN: "completed",
    O.H_REVERT: "completed",
    O.H_SELFDESTRUCT: "completed",
    O.H_INVALID: "completed",
    O.H_DEPTH: "budget_exhausted",
    O.H_LOOP: "loop_bound",
}


def classify_termination(rec: PathRecord) -> Optional[str]:
    """Exploration-ledger class for a retiring record, or ``None`` when
    the path parks (continues host-side)."""
    if rec.term_class is not None:
        return rec.term_class
    if rec.dead:
        # walker kill without an explicit class (dead branch detected
        # during replay, empty hook result, ...) counts as a normally
        # completed path; plugin prunes set term_class before dying
        return "completed"
    if rec._replay_err is not None or rec.final is None:
        return "completed"
    return _TERMINAL_CLASS.get(int(rec.final["halt"]))


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


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------


def _replay_group(walker, recs: List[PathRecord]) -> None:
    """Replay one laser shard's finished records, in slot order.  An
    exception poisons only the failing record (stored for the commit phase
    to count and log); a device fault (``is_device_fault``) stops the shard
    and reaches the calling thread."""
    for rec in recs:
        try:
            walker.replay(rec)
        except Exception as e:
            if is_device_fault(e):
                raise
            rec._replay_err = e


def _replay_subgroups(walker, subgroups: List[List[PathRecord]],
                      sid: int = -1, fid: Optional[int] = None) -> None:
    """Replay one laser's per-device subgroups sequentially, device order.

    Under a path-sharded mesh the replay shard key is (device, laser); a
    laser's state is still single-threaded, so all of its device subgroups
    run on ONE worker, back to back.  Shards are contiguous slot blocks, so
    device order within a laser is exactly slot order — bit-identical to
    the unsharded per-laser replay.  A device fault stops the laser's
    replays and reaches the calling thread.

    ``sid``/``fid`` are trace correlation handles: the worker span carries
    the segment id and finishes the flow arrow the harvest thread started
    when it submitted this laser's work."""
    with _otrace.span("frontier.replay", cat="frontier", segment=sid,
                      paths=sum(len(r) for r in subgroups)):
        if fid is not None:
            _otrace.get_tracer().flow("f", fid, "flow.replay", cat="frontier")
        for recs in subgroups:
            _replay_group(walker, recs)


# The replay pool is process-wide and persistent (spawning threads per
# harvest would cost more than short replays take); it is resized lazily
# when --harvest-workers changes between analyses
_pool: Optional[ThreadPoolExecutor] = None
_pool_size = 0


def _shared_pool(workers: int) -> Optional[ThreadPoolExecutor]:
    global _pool, _pool_size
    if workers <= 0:
        return None
    if _pool is None or _pool_size != workers:
        if _pool is not None:
            _pool.shutdown(wait=True)
        _pool = ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="mythril-harvest"
        )
        _pool_size = workers
    return _pool


def shutdown_replay_pool() -> None:
    """Drain and drop the shared replay pool (test isolation hook)."""
    global _pool, _pool_size
    if _pool is not None:
        _pool.shutdown(wait=True)
        _pool = None
        _pool_size = 0


class HarvestExecutor:
    """Drives the ingest -> solve -> replay -> commit phases of a harvest,
    sharding the replay phase over the shared pool.

    ``workers == 0`` is the serial escape hatch (``--harvest-workers 0``):
    the same phase structure, replayed inline on the calling thread."""

    def __init__(self, engine, workers: Optional[int] = None):
        self.engine = engine
        if workers is None:
            workers = getattr(args, "harvest_workers", 0)
        self.workers = max(0, int(workers))

    def harvest(self, st: FrontierState, records, walker,
                ev_seen: np.ndarray, pipe=None) -> None:
        """Full harvest of one pulled segment."""
        eng = self.engine
        caps = eng.caps
        reg = _get_metrics()
        stats = FrontierStatistics()
        sid = getattr(pipe, "current_sid", -1) if pipe is not None else -1

        t0 = time.perf_counter()
        with _otrace.span("frontier.harvest.ingest", cat="frontier",
                          segment=sid):
            ingest_events(st, records, ev_seen)
            attribute_steps(st, records, walker)
        t1 = time.perf_counter()
        reg.observe("frontier.harvest.ingest_s", t1 - t0)

        # feasibility prune + mutation-check prefetch: batched solver work
        # (the pipelined path submits to the background pool instead)
        with _otrace.span("frontier.harvest.solver", cat="solver",
                          segment=sid):
            if not args.sparse_pruning:
                eng._prune_running(st, records, walker, ev_seen, pipe)
            eng._prefetch_mutation_checks(st, records, walker)
        t2 = time.perf_counter()
        reg.observe("frontier.harvest.solver_s", t2 - t1)

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
                if pipe is not None:
                    pipe.ledger.touch(slot)
                continue
            # batch saturated pending-forks spill to the host engine
            rec.final = snapshot_slot(st, slot)
            stats.count("device_paths")
            if halt == O.H_PENDING_FORK:
                rec.final["halt"] = O.H_PARK
                stats.record_bulk_park("batch-full")
            elif halt == O.H_PAGE_FAULT:
                # packed-code paging: the pc left the code's resident
                # window.  Degrade to an ordinary park carrier (the host
                # engine is always correct) and tell the engine which
                # window to fold in at the next repack; past the code's
                # fault budget, pin the carrier host-side instead of
                # re-injecting into another fault
                rec.final["halt"] = O.H_PARK
                rec.final["page_fault"] = True
                ok = eng._note_page_fault(
                    int(np.asarray(st.code_id)[slot]),
                    int(rec.final["pc"]),
                )
                if not ok:
                    rec.final["semantic_park"] = True
                    stats.count("semantic_parks")
                stats.record_bulk_park("page-fault")
            elif halt == O.H_PARK:
                pc = int(rec.final["pc"])
                names = walker.tables_for(rec).opcode_names
                stats.record_park(names[pc] if pc < len(names) else "?")
                # semantic park: re-injecting at this pc would immediately
                # re-park — the walker stamps the carrier so _mid_eligible
                # holds it host-side until the host steps past the pc
                rec.final["semantic_park"] = True
                stats.count("semantic_parks")
            finishing.append(slot)
            free_cnt += 1

        # replay: shard by (device, owning laser) — slot order within each
        # shard.  The device component is the slot's owning path-shard
        # (identity when there is no mesh), so per-shard pull attribution
        # and replay accounting line up; per-laser serialization is kept by
        # merging a laser's device subgroups onto one worker
        t3 = time.perf_counter()
        pool = _shared_pool(self.workers)
        if pool is not None and finishing:
            n_sh = max(1, getattr(pipe, "n_shards", 1)) if pipe else 1
            groups: Dict[tuple, List[PathRecord]] = {}
            for slot in finishing:
                rec = records[slot]
                key = (slot * n_sh // caps.B, id(walker.laser_for(rec)))
                groups.setdefault(key, []).append(rec)
            by_laser: Dict[int, List[List[PathRecord]]] = {}
            for shard, lid in sorted(groups):
                by_laser.setdefault(lid, []).append(groups[(shard, lid)])
            tracer = _otrace.get_tracer()
            futs = []
            for subs in by_laser.values():
                fid = None
                if tracer.enabled:
                    # flow arrow: this harvest slice -> the worker's replay
                    # span (emitted before submit so "s" precedes "f")
                    fid = tracer.new_flow_id()
                    tracer.flow("s", fid, "flow.replay", cat="frontier")
                futs.append(pool.submit(_replay_subgroups, walker, subs, sid, fid))
            # every shard finishes before a device fault unwinds the harvest
            wait(futs)
            for f in futs:
                f.result()
            reg.counter("frontier.harvest.replay_shards").inc(len(by_laser))
            reg.counter("frontier.harvest.device_laser_shards").inc(len(groups))
            reg.counter("frontier.harvest.sharded_paths").inc(len(finishing))
        else:
            _replay_subgroups(walker, [[records[slot] for slot in finishing]], sid)
        t4 = time.perf_counter()
        reg.observe("frontier.harvest.replay_s", t4 - t3)

        # commit: calling thread, slot order — park routing, slot
        # recycling, ledger touches, termination stamps
        with _otrace.span("frontier.harvest.commit", cat="frontier",
                          segment=sid, paths=len(finishing)):
            self._commit(st, records, walker, ev_seen, pipe, finishing)
        reg.observe("frontier.harvest.commit_s", time.perf_counter() - t4)

    @staticmethod
    def _commit(st, records, walker, ev_seen, pipe, finishing) -> None:
        stats = FrontierStatistics()
        led = get_exploration_ledger()
        for slot in finishing:
            rec = records[slot]
            if rec._replay_err is not None:
                stats.count("replay_errors")
                log.warning(
                    "frontier walker failed on a path: %s",
                    rec._replay_err, exc_info=rec._replay_err,
                )
            else:
                try:
                    walker.commit(rec)
                except Exception as e:
                    if is_device_fault(e):
                        raise
                    stats.count("commit_errors")
                    log.warning("frontier walker failed on a path: %s", e,
                                exc_info=True)
            if rec.term_class is None:
                cls = classify_termination(rec)
                if cls is not None:
                    rec.term_class = cls
                    led.stamp(cls)
            records[slot] = None
            clear_slot(st, slot)
            ev_seen[slot] = 0
            if pipe is not None:
                pipe.ledger.touch(slot)
