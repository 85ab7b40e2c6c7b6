"""Pipelined frontier loop: overlap device segments with host harvest/solve.

The synchronous loop in engine._run alternates strictly — dispatch a
segment, block pulling its results, harvest on the host, repeat — so the
device idles for the whole harvest.  This module keeps ONE segment in
flight at all times:

  * dispatch N+1 is CHAINED onto dispatch N's device outputs
    (step.chain_dispatch) before the host ever blocks on N, so the device
    starts segment N+1 the moment N retires while the host is still
    pulling/harvesting N;
  * host mutations from harvest N-1 (freed slots, resumed pending forks,
    fresh seed injections) ride dispatch N+1 as a per-slot correction mask
    merged on device — one packed upload, same cost the synchronous loop
    pays for its full push;
  * per-record feasibility checks (engine._prune_running) move into a
    bounded background pool: running paths continue SPECULATIVELY while the
    solver works, and an UNSAT verdict rolls the path (and any descendants
    it forked meanwhile) back at the next harvest.  Pruning is a
    performance optimization, not a soundness gate — issues are confirmed
    by their own solver queries at detection time — so late rollback keeps
    the issue set identical (args.sparse_pruning already disables the
    sweep entirely).

Correction protocol (the part that makes chaining sound):

  * every host write to a slot is uploaded EXACTLY ONCE.  corrections from
    harvest j ride dispatch j+2 (the first dispatch issued after harvest
    j), so ``active_at[slot]`` records that dispatch index;
  * until the pull of segment ``active_at[slot]`` the device's view of the
    slot is stale, so each pull carries the slot's row forward from the
    previous host mirror (pull_harvest builds a fresh mirror every
    segment).  Carried slots get ``ev_len = 0``: their device events were
    already drained at the harvest that mutated them, and re-draining the
    stale buffer would duplicate events;
  * a slot whose correction exposed it FREE becomes device-owned the
    moment a chained dispatch consumes the mask: every later chained
    segment may grant a fork into it, so the host never re-injects into it
    until a sync point (no dispatch in flight) resets ownership.  Fork
    grants into freed slots whose parent was meanwhile killed show up as
    occupied device slots with no host record — the orphan scan clears
    them and schedules the clear as a correction.

Sync points (the only places the pipeline intentionally drains): host
arena appends for spill re-injection (an in-flight segment appends device
rows at the same indices), reclaiming device-owned free slots for a
backed-up seed queue, a mesh's rebalance, and the final drain — an
in-flight segment is always pulled and harvested before the loop exits,
never discarded.

On the card (the port's own part).  The runner queues every segment and
its correction merge on a stream of its own, entered only around
``_dispatch_full`` and ``_chain``: the harvest's kernels (the prefilter's
known-bits pass, the probe) and its reads stay on the caller's stream and
never wait behind an in-flight segment.  An event recorded right behind
each segment orders its pull, which runs on a copy stream of its own, so a
pull waits for its segment and never for the one chained after it.  The
host arena's re-injected rows are written into the device arena in place
(``step.push_arena_rows``) only at a sync point, after the copy stream's
last pull.  A failed stream, event or launch raises; nothing falls back to
the synchronous loop.  On the CPU (the plain segment) the same loop runs
with no streams.  On a mesh of several cards each card has its pair of
streams, entered together: a chained dispatch's correction merge runs on
each card over its own block, the partitioned segment launches once per
card, and each card's copy stream pulls its own block.

The runner is the JAX package's on one device, with the adaptive
controller's hooks: spills the re-injection queue cannot hold wait in a
bounded park pool (``adaptive_parked``) that the steering plan resurrects
at sync points when slots free (``_adaptive_requeue``), anything still
pooled flushes back to its host work list when the run ends, on every exit
path (a pooled carrier is never also on a work list or in a slot), and the
``--coverage-target`` verdict ends the run.  Killed and retired paths are
stamped with their termination class in the exploration ledger, and the
feasibility pool attributes each solve's wall time to its program point.
On a mesh (``mesh=``, ``parallel/mesh.py``) the slot batch is path-sharded:
shard k is slot block k, injections go to the least-loaded shard
(``choose_free_slot``), an imbalance forces a sync point where
``_rebalance`` spills the hottest shard's youngest paths for re-injection
(``plan_rebalance``, with a backoff), the delta pulls' bytes and the
heartbeat's slot counts are kept per shard, and every dispatch is the
partitioned segment (``step.segment_partitioned``) over the blocks, which
live on the mesh's cards (``step.ShardedState``); the arena and the
coverage planes stay on the mesh's first device, the run's own, where the
harvest and the coverage read find them.  The tracer's spans and flows and the
device plane's scope, stamps and analysis are the JAX package's; the
``pipeline.*`` metrics live in the registry (``COUNTERS`` is a view of the
counters by name without the prefix).  Every run registers its queue depths with the
heartbeat (``observability/heartbeat.py``) and starts the sampler when
nothing else has (every ``args.heartbeat_interval`` seconds, 0.5 by
default), as in the JAX package; the sampler thread reads host-side
lengths and masks only, never a CUDA tensor, so it adds no synchronising
call.  The flight recorder's watchdog is beaten as each segment retires.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from mythril_tpu_torch.device import is_device_fault
from mythril_tpu_torch.frontier import ops as O
from mythril_tpu_torch.frontier.records import PathRecord
from mythril_tpu_torch.frontier.state import FrontierState, clear_slot
from mythril_tpu_torch.frontier.stats import FrontierStatistics
from mythril_tpu_torch.observability import deviceplane as _devplane
from mythril_tpu_torch.observability import flightrecorder as _frec
from mythril_tpu_torch.observability import tracer as _otrace
from mythril_tpu_torch.observability import views
from mythril_tpu_torch.observability.heartbeat import get_heartbeat
from mythril_tpu_torch.observability.metrics import get_registry as _get_metrics
from mythril_tpu_torch.support.support_args import args
from mythril_tpu_torch.support.time_handler import time_handler

log = logging.getLogger(__name__)

# the JAX package's ``pipeline.*`` counters; ``count`` is one registry
# increment, safe under the pool's threads
_COUNTER_NAMES = (
    "segments_pipelined", "overlap_segments", "overlap_s", "bubble_s", "carried_slots",
    "corrected_slots", "delta_pulls", "delta_pull_bytes", "pool_submitted",
    "pool_inflight_dedup", "pool_prefilter_kills", "pool_unsat_rollbacks", "orphan_rollbacks",
    "reinject_queued", "reinjected", "adaptive_parked", "rebalance_syncs", "rebalanced_slots",
)
COUNTERS = views.CounterView("pipeline.", _COUNTER_NAMES)


def count(name: str, n=1) -> None:
    _get_metrics().counter("pipeline." + name).inc(n)


def reset_counters() -> None:
    _get_metrics().reset(prefix="pipeline.")


def plan_rebalance(live: np.ndarray, free: np.ndarray, n_shards: int,
                   max_moves: int = 4) -> List[int]:
    """Slots to SPILL so live paths spread across path-shards.

    ``live``/``free`` are [B] bool masks (running record present / host-
    reclaimable).  Returns source slots, hottest shard first — the spill/
    re-inject machinery parks them and re-injects into the coolest shards'
    free slots (``choose_free_slot``).  A move is planned only while the
    hottest shard holds at least 2 more live paths than the coolest AND the
    coolest shards have free slots to receive them, so a balanced (or
    fully packed) pod plans nothing.  Pure numpy, unit-testable."""
    B = live.shape[0]
    if n_shards <= 1 or B % n_shards:
        return []
    sz = B // n_shards
    live_by = live.reshape(n_shards, sz).sum(axis=1)
    free_by = free.reshape(n_shards, sz).sum(axis=1).astype(np.int64)
    moves: List[int] = []
    spilled = np.zeros(B, bool)
    while len(moves) < max_moves:
        hot = int(np.argmax(live_by))
        order = np.argsort(live_by, kind="stable")
        cold = next((int(s) for s in order if free_by[s] > 0), None)
        if cold is None or live_by[hot] - live_by[cold] < 2:
            break
        # spill the hot shard's LAST live slot (latest-injected first, so
        # long-running early paths keep their device residency)
        block = np.flatnonzero(live[hot * sz:(hot + 1) * sz]
                               & ~spilled[hot * sz:(hot + 1) * sz])
        if block.size == 0:
            break
        src = hot * sz + int(block[-1])
        spilled[src] = True
        moves.append(src)
        live_by[hot] -= 1
        live_by[cold] += 1
        free_by[cold] -= 1
    return moves


def choose_free_slot(free: np.ndarray, live: np.ndarray,
                     n_shards: int) -> Optional[int]:
    """First free slot on the least-loaded shard (ties to the lowest shard
    index; slot order within a shard).  With one shard this is exactly the
    pre-pod first-free scan, so single-device injection order — and hence
    the parity baseline — is unchanged."""
    idx = np.flatnonzero(free)
    if idx.size == 0:
        return None
    B = free.shape[0]
    if n_shards <= 1 or B % n_shards:
        return int(idx[0])
    sz = B // n_shards
    live_by = live.reshape(n_shards, sz).sum(axis=1)
    for shard in np.argsort(live_by, kind="stable"):
        block = np.flatnonzero(free[shard * sz:(shard + 1) * sz])
        if block.size:
            return int(shard) * sz + int(block[0])
    return None


class CorrectionLedger:
    """Exactly-once correction bookkeeping for chained dispatches.

    Tracks, per slot, the index of the first segment output that reflects
    the host's latest write (``active_at``), the pending upload mask, and
    device ownership of host-freed slots.  Kept free of engine state so the
    protocol is unit-testable on its own."""

    def __init__(self, n_slots: int):
        self.corr_mask = np.zeros(n_slots, bool)
        self.active_at = np.full(n_slots, -1, np.int64)
        self.device_owned = np.zeros(n_slots, bool)
        self.next_dispatch = 0  # index of the next dispatch to be issued
        self.pulled = -1  # index of the last pulled segment

    def touch(self, slot: int) -> None:
        """Host mutated ``slot``: upload it with the next dispatch."""
        self.corr_mask[slot] = True
        self.active_at[slot] = self.next_dispatch
        count("corrected_slots")

    def consume(self, host_seed: np.ndarray) -> np.ndarray:
        """A dispatch is consuming the pending mask: return it (copy) and
        mark host-freed slots device-owned (the device may fork-grant into
        them from this dispatch on)."""
        mask = self.corr_mask.copy()
        self.device_owned |= mask & (host_seed < 0)
        self.corr_mask[:] = False
        self.next_dispatch += 1
        return mask

    def consume_all(self) -> None:
        """A FULL push is being dispatched: every slot becomes device
        authoritative at this dispatch's output."""
        self.corr_mask[:] = False
        self.active_at[:] = self.next_dispatch
        self.next_dispatch += 1

    def on_pull(self) -> np.ndarray:
        """A segment was pulled; returns the slots whose host value is
        newer than this output (to carry forward from the old mirror)."""
        self.pulled += 1
        return np.nonzero(self.active_at > self.pulled)[0]

    def carry_forward(self, new_st: FrontierState, prev_st: FrontierState
                      ) -> int:
        slots = self.on_pull()
        for slot in slots:
            s = int(slot)
            for name, dst, src in zip(new_st._fields, new_st, prev_st):
                if name == "events":
                    continue
                dst[s] = src[s]
            # host-authoritative slots have no undrained device events
            new_st.ev_len[s] = 0
        return len(slots)

    def release_owned(self) -> None:
        """Sync point (no dispatch in flight anywhere): nothing can grant
        into host-freed slots anymore, the host may reclaim them."""
        self.device_owned[:] = False


class FeasibilityPool:
    """Background solver pool for speculative feasibility checks.

    Raws are decoded on the MAIN thread (the walker/arena decode path is
    not thread-safe); workers only run check_satisfiable_batch, which is
    query-cache-aware through the solver fast path.  In-flight queries are
    deduplicated by the fast path's own canonical key (the frozenset of
    constraint term ids), so identical lineages pending at the same time
    solve once.  Actual solves are serialized under one lock: the solver's
    memo caches are shared, and the win is moving the solve OFF the
    dispatch critical path, not parallel solving.

    A worker's solve launches the solver's kernels (the tape VM, the
    lowering, known bits, DPLL) from the worker thread, on its current
    stream, on the device the pool was given (None: the card).  An
    exception of the solve stops the run as it does in the synchronous
    prune (``engine._prune_running``), where the JAX package counts it as
    "satisfiable": a kernel that fails to build or launch, faults, runs out
    of memory or refuses its shapes is not a verdict.  The worker keeps the
    first such exception, and the next ``drain``, or ``shutdown`` when no
    drain follows, raises it on the calling thread."""

    def __init__(self, workers: int, device=None):
        self._executor = ThreadPoolExecutor(
            max_workers=max(1, int(workers)),
            thread_name_prefix="mythril-feas",
        )
        self._device = device
        self._solver_lock = threading.Lock()
        self._lock = threading.Lock()
        self._inflight: Dict[frozenset, list] = {}
        self._done: list = []
        self._fault: Optional[BaseException] = None

    def submit(self, slot: int, rec, n_cons: int, raws, key: frozenset,
               sid: int = -1, verdict: Optional[bool] = None,
               point: str = "") -> None:
        """Queue a feasibility check.  ``verdict=False`` means the abstract
        pre-filter already PROVED the query UNSAT: no worker runs, and the
        verdict is published to EVERY waiter deduplicated under ``key`` —
        including ones already in flight, so concurrent identical lineages
        never fall through to an exact solve the pre-filter refuted.

        ``point`` is the program-point label ("codehash:0xPC") of the JUMPI
        being checked: the devsolver's admission attributes the query to it
        (``devsolver.admission.point_context``)."""
        if verdict is False:
            with self._lock:
                waiters = self._inflight.get(key)
                if waiters is not None:
                    waiters.append((slot, rec, n_cons))
                    count("pool_inflight_dedup")
                else:
                    self._inflight[key] = [(slot, rec, n_cons)]
                # drain() tolerates a second (key, ok, why) entry for a
                # query a worker also finishes: the later pop finds nothing
                self._done.append((key, False, "prefilter"))
            count("pool_prefilter_kills")
            return
        with self._lock:
            waiters = self._inflight.get(key)
            if waiters is not None:
                waiters.append((slot, rec, n_cons))
                count("pool_inflight_dedup")
                return
            self._inflight[key] = [(slot, rec, n_cons)]
        count("pool_submitted")
        tracer = _otrace.get_tracer()
        fid = None
        if tracer.enabled:
            # flow arrow: harvest slice (caller's thread) -> worker span
            fid = tracer.new_flow_id()
            tracer.flow("s", fid, "flow.feasibility", cat="solver")
        self._executor.submit(self._work, key, raws, sid, fid, point)

    def _work(self, key: frozenset, raws, sid: int = -1,
              fid: Optional[int] = None, point: str = "") -> None:
        from mythril_tpu_torch.devsolver.admission import point_context
        from mythril_tpu_torch.observability.exploration import (
            get_exploration_ledger,
        )
        from mythril_tpu_torch.smt import solver

        with _otrace.span("pipeline.feasibility", cat="solver", segment=sid):
            if fid is not None:
                _otrace.get_tracer().flow("f", fid, "flow.feasibility",
                                          cat="solver")
            statuses: list = []
            t0 = time.perf_counter()
            try:
                with self._solver_lock, point_context(point):
                    ok = bool(solver.check_satisfiable_batch(
                        [raws], statuses_out=statuses, device=self._device)[0])
            except Exception as e:
                with self._lock:
                    if self._fault is None:
                        self._fault = e
                return
            if point:
                get_exploration_ledger().record_solver_time(
                    point, time.perf_counter() - t0)
        why = statuses[0] if statuses else ("sat" if ok else "unsat")
        with self._lock:
            self._done.append((key, ok, why))

    def drain(self) -> list:
        """Verdicts that landed since the last drain as
        (slot, rec, n_cons, ok, why) tuples.  Raises the exception a
        worker met."""
        out = []
        with self._lock:
            if self._fault is not None:
                fault, self._fault = self._fault, None
                raise fault
            done, self._done = self._done, []
            for key, ok, why in done:
                for item in self._inflight.pop(key, ()):
                    out.append((*item, ok, why))
        return out

    def pending(self) -> int:
        with self._lock:
            return len(self._inflight)

    def shutdown(self) -> None:
        """Wait for the workers.  Apply nothing: whatever verdicts are
        still queued are dropped with the run (speculation is sound without
        them); a worker's exception is raised."""
        self._executor.shutdown(wait=True)
        with self._lock:
            fault, self._fault = self._fault, None
        if fault is not None:
            raise fault


class _Streams:
    """The runner's CUDA streams, a pair on each card of the run (the run's
    device, or a mesh's cards): segments on one, pulls on the other, an
    event recorded behind every segment on each card.  Entering a pair
    makes it the current stream of its card, so a partitioned segment's
    per-card launches, merges and pulls each queue on their own card's
    stream.  On the CPU every method is a no-op."""

    def __init__(self, devices):
        devices = [torch.device(d) for d in devices]
        self.cuda = devices[0].type == "cuda"
        if self.cuda:
            # the leader last: entered last, it is the current device inside
            self.devices = list(dict.fromkeys(devices[1:] + devices[:1]))
            self.segment = {d: torch.cuda.Stream(device=d) for d in self.devices}
            self.copy = {d: torch.cuda.Stream(device=d) for d in self.devices}

    def _enter(self, streams):
        stack = contextlib.ExitStack()
        for d in self.devices:
            stack.enter_context(torch.cuda.stream(streams[d]))
        return stack

    def dispatching(self):
        """Queue on the segment streams, after everything each card's
        current stream has queued (the tables, the arena, a sync point's
        arena rows)."""
        if not self.cuda:
            return contextlib.nullcontext()
        for d in self.devices:
            self.segment[d].wait_stream(torch.cuda.current_stream(d))
        return self._enter(self.segment)

    def mark(self):
        """Events right behind the segment just queued, one per card."""
        if not self.cuda:
            return None
        events = {}
        for d in self.devices:
            events[d] = torch.cuda.Event()
            events[d].record(self.segment[d])
        return events

    def pulling(self, events):
        """Read on the copy streams once the segment behind ``events`` is
        done on each card (not the one chained after it)."""
        if not self.cuda:
            return contextlib.nullcontext()
        for d in self.devices:
            self.copy[d].wait_event(events[d])
        return self._enter(self.copy)

    def settle(self) -> None:
        """Each card's current stream after its copy stream's last pull and
        its segment stream's last work: what it queues next (a sync point's
        in-place arena write, the final coverage read) is ordered after
        them."""
        if self.cuda:
            for d in self.devices:
                current = torch.cuda.current_stream(d)
                current.wait_stream(self.copy[d])
                current.wait_stream(self.segment[d])


class PipelinedRunner:
    """Drives engine._run's segment loop in pipelined (chained) form.

    Constructed by engine._run with the run's prepared state; mutates the
    shared mirrors/records in place and reports the loop outcome via
    attributes (executed, max_live, slow_bailed, width_verdict_valid,
    visited, arena_len)."""

    def __init__(self, engine, *, st, records, walker, arena, ev_seen,
                 seeds, lasers, ctxs, seed_code_idx, mid_enc,
                 seed_queue, statics, beam, tables, table_code, table_idx,
                 table_hash, segment, code_dev, cfg, dev_arena, arena_len, visited,
                 deadline, program_key, program_warm, mesh=None,
                 repack_fn=None):
        self.engine = engine
        self.caps = engine.caps
        self.device = engine.device
        self.st = st
        self.records = records
        self.walker = walker
        self.arena = arena
        self.ev_seen = ev_seen
        self.seeds = seeds
        self.lasers = lasers
        self.ctxs = ctxs
        self.seed_code_idx = seed_code_idx
        self.mid_enc = mid_enc
        self.seed_queue = seed_queue
        self.statics = statics
        self.beam = beam
        self.tables = tables
        self.table_code = table_code
        self.table_idx = table_idx
        self.table_hash = table_hash
        self.segment = segment
        self.code_dev = code_dev
        self.cfg = cfg
        self.dev_arena = dev_arena
        self.arena_len = arena_len
        self.visited = visited
        self.deadline = deadline
        self.program_key = program_key
        self.program_warm = program_warm
        # packed-code paging: engine callback that folds pending window
        # moves into fresh same-shape tables.  Called ONLY at sync points
        # (no dispatch in flight), the one place swapping code_dev cannot
        # race a chained dispatch that already captured the old tables.
        self.repack_fn = repack_fn

        # pod composition: with a mesh the slot batch is path-sharded (shard
        # k is slot block k, on the mesh's k-th device) and every dispatch is
        # the partitioned segment over the blocks.
        self.mesh = mesh
        self.n_shards = 1
        if mesh is not None:
            from mythril_tpu_torch.parallel.mesh import PATH_AXIS

            self.n_shards = int(mesh.shape[PATH_AXIS])
            _get_metrics().gauge("pipeline.mesh_shards").set(self.n_shards)
        self._rebalance_backoff = 0

        self.ledger = CorrectionLedger(self.caps.B)
        self.pool = FeasibilityPool(args.solver_workers, self.device)
        # a partitioned mesh's blocks live on its cards (``mesh_devices``);
        # logical shards of one device keep theirs beside each other there
        self.shard_devices = mesh.path_devices if mesh is not None else [self.device]
        self.streams = _Streams(self.shard_devices)
        self.reinject_q: List[tuple] = []
        # adaptive park pool: re-runnable spills the reinject queue could
        # not hold.  The controller's plan names which to resurrect when
        # arena slots free; anything still pooled at run end flushes back
        # to its host work list (exactly-once: a pooled carrier is never
        # simultaneously on a work list or in a slot)
        self.adaptive_parked: List[tuple] = []

        self.executed = 0
        self.max_live = 0
        self.slow_bailed = False
        self.width_verdict_valid = True

        # trace correlation: every dispatch (full or chained) gets a
        # monotonic segment id that its pull, harvest, replay and
        # feasibility spans all carry, plus a flow id linking the dispatch
        # slice to the host work it produced (s at dispatch, t at pull,
        # f at harvest)
        self.seg_uid = -1
        self.current_sid = -1  # sid of the segment being harvested
        self._seg_flow: Dict[int, int] = {}
        self._last_dispatch_sid = -1
        self._full_args = None  # the last full dispatch's inputs (microbench)

    def _begin_dispatch(self) -> int:
        self.seg_uid += 1
        sid = self.seg_uid
        self._last_dispatch_sid = sid
        tracer = _otrace.get_tracer()
        if tracer.enabled:
            self._seg_flow[sid] = tracer.new_flow_id()
        return sid

    # -- queue depths --------------------------------------------------

    def _heartbeat_sample(self) -> dict:
        """Queue depths for the heartbeat sampler.  Runs on the sampler
        thread against concurrently-mutated state: values are snapshots of
        host-side lengths and masks, and the sampler tolerates a transient
        race throwing."""
        B = self.caps.B
        live, free = self._slot_masks()
        sample = {
            "pipeline.pool_queue_depth": self.pool.pending(),
            "pipeline.ledger_pending_corrections": int(
                self.ledger.corr_mask.sum()
            ),
            "pipeline.reinject_queue_depth": len(self.reinject_q),
            "pipeline.seed_queue_depth": len(self.seed_queue),
            "frontier.arena_occupancy": int(self.arena.length),
            "frontier.live_paths": int(live.sum()),
        }
        n_sh = self.n_shards
        if n_sh >= 1 and B % max(n_sh, 1) == 0:
            sz = B // n_sh
            sample["pipeline.free_slots_by_shard"] = {
                f"shard{i}": int(free[i * sz:(i + 1) * sz].sum())
                for i in range(n_sh)
            }
            sample["pipeline.live_slots_by_shard"] = {
                f"shard{i}": int(live[i * sz:(i + 1) * sz].sum())
                for i in range(n_sh)
            }
        return sample

    # -- walker park sink: catch re-runnable spills ---------------------

    def _park_sink(self, laser, rec, carrier, snap) -> bool:
        """Batch-full spills are perfectly re-runnable device states; queue
        them for re-injection at the next sync point instead of bouncing
        them to the host work list.  Semantic parks (the device provably
        cannot execute the instruction) always go to the host."""
        if snap.get("semantic_park"):
            return False
        from mythril_tpu_torch.frontier.engine import _mid_eligible

        if len(self.reinject_q) >= 2 * self.caps.B:
            # queue full: these spills are exactly the "budget" parks the
            # adaptive plan resurrects when slots free — pool them
            # (bounded) instead of bouncing to the host work list
            if self._adaptive_enabled() and \
                    len(self.adaptive_parked) < 4 * self.caps.B \
                    and _mid_eligible(carrier):
                self.adaptive_parked.append((laser, carrier))
                count("adaptive_parked")
                return True
            return False
        if not _mid_eligible(carrier):
            return False
        self.reinject_q.append((laser, carrier))
        count("reinject_queued")
        return True

    # -- speculative verdicts ------------------------------------------

    def apply_verdicts(self) -> None:
        from mythril_tpu_torch.observability.exploration import (
            VERDICT_CLASS,
            get_exploration_ledger,
        )

        st, records = self.st, self.records
        led = get_exploration_ledger()
        for slot, rec, n_cons, ok, why in self.pool.drain():
            if ok:
                if records[slot] is rec:
                    rec._pruned_at = max(rec._pruned_at, n_cons)
                continue
            # UNSAT: roll back the speculatively-running path and every
            # descendant it forked while the verdict was pending.  A path
            # that already finished replayed its events, but its issues
            # (if any) fail their own confirmation query — soundness does
            # not depend on this rollback, only slot recycling does.
            cls = VERDICT_CLASS.get(why, "solver_unsat")
            for s in range(self.caps.B):
                r = records[s]
                node = r
                while node is not None and node is not rec:
                    node = node.parent
                if node is rec and r is not None:
                    records[s] = None
                    clear_slot(st, s)
                    self.ev_seen[s] = 0
                    self.ledger.touch(s)
                    count("pool_unsat_rollbacks")
                    if r.term_class is None:
                        r.term_class = cls
                        led.stamp(cls)

    def clear_orphans(self) -> None:
        """Device-occupied slots with no host record are descendants of
        paths killed while a segment was in flight: the fork event that
        would have created their record was skipped (dead parent)."""
        st, records = self.st, self.records
        for slot in range(self.caps.B):
            if records[slot] is not None:
                continue
            if self.ledger.active_at[slot] > self.ledger.pulled:
                continue  # host-authoritative row, host knows it is free
            if int(st.seed[slot]) >= 0:
                clear_slot(st, slot)
                self.ev_seen[slot] = 0
                self.ledger.touch(slot)
                count("orphan_rollbacks")

    # -- refill ---------------------------------------------------------

    def _slot_masks(self):
        """([B] live, [B] free) numpy masks of the host's current view:
        live = running record present, free = host-reclaimable."""
        B = self.caps.B
        rec = np.fromiter(
            (self.records[s] is not None for s in range(B)), bool, B
        )
        seed = np.asarray(self.st.seed)
        live = rec & (np.asarray(self.st.halt) == O.H_RUNNING) & (seed >= 0)
        free = ~rec & ~self.ledger.device_owned & (seed < 0)
        return live, free

    def _free_slot(self) -> Optional[int]:
        """Next injection target among the host-reclaimable slots (no
        record, not device-owned, no seed on the device).  Single-device:
        the first (the pre-pod scan).  Mesh: a free slot on the least-loaded
        shard, so injections spread over the pod instead of packing shard
        0."""
        live, free = self._slot_masks()
        return choose_free_slot(free, live, self.n_shards)

    def refill(self) -> None:
        """Queued seeds into host-reclaimable free slots.  Unlike the
        synchronous loop, beam scores of LIVE slots are not refreshed:
        uploading onto a device-advanced slot would clobber it.  Seed
        order follows the adaptive plan's deficit scheduler (FIFO with one
        code or --no-adaptive)."""
        from mythril_tpu_torch.frontier.engine import (
            _adaptive_pick,
            _beam_importance,
        )

        eng = self.engine
        while self.seed_queue:
            slot = self._free_slot()
            if slot is None:
                break
            si = self.seed_queue.pop(
                _adaptive_pick(self.seed_queue, self.seed_code_idx,
                               self.table_hash)
            )
            eng._inject(self.st, slot, si, self.ctxs[si],
                        self.seed_code_idx[si],
                        _beam_importance(self.seeds[si]) if self.beam else 0,
                        static=self.statics[si])
            if self.mid_enc[si] is not None:
                with _otrace.span("frontier.mid_inject", cat="frontier",
                                  seed=si):
                    eng._apply_mid(self.st, slot, self.mid_enc[si])
                FrontierStatistics().count("mid_injections")
            self.records[slot] = PathRecord(seed_idx=si)
            self.ev_seen[slot] = 0
            self.ledger.touch(slot)

    # -- adaptive steering ---------------------------------------------

    @staticmethod
    def _adaptive_enabled() -> bool:
        return bool(getattr(args, "adaptive", True))

    def _adaptive_requeue(self) -> None:
        """Resurrect pooled spills when arena slots free (sync point
        only: the moved carriers ride the ordinary ``_reinject`` path, so
        arena appends and ledger touches stay inside the existing
        exactly-once protocol).  The plan picks which parked paths earn
        their slot back; the rest stay pooled."""
        if not self.adaptive_parked or not self._adaptive_enabled():
            return
        _live, free = self._slot_masks()
        room = int(free.sum()) - len(self.reinject_q) - len(self.seed_queue)
        if room <= 0:
            return
        try:
            from mythril_tpu_torch.adaptive import get_adaptive_controller

            parked = [
                (id(carrier), "budget_exhausted")
                for _, carrier in self.adaptive_parked
            ]
            picked = set(get_adaptive_controller().select_requeue(
                parked, live=(), limit=room
            ))
        except Exception:  # steering must never break a dispatch
            log.debug("adaptive requeue failed", exc_info=True)
            return
        if not picked:
            return
        keep: List[tuple] = []
        cap = 2 * self.caps.B
        for laser, carrier in self.adaptive_parked:
            if id(carrier) in picked and len(self.reinject_q) < cap:
                self.reinject_q.append((laser, carrier))
            else:
                keep.append((laser, carrier))
        self.adaptive_parked = keep

    def _adaptive_coverage_stop(self) -> bool:
        from mythril_tpu_torch.frontier.engine import _adaptive_coverage_stop

        return _adaptive_coverage_stop()

    # -- sync-point spill re-injection ---------------------------------

    def _reinject(self) -> bool:
        """Encode queued spills back into free slots.  ONLY at a sync
        point: seed-context/mid encoding appends host arena rows, which an
        in-flight segment would race at the same indices.  Returns True
        when device arena rows were appended (the next dispatch must use
        the refreshed arena)."""
        from mythril_tpu_torch.frontier.engine import _beam_importance
        from mythril_tpu_torch.frontier.step import push_arena_rows

        eng, arena = self.engine, self.arena
        old_len = arena.length
        q, self.reinject_q = self.reinject_q, []
        for laser, carrier in q:
            slot = self._free_slot()
            ci = self.table_idx.get((id(laser), id(carrier.environment.code)))
            if slot is None or ci is None:
                laser.work_list.append(carrier)
                continue
            try:
                si = len(self.seeds)
                ctx = eng._seed_ctx(arena, carrier, si)
                enc = eng._encode_mid(arena, carrier)
            except MemoryError:
                laser.work_list.append(carrier)
                continue
            if enc is None:
                # stamp like a bounced seed so _mid_eligible stops
                # re-offering the state at this pc
                carrier._frontier_park_pc = carrier.mstate.pc
                laser.work_list.append(carrier)
                continue
            self.walker.add_seed(laser, self.tables[ci], carrier)
            self.ctxs.append(ctx)
            self.seed_code_idx.append(ci)
            self.mid_enc.append(enc)
            self.statics.append(
                1 if getattr(carrier.environment, "static", False) else 0
            )
            eng._inject(self.st, slot, si, ctx, ci,
                        _beam_importance(carrier) if self.beam else 0,
                        static=self.statics[-1])
            eng._apply_mid(self.st, slot, enc)
            FrontierStatistics().count("mid_injections")
            self.records[slot] = PathRecord(seed_idx=si)
            self.ev_seen[slot] = 0
            self.ledger.touch(slot)
            count("reinjected")
        if arena.length > old_len:
            # in place on the caller's stream, after the last pull
            # (settle) and before the next dispatch (which waits for it)
            self.streams.settle()
            self.dev_arena = push_arena_rows(
                self.dev_arena, arena, old_len, arena.length
            )
            self.arena_len = arena.length
            return True
        return False

    def _flush_reinject_queue(self) -> None:
        for laser, carrier in self.reinject_q:
            laser.work_list.append(carrier)
        self.reinject_q = []
        self._flush_adaptive_pool()

    def _flush_adaptive_pool(self) -> None:
        for laser, carrier in self.adaptive_parked:
            laser.work_list.append(carrier)
        self.adaptive_parked = []

    def _rebalance(self) -> bool:
        """Sync-point live-slot rebalance across path-shards.

        Spills the hottest shard's youngest live paths through the ordinary
        batch-full park flow — snapshot, forced ``H_PARK``, walker replay +
        commit — so they land in ``reinject_q`` via the park sink and are
        re-injected (same sync point) into the coolest shards' free slots.
        Every spill and re-injection goes through ``ledger.touch``, so the
        exactly-once correction protocol is preserved.  A replay or commit
        that raises costs only its path (logged), as in the JAX package; a
        device fault (``is_device_fault``) reaches the caller.  Returns True
        when any slot moved."""
        from mythril_tpu_torch.frontier.records import snapshot_slot

        live, free = self._slot_masks()
        moves = plan_rebalance(live, free, self.n_shards)
        if not moves:
            return False
        stats = FrontierStatistics()
        for src in moves:
            rec = self.records[src]
            rec.final = snapshot_slot(self.st, src)
            rec.final["halt"] = O.H_PARK
            stats.count("device_paths")
            stats.record_bulk_park("rebalance")
            try:
                self.walker.replay(rec)
                self.walker.commit(rec)
            except Exception as e:
                if is_device_fault(e):
                    raise
                log.warning(
                    "frontier rebalance failed on a path: %s", e,
                    exc_info=True,
                )
            self.records[src] = None
            clear_slot(self.st, src)
            self.ev_seen[src] = 0
            self.ledger.touch(src)
            count("rebalanced_slots")
        return True

    # -- the loop -------------------------------------------------------

    def _ramped_cfg(self):
        caps = self.caps
        return self.cfg._replace(
            k_limit=min(caps.K, 96 << min(FrontierStatistics().segments, 4))
        )

    def _dispatch_full(self):
        """Full push of the host mirror (dispatch 0 and sync points), on the
        segment stream.  -> (outputs, the
        event behind the segment).  The segment's device time is stamped on
        the segment stream; the bucket's first dispatch harvests the
        allocator's peak."""
        from mythril_tpu_torch.frontier.step import push_state

        sid = self._begin_dispatch()
        cfg = self._ramped_cfg()
        with _otrace.span("frontier.dispatch", cat="device", segment=sid,
                          full=True, shards=self.n_shards):
            self._emit_dispatch_flow(sid)
            with self.streams.dispatching():
                st_dev = push_state(self.st, device=self.device,
                                    devices=self.shard_devices if self.mesh is not None
                                    else None)
                self.ledger.consume_all()
                # every free slot is exposed to the device again
                for slot in range(self.caps.B):
                    self.ledger.device_owned[slot] = self.records[slot] is None
                self._full_args = (st_dev, self.dev_arena, self.arena_len,
                                   self.visited, self.code_dev, cfg)
                with _devplane.harvest_analysis(self.device,
                                                _devplane.current_bucket()):
                    stamp = _devplane.stamp_begin(self.shard_devices)
                    out = self.segment(*self._full_args)
                    _devplane.stamp_end(stamp, "frontier.segment_device_s")
                event = self.streams.mark()
        return out, event

    def _chain(self, inflight):
        """The next segment chained on ``inflight``'s outputs, on the
        segment stream; the host reads no device value.  -> (outputs, the
        event behind the segment)."""
        from mythril_tpu_torch.frontier.step import chain_dispatch

        sid = self._begin_dispatch()
        cfg = self._ramped_cfg()
        with _otrace.span("frontier.dispatch", cat="device", segment=sid,
                          chained=True, shards=self.n_shards):
            self._emit_dispatch_flow(sid)
            with self.streams.dispatching():
                mask = self.ledger.consume(self.st.seed)
                out = chain_dispatch(self.segment, inflight, self.st, mask,
                                     self.code_dev, cfg,
                                     segment_id=sid)
                event = self.streams.mark()
        count("segments_pipelined")
        return out, event

    def _emit_dispatch_flow(self, sid: int) -> None:
        fid = self._seg_flow.get(sid)
        if fid is not None:
            _otrace.get_tracer().flow("s", fid, "flow.segment", cat="device")

    def run(self) -> None:
        from mythril_tpu_torch.frontier import engine as _eng
        from mythril_tpu_torch.frontier.step import pull_harvest

        eng, caps = self.engine, self.caps
        stats = FrontierStatistics()
        reg = _get_metrics()
        self.walker.park_sink = self._park_sink
        narrow_harvests = 0
        run_segments = 0
        stop: Optional[str] = None
        # microbench timings are single-device figures; skip it on a mesh
        # (the synchronous loop applies the same gate)
        micro_pending = bool(args.frontier_microbench and not stats.microbench
                             and self.mesh is None)

        hb = get_heartbeat()
        hb.register("pipeline", self._heartbeat_sample)
        hb_started = False
        if not hb.running:
            # CLI runs with --heartbeat-out arm the sampler up front; any
            # other pipelined run (facade embedding, bench) starts it here
            # so pool/ledger depth gauges are sampled, not set-on-mutation
            hb.start(period_s=args.heartbeat_interval, out_path=args.heartbeat_out)
            hb_started = True

        # device plane: tag this thread's dispatches and pulls (and any
        # kernel build they trigger) with the program's bucket shape for
        # the duration of the run; restored in the finally below
        _devplane.install()
        _bucket_tag = _devplane.bucket_tag(self.program_key[1])
        _dscope = _devplane.dispatch_scope(_bucket_tag)
        _dscope.__enter__()

        t0 = time.perf_counter()
        inflight, inflight_event = self._dispatch_full()
        inflight_sid = self._last_dispatch_sid
        full_args = self._full_args
        dispatch_wall = time.perf_counter() - t0
        prev_st = self.st
        # while any dispatch is in flight the device owns the arena append
        # indices; host encode paths must not race them (arena.freeze)
        self.arena.freeze()
        watch = _frec.activity()
        watch.__enter__()
        try:
            while True:
                deadline_hit = (time.perf_counter() > self.deadline
                                or time_handler.time_remaining() <= 0)
                # chain the next dispatch BEFORE blocking on the current
                # one, unless this iteration must end at a sync point
                free_owned = bool(
                    (self.ledger.device_owned
                     & np.fromiter((self.records[s] is None
                                    for s in range(caps.B)), bool, caps.B)
                     ).any()
                )
                want_sync = bool(
                    micro_pending or self.reinject_q
                    or (self.seed_queue and free_owned)
                    or (self.adaptive_parked and free_owned)
                )
                if (not want_sync and self.n_shards > 1
                        and stop is None and not deadline_hit):
                    # pod imbalance: force a sync point so _rebalance can
                    # spill/re-inject; backoff avoids syncing every segment
                    # when the imbalance is not fixable (e.g. no free slots)
                    if self._rebalance_backoff > 0:
                        self._rebalance_backoff -= 1
                    else:
                        live_m, free_m = self._slot_masks()
                        if plan_rebalance(live_m, free_m, self.n_shards):
                            want_sync = True
                            count("rebalance_syncs")
                nxt = None
                nxt_event = None
                nxt_sid = -1
                nxt_wall = 0.0
                if stop is None and not deadline_hit and not want_sync:
                    t_d = time.perf_counter()
                    nxt, nxt_event = self._chain(inflight)
                    nxt_sid = self._last_dispatch_sid
                    nxt_wall = time.perf_counter() - t_d

                # ---- pull: the pipeline's only blocking point, on the
                # copy stream once the in-flight segment (not nxt) is done
                (out_state, out_arena, out_len, n_exec, seg_ml,
                 out_visited) = inflight
                t_pull = time.perf_counter()
                _req_tags = getattr(self.engine, "request_tags", None)
                with self.streams.pulling(inflight_event):
                    with _otrace.span(
                        "frontier.segment", cat="device", segment=inflight_sid,
                        warm=self.program_warm, pipelined=True,
                        **({"requests": ",".join(_req_tags)}
                           if _req_tags else {}),
                    ), _otrace.device_annotation("frontier.segment"):
                        _fid = self._seg_flow.get(inflight_sid)
                        if _fid is not None:
                            _otrace.get_tracer().flow(
                                "t", _fid, "flow.segment", cat="device"
                            )
                        self.engine._fire_request_flows()
                        # steady state (next dispatch chained): delta pull
                        # — the [B] scalar plane + dirty rows/events only; a
                        # sync point follows otherwise and _dispatch_full
                        # pushes the whole mirror, so pull everything
                        new_st, arena_len_new, n_exec_host, seg_ml_host = (
                            pull_harvest(
                                out_state, out_len, n_exec, seg_ml,
                                prev=prev_st if nxt is not None else None,
                                shards=self.n_shards,
                            )
                        )
                    bubble = time.perf_counter() - t_pull
                    self.arena.pull_from_device(out_arena, arena_len_new)
                self.max_live = max(self.max_live, seg_ml_host)
                self.arena_len = arena_len_new
                self.dev_arena = out_arena
                self.visited = out_visited
                self.executed += n_exec_host
                stats.count("device_instructions", n_exec_host)
                stats.count("segments")
                # host-visible device cost of this segment: its dispatch
                # call plus the time the host actually waited on it — the
                # harvest that overlapped it is NOT device time
                seg_equiv = dispatch_wall + bubble
                stats.count("segment_s", seg_equiv)
                reg.observe("frontier.segment_wall_s", seg_equiv)
                count("bubble_s", bubble)
                if nxt is not None:
                    count("overlap_segments")
                _eng._WARM_PROGRAMS.add(self.program_key)

                if micro_pending and n_exec_host > 0:
                    t_mb = time.perf_counter()
                    with self.streams.dispatching():
                        eng._run_microbench(
                            self.segment, full_args, n_exec_host, new_st
                        )
                    self.deadline += time.perf_counter() - t_mb
                    micro_pending = False

                # ---- harvest (overlaps the in-flight nxt segment)
                carried = self.ledger.carry_forward(new_st, prev_st)
                if carried:
                    count("carried_slots", carried)
                self.st = new_st
                prev_st = new_st
                if nxt is None:
                    self.ledger.release_owned()
                _frec.beat()  # a segment retired: push the watchdog out
                t_har = time.perf_counter()
                self.apply_verdicts()
                self.current_sid = inflight_sid
                with _otrace.span("frontier.harvest", cat="frontier",
                                  segment=inflight_sid):
                    _fid = self._seg_flow.pop(inflight_sid, None)
                    if _fid is not None:
                        _otrace.get_tracer().flow(
                            "f", _fid, "flow.segment", cat="device"
                        )
                    eng._harvest(self.st, self.records, self.walker,
                                 self.ev_seen, pipe=self)
                self.clear_orphans()
                for slot in range(caps.B):
                    if self.records[slot] is not None:
                        self.ledger.device_owned[slot] = False
                self.ev_seen.fill(0)
                har_only = time.perf_counter() - t_har
                stats.count("harvest_s", har_only)
                reg.observe("frontier.harvest_wall_s", har_only)
                if nxt is not None:
                    count("overlap_s", har_only)

                # ---- slow-bail accounting on the host-visible wall
                bail_now = False
                if ((run_segments > 0 or self.program_warm)
                        and not args.frontier_force):
                    host_rates = [
                        r for r in (
                            getattr(laser, "host_step_rate", lambda: None)()
                            for laser in self.lasers
                        ) if r
                    ]
                    bail_rate = (
                        _eng._SLOW_BAIL_HOST_FACTOR * min(host_rates)
                        if host_rates else _eng._SLOW_BAIL_FLOOR
                    )
                    code_keys = [_eng._code_key(c) for c in self.table_code]
                    seg_rate = n_exec_host / max(seg_equiv, 1e-6)
                    if seg_rate < bail_rate:
                        counts = [
                            _eng._SLOW_SEGMENTS.get(k, 0) + 1
                            for k in code_keys
                        ]
                        for k, c in zip(code_keys, counts):
                            _eng._SLOW_SEGMENTS[k] = c
                        if (max(counts) >= _eng._SLOW_BAIL_SEGMENTS
                                or seg_rate
                                < _eng._SLOW_BAIL_DECISIVE * bail_rate):
                            log.info(
                                "frontier: %d instructions in %.2fs (below "
                                "%.0f/s); host engine takes over",
                                n_exec_host, seg_equiv, bail_rate,
                            )
                            bail_now = True
                    else:
                        for k in code_keys:
                            _eng._SLOW_SEGMENTS.pop(k, None)
                run_segments += 1

                if stop is None:
                    self.refill()
                live = int(((self.st.halt == O.H_RUNNING)
                            & (self.st.seed >= 0)).sum())
                self.max_live = max(self.max_live, live)

                # ---- exit decisions (first verdict wins; a later drain
                # iteration must not overwrite it)
                if stop is None:
                    if deadline_hit:
                        log.info(
                            "frontier: execution timeout; parking live paths"
                        )
                        stop = "timeout"
                    elif bail_now:
                        stop = "slow-bail"
                    elif self._adaptive_coverage_stop():
                        log.info(
                            "frontier: coverage target reached; "
                            "parking live paths"
                        )
                        stop = "coverage-target"
                    elif (live == 0 and not self.seed_queue
                          and not self.reinject_q
                          and not self.adaptive_parked):
                        stop = "done"
                    elif (self.arena_len + max(live, 1) * caps.R * 4
                          >= caps.ARENA):
                        # double the synchronous margin: up to two segments
                        # of appends can be in flight before the next check
                        log.warning(
                            "frontier: arena nearly full; parking live paths"
                        )
                        stop = "arena-full"
                    elif live < caps.MIN_LIVE:
                        narrow_harvests += 1
                        if narrow_harvests >= caps.NARROW_BAIL:
                            log.info(
                                "frontier: only %d live paths after %d "
                                "segments; host engine takes over",
                                live, narrow_harvests,
                            )
                            stop = "narrow-bail"
                    else:
                        narrow_harvests = 0

                if nxt is not None:
                    inflight, inflight_event = nxt, nxt_event
                    inflight_sid = nxt_sid
                    dispatch_wall = nxt_wall
                    continue
                # sync point: no dispatch in flight anywhere
                if stop is not None:
                    break
                self.ledger.release_owned()
                self.arena.thaw()
                if self.n_shards > 1:
                    moved = self._rebalance()
                    self._rebalance_backoff = 0 if moved else 2
                self._adaptive_requeue()
                if (self.adaptive_parked and not self.reinject_q
                        and not self.seed_queue):
                    live_now, _ = self._slot_masks()
                    if not live_now.any():
                        # nothing else runs and the plan declined the
                        # pooled spills: hand them to the host engine
                        # rather than spin on empty segments
                        self._flush_adaptive_pool()
                if self.repack_fn is not None:
                    # fold pending page-window moves in BEFORE re-injection
                    # so faulted carriers resume against tables whose
                    # resident window now covers their pc
                    new_cd = self.repack_fn()
                    if new_cd is not None:
                        self.code_dev = new_cd
                if self.reinject_q:
                    self._reinject()
                self.refill()
                t0 = time.perf_counter()
                inflight, inflight_event = self._dispatch_full()
                inflight_sid = self._last_dispatch_sid
                full_args = self._full_args
                dispatch_wall = time.perf_counter() - t0
                self.arena.freeze()
        finally:
            _dscope.__exit__(None, None, None)
            watch.__exit__(None, None, None)
            self.arena.thaw()
            self.walker.park_sink = None
            self._flush_reinject_queue()
            # whatever the caller's stream reads next (the coverage planes)
            # comes after the runner's last segment and pull
            self.streams.settle()
            # an abandoned dispatch (exception before its pull) would leave
            # a started flow with no finish; close it so every "s" in the
            # export has its "f"
            if self._seg_flow:
                tracer = _otrace.get_tracer()
                for sid, fid in self._seg_flow.items():
                    with tracer.span("frontier.dispatch.abandoned",
                                     cat="device", segment=sid):
                        tracer.flow("f", fid, "flow.segment", cat="device")
                self._seg_flow.clear()
            hb.unregister("pipeline")
            if hb_started:
                hb.stop()
            overlap = reg.counter("pipeline.overlap_s").value
            total_har = overlap + reg.counter("pipeline.bubble_s").value
            if total_har > 0:
                reg.gauge("pipeline.overlap_ratio").set(
                    round(overlap / total_har, 4)
                )
            # the microbench ran at a sync point (full pull), so its
            # bytes_pulled estimate is the full-state figure; overwrite it
            # with the measured steady-state delta-pull average
            mb = stats.microbench
            pulls = reg.counter("pipeline.delta_pulls").value
            if mb and pulls:
                mb = dict(mb)
                mb["bytes_pulled_meta_per_segment"] = int(
                    reg.counter("pipeline.delta_pull_bytes").value / pulls
                )
                mb["delta_pull_segments"] = int(pulls)
                stats.microbench = mb
            # last: raises a feasibility worker's exception
            self.pool.shutdown()

        if stop == "slow-bail":
            self.slow_bailed = True
        if stop in ("timeout", "slow-bail", "arena-full", "coverage-target"):
            self.width_verdict_valid = False
        live = int(((self.st.halt == O.H_RUNNING)
                    & (self.st.seed >= 0)).sum())
        if stop != "done" or live > 0:
            eng._park_all(self.st, self.records, self.walker,
                          reason=stop or "drain")
