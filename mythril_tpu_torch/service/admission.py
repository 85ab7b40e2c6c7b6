"""Admission control: dedup by canonical identity, batch by options.

The controller owns three maps, all keyed by ``(codehash,
options_key)``:

* ``pending`` — flights waiting for a batch slot (FIFO by first
  submission time; interactive flights jump the line),
* ``running`` — flights the worker has admitted into the current batch,
* ``results`` — a bounded log of completed flights for instant replay.

A duplicate submission never re-analyzes: it subscribes to the pending
or running flight (replay-then-live ordering under the flight lock) or
replays a completed result — from the in-memory log, or (when a
``ResultStore`` is attached) from the cross-process completed-result
LRU shared by every daemon/worker under one ``--cache-root``.
``next_batch`` hands the worker the highest-priority compatible group —
all admitted flights share one options key, because the cooperative
sweep runs one configuration per batch.  An optional
``SchedulerPolicy`` adds tenant quotas, batch-tier load shedding, and
priority aging on top of the base interactive-jumps-the-line rule.

Every mutation is guarded by one controller lock; flight event fan-out
is guarded by the per-flight lock so replay and live emission cannot
interleave.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from mythril_tpu_torch.observability.metrics import get_registry
from mythril_tpu_torch.service.request import AnalysisRequest, ResultStream
from mythril_tpu_torch.service.scheduling import AdmissionRejected, SchedulerPolicy

log = logging.getLogger(__name__)

__all__ = ["AdmissionController", "Flight"]

Key = Tuple[str, Tuple]


class Flight:
    """One in-progress analysis and its subscribers.

    ``emit`` appends to the event log and fans out to every subscriber;
    ``subscribe`` replays the log into the new stream first — both under
    ``self.lock``, so a late subscriber sees exactly the events an early
    one did, in order, with no loss or duplication at the seam.
    """

    def __init__(self, key: Key, request: AnalysisRequest):
        self.key = key
        self.codehash = request.codehash
        self.options = request.options
        self.tier = request.tier
        self.tenant = request.tenant or "-"
        self.created_at = request.submitted_at
        self.requests: List[AnalysisRequest] = [request]
        self.lock = threading.Lock()
        # long-poll subscribers wait on this for events past their cursor
        self.cond = threading.Condition(self.lock)
        self.events: List[Tuple[str, Any]] = []
        self.streams: List[ResultStream] = []
        self.finished = False
        # first-evidence attribution for the probe-vs-device counters
        self.first_issue_source: Optional[str] = None
        # perf_counter stamp set when next_batch admits the flight, so
        # late dedup subscribers can stamp their own queue-wait boundary
        self.admitted_at: Optional[float] = None

    def subscribe(self, request: AnalysisRequest) -> ResultStream:
        # TTFE clock starts at submission, not subscription: admission
        # stalls ahead of dispatch must burn the watchtower's budget
        stream = ResultStream(request.request_id,
                              created_at=request.submitted_at)
        with self.lock:
            if request not in self.requests:
                self.requests.append(request)
                if request.interactive:
                    self.tier = request.tier  # a dup upgrade counts
                if self.admitted_at is not None:
                    # joined after admission: this request never waited in
                    # the queue — its queue_wait phase ends right here
                    request.stamps.setdefault("admitted", time.perf_counter())
            for kind, payload in self.events:
                stream.push(kind, payload)
            if not self.finished:
                self.streams.append(stream)
        return stream

    def emit(self, kind: str, payload: Any, source: str = "device") -> None:
        with self.lock:
            if self.finished:
                return
            if kind == "issue" and self.first_issue_source is None:
                self.first_issue_source = source
            self.events.append((kind, payload))
            if kind in ResultStream._DONE_KINDS:
                self.finished = True
            for stream in self.streams:
                stream.push(kind, payload)
            if self.finished:
                self.streams.clear()
            self.cond.notify_all()

    def poll(self, cursor: int = 0, wait_s: float = 0.0
             ) -> Tuple[List[Tuple[str, Any]], int, bool]:
        """Long-poll view: events past ``cursor``, blocking up to
        ``wait_s`` for the first new one.  Returns ``(events,
        new_cursor, closed)`` — ``closed`` once the terminal event has
        been delivered at or before ``new_cursor``."""
        deadline = time.perf_counter() + max(wait_s, 0.0)
        with self.lock:
            while True:
                fresh = self.events[cursor:]
                if fresh or self.finished:
                    break
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                self.cond.wait(timeout=remaining)
            new_cursor = cursor + len(fresh)
            closed = self.finished and new_cursor >= len(self.events)
            return list(fresh), new_cursor, closed

    @property
    def interactive(self) -> bool:
        return self.tier == "interactive"


class AdmissionController:
    def __init__(self, result_cache_size: int = 256,
                 policy: Optional[SchedulerPolicy] = None,
                 result_store=None):
        self._lock = threading.Lock()
        self._pending: "OrderedDict[Key, Flight]" = OrderedDict()
        self._running: Dict[Key, Flight] = {}
        self._results: "OrderedDict[Key, List[Tuple[str, Any]]]" = OrderedDict()
        self._result_cache_size = result_cache_size
        self._policy = policy
        #: optional cross-process completed-result LRU (resultstore.py)
        self._store = result_store
        self._arrival = threading.Condition(self._lock)
        reg = get_registry()
        # persistent=True: the worker sweeps analysis-scoped metrics
        # before every batch; service counters must survive that
        self._c_requests = reg.counter("service.requests", persistent=True)
        self._c_dedup = reg.counter("service.dedup_hits", persistent=True)
        self._c_replay = reg.counter("service.replay_hits", persistent=True)
        self._c_admitted = reg.counter("service.admitted", persistent=True)
        self._c_shed = reg.counter("service.shed_total", persistent=True)
        self._c_quota = reg.counter(
            "service.quota_rejections", persistent=True
        )
        self._c_store_hits = reg.counter(
            "service.result_store_hits", persistent=True
        )

    # -- submission side ----------------------------------------------

    def submit(self, request: AnalysisRequest) -> Tuple[ResultStream, bool]:
        """Queue ``request``; returns ``(stream, deduped)``.

        ``deduped`` is True when no new analysis was scheduled — the
        request subscribed to an in-flight twin or replayed a completed
        result (in-memory, or from the cross-process result store).
        Raises ``AdmissionRejected`` when the scheduling policy refuses
        new work (tenant over quota, batch tier shed under load) —
        dedup subscriptions and replays are never refused, they add no
        load.
        """
        key: Key = (request.codehash, request.options.key())
        self._c_requests.inc()
        with self._lock:
            flight = self._pending.get(key) or self._running.get(key)
            if flight is not None:
                self._c_dedup.inc()
                stream = flight.subscribe(request)
                return stream, True
            cached = self._results.get(key)
            if cached is None and self._store is not None:
                # cross-process LRU: a twin completed in another worker
                # process / daemon sharing this cache root
                cached = self._store.get(key)
                if cached is not None:
                    self._c_store_hits.inc()
                    self._results[key] = list(cached)
                    self._trim_results()
            if cached is not None:
                if key in self._results:
                    self._results.move_to_end(key)
                self._c_dedup.inc()
                self._c_replay.inc()
                stream = ResultStream(request.request_id,
                                      created_at=request.submitted_at)
                for kind, payload in cached:
                    stream.push(kind, payload)
                return stream, True
            self._check_policy(request)
            flight = Flight(key, request)
            self._pending[key] = flight
            stream = flight.subscribe(request)
            self._arrival.notify_all()
            return stream, False

    def _check_policy(self, request: AnalysisRequest) -> None:
        """Quota/shed gate for a submission that would create NEW work.
        Caller holds the controller lock."""
        policy = self._policy
        if policy is None:
            return
        if (
            policy.shed_queue_depth
            and not request.interactive
            and len(self._pending) >= policy.shed_queue_depth
        ):
            self._c_shed.inc()
            raise AdmissionRejected(
                f"load shed: {len(self._pending)} flights pending "
                f"(batch tier refused at depth "
                f"{policy.shed_queue_depth}; retry later or submit "
                f"interactive)",
                kind="shed",
            )
        if policy.max_pending_per_tenant:
            tenant = request.tenant or "-"
            held = sum(
                1 for f in self._pending.values() if f.tenant == tenant
            )
            if held >= policy.max_pending_per_tenant:
                self._c_quota.inc()
                raise AdmissionRejected(
                    f"tenant quota: {tenant!r} already holds {held} "
                    f"pending flights (limit "
                    f"{policy.max_pending_per_tenant})",
                    kind="quota",
                )

    # -- worker side ---------------------------------------------------

    def wait_for_pending(self, timeout: Optional[float] = None) -> bool:
        """Block until at least one flight is pending (or timeout)."""
        with self._lock:
            if self._pending:
                return True
            self._arrival.wait(timeout=timeout)
            return bool(self._pending)

    def has_interactive_pending(self) -> bool:
        with self._lock:
            return any(f.interactive for f in self._pending.values())

    def next_batch(self, max_width: int) -> List[Flight]:
        """Admit up to ``max_width`` compatible flights and mark them
        running.

        The anchor is the highest-priority pending flight: interactive
        jumps the line, and (with a policy) batch flights that have
        waited past ``age_priority_s`` are promoted into the same class
        — within a class, FIFO by first submission.  Every other
        admitted flight shares the anchor's options key; the rest stay
        pending for the next batch.
        """
        with self._lock:
            if not self._pending:
                return []
            if self._policy is not None and self._policy.active:
                now = time.time()
                anchor = min(
                    self._pending.values(),
                    key=lambda f: (
                        self._policy.priority_class(
                            f.interactive, f.created_at, now
                        ),
                        f.created_at,
                    ),
                )
            else:
                anchor = next(
                    (f for f in self._pending.values() if f.interactive),
                    next(iter(self._pending.values())),
                )
            opts_key = anchor.key[1]
            batch: List[Flight] = [anchor]
            for key, flight in self._pending.items():
                if flight is anchor or len(batch) >= max_width:
                    continue
                if key[1] == opts_key:
                    batch.append(flight)
            now = time.perf_counter()
            for flight in batch:
                del self._pending[flight.key]
                self._running[flight.key] = flight
                flight.admitted_at = now
                for req in list(flight.requests):
                    req.stamps.setdefault("admitted", now)
            self._c_admitted.inc(len(batch))
            return batch

    def finish(self, flight: Flight, events: Optional[List[Tuple[str, Any]]] = None) -> None:
        """Retire a running flight; cache its event log for replay.

        Error'd flights are NOT cached — a tenant-scoped failure
        (solver timeout, plugin exception) must not poison later
        submissions of the same contract.
        """
        with self._lock:
            self._running.pop(flight.key, None)
            log_ = events if events is not None else flight.events
            if log_ and log_[-1][0] == "done":
                self._results[flight.key] = list(log_)
                self._results.move_to_end(flight.key)
                self._trim_results()
                if self._store is not None:
                    self._store.put(flight.key, list(log_))

    def _trim_results(self) -> None:
        while len(self._results) > self._result_cache_size:
            self._results.popitem(last=False)

    # -- introspection -------------------------------------------------

    def flight_for(self, key: Key) -> Optional[Flight]:
        """The live (pending or running) flight for ``key``, if any —
        the poll registry pins it so long-poll works after retirement."""
        with self._lock:
            return self._pending.get(key) or self._running.get(key)

    def cached_events(self, key: Key) -> List[Tuple[str, Any]]:
        """Snapshot of the replay log for ``key`` (empty when evicted) —
        lets the daemon attribute a replayed issue set to the request
        it just served from cache."""
        with self._lock:
            return list(self._results.get(key) or ())

    def depths(self) -> Dict[str, int]:
        """Heartbeat source payload (sampled, never set on mutation)."""
        with self._lock:
            return {
                "service.queue_depth": len(self._pending),
                "service.inflight": len(self._running),
                "service.result_cache": len(self._results),
            }

    def drain_wait(self, timeout: Optional[float] = None) -> bool:
        """Block until no pending and no running flights remain."""
        deadline = None if timeout is None else time.time() + timeout
        while True:
            with self._lock:
                if not self._pending and not self._running:
                    return True
            if deadline is not None and time.time() > deadline:
                return False
            time.sleep(0.02)
