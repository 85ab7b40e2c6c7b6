"""Low-overhead span tracer with Chrome-trace/Perfetto and JSONL export.

Design constraints, in order:

1. **Near-zero cost when disabled.**  The tracer ships disabled; every
   instrumentation site in the hot path (per-segment, per-SMT-query,
   per-detection-module) does one attribute check and receives a shared
   immutable no-op context manager.  No allocation, no clock read.

2. **Cheap when enabled.**  Spans are recorded as plain tuples into a
   bounded ring buffer under a lock (harvest threads and the host engine
   both emit spans); ``time.perf_counter()`` is the only clock used, so
   NTP steps cannot corrupt durations.

3. **Standard export.**  ``export_chrome_trace()`` writes the Chrome
   ``trace_event`` JSON object format that chrome://tracing and
   https://ui.perfetto.dev load directly: "X" complete events for spans,
   "M" metadata events naming every thread/track that recorded anything,
   "C" counter events for heartbeat samples, and "s"/"f" flow events
   correlating device dispatches with the host work they produced;
   ``export_jsonl()`` writes one flat JSON object per line for ad-hoc
   grep/jq pipelines.

Timestamps are microseconds relative to the tracer's origin (first
construction or last ``reset()``), which is what the trace viewers
expect — they render relative time, not epoch time.
"""

from __future__ import annotations

import functools
import itertools
import json
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

__all__ = [
    "Tracer",
    "get_tracer",
    "span",
    "traced",
    "device_annotation",
]

# Event-phase constants for the ring tuples.  "X" complete events are by
# far the most common; flows and counters ride in the same ring so the
# export stays a single time-ordered pass.
_PH_SPAN = "X"
_PH_INSTANT = "i"
_PH_FLOW_START = "s"
_PH_FLOW_END = "f"
_PH_COUNTER = "C"


class _NullContext:
    """Shared no-op context manager returned when tracing is disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *_exc):
        return False

    def set(self, **_args):  # matches _SpanContext.set
        return self


_NULL_CONTEXT = _NullContext()


class _SpanContext:
    """Context manager recording one complete ("X") span on exit."""

    __slots__ = ("_tracer", "_name", "_cat", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: Optional[dict]):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._args = args

    def set(self, **args) -> "_SpanContext":
        """Attach/override span args from inside the span body."""
        if self._args is None:
            self._args = args
        else:
            self._args.update(args)
        return self

    def __enter__(self) -> "_SpanContext":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *_exc) -> bool:
        t1 = time.perf_counter()
        self._tracer._record(
            self._name, self._cat, self._t0, t1 - self._t0,
            threading.get_ident(), self._args,
        )
        return False


class Tracer:
    """Thread-safe bounded span recorder.

    ``capacity`` bounds memory: once full, the oldest spans are evicted
    and counted in ``dropped`` so exports can report truncation instead
    of silently looking complete.
    """

    def __init__(self, capacity: int = 100_000):
        self.enabled = False
        self.capacity = capacity
        self._lock = threading.Lock()
        self._buf: deque = deque(maxlen=capacity)
        self.dropped = 0
        # monotonically increasing count of everything ever recorded —
        # unlike len(_buf) it survives ring eviction, so flush cursors
        # (observability/fleet.py) can drain exactly-once
        self.total = 0
        self._origin = time.perf_counter()
        # tid -> human name, captured lazily on first record per thread
        # (worker pools name their threads mythril-feas-N etc.), plus
        # synthetic ids for non-thread tracks registered explicitly.
        self._thread_names: Dict[int, str] = {}
        self._track_ids = itertools.count(1)
        self._flow_ids = itertools.count(1)
        # pid -> {"name", "events" (deque of wire tuples with *absolute*
        # perf_counter stamps), "tracks", "dropped"} for span batches
        # folded in from other processes (pool workers)
        self._foreign: Dict[int, Dict[str, Any]] = {}

    # -- recording -----------------------------------------------------

    def span(self, name: str, cat: str = "host", **args):
        """Context manager timing a span; no-op when disabled.

        ::

            with tracer.span("frontier.segment", cat="frontier", k=64):
                dispatch()
        """
        if not self.enabled:
            return _NULL_CONTEXT
        return _SpanContext(self, name, cat, args or None)

    def instant(self, name: str, cat: str = "host", **args) -> None:
        """Record a zero-duration marker event."""
        if not self.enabled:
            return
        t = time.perf_counter()
        self._record(name, cat, t, 0.0, threading.get_ident(), args or None,
                     ph=_PH_INSTANT)

    def new_flow_id(self) -> int:
        """A process-unique id binding one ``s`` event to one ``f`` event."""
        return next(self._flow_ids)

    def flow(self, phase: str, fid: int, name: str, cat: str = "host") -> None:
        """Record one endpoint of a flow arrow (``phase`` is "s" or "f").

        Chrome-trace flow events bind to the enclosing slice on their
        track at their timestamp, so call this *inside* the span the
        arrow should attach to.  Each ``fid`` must see its "s" before
        its "f" in wall-clock order (guaranteed here because the start
        side is always emitted before the work is handed off).
        """
        if not self.enabled:
            return
        t = time.perf_counter()
        self._record(name, cat, t, 0.0, threading.get_ident(), None,
                     ph=phase, fid=fid)

    def flow_at(self, phase: str, fid: int, name: str, cat: str = "host",
                tid: Optional[int] = None, t: Optional[float] = None) -> None:
        """``flow`` with an explicit timestamp and track.

        Post-hoc emission path: the service records a request's flow
        "s" endpoint at terminal time, stamped back inside the request's
        execute window.  Exports order events by ``ts``, so an "s"
        recorded after its "f" but carrying an earlier stamp still
        renders as a forward arrow.  ``t`` is an absolute
        ``time.perf_counter()`` value.
        """
        if not self.enabled:
            return
        self._record(name, cat,
                     t if t is not None else time.perf_counter(), 0.0,
                     tid if tid is not None else threading.get_ident(),
                     None, ph=phase, fid=fid)

    def record_span(self, name: str, cat: str, t0: float, dur: float,
                    tid: Optional[int] = None,
                    args: Optional[dict] = None) -> None:
        """Record a complete span from explicit ``perf_counter`` stamps.

        The live ``span()`` context manager times code as it runs; this
        is the post-hoc form for spans reconstructed from stamps taken
        earlier (the service's per-request phase trees).  ``t0`` must be
        an absolute ``time.perf_counter()`` value from this process so
        it shares the clock domain of every live span.  Span args are an
        explicit dict (not ``**kwargs``) so keys like ``name`` stay
        usable.
        """
        if not self.enabled:
            return
        self._record(name, cat, t0, dur,
                     tid if tid is not None else threading.get_ident(),
                     dict(args) if args else None)

    def counter(self, name: str, values: Dict[str, float], tid: Optional[int] = None) -> None:
        """Record a counter sample ("C" event -> Perfetto counter track)."""
        if not self.enabled:
            return
        t = time.perf_counter()
        self._record(name, "counter", t, 0.0,
                     tid if tid is not None else threading.get_ident(),
                     dict(values), ph=_PH_COUNTER)

    def register_track(self, name: str) -> int:
        """Reserve a synthetic tid rendered as a named track in exports.

        Used for logical tracks that are not OS threads (per-shard
        counter tracks, the heartbeat sampler's queue-depth lanes).
        """
        with self._lock:
            tid = 1_000_000_000 + next(self._track_ids)
            self._thread_names[tid] = name
        return tid

    def _record(self, name, cat, t0, dur, tid, args, ph=_PH_SPAN, fid=None) -> None:
        with self._lock:
            if len(self._buf) == self.capacity:
                self.dropped += 1
            if tid not in self._thread_names:
                cur = threading.current_thread()
                if cur.ident == tid:
                    self._thread_names[tid] = cur.name
            self._buf.append((name, cat, t0 - self._origin, dur, tid, args, ph, fid))
            self.total += 1

    # -- cross-process fabric ------------------------------------------

    def drain_since(self, cursor: int):
        """Events recorded after ``cursor`` (a previous return's first
        element), as wire-format lists with *absolute* ``perf_counter``
        timestamps, plus the track-name map.

        Returns ``(total, events, track_names)``; pass ``total`` back as
        the next cursor.  Absolute stamps keep the batch meaningful in a
        *different* process: ``perf_counter`` is CLOCK_MONOTONIC on
        Linux, one clock domain for every process on the host, so the
        aggregating daemon can rebase against its own origin.  Events
        evicted from the ring between drains are simply lost (already
        counted in ``dropped``).
        """
        with self._lock:
            total = self.total
            new = total - cursor
            if new <= 0:
                return total, [], {}
            raw = list(self._buf)[-min(new, len(self._buf)):]
            names = dict(self._thread_names)
            origin = self._origin
        events = [
            [name, cat, ts + origin, dur, tid, args, ph, fid]
            for name, cat, ts, dur, tid, args, ph, fid in raw
        ]
        return total, events, names

    def ingest_foreign(self, pid: int, process_name: str,
                       events: List[Any],
                       track_names: Optional[Dict[Any, str]] = None) -> None:
        """Fold a ``drain_since`` batch from another process into this
        tracer, keyed by the producer's pid.

        Timestamps stay absolute until export (``chrome_trace`` rebases
        them against this tracer's origin), so a ``reset()`` here cannot
        skew spans recorded remotely.  Each pid's buffer is bounded at
        ``capacity`` with its own drop counter.
        """
        with self._lock:
            entry = self._foreign.get(pid)
            if entry is None:
                entry = self._foreign[pid] = {
                    "name": process_name,
                    "events": deque(maxlen=self.capacity),
                    "tracks": {},
                    "dropped": 0,
                }
            entry["name"] = process_name
            for tid, tname in (track_names or {}).items():
                entry["tracks"][int(tid)] = str(tname)
            buf = entry["events"]
            for ev in events:
                if len(buf) == buf.maxlen:
                    entry["dropped"] += 1
                buf.append(tuple(ev))

    # -- inspection ----------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    def spans(self) -> List[Dict[str, Any]]:
        """Snapshot of recorded spans as dicts (seconds, origin-relative)."""
        with self._lock:
            raw = list(self._buf)
        out = []
        for name, cat, ts, dur, tid, args, ph, fid in raw:
            rec = {
                "name": name,
                "cat": cat,
                "ts": ts,
                "dur": dur,
                "tid": tid,
                **({"args": args} if args else {}),
            }
            if ph != _PH_SPAN:
                rec["ph"] = ph
            if fid is not None:
                rec["flow_id"] = fid
            out.append(rec)
        return out

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            n = len(self._buf)
            foreign = sum(len(e["events"]) for e in self._foreign.values())
            processes = len(self._foreign)
        out = {
            "enabled": self.enabled,
            "spans": n,
            "dropped": self.dropped,
            "capacity": self.capacity,
        }
        if processes:
            out["foreign_spans"] = foreign
            out["foreign_processes"] = processes
        return out

    def thread_names(self) -> Dict[int, str]:
        """Snapshot of tid -> track name seen so far."""
        with self._lock:
            return dict(self._thread_names)

    def reset(self) -> None:
        with self._lock:
            self._buf.clear()
            self.dropped = 0
            self._origin = time.perf_counter()
            self._thread_names.clear()
            self._foreign.clear()

    # -- export --------------------------------------------------------

    def chrome_trace(self) -> Dict[str, Any]:
        """Chrome ``trace_event`` JSON object format (Perfetto-loadable)."""
        import os

        pid = os.getpid()
        with self._lock:
            raw = list(self._buf)
            names = dict(self._thread_names)
            dropped = self.dropped
            origin = self._origin
            foreign = {
                fpid: {
                    "name": entry["name"],
                    "events": list(entry["events"]),
                    "tracks": dict(entry["tracks"]),
                    "dropped": entry["dropped"],
                }
                for fpid, entry in self._foreign.items()
            }

        def _convert(name, cat, rel_ts, dur, tid, args, ph, fid, epid):
            ev = {
                "name": name,
                "cat": cat,
                "ph": ph,
                "ts": round(rel_ts * 1e6, 3),
                "pid": epid,
                "tid": tid,
            }
            if ph == _PH_SPAN:
                ev["dur"] = round(dur * 1e6, 3)
            elif ph == _PH_INSTANT:
                ev["s"] = "t"  # thread-scoped instant
            elif ph == _PH_FLOW_END:
                ev["bp"] = "e"  # bind to enclosing slice, not the next one
            if fid is not None:
                ev["id"] = fid
            if args:
                ev["args"] = args
            return ev

        def _meta(epid, proc_name, seen_tids, tid_names):
            out = [{
                "name": "process_name",
                "ph": "M",
                "pid": epid,
                "tid": 0,
                "args": {"name": proc_name},
            }]
            for tid in sorted(seen_tids | set(tid_names)):
                out.append({
                    "name": "thread_name",
                    "ph": "M",
                    "pid": epid,
                    "tid": tid,
                    "args": {"name": tid_names.get(tid, f"thread-{tid}")},
                })
            return out

        seen_tids = {tid for (_n, _c, _ts, _d, tid, _a, _ph, _f) in raw}
        events: List[Dict[str, Any]] = _meta(pid, "mythril-tpu", seen_tids, names)
        for name, cat, ts, dur, tid, args, ph, fid in raw:
            events.append(_convert(name, cat, ts, dur, tid, args, ph, fid, pid))
        # one process track per pool worker; their stamps are absolute
        # perf_counter values, rebased here against this tracer's origin
        for fpid in sorted(foreign):
            entry = foreign[fpid]
            fseen = {tid for (_n, _c, _ts, _d, tid, _a, _ph, _f)
                     in entry["events"]}
            events.extend(_meta(fpid, entry["name"], fseen, entry["tracks"]))
            for name, cat, abs_ts, dur, tid, args, ph, fid in entry["events"]:
                events.append(_convert(name, cat, abs_ts - origin, dur, tid,
                                       args, ph, fid, fpid))
            dropped += entry["dropped"]
        if dropped:
            # Visible marker so a truncated timeline cannot be mistaken
            # for a complete one (otherData is easy to miss in viewers).
            last_ts = max((e["ts"] for e in events if "ts" in e), default=0.0)
            events.append({
                "name": f"tracer.dropped={dropped}",
                "cat": "tracer",
                "ph": "i",
                "s": "g",  # global-scoped: full-height line in the viewer
                "ts": last_ts,
                "pid": pid,
                "tid": 0,
                "args": {"dropped_spans": dropped, "capacity": self.capacity},
            })
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "producer": "mythril_tpu_torch.observability",
                "dropped_spans": dropped,
            },
        }

    def export_chrome_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)

    def export_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for rec in self.spans():
                f.write(json.dumps(rec) + "\n")


_tracer = Tracer()


def get_tracer() -> Tracer:
    return _tracer


def span(name: str, cat: str = "host", **args):
    """Module-level shorthand for ``get_tracer().span(...)``."""
    if not _tracer.enabled:
        return _NULL_CONTEXT
    return _SpanContext(_tracer, name, cat, args or None)


def traced(name: Optional[str] = None, cat: str = "host") -> Callable:
    """Decorator form: time every call of the wrapped function as a span."""

    def deco(fn: Callable) -> Callable:
        span_name = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            if not _tracer.enabled:
                return fn(*a, **kw)
            with _SpanContext(_tracer, span_name, cat, None):
                return fn(*a, **kw)

        return wrapper

    return deco


def device_annotation(name: str):
    """``torch.profiler.record_function(name)`` when tracing is on, else a
    no-op.

    Lets our span names show up as ranges in a ``torch.profiler`` capture
    (CPU ops and the CUDA kernels launched inside them), so a profile of
    the card can be overlaid with the host-side trace.  torch is imported
    lazily, when the tracer is enabled.
    """
    if not _tracer.enabled:
        return _NULL_CONTEXT
    from torch.profiler import record_function  # local import: lazy

    return record_function(name)
