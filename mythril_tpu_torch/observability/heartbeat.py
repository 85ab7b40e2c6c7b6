"""Heartbeat sampler: periodic queue-depth snapshots for long runs.

The pipelined frontier's interesting state — feasibility solves in
flight, ledger corrections pending, free slots per shard, arena
occupancy — lives in structures that mutate thousands of times per
segment.  Publishing a gauge on every mutation is both expensive and
misleading (the value read between sync points is whatever the last
mutator happened to leave).  The flight deck inverts this: owners
*register a sampling callback*, and one daemon thread snapshots every
source at a fixed period.  Each tick

* sets the corresponding registry gauges (so ``--metrics-out`` and the
  report meta show the last sampled depth, never a stale mutation),
* emits Chrome-trace "C" counter events onto a dedicated ``heartbeat``
  track (Perfetto renders them as stacked counter lanes), and
* appends one JSON line to ``--heartbeat-out`` when configured —
  ``tail -f`` progress for multi-minute pod runs.

A bounded ring of recent samples is kept for the flight recorder, so a
hang bundle shows the queue-depth trajectory leading into the stall.

Sources are plain callables returning ``{metric_name: value}``; values
may be numbers or flat ``{label: number}`` dicts (per-shard breakdowns).
Sampling never raises: a source that throws is recorded as errored and
skipped for the rest of the run.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from mythril_tpu_torch.observability.metrics import get_registry
from mythril_tpu_torch.observability.tracer import get_tracer

log = logging.getLogger(__name__)

__all__ = ["HeartbeatSampler", "get_heartbeat"]

Source = Callable[[], Dict[str, Any]]

DEFAULT_PERIOD_S = 0.5


class HeartbeatSampler:
    """Daemon-thread sampler over registered queue-depth sources."""

    def __init__(self, period_s: float = DEFAULT_PERIOD_S):
        self.period_s = period_s
        self._lock = threading.Lock()
        self._sources: Dict[str, Source] = {}
        self._errors: Dict[str, int] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._out_path: Optional[str] = None
        self._out_file = None
        self._track_tid: Optional[int] = None
        self.recent: deque = deque(maxlen=240)  # flight-recorder tail
        self.ticks = 0

    # -- source registry ----------------------------------------------

    MAX_SOURCE_ERRORS = 5  # consecutive failures before a source is dropped

    def register(self, name: str, fn: Source) -> None:
        """Add/replace a sampling source (idempotent by ``name``)."""
        with self._lock:
            self._sources[name] = fn
            self._errors.pop(name, None)

    def unregister(self, name: str) -> None:
        with self._lock:
            self._sources.pop(name, None)
            self._errors.pop(name, None)

    # -- lifecycle -----------------------------------------------------

    def start(
        self,
        period_s: Optional[float] = None,
        out_path: Optional[str] = None,
    ) -> None:
        """Start the daemon thread (no-op if already running)."""
        if self._thread is not None and self._thread.is_alive():
            return
        if period_s is not None:
            self.period_s = period_s
        self._out_path = out_path
        if out_path:
            self._out_file = open(out_path, "w")
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="mythril-heartbeat", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=self.period_s * 4 + 1.0)
        self._thread = None
        if self._out_file is not None:
            try:
                self._out_file.close()
            finally:
                self._out_file = None

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def _run(self) -> None:
        while not self._stop.wait(self.period_s):
            self.sample_now()

    # -- sampling ------------------------------------------------------

    def sample_now(self) -> Dict[str, Any]:
        """Take one sample synchronously (also the test/recorder entry)."""
        with self._lock:
            sources = [
                (n, f) for n, f in self._sources.items()
                if self._errors.get(n, 0) < self.MAX_SOURCE_ERRORS
            ]
        sample: Dict[str, Any] = {}
        reg = get_registry()
        for name, fn in sources:
            try:
                vals = fn()
            except Exception:
                # sources read concurrently-mutated pipeline state, so a
                # transient race may throw; only repeat offenders drop out
                reg.labeled_counter(
                    "heartbeat.source_errors", persistent=True,
                    label_name="source",
                ).inc(name)
                with self._lock:
                    self._errors[name] = self._errors.get(name, 0) + 1
                    dropped = self._errors[name] == self.MAX_SOURCE_ERRORS
                if dropped:
                    reg.counter(
                        "heartbeat.sources_dropped", persistent=True
                    ).inc()
                    log.warning(
                        "heartbeat source %r dropped after %d consecutive "
                        "errors", name, self.MAX_SOURCE_ERRORS,
                    )
                continue
            with self._lock:
                self._errors.pop(name, None)
            if vals:
                sample.update(vals)
        self._publish(sample)
        return sample

    def _publish(self, sample: Dict[str, Any]) -> None:
        reg = get_registry()
        tracer = get_tracer()
        if tracer.enabled and self._track_tid is None:
            self._track_tid = tracer.register_track("heartbeat")
        for key, val in sample.items():
            reg.gauge(key).set(val)
            if tracer.enabled:
                series = val if isinstance(val, dict) else {"value": val}
                # counter events need numeric series; drop anything else
                series = {
                    k: v for k, v in series.items()
                    if isinstance(v, (int, float))
                }
                if series:
                    tracer.counter(key, series, tid=self._track_tid)
        self.ticks += 1
        line = {"t": round(time.time(), 3), "tick": self.ticks, **sample}
        self.recent.append(line)
        f = self._out_file
        if f is not None:
            try:
                f.write(json.dumps(line) + "\n")
                f.flush()
            except ValueError:
                pass  # closed under us during shutdown

    def recent_samples(self) -> List[Dict[str, Any]]:
        return list(self.recent)

    def dropped_sources(self) -> List[str]:
        """Names of sources dropped for repeated errors (``myth top``)."""
        with self._lock:
            return sorted(
                n for n, c in self._errors.items()
                if c >= self.MAX_SOURCE_ERRORS
            )

    def source_error_counts(self) -> Dict[str, int]:
        """Current consecutive-error count per misbehaving source."""
        with self._lock:
            return dict(self._errors)

    def reset(self) -> None:
        """Stop and forget all sources/samples (tests, between analyses)."""
        self.stop()
        with self._lock:
            self._sources.clear()
            self._errors.clear()
        self.recent.clear()
        self.ticks = 0
        self._track_tid = None


_heartbeat = HeartbeatSampler()


def get_heartbeat() -> HeartbeatSampler:
    return _heartbeat
