"""Request-scoped telemetry: phase decomposition, span trees, tenants.

The engine-side instrumentation (tracing spine, flight deck) answers
"what is the device doing"; this module answers the questions a
multi-tenant service gets asked: *where did request X spend its two
seconds* and *which tenant is eating the batch window*.

One ``RequestTelemetry`` instance rides each ``AnalysisService``:

* **Phase decomposition.**  Every ``AnalysisRequest`` carries
  ``perf_counter`` stamps taken as it moves — ``t_submit`` at
  construction, ``admitted`` when the admission controller pulls its
  flight into a batch, ``execute0``/``execute1`` around the shared
  cooperative run.  At the terminal event the deltas land in the
  ``service.{queue_wait,batch_wait,execute,stream}_s`` histograms
  (persistent — they survive the per-batch metrics sweep), whose
  percentiles feed ``stats()``, the ``metrics`` verb, and ``myth top``.
  ``batch_wait`` covers admission to the device run, which includes the
  host-first probes of interactive flights in the same batch.

* **Span trees.**  When tracing is on, the terminal event also emits a
  ``service.request`` span with nested phase children onto a per-request
  synthetic track, reconstructed from the stamps (the tracer's post-hoc
  ``record_span`` path), plus a ``flow.request`` arrow from the
  request's ``service.execute`` child to the first ``frontier.segment``
  span of the shared batch that served it — one Perfetto trace shows a
  request end-to-end across the handler thread, the worker, and the
  device frontier.

* **Tenant accounting.**  Submissions may carry an optional ``tenant``
  label (``"-"`` when absent).  Labeled counters track per-tenant
  requests, streamed issues, dedup hits, and compute seconds attributed
  by batch share (device wall / flights in batch / requests on the
  flight) — the substrate the ROADMAP's quota item needs.

* **Request log.**  One JSON line per terminal event (ids, tenant,
  phases, issue digests) appended to the daemon's ``--request-log``.

Everything here runs at request granularity — nothing touches the
per-instruction hot path — and ``bench.py --serve-load`` asserts issue
digests stay bit-identical to solo runs with all of it enabled.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from mythril_tpu_torch.observability.metrics import Histogram, get_registry
from mythril_tpu_torch.observability.tracer import get_tracer
from mythril_tpu_torch.service.request import AnalysisRequest

__all__ = ["RequestTelemetry", "PHASES"]

# Phase order is the request's life in wall-clock order; each phase's
# start stamp is the previous phase's end.
PHASES = ("queue_wait", "batch_wait", "execute", "stream")

# Histograms whose percentiles stats() exposes, keyed by short phase name.
_STAT_HISTOGRAMS = PHASES + ("ttfe", "probe")


def _hist_stats(h: Histogram) -> Dict[str, Any]:
    if not h.count:
        return {"count": 0}
    return {
        "count": h.count,
        "avg": round(h.sum / h.count, 6),
        "p50": round(h.percentile(0.50), 6),
        "p95": round(h.percentile(0.95), 6),
        "p99": round(h.percentile(0.99), 6),
    }


class RequestTelemetry:
    # rollover keeps FILE.1 .. FILE.<backups>; oldest falls off the end
    LOG_BACKUPS = 5

    def __init__(self, request_log: Optional[str] = None,
                 request_log_max_bytes: int = 0):
        reg = get_registry()
        # persistent=True throughout: the worker sweeps analysis-scoped
        # metrics before every shared batch
        self._h_phase = {
            p: reg.histogram(f"service.{p}_s", persistent=True)
            for p in PHASES
        }
        self._t_requests = reg.labeled_counter(
            "service.tenant_requests", persistent=True, label_name="tenant")
        self._t_issues = reg.labeled_counter(
            "service.tenant_issues", persistent=True, label_name="tenant")
        self._t_dedup = reg.labeled_counter(
            "service.tenant_dedup_hits", persistent=True, label_name="tenant")
        self._t_compute = reg.labeled_counter(
            "service.tenant_compute_s", persistent=True, label_name="tenant")
        self._lock = threading.Lock()
        # rid -> live entry; a request is "active" from submission until
        # its terminal event.  Doubles as the finalize-once guard: the
        # first request_finished pops the entry, later calls no-op (the
        # dedup seam can race the worker's per-flight finalize loop).
        self._active: Dict[str, Dict[str, Any]] = {}
        # rid -> flow id for the batch currently executing (single
        # worker: one batch at a time), plus the set of flow ids whose
        # "f" endpoint the frontier actually emitted — the "s" side is
        # only recorded for those, so no arrow ever dangles when a batch
        # never reaches a device segment (host-only engine, errors).
        self._flows: Dict[str, int] = {}
        self._flows_emitted: set = set()
        self._log_lock = threading.Lock()
        self._log_path = request_log
        self._log_max_bytes = max(0, int(request_log_max_bytes))
        self._c_log_rotations = reg.counter(
            "service.request_log_rotations", persistent=True)
        self._log_file = open(request_log, "a", encoding="utf-8") \
            if request_log else None

    def close(self) -> None:
        with self._log_lock:
            if self._log_file is not None:
                self._log_file.close()
                self._log_file = None

    # -- request lifecycle --------------------------------------------

    @staticmethod
    def _tenant(request: AnalysisRequest) -> str:
        return request.tenant or "-"

    def request_started(self, request: AnalysisRequest) -> None:
        """Register a submission BEFORE it enters admission, so the
        worker can never finalize a request this table has not seen."""
        self._t_requests.inc(self._tenant(request))
        with self._lock:
            self._active[request.request_id] = {
                "tenant": self._tenant(request),
                "name": request.name,
                "codehash": request.codehash,
                "tier": request.tier,
                "phase": "queue_wait",
                "t0": request.t_submit,
            }

    def request_deduped(self, request: AnalysisRequest) -> None:
        self._t_dedup.inc(self._tenant(request))

    def set_phase(self, request: AnalysisRequest, phase: str) -> None:
        with self._lock:
            entry = self._active.get(request.request_id)
            if entry is not None:
                entry["phase"] = phase

    def request_finished(
        self,
        request: AnalysisRequest,
        event: str,
        *,
        n_issues: int = 0,
        digests: Optional[Sequence] = None,
        batch_width: Optional[int] = None,
        compute_share: float = 0.0,
        deduped: bool = False,
        replayed: bool = False,
        coverage_pct: Optional[float] = None,
        coverage_pct_reachable: Optional[float] = None,
        coverage_target_met: Optional[bool] = None,
    ) -> None:
        """Finalize one request at its terminal event (idempotent).

        ``coverage_pct`` is the exploration ledger's instruction-coverage
        percentage for the request's contract (None when the engine never
        produced one — rejected/replayed requests);
        ``coverage_pct_reachable`` is the same percentage quoted against
        the statically reachable denominator (staticpass oracle).
        ``coverage_target_met`` is the --coverage-target verdict: True
        when the adaptive controller ended exploration at the bar (or on
        plateau), False when the budget ran out first, None when the
        request carried no target."""
        with self._lock:
            entry = self._active.pop(request.request_id, None)
        if entry is None:
            return  # already finalized across the dedup seam
        now = time.perf_counter()
        stamps = request.stamps
        admitted = stamps.get("admitted", request.t_submit)
        exec0 = stamps.get("execute0", admitted)
        exec1 = stamps.get("execute1", exec0)
        phases = {
            "queue_wait": max(admitted - request.t_submit, 0.0),
            "batch_wait": max(exec0 - admitted, 0.0),
            "execute": max(exec1 - exec0, 0.0),
            "stream": max(now - exec1, 0.0),
        }
        for p, v in phases.items():
            self._h_phase[p].observe(v)
        tenant = entry["tenant"]
        if n_issues:
            self._t_issues.inc(tenant, n_issues)
        if compute_share:
            self._t_compute.inc(tenant, round(compute_share, 6))
        self._emit_span_tree(request, entry, phases, now, event,
                             deduped=deduped, replayed=replayed,
                             batch_width=batch_width)
        self._log_line(request, entry, phases, event,
                       n_issues=n_issues, digests=digests,
                       batch_width=batch_width, deduped=deduped,
                       replayed=replayed, coverage_pct=coverage_pct,
                       coverage_pct_reachable=coverage_pct_reachable,
                       coverage_target_met=coverage_target_met)
        # pool mode allocates flows per request (adopt_worker_flow), not
        # per batch, so retire the binding here to keep the table bounded
        with self._lock:
            fid = self._flows.pop(request.request_id, None)
            if fid is not None:
                self._flows_emitted.discard(fid)

    # -- span tree + flow join ----------------------------------------

    def batch_flow_callback(self, request_ids: Sequence[str]
                            ) -> Optional[Callable[[], None]]:
        """Allocate one flow id per request in the batch about to run.

        Returns the callback the frontier invokes *inside* its first
        ``frontier.segment`` span (recording every "f" endpoint there),
        or ``None`` when tracing is off.  The matching "s" endpoints are
        recorded per request at terminal time, stamped back inside the
        request's execute window — exports order by timestamp, so the
        arrows still point forward.
        """
        tr = get_tracer()
        self._flows = {}
        self._flows_emitted = set()
        if not tr.enabled:
            return None
        for rid in request_ids:
            self._flows[rid] = tr.new_flow_id()

        def _emit_flow_targets() -> None:
            for fid in self._flows.values():
                if fid not in self._flows_emitted:
                    tr.flow("f", fid, "flow.request", cat="service")
                    self._flows_emitted.add(fid)

        return _emit_flow_targets

    def adopt_worker_flow(self, request_id: str) -> Optional[int]:
        """Allocate (or reuse) this request's daemon-side flow id when a
        pool worker reports a ``flow.request`` binding for it.

        This is the fabric's ``flow_resolver``: the worker recorded the
        "f" endpoint inside its own batch span under a worker-local id;
        the aggregator remaps that id to the value returned here, and
        marking it *emitted* licenses ``_emit_span_tree`` to record the
        matching "s" at terminal time — the arrow crosses the process
        seam without either side trusting the other's id space.
        """
        tr = get_tracer()
        if not tr.enabled:
            return None
        with self._lock:
            fid = self._flows.get(request_id)
            if fid is None:
                fid = tr.new_flow_id()
                self._flows[request_id] = fid
            self._flows_emitted.add(fid)
        return fid

    def _emit_span_tree(self, request, entry, phases, now, event, *,
                        deduped, replayed, batch_width) -> None:
        tr = get_tracer()
        if not tr.enabled:
            return
        rid = request.request_id
        tid = tr.register_track(f"service.request {rid}")
        tr.record_span(
            "service.request", "service", request.t_submit,
            max(now - request.t_submit, 0.0), tid=tid,
            args={
                "request": rid, "tenant": entry["tenant"],
                "name": entry["name"], "codehash": entry["codehash"],
                "tier": entry["tier"], "event": event,
                "deduped": deduped, "replayed": replayed,
                **({"batch_width": batch_width} if batch_width else {}),
            },
        )
        t = request.t_submit
        for p in PHASES:
            dur = phases[p]
            if dur > 0.0:
                tr.record_span(f"service.{p}", "service", t, dur,
                               tid=tid, args={"request": rid})
            t += dur
        fid = self._flows.get(rid)
        if fid is not None and fid in self._flows_emitted:
            exec0 = request.stamps.get("execute0")
            if exec0 is not None:
                # the "s" endpoint binds to the service.execute child at
                # its timestamp; 1µs in keeps it inside the slice
                tr.flow_at("s", fid, "flow.request", cat="service",
                           tid=tid, t=exec0 + 1e-6)

    # -- request log ---------------------------------------------------

    def _log_line(self, request, entry, phases, event, *, n_issues,
                  digests, batch_width, deduped, replayed,
                  coverage_pct=None, coverage_pct_reachable=None,
                  coverage_target_met=None) -> None:
        if self._log_file is None:
            return
        rec = {
            "t": round(time.time(), 3),
            "request_id": request.request_id,
            "name": entry["name"],
            "tenant": request.tenant,
            "codehash": entry["codehash"],
            "tier": entry["tier"],
            "event": event,
            "deduped": deduped,
            "replayed": replayed,
            "batch_width": batch_width,
            "n_issues": n_issues,
            "digests": [list(d) for d in digests] if digests else [],
            "phases_s": {p: round(v, 6) for p, v in phases.items()},
            "coverage_pct": coverage_pct,
            "coverage_pct_reachable": coverage_pct_reachable,
        }
        if coverage_target_met is not None:
            rec["coverage_target_met"] = coverage_target_met
        line = json.dumps(rec, default=repr) + "\n"
        with self._log_lock:
            if self._log_file is not None:
                self._log_file.write(line)
                self._log_file.flush()
                if (self._log_max_bytes
                        and self._log_file.tell() >= self._log_max_bytes):
                    self._rotate_locked()

    def _rotate_locked(self) -> None:
        """Size-based rollover: FILE -> FILE.1 -> ... (caller holds lock).

        A long-lived daemon otherwise grows the request log without
        bound; the rotation counter makes rollover rate visible.
        """
        base = self._log_path
        try:
            self._log_file.close()
            for i in range(self.LOG_BACKUPS - 1, 0, -1):
                src = f"{base}.{i}"
                if os.path.exists(src):
                    os.replace(src, f"{base}.{i + 1}")
            os.replace(base, f"{base}.1")
            self._c_log_rotations.inc()
        except OSError:
            pass  # worst case: keep appending to the current file
        self._log_file = open(base, "a", encoding="utf-8")

    # -- introspection -------------------------------------------------

    def active_requests(self) -> List[Dict[str, Any]]:
        """Live requests with their current phase, oldest first — the
        flight-recorder context source and the ``myth top`` in-flight
        table."""
        now = time.perf_counter()
        with self._lock:
            items = sorted(self._active.items(),
                           key=lambda kv: kv[1]["t0"])
            return [
                {
                    "request_id": rid,
                    "tenant": e["tenant"],
                    "name": e["name"],
                    "tier": e["tier"],
                    "phase": e["phase"],
                    "age_s": round(now - e["t0"], 3),
                }
                for rid, e in items
            ]

    def phase_stats(self) -> Dict[str, Dict[str, Any]]:
        """Per-phase latency percentiles for stats()/``myth top``."""
        reg = get_registry()
        return {
            p: _hist_stats(reg.histogram(f"service.{p}_s", persistent=True))
            for p in _STAT_HISTOGRAMS
        }

    def tenant_stats(self) -> Dict[str, Dict[str, Any]]:
        out: Dict[str, Dict[str, Any]] = {}
        for tenant, n in sorted(self._t_requests.snapshot().items()):
            out[tenant] = {
                "requests": n,
                "issues": self._t_issues.get(tenant, 0),
                "dedup_hits": self._t_dedup.get(tenant, 0),
                "compute_s": round(self._t_compute.get(tenant, 0.0), 3),
            }
        return out
