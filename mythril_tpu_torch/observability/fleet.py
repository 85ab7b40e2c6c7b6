"""Cross-process telemetry fabric: delta snapshots and a fleet rollup.

The worker pool moved analysis into spawned worker processes, which made every
per-process observability plane (metrics registry, span tracer,
heartbeat gauges, flight bundles) blind to where the work actually
happens.  This module is the seam that stitches them back together:

* ``FleetPublisher`` runs **inside a worker**.  It watches the worker's
  own registry and tracer and periodically produces a *delta payload* —
  counter/labeled-counter/histogram increments since the previous
  flush, absolute gauge values, newly recorded span batches (absolute
  ``perf_counter`` stamps so the daemon can rebase them), and the
  local-flow-id → request-id table that lets ``flow.request`` arrows
  survive the process seam.  Payloads carry a monotonically increasing
  sequence number and the producer pid.

* ``FleetAggregator`` runs **inside the daemon**.  It folds payloads
  into per-worker series plus a fleet rollup, drops replayed sequence
  numbers (idempotent: applying the same payload twice is a no-op),
  remaps worker-local flow ids onto daemon flow ids, and hands span
  batches to the daemon tracer as foreign process tracks.  Its
  ``prometheus_text`` renders the worker-labeled ``fleet_*`` series
  whose totals equal the unlabeled rollup lines — one scrape, one
  consistent snapshot.

The wire format is plain JSON-able dicts/lists tagged with a version —
deliberately host-count-agnostic, so the same payloads can ride a
socket between hosts when the multi-host pod bring-up needs them, not
just the pool's multiprocessing queue.

Delta algebra
-------------
Worker registries are swept between batches (``reset_analysis_scope``),
so "current minus last seen" would undercount or go negative across a
sweep.  Every metric therefore carries a reset *generation* (bumped by
its ``reset()``): when the generation moved since the baseline was
taken, the baseline is discarded and the delta restarts from the
metric's initial state.  Persistent metrics never reset in the sweep,
so their generation never moves and their deltas are exact — the sweep
semantics the rest of the system relies on are untouched.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from mythril_tpu_torch.observability.metrics import (
    _MUTATION_LOCK,
    Counter,
    Gauge,
    Histogram,
    LabeledCounter,
    MetricsRegistry,
    _prom_label_value,
    _prom_name,
    _prom_number,
    get_registry,
)
from mythril_tpu_torch.observability.tracer import Tracer, get_tracer

__all__ = [
    "WIRE_VERSION",
    "FleetPublisher",
    "FleetAggregator",
]

WIRE_VERSION = 1

Number = Any  # int | float


class FleetPublisher:
    """Worker-side delta producer over one registry + tracer pair.

    Thread-safe: the worker's control thread flushes on a timer while
    the main thread flushes before every batch completion, and both may
    note flow bindings concurrently.
    """

    def __init__(
        self,
        worker_id: int,
        registry: Optional[MetricsRegistry] = None,
        tracer: Optional[Tracer] = None,
    ):
        self.worker_id = worker_id
        self.pid = os.getpid()
        self._reg = registry if registry is not None else get_registry()
        self._tracer = tracer if tracer is not None else get_tracer()
        self._lock = threading.Lock()
        self._flush_lock = threading.Lock()
        self._seq = 0
        # baselines: value-at-last-flush plus the reset generation it
        # was taken under (see module docstring)
        self._counter_base: Dict[str, Tuple[Number, int]] = {}
        self._labeled_base: Dict[str, Tuple[Dict[str, Number], int]] = {}
        self._hist_base: Dict[str, Tuple[List[int], int, float, int]] = {}
        self._gauge_sent: Dict[str, Any] = {}
        self._span_cursor = 0
        self._flows: Dict[int, str] = {}

    # -- flow seam ------------------------------------------------------

    def note_flow(self, fid: int, request_id: str) -> None:
        """Bind a tracer-local flow id to the request it serves.

        Call *before* recording the flow event so no flush can ship the
        span without the binding that lets the daemon remap its id.
        """
        with self._lock:
            self._flows[fid] = request_id

    # -- delta computation ---------------------------------------------

    def _metrics_delta(self) -> Dict[str, Any]:
        counters: Dict[str, Number] = {}
        gauges: Dict[str, Any] = {}
        labeled: Dict[str, Dict[str, Any]] = {}
        hists: Dict[str, Dict[str, Any]] = {}
        with self._reg._lock:
            items = sorted(self._reg._metrics.items())
        for name, m in items:
            if isinstance(m, Histogram):
                with _MUTATION_LOCK:
                    bcounts = list(m.bucket_counts)
                    count, total = m.count, m.sum
                    mmin, mmax, gen = m.min, m.max, m.gen
                base = self._hist_base.get(name)
                if base is None or base[3] != gen:
                    bbase: List[int] = [0] * len(bcounts)
                    cbase, sbase = 0, 0.0
                else:
                    bbase, cbase, sbase, _ = base
                dcount = count - cbase
                self._hist_base[name] = (bcounts, count, total, gen)
                if dcount > 0:
                    hists[name] = {
                        "buckets": [float(b) for b in m.buckets],
                        "counts": [c - b for c, b in zip(bcounts, bbase)],
                        "count": dcount,
                        "sum": total - sbase,
                        "min": mmin,
                        "max": mmax,
                    }
            elif isinstance(m, LabeledCounter):
                with _MUTATION_LOCK:
                    snap = dict(m)
                    gen = m.gen
                base_d, base_g = self._labeled_base.get(name, ({}, gen))
                if base_g != gen:
                    base_d = {}
                inc: Dict[str, Number] = {}
                for label, v in snap.items():
                    if not isinstance(v, (int, float)):
                        continue
                    dv = v - base_d.get(label, 0)
                    if dv:
                        inc[str(label)] = dv
                self._labeled_base[name] = (snap, gen)
                if inc:
                    labeled[name] = {"label_name": m.label_name, "inc": inc}
            elif isinstance(m, Counter):
                value, gen = m.value, m.gen
                if not isinstance(value, (int, float)):
                    continue
                base_v, base_g = self._counter_base.get(
                    name, (m._initial, gen)
                )
                if base_g != gen:
                    base_v = m._initial
                d = value - base_v
                self._counter_base[name] = (value, gen)
                if d:
                    counters[name] = d
            elif isinstance(m, Gauge):
                v = m.value
                if isinstance(v, dict):
                    v = {
                        str(k): x for k, x in v.items()
                        if isinstance(x, (int, float))
                        and not isinstance(x, bool)
                    }
                    if not v:
                        continue
                elif isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                if self._gauge_sent.get(name) != v:
                    gauges[name] = v
                    self._gauge_sent[name] = v
        out: Dict[str, Any] = {}
        if counters:
            out["counters"] = counters
        if gauges:
            out["gauges"] = gauges
        if labeled:
            out["labeled"] = labeled
        if hists:
            out["hists"] = hists
        return out

    def collect(self) -> Optional[Dict[str, Any]]:
        """One delta payload, or ``None`` when nothing moved."""
        with self._lock:
            payload = self._metrics_delta()
            if self._tracer.enabled:
                cursor, events, names = self._tracer.drain_since(
                    self._span_cursor
                )
                self._span_cursor = cursor
                if events:
                    payload["spans"] = events
                    payload["tracks"] = {
                        int(t): str(n) for t, n in names.items()
                    }
            if self._flows:
                payload["flows"] = [
                    [fid, rid] for fid, rid in self._flows.items()
                ]
                self._flows = {}
            if not payload:
                return None
            self._seq += 1
            payload["v"] = WIRE_VERSION
            payload["seq"] = self._seq
            payload["pid"] = self.pid
            payload["worker"] = self.worker_id
            payload["t"] = time.time()
            return payload

    def flush(self, event_q) -> bool:
        """Collect and ship one payload on the pool event multiplex.

        The outer lock keeps (collect, put) atomic across the worker's
        two flushing threads so sequence numbers leave in order.
        """
        with self._flush_lock:
            payload = self.collect()
            if payload is None:
                return False
            event_q.put(("telemetry", self.worker_id, payload))
            return True


class _SeriesStore:
    """One accumulated metric store: a worker's series, or the rollup."""

    __slots__ = ("counters", "gauges", "labeled", "label_names", "hists")

    def __init__(self):
        self.counters: Dict[str, Number] = {}
        self.gauges: Dict[str, Any] = {}
        self.labeled: Dict[str, Dict[str, Number]] = {}
        self.label_names: Dict[str, str] = {}
        self.hists: Dict[str, Histogram] = {}

    def merge(self, payload: Dict[str, Any]) -> None:
        for name, d in (payload.get("counters") or {}).items():
            self.counters[name] = self.counters.get(name, 0) + d
        for name, v in (payload.get("gauges") or {}).items():
            self.gauges[name] = v
        for name, body in (payload.get("labeled") or {}).items():
            self.label_names[name] = body.get("label_name", "label")
            dest = self.labeled.setdefault(name, {})
            for label, d in (body.get("inc") or {}).items():
                dest[label] = dest.get(label, 0) + d
        for name, body in (payload.get("hists") or {}).items():
            h = self.hists.get(name)
            buckets = tuple(body.get("buckets") or ())
            if h is None or h.buckets != buckets:
                # backed by a real Histogram so percentile()/snapshot()
                # come for free on the aggregated side
                h = self.hists[name] = Histogram(name, buckets=buckets)
            counts = body.get("counts") or []
            for i, c in enumerate(counts):
                if i < len(h.bucket_counts):
                    h.bucket_counts[i] += c
            h.count += body.get("count", 0)
            h.sum += body.get("sum", 0.0)
            bmin, bmax = body.get("min"), body.get("max")
            if bmin is not None and (h.min is None or bmin < h.min):
                h.min = bmin
            if bmax is not None and (h.max is None or bmax > h.max):
                h.max = bmax


class _WorkerSeries(_SeriesStore):
    __slots__ = ("worker_id", "pid", "seq", "flushes", "spans", "last_flush")

    def __init__(self, worker_id):
        super().__init__()
        self.worker_id = worker_id
        self.pid: Optional[int] = None
        self.seq = 0
        self.flushes = 0
        self.spans = 0
        self.last_flush: Optional[float] = None


class FleetAggregator:
    """Daemon-side fold of worker delta payloads.

    ``flow_resolver`` maps a request id to a daemon-tracer flow id (and
    marks it live for the request's post-hoc "s" emission); when absent
    or returning ``None``, unmatched worker flows get fresh daemon ids.
    """

    def __init__(
        self,
        tracer: Optional[Tracer] = None,
        flow_resolver: Optional[Callable[[str], Optional[int]]] = None,
    ):
        self._tracer = tracer if tracer is not None else get_tracer()
        self._flow_resolver = flow_resolver
        self._lock = threading.Lock()
        self._workers: Dict[Any, _WorkerSeries] = {}
        self._rollup = _SeriesStore()
        # per-worker local-fid -> daemon-fid memo; spans and their flow
        # bindings may arrive in different payloads
        self._fid_maps: Dict[Any, Dict[int, int]] = {}
        self.replayed = 0
        self.discarded = 0

    def apply(self, worker_id, payload: Dict[str, Any]) -> bool:
        """Fold one payload; returns False for replays/bad versions."""
        if not isinstance(payload, dict) or payload.get("v") != WIRE_VERSION:
            self.discarded += 1
            return False
        with self._lock:
            ws = self._workers.get(worker_id)
            if ws is None:
                ws = self._workers[worker_id] = _WorkerSeries(worker_id)
            pid = payload.get("pid")
            seq = payload.get("seq", 0)
            if pid == ws.pid and seq <= ws.seq:
                self.replayed += 1
                return False
            if pid != ws.pid:
                # respawned worker: new pid, sequence restarts, and its
                # local flow ids mean nothing anymore
                ws.pid = pid
                ws.seq = 0
                self._fid_maps.pop(worker_id, None)
            ws.seq = seq
            ws.flushes += 1
            ws.last_flush = time.time()
            ws.merge(payload)
            self._rollup.merge(payload)
            spans = payload.get("spans") or []
            ws.spans += len(spans)
            self._ingest_spans(worker_id, pid, payload, spans)
        return True

    def _ingest_spans(self, worker_id, pid, payload, spans) -> None:
        # caller holds self._lock
        if not self._tracer.enabled:
            return
        fidmap = self._fid_maps.setdefault(worker_id, {})
        for pair in payload.get("flows") or []:
            try:
                lfid, rid = pair
            except Exception:
                continue
            gfid = self._flow_resolver(rid) if self._flow_resolver else None
            if gfid is not None:
                fidmap[lfid] = gfid
        if not spans or pid is None:
            return
        mapped = []
        for name, cat, ts, dur, tid, args, ph, fid in spans:
            if fid is not None:
                gfid = fidmap.get(fid)
                if gfid is None:
                    gfid = self._tracer.new_flow_id()
                    fidmap[fid] = gfid
                fid = gfid
            mapped.append((name, cat, ts, dur, tid, args, ph, fid))
        self._tracer.ingest_foreign(
            pid, f"mythril-worker-{worker_id}", mapped,
            payload.get("tracks") or {},
        )

    # -- views ----------------------------------------------------------

    def workers(self) -> List[Any]:
        with self._lock:
            return sorted(self._workers, key=str)

    def worker_summary(self, worker_id) -> Dict[str, Any]:
        """Per-worker operator view: phase times, kill rate, flushes."""
        with self._lock:
            ws = self._workers.get(worker_id)
            if ws is None:
                return {}
            out: Dict[str, Any] = {
                "pid": ws.pid,
                "seq": ws.seq,
                "flushes": ws.flushes,
                "spans": ws.spans,
            }
            if ws.last_flush is not None:
                out["flush_age_s"] = round(time.time() - ws.last_flush, 3)
            phases = {}
            for label, hname in (
                ("execute", "worker.execute_s"),
                ("probe", "worker.probe_s"),
            ):
                h = ws.hists.get(hname)
                if h is not None and h.count:
                    phases[label] = {
                        "count": h.count,
                        "avg_s": round(h.sum / h.count, 6),
                        "p50_s": round(h.percentile(0.5) or 0.0, 6),
                        "p95_s": round(h.percentile(0.95) or 0.0, 6),
                    }
            if phases:
                out["phase_s"] = phases
            evaluated = ws.counters.get("prefilter.evaluated", 0)
            killed = ws.counters.get("prefilter.killed", 0)
            if evaluated:
                out["prefilter"] = {
                    "evaluated": evaluated,
                    "killed": killed,
                    "kill_rate": round(killed / evaluated, 4),
                }
            ds_adm = ws.counters.get("devsolver.admitted", 0)
            if ds_adm:
                ds_sat = ws.counters.get("devsolver.decided_sat", 0)
                ds_uns = ws.counters.get("devsolver.decided_unsat", 0)
                out["devsolver"] = {
                    "admitted": ds_adm,
                    "decided_sat": ds_sat,
                    "decided_unsat": ds_uns,
                    "unknown": ws.counters.get("devsolver.unknown", 0),
                    "decide_rate": round((ds_sat + ds_uns) / ds_adm, 4),
                }
            # device-plane series flow through the fabric like any other
            # metric; summarize the worker's device-facing totals for top
            compile_s = ws.counters.get("device.compile_wall_s_total", 0)
            recompiles = ws.counters.get("device.recompiles_total", 0)
            hbm = ws.gauges.get("device.hbm_bytes")
            if compile_s or recompiles or hbm:
                device: Dict[str, Any] = {
                    "compile_s": round(float(compile_s), 3),
                    "recompiles": int(recompiles),
                }
                if isinstance(hbm, dict) and hbm:
                    device["hbm_bytes"] = max(
                        v for v in hbm.values()
                        if isinstance(v, (int, float))
                    )
                out["device"] = device
            return out

    def summary(self) -> Dict[str, Any]:
        """JSON view for the ``stats`` verb's ``fleet`` block."""
        out: Dict[str, Any] = {
            "workers": {
                str(w): self.worker_summary(w) for w in self.workers()
            },
            "replayed": self.replayed,
            "discarded": self.discarded,
        }
        with self._lock:
            out["rollup"] = {
                "counters": dict(self._rollup.counters),
                "spans": sum(w.spans for w in self._workers.values()),
            }
        return out

    # -- exposition ------------------------------------------------------

    def prometheus_text(self) -> str:
        """Worker-labeled ``fleet_*`` series plus unlabeled rollups.

        Rollup lines are recomputed from the per-worker series inside
        one lock hold, so within a single scrape the labeled samples
        always sum exactly to the rollup sample.
        """
        with self._lock:
            wids = sorted(self._workers, key=str)
            if not wids:
                return ""
            workers = {w: self._workers[w] for w in wids}
            lines: List[str] = []

            def wlabel(w):
                return _prom_label_value(w)

            names = sorted({n for ws in workers.values() for n in ws.counters})
            for name in names:
                pname = "fleet_" + _prom_name(name)
                lines.append(f"# TYPE {pname} counter")
                total = 0
                for w in wids:
                    v = workers[w].counters.get(name)
                    if v is None:
                        continue
                    total += v
                    lines.append(
                        f'{pname}{{worker="{wlabel(w)}"}} {_prom_number(v)}'
                    )
                lines.append(f"{pname} {_prom_number(total)}")

            names = sorted({n for ws in workers.values() for n in ws.gauges})
            for name in names:
                pname = "fleet_" + _prom_name(name)
                lines.append(f"# TYPE {pname} gauge")
                total = 0
                scalar = False
                for w in wids:
                    v = workers[w].gauges.get(name)
                    if v is None:
                        continue
                    if isinstance(v, dict):
                        for k, x in sorted(v.items()):
                            lines.append(
                                f'{pname}{{key="{_prom_label_value(k)}",'
                                f'worker="{wlabel(w)}"}} {_prom_number(x)}'
                            )
                    else:
                        scalar = True
                        total += v
                        lines.append(
                            f'{pname}{{worker="{wlabel(w)}"}} {_prom_number(v)}'
                        )
                if scalar:
                    lines.append(f"{pname} {_prom_number(total)}")

            names = sorted({n for ws in workers.values() for n in ws.labeled})
            for name in names:
                pname = "fleet_" + _prom_name(name)
                lines.append(f"# TYPE {pname} counter")
                lkey = "label"
                totals: Dict[str, Number] = {}
                for w in wids:
                    ws = workers[w]
                    if name in ws.label_names:
                        lkey = _prom_name(ws.label_names[name] or "label")
                for w in wids:
                    for label, v in sorted(
                        (workers[w].labeled.get(name) or {}).items()
                    ):
                        totals[label] = totals.get(label, 0) + v
                        lines.append(
                            f'{pname}{{{lkey}="{_prom_label_value(label)}",'
                            f'worker="{wlabel(w)}"}} {_prom_number(v)}'
                        )
                for label, v in sorted(totals.items()):
                    lines.append(
                        f'{pname}{{{lkey}="{_prom_label_value(label)}"}}'
                        f" {_prom_number(v)}"
                    )

            names = sorted({n for ws in workers.values() for n in ws.hists})
            for name in names:
                pname = "fleet_" + _prom_name(name)
                lines.append(f"# TYPE {pname} histogram")
                agg: Optional[Histogram] = None
                for w in wids:
                    h = workers[w].hists.get(name)
                    if h is None:
                        continue
                    if agg is None:
                        agg = Histogram(name, buckets=h.buckets)
                    self._emit_hist(lines, pname, h, f',worker="{wlabel(w)}"')
                    if agg.buckets == h.buckets:
                        for i, c in enumerate(h.bucket_counts):
                            agg.bucket_counts[i] += c
                        agg.count += h.count
                        agg.sum += h.sum
                if agg is not None:
                    self._emit_hist(lines, pname, agg, "")
        return "\n".join(lines) + "\n" if lines else ""

    @staticmethod
    def _emit_hist(lines: List[str], pname: str, h: Histogram,
                   extra_label: str) -> None:
        cum = 0
        for i, c in enumerate(h.bucket_counts):
            cum += c
            le = ("+Inf" if i == len(h.buckets)
                  else _prom_number(float(h.buckets[i])))
            lines.append(
                f'{pname}_bucket{{le="{le}"{extra_label}}} {cum}'
            )
        tail = ("{" + extra_label.lstrip(",") + "}") if extra_label else ""
        lines.append(f"{pname}_sum{tail} {_prom_number(float(h.sum))}")
        lines.append(f"{pname}_count{tail} {h.count}")
