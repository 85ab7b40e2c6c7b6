"""The warm analysis service: admission plane + N analysis workers.

The admission plane (this module) owns submission identity, dedup,
scheduling policy, telemetry and result caching; analysis runs on
*workers*.  Two worker shapes share one finalize path:

* ``workers=1`` (default) — the classic inline worker: one daemon
  thread (``service-worker``) owns every non-reentrant analysis
  singleton through an explicit ``facade.warm.WorkerContext`` and runs
  admitted flights as shared wide device batches.
* ``workers=N>1`` — a horizontal pool of N worker *processes*
  (``service/pool.py`` + ``service/worker.py``).  The engine's
  process-globals (flag object, issue sink, interned SMT terms) confined
  analysis to one thread per process; process isolation gives each
  worker its own private copy, so N batches run truly concurrently.
  Workers share the on-disk SMT query cache and kernel build cache under
  ``--cache-root`` plus the cross-process completed-result LRU
  (``service/resultstore.py``), so dedup hits survive worker affinity
  and daemon restarts.  A dead worker errors only its in-flight
  requests (with a flight-recorder bundle naming them), is respawned,
  and ``service.worker_restarts`` counts the event.

Per-batch scope reset (``WorkerContext.reset_scope``) makes every batch
behave like a fresh process for *detection* while the SMT query cache,
interned terms, and built kernel libraries stay warm — that split is the
determinism story: issue sets are bit-identical to solo runs
(differentially tested in tests/service/), throughput is not.

Streaming: a per-process issue sink taps every confirmation the moment
a module accepts it; the sink attributes issues to flights by
``Issue.bytecode_hash`` and emits each digest once per flight — inline
via the flight directly, pool workers via the event queue the pump
multiplexes back into the same flights.  The terminal ``done`` event
carries the authoritative end-of-batch issue list, so a client that
ignores the stream loses latency, never findings.  ``poll`` adds a
long-poll subscribe path (cursor + bounded wait) so idle subscribers
hold no handler thread between events.

Interactive tier: flights submitted with ``tier="interactive"`` jump the
admission queue, cut the batch window, and (by default) get a bounded
host-first 1-tx probe *before* the authoritative batch.  Scheduling
policy (``service/scheduling.py``) layers tenant quotas, batch-tier
load shedding, and priority aging on top, so one hot tenant cannot
starve the interactive tier.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import logging
import os
import tempfile
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple

from mythril_tpu_torch.observability import tracer as _otrace
from mythril_tpu_torch.observability.fleet import FleetAggregator
from mythril_tpu_torch.observability.flightrecorder import (
    get_flight_recorder,
    register_dump_listener,
    register_flight_context,
    unregister_dump_listener,
    unregister_flight_context,
)
from mythril_tpu_torch.observability.heartbeat import get_heartbeat
from mythril_tpu_torch.observability.metrics import get_registry
from mythril_tpu_torch.service.admission import AdmissionController, Flight
from mythril_tpu_torch.service.codehash import canonical_codehash, issue_digest, normalize_code
from mythril_tpu_torch.service.request import (
    AnalysisOptions,
    AnalysisRequest,
    ResultStream,
    TIER_BATCH,
    TIER_INTERACTIVE,
    issue_to_wire,
)
from mythril_tpu_torch.service.scheduling import (
    AdmissionRejected,
    SchedulerPolicy,
    validate_coverage_target,
)
from mythril_tpu_torch.service.telemetry import RequestTelemetry

log = logging.getLogger(__name__)

__all__ = ["AnalysisService", "ServiceConfig"]

#: minimal STOP contract used to pull heavy imports during warmup
_WARMUP_CODE = bytes.fromhex("00")

#: bound on the request-id -> flight registry backing the poll API
_RID_REGISTRY_CAP = 4096


@dataclass
class ServiceConfig:
    default_options: AnalysisOptions = field(default_factory=AnalysisOptions)
    max_batch_width: int = 8
    #: how long the worker holds an admission window open for more
    #: arrivals once work is pending (interactive arrivals cut it short)
    batch_window_s: float = 0.05
    #: run batches on the device frontier (the service's raison d'être);
    #: tests flip this off for pure-host speed
    frontier: bool = True
    #: host-first hybrid probe for interactive-tier requests (default ON:
    #: a cold bucket must still meet the TTFE budget)
    probe: bool = True
    probe_timeout_s: int = 10
    #: one directory pinning query cache + kernel build cache + the
    #: cross-process completed-result LRU
    cache_root: Optional[str] = None
    #: run a tiny analysis at start() so imports/solver are hot before
    #: the first real request lands
    warmup: bool = True
    #: start the heartbeat sampler and register the service depth source
    heartbeat: bool = False
    heartbeat_interval_s: float = 0.5
    result_cache_size: int = 256
    #: append one JSON line per terminal request event (ids, tenant,
    #: phase decomposition, issue digests) to this path
    request_log: Optional[str] = None
    #: analysis workers: 1 = inline worker thread (classic daemon),
    #: N > 1 = a pool of N spawned worker processes behind this
    #: admission plane
    workers: int = 1
    #: scheduling policy knobs (0 / 0.0 leave the base behavior intact)
    tenant_quota: int = 0
    shed_queue_depth: int = 0
    age_priority_s: float = 0.0
    #: pool workers enable their local tracer and ship span batches back
    #: over the telemetry fabric (set when the daemon runs --trace-out)
    trace: bool = False
    #: worker-side telemetry flush cadence (control-thread idle timeout)
    flush_interval_s: float = 0.5
    #: size-based request-log rollover threshold in MiB (0 disables)
    request_log_max_mb: float = 64.0
    #: run the watchtower: persistent metrics history under
    #: <cache_root>/history plus SLO evaluation with auto-capture
    #: (``myth serve`` turns this on; unit tests keep it off)
    watchtower: bool = False
    watchtower_interval_s: float = 5.0
    #: declarative SLO file (YAML/JSON); None = built-in defaults
    slo_file: Optional[str] = None
    #: the port's own: the device every worker analyzes on — None is the
    #: CUDA card (``NoCudaDevice`` at start() without one), ``"cpu"`` the
    #: plain PyTorch kernels; pool workers get it over the wire config
    device: Optional[str] = None

    def scheduler_policy(self) -> Optional[SchedulerPolicy]:
        if not (self.tenant_quota or self.shed_queue_depth
                or self.age_priority_s > 0):
            return None
        return SchedulerPolicy(
            max_pending_per_tenant=self.tenant_quota,
            shed_queue_depth=self.shed_queue_depth,
            age_priority_s=self.age_priority_s,
        )


class AnalysisService:
    def __init__(self, config: Optional[ServiceConfig] = None):
        self.config = config or ServiceConfig()
        if self.config.workers < 1:
            raise ValueError("ServiceConfig.workers must be >= 1")
        result_store = None
        if self.config.cache_root:
            from mythril_tpu_torch.service.resultstore import ResultStore

            result_store = ResultStore(
                os.path.join(self.config.cache_root, "results")
            )
        self.admission = AdmissionController(
            result_cache_size=self.config.result_cache_size,
            policy=self.config.scheduler_policy(),
            result_store=result_store,
        )
        self._ids = itertools.count(1)
        self._worker: Optional[threading.Thread] = None
        self._pool = None  # WorkerPool when workers > 1
        self._jobs: Dict[int, Dict[str, Any]] = {}
        self._jobs_lock = threading.Lock()
        self._stop = threading.Event()
        self._warm_ready = threading.Event()
        self._draining = False
        self._started = False
        # request-id -> (key, flight-or-None): the poll/long-poll path
        self._by_rid: "OrderedDict[str, Tuple[Tuple, Optional[Flight]]]" = (
            OrderedDict()
        )
        self._rid_lock = threading.Lock()
        self._ctx = None  # inline worker's WorkerContext
        #: the port's own: the device fault that stopped the inline worker
        #: (``run_server`` then returns 1), else None
        self.fault: Optional[BaseException] = None
        reg = get_registry()
        self._c_batches = reg.counter("service.batches", persistent=True)
        self._h_width = reg.histogram(
            "service.batch_width", buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0),
            persistent=True,
        )
        self._c_streamed = reg.counter("service.streamed_issues", persistent=True)
        self._c_errors = reg.counter("service.request_errors", persistent=True)
        self._c_probe_wins = reg.counter("service.probe_wins", persistent=True)
        self._c_device_wins = reg.counter("service.device_wins", persistent=True)
        self._c_probe_runs = reg.counter("service.probe_runs", persistent=True)
        self._h_probe = reg.histogram("service.probe_s", persistent=True)
        self._c_restarts = reg.counter(
            "service.worker_restarts", persistent=True
        )
        # per-analysis prefilter.* counters are scope-reset between batches;
        # these persistent mirrors accumulate their deltas for stats()/top
        self._c_pf_eval = reg.counter(
            "service.prefilter_evaluated", persistent=True
        )
        self._c_pf_kill = reg.counter(
            "service.prefilter_killed", persistent=True
        )
        # device SAT tier mirrors, same scope-reset/persistent-delta
        # contract as the prefilter pair
        self._c_ds = {
            name: reg.counter("service.devsolver_" + name, persistent=True)
            for name in ("admitted", "decided_sat", "decided_unsat",
                         "unknown", "model_validation_failures")
        }
        # adaptive-controller mirrors, same scope-reset/persistent-delta
        # contract; coverage_stop keeps the most recent batch's latched
        # verdict for stats()/top
        self._c_adaptive = {
            name: reg.counter("service.adaptive_" + name, persistent=True)
            for name in ("plans", "resteered_slots", "requeued_paths",
                         "flips_planned", "flips_hit", "plateau_stops")
        }
        self._last_coverage_stop: Optional[Dict[str, Any]] = None
        # exploration-ledger mirrors: termination classes and pc-overflow
        # deltas accumulate here across batches (the scoped exploration.*
        # counters reset per analysis); per-contract coverage keeps the
        # most recent batch's view, bounded
        self._c_term = reg.labeled_counter(
            "service.exploration_terminated", persistent=True,
            label_name="class",
        )
        self._c_term_total = reg.counter(
            "service.exploration_terminated_total", persistent=True
        )
        self._c_pc_overflow = reg.counter(
            "service.exploration_pc_overflow", persistent=True
        )
        self._coverage_by_hash: "collections.OrderedDict[str, float]" = (
            collections.OrderedDict()
        )
        # same view over the statically reachable denominator (the
        # staticpass reachable-edge oracle); falls back to the raw
        # percentage for codes with no registered static masks
        self._coverage_reach_by_hash: "collections.OrderedDict[str, float]" = (
            collections.OrderedDict()
        )
        self._g_coverage = reg.gauge(
            "service.coverage_avg_pct", persistent=True
        )
        self._g_coverage_reach = reg.gauge(
            "service.coverage_reachable_avg_pct", persistent=True
        )
        self.telemetry = RequestTelemetry(
            request_log=self.config.request_log,
            request_log_max_bytes=int(
                self.config.request_log_max_mb * 1024 * 1024
            ),
        )
        # cross-process telemetry fold: worker delta payloads land here
        # (kept separate from the daemon registry so daemon-side sweeps
        # can never break the worker-sum == rollup invariant)
        self.fleet = FleetAggregator(
            flow_resolver=self.telemetry.adopt_worker_flow
        )
        self._profile_ids = itertools.count(1)
        self._profile_waits: Dict[int, Dict[str, Any]] = {}
        self._profile_lock = threading.Lock()
        self.watchtower = None  # armed in start() when config.watchtower
        # fault hook (bench serve-load, CI breach drill): stall every
        # submission ahead of admission by this many seconds, so the
        # injected latency lands inside the TTFE/queue-wait budgets
        self._inject_submit_sleep = float(
            os.environ.get("BENCH_INJECT_ADMISSION_SLEEP", "0") or 0.0
        )

    @property
    def pooled(self) -> bool:
        return self.config.workers > 1

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "AnalysisService":
        if self._started:
            return self
        hb = get_heartbeat()
        hb.register("service", self._sample_depths)
        register_flight_context(
            "service.requests", self.telemetry.active_requests
        )
        if self.config.heartbeat and not hb.running:
            hb.start(period_s=self.config.heartbeat_interval_s)
        self._stop.clear()
        self._warm_ready.clear()
        self._draining = False
        if self.pooled:
            from mythril_tpu_torch.service.pool import WorkerPool
            from mythril_tpu_torch.service.worker import worker_config

            self._pool = WorkerPool(
                self.config.workers,
                worker_config(self.config),
                self._on_worker_event,
            )
            # daemon flight dumps (crash, SIGUSR1, watchdog) fan out a
            # bundle request to every live worker so operators get one
            # linked bundle set covering the whole process tree
            register_dump_listener("service.fleet", self._fanout_bundles)
            register_flight_context("service.workers", self.worker_stats)
            self._worker = threading.Thread(
                target=self._pool_dispatch_loop, name="service-dispatch",
                daemon=True,
            )
        else:
            self._configure_process()
            self._worker = threading.Thread(
                target=self._worker_loop, name="service-worker", daemon=True
            )
        self._started = True
        self._worker.start()
        if self.config.watchtower:
            self._start_watchtower()
        return self

    def wait_warm(self, timeout: Optional[float] = None) -> bool:
        """Block until startup warmup has finished (immediately true when
        ``warmup=False`` and inline; in pool mode, until every worker
        process has reported ready).  Load generators use this so
        measured windows start from a warm process, matching the
        service's steady state."""
        return self._warm_ready.wait(timeout)

    def stop(self, drain: bool = True, timeout: Optional[float] = None) -> bool:
        """Stop the worker(s); with ``drain`` (the SIGTERM path) finish
        every pending and running flight first — busy pool workers run
        their current batch to its terminal events before exiting.
        Returns True on clean drain."""
        if not self._started:
            return True
        self._draining = True  # reject new submissions immediately
        drained = True
        if drain:
            drained = self.admission.drain_wait(timeout=timeout)
        self._stop.set()
        w = self._worker
        if w is not None and w.is_alive():
            w.join(timeout=30.0)
        self._worker = None
        if self._pool is not None:
            self._pool.stop(timeout=30.0)
            self._pool = None
        self._started = False
        wt = self.watchtower
        if wt is not None:
            wt.stop()
            from mythril_tpu_torch.observability.watchtower import set_watchtower
            set_watchtower(None)
        get_heartbeat().unregister("service")
        unregister_flight_context("service.requests")
        unregister_flight_context("service.workers")
        unregister_dump_listener("service.fleet")
        self.telemetry.close()
        return drained

    def _start_watchtower(self) -> None:
        """Arm the SLO engine: history ring + objectives + capture hook."""
        import tempfile

        from mythril_tpu_torch.observability.watchtower import (
            Watchtower, default_objectives, load_slo_file, set_watchtower,
        )

        objectives = default_objectives(self.config.workers)
        options: Dict[str, Any] = {}
        if self.config.slo_file:
            objectives, options = load_slo_file(self.config.slo_file)
        if self.config.cache_root:
            history_dir = os.path.join(self.config.cache_root, "history")
        else:
            history_dir = tempfile.mkdtemp(prefix="myth-history-")
        capture_cfg = options.get("capture") or {}
        self._profile_duration_s = float(
            capture_cfg.get("profile_duration_s", 2.0)
        )
        self._profile_on_breach = bool(capture_cfg.get("profile", True))
        self.watchtower = Watchtower(
            history_dir,
            objectives=objectives,
            interval_s=float(
                options.get("interval_s", self.config.watchtower_interval_s)
            ),
            capture=self._on_slo_breach,
            capture_cooldown_s=float(capture_cfg.get("cooldown_s", 120.0)),
        )
        set_watchtower(self.watchtower)
        self.watchtower.start()
        log.info(
            "watchtower armed: %d objectives, %.1fs cadence, history at %s",
            len(objectives), self.watchtower.interval_s, history_dir,
        )

    def _worst_worker(self) -> int:
        """Capture target: the pool worker with the slowest execute p95
        (the one most likely implicated in a latency breach)."""
        pool = self._pool
        if pool is None:
            return 0
        worst, wid = -1.0, 0
        for row in pool.stats():
            summary = self.fleet.worker_summary(row.get("id", 0))
            p95 = (((summary.get("phase_s") or {}).get("execute") or {})
                   .get("p95_s") or 0.0)
            if p95 > worst:
                worst, wid = p95, row.get("id", 0)
        return wid

    def _on_slo_breach(self, objective, evaluation) -> Dict[str, Any]:
        """Auto-capture: flight bundle (fans out linked worker bundles in
        pool mode) + a short profile window on the worst worker, both
        stamped with the breaching objective."""
        info: Dict[str, Any] = {}
        rec = get_flight_recorder()
        if rec is not None:
            try:
                info["bundle"] = rec.dump(
                    f"slo.{objective.name}",
                    extra={"slo": evaluation},
                )
            except Exception:
                log.exception("breach bundle dump failed")
        if self._profile_on_breach:
            wid = self._worst_worker()
            info["profile_worker"] = wid

            def _capture() -> None:
                try:
                    self.profile(
                        worker_id=wid,
                        duration_s=self._profile_duration_s,
                        tag=f"slo-{objective.name}",
                    )
                except Exception:
                    log.exception("breach profile capture failed")

            # off-thread: profile() blocks for the capture window and the
            # watchtower tick loop must not stall behind it
            threading.Thread(
                target=_capture, name="slo-capture", daemon=True
            ).start()
        return info

    def health(self) -> Dict[str, Any]:
        """The ``health`` verb: watchtower SLO state (or disabled)."""
        wt = self.watchtower
        if wt is None:
            return {"enabled": False, "ok": None, "objectives": []}
        return wt.health()

    def _sample_depths(self) -> Dict[str, int]:
        """Heartbeat source: admission + worker-slot depths + live
        request count."""
        depths = self.admission.depths()
        depths["service.active_requests"] = len(self.telemetry.active_requests())
        pool = self._pool
        if pool is not None:
            depths.update(pool.depths())
        return depths

    def _configure_process(self) -> None:
        """Arm the inline worker's context once, at startup, on
        ``config.device``."""
        from mythril_tpu_torch.facade.mythril_analyzer import AnalyzerArgs
        from mythril_tpu_torch.facade.warm import WorkerContext

        opts = self.config.default_options
        self._ctx = WorkerContext(AnalyzerArgs(
            strategy=opts.strategy,
            transaction_count=opts.transaction_count,
            execution_timeout=opts.execution_timeout,
            modules=list(opts.modules) if opts.modules else None,
            frontier=self.config.frontier,
            cache_root=self.config.cache_root,
        ), device=self.config.device).configure()

    def _warmup(self) -> None:
        """Pull heavy imports + solver setup with a minimal contract so
        the first real request pays dispatch, not process warmup.  A
        device fault propagates (the worker loop stops the service)."""
        from mythril_tpu_torch.analysis.cooperative import run_cooperative_batch
        from mythril_tpu_torch.device import is_device_fault

        t0 = time.perf_counter()
        try:
            with _otrace.span("service.warmup", cat="service"):
                run_cooperative_batch(
                    [("warmup", _WARMUP_CODE)],
                    transaction_count=1,
                    execution_timeout=5,
                    isolate_errors=True,
                    device=self._ctx.device,
                )
        except Exception as exc:
            if is_device_fault(exc):
                raise
            log.exception("service warmup failed; continuing cold")
        self._scope_reset()
        log.info("service warmup done in %.2fs", time.perf_counter() - t0)

    # -- submission API (any thread) -----------------------------------

    def submit(
        self,
        code,
        name: Optional[str] = None,
        tier: str = TIER_BATCH,
        options: Optional[AnalysisOptions] = None,
        tenant: Optional[str] = None,
    ) -> Tuple[AnalysisRequest, ResultStream, bool]:
        """Queue one contract; returns ``(request, stream, deduped)``.

        Raises ``AdmissionRejected`` when the scheduling policy refuses
        the submission (tenant quota, load shed)."""
        if self._draining or not self._started:
            raise RuntimeError("service is not accepting submissions")
        if tier not in (TIER_BATCH, TIER_INTERACTIVE):
            raise ValueError(f"unknown tier {tier!r}")
        # refuse a nonsense coverage bar at submit, before any budget burns
        validate_coverage_target(
            (options or self.config.default_options).coverage_target
        )
        raw = normalize_code(code)
        codehash = canonical_codehash(raw)
        request = AnalysisRequest(
            request_id=f"r{next(self._ids):06d}",
            name=name or codehash[:10],
            code=raw,
            codehash=codehash,
            options=options or self.config.default_options,
            tier=tier,
            tenant=tenant,
        )
        # register with telemetry BEFORE admission: once admitted the
        # worker may finalize the request at any moment, and finalize of
        # an unregistered request would be dropped
        self.telemetry.request_started(request)
        if self._inject_submit_sleep > 0:
            time.sleep(self._inject_submit_sleep)
        try:
            stream, deduped = self.admission.submit(request)
        except AdmissionRejected:
            self.telemetry.request_finished(request, "rejected")
            # termination attribution: a shed request is a path-set that
            # never got to explore — mirror-only (the scoped ledger
            # belongs to the engine's analysis scope, which a rejected
            # request never enters)
            self._c_term.inc("shed")
            self._c_term_total.inc()
            raise
        key = (request.codehash, request.options.key())
        self._register_rid(request.request_id, key)
        if deduped:
            self.telemetry.request_deduped(request)
            if stream.closed:
                # pure replay of a cached result: no flight will ever
                # reference this request again — finalize it now, with
                # the replayed issue set (it WAS delivered to this
                # tenant, so it counts toward their accounting)
                events = self.admission.cached_events(key)
                issues = next(
                    (p.get("issues", []) for k, p in events if k == "done"),
                    [],
                )
                self.telemetry.request_finished(
                    request,
                    events[-1][0] if events else "done",
                    n_issues=len(issues),
                    digests=[issue_digest(i) for i in issues],
                    deduped=True,
                    replayed=True,
                )
        return request, stream, deduped

    def _register_rid(self, request_id: str, key: Tuple) -> None:
        flight = self.admission.flight_for(key)
        with self._rid_lock:
            self._by_rid[request_id] = (key, flight)
            while len(self._by_rid) > _RID_REGISTRY_CAP:
                self._by_rid.popitem(last=False)

    def poll(self, request_id: str, cursor: int = 0,
             wait_s: float = 0.0) -> Dict[str, Any]:
        """Long-poll subscribe: events past ``cursor`` for a submitted
        request, blocking up to ``wait_s`` for the first new one.

        Returns ``{"events": [(kind, payload), ...], "cursor": int,
        "closed": bool}``.  An idle subscriber costs the service nothing
        between polls — no handler thread, no worker, no stream queue.
        Raises ``KeyError`` for an unknown (or long-evicted) request id.
        """
        with self._rid_lock:
            entry = self._by_rid.get(request_id)
        if entry is None:
            raise KeyError(f"unknown request id {request_id!r}")
        key, flight = entry
        if flight is not None:
            events, new_cursor, closed = flight.poll(
                cursor, min(max(wait_s, 0.0), 120.0)
            )
        else:
            cached = self.admission.cached_events(key)
            events = cached[cursor:]
            new_cursor = cursor + len(events)
            closed = bool(cached) and new_cursor >= len(cached)
        return {"events": events, "cursor": new_cursor, "closed": closed}

    def worker_stats(self) -> List[Dict[str, Any]]:
        """Per-worker rows for stats()/``myth top`` (pool or inline).

        Pool rows are pool liveness state joined with the fleet fold:
        phase-time percentiles, prefilter kill rate, and the request ids
        the worker is serving right now."""
        pool = self._pool
        if pool is not None:
            with self._jobs_lock:
                active: Dict[int, List[str]] = {}
                for job in self._jobs.values():
                    rids = [
                        f.requests[0].request_id for f in job["batch"]
                    ]
                    active.setdefault(job["worker"], []).extend(rids)
            rows = pool.stats()
            for row in rows:
                row["active_rids"] = active.get(row["id"], [])
                fleet = self.fleet.worker_summary(row["id"])
                for key in ("phase_s", "prefilter", "device", "flushes",
                            "flush_age_s"):
                    if key in fleet:
                        row[key] = fleet[key]
            return rows
        return [{
            "id": 0,
            "pid": os.getpid(),
            "state": "inline",
            "job": None,
            "batches": int(self._c_batches.snapshot() or 0),
            "restarts": 0,
            "age_s": 0.0,
        }]

    def stats(self) -> Dict[str, Any]:
        reg = get_registry()
        out = dict(self.admission.depths())
        for name in (
            "service.requests", "service.dedup_hits", "service.replay_hits",
            "service.admitted", "service.batches", "service.streamed_issues",
            "service.request_errors", "service.probe_wins",
            "service.device_wins", "service.probe_runs",
            "service.prefilter_evaluated", "service.prefilter_killed",
            "service.devsolver_admitted", "service.devsolver_decided_sat",
            "service.devsolver_decided_unsat", "service.devsolver_unknown",
            "service.devsolver_model_validation_failures",
            "service.worker_restarts", "service.shed_total",
            "service.quota_rejections", "service.result_store_hits",
        ):
            out[name] = reg.counter(name, persistent=True).snapshot()
        pf_eval = out["service.prefilter_evaluated"] or 0
        out["prefilter"] = {
            "evaluated": pf_eval,
            "killed": out["service.prefilter_killed"] or 0,
            "kill_rate": round(
                (out["service.prefilter_killed"] or 0) / pf_eval, 4
            ) if pf_eval else 0.0,
        }
        ds_adm = out["service.devsolver_admitted"] or 0
        ds_dec = (out["service.devsolver_decided_sat"] or 0) + (
            out["service.devsolver_decided_unsat"] or 0)
        out["devsolver"] = {
            "admitted": ds_adm,
            "decided_sat": out["service.devsolver_decided_sat"] or 0,
            "decided_unsat": out["service.devsolver_decided_unsat"] or 0,
            "unknown": out["service.devsolver_unknown"] or 0,
            "model_validation_failures": out[
                "service.devsolver_model_validation_failures"] or 0,
            "decide_rate": round(ds_dec / ds_adm, 4) if ds_adm else 0.0,
        }
        # adaptive steering rollup: persistent mirrors of the scoped
        # adaptive.* counters, plus the most recent coverage-stop verdict
        flips_planned = int(
            self._c_adaptive["flips_planned"].snapshot() or 0
        )
        flips_hit = int(self._c_adaptive["flips_hit"].snapshot() or 0)
        out["adaptive"] = {
            "plans": int(self._c_adaptive["plans"].snapshot() or 0),
            "resteered_slots": int(
                self._c_adaptive["resteered_slots"].snapshot() or 0
            ),
            "requeued_paths": int(
                self._c_adaptive["requeued_paths"].snapshot() or 0
            ),
            "flips_planned": flips_planned,
            "flips_hit": flips_hit,
            "flip_hit_rate": round(flips_hit / flips_planned, 4)
            if flips_planned else 0.0,
            "plateau_stops": int(
                self._c_adaptive["plateau_stops"].snapshot() or 0
            ),
            "coverage_stop": self._last_coverage_stop,
        }
        from mythril_tpu_torch.observability.exploration import TERM_CLASSES

        term_snap = self._c_term.snapshot()
        terminated = {c: int(term_snap.get(c, 0)) for c in TERM_CLASSES}
        term_total = int(self._c_term_total.snapshot() or 0)
        out["exploration"] = {
            "terminated": terminated,
            "terminated_total": term_total,
            "partition_ok": sum(terminated.values()) == term_total,
            "pc_overflow": int(self._c_pc_overflow.snapshot() or 0),
            "coverage_pct": {
                h[:10]: pct for h, pct in self._coverage_by_hash.items()
            },
            "coverage_pct_reachable": {
                h[:10]: pct
                for h, pct in self._coverage_reach_by_hash.items()
            },
        }
        # static-gate health: self-disable reasons + the reachable-edge
        # oracle's aggregate (daemon-local registry view; `myth top`
        # renders a WARN line when any self-disable occurred)
        from mythril_tpu_torch.observability import get_registry as _get_reg

        _reg = _get_reg()
        out["staticpass"] = {
            "gate_disabled": dict(_reg.labeled_counter(
                "staticpass.gate_disabled", label_name="reason"
            ).snapshot()),
            "reachable_edge_pct": _reg.gauge(
                "staticpass.reachable_edge_pct"
            ).snapshot(),
        }
        # large-code frontier: pad economics + paging pressure (local
        # registry view — per-run scoped, so this reflects the most
        # recent analysis in inline mode)
        out["frontier"] = {
            "bucket_classes": _reg.gauge(
                "frontier.bucket_classes").snapshot() or 0,
            "pad_waste_pct": _reg.gauge(
                "frontier.pad_waste_pct").snapshot() or 0.0,
            "pad_waste_single_bucket_pct": _reg.gauge(
                "frontier.pad_waste_single_bucket_pct").snapshot() or 0.0,
            "page_faults": _reg.counter(
                "frontier.page_faults").snapshot() or 0,
            "page_repacks": _reg.counter(
                "frontier.page_repacks").snapshot() or 0,
            "page_resident_pct": _reg.gauge(
                "frontier.page_resident_pct").snapshot() or 100.0,
        }
        requests = out["service.requests"] or 0
        out["cache"] = {
            "dedup_hit_rate": round(out["service.dedup_hits"] / requests, 4)
            if requests else 0.0,
            "replay_hit_rate": round(out["service.replay_hits"] / requests, 4)
            if requests else 0.0,
        }
        out["workers"] = self.worker_stats()
        out["device"] = self._device_stats()
        policy = self.config.scheduler_policy()
        if policy is not None:
            out["scheduler"] = {
                "tenant_quota": policy.max_pending_per_tenant,
                "shed_queue_depth": policy.shed_queue_depth,
                "age_priority_s": policy.age_priority_s,
            }
        out["phases"] = self.telemetry.phase_stats()
        out["tenants"] = self.telemetry.tenant_stats()
        out["inflight_requests"] = self.telemetry.active_requests()
        if self.watchtower is not None:
            out["health"] = self.watchtower.health()
        hb = get_heartbeat()
        dropped = hb.dropped_sources()
        if dropped:
            out["heartbeat"] = {
                "sources_dropped": dropped,
                "source_errors": hb.source_error_counts(),
            }
        # "fleet" = this daemon aggregates worker processes; "daemon" =
        # everything in-process (pre-fabric shape, inline worker)
        out["scope"] = "fleet" if self.pooled else "daemon"
        if self.pooled:
            out["fleet"] = self.fleet.summary()
        return out

    def _device_stats(self) -> Dict[str, Any]:
        """The stats payload's ``device`` block.

        Inline mode reads the local registry (the engine runs in this
        process); pooled mode folds the fleet rollup, where the workers'
        ``device.*`` series land via the fabric.
        """
        from mythril_tpu_torch.observability.deviceplane import device_meta

        if not self.pooled:
            return device_meta()
        with self.fleet._lock:
            roll = self.fleet._rollup
            out: Dict[str, Any] = {
                "enabled": True,
                "scope": "fleet",
                "compile_wall_s": round(float(
                    roll.counters.get("device.compile_wall_s_total", 0)), 3),
                "recompiles": int(
                    roll.counters.get("device.recompiles_total", 0)),
                "shape_churn": int(
                    roll.counters.get("device.shape_churn_total", 0)),
                "cache": {
                    "hits": int(roll.counters.get("device.cache_hits", 0)),
                    "misses": int(
                        roll.counters.get("device.cache_misses", 0)),
                },
            }
            by_bucket = roll.labeled.get("device.compile_wall_s_by_bucket")
            if by_bucket:
                out["compile_wall_s_by_bucket"] = {
                    k: round(float(v), 3)
                    for k, v in sorted(by_bucket.items())
                }
            hbm = roll.gauges.get("device.hbm_bytes")
            if isinstance(hbm, dict) and hbm:
                out["hbm_bytes"] = dict(hbm)
            flops = roll.gauges.get("device.flops_per_segment")
            if isinstance(flops, dict) and flops:
                out["flops_per_segment"] = dict(flops)
            return out

    def fleet_prometheus_text(self) -> str:
        """Worker-labeled ``fleet_*`` exposition ("" when not pooled)."""
        return self.fleet.prometheus_text() if self.pooled else ""

    # -- inline worker (one thread owns the engine) --------------------

    def _worker_loop(self) -> None:
        """The inline worker.  A batch's exception errors its requests and
        the loop goes on, but a device fault (``device.is_device_fault``)
        stops the service: its batch's requests error naming the fault, no
        further batch runs in this process (its CUDA context may be
        unusable), submissions are refused, every flight still pending
        errors, and ``fault`` holds the exception."""
        from mythril_tpu_torch.device import is_device_fault

        cfg = self.config

        def _error_batch(batch, reason: str) -> None:
            for flight in batch:
                if not flight.finished:
                    flight.emit("error", reason)
                    self._c_errors.inc()
                self.admission.finish(flight)
                with flight.lock:
                    flight_requests = list(flight.requests)
                self._finish_requests(
                    flight, flight_requests, "error",
                    batch_width=len(batch),
                )

        def _stop_on(exc: BaseException) -> None:
            log.error("device fault: %r; the analysis service stops", exc)
            self.fault = exc
            self._draining = True  # reject new submissions

        if self.config.warmup:
            try:
                self._warmup()
            except Exception as exc:  # only a device fault leaves _warmup
                _stop_on(exc)
        self._warm_ready.set()
        while True:
            if not self.admission.wait_for_pending(timeout=0.1):
                if self._stop.is_set():
                    return
                continue
            if self.fault is not None:
                # stopped: what is still pending (or slipped past the
                # refusal) errors, and never reaches the device
                _error_batch(
                    self.admission.next_batch(cfg.max_batch_width),
                    f"service stopped by a device fault: {self.fault!r}",
                )
                continue
            # admission window: give compatible arrivals a moment to pile
            # into the same wide segment batch — unless an interactive
            # request is waiting (TTFE beats width) or we are draining
            self._admission_window(cfg)
            batch = self.admission.next_batch(cfg.max_batch_width)
            if not batch:
                continue
            try:
                self._run_batch(batch)
            except Exception as exc:
                if is_device_fault(exc):
                    _stop_on(exc)
                    _error_batch(batch, f"device fault: {exc!r}")
                    continue
                # any other exception never kills the worker
                log.exception("service batch failed")
                _error_batch(batch, f"batch failure: {exc!r}")

    def _admission_window(self, cfg: ServiceConfig) -> None:
        deadline = time.perf_counter() + cfg.batch_window_s
        while (
            time.perf_counter() < deadline
            and not self._draining
            and not self._stop.is_set()
            and not self.admission.has_interactive_pending()
        ):
            time.sleep(min(0.005, cfg.batch_window_s))

    def _scope_reset(self) -> None:
        if self._ctx is not None:
            self._ctx.reset_scope()
        else:  # pool mode touches no engine state in-process
            from mythril_tpu_torch.facade.warm import reset_analysis_scope

            reset_analysis_scope()

    def _make_sink(
        self,
        by_hash: Dict[str, Flight],
        streamed: Dict[Tuple, Set[Tuple]],
        source: str,
        lock: threading.Lock,
    ):
        """Issue-sink closure attributing confirmations to flights.

        Runs on whatever thread confirms the issue (worker, harvest
        replay workers), hence the explicit lock around the check-then-
        add on the per-flight streamed-digest sets.
        """
        provisional = source == "probe"

        def _sink(issues) -> None:
            for issue in issues:
                flight = by_hash.get(issue.bytecode_hash)
                if flight is None:
                    continue
                digest = issue_digest(issue)
                with lock:
                    if digest in streamed[flight.key]:
                        continue
                    streamed[flight.key].add(digest)
                wire = issue_to_wire(issue)
                if provisional:
                    wire["provisional"] = True
                flight.emit("issue", wire, source=source)
                self._c_streamed.inc()

        return _sink

    @contextlib.contextmanager
    def _account_prefilter(self):
        """Fold this scope's abstract pre-filter activity into the
        persistent service mirrors (the scoped counters reset per batch)."""
        delta: Dict[str, int] = {}
        try:
            with self._ctx.prefilter_delta(delta):
                yield
        finally:
            if delta.get("evaluated"):
                self._c_pf_eval.inc(delta["evaluated"])
            if delta.get("killed"):
                self._c_pf_kill.inc(delta["killed"])

    @contextlib.contextmanager
    def _account_devsolver(self):
        """Fold this scope's device-SAT-tier activity into the persistent
        service mirrors — same pattern as ``_account_prefilter``."""
        delta: Dict[str, int] = {}
        try:
            with self._ctx.devsolver_delta(delta):
                yield
        finally:
            self._fold_devsolver(delta)

    def _fold_devsolver(self, delta: Dict[str, int]) -> None:
        for name, counter in self._c_ds.items():
            if delta.get(name):
                counter.inc(delta[name])

    @contextlib.contextmanager
    def _account_exploration(self):
        """Fold this scope's exploration-ledger activity (termination
        classes, pc-overflow, per-contract coverage) into the persistent
        service mirrors — same pattern as ``_account_prefilter``."""
        delta: Dict[str, Any] = {}
        try:
            with self._ctx.exploration_delta(delta):
                yield
        finally:
            self._fold_exploration(delta)

    @contextlib.contextmanager
    def _account_adaptive(self, out: Dict[str, Any]):
        """Fold this scope's adaptive-controller activity into the
        persistent service mirrors — same pattern as
        ``_account_prefilter``.  ``out`` also carries the scope-end
        ``coverage_stop`` verdict to the caller (``_run_batch`` stamps
        it into the done payload)."""
        try:
            with self._ctx.adaptive_delta(out):
                yield
        finally:
            self._fold_adaptive(out)

    def _fold_adaptive(self, delta: Dict[str, Any]) -> None:
        if not delta:
            return
        for name, counter in self._c_adaptive.items():
            if delta.get(name):
                counter.inc(delta[name])
        if delta.get("coverage_stop"):
            self._last_coverage_stop = dict(delta["coverage_stop"])

    def _fold_exploration(self, delta: Dict[str, Any]) -> None:
        """Merge one batch's exploration delta (inline scope or a pool
        worker's done payload) into the persistent mirrors."""
        if not delta:
            return
        for cls, n in (delta.get("terminated") or {}).items():
            if n:
                self._c_term.inc(cls, n)
                self._c_term_total.inc(n)
        if delta.get("pc_overflow"):
            self._c_pc_overflow.inc(delta["pc_overflow"])
        for codehash, pct in (delta.get("coverage_pct") or {}).items():
            self._coverage_by_hash[codehash] = pct
            self._coverage_by_hash.move_to_end(codehash)
        while len(self._coverage_by_hash) > _RID_REGISTRY_CAP:
            self._coverage_by_hash.popitem(last=False)
        for codehash, pct in (
            delta.get("coverage_pct_reachable") or {}
        ).items():
            self._coverage_reach_by_hash[codehash] = pct
            self._coverage_reach_by_hash.move_to_end(codehash)
        while len(self._coverage_reach_by_hash) > _RID_REGISTRY_CAP:
            self._coverage_reach_by_hash.popitem(last=False)
        if self._coverage_by_hash:
            # registry mirror of the rolling average: the watchtower's
            # coverage-floor objective reads it from the history
            vals = self._coverage_by_hash.values()
            self._g_coverage.set(round(sum(vals) / len(vals), 3))
        if self._coverage_reach_by_hash:
            vals = self._coverage_reach_by_hash.values()
            self._g_coverage_reach.set(round(sum(vals) / len(vals), 3))

    def _coverage_of(self, codehash: str) -> Optional[float]:
        return self._coverage_by_hash.get(codehash)

    def _run_batch(self, batch: List[Flight]) -> None:
        from mythril_tpu_torch.analysis.cooperative import run_cooperative_batch
        from mythril_tpu_torch.support.support_args import args as engine_args

        t0 = time.perf_counter()
        self._c_batches.inc()
        self._h_width.observe(float(len(batch)))
        by_hash = {f.codehash: f for f in batch}
        streamed: Dict[Tuple, Set[Tuple]] = {f.key: set() for f in batch}
        sink_lock = threading.Lock()
        request_ids = [f.requests[0].request_id for f in batch]
        opts: AnalysisOptions = batch[0].options
        tel = self.telemetry
        self._stamp_batch(batch, None, "batch_wait")
        # one trace flow id per primary request; the frontier emits the
        # "f" endpoints inside its first segment span, the matching "s"
        # endpoints ride each request's span tree at terminal time
        flow_cb = tel.batch_flow_callback(request_ids)

        with _otrace.span(
            "service.batch", cat="service", width=len(batch),
            requests=",".join(request_ids),
        ):
            self._scope_reset()
            if self.config.probe:
                for flight in batch:
                    if flight.interactive and not flight.finished:
                        self._probe(flight, by_hash, streamed, sink_lock)
                # the probe ran detectors: sweep their issue lists and
                # (address, codehash) caches so the authoritative batch
                # re-detects everything it would have found solo
                self._scope_reset()

            self._stamp_batch(batch, "execute0", "execute")
            adaptive_out: Dict[str, Any] = {}
            with self._account_prefilter(), self._account_devsolver(), \
                    self._account_exploration(), \
                    self._account_adaptive(adaptive_out), \
                    self._ctx.sink_scope(
                self._make_sink(by_hash, streamed, "device", sink_lock)
            ):
                # the coverage-target contract rides the engine-global
                # args (the frontier/svm loops poll it mid-run); scoped
                # to this batch, restored before the next one
                prev_target = engine_args.coverage_target
                engine_args.coverage_target = opts.coverage_target
                try:
                    issues_by_name, errors_by_name, _states = run_cooperative_batch(
                        [(f.codehash, f.requests[0].code) for f in batch],
                        transaction_count=opts.transaction_count,
                        modules=list(opts.modules) if opts.modules else None,
                        strategy=opts.strategy,
                        execution_timeout=opts.execution_timeout,
                        isolate_errors=True,
                        request_tags=request_ids,
                        request_flow_cb=flow_cb,
                        device=self._ctx.device,
                    )
                finally:
                    engine_args.coverage_target = prev_target
            self._stamp_batch(batch, "execute1", "stream")

        elapsed = time.perf_counter() - t0
        exec0 = batch[0].requests[0].stamps.get("execute0", t0)
        exec1 = batch[0].requests[0].stamps.get("execute1", exec0)
        device_wall = max(exec1 - exec0, 0.0)
        wires_by_hash = {
            f.codehash: [
                issue_to_wire(i) for i in issues_by_name.get(f.codehash, [])
            ]
            for f in batch
        }
        coverage_target_met = None
        if opts.coverage_target is not None:
            stop = adaptive_out.get("coverage_stop")
            coverage_target_met = bool(
                stop and stop.get("coverage_target_met")
            )
        self._finalize_batch(
            batch, streamed, wires_by_hash, dict(errors_by_name),
            elapsed=elapsed, device_wall=device_wall, sink_lock=sink_lock,
            coverage_target=opts.coverage_target,
            coverage_target_met=coverage_target_met,
        )
        log.info(
            "service batch of %d done in %.2fs (%d errored)",
            len(batch), elapsed, len(errors_by_name),
        )

    def _finalize_batch(
        self,
        batch: List[Flight],
        streamed: Dict[Tuple, Set[Tuple]],
        wires_by_hash: Dict[str, List[Dict[str, Any]]],
        errors_by_hash: Dict[str, str],
        *,
        elapsed: float,
        device_wall: float,
        sink_lock: Optional[threading.Lock] = None,
        coverage_target: Optional[float] = None,
        coverage_target_met: Optional[bool] = None,
    ) -> None:
        """Shared terminal path for inline batches and pool jobs:
        stream any late findings, emit terminal events, retire flights,
        finalize telemetry."""
        sink_lock = sink_lock or threading.Lock()
        for flight in batch:
            with flight.lock:
                flight_requests = list(flight.requests)
            # device wall attributed evenly: by flight, then by the
            # requests sharing the flight
            share = device_wall / len(batch) / max(len(flight_requests), 1)
            if flight.codehash in errors_by_hash:
                flight.emit("error", errors_by_hash[flight.codehash])
                self._c_errors.inc()
                self.admission.finish(flight)
                self._finish_requests(
                    flight, flight_requests, "error",
                    batch_width=len(batch), compute_share=share,
                )
                continue
            wires = wires_by_hash.get(flight.codehash, [])
            # stream anything end-of-batch collection found that the sink
            # did not see mid-run (POST modules, late confirmations)
            for wire in wires:
                digest = issue_digest(wire)
                with sink_lock:
                    fresh = digest not in streamed[flight.key]
                    if fresh:
                        streamed[flight.key].add(digest)
                if fresh:
                    flight.emit("issue", wire, source="device")
                    self._c_streamed.inc()
            if flight.interactive and flight.first_issue_source is not None:
                (self._c_probe_wins if flight.first_issue_source == "probe"
                 else self._c_device_wins).inc()
            done_payload: Dict[str, Any] = {
                "codehash": flight.codehash,
                "issues": wires,
                "elapsed_s": round(elapsed, 3),
                "batch_width": len(batch),
            }
            if coverage_target is not None:
                done_payload["coverage_target"] = coverage_target
                done_payload["coverage_target_met"] = bool(
                    coverage_target_met
                )
            flight.emit("done", done_payload)
            self.admission.finish(flight)
            self._finish_requests(
                flight, flight_requests, "done",
                n_issues=len(wires),
                digests=[issue_digest(w) for w in wires],
                batch_width=len(batch), compute_share=share,
                coverage_target_met=coverage_target_met,
            )

    def _stamp_batch(self, batch: List[Flight], stamp: Optional[str],
                     phase: str) -> None:
        """Stamp every request on every flight at a phase boundary."""
        now = time.perf_counter()
        for flight in batch:
            with flight.lock:
                requests = list(flight.requests)
            for req in requests:
                if stamp is not None:
                    req.stamps.setdefault(stamp, now)
                self.telemetry.set_phase(req, phase)

    def _finish_requests(self, flight: Flight,
                         requests: List[AnalysisRequest], event: str,
                         *, n_issues: int = 0, digests=None,
                         batch_width: Optional[int] = None,
                         compute_share: float = 0.0,
                         coverage_target_met: Optional[bool] = None) -> None:
        primary = flight.requests[0]
        coverage_pct = self._coverage_of(flight.codehash)
        coverage_pct_reachable = self._coverage_reach_by_hash.get(
            flight.codehash
        )
        for req in requests:
            self.telemetry.request_finished(
                req, event,
                n_issues=n_issues, digests=digests,
                batch_width=batch_width, compute_share=compute_share,
                deduped=req is not primary,
                coverage_pct=coverage_pct,
                coverage_pct_reachable=coverage_pct_reachable,
                coverage_target_met=coverage_target_met,
            )

    def _probe(
        self,
        flight: Flight,
        by_hash: Dict[str, Flight],
        streamed: Dict[Tuple, Set[Tuple]],
        sink_lock: threading.Lock,
    ) -> None:
        """Bounded host-first 1-tx pre-analysis for an interactive flight.

        Runs with the frontier off and the host probe backend, so first
        evidence never waits on a cold kernel build.  Findings are
        provisional (1-tx is a subset of the authoritative run); the
        per-flight streamed-digest set spans probe AND batch, so a
        confirmed probe finding is not re-streamed by the device pass.
        A device fault propagates; any other failure leaves the batch to
        run.
        """
        from mythril_tpu_torch.analysis.cooperative import run_cooperative_batch
        from mythril_tpu_torch.device import is_device_fault

        self._c_probe_runs.inc()
        opts = flight.options
        t0 = time.perf_counter()
        try:
            with _otrace.span(
                "service.probe", cat="service",
                request=flight.requests[0].request_id,
            ), self._account_prefilter(), self._account_devsolver(), \
                    self._ctx.probe_scope(), \
                    self._ctx.sink_scope(
                        self._make_sink(by_hash, streamed, "probe", sink_lock)
                    ):
                # quick triage: the abstract pre-filter sits in the solver
                # fast path, so the host-first probe gets its near-free
                # UNSAT verdicts before any exact solve
                run_cooperative_batch(
                    [(flight.codehash, flight.requests[0].code)],
                    transaction_count=1,
                    modules=list(opts.modules) if opts.modules else None,
                    strategy=opts.strategy,
                    execution_timeout=min(
                        self.config.probe_timeout_s, opts.execution_timeout
                    ),
                    isolate_errors=True,
                    device=self._ctx.device,
                )
        except Exception as exc:
            if is_device_fault(exc):
                raise
            log.exception("interactive probe failed; batch continues")
        self._h_probe.observe(time.perf_counter() - t0)

    # -- pool mode (admission plane side) ------------------------------

    def _pool_dispatch_loop(self) -> None:
        """Dispatcher thread: admit batches and hand them to idle
        worker processes.  The engine never runs on this thread — the
        admission plane stays thin."""
        pool = self._pool
        if not pool.wait_ready(timeout=600):
            log.warning("worker pool not fully ready after 600s; "
                        "dispatching to whatever is")
        self._warm_ready.set()
        cfg = self.config
        while True:
            if not self.admission.wait_for_pending(timeout=0.1):
                if self._stop.is_set():
                    return
                continue
            handle = pool.acquire(timeout=0.5)
            if handle is None:
                if self._stop.is_set():
                    return
                continue
            self._admission_window(cfg)
            batch = self.admission.next_batch(cfg.max_batch_width)
            if not batch:
                pool.release(handle)
                continue
            self._dispatch_batch(handle, batch)

    def _dispatch_batch(self, handle, batch: List[Flight]) -> None:
        pool = self._pool
        job_id = pool.new_job_id()
        self._c_batches.inc()
        self._h_width.observe(float(len(batch)))
        self._stamp_batch(batch, None, "batch_wait")
        with self._jobs_lock:
            self._jobs[job_id] = {
                "batch": batch,
                "by_hash": {f.codehash: f for f in batch},
                "streamed": {f.key: set() for f in batch},
                "t0": time.perf_counter(),
                "worker": handle.id,
            }
        self._stamp_batch(batch, "execute0", "execute")
        pool.dispatch(
            handle, job_id,
            [
                {
                    "codehash": f.codehash,
                    "code": f.requests[0].code,
                    "request_id": f.requests[0].request_id,
                    "tier": f.tier,
                }
                for f in batch
            ],
            batch[0].options.to_dict(),
        )

    def _on_worker_event(self, msg: tuple) -> None:
        """Pump-thread callback: multiplex worker events onto flights.

        The port's ``device_fault`` is a worker's answer to the batch a
        device fault struck: its requests error with the fault, and the
        worker, told to stop, exits; the pool's liveness monitor then
        counts the restart and respawns it with a fresh CUDA context."""
        kind = msg[0]
        if kind == "issue":
            _, _wid, job_id, codehash, wire, source = msg
            with self._jobs_lock:
                job = self._jobs.get(job_id)
            if job is None:
                return
            flight = job["by_hash"].get(codehash)
            if flight is None:
                return
            digest = issue_digest(wire)
            seen = job["streamed"][flight.key]
            if digest in seen:
                return
            seen.add(digest)
            flight.emit("issue", wire, source=source)
            self._c_streamed.inc()
        elif kind == "done":
            _, _wid, job_id, payload = msg
            with self._jobs_lock:
                job = self._jobs.pop(job_id, None)
            if job is None:
                return
            self._finalize_pool_job(job, payload)
        elif kind == "device_fault":
            _, wid, job_id, payload = msg
            with self._jobs_lock:
                job = self._jobs.pop(job_id, None)
            pool = self._pool
            if pool is not None:
                pool.handles[wid].job_q.put(("stop",))
            if job is not None:
                self._finalize_pool_job(job, payload)
        elif kind == "telemetry":
            _, wid, payload = msg
            self.fleet.apply(wid, payload)
        elif kind == "flight_bundle":
            _, wid, bundle_id, bundle = msg
            self._write_worker_bundle(wid, bundle_id, bundle)
        elif kind == "profiled":
            _, _wid, profile_id, result = msg
            with self._profile_lock:
                waiter = self._profile_waits.pop(profile_id, None)
            if waiter is not None:
                waiter["result"] = result
                waiter["event"].set()
        elif kind == "worker_died":
            _, wid, job_id, pid = msg
            self._c_restarts.inc()
            job = None
            if job_id is not None:
                with self._jobs_lock:
                    job = self._jobs.pop(job_id, None)
            self._fail_pool_job(job, wid, pid)

    def _finalize_pool_job(self, job: Dict[str, Any],
                           payload: Dict[str, Any]) -> None:
        batch: List[Flight] = job["batch"]
        self._stamp_batch(batch, "execute1", "stream")
        elapsed = time.perf_counter() - job["t0"]
        pf = payload.get("prefilter") or {}
        if pf.get("evaluated"):
            self._c_pf_eval.inc(pf["evaluated"])
        if pf.get("killed"):
            self._c_pf_kill.inc(pf["killed"])
        self._fold_devsolver(payload.get("devsolver") or {})
        self._fold_exploration(payload.get("exploration") or {})
        adaptive = payload.get("adaptive") or {}
        self._fold_adaptive(adaptive)
        for wall in payload.get("probe_s") or []:
            self._c_probe_runs.inc()
            self._h_probe.observe(wall)
        target = batch[0].options.coverage_target
        met = None
        if target is not None:
            stop = adaptive.get("coverage_stop")
            met = bool(stop and stop.get("coverage_target_met"))
        self._finalize_batch(
            batch, job["streamed"],
            payload.get("issues") or {},
            payload.get("errors") or {},
            elapsed=elapsed,
            device_wall=float(payload.get("elapsed_s") or 0.0),
            coverage_target=target,
            coverage_target_met=met,
        )
        log.info(
            "pool job on worker %d: batch of %d done in %.2fs (%d errored)",
            job["worker"], len(batch), elapsed,
            len(payload.get("errors") or {}),
        )

    def _fail_pool_job(self, job: Optional[Dict[str, Any]], wid: int,
                       pid) -> None:
        """Worker-crash containment: error ONLY the dead worker's
        in-flight requests (nothing is requeued silently), leave a
        flight-recorder bundle naming them, and let the pool respawn."""
        lost_rids: List[str] = []
        if job is not None:
            batch: List[Flight] = job["batch"]
            reason = f"worker {wid} (pid {pid}) died mid-batch"
            for flight in batch:
                with flight.lock:
                    flight_requests = list(flight.requests)
                lost_rids.extend(r.request_id for r in flight_requests)
                if not flight.finished:
                    flight.emit("error", reason)
                    self._c_errors.inc()
                self.admission.finish(flight)
                self._finish_requests(
                    flight, flight_requests, "error",
                    batch_width=len(batch),
                )
        log.error("worker %d (pid %s) crashed; lost requests: %s",
                  wid, pid, ",".join(lost_rids) or "none")
        rec = get_flight_recorder()
        if rec is not None:
            try:
                rec.dump("service.worker_crash", extra={
                    "worker": wid,
                    "pid": pid,
                    "lost_requests": lost_rids,
                })
            except Exception:
                log.exception("flight-recorder dump failed after crash")

    # -- fleet observability (bundle fan-out + profiler windows) -------

    def _fanout_bundles(self, reason: str, path: str,
                        bundle: Dict[str, Any]) -> None:
        """Dump listener: ask every live worker for a linked bundle.

        Replies arrive asynchronously as ``flight_bundle`` events on the
        pool multiplex; ``_write_worker_bundle`` files them next to the
        daemon bundle with the shared ``bundle_id``.
        """
        pool = self._pool
        if pool is None:
            return
        bundle_id = bundle.get("bundle_id") or f"{os.getpid()}-0"
        reached = pool.broadcast_control(("bundle", bundle_id, reason))
        log.info("flight dump %s fanned out to workers %s",
                 bundle_id, reached)

    def _write_worker_bundle(self, wid, bundle_id: str,
                             bundle: Dict[str, Any]) -> None:
        rec = get_flight_recorder()
        out_dir = rec.out_dir if rec is not None else (
            self.config.cache_root or tempfile.gettempdir()
        )
        reason = bundle.get("reason", "bundle")
        bundle["fleet"] = {
            "bundle_id": bundle_id,
            "worker": wid,
            "role": "worker",
            "daemon_pid": os.getpid(),
        }
        try:
            os.makedirs(out_dir, exist_ok=True)
            path = os.path.join(
                out_dir, f"flight-{reason}-w{wid}-{bundle_id}.json"
            )
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(bundle, f, indent=1, default=repr)
            os.replace(tmp, path)
            if rec is not None:
                rec.bundles.append(path)
            log.info("worker %s flight bundle: wrote %s", wid, path)
        except Exception:
            log.exception("failed to write worker %s bundle", wid)

    def profile(self, worker_id: int = 0, duration_s: float = 1.0,
                tag: Optional[str] = None) -> Dict[str, Any]:
        """Open a windowed ``torch.profiler`` capture inside one worker.

        The capture directory lands under ``--cache-root`` (or the
        system tempdir); ``tag`` prefixes its name — the watchtower
        stamps breach captures with the breaching objective so a 3 a.m.
        profile is attributable without cross-referencing logs.  Pool
        mode round-trips through the worker's control thread; inline
        mode profiles this process — the inline worker thread's device
        work is visible to the process-wide profiler.  Blocks for the
        window plus transport slack.
        """
        duration_s = min(max(float(duration_s), 0.05), 60.0)
        root = self.config.cache_root or tempfile.gettempdir()
        profile_id = next(self._profile_ids)
        stem = f"w{worker_id}-{profile_id}"
        if tag:
            stem = f"{_safe_tag(tag)}-{stem}"
        out_dir = os.path.join(root, "profiles", stem)
        pool = self._pool
        if pool is None:
            from mythril_tpu_torch.service.worker import _run_profile

            result = _run_profile(duration_s, out_dir, threading.Event())
            result["worker"] = worker_id
            return result
        waiter = {"event": threading.Event(), "result": None}
        with self._profile_lock:
            self._profile_waits[profile_id] = waiter
        if not pool.control(
            worker_id, ("profile", profile_id, duration_s, out_dir)
        ):
            with self._profile_lock:
                self._profile_waits.pop(profile_id, None)
            return {"ok": False, "worker": worker_id,
                    "error": f"worker {worker_id} is not reachable"}
        if not waiter["event"].wait(duration_s + 30.0):
            with self._profile_lock:
                self._profile_waits.pop(profile_id, None)
            return {"ok": False, "worker": worker_id,
                    "error": "profile window timed out"}
        result = dict(waiter["result"] or {})
        result["worker"] = worker_id
        return result


def _safe_tag(tag: str) -> str:
    """Reduce a capture tag to a filesystem-safe token."""
    return "".join(
        c if (c.isalnum() or c in "._-") else "-" for c in tag
    ) or "tagged"


# Backwards-compatible alias: the wire conversion moved to request.py so
# pool workers can import it without pulling the daemon module.
_issue_to_wire = issue_to_wire
