"""Worker protocol + process entry point for the horizontal worker pool.

One pool worker is a separate *process* (spawned, never forked: the
parent may hold a live CUDA context) running ``worker_main``.  Process
isolation is what makes N workers legal at all — the engine's
process-globals (flag singleton, issue sink, interned SMT terms,
detection caches) exist once per process, so each worker owns a private
``facade.warm.WorkerContext`` and no engine state is ever shared.  What
IS shared is on disk: the SMT query cache and the kernel build cache
under ``--cache-root`` (both concurrent-shard safe), plus the
completed-result LRU (``service/resultstore.py``).

Protocol (picklable tuples, first element is the kind):

daemon -> worker, over the worker's private job queue::

    ("batch", job_id, [flight_dict, ...], options_dict)
    ("stop",)

``flight_dict`` carries ``codehash``/``code``/``request_id``/``tier``;
``options_dict`` is ``AnalysisOptions.to_dict()`` plus the probe config.

daemon -> worker, over the worker's private *control* queue (drained by
a background control thread so a busy batch never blocks telemetry)::

    ("bundle",  bundle_id, reason)                 # flight-bundle request
    ("profile", profile_id, duration_s, out_dir)   # windowed torch.profiler

worker -> daemon, over the pool's shared event queue (every kind keeps
the worker id at index 1 — the pool's event pump keys liveness on it)::

    ("ready",   worker_id, pid)                                # warm, idle
    ("issue",   worker_id, job_id, codehash, wire, source)     # streamed
    ("done",    worker_id, job_id, payload)                    # terminal
    ("telemetry", worker_id, payload)              # fleet delta snapshot
    ("flight_bundle", worker_id, bundle_id, bundle_dict)
    ("profiled", worker_id, profile_id, result_dict)
    ("device_fault", worker_id, job_id, payload)   # the done keys; exits
    ("stopped", worker_id)

Telemetry rides the same multiplex as results, so per-producer FIFO
gives the daemon a worker's span/metric flush *before* the ``done`` it
describes — the fabric needs no second channel and no clock games
(``observability/fleet.py`` has the wire format).

``done.payload`` is the authoritative end-of-batch result:
``issues`` (codehash -> wire list), ``errors`` (codehash -> one-line
reason), ``elapsed_s``, ``prefilter`` (evaluated/killed deltas),
``devsolver`` (device-SAT-tier decide/fallthrough deltas),
``exploration`` (termination-class deltas + per-contract coverage),
``probe_s`` (per-probe walls) and ``first_source`` (codehash ->
probe|device).  A worker never sends a partial ``done``: a batch-level
crash inside the engine is converted to per-codehash errors, and a hard
kill (SIGKILL, OOM) sends nothing — the daemon's liveness monitor turns
that silence into per-request errors and a respawn (never a silent
requeue).

Event ordering: the mp queue preserves per-producer FIFO, so a job's
``issue`` events always precede its ``done`` on the daemon side —
exactly the replay-then-live contract ``Flight.emit`` needs.
"""

from __future__ import annotations

import logging
import os
import queue as queue_mod
import threading
import time
from typing import Any, Dict, List, Optional

from mythril_tpu_torch.service.codehash import issue_digest
from mythril_tpu_torch.service.request import AnalysisOptions, issue_to_wire

log = logging.getLogger(__name__)

__all__ = ["worker_config", "worker_main"]

#: telemetry flush cadence when the control thread is otherwise idle
DEFAULT_FLUSH_INTERVAL_S = 0.5

#: minimal STOP contract used to pull heavy imports during worker warmup
_WARMUP_CODE = bytes.fromhex("00")


def worker_config(service_config) -> Dict[str, Any]:
    """Picklable worker-process configuration from a ``ServiceConfig``.

    The workers re-derive the engine configuration from this dict via
    the same ``apply_analyzer_args`` path the daemon's inline worker
    uses, so an N-worker pool and a solo run configure identically.  The
    port's dict also carries ``ServiceConfig.device`` (None is the CUDA
    card, ``"cpu"`` the plain kernels).
    """
    opts = service_config.default_options
    return {
        "options": opts.to_dict(),
        # the port's own: the workers' device (None is the CUDA card)
        "device": service_config.device,
        "frontier": service_config.frontier,
        "cache_root": service_config.cache_root,
        "warmup": service_config.warmup,
        "probe": service_config.probe,
        "probe_timeout_s": service_config.probe_timeout_s,
        "trace": getattr(service_config, "trace", False),
        "heartbeat": service_config.heartbeat,
        "heartbeat_interval_s": service_config.heartbeat_interval_s,
        "flush_interval_s": getattr(
            service_config, "flush_interval_s", DEFAULT_FLUSH_INTERVAL_S
        ),
    }


def _make_context(config: Dict[str, Any]):
    """Build + arm this process's WorkerContext from the wire config, on
    the wire config's device."""
    from mythril_tpu_torch.facade.mythril_analyzer import AnalyzerArgs
    from mythril_tpu_torch.facade.warm import WorkerContext

    opts = AnalysisOptions.from_dict(config["options"])
    return WorkerContext(AnalyzerArgs(
        strategy=opts.strategy,
        transaction_count=opts.transaction_count,
        execution_timeout=opts.execution_timeout,
        modules=list(opts.modules) if opts.modules else None,
        frontier=config.get("frontier", False),
        cache_root=config.get("cache_root"),
    ), device=config.get("device")).configure()


def _make_sink(event_q, worker_id: int, job_id: int,
               streamed: Dict[str, set], source: str):
    """Issue-sink closure forwarding confirmations onto the event queue.

    The per-codehash streamed-digest sets span probe AND device phases
    of one job, so a finding the probe already streamed is not re-sent
    by the authoritative pass (the daemon keeps its own set as well —
    belt and braces across the process boundary).
    """
    provisional = source == "probe"

    def _sink(issues) -> None:
        for issue in issues:
            seen = streamed.get(issue.bytecode_hash)
            if seen is None:
                continue
            digest = issue_digest(issue)
            if digest in seen:
                continue
            seen.add(digest)
            wire = issue_to_wire(issue)
            if provisional:
                wire["provisional"] = True
            event_q.put(
                ("issue", worker_id, job_id, issue.bytecode_hash, wire,
                 source)
            )

    return _sink


def _run_job(ctx, worker_id: int, job_id: int,
             flights: List[Dict[str, Any]], options: Dict[str, Any],
             config: Dict[str, Any], event_q, publisher=None) -> None:
    """Run one admitted batch exactly as the inline worker would, on the
    context's device.  A device fault in the probe or the batch
    propagates (``worker_main`` answers the batch with it and exits)."""
    from mythril_tpu_torch.analysis.cooperative import run_cooperative_batch
    from mythril_tpu_torch.device import is_device_fault
    from mythril_tpu_torch.observability import get_registry, get_tracer

    opts = AnalysisOptions.from_dict(options)
    tracer = get_tracer()
    t0 = time.perf_counter()
    streamed: Dict[str, set] = {f["codehash"]: set() for f in flights}
    first_source: Dict[str, str] = {}
    probe_walls: List[float] = []
    prefilter: Dict[str, int] = {}
    devsolver: Dict[str, int] = {}
    exploration: Dict[str, Any] = {}
    adaptive: Dict[str, Any] = {}

    def _note_first(source):
        base = _make_sink(event_q, worker_id, job_id, streamed, source)

        def _sink(issues):
            for issue in issues:
                first_source.setdefault(issue.bytecode_hash, source)
            base(issues)

        return _sink

    ctx.reset_scope()
    with ctx.prefilter_delta(prefilter), \
            ctx.devsolver_delta(devsolver), \
            ctx.exploration_delta(exploration), \
            ctx.adaptive_delta(adaptive), \
            tracer.span("service.worker_batch", cat="service",
                        job=job_id, width=len(flights)):
        # flow.request arrows across the process seam: emit the "f"
        # endpoint inside the batch span (the slice serving the request)
        # and ship the fid -> request-id binding with the next flush so
        # the daemon can remap it onto the request's own flow id.  The
        # binding is noted BEFORE the event is recorded — no flush can
        # ship the span without its binding.
        if publisher is not None and tracer.enabled:
            for flight in flights:
                fid = tracer.new_flow_id()
                publisher.note_flow(fid, flight["request_id"])
                tracer.flow("f", fid, "flow.request", cat="service")
        if config.get("probe", True):
            for flight in flights:
                if flight.get("tier") != "interactive":
                    continue
                tp = time.perf_counter()
                try:
                    with ctx.probe_scope(), \
                            ctx.sink_scope(_note_first("probe")):
                        run_cooperative_batch(
                            [(flight["codehash"], flight["code"])],
                            transaction_count=1,
                            modules=list(opts.modules) if opts.modules
                            else None,
                            strategy=opts.strategy,
                            execution_timeout=min(
                                config.get("probe_timeout_s", 10),
                                opts.execution_timeout,
                            ),
                            isolate_errors=True,
                            device=ctx.device,
                        )
                except Exception as exc:
                    if is_device_fault(exc):
                        raise
                    log.exception("worker %d probe failed; batch continues",
                                  worker_id)
                probe_walls.append(time.perf_counter() - tp)
            if probe_walls:
                # the probe ran detectors: sweep their issue lists and
                # caches so the authoritative pass re-detects everything
                ctx.reset_scope()

        with ctx.sink_scope(_note_first("device")):
            # coverage-target contract rides the engine-global args for
            # the authoritative pass only (the probe stays budget-bound)
            from mythril_tpu_torch.support.support_args import args as engine_args

            prev_target = engine_args.coverage_target
            engine_args.coverage_target = opts.coverage_target
            try:
                issues_by_name, errors_by_name, _states = run_cooperative_batch(
                    [(f["codehash"], f["code"]) for f in flights],
                    transaction_count=opts.transaction_count,
                    modules=list(opts.modules) if opts.modules else None,
                    strategy=opts.strategy,
                    execution_timeout=opts.execution_timeout,
                    isolate_errors=True,
                    request_tags=[f["request_id"] for f in flights],
                    device=ctx.device,
                )
            finally:
                engine_args.coverage_target = prev_target

    elapsed = time.perf_counter() - t0
    # persistent: survives the per-batch analysis-scope sweep, so the
    # fleet's per-worker phase-time series accumulate across batches
    reg = get_registry()
    reg.histogram("worker.execute_s", persistent=True).observe(elapsed)
    for w in probe_walls:
        reg.histogram("worker.probe_s", persistent=True).observe(w)
    reg.counter("worker.batches", persistent=True).inc()
    if publisher is not None:
        # ship the batch's spans/metrics ahead of its "done" (FIFO)
        try:
            publisher.flush(event_q)
        except Exception:
            log.debug("worker %d telemetry flush failed", worker_id,
                      exc_info=True)

    event_q.put(("done", worker_id, job_id, {
        "issues": {
            f["codehash"]: [
                issue_to_wire(i)
                for i in issues_by_name.get(f["codehash"], [])
            ]
            for f in flights
        },
        "errors": dict(errors_by_name),
        "elapsed_s": round(elapsed, 6),
        "prefilter": dict(prefilter),
        "devsolver": dict(devsolver),
        "exploration": dict(exploration),
        "adaptive": dict(adaptive),
        "probe_s": probe_walls,
        "first_source": first_source,
    }))


def _run_profile(duration_s: float, out_dir: str,
                 stop_ev: threading.Event) -> Dict[str, Any]:
    """Windowed ``torch.profiler`` capture; always returns a result dict.

    The JAX package's window is ``jax.profiler``'s trace directory; the
    port's records this process's CPU activity (and the card's, where one
    is visible) for the window and writes it as a Chrome trace,
    ``<out_dir>/trace.json``.  The result dict is the JAX package's."""
    t0 = time.perf_counter()
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile

        os.makedirs(out_dir, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        try:
            # stop_ev short-circuits the window on worker shutdown
            stop_ev.wait(min(max(float(duration_s), 0.05), 60.0))
        finally:
            prof.stop()
        prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
        return {
            "ok": True,
            "dir": out_dir,
            "duration_s": round(time.perf_counter() - t0, 3),
        }
    except Exception as e:
        return {"ok": False, "error": repr(e), "dir": out_dir}


def _control_loop(worker_id: int, config: Dict[str, Any], control_q,
                  event_q, publisher, stop_ev: threading.Event) -> None:
    """Background thread: periodic telemetry flush + control verbs.

    Runs beside the batch loop so a long-running batch still ships
    deltas, answers flight-bundle fan-outs (``sys._current_frames``
    captures the busy main thread mid-batch), and opens profiler
    windows.  Pure observer: it never touches the WorkerContext, so it
    cannot perturb issue digests.
    """
    interval = float(config.get("flush_interval_s",
                                DEFAULT_FLUSH_INTERVAL_S))
    while not stop_ev.is_set():
        try:
            msg = control_q.get(timeout=interval)
        except queue_mod.Empty:
            msg = None
        except (EOFError, OSError):
            break
        if isinstance(msg, tuple) and msg:
            kind = msg[0]
            if kind == "bundle":
                from mythril_tpu_torch.observability.flightrecorder import (
                    build_bundle,
                )

                _, bundle_id, reason = msg
                try:
                    bundle = build_bundle(reason)
                except Exception as e:
                    bundle = {"reason": reason, "pid": os.getpid(),
                              "error": repr(e)}
                event_q.put(
                    ("flight_bundle", worker_id, bundle_id, bundle)
                )
            elif kind == "profile":
                _, profile_id, duration_s, out_dir = msg
                event_q.put(("profiled", worker_id, profile_id,
                             _run_profile(duration_s, out_dir, stop_ev)))
        try:
            publisher.flush(event_q)
        except (EOFError, OSError, ValueError):
            break
        except Exception:
            log.debug("worker %d telemetry flush failed", worker_id,
                      exc_info=True)


def worker_main(worker_id: int, config: Dict[str, Any],
                job_q, event_q, control_q=None) -> None:
    """Entry point of one pool worker process (spawn target).

    Configures this process's engine from ``config``, optionally runs a
    warmup analysis, then serves batch jobs until a ``stop`` message.
    Every failure mode that leaves the process alive is converted into
    job-scoped errors; only a hard kill is left for the daemon's
    liveness monitor.

    A device fault (``device.is_device_fault``) is the exception: the
    process's CUDA context may be unusable after it, so the worker answers
    its batch with a ``device_fault`` event (each request's error names the
    fault), waits for the daemon to take it, and exits with code 1; the
    pool respawns it with a fresh context.  A fault in the configuration
    or the warmup is answered the same way, on the first batch.
    """
    logging.basicConfig(level=logging.ERROR)
    from mythril_tpu_torch.device import is_device_fault
    from mythril_tpu_torch.observability import get_heartbeat, get_tracer
    from mythril_tpu_torch.observability.fleet import FleetPublisher

    if config.get("trace"):
        get_tracer().enabled = True
    publisher = FleetPublisher(worker_id)
    ctx = None
    fault: Optional[BaseException] = None
    try:
        ctx = _make_context(config)
        if config.get("warmup", False):
            from mythril_tpu_torch.analysis.cooperative import run_cooperative_batch

            try:
                run_cooperative_batch(
                    [("warmup", _WARMUP_CODE)],
                    transaction_count=1,
                    execution_timeout=5,
                    isolate_errors=True,
                    device=ctx.device,
                )
            except Exception as exc:
                if is_device_fault(exc):
                    raise
                log.exception("worker %d warmup failed; continuing cold",
                              worker_id)
            ctx.reset_scope()
    except Exception as exc:
        if not is_device_fault(exc):
            log.exception("worker %d failed to configure; exiting", worker_id)
            return
        log.error("worker %d: device fault before any batch: %r",
                  worker_id, exc)
        fault = exc
    # heartbeat runs here too — worker arena/queue-depth gauges exist in
    # the worker's registry and reach the daemon as fleet gauge samples
    if fault is None and config.get("heartbeat", True):
        hb = get_heartbeat()
        hb.register(
            "worker",
            lambda: {"worker.interned_terms":
                     ctx.stats().get("interned_terms", 0)},
        )
        hb.start(period_s=float(config.get("heartbeat_interval_s", 0.5)))
    stop_ev = threading.Event()
    control_thread: Optional[threading.Thread] = None

    def _exit_on_fault(job_id, flights, exc) -> None:
        # the device_fault event carries the done payload's keys; the pool
        # keeps this slot busy until the process is gone, so no batch
        # follows, and the process exits only once the daemon has taken
        # the answer (its "stop", or 30 s), so the pool's liveness monitor
        # never sees the death first
        log.error("worker %d job %s: device fault %r; exiting", worker_id,
                  job_id, exc)
        event_q.put(("device_fault", worker_id, job_id, {
            "issues": {},
            "errors": {
                f["codehash"]: f"device fault: {exc!r}" for f in flights
            },
            "elapsed_s": 0.0,
            "prefilter": {},
            "devsolver": {},
            "exploration": {},
            "probe_s": [],
            "first_source": {},
        }))
        stop_ev.set()
        if control_thread is not None:
            control_thread.join(timeout=2.0)
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            try:
                msg = job_q.get(timeout=max(deadline - time.monotonic(), 0.01))
            except queue_mod.Empty:
                break
            if isinstance(msg, tuple) and msg and msg[0] == "stop":
                break
        event_q.close()
        event_q.join_thread()
        # no interpreter teardown: it would run CUDA and thread-pool
        # finalizers on a context the fault may have left unusable
        os._exit(1)

    if control_q is not None:
        control_thread = threading.Thread(
            target=_control_loop,
            args=(worker_id, config, control_q, event_q, publisher,
                  stop_ev),
            name=f"mythril-worker-{worker_id}-control",
            daemon=True,
        )
        control_thread.start()
    event_q.put(("ready", worker_id, os.getpid()))
    while True:
        msg = job_q.get()
        if not isinstance(msg, tuple) or not msg:
            continue
        if msg[0] == "stop":
            break
        if msg[0] != "batch":
            continue
        _, job_id, flights, options = msg
        try:
            if fault is not None:
                raise fault
            _run_job(ctx, worker_id, job_id, flights, options, config,
                     event_q, publisher=publisher)
        except Exception as exc:
            if is_device_fault(exc):
                _exit_on_fault(job_id, flights, exc)
            # never a partial result: the whole batch errors per-request
            log.exception("worker %d job %s failed", worker_id, job_id)
            event_q.put(("done", worker_id, job_id, {
                "issues": {},
                "errors": {
                    f["codehash"]: f"worker batch failure: {exc!r}"
                    for f in flights
                },
                "elapsed_s": 0.0,
                "prefilter": {},
                "devsolver": {},
                "exploration": {},
                "probe_s": [],
                "first_source": {},
            }))
    stop_ev.set()
    if control_thread is not None:
        control_thread.join(timeout=2.0)
    try:
        publisher.flush(event_q)
    except Exception:
        pass
    event_q.put(("stopped", worker_id))
