"""Tracing, metrics and the exploration ledger of the analysis.

The port's counterpart of ``mythril_tpu/observability``:

* :mod:`.tracer` — the span tracer (a copy of the JAX module; its
  ``device_annotation`` is ``torch.profiler.record_function``): disabled by
  default, a shared no-op context per instrumentation site when disabled;
  Chrome-trace/Perfetto JSON and JSONL export, flows and counters.
* :mod:`.metrics` — the registry of named counters, gauges, labeled
  counters and histograms (a copy).  Every subsystem's telemetry lives in
  it under the JAX package's names; ``FrontierStatistics`` and
  ``SolverStatistics`` are facades over it, and :mod:`.views` keeps the
  port's older module-state names readable.
* :mod:`.deviceplane` — the device telemetry plane: kernel builds, CUDA-event
  device time of segments and pulls, the allocator's peak per bucket.
* :mod:`.exploration` — the exploration ledger: coverage bitmaps, the
  termination taxonomy and solver hotspots.
* The health surfaces, copies of the JAX modules: :mod:`.heartbeat` (the
  queue-depth sampler), :mod:`.flightrecorder` (bundles on an exception,
  SIGUSR1 or the watchdog; the bundle also carries ``device_meta()``),
  :mod:`.history` (the persistent metrics ring), :mod:`.watchtower` (SLO
  objectives over the history, ``meta.health``) and :mod:`.drift` (the
  ranked differ of two bench tables or two history windows).

* :mod:`.fleet` — the fleet fabric (a copy): a pool worker's
  ``FleetPublisher`` ships metric deltas and span batches to the analysis
  service's ``FleetAggregator``, which keeps the per-worker series and the
  rollup.

    from mythril_tpu_torch.observability import get_tracer, get_registry, span

    with span("frontier.segment", cat="device", segment=0):
        ...
"""

from mythril_tpu_torch.observability.deviceplane import (  # noqa: F401
    bucket_tag,
    device_meta,
    dispatch_scope,
    install_deviceplane,
)
from mythril_tpu_torch.observability.drift import (  # noqa: F401
    diff_history_windows,
    diff_tables,
    format_drift,
)
from mythril_tpu_torch.observability.exploration import (  # noqa: F401
    TERM_CLASSES,
    ExplorationLedger,
    exploration_meta,
    get_exploration_ledger,
)
from mythril_tpu_torch.observability.fleet import (  # noqa: F401
    WIRE_VERSION,
    FleetAggregator,
    FleetPublisher,
)
from mythril_tpu_torch.observability.flightrecorder import (  # noqa: F401
    FlightRecorder,
    arm_flight_recorder,
    build_bundle,
    disarm_flight_recorder,
    get_flight_recorder,
    register_dump_listener,
    register_flight_context,
    unregister_dump_listener,
    unregister_flight_context,
)
from mythril_tpu_torch.observability.heartbeat import (  # noqa: F401
    HeartbeatSampler,
    get_heartbeat,
)
from mythril_tpu_torch.observability.history import (  # noqa: F401
    HistoryReader,
    MetricsHistory,
)
from mythril_tpu_torch.observability.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    LabeledCounter,
    MetricsRegistry,
    get_registry,
    prometheus_text,
)
from mythril_tpu_torch.observability.tracer import (  # noqa: F401
    Tracer,
    device_annotation,
    get_tracer,
    span,
    traced,
)
from mythril_tpu_torch.observability.watchtower import (  # noqa: F401
    Objective,
    Watchtower,
    default_objectives,
    get_watchtower,
    health_meta,
    load_slo_file,
    set_watchtower,
)


def observability_meta() -> dict:
    """Snapshot block embedded in report meta and ``--metrics-out``."""
    # Materialize the facade-backed metrics first so the snapshot always
    # carries the full frontier.*/solver.* key set, even for runs where a
    # stage never executed
    from mythril_tpu_torch.frontier.stats import FrontierStatistics
    from mythril_tpu_torch.querycache.cache import materialize_counters
    from mythril_tpu_torch.smt.solver import SolverStatistics

    FrontierStatistics()._materialize()
    SolverStatistics()
    materialize_counters()
    tracer = get_tracer()
    meta = {"metrics": get_registry().snapshot()}
    if tracer.enabled or len(tracer):
        meta["trace"] = tracer.summary()
    return meta


def reset_analysis_metrics() -> None:
    """Reset per-analysis telemetry at the start of an analysis.

    Clears every non-persistent metric of the registry (the
    ``FrontierStatistics`` and ``SolverStatistics`` facades and every
    subsystem's counters with it; ``persistent=True`` metrics such as the
    frontier's per-code verdicts and the device plane's survive), the
    exploration ledger's coverage bitmaps, and the adaptive controller's
    plan cache, coverage history and latched coverage-stop verdict, which
    all describe the scope being swept."""
    get_registry().reset()
    get_exploration_ledger().reset_scope()
    from mythril_tpu_torch.adaptive import get_adaptive_controller

    get_adaptive_controller().reset_scope()
