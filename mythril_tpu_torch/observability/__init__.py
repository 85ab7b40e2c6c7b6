"""Exploration accounting and the metrics registry it lives in.

The part of ``mythril_tpu/observability`` that the analysis reads:

* :mod:`.metrics` — the registry of named counters, gauges, labeled
  counters and histograms (a copy of the JAX module).  The exploration
  ledger's ``exploration.*`` series and the adaptive controller's
  ``adaptive.*`` counters live in it; the port's older counters
  (``FrontierStatistics``, ``SolverStatistics``, ``staticpass``,
  ``querycache``, ``pipeline``) stay module state of their own packages.
* :mod:`.exploration` — the exploration ledger: coverage bitmaps, the
  termination taxonomy and solver hotspots.

The tracer, the device plane, the fleet fabric, the flight recorder, the
heartbeat, history, drift and watchtower wait for ROADMAP Queue A item 13.
"""

from mythril_tpu_torch.observability.exploration import (  # noqa: F401
    TERM_CLASSES,
    ExplorationLedger,
    exploration_meta,
    get_exploration_ledger,
)
from mythril_tpu_torch.observability.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    LabeledCounter,
    MetricsRegistry,
    get_registry,
)


def reset_analysis_metrics() -> None:
    """Reset per-analysis telemetry at the start of an analysis.

    Clears every non-persistent metric of the registry, the exploration
    ledger's coverage bitmaps, and the adaptive controller's plan cache,
    coverage history and latched coverage-stop verdict, which all describe
    the scope being swept."""
    get_registry().reset()
    get_exploration_ledger().reset_scope()
    from mythril_tpu_torch.adaptive import get_adaptive_controller

    get_adaptive_controller().reset_scope()
