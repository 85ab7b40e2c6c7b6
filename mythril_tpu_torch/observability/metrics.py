"""Process-wide metrics registry: named counters, gauges, histograms.

This registry absorbs the mutable-attribute telemetry that used to live
in three disconnected singletons (``FrontierStatistics``,
``SolverStatistics``, the ``InstructionProfiler`` plugin).  Those
classes remain as thin facades whose attributes are properties backed by
registry metrics, so call sites like ``stats.segments += 1`` and tests
that assign ``stats.unknown_as_unsat = 0`` keep working unchanged.

Scopes
------
Metrics default to the *analysis* scope and are cleared by
``MetricsRegistry.reset()`` at the start of each analysis.  Metrics
created with ``persistent=True`` survive that sweep — the frontier's
per-code slow/narrow-segment verdicts use this, mirroring the
deliberately process-persistent ``_SLOW_CODES`` / ``_NARROW_CODES``
dicts in ``frontier/engine.py`` (a code that degenerated once must not
be re-probed by the very next analysis in the same process).

Thread-safety: ``Counter.inc``, ``Histogram.observe`` and
``LabeledCounter.inc`` are real read-modify-write cycles, and the
pipelined frontier's feasibility pool mutates solver/querycache counters
from worker threads — so all three take a shared module-level mutation
lock (one uncontended lock acquire per increment; the hot paths increment
at segment/query granularity, not per instruction).  Plain ``+=`` on a
``LabeledCounter`` item and facade property writes remain main-thread
constructs.  Registry *registration* is separately lock-protected because
worker threads may create metrics concurrently.
"""

from __future__ import annotations

import bisect
import collections
import re
import threading
from typing import Any, Dict, List, Optional, Tuple, Union

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "LabeledCounter",
    "MetricsRegistry",
    "get_registry",
    "percentile_from_buckets",
    "prometheus_text",
]

Number = Union[int, float]

# shared by every metric's mutators: increments are read-modify-write and
# must be atomic across the feasibility-pool worker threads
_MUTATION_LOCK = threading.Lock()


class Counter:
    """Monotonic-by-convention accumulator; ``set()`` exists for facades.

    ``initial`` fixes the numeric type: a counter created with ``0.0``
    resets to float zero, keeping facade report output (``round(x, 3)``)
    type-stable with the pre-registry singletons.
    """

    __slots__ = ("name", "persistent", "value", "gen", "_initial")

    def __init__(self, name: str, persistent: bool = False, initial: Number = 0):
        self.name = name
        self.persistent = persistent
        self._initial = initial
        self.value: Number = initial
        # reset generation: bumped by every reset() so delta consumers
        # (observability/fleet.py) can tell "swept back to zero" from
        # "never moved" without guessing from the value
        self.gen = 0

    def inc(self, n: Number = 1) -> None:
        with _MUTATION_LOCK:
            self.value += n

    def set(self, v: Number) -> None:
        self.value = v

    def reset(self) -> None:
        self.value = self._initial
        self.gen += 1

    def snapshot(self) -> Number:
        return self.value


class Gauge:
    """Last-write-wins value; may hold any JSON-serializable object."""

    __slots__ = ("name", "persistent", "value", "gen", "_default",
                 "label_name")

    def __init__(self, name: str, persistent: bool = False, default: Any = 0,
                 label_name: str = "key"):
        self.name = name
        self.persistent = persistent
        self._default = default
        self.value: Any = _copy_default(default)
        # label key used when a dict-valued gauge is rendered to the
        # Prometheus text format ({objective="ttfe_p95"} reads better
        # than {key="ttfe_p95"} for the watchtower's status gauge)
        self.label_name = label_name
        self.gen = 0

    def set(self, v: Any) -> None:
        self.value = v

    def reset(self) -> None:
        self.value = _copy_default(self._default)
        self.gen += 1

    def snapshot(self) -> Any:
        return self.value


def _copy_default(default: Any) -> Any:
    # mutable defaults (microbench dict) must not be shared across resets
    return default.copy() if isinstance(default, (dict, list)) else default


class LabeledCounter(collections.Counter):
    """A ``collections.Counter`` registered as one metric.

    Subclassing keeps facade call sites like
    ``stats.parks_by_opcode[op] += 1`` and ``.most_common()`` intact.
    """

    def __init__(self, name: str, persistent: bool = False,
                 label_name: str = "label"):
        super().__init__()
        self.name = name
        self.persistent = persistent
        # Prometheus label key used by the text exposition ({tenant="x"}
        # reads better than {label="x"} for the service's per-tenant
        # counters); keys stay plain strings everywhere else.
        self.label_name = label_name
        self.gen = 0

    def inc(self, label: str, n: Number = 1) -> None:
        """Thread-safe increment (``c[label] += n`` is not atomic)."""
        with _MUTATION_LOCK:
            self[label] = self.get(label, 0) + n

    def reset(self) -> None:
        self.clear()
        self.gen += 1

    def snapshot(self) -> Dict[str, Number]:
        return dict(self.most_common())


# Power-of-two-ish duration buckets (seconds): 100µs .. ~100s.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
)


def percentile_from_buckets(
    buckets: Tuple[float, ...],
    bucket_counts: List[int],
    q: float,
    lo_obs: Optional[float] = None,
    hi_obs: Optional[float] = None,
) -> Optional[float]:
    """Estimate the ``q``-quantile (0..1) from a bucket layout.

    ``bucket_counts`` is one count per bucket plus the +Inf overflow slot
    (``Histogram`` layout).  Linear interpolation inside the covering
    bucket, clamped to ``[lo_obs, hi_obs]`` when observed extremes are
    known.  Shared by ``Histogram.percentile`` (live registry) and the
    watchtower's windowed evaluation over history bucket deltas, where
    only counts — not extremes — survive delta encoding.  Returns
    ``None`` when the counts are empty.
    """
    count = sum(bucket_counts)
    if not count:
        return None
    target = max(0.0, min(1.0, q)) * count
    cum = 0
    for i, c in enumerate(bucket_counts):
        if not c:
            continue
        if cum + c >= target:
            lo = buckets[i - 1] if i > 0 else 0.0
            if i < len(buckets):
                hi = buckets[i]
            elif hi_obs is not None:
                hi = hi_obs
            else:
                hi = buckets[-1]
            frac = (target - cum) / c
            est = lo + (hi - lo) * max(0.0, min(1.0, frac))
            if lo_obs is not None:
                est = max(est, lo_obs)
            if hi_obs is not None:
                est = min(est, hi_obs)
            return est
        cum += c
    return hi_obs if hi_obs is not None else buckets[-1]


class Histogram:
    """Fixed-bucket histogram with count/sum/min/max.

    ``bucket_counts[i]`` counts observations ``<= buckets[i]``; the final
    slot is the +Inf overflow bucket (Prometheus-style cumulative-free
    layout — each observation lands in exactly one slot).
    """

    __slots__ = (
        "name", "persistent", "buckets", "bucket_counts",
        "count", "sum", "min", "max", "gen",
    )

    def __init__(
        self,
        name: str,
        buckets: Tuple[float, ...] = DEFAULT_BUCKETS,
        persistent: bool = False,
    ):
        self.name = name
        self.persistent = persistent
        self.buckets: Tuple[float, ...] = tuple(buckets)
        self.bucket_counts: List[int] = [0] * (len(self.buckets) + 1)
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self.gen = 0

    def observe(self, v: float) -> None:
        with _MUTATION_LOCK:
            self.bucket_counts[bisect.bisect_left(self.buckets, v)] += 1
            self.count += 1
            self.sum += v
            if self.min is None or v < self.min:
                self.min = v
            if self.max is None or v > self.max:
                self.max = v

    def reset(self) -> None:
        self.bucket_counts = [0] * (len(self.buckets) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None
        self.gen += 1

    def percentile(self, q: float) -> Optional[float]:
        """Estimate the ``q``-quantile (0..1) from the bucket layout.

        Linear interpolation inside the covering bucket, clamped to the
        observed ``[min, max]`` — exact at the extremes, bucket-resolution
        in between (the same estimate ``histogram_quantile`` makes).
        Returns ``None`` when nothing has been observed.
        """
        with _MUTATION_LOCK:
            if not self.count:
                return None
            counts = list(self.bucket_counts)
            lo_obs, hi_obs = self.min, self.max
        return percentile_from_buckets(self.buckets, counts, q,
                                       lo_obs=lo_obs, hi_obs=hi_obs)

    def snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "count": self.count,
            "sum": round(self.sum, 6),
        }
        if self.count:
            out["min"] = round(self.min, 6)
            out["max"] = round(self.max, 6)
            out["avg"] = round(self.sum / self.count, 6)
            # only non-empty buckets, keyed by upper bound ("+Inf" last)
            nonzero = {}
            for i, c in enumerate(self.bucket_counts):
                if c:
                    le = "+Inf" if i == len(self.buckets) else repr(self.buckets[i])
                    nonzero[le] = c
            out["buckets_le"] = nonzero
        return out


class MetricsRegistry:
    """Name -> metric map with get-or-create accessors and scoped reset."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Any] = {}

    def _get_or_create(self, name: str, factory, kind) -> Any:
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    m = factory()
                    self._metrics[name] = m
        if not isinstance(m, kind):
            raise TypeError(
                f"metric {name!r} already registered as {type(m).__name__}"
            )
        return m

    def counter(
        self, name: str, persistent: bool = False, initial: Number = 0
    ) -> Counter:
        return self._get_or_create(
            name, lambda: Counter(name, persistent, initial), Counter
        )

    def gauge(self, name: str, persistent: bool = False, default: Any = 0,
              label_name: str = "key") -> Gauge:
        return self._get_or_create(
            name, lambda: Gauge(name, persistent, default, label_name), Gauge
        )

    def labeled_counter(self, name: str, persistent: bool = False,
                        label_name: str = "label") -> LabeledCounter:
        return self._get_or_create(
            name, lambda: LabeledCounter(name, persistent, label_name),
            LabeledCounter,
        )

    def histogram(
        self,
        name: str,
        buckets: Tuple[float, ...] = DEFAULT_BUCKETS,
        persistent: bool = False,
    ) -> Histogram:
        return self._get_or_create(
            name, lambda: Histogram(name, buckets, persistent), Histogram
        )

    def observe(self, name: str, v: float) -> None:
        """Shorthand: record ``v`` into histogram ``name``."""
        self.histogram(name).observe(v)

    def reset(self, include_persistent: bool = False, prefix: str = "") -> None:
        """Zero analysis-scoped metrics; keep ``persistent=True`` ones
        unless ``include_persistent`` is set.  ``prefix`` restricts the
        sweep to one namespace (e.g. ``"frontier."``)."""
        with self._lock:
            metrics = [
                m for name, m in self._metrics.items()
                if name.startswith(prefix)
            ]
        for m in metrics:
            if include_persistent or not m.persistent:
                m.reset()

    def snapshot(self, prefix: str = "") -> Dict[str, Any]:
        """JSON-serializable view of every metric (optionally filtered)."""
        with self._lock:
            items = sorted(self._metrics.items())
        return {
            name: m.snapshot()
            for name, m in items
            if name.startswith(prefix)
        }


_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _registry


# -- Prometheus text exposition (format 0.0.4) ---------------------------

_PROM_BAD_CHARS = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    """Registry names use dots; Prometheus metric names cannot."""
    n = _PROM_BAD_CHARS.sub("_", name)
    return "_" + n if n and n[0].isdigit() else n


def _prom_label_value(v: Any) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _prom_number(v: Number) -> str:
    if isinstance(v, float) and v == int(v) and abs(v) < 1e15:
        return repr(v)
    return repr(v) if isinstance(v, float) else str(v)


def prometheus_text(registry: Optional[MetricsRegistry] = None) -> str:
    """Render the registry in the Prometheus text exposition format.

    Counters and gauges become single samples; dict-valued gauges (the
    heartbeat's per-shard depth maps) and labeled counters become one
    labeled sample per key; histograms emit the standard *cumulative*
    ``_bucket{le=...}`` series plus ``_sum``/``_count``.  Non-numeric
    gauge payloads are skipped — the format has no place for them.
    The analysis service serves this under the ``metrics`` verb.
    """
    reg = registry or get_registry()
    with reg._lock:
        items = sorted(reg._metrics.items())
    lines: List[str] = []
    for name, m in items:
        pname = _prom_name(name)
        if isinstance(m, Histogram):
            with _MUTATION_LOCK:
                counts = list(m.bucket_counts)
                count, total = m.count, m.sum
            lines.append(f"# TYPE {pname} histogram")
            cum = 0
            for i, c in enumerate(counts):
                cum += c
                le = ("+Inf" if i == len(m.buckets)
                      else _prom_number(float(m.buckets[i])))
                lines.append(f'{pname}_bucket{{le="{le}"}} {cum}')
            lines.append(f"{pname}_sum {_prom_number(float(total))}")
            lines.append(f"{pname}_count {count}")
        elif isinstance(m, LabeledCounter):
            # the label *name* is interpolated into the exposition verbatim,
            # so it must be a legal Prometheus label identifier too
            lkey = _prom_name(m.label_name or "label")
            lines.append(f"# TYPE {pname} counter")
            for label, v in sorted(m.snapshot().items()):
                if isinstance(v, (int, float)):
                    lines.append(
                        f'{pname}{{{lkey}="{_prom_label_value(label)}"}}'
                        f" {_prom_number(v)}"
                    )
        elif isinstance(m, Counter):
            lines.append(f"# TYPE {pname} counter")
            lines.append(f"{pname} {_prom_number(m.value)}")
        elif isinstance(m, Gauge):
            v = m.value
            if isinstance(v, dict):
                numeric = {k: x for k, x in v.items()
                           if isinstance(x, (int, float))}
                if not numeric:
                    continue
                lkey = _prom_name(m.label_name or "key")
                lines.append(f"# TYPE {pname} gauge")
                for k, x in sorted(numeric.items()):
                    lines.append(
                        f'{pname}{{{lkey}="{_prom_label_value(k)}"}}'
                        f" {_prom_number(x)}"
                    )
            elif isinstance(v, (int, float)) and not isinstance(v, bool):
                lines.append(f"# TYPE {pname} gauge")
                lines.append(f"{pname} {_prom_number(v)}")
    return "\n".join(lines) + "\n"
