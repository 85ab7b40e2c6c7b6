"""Watchtower: declarative SLOs evaluated over the metrics history.

The four measurement planes (flight deck, request telemetry, fleet
fabric, exploration ledger) record everything and watch nothing — a
regression is only caught when a human runs the bench gate or stares at
``myth top``.  The watchtower closes that loop:

* **Objectives** are declarative: a named target over one metric —
  a histogram quantile (``ttfe_p95``), a counter ratio (``error_rate``),
  or a gauge level (``worker_liveness``).  Defaults cover the service's
  standing contract; ``--slo FILE`` (YAML or JSON) replaces them.
* **Multi-window burn rates**: each objective is evaluated over a fast
  window (default 1 min) and a slow window (default 30 min) computed
  from the metrics history.  A *breach* requires the fast window to
  violate the target while the slow window confirms (or hasn't enough
  data yet to disagree); a fast-only violation is a *warn* — the
  standard SRE trade of paging latency against flappiness.
* **Anomaly-triggered auto-capture**: on an ok-to-breach edge the
  configured capture hook fires (the daemon dumps a flight bundle with
  linked worker bundles and opens a short profile window on the worst
  worker), stamped with the objective name and rate-limited by a
  per-objective cooldown.

Each tick also appends one snapshot to the persistent
:class:`~mythril_tpu_torch.observability.history.MetricsHistory` ring, and the
evaluation reads from a bounded in-memory tail of the very samples it
just wrote — the disk is for post-hoc queries, not the hot path.

Exposition: ``slo.status`` dict gauge (rendered as
``slo_status{objective="..."}``), ``slo.breaches_total`` counter and
``slo.breaches{objective=...}`` labeled counter, the ``health`` protocol
verb, ``myth health``, and ``meta.health`` in the jsonv2 report.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from mythril_tpu_torch.observability.history import (
    MetricsHistory, counter_window, window_percentile,
)
from mythril_tpu_torch.observability.metrics import get_registry

log = logging.getLogger(__name__)

__all__ = [
    "Objective",
    "Watchtower",
    "default_objectives",
    "get_watchtower",
    "health_meta",
    "load_slo_file",
    "set_watchtower",
]

# status gauge encoding (slo.status{objective=...})
STATUS_OK = 0
STATUS_WARN = 1
STATUS_BREACH = 2

DEFAULT_FAST_WINDOW_S = 60.0
DEFAULT_SLOW_WINDOW_S = 1800.0
DEFAULT_CAPTURE_COOLDOWN_S = 120.0
DEFAULT_PROFILE_DURATION_S = 2.0


@dataclass
class Objective:
    """One declarative service-level objective.

    ``kind`` selects the evaluation:

    * ``"quantile"`` — ``q``-quantile of histogram ``metric`` over the
      window must satisfy ``op target``.
    * ``"ratio"`` — window delta of counter ``metric`` divided by the
      window delta of counter ``denominator``; the denominator delta
      must reach ``min_count`` before the objective has data.
    * ``"gauge"`` — latest value of gauge ``metric`` (mean of the values
      for a dict gauge); level objectives page immediately, so fast and
      slow windows coincide.

    ``op`` is the *healthy* direction: ``"<="`` for budgets, ``">="``
    for floors.
    """

    name: str
    kind: str
    metric: str
    target: float
    op: str = "<="
    q: float = 0.95
    denominator: Optional[str] = None
    fast_window_s: float = DEFAULT_FAST_WINDOW_S
    slow_window_s: float = DEFAULT_SLOW_WINDOW_S
    min_count: int = 1
    description: str = ""

    def ok(self, value: float) -> bool:
        return value <= self.target if self.op == "<=" else value >= self.target


def default_objectives(workers: int = 1) -> List[Objective]:
    """The service's standing contract, tuned for interactive serving."""
    objs = [
        Objective("ttfe_p95", "quantile", "service.ttfe_s", target=2.0,
                  description="p95 time-to-first-evidence stays interactive"),
        Objective("queue_wait_p95", "quantile", "service.queue_wait_s",
                  target=5.0,
                  description="admission-to-dispatch p95 stays bounded"),
        Objective("execute_p95", "quantile", "service.execute_s",
                  target=120.0,
                  description="worker execute-phase p95 stays bounded"),
        Objective("error_rate", "ratio", "service.request_errors",
                  denominator="service.requests", target=0.05, min_count=5,
                  description="under 5% of requests end in error"),
        Objective("shed_rate", "ratio", "service.shed_total",
                  denominator="service.requests", target=0.25, min_count=5,
                  description="under 25% of requests shed at admission"),
        Objective("coverage_floor", "gauge", "service.coverage_avg_pct",
                  target=10.0, op=">=",
                  description="average exploration coverage stays above floor"),
        Objective("prefilter_kill_floor", "ratio", "service.prefilter_killed",
                  denominator="service.prefilter_evaluated", target=0.01,
                  op=">=", min_count=50,
                  description="the abstract pre-filter keeps earning its keep"),
    ]
    if workers > 1:
        objs.append(Objective(
            "worker_liveness", "gauge", "service.workers",
            target=float(workers), op=">=",
            description="every configured worker slot is alive"))
    return objs


def load_slo_file(path: str) -> Tuple[List[Objective], Dict[str, Any]]:
    """Parse ``--slo FILE`` (YAML or JSON; JSON is a YAML subset).

    Layout::

        interval_s: 5.0
        capture: {cooldown_s: 120, profile_duration_s: 2.0, profile: true}
        objectives:
          - {name: ttfe_p95, kind: quantile, metric: service.ttfe_s,
             q: 0.95, target: 2.0, fast_window_s: 60, slow_window_s: 1800}

    Returns ``(objectives, options)`` where ``options`` carries the
    non-objective keys (``interval_s``, ``capture``, history sizing).
    """
    with open(path, encoding="utf-8") as f:
        text = f.read()
    try:
        import yaml
        doc = yaml.safe_load(text)
    except ImportError:
        import json
        doc = json.loads(text)
    if not isinstance(doc, dict):
        raise ValueError(f"SLO file {path}: expected a mapping at top level")
    raw = doc.get("objectives")
    if not isinstance(raw, list) or not raw:
        raise ValueError(f"SLO file {path}: 'objectives' list is required")
    fields = {f_.name for f_ in Objective.__dataclass_fields__.values()}
    objectives = []
    for i, entry in enumerate(raw):
        if not isinstance(entry, dict):
            raise ValueError(f"SLO file {path}: objectives[{i}] not a mapping")
        unknown = set(entry) - fields
        if unknown:
            raise ValueError(
                f"SLO file {path}: objectives[{i}] unknown keys {sorted(unknown)}"
            )
        missing = {"name", "kind", "metric", "target"} - set(entry)
        if missing:
            raise ValueError(
                f"SLO file {path}: objectives[{i}] missing {sorted(missing)}"
            )
        if entry["kind"] not in ("quantile", "ratio", "gauge"):
            raise ValueError(
                f"SLO file {path}: objectives[{i}] bad kind {entry['kind']!r}"
            )
        objectives.append(Objective(**entry))
    options = {k: v for k, v in doc.items() if k != "objectives"}
    return objectives, options


# capture hook: (objective, evaluation) -> optional info dict recorded
# in health(); the daemon wires this to flight-dump + worst-worker profile
CaptureHook = Callable[[Objective, Dict[str, Any]], Optional[Dict[str, Any]]]


class Watchtower:
    """Tick loop: snapshot -> history append -> SLO evaluation -> capture."""

    def __init__(
        self,
        history_dir: str,
        objectives: Optional[List[Objective]] = None,
        interval_s: float = 5.0,
        capture: Optional[CaptureHook] = None,
        capture_cooldown_s: float = DEFAULT_CAPTURE_COOLDOWN_S,
        max_segment_bytes: int = 1 << 20,
        max_segments: int = 16,
        source: Optional[Callable[[], Tuple[Dict[str, Any], Dict[str, Any]]]] = None,
    ):
        self.objectives = list(objectives) if objectives is not None else []
        self.interval_s = max(0.05, interval_s)
        self.capture = capture
        self.capture_cooldown_s = capture_cooldown_s
        self.history = MetricsHistory(
            history_dir,
            max_segment_bytes=max_segment_bytes,
            max_segments=max_segments,
            source=source,
        )
        slow = max(
            [o.slow_window_s for o in self.objectives] or [DEFAULT_SLOW_WINDOW_S]
        )
        # in-memory tail sized to the slowest window at this cadence
        self._tail: deque = deque(
            maxlen=max(64, int(slow / self.interval_s) + 8)
        )
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._evals: Dict[str, Dict[str, Any]] = {}
        self._breached: Dict[str, bool] = {}
        self._last_capture_t: Dict[str, float] = {}
        self.captures: deque = deque(maxlen=16)
        self.ticks = 0
        self._tick_time_s = 0.0
        reg = get_registry()
        self._c_breaches = reg.counter("slo.breaches_total", persistent=True)
        self._c_by_objective = reg.labeled_counter(
            "slo.breaches", persistent=True, label_name="objective")
        self._g_status = reg.gauge("slo.status", persistent=True, default={},
                                   label_name="objective")

    # -- lifecycle -----------------------------------------------------

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="mythril-watchtower", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=self.interval_s * 4 + 1.0)
        self._thread = None
        self.history.close()

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:
                log.exception("watchtower tick failed")

    # -- evaluation ----------------------------------------------------

    def tick(self, now: Optional[float] = None) -> Dict[str, Dict[str, Any]]:
        """One snapshot + evaluation pass; returns per-objective evals."""
        t0_wall = time.perf_counter()
        t, values = self.history.record(now)
        with self._lock:
            self._tail.append((t, values))
            tail = list(self._tail)
        evals = {o.name: self._evaluate(o, tail, t) for o in self.objectives}
        status = {name: e["status"] for name, e in evals.items()}
        self._g_status.set(status)
        fired = []
        with self._lock:
            self._evals = evals
            for o in self.objectives:
                e = evals[o.name]
                breaching = e["state"] == "breach"
                if breaching and not self._breached.get(o.name):
                    self._c_breaches.inc()
                    self._c_by_objective.inc(o.name)
                if breaching:
                    last = self._last_capture_t.get(o.name, 0.0)
                    if (self.capture is not None
                            and t - last >= self.capture_cooldown_s):
                        self._last_capture_t[o.name] = t
                        fired.append((o, e))
                self._breached[o.name] = breaching
        for o, e in fired:
            # outside the lock: the hook dumps bundles / launches profiles
            try:
                info = self.capture(o, e)
            except Exception:
                log.exception("watchtower capture for %s failed", o.name)
                info = None
            rec = {"t": round(t, 3), "objective": o.name}
            if isinstance(info, dict):
                rec.update(info)
            with self._lock:
                self.captures.append(rec)
        self.ticks += 1
        self._tick_time_s += time.perf_counter() - t0_wall
        return evals

    def _evaluate(self, o: Objective, tail: List[Tuple[float, Dict[str, Any]]],
                  now: float) -> Dict[str, Any]:
        fast, n_fast = self._window_value(o, tail, now - o.fast_window_s, now)
        slow, n_slow = self._window_value(o, tail, now - o.slow_window_s, now)
        if fast is None:
            state = "no_data"
        elif o.ok(fast):
            state = "ok"
        elif slow is None or not o.ok(slow):
            # fast window violates and the slow window confirms (or has
            # no opinion yet): the budget is burning at both rates
            state = "breach"
        else:
            state = "warn"
        return {
            "name": o.name,
            "kind": o.kind,
            "metric": o.metric,
            "state": state,
            "status": {"ok": STATUS_OK, "warn": STATUS_WARN,
                       "breach": STATUS_BREACH}.get(state, STATUS_OK),
            "value": None if fast is None else round(fast, 6),
            "slow_value": None if slow is None else round(slow, 6),
            "target": o.target,
            "op": o.op,
            "window_count": n_fast,
            "slow_window_count": n_slow,
            "fast_window_s": o.fast_window_s,
            "slow_window_s": o.slow_window_s,
            "description": o.description,
        }

    def _window_value(
        self, o: Objective, tail: List[Tuple[float, Dict[str, Any]]],
        t0: float, t1: float,
    ) -> Tuple[Optional[float], int]:
        if o.kind == "quantile":
            return window_percentile(
                tail, o.metric, o.q, t0, t1,
                self.history.bucket_bounds, min_count=o.min_count)
        if o.kind == "ratio":
            num = counter_window(tail, o.metric, t0, t1)
            den = counter_window(tail, o.denominator or "", t0, t1)
            if den < max(1, o.min_count):
                return None, int(den)
            return num / den, int(den)
        # gauge: level objective over the latest sample
        if not tail:
            return None, 0
        v = tail[-1][1].get(o.metric)
        if isinstance(v, dict):
            nums = [x for x in v.values() if isinstance(x, (int, float))]
            if not nums:
                return None, 0
            return sum(nums) / len(nums), len(nums)
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            return float(v), 1
        return None, 0

    # -- reporting -----------------------------------------------------

    def health(self) -> Dict[str, Any]:
        """JSON-ready health block (``health`` verb, ``meta.health``)."""
        with self._lock:
            evals = [self._evals[o.name] for o in self.objectives
                     if o.name in self._evals]
            captures = list(self.captures)
        breaching = [e["name"] for e in evals if e["state"] == "breach"]
        warning = [e["name"] for e in evals if e["state"] == "warn"]
        return {
            "enabled": True,
            "ok": not breaching,
            "breaching": breaching,
            "warning": warning,
            "objectives": evals,
            "breaches_total": self._c_breaches.value,
            "ticks": self.ticks,
            "interval_s": self.interval_s,
            "overhead_pct": round(self.overhead_pct(), 3),
            "history_dir": self.history.out_dir,
            "captures": captures,
        }

    def overhead_pct(self) -> float:
        """Mean tick cost as a share of the tick period (the 2% budget)."""
        if not self.ticks:
            return 0.0
        return (self._tick_time_s / self.ticks) / self.interval_s * 100.0

    def status_line(self) -> str:
        """One-line summary for ``myth top``."""
        h = self.health()
        if h["breaching"]:
            return "SLO BREACH: " + ", ".join(h["breaching"])
        n = len(self.objectives)
        line = f"slo: ok ({n} objective{'s' if n != 1 else ''}"
        if h["warning"]:
            line += f", warn: {', '.join(h['warning'])}"
        bt = h["breaches_total"]
        if bt:
            line += f", breaches_total {bt}"
        return line + ")"


# -- module singleton (report.py reads it for jsonv2 meta.health) --------

_watchtower: Optional[Watchtower] = None


def get_watchtower() -> Optional[Watchtower]:
    return _watchtower


def set_watchtower(wt: Optional[Watchtower]) -> None:
    global _watchtower
    _watchtower = wt


def health_meta() -> Dict[str, Any]:
    """Compact health block for the jsonv2 report meta."""
    wt = get_watchtower()
    if wt is None:
        return {"enabled": False}
    h = wt.health()
    return {
        "enabled": True,
        "ok": h["ok"],
        "breaching": h["breaching"],
        "warning": h["warning"],
        "breaches_total": h["breaches_total"],
        "objectives": {
            e["name"]: {"state": e["state"], "value": e["value"],
                        "target": e["target"], "op": e["op"]}
            for e in h["objectives"]
        },
    }
