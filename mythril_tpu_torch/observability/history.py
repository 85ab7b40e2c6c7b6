"""Persistent metrics history: a bounded on-disk ring of registry snapshots.

Every telemetry plane in the repo answers "what is the value *now*" —
the registry, the heartbeat, the fleet fabric are all instantaneous.
The watchtower needs a *time axis*: SLO burn rates are deltas between
two points in history, and a 3 a.m. breach is only diagnosable if the
minutes leading into it were recorded somewhere durable.

``MetricsHistory`` appends one JSON line per tick to segment files under
``<dir>/seg-NNNNNNNN.jsonl``:

* the first line of every segment is a **full** snapshot
  (``{"v": 1, "t": ..., "full": 1, "m": {...}, "hb": {...}}``) so each
  segment is independently readable;
* subsequent lines are **deltas** carrying only the metrics whose
  encoded value changed since the previous tick (``{"t": ..., "m":
  {...}}``) — under a quiet daemon a tick costs a handful of bytes;
* segments rotate at ``max_segment_bytes`` and the oldest are deleted
  beyond ``max_segments``, bounding the store regardless of uptime;
* a restarting daemon scans the directory and continues the segment
  sequence, so the ring spans process lifetimes.

Encoded forms per metric kind: counters and numeric gauges are plain
numbers, dict gauges and labeled counters are ``{label: number}`` maps,
histograms are ``{"c": count, "s": sum, "mn": min, "mx": max, "bc":
[per-bucket counts]}`` with the bucket boundaries recorded once per
segment in the full line's ``hb`` map (they never change at runtime).

``HistoryReader`` is the pure query side: it replays full+delta lines
back into cumulative samples.  The module-level window helpers
(``histogram_window``, ``counter_window``, ``window_percentile``)
compute the deltas the SLO engine evaluates; they operate on any
``(t, values)`` sequence — the watchtower's in-memory tail and the
reader's on-disk replay use the same code paths.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from typing import (
    Any, Callable, Dict, Iterable, Iterator, List, Optional, Tuple,
)

from mythril_tpu_torch.observability.metrics import (
    Counter, Gauge, Histogram, LabeledCounter, MetricsRegistry,
    get_registry, percentile_from_buckets,
)

__all__ = [
    "DEFAULT_PREFIXES",
    "HistoryReader",
    "MetricsHistory",
    "counter_window",
    "encode_registry",
    "histogram_window",
    "window_percentile",
]

# Namespaces worth a time axis.  Solver/frontier internals churn far too
# fast to snapshot wholesale and are better served by the tracer.
DEFAULT_PREFIXES: Tuple[str, ...] = (
    "service.", "slo.", "heartbeat.", "exploration.", "prefilter.",
    "devsolver.", "device.",
)

_SEGMENT_RE = re.compile(r"^seg-(\d{8})\.jsonl$")

Sample = Tuple[float, Dict[str, Any]]


def encode_registry(
    registry: Optional[MetricsRegistry] = None,
    prefixes: Tuple[str, ...] = DEFAULT_PREFIXES,
) -> Tuple[Dict[str, Any], Dict[str, Tuple[float, ...]]]:
    """Snapshot the registry into history wire values.

    Returns ``(values, hist_buckets)``.  Zero counters, empty histograms
    and empty label maps are omitted (absent means zero to every
    consumer); numeric gauges are kept even at zero because a gauge at
    zero is a statement (``service.workers 0``), not noise.
    """
    reg = registry or get_registry()
    with reg._lock:
        items = sorted(reg._metrics.items())
    values: Dict[str, Any] = {}
    bounds: Dict[str, Tuple[float, ...]] = {}
    for name, m in items:
        if prefixes and not name.startswith(prefixes):
            continue
        if isinstance(m, Histogram):
            if not m.count:
                continue
            values[name] = {
                "c": m.count,
                "s": round(m.sum, 6),
                "mn": m.min,
                "mx": m.max,
                "bc": list(m.bucket_counts),
            }
            bounds[name] = m.buckets
        elif isinstance(m, LabeledCounter):
            snap = m.snapshot()
            if snap:
                values[name] = snap
        elif isinstance(m, Counter):
            if m.value:
                values[name] = m.value
        elif isinstance(m, Gauge):
            v = m.value
            if isinstance(v, bool):
                continue
            if isinstance(v, (int, float)):
                values[name] = v
            elif isinstance(v, dict):
                numeric = {k: x for k, x in v.items()
                           if isinstance(x, (int, float))
                           and not isinstance(x, bool)}
                if numeric:
                    values[name] = numeric
    return values, bounds


class MetricsHistory:
    """Append-only writer side of the history ring.

    ``record()`` takes one snapshot, writes a delta (or a full line at
    segment start) and returns the ``(t, values)`` sample so callers —
    the watchtower keeps a bounded in-memory tail — never re-read their
    own writes.  ``source`` overrides the registry snapshot for tests.
    """

    SCHEMA = 1

    def __init__(
        self,
        out_dir: str,
        prefixes: Tuple[str, ...] = DEFAULT_PREFIXES,
        max_segment_bytes: int = 1 << 20,
        max_segments: int = 16,
        registry: Optional[MetricsRegistry] = None,
        source: Optional[
            Callable[[], Tuple[Dict[str, Any], Dict[str, Tuple[float, ...]]]]
        ] = None,
    ):
        self.out_dir = out_dir
        self.prefixes = tuple(prefixes)
        self.max_segment_bytes = max_segment_bytes
        self.max_segments = max(1, max_segments)
        self._registry = registry
        self._source = source
        self._lock = threading.Lock()
        self._fh = None
        self._seg_bytes = 0
        self._last: Dict[str, Any] = {}
        self.bucket_bounds: Dict[str, Tuple[float, ...]] = {}
        os.makedirs(out_dir, exist_ok=True)
        # continue the sequence left by prior daemon lifetimes; the new
        # process opens a fresh segment (its registry starts over, so
        # the segment-leading full snapshot is the restart seam marker)
        existing = _list_segments(out_dir)
        self._seq = (existing[-1][0] + 1) if existing else 0
        self.records = 0

    # -- write path ----------------------------------------------------

    def record(self, t: Optional[float] = None) -> Sample:
        """Snapshot, append one line, rotate if due; returns the sample."""
        t = time.time() if t is None else t
        if self._source is not None:
            values, bounds = self._source()
        else:
            values, bounds = encode_registry(self._registry, self.prefixes)
        with self._lock:
            self.bucket_bounds.update(bounds)
            if self._fh is None:
                self._open_segment(t, values, bounds)
            else:
                delta = {k: v for k, v in values.items()
                         if self._last.get(k) != v}
                if delta:
                    self._write_line({"t": round(t, 3), "m": delta})
            self._last = values
            if self._seg_bytes >= self.max_segment_bytes:
                self._close_segment()
            self.records += 1
        return t, values

    def close(self) -> None:
        with self._lock:
            self._close_segment()

    def _open_segment(self, t: float, values: Dict[str, Any],
                      bounds: Dict[str, Tuple[float, ...]]) -> None:
        path = os.path.join(self.out_dir, f"seg-{self._seq:08d}.jsonl")
        self._fh = open(path, "w", encoding="utf-8")
        self._seg_bytes = 0
        self._seq += 1
        self._write_line({
            "v": self.SCHEMA,
            "t": round(t, 3),
            "full": 1,
            "m": values,
            "hb": {k: list(v) for k, v in bounds.items()},
        })
        self._prune()

    def _close_segment(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            finally:
                self._fh = None

    def _write_line(self, obj: Dict[str, Any]) -> None:
        line = json.dumps(obj, separators=(",", ":")) + "\n"
        self._fh.write(line)
        self._fh.flush()
        self._seg_bytes += len(line)

    def _prune(self) -> None:
        segments = _list_segments(self.out_dir)
        while len(segments) > self.max_segments:
            seq, path = segments.pop(0)
            try:
                os.remove(path)
            except OSError:
                break


def _list_segments(out_dir: str) -> List[Tuple[int, str]]:
    try:
        names = os.listdir(out_dir)
    except OSError:
        return []
    out = []
    for n in names:
        m = _SEGMENT_RE.match(n)
        if m:
            out.append((int(m.group(1)), os.path.join(out_dir, n)))
    out.sort()
    return out


class HistoryReader:
    """Pure query API over a history directory.

    Replays full+delta lines into cumulative ``(t, values)`` samples.
    Never holds file handles between calls, so it can run against a
    directory a live daemon is writing to.
    """

    def __init__(self, dir_path: str):
        self.dir = dir_path
        self.bucket_bounds: Dict[str, Tuple[float, ...]] = {}

    def segments(self) -> List[Dict[str, Any]]:
        """One row per on-disk segment (for ``myth history segments``)."""
        rows = []
        for seq, path in _list_segments(self.dir):
            t0 = t1 = None
            lines = 0
            try:
                with open(path, encoding="utf-8") as f:
                    for line in f:
                        obj = _parse(line)
                        if obj is None:
                            continue
                        lines += 1
                        if t0 is None:
                            t0 = obj.get("t")
                        t1 = obj.get("t")
                size = os.path.getsize(path)
            except OSError:
                continue
            rows.append({"seq": seq, "path": path, "bytes": size,
                         "lines": lines, "t_first": t0, "t_last": t1})
        return rows

    def samples(
        self,
        since: Optional[float] = None,
        until: Optional[float] = None,
        names: Optional[Iterable[str]] = None,
    ) -> Iterator[Sample]:
        """Yield cumulative ``(t, values)`` samples in time order.

        ``names`` filters the yielded dicts (reconstruction always
        tracks everything — deltas don't respect filters).  Values are
        replaced wholesale per tick, never mutated in place, so the
        shallow copies yielded here stay stable after the generator
        advances.
        """
        wanted = set(names) if names is not None else None
        cur: Dict[str, Any] = {}
        for seq, path in _list_segments(self.dir):
            try:
                f = open(path, encoding="utf-8")
            except OSError:
                continue
            with f:
                for line in f:
                    obj = _parse(line)
                    if obj is None:
                        continue
                    t = obj.get("t")
                    if not isinstance(t, (int, float)):
                        continue
                    if obj.get("full"):
                        cur = dict(obj.get("m") or {})
                        for k, b in (obj.get("hb") or {}).items():
                            self.bucket_bounds[k] = tuple(b)
                    else:
                        cur.update(obj.get("m") or {})
                    if until is not None and t > until:
                        return
                    if since is not None and t < since:
                        continue
                    if wanted is None:
                        yield t, dict(cur)
                    else:
                        yield t, {k: v for k, v in cur.items()
                                  if k in wanted}

    def series(
        self,
        name: str,
        since: Optional[float] = None,
        until: Optional[float] = None,
    ) -> List[Tuple[float, Any]]:
        """``[(t, value)]`` for one metric (absent ticks are skipped)."""
        return [
            (t, vals[name])
            for t, vals in self.samples(since, until, names=(name,))
            if name in vals
        ]

    def latest(self) -> Optional[Sample]:
        last = None
        for s in self.samples():
            last = s
        return last


def _parse(line: str) -> Optional[Dict[str, Any]]:
    line = line.strip()
    if not line:
        return None
    try:
        obj = json.loads(line)
    except ValueError:
        return None  # torn tail line from a crashed writer
    return obj if isinstance(obj, dict) else None


# -- windowed evaluation over samples ------------------------------------
#
# These operate on any time-ordered [(t, values)] sequence.  A window is
# the delta between the last sample at-or-before t0 (baseline; zero when
# the history doesn't reach back that far) and the last sample
# at-or-before t1.  Negative deltas mean a restart seam crossed the
# window; the end-sample value is then used outright — "everything since
# the restart" is the conservative reading.


def _window_edges(
    samples: Iterable[Sample], t0: float, t1: float
) -> Tuple[Optional[Dict[str, Any]], Optional[Dict[str, Any]]]:
    s0 = s1 = None
    for t, vals in samples:
        if t > t1:
            break
        if t <= t0:
            s0 = vals
        s1 = vals
    return s0, s1


def histogram_window(
    samples: Iterable[Sample], name: str, t0: float, t1: float
) -> Optional[Dict[str, Any]]:
    """Bucket-count delta of histogram ``name`` over ``(t0, t1]``.

    Returns ``{"bc": [...], "count": n, "mn": ..., "mx": ...}`` or
    ``None`` when the metric never appears by ``t1``.  ``mn``/``mx`` are
    the end sample's lifetime extremes (extremes don't delta-encode);
    they only clamp the percentile estimate.
    """
    s0, s1 = _window_edges(samples, t0, t1)
    end = (s1 or {}).get(name)
    if not isinstance(end, dict) or "bc" not in end:
        return None
    c1 = end["bc"]
    base = (s0 or {}).get(name)
    c0 = base["bc"] if isinstance(base, dict) and "bc" in base else None
    if c0 is None or len(c0) != len(c1) or any(a < b for a, b in zip(c1, c0)):
        delta = list(c1)
    else:
        delta = [a - b for a, b in zip(c1, c0)]
    return {"bc": delta, "count": sum(delta),
            "mn": end.get("mn"), "mx": end.get("mx")}


def counter_window(
    samples: Iterable[Sample], name: str, t0: float, t1: float
) -> float:
    """Numeric delta of counter ``name`` over ``(t0, t1]`` (0 if absent)."""
    s0, s1 = _window_edges(samples, t0, t1)
    end = (s1 or {}).get(name, 0)
    base = (s0 or {}).get(name, 0)
    if not isinstance(end, (int, float)):
        return 0.0
    if not isinstance(base, (int, float)) or end < base:
        return float(end)
    return float(end - base)


def window_percentile(
    samples: Iterable[Sample],
    name: str,
    q: float,
    t0: float,
    t1: float,
    bounds: Dict[str, Tuple[float, ...]],
    min_count: int = 1,
) -> Tuple[Optional[float], int]:
    """``(estimate, window_count)`` for histogram ``name`` over the window.

    The estimate is ``None`` when the metric is missing, its bucket
    boundaries are unknown, or fewer than ``min_count`` observations
    landed in the window.
    """
    win = histogram_window(samples, name, t0, t1)
    b = bounds.get(name)
    if win is None or b is None or len(win["bc"]) != len(b) + 1:
        return None, 0
    n = win["count"]
    if n < max(1, min_count):
        return None, n
    est = percentile_from_buckets(b, win["bc"], q,
                                  lo_obs=win["mn"], hi_obs=win["mx"])
    return est, n
