"""Device telemetry plane: the card's side of the frontier as registry metrics.

The port's counterpart of ``mythril_tpu/observability/deviceplane.py``, with
the same metric names, scopes and surfaces.  What differs is where the
numbers come from:

* **Kernel builds.**  The JAX package listens to ``jax.monitoring`` for
  XLA's compile events.  The port's kernels are built by ``nvcc`` into one
  library (``ops/_build.py``), which reports here: a library that had to be
  built is a cache miss and a compile event with its wall
  (``on_compile``), one found on disk is a cache hit (``on_cache``).  Both
  are tagged with the calling thread's dispatch scope, and recompiles are
  counted per dispatch session as in the JAX package.
* **Segment and pull device time.**  ``stamp_begin`` / ``stamp_end`` put
  CUDA events (timing on) on the stream that runs the work, around a
  segment dispatch or a harvest pull.  Nothing reads them until a blocking
  point the frontier already has (``settle``, called after the pulls and
  the arena pull): a stamp whose end event has completed
  (``Event.query``, which does not wait) is published into
  ``frontier.segment_device_s`` / ``frontier.pull_device_s`` and their
  per-bucket ``_sum`` / ``_count`` series; one still in flight waits for
  the next blocking point.  A partitioned segment over several cards is
  stamped on every card's stream, and its ``frontier.segment_device_s`` is
  the longest card's span (the segment ends with its last card); a pull of
  its blocks likewise.  The plane adds no synchronisation and reads no
  device value on the host.  On the CPU the stamps are host clocks, as the
  JAX plane's are on a CPU backend.
* **Analysis.**  There is no XLA cost analysis: ``device.flops_per_segment``
  is never set, and each harvest counts
  ``device.analysis_unavailable{reason="cost_analysis:none"}`` instead of
  reading as a zero.  ``device.hbm_bytes{bucket}`` is the caching
  allocator's peak (``torch.cuda.max_memory_allocated`` after a reset)
  across a bucket's first dispatch; on the CPU there is no such allocator
  and the reason is ``memory_analysis:none``.

All ``device.*`` metrics are ``persistent=True``: build history survives
the per-analysis registry sweep.  Time spent inside the plane is
self-measured into ``device.plane_overhead_s``.
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional, Sequence

from mythril_tpu_torch.observability.metrics import get_registry

__all__ = [
    "bucket_tag",
    "current_bucket",
    "device_meta",
    "dispatch_scope",
    "harvest_analysis",
    "heartbeat_source",
    "install",
    "install_deviceplane",
    "installed",
    "note_backend",
    "observe_pull",
    "observe_segment",
    "on_cache",
    "on_compile",
    "reset_for_tests",
    "settle",
    "stamp_begin",
    "stamp_end",
]

_UNTAGGED = "untagged"

_install_lock = threading.Lock()
_installed = False

# dispatch attribution is per-thread: a kernel library is built on the
# thread whose first launch needs it, so a thread-local scope is exact
_ctx = threading.local()

# tag -> dispatch-scope session id of its last build (see on_compile)
_compiled_tags: Dict[str, int] = {}
_session_seq = [0]
# bucket tags whose memory analysis has been harvested
_analyzed_tags: set = set()
# stamps waiting for their end event, in the order they were taken
_pending: List["_Stamp"] = []
_pending_lock = threading.Lock()


def bucket_tag(bucket: Sequence[int]) -> str:
    """Canonical label for a size bucket: ``"CCxICxACxLC"``."""
    return "x".join(str(int(b)) for b in bucket)


def current_bucket() -> Optional[str]:
    """Bucket tag of the innermost active dispatch scope, if any."""
    return getattr(_ctx, "bucket", None)


@contextmanager
def dispatch_scope(bucket) -> Iterator[None]:
    """Tag the calling thread with the dispatching bucket shape.

    ``bucket`` is either the 4-tuple ``(code_cap, instr_cap, addr_cap,
    loops_cap)`` or an already-formatted tag string.  Scopes nest; the
    innermost wins.
    """
    tag = bucket if isinstance(bucket, str) else bucket_tag(bucket)
    prev = getattr(_ctx, "bucket", None)
    prev_session = getattr(_ctx, "session", 0)
    with _install_lock:
        _session_seq[0] += 1
        _ctx.session = _session_seq[0]
    _ctx.bucket = tag
    try:
        yield
    finally:
        _ctx.bucket = prev
        _ctx.session = prev_session


def _overhead(t0: float) -> None:
    get_registry().counter("device.plane_overhead_s", persistent=True,
                           initial=0.0).inc(time.perf_counter() - t0)


# -- kernel builds (ops/_build.py) -----------------------------------------


def on_compile(duration_secs: float) -> None:
    """One kernel library built by nvcc, ``duration_secs`` of wall."""
    t0 = time.perf_counter()
    reg = get_registry()
    tag = current_bucket() or _UNTAGGED
    reg.observe("device.compile_wall_s", duration_secs)
    reg.counter("device.compile_wall_s_total", persistent=True,
                initial=0.0).inc(duration_secs)
    reg.labeled_counter("device.compile_wall_s_by_bucket", persistent=True,
                        label_name="bucket").inc(tag, duration_secs)
    session = getattr(_ctx, "session", 0)
    with _install_lock:
        prev_session = _compiled_tags.get(tag)
        _compiled_tags[tag] = session
        n_shapes = len(_compiled_tags)
    if prev_session is None:
        reg.counter("device.shapes_compiled_total", persistent=True).inc()
        if n_shapes > 1:
            # every distinct shape beyond the first is churn
            reg.counter("device.shape_churn_total", persistent=True).inc()
    elif prev_session != session:
        # the same tag building again in a later dispatch session: a
        # library we had already paid for was built again
        reg.counter("device.recompiles_total", persistent=True).inc()
        reg.labeled_counter("device.recompiles_by_bucket", persistent=True,
                            label_name="bucket").inc(tag)
    _overhead(t0)


def on_cache(hit: bool) -> None:
    """A kernel library found on disk (``hit``) or one that must be built."""
    reg = get_registry()
    tag = current_bucket() or _UNTAGGED
    kind = "hits" if hit else "misses"
    reg.counter("device.cache_" + kind, persistent=True).inc()
    reg.labeled_counter("device.cache_%s_by_bucket" % kind, persistent=True,
                        label_name="bucket").inc(tag)


def install() -> bool:
    """Switch the plane on and register its heartbeat source (idempotent).
    Returns True when it is active; ``MYTHRIL_DEVICEPLANE=0`` keeps it off."""
    global _installed
    if _installed:
        return True
    if os.environ.get("MYTHRIL_DEVICEPLANE", "1") in ("0", "false", "off"):
        return False
    with _install_lock:
        if _installed:
            return True
        from mythril_tpu_torch.observability.heartbeat import get_heartbeat

        get_heartbeat().register("device", heartbeat_source)
        _installed = True
    return True


def installed() -> bool:
    return _installed


# package-level re-export name ("install" is too generic outside the
# deviceplane namespace)
install_deviceplane = install


# -- device-time stamps ----------------------------------------------------


def _stamp(base: str, seconds: float, tag: Optional[str]) -> None:
    t0 = time.perf_counter()
    reg = get_registry()
    tag = tag or current_bucket() or _UNTAGGED
    reg.observe(base, float(seconds))
    # no labeled-histogram kind exists; a per-bucket sum/count pair is
    # the standard exposition (avg-by-bucket in one PromQL division)
    reg.labeled_counter(base + "_sum", persistent=True,
                        label_name="bucket").inc(tag, float(seconds))
    reg.labeled_counter(base + "_count", persistent=True,
                        label_name="bucket").inc(tag)
    _overhead(t0)


def observe_segment(seconds: float, tag: Optional[str] = None) -> None:
    """Record one segment's device time."""
    _stamp("frontier.segment_device_s", seconds, tag)


def observe_pull(seconds: float, tag: Optional[str] = None) -> None:
    """Record one device->host harvest pull's device time."""
    _stamp("frontier.pull_device_s", seconds, tag)


class _Stamp:
    """Two CUDA events (timing on) on one stream of each card, or two host
    clocks."""

    __slots__ = ("base", "tag", "start", "end", "t0", "t1", "devices")

    def __init__(self, device):
        import torch

        devices = list(dict.fromkeys(device)) if isinstance(device, (list, tuple)) else [device]
        self.base = self.tag = None
        self.start = self.end = None
        self.t0 = self.t1 = None
        self.devices = [torch.device(d) for d in devices]
        if self.devices[0].type == "cuda":
            self.start = []
            for d in self.devices:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record(torch.cuda.current_stream(d))
                self.start.append(ev)
        else:
            self.t0 = time.perf_counter()

    def record_end(self) -> None:
        import torch

        if self.start is not None:
            self.end = []
            for d in self.devices:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record(torch.cuda.current_stream(d))
                self.end.append(ev)
        else:
            self.t1 = time.perf_counter()

    def done(self) -> bool:
        return self.end is None or all(e.query() for e in self.end)

    def seconds(self) -> float:
        if self.end is None:
            return self.t1 - self.t0
        return max(s.elapsed_time(e) for s, e in zip(self.start, self.end)) / 1000.0


def stamp_begin(device) -> _Stamp:
    """Start timing work queued next on the current stream of ``device``
    (a CUDA event recorded there), or on the host clock for the CPU.
    ``device`` may be a list of cards (a partitioned segment's): an event
    on each one's current stream, and the stamp is the longest card's
    span, the segment's device time, which ends with its last card."""
    return _Stamp(device)


def stamp_end(stamp: _Stamp, base: str, tag: Optional[str] = None) -> None:
    """Close ``stamp`` behind the work queued since ``stamp_begin`` on the
    current stream and queue it for ``settle``; ``base`` is the histogram
    (``"frontier.segment_device_s"`` or ``"frontier.pull_device_s"``),
    ``tag`` the bucket (default: the current dispatch scope)."""
    t0 = time.perf_counter()
    stamp.base = base
    stamp.tag = tag or current_bucket() or _UNTAGGED
    stamp.record_end()
    with _pending_lock:
        _pending.append(stamp)
    _overhead(t0)


def settle(final: bool = False) -> int:
    """Publish every queued stamp whose end event has completed; called at
    the frontier's blocking points, so no stamp is read before its work is
    done and the host never waits here.  ``final``: the caller has waited
    for everything queued (the run's last read), so a stamp still in
    flight is an error.  -> the number of stamps published."""
    with _pending_lock:
        if not _pending:
            return 0
        ready = [s for s in _pending if s.done()]
        left = [s for s in _pending if s not in ready]
        _pending[:] = left
    if final and left:
        raise RuntimeError(f"{len(left)} device-time stamps still in flight "
                           "after the frontier's last blocking read")
    for s in ready:
        _stamp(s.base, s.seconds(), s.tag)
    return len(ready)


# -- memory analysis -------------------------------------------------------


def _analysis_unavailable(reason: str) -> None:
    get_registry().labeled_counter(
        "device.analysis_unavailable", persistent=True, label_name="reason"
    ).inc(reason)


def _set_bucket_gauge(name: str, tag: str, value: float) -> None:
    g = get_registry().gauge(name, persistent=True, default={},
                             label_name="bucket")
    cur = g.value if isinstance(g.value, dict) else {}
    nxt = dict(cur)
    nxt[tag] = value
    g.set(nxt)


@contextmanager
def harvest_analysis(device, tag: str) -> Iterator[None]:
    """Around a bucket's dispatch: the first time ``tag`` dispatches, the
    caching allocator's peak across the body (reset before, read after:
    both host-side allocator statistics, no synchronisation) becomes
    ``device.hbm_bytes{tag}``.  Every later dispatch of the tag, and every
    dispatch with ``MYTHRIL_DEVICE_ANALYSIS=0``, runs the body alone."""
    import torch

    first = os.environ.get("MYTHRIL_DEVICE_ANALYSIS", "1") not in (
        "0", "false", "off")
    if first:
        with _install_lock:
            first = tag not in _analyzed_tags
            _analyzed_tags.add(tag)
    cuda = torch.device(device).type == "cuda"
    if first and cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    yield
    if not first:
        return
    # no XLA cost analysis exists for a hand-written kernel: absence, not 0
    _analysis_unavailable("cost_analysis:none")
    if not cuda:
        _analysis_unavailable("memory_analysis:none")
    else:
        peak = torch.cuda.max_memory_allocated(device)
        if peak > 0:
            _set_bucket_gauge("device.hbm_bytes", tag, float(peak))
        else:
            _analysis_unavailable("memory_analysis:empty")
    get_registry().observe("device.analysis_harvest_s", time.perf_counter() - t0)


# -- surfaces --------------------------------------------------------------


def _counter_value(reg, name: str) -> float:
    m = reg._metrics.get(name)
    return m.value if m is not None and hasattr(m, "value") else 0


def _gauge_dict(reg, name: str) -> Dict[str, Any]:
    m = reg._metrics.get(name)
    v = getattr(m, "value", None)
    return dict(v) if isinstance(v, dict) else {}


def _labeled_dict(reg, name: str) -> Dict[str, Any]:
    m = reg._metrics.get(name)
    return dict(m) if m is not None and isinstance(m, dict) else {}


_backend = [None]


def note_backend(device) -> None:
    """Remember the device an analysis runs on (``analysis_device``): its
    type is ``device_meta()["backend"]``.  None is the card."""
    import torch

    _backend[0] = "cuda" if device is None else torch.device(device).type


def _backend_name() -> str:
    """"cuda" or "cpu": the last analysis's device, else the default one."""
    if _backend[0] is None:
        import torch

        return "cuda" if torch.cuda.is_available() else "cpu"
    return _backend[0]


def device_meta() -> Dict[str, Any]:
    """The ``meta.device`` block for jsonv2 reports.

    Pure read of the registry, the JAX package's keys — safe without
    install() (everything reads zero/absent) and cheap enough for every
    report.
    """
    reg = get_registry()
    out: Dict[str, Any] = {"enabled": _installed, "backend": _backend_name()}
    out["compile_wall_s"] = round(
        float(_counter_value(reg, "device.compile_wall_s_total")), 3)
    hist = reg._metrics.get("device.compile_wall_s")
    out["compiles"] = getattr(hist, "count", 0)
    out["recompiles"] = int(_counter_value(reg, "device.recompiles_total"))
    out["shape_churn"] = int(_counter_value(reg, "device.shape_churn_total"))
    out["cache"] = {
        "hits": int(_counter_value(reg, "device.cache_hits")),
        "misses": int(_counter_value(reg, "device.cache_misses")),
    }
    by_bucket = _labeled_dict(reg, "device.compile_wall_s_by_bucket")
    out["compile_wall_s_by_bucket"] = {
        k: round(float(v), 3) for k, v in sorted(by_bucket.items())
    }
    flops = _gauge_dict(reg, "device.flops_per_segment")
    if flops:
        out["flops_per_segment"] = flops
    hbm = _gauge_dict(reg, "device.hbm_bytes")
    if hbm:
        out["hbm_bytes"] = hbm
    seg = reg._metrics.get("frontier.segment_device_s")
    if seg is not None and getattr(seg, "count", 0):
        out["segment_device_s"] = {
            "count": seg.count,
            "sum": round(seg.sum, 3),
            "p50": round(seg.percentile(0.5) or 0.0, 6),
            "p95": round(seg.percentile(0.95) or 0.0, 6),
        }
    unavailable = _labeled_dict(reg, "device.analysis_unavailable")
    if unavailable:
        out["analysis_unavailable"] = dict(sorted(unavailable.items()))
    overhead = float(_counter_value(reg, "device.plane_overhead_s"))
    wall = getattr(seg, "sum", 0.0) or 0.0
    out["overhead_pct"] = round(100.0 * overhead / wall, 4) if wall else 0.0
    return out


def heartbeat_source() -> Dict[str, Any]:
    """Heartbeat gauges: build wall / recompiles / churn trajectory."""
    reg = get_registry()
    return {
        "heartbeat.device_compile_s": round(
            float(_counter_value(reg, "device.compile_wall_s_total")), 3),
        "heartbeat.device_recompiles": int(
            _counter_value(reg, "device.recompiles_total")),
        "heartbeat.device_shape_churn": int(
            _counter_value(reg, "device.shape_churn_total")),
    }


def reset_for_tests() -> None:
    """Forget attribution state (built tags, harvested buckets, queued
    stamps).  Registry metrics are reset separately via
    ``MetricsRegistry.reset``."""
    with _install_lock:
        _compiled_tags.clear()
        _analyzed_tags.clear()
    with _pending_lock:
        _pending.clear()
