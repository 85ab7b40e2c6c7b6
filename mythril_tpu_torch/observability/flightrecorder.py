"""Flight recorder: turn "the pod run hung" into an artifact.

Keeps no state of its own beyond a beat timestamp — the bounded span
ring already lives in the tracer and the queue-depth tail in the
heartbeat sampler.  What this module adds is the *dump triggers*:

* **unhandled exception** — chains ``sys.excepthook`` so the bundle is
  written before the traceback prints;
* **SIGUSR1** — operator-triggered snapshot of a live run
  (``kill -USR1 <pid>``), installed only when running on the main
  thread of a platform that has the signal;
* **watchdog** — a daemon thread that fires when no segment completes
  within a configurable deadline while the engine is inside an active
  window (``activity()`` context), catching silent stalls in chained
  dispatch or a wedged solver pool.

A bundle is one JSON file: the trigger reason, the tail of recent spans,
the full metrics snapshot, recent heartbeat samples, and a stack dump of
every live thread (``sys._current_frames``) — enough to attribute a hang
to the device fence, the feasibility pool, or a harvest worker without
reproducing it.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback
from typing import Any, Callable, Dict, Optional

__all__ = [
    "FlightRecorder",
    "arm_flight_recorder",
    "build_bundle",
    "disarm_flight_recorder",
    "get_flight_recorder",
    "register_flight_context",
    "unregister_flight_context",
    "register_dump_listener",
    "unregister_dump_listener",
    "beat",
    "activity",
]

SPAN_TAIL = 2000  # most recent spans included in a bundle

# Pluggable context providers: subsystems register a callable whose
# payload rides every bundle under ``bundle["context"][name]``.  The
# analysis service registers its active-request table here so a
# watchdog/SIGUSR1 snapshot of a stuck daemon names the requests (ids,
# tenants, phases) it was serving.  Module-level — survives recorder
# re-arms — and callables must be cheap and must not block.
_context_sources: Dict[str, Callable[[], Any]] = {}


def register_flight_context(name: str, fn: Callable[[], Any]) -> None:
    _context_sources[name] = fn


def unregister_flight_context(name: str) -> None:
    _context_sources.pop(name, None)


# Dump listeners run after every bundle write with (reason, path, bundle).
# The analysis service registers one to fan the dump out to its pool
# workers so a daemon bundle arrives with a linked bundle per process.
# Listeners must not raise and must not call dump() re-entrantly.
_dump_listeners: Dict[str, Callable[[str, str, Dict[str, Any]], None]] = {}


def register_dump_listener(
    name: str, fn: Callable[[str, str, Dict[str, Any]], None]
) -> None:
    _dump_listeners[name] = fn


def unregister_dump_listener(name: str) -> None:
    _dump_listeners.pop(name, None)


def build_bundle(reason: str, extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Assemble a flight bundle dict for this process without writing it.

    Module-level so a pool worker can answer the daemon's bundle request
    over the event queue without arming a recorder of its own; the armed
    recorder's ``dump`` builds on the same body.  The port's bundle also
    carries the device plane's ``device_meta()`` under ``device`` (the
    backend, ``cuda`` on the card, and the kernel builds and stamps so far).
    """
    from mythril_tpu_torch.observability import observability_meta
    from mythril_tpu_torch.observability.deviceplane import device_meta
    from mythril_tpu_torch.observability.heartbeat import get_heartbeat
    from mythril_tpu_torch.observability.tracer import get_tracer

    bundle: Dict[str, Any] = {
        "reason": reason,
        "time": time.time(),
        "pid": os.getpid(),
    }
    if extra:
        bundle.update(extra)
    try:
        bundle["observability"] = observability_meta()
    except Exception as e:  # never let the dump path throw
        bundle["observability_error"] = repr(e)
    try:
        bundle["device"] = device_meta()
    except Exception as e:
        bundle["device_error"] = repr(e)
    try:
        tracer = get_tracer()
        spans = tracer.spans()
        bundle["spans_tail"] = spans[-SPAN_TAIL:]
        bundle["spans_dropped"] = tracer.dropped
    except Exception as e:
        bundle["spans_error"] = repr(e)
    try:
        bundle["heartbeat_tail"] = get_heartbeat().recent_samples()
    except Exception as e:
        bundle["heartbeat_error"] = repr(e)
    for cname, fn in list(_context_sources.items()):
        ctx = bundle.setdefault("context", {})
        try:
            ctx[cname] = fn()
        except Exception as e:  # one bad source must not kill the dump
            ctx[cname] = {"error": repr(e)}
    bundle["threads"] = FlightRecorder._thread_stacks()
    return bundle


class FlightRecorder:
    def __init__(
        self,
        out_dir: str,
        watchdog_deadline_s: Optional[float] = None,
    ):
        self.out_dir = out_dir
        self.watchdog_deadline_s = watchdog_deadline_s
        self._lock = threading.Lock()
        self._armed = False
        self._prev_excepthook = None
        self._hook = None
        self._prev_sigusr1 = None
        self._watchdog: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._last_beat = time.perf_counter()
        self._active = 0
        self._watchdog_fired = False
        self._bundle_seq = 0
        self.bundles: list = []  # paths written, for tests/CLI summary

    # -- triggers ------------------------------------------------------

    def arm(self) -> None:
        if self._armed:
            return
        self._armed = True
        os.makedirs(self.out_dir, exist_ok=True)
        self._prev_excepthook = sys.excepthook
        # keep ONE bound-method object: attribute access mints a fresh one
        # each time, so disarm()'s identity check needs this exact reference
        self._hook = self._on_exception
        sys.excepthook = self._hook
        self._install_sigusr1()
        if self.watchdog_deadline_s:
            self._stop.clear()
            self._watchdog = threading.Thread(
                target=self._watch, name="mythril-watchdog", daemon=True
            )
            self._watchdog.start()

    def disarm(self) -> None:
        if not self._armed:
            return
        self._armed = False
        self._stop.set()
        if sys.excepthook is self._hook:
            sys.excepthook = self._prev_excepthook
        if self._prev_sigusr1 is not None:
            try:
                import signal

                signal.signal(signal.SIGUSR1, self._prev_sigusr1)
            except Exception:
                pass
            self._prev_sigusr1 = None
        w = self._watchdog
        if w is not None and w.is_alive():
            w.join(timeout=2.0)
        self._watchdog = None

    def _install_sigusr1(self) -> None:
        # signal handlers can only be installed from the main thread;
        # service-mode embeddings arm from workers and just skip this.
        try:
            import signal

            if not hasattr(signal, "SIGUSR1"):
                return
            if threading.current_thread() is not threading.main_thread():
                return
            self._prev_sigusr1 = signal.signal(
                signal.SIGUSR1, lambda _sig, _frm: self.dump("sigusr1")
            )
        except Exception:
            self._prev_sigusr1 = None

    def _on_exception(self, exc_type, exc, tb) -> None:
        try:
            self.dump(
                "exception",
                extra={
                    "exception": "".join(
                        traceback.format_exception(exc_type, exc, tb)
                    )[-8000:],
                },
            )
        finally:
            prev = self._prev_excepthook or sys.__excepthook__
            prev(exc_type, exc, tb)

    # -- watchdog ------------------------------------------------------

    def beat(self) -> None:
        """A segment completed — push the watchdog deadline out."""
        self._last_beat = time.perf_counter()
        self._watchdog_fired = False

    def activity(self) -> "_Activity":
        """Scope the watchdog: it only fires inside an activity window."""
        return _Activity(self)

    def _watch(self) -> None:
        deadline = self.watchdog_deadline_s
        tick = min(max(deadline / 4.0, 0.05), 1.0)
        while not self._stop.wait(tick):
            if self._active <= 0 or self._watchdog_fired:
                continue
            idle = time.perf_counter() - self._last_beat
            if idle > deadline:
                self._watchdog_fired = True  # once per stall, reset by beat()
                self.dump("watchdog", extra={"idle_s": round(idle, 3)})

    # -- bundle --------------------------------------------------------

    def dump(self, reason: str, extra: Optional[Dict[str, Any]] = None) -> str:
        """Write a bundle now; returns the path."""
        with self._lock:
            self._bundle_seq += 1
            seq = self._bundle_seq
        bundle = build_bundle(reason, extra)
        bundle["seq"] = seq
        # process-unique id so fanned-out worker bundles can link back
        bundle["bundle_id"] = f"{os.getpid()}-{seq}"
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(
            self.out_dir, f"flight-{reason}-{os.getpid()}-{seq}.json"
        )
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(bundle, f, indent=1, default=repr)
        os.replace(tmp, path)
        self.bundles.append(path)
        sys.stderr.write(f"[flight-recorder] {reason}: wrote {path}\n")
        for _lname, fn in list(_dump_listeners.items()):
            try:
                fn(reason, path, bundle)
            except Exception:
                pass
        return path

    @staticmethod
    def _thread_stacks() -> Dict[str, Any]:
        names = {t.ident: t.name for t in threading.enumerate()}
        out = {}
        for tid, frame in sys._current_frames().items():
            out[f"{names.get(tid, 'thread')}-{tid}"] = traceback.format_stack(
                frame
            )[-12:]
        return out


class _Activity:
    __slots__ = ("_rec",)

    def __init__(self, rec: FlightRecorder):
        self._rec = rec

    def __enter__(self):
        self._rec._last_beat = time.perf_counter()
        self._rec._active += 1
        return self

    def __exit__(self, *_exc):
        self._rec._active -= 1
        return False


class _NullActivity:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *_exc):
        return False


_NULL_ACTIVITY = _NullActivity()

_recorder: Optional[FlightRecorder] = None


def arm_flight_recorder(
    out_dir: str, watchdog_deadline_s: Optional[float] = None
) -> FlightRecorder:
    """Install (or re-point) the process flight recorder."""
    global _recorder
    if _recorder is not None:
        _recorder.disarm()
    _recorder = FlightRecorder(out_dir, watchdog_deadline_s)
    _recorder.arm()
    return _recorder


def disarm_flight_recorder() -> None:
    global _recorder
    if _recorder is not None:
        _recorder.disarm()
        _recorder = None


def get_flight_recorder() -> Optional[FlightRecorder]:
    return _recorder


def beat() -> None:
    """Segment-completion heartbeat; free when no recorder is armed."""
    r = _recorder
    if r is not None:
        r.beat()


def activity():
    """Watchdog window context; no-op when no recorder is armed."""
    r = _recorder
    return r.activity() if r is not None else _NULL_ACTIVITY
