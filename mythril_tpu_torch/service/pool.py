"""Horizontal worker pool: N analysis worker processes, one event plane.

The pool owns process lifecycle and nothing else — admission, flights,
telemetry and result caching stay in the daemon, which keeps the
admission plane thin (the EVMx host/accelerator split, applied to
serving).  Each worker gets a private job queue (so a job's owner is
always known, and a dead worker's in-flight loss is exactly its current
job); all workers share one event queue the pool's pump thread drains
into the daemon's callback.

Crash containment: the pump doubles as a liveness monitor.  A worker
process that dies without sending ``done`` (SIGKILL, OOM, segfault in a
native solver) is detected by ``Process.is_alive()``; the pool emits a
synthetic ``("worker_died", worker_id, job_id, pid)`` event — the daemon
errors only that job's requests and dumps a flight-recorder bundle — and
respawns a fresh worker process in its slot.  Nothing is silently
requeued: a lost request errors, visibly, exactly once.
"""

from __future__ import annotations

import itertools
import logging
import multiprocessing
import queue as queue_mod
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from mythril_tpu_torch.service.worker import worker_main

log = logging.getLogger(__name__)

__all__ = ["WorkerHandle", "WorkerPool"]

# states a worker slot moves through
STARTING = "starting"
IDLE = "idle"
BUSY = "busy"
DEAD = "dead"
STOPPING = "stopping"


class WorkerHandle:
    """One worker slot: a process, its private job queue, and its state.

    The slot survives its process — ``respawn`` replaces a dead process
    in place, bumping ``restarts``, so worker ids are stable for
    telemetry (``myth top`` shows w0..wN-1 for the daemon's lifetime).
    """

    def __init__(self, worker_id: int, config: Dict[str, Any],
                 event_q, mp_ctx):
        self.id = worker_id
        self.config = config
        self.event_q = event_q
        self._mp = mp_ctx
        self.restarts = 0
        self.batches = 0
        self.state = DEAD
        self.current_job: Optional[int] = None
        self.proc = None
        self.job_q = None
        self.control_q = None
        self.started_at = 0.0

    def spawn(self) -> None:
        self.job_q = self._mp.Queue()
        # fresh control queue per process: a queue fed to a dead process
        # may hold a wedged feeder thread, and the respawned worker must
        # not replay the old process's control backlog
        self.control_q = self._mp.Queue()
        self.proc = self._mp.Process(
            target=worker_main,
            args=(self.id, self.config, self.job_q, self.event_q,
                  self.control_q),
            name=f"service-worker-{self.id}",
            daemon=True,
        )
        self.state = STARTING
        self.current_job = None
        self.started_at = time.time()
        self.proc.start()

    def respawn(self) -> None:
        self.restarts += 1
        self.spawn()

    def alive(self) -> bool:
        return self.proc is not None and self.proc.is_alive()

    @property
    def pid(self) -> Optional[int]:
        return self.proc.pid if self.proc is not None else None

    def stats(self) -> Dict[str, Any]:
        return {
            "id": self.id,
            "pid": self.pid,
            "state": self.state,
            "job": self.current_job,
            "batches": self.batches,
            "restarts": self.restarts,
            "age_s": round(time.time() - self.started_at, 1)
            if self.started_at else 0.0,
        }


class WorkerPool:
    """N worker processes behind one pump thread.

    ``on_event`` is invoked in the pump thread for every worker event
    (after the pool updates slot state), including the synthetic
    ``worker_died``.  The callback must never raise for long — it owns
    flight fan-out, which is lock-bounded, not engine-bounded.
    """

    def __init__(self, n: int, config: Dict[str, Any],
                 on_event: Callable[[tuple], None]):
        if n < 1:
            raise ValueError("worker pool needs at least 1 worker")
        self._mp = multiprocessing.get_context("spawn")
        self.event_q = self._mp.Queue()
        self.on_event = on_event
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._stopping = False
        self._ready_once: set = set()
        self._all_ready = threading.Event()
        self.handles: List[WorkerHandle] = [
            WorkerHandle(i, config, self.event_q, self._mp) for i in range(n)
        ]
        self._job_ids = itertools.count(1)
        for h in self.handles:
            h.spawn()
        self._pump = threading.Thread(
            target=self._pump_loop, name="service-pool-pump", daemon=True
        )
        self._pump.start()

    # -- daemon side ---------------------------------------------------

    def new_job_id(self) -> int:
        return next(self._job_ids)

    def acquire(self, timeout: Optional[float] = None
                ) -> Optional[WorkerHandle]:
        """Block until a worker is idle; claim and return it (or None)."""
        deadline = None if timeout is None else time.perf_counter() + timeout
        with self._idle:
            while True:
                if self._stopping:
                    return None
                for h in self.handles:
                    if h.state == IDLE:
                        h.state = BUSY
                        return h
                remaining = None if deadline is None \
                    else deadline - time.perf_counter()
                if remaining is not None and remaining <= 0:
                    return None
                self._idle.wait(timeout=remaining if remaining is not None
                                else 0.5)

    def release(self, handle: WorkerHandle) -> None:
        """Return a claimed-but-undispatched worker to the idle set."""
        with self._idle:
            if handle.state == BUSY and handle.current_job is None:
                handle.state = IDLE
                self._idle.notify_all()

    def dispatch(self, handle: WorkerHandle, job_id: int,
                 flights: List[Dict[str, Any]],
                 options: Dict[str, Any]) -> None:
        """Send one batch job to a claimed worker."""
        with self._lock:
            handle.current_job = job_id
            handle.batches += 1
        handle.job_q.put(("batch", job_id, flights, options))

    def wait_ready(self, timeout: Optional[float] = None) -> bool:
        """Block until every worker has reported ready at least once."""
        return self._all_ready.wait(timeout)

    def control(self, worker_id: int, msg: tuple) -> bool:
        """Send one control message to a live worker's control thread."""
        with self._lock:
            if not 0 <= worker_id < len(self.handles):
                return False
            h = self.handles[worker_id]
            if not h.alive() or h.control_q is None:
                return False
            q = h.control_q
        try:
            q.put(msg)
            return True
        except Exception:
            return False

    def broadcast_control(self, msg: tuple) -> List[int]:
        """Send a control message to every live worker; returns their ids."""
        reached = []
        for h in self.handles:
            if self.control(h.id, msg):
                reached.append(h.id)
        return reached

    def stats(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [h.stats() for h in self.handles]

    def depths(self) -> Dict[str, int]:
        """Heartbeat payload: worker-slot states at a glance."""
        with self._lock:
            states = [h.state for h in self.handles]
        return {
            "service.workers": len(states),
            "service.workers_idle": states.count(IDLE),
            "service.workers_busy": states.count(BUSY),
            "service.workers_starting": states.count(STARTING),
        }

    def total_restarts(self) -> int:
        with self._lock:
            return sum(h.restarts for h in self.handles)

    def stop(self, timeout: float = 30.0) -> None:
        """Graceful stop: ask every worker to exit, then reap."""
        with self._idle:
            self._stopping = True
            self._idle.notify_all()
        for h in self.handles:
            if h.alive() and h.job_q is not None:
                try:
                    h.job_q.put(("stop",))
                except Exception:
                    pass
        deadline = time.perf_counter() + timeout
        for h in self.handles:
            if h.proc is None:
                continue
            h.proc.join(timeout=max(deadline - time.perf_counter(), 0.1))
            if h.proc.is_alive():
                log.warning("worker %d did not drain; terminating", h.id)
                h.proc.terminate()
                h.proc.join(timeout=5.0)
            h.state = DEAD
        self._pump.join(timeout=5.0)

    # -- pump thread ---------------------------------------------------

    def _pump_loop(self) -> None:
        """Drain worker events + watch liveness until stop completes."""
        while True:
            try:
                msg = self.event_q.get(timeout=0.2)
            except queue_mod.Empty:
                msg = None
            if msg is not None:
                self._handle_event(msg)
            self._check_liveness()
            if self._stopping and all(
                not h.alive() for h in self.handles
            ):
                return

    def _handle_event(self, msg: tuple) -> None:
        kind = msg[0]
        wid = msg[1]
        handle = self.handles[wid]
        if kind == "ready":
            with self._idle:
                handle.state = IDLE
                self._idle.notify_all()
            self._ready_once.add(wid)
            if len(self._ready_once) == len(self.handles):
                self._all_ready.set()
        elif kind == "done":
            job_id = msg[2]
            with self._idle:
                if handle.current_job == job_id:
                    handle.current_job = None
                    handle.state = IDLE if not self._stopping else STOPPING
                    self._idle.notify_all()
        elif kind == "stopped":
            with self._lock:
                handle.state = STOPPING
        try:
            self.on_event(msg)
        except Exception:
            log.exception("pool event callback failed for %r", kind)

    def _check_liveness(self) -> None:
        for h in self.handles:
            if h.state in (DEAD, STOPPING) or h.proc is None:
                continue
            if h.proc.is_alive():
                continue
            # a worker died without a terminal message
            with self._idle:
                lost_job, pid = h.current_job, h.pid
                h.current_job = None
                h.state = DEAD
            if self._stopping and lost_job is None:
                continue  # normal exit race during shutdown
            log.error("worker %d (pid %s) died%s", h.id, pid,
                      f" holding job {lost_job}" if lost_job else "")
            if not self._stopping:
                h.respawn()
                with self._idle:
                    self._idle.notify_all()
            try:
                self.on_event(("worker_died", h.id, lost_job, pid))
            except Exception:
                log.exception("pool worker_died callback failed")
