"""JSON-lines TCP front end for the analysis service (``myth serve``).

Deliberately thin: one request line in, a stream of event lines out —
the protocol mirrors the in-process ``ResultStream`` one-to-one so the
daemon, not the transport, owns ordering and isolation.

Protocol (UTF-8, one JSON object per line):

    -> {"op": "submit", "code": "<hex>", "name": "...", "tier": "batch"}
    <- {"event": "accepted", "request_id": "...", "deduped": false}
    <- {"event": "issue", "swc_id": "106", ...}          (0..n, as they confirm)
    <- {"event": "done", "issues": [...], "elapsed_s": 1.2}
  or <- {"event": "error", "error": "..."}

    -> {"op": "ping"}    <- {"event": "pong"}
    -> {"op": "stats"}   <- {"event": "stats", ...counters...}
    -> {"op": "metrics"} <- {"event": "metrics", "text": "<prometheus>"}
    -> {"op": "profile", "worker": 0, "duration_s": 1.0}
    <- {"event": "profile", "ok": true, "dir": "...", "worker": 0}

``metrics`` concatenates the daemon-local registry with the fleet's
worker-labeled series (``fleet_*{worker="N"}`` plus unlabeled rollups)
when a worker pool is running, so one scrape is pool-wide truth.
``profile`` opens a windowed ``torch.profiler`` capture inside the chosen
worker (the daemon process in inline mode) and blocks until the window
closes; the capture directory lands under ``--cache-root``.

``submit`` also accepts an optional ``"tenant"`` label for per-tenant
accounting and ``"detach": true`` — the handler then answers with the
``accepted`` line only and returns the connection, instead of holding a
handler thread open for the whole analysis.  A detached client follows
up over fresh connections with the long-poll op:

    -> {"op": "poll", "request_id": "...", "cursor": 0, "wait_s": 10}
    <- {"event": "poll", "events": [{"kind": ..., "payload": ...}],
        "cursor": 3, "closed": false}

which blocks server-side at most ``wait_s`` for the first event past
``cursor`` — an idle subscriber holds no worker and no thread between
polls.  A submission refused by scheduling policy (tenant quota, load
shed) answers ``{"event": "error", "error": ..., "rejected":
"quota"|"shed"}`` immediately.

``metrics`` returns the full registry in the Prometheus text exposition
format (``content_type`` names the version) so one sidecar bridge can
serve it over HTTP unmodified.

``run_server`` installs SIGTERM/SIGINT handlers that stop accepting,
drain every in-flight request (subscribers still receive their streamed
issues and terminal events), then exit — the graceful-shutdown contract
a deployment's rolling restart relies on.
"""

from __future__ import annotations

import json
import logging
import signal
import socket
import socketserver
import threading
from typing import Optional, Tuple

from mythril_tpu_torch.service.daemon import AnalysisService, ServiceConfig
from mythril_tpu_torch.service.request import AnalysisOptions

log = logging.getLogger(__name__)

__all__ = ["AnalysisServer", "run_server"]

#: bound on one request line (code is hex: 2 chars/byte; EVM contracts
#: cap at 24KiB runtime, so 1MiB is generous headroom for options)
MAX_LINE = 1 << 20


class _Handler(socketserver.StreamRequestHandler):
    def handle(self) -> None:
        service: AnalysisService = self.server.service  # type: ignore[attr-defined]
        try:
            line = self.rfile.readline(MAX_LINE)
            if not line:
                return
            try:
                msg = json.loads(line)
            except ValueError:
                self._send({"event": "error", "error": "malformed JSON"})
                return
            op = msg.get("op")
            if op == "ping":
                self._send({"event": "pong"})
            elif op == "stats":
                self._send({"event": "stats", **service.stats()})
            elif op == "health":
                self._send({"event": "health", **service.health()})
            elif op == "metrics":
                from mythril_tpu_torch.observability.metrics import prometheus_text

                # daemon-local registry first, then the fleet rollup of
                # worker-labeled series (empty string in inline mode)
                self._send({
                    "event": "metrics",
                    "content_type": "text/plain; version=0.0.4",
                    "text": prometheus_text()
                    + service.fleet_prometheus_text(),
                })
            elif op == "profile":
                self._send({
                    "event": "profile",
                    **service.profile(
                        worker_id=int(msg.get("worker", 0)),
                        duration_s=float(msg.get("duration_s", 1.0)),
                    ),
                })
            elif op == "submit":
                self._submit(service, msg)
            elif op == "poll":
                self._poll(service, msg)
            else:
                self._send({"event": "error", "error": f"unknown op {op!r}"})
        except (BrokenPipeError, ConnectionResetError):
            pass  # client went away; the flight finishes for other subscribers

    def _submit(self, service: AnalysisService, msg: dict) -> None:
        try:
            options = None
            if any(k in msg for k in (
                "transaction_count", "modules", "strategy",
                "execution_timeout", "coverage_target",
            )):
                base = service.config.default_options
                raw_target = msg.get("coverage_target", base.coverage_target)
                options = AnalysisOptions(
                    transaction_count=int(
                        msg.get("transaction_count", base.transaction_count)
                    ),
                    modules=tuple(msg["modules"]) if msg.get("modules")
                    else base.modules,
                    strategy=msg.get("strategy", base.strategy),
                    execution_timeout=int(
                        msg.get("execution_timeout", base.execution_timeout)
                    ),
                    coverage_target=float(raw_target)
                    if raw_target is not None else None,
                )
            request, stream, deduped = service.submit(
                msg.get("code", ""),
                name=msg.get("name"),
                tier=msg.get("tier", "batch"),
                options=options,
                tenant=msg.get("tenant"),
            )
        except (ValueError, RuntimeError) as exc:
            err = {"event": "error", "error": str(exc)}
            kind = getattr(exc, "kind", None)
            if kind is not None:  # AdmissionRejected: quota | shed
                err["rejected"] = kind
            self._send(err)
            return
        self._send({
            "event": "accepted",
            "request_id": request.request_id,
            "codehash": request.codehash,
            "deduped": deduped,
        })
        if msg.get("detach"):
            return  # client follows up via {"op": "poll"}
        for kind, payload in stream.events():
            if kind == "issue":
                self._send({"event": "issue", **payload})
            elif kind == "error":
                self._send({"event": "error", "error": payload})
            else:
                self._send({"event": "done", **payload})

    def _poll(self, service: AnalysisService, msg: dict) -> None:
        try:
            out = service.poll(
                str(msg.get("request_id", "")),
                cursor=int(msg.get("cursor", 0)),
                wait_s=float(msg.get("wait_s", 0.0)),
            )
        except KeyError as exc:
            self._send({"event": "error", "error": str(exc)})
            return
        self._send({
            "event": "poll",
            "events": [
                {"kind": kind, "payload": payload}
                for kind, payload in out["events"]
            ],
            "cursor": out["cursor"],
            "closed": out["closed"],
        })

    def _send(self, obj: dict) -> None:
        self.wfile.write((json.dumps(obj) + "\n").encode())
        self.wfile.flush()


class _TCPServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True  # handler threads must not block process exit


class AnalysisServer:
    """Socket server + service lifecycle, embeddable in tests."""

    def __init__(
        self,
        config: Optional[ServiceConfig] = None,
        host: str = "127.0.0.1",
        port: int = 0,
    ):
        self.service = AnalysisService(config)
        self._tcp = _TCPServer((host, port), _Handler)
        self._tcp.service = self.service  # type: ignore[attr-defined]
        self._serve_thread: Optional[threading.Thread] = None

    @property
    def address(self) -> Tuple[str, int]:
        return self._tcp.server_address[:2]

    def start(self) -> "AnalysisServer":
        self.service.start()
        self._serve_thread = threading.Thread(
            target=self._tcp.serve_forever, name="service-accept", daemon=True
        )
        self._serve_thread.start()
        log.info("analysis service listening on %s:%d", *self.address)
        return self

    def stop(self, drain: bool = True, timeout: Optional[float] = None) -> bool:
        """Stop accepting, drain in-flight work, close the socket."""
        drained = self.service.stop(drain=drain, timeout=timeout)
        self._tcp.shutdown()
        self._tcp.server_close()
        t = self._serve_thread
        if t is not None and t.is_alive():
            t.join(timeout=5.0)
        self._serve_thread = None
        return drained


def run_server(
    config: Optional[ServiceConfig] = None,
    host: str = "127.0.0.1",
    port: int = 7344,
    drain_timeout: Optional[float] = None,
) -> int:
    """Blocking entry point for ``myth serve``; returns an exit code.

    SIGTERM/SIGINT trigger a graceful drain: no new submissions, every
    in-flight flight runs to its terminal event, then the socket closes.
    A device fault that stopped the service (``AnalysisService.fault``)
    closes it the same way, and the exit code is 1.
    """
    server = AnalysisServer(config, host=host, port=port).start()
    stop = threading.Event()

    def _on_signal(signum, _frame):
        log.info("signal %d: draining analysis service", signum)
        stop.set()

    prev = {
        sig: signal.signal(sig, _on_signal)
        for sig in (signal.SIGTERM, signal.SIGINT)
    }
    try:
        print(f"analysis service listening on {server.address[0]}:"
              f"{server.address[1]}", flush=True)
        while not stop.wait(0.2):
            if server.service.fault is not None:
                log.error("analysis service stopped by a device fault: %r",
                          server.service.fault)
                break
        drained = server.stop(drain=True, timeout=drain_timeout)
        return 0 if drained and server.service.fault is None else 1
    finally:
        for sig, handler in prev.items():
            signal.signal(sig, handler)


def wait_for_server(host: str, port: int, timeout: float = 30.0) -> bool:
    """Poll until the server accepts connections (CI smoke helper)."""
    import time as _time

    deadline = _time.time() + timeout
    while _time.time() < deadline:
        try:
            with socket.create_connection((host, port), timeout=1.0):
                return True
        except OSError:
            _time.sleep(0.1)
    return False
