"""Thin client for the analysis service (``myth submit``).

One TCP connection per submission: write the request line, then iterate
the event lines the daemon streams back.  ``submit_stream`` yields each
event dict as it arrives (issues the moment they confirm); ``submit``
collects and returns the terminal summary.

``submit_detached`` + ``poll``/``wait`` use the long-poll path instead:
the submit connection returns after ``accepted`` and each poll is its
own short connection, so a client watching a slow analysis holds no
server thread between events.
"""

from __future__ import annotations

import json
import socket
from typing import Any, Dict, Iterator, List, Optional, Sequence

__all__ = ["ServiceClient"]


class ServiceClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 7344,
                 timeout: Optional[float] = 300.0):
        self.host = host
        self.port = port
        self.timeout = timeout

    # -- plumbing ------------------------------------------------------

    def _roundtrip(self, msg: Dict[str, Any]) -> Iterator[Dict[str, Any]]:
        with socket.create_connection(
            (self.host, self.port), timeout=self.timeout
        ) as sock:
            sock.sendall((json.dumps(msg) + "\n").encode())
            with sock.makefile("r", encoding="utf-8") as rf:
                for line in rf:
                    line = line.strip()
                    if line:
                        yield json.loads(line)

    # -- API -----------------------------------------------------------

    def ping(self) -> bool:
        for event in self._roundtrip({"op": "ping"}):
            return event.get("event") == "pong"
        return False

    def stats(self) -> Dict[str, Any]:
        for event in self._roundtrip({"op": "stats"}):
            return event
        return {}

    def health(self) -> Dict[str, Any]:
        """Watchtower SLO state: ``ok``, ``breaching``, per-objective
        evaluations (``{"enabled": False}`` when the daemon runs without
        the watchtower)."""
        for event in self._roundtrip({"op": "health"}):
            return event
        return {"enabled": False, "ok": None, "objectives": []}

    def metrics(self) -> str:
        """The daemon's registry in Prometheus text exposition format.

        When a worker pool is running, the text also carries the fleet's
        worker-labeled ``fleet_*{worker="N"}`` series and their rollups.
        """
        for event in self._roundtrip({"op": "metrics"}):
            return event.get("text", "")
        return ""

    def profile(self, worker: int = 0,
                duration_s: float = 1.0) -> Dict[str, Any]:
        """Open a windowed ``torch.profiler`` capture in one worker.

        Blocks for the window plus transport slack; returns a dict with
        ``ok``, ``dir`` (the capture directory under the daemon's cache
        root) and ``worker``.
        """
        for event in self._roundtrip({
            "op": "profile", "worker": worker, "duration_s": duration_s,
        }):
            return event
        return {"ok": False, "error": "server closed during profile"}

    def submit_stream(
        self,
        code: str,
        name: Optional[str] = None,
        tier: str = "batch",
        transaction_count: Optional[int] = None,
        modules: Optional[Sequence[str]] = None,
        strategy: Optional[str] = None,
        execution_timeout: Optional[int] = None,
        tenant: Optional[str] = None,
        coverage_target: Optional[float] = None,
    ) -> Iterator[Dict[str, Any]]:
        """Yield event dicts: ``accepted``, ``issue``*, ``done``/``error``."""
        msg: Dict[str, Any] = {"op": "submit", "code": code, "tier": tier}
        if name:
            msg["name"] = name
        if tenant:
            msg["tenant"] = tenant
        if transaction_count is not None:
            msg["transaction_count"] = transaction_count
        if modules:
            msg["modules"] = list(modules)
        if strategy:
            msg["strategy"] = strategy
        if execution_timeout is not None:
            msg["execution_timeout"] = execution_timeout
        if coverage_target is not None:
            msg["coverage_target"] = coverage_target
        terminal = False
        for event in self._roundtrip(msg):
            yield event
            if event.get("event") in ("done", "error"):
                terminal = True
                break
        if not terminal:
            raise ConnectionError(
                "server closed the stream before a terminal event"
            )

    def submit_detached(
        self,
        code: str,
        name: Optional[str] = None,
        tier: str = "batch",
        tenant: Optional[str] = None,
        **options: Any,
    ) -> Dict[str, Any]:
        """Fire-and-poll submit: returns the ``accepted`` event dict
        (``request_id``, ``codehash``, ``deduped``) without waiting for
        the analysis.  Follow up with ``poll``/``wait``.  Raises
        ``RuntimeError`` on rejection (the message names quota/shed)."""
        msg: Dict[str, Any] = {
            "op": "submit", "code": code, "tier": tier, "detach": True,
        }
        if name:
            msg["name"] = name
        if tenant:
            msg["tenant"] = tenant
        for key in ("transaction_count", "modules", "strategy",
                    "execution_timeout", "coverage_target"):
            if options.get(key) is not None:
                msg[key] = options[key]
        for event in self._roundtrip(msg):
            if event.get("event") == "error":
                raise RuntimeError(f"submit rejected: {event.get('error')}")
            return event
        raise ConnectionError("server closed before accepting")

    def poll(self, request_id: str, cursor: int = 0,
             wait_s: float = 0.0) -> Dict[str, Any]:
        """One long-poll round: events past ``cursor`` (blocking up to
        ``wait_s`` server-side), the advanced cursor, and ``closed``."""
        for event in self._roundtrip({
            "op": "poll", "request_id": request_id,
            "cursor": cursor, "wait_s": wait_s,
        }):
            if event.get("event") == "error":
                raise RuntimeError(f"poll failed: {event.get('error')}")
            return event
        raise ConnectionError("server closed during poll")

    def wait(self, request_id: str, timeout: float = 300.0,
             poll_wait_s: float = 10.0) -> Dict[str, Any]:
        """Long-poll until the terminal event; returns the ``done``
        summary (with ``streamed``/``request_id`` like ``submit``).
        Raises ``RuntimeError`` on an ``error`` terminal."""
        import time as _time

        deadline = _time.time() + timeout
        cursor = 0
        streamed: List[Dict[str, Any]] = []
        while True:
            remaining = deadline - _time.time()
            if remaining <= 0:
                raise TimeoutError(
                    f"request {request_id} not terminal after {timeout}s"
                )
            out = self.poll(
                request_id, cursor=cursor,
                wait_s=min(poll_wait_s, max(remaining, 0.0)),
            )
            cursor = out.get("cursor", cursor)
            for entry in out.get("events", []):
                kind, payload = entry.get("kind"), entry.get("payload")
                if kind == "issue":
                    streamed.append(payload)
                elif kind == "error":
                    raise RuntimeError(f"analysis failed: {payload}")
                elif kind == "done":
                    summary = dict(payload)
                    summary["streamed"] = streamed
                    summary["request_id"] = request_id
                    return summary
            if out.get("closed"):
                raise ConnectionError(
                    f"request {request_id} closed without a done event"
                )

    def submit(self, code: str, **kwargs) -> Dict[str, Any]:
        """Blocking submit; returns the ``done`` summary.

        The summary's ``issues`` list is authoritative; ``streamed``
        carries the incrementally received issue events (a superset
        check for the determinism tests).  Raises ``RuntimeError`` on a
        per-request analysis failure.
        """
        streamed: List[Dict[str, Any]] = []
        accepted: Dict[str, Any] = {}
        for event in self.submit_stream(code, **kwargs):
            kind = event.get("event")
            if kind == "accepted":
                accepted = event
            elif kind == "issue":
                streamed.append(event)
            elif kind == "error":
                raise RuntimeError(f"analysis failed: {event.get('error')}")
            elif kind == "done":
                out = dict(event)
                out["streamed"] = streamed
                out["request_id"] = accepted.get("request_id")
                out["deduped"] = accepted.get("deduped", False)
                return out
        raise ConnectionError("stream ended without terminal event")
