"""Request and result-stream primitives for the analysis service.

A submission produces a ``ResultStream``: a per-subscriber queue of
events the owner (the daemon worker, via the flight it rides) pushes as
the analysis progresses.  Duplicate submitters each get their OWN
stream; the flight replays already-emitted events into a late
subscriber's queue before attaching it live, so every subscriber
observes the same sequence — replay first, then live, issues strictly
before the terminal event.

Events are ``(kind, payload)`` with kind one of ``"issue"`` (one wire
dict, streamed the moment the finding confirms), ``"done"`` (payload:
summary dict with the authoritative ``issues`` list) or ``"error"``
(payload: one-line reason).  ``done``/``error`` are terminal and emitted
exactly once per stream.
"""

from __future__ import annotations

import queue
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple

from mythril_tpu_torch.observability.metrics import Histogram, get_registry

__all__ = [
    "AnalysisOptions",
    "AnalysisRequest",
    "ResultStream",
    "issue_to_wire",
]

TIER_BATCH = "batch"
TIER_INTERACTIVE = "interactive"

# Cached instrument: push() runs once per streamed event, and a registry
# lookup per observation is a dict probe + isinstance we don't need.
_H_TTFE: Optional[Histogram] = None


def _ttfe_histogram() -> Histogram:
    global _H_TTFE
    if _H_TTFE is None:
        _H_TTFE = get_registry().histogram("service.ttfe_s", persistent=True)
    return _H_TTFE


@dataclass(frozen=True)
class AnalysisOptions:
    """The per-request options that can change the issue set."""

    transaction_count: int = 2
    modules: Optional[Tuple[str, ...]] = None
    strategy: str = "bfs"
    execution_timeout: int = 60
    # explore-to-a-coverage-bar contract (--coverage-target): terminate
    # once reachable coverage reaches this percent or all explored codes
    # plateau.  Part of the dedup key: a target-bounded run may terminate
    # earlier than a budget-bounded one, so their results must not alias
    coverage_target: Optional[float] = None

    def key(self) -> Tuple:
        from mythril_tpu_torch.service.codehash import options_key

        return options_key(
            self.transaction_count,
            self.modules,
            self.strategy,
            self.execution_timeout,
            self.coverage_target,
        )

    def to_dict(self) -> Dict[str, Any]:
        """Picklable/JSON-safe form for the worker-pool job protocol."""
        return {
            "transaction_count": self.transaction_count,
            "modules": list(self.modules) if self.modules else None,
            "strategy": self.strategy,
            "execution_timeout": self.execution_timeout,
            "coverage_target": self.coverage_target,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "AnalysisOptions":
        target = d.get("coverage_target")
        return cls(
            transaction_count=int(d.get("transaction_count", 2)),
            modules=tuple(d["modules"]) if d.get("modules") else None,
            strategy=d.get("strategy", "bfs"),
            execution_timeout=int(d.get("execution_timeout", 60)),
            coverage_target=float(target) if target is not None else None,
        )


def issue_to_wire(issue) -> Dict[str, Any]:
    """JSON-safe wire form of one finding (digest-complete + context).

    Shared by the in-daemon worker thread and the pool worker processes:
    both sides of the worker protocol speak exactly this shape, so the
    digests a client computes are identical either way.
    """
    return {
        "contract": issue.contract,
        "function": issue.function,
        "address": issue.address,
        "swc_id": issue.swc_id,
        "title": issue.title,
        "severity": issue.severity,
        "description_head": issue.description_head,
        "bytecode_hash": issue.bytecode_hash,
        "discovery_time": round(issue.discovery_time, 3),
    }


@dataclass
class AnalysisRequest:
    request_id: str
    name: str
    code: bytes
    codehash: str
    options: AnalysisOptions
    tier: str = TIER_BATCH
    submitted_at: float = field(default_factory=time.time)
    # optional tenant label for per-tenant accounting (None -> "-")
    tenant: Optional[str] = None
    # telemetry phase stamps, all in the perf_counter domain: t_submit is
    # taken at construction; "admitted"/"execute0"/"execute1" are stamped
    # by the admission controller and the worker as the request moves.
    t_submit: float = field(default_factory=time.perf_counter)
    stamps: Dict[str, float] = field(default_factory=dict)

    @property
    def interactive(self) -> bool:
        return self.tier == TIER_INTERACTIVE


class ResultStream:
    """One subscriber's ordered view of a flight's events.

    Producer side (flight, under its lock): ``push``.  Consumer side
    (client handler thread): ``events()`` / ``issues()`` — both block
    until the terminal event.  The stream also owns the service-level
    TTFE sample: the clock starts at ``created_at`` — the admission
    paths pass the request's ``submitted_at`` so any stall *before*
    dispatch (admission queueing, fault-injected sleeps) counts against
    the budget the watchtower holds.  A dedup subscriber replayed a
    finished flight still legitimately records a near-zero TTFE — that
    IS the time-to-first-evidence the service delivered.
    """

    _DONE_KINDS = ("done", "error")

    def __init__(self, request_id: str, created_at: Optional[float] = None):
        self.request_id = request_id
        self.created_at = time.time() if created_at is None else created_at
        self.first_issue_at: Optional[float] = None
        self._q: "queue.Queue[Tuple[str, Any]]" = queue.Queue()
        self._closed = False  # producer-side; guarded by the flight lock

    # -- producer ------------------------------------------------------

    def push(self, kind: str, payload: Any) -> None:
        if self._closed:
            return
        if kind == "issue" and self.first_issue_at is None:
            self.first_issue_at = time.time()
            _ttfe_histogram().observe(self.first_issue_at - self.created_at)
        if kind in self._DONE_KINDS:
            self._closed = True
        self._q.put((kind, payload))

    @property
    def closed(self) -> bool:
        """True once the terminal event has been pushed.

        A dedup submission whose stream comes back already closed was a
        pure replay — the daemon finalizes its telemetry immediately
        instead of waiting on a batch that will never reference it.
        """
        return self._closed

    # -- consumer ------------------------------------------------------

    def events(self, timeout: Optional[float] = None) -> Iterator[Tuple[str, Any]]:
        """Yield events until (and including) the terminal one.

        ``timeout`` bounds the wait for EACH event; expiry raises
        ``queue.Empty`` (a stuck daemon must not hang clients forever).
        """
        while True:
            kind, payload = self._q.get(timeout=timeout)
            yield kind, payload
            if kind in self._DONE_KINDS:
                return

    def result(self, timeout: Optional[float] = None) -> Dict[str, Any]:
        """Drain the stream; return the ``done`` summary.

        Raises ``RuntimeError`` on an ``error`` event (per-tenant
        isolation surfaces here: only this request's submitter sees it).
        """
        streamed: List[Dict[str, Any]] = []
        for kind, payload in self.events(timeout=timeout):
            if kind == "issue":
                streamed.append(payload)
            elif kind == "error":
                raise RuntimeError(f"analysis failed: {payload}")
            else:
                summary = dict(payload)
                summary["streamed"] = streamed
                return summary
        raise RuntimeError("stream ended without terminal event")

    def issues(self, timeout: Optional[float] = None) -> List[Dict[str, Any]]:
        """Authoritative issue dicts from the ``done`` summary."""
        return self.result(timeout=timeout)["issues"]
