"""Admission scheduling policy: tenant quotas, priority aging, shedding.

The tenant accounting made per-tenant load visible; this module makes
it actionable.  The policy runs entirely inside the admission plane —
workers never see it — and has three independent levers:

* **Tenant quota** (``max_pending_per_tenant``): a tenant may hold at
  most N *new* pending flights (dedup subscriptions are free — they add
  no work).  The N+1st submission is rejected with a one-line error the
  submitter sees immediately; nothing is queued.  This bounds how much
  of the admission queue one hot tenant can own, which is what keeps the
  interactive tier's queue-wait flat under a tenant flood.

* **Load shedding** (``shed_queue_depth``): when the pending queue is
  this deep, *batch-tier* submissions are refused outright (shed), while
  interactive submissions still queue — a saturated service degrades by
  dropping bulk work, not by stretching interactive p95s.  Shedding is
  visible: ``service.shed_total`` counts every refusal.

* **Priority aging** (``age_priority_s``): interactive flights jump the
  queue; a batch flight that has waited ``age_priority_s`` is promoted
  to the same priority class, so a continuous interactive stream ages
  batch work forward instead of starving it forever.  Within a class,
  FIFO by first submission.

``AdmissionRejected`` is a ``RuntimeError`` so every existing transport
path (server error event, client exception) reports it unchanged.

This module also owns the **coverage-target contract** validation
(:func:`validate_coverage_target`): ``--coverage-target PCT`` turns a
request's termination condition from "flat tx/time budget" into
"reachable coverage reached the bar, or all explored codes plateaued".
The adaptive controller renders the verdict mid-run; the daemon stamps
``coverage_target_met`` into the request's done meta and request-log
line.  Validation lives here — with the other admission-time request
checks — so a nonsense bar is refused at submit, not discovered after a
full exploration budget burned.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

__all__ = [
    "AdmissionRejected",
    "SchedulerPolicy",
    "validate_coverage_target",
]


def validate_coverage_target(pct) -> Optional[float]:
    """Normalize a ``--coverage-target`` value (percent in (0, 100]).

    None/empty passes through (no contract); anything unparseable or out
    of range raises :class:`AdmissionRejected` so the submitter sees a
    one-line refusal immediately."""
    if pct is None or pct == "":
        return None
    try:
        val = float(pct)
    except (TypeError, ValueError):
        raise AdmissionRejected(
            f"invalid coverage target {pct!r} (expected a percent)",
            kind="coverage_target",
        )
    if not 0.0 < val <= 100.0:
        raise AdmissionRejected(
            f"coverage target {val} out of range (0, 100]",
            kind="coverage_target",
        )
    return val


class AdmissionRejected(RuntimeError):
    """Submission refused by admission policy (quota or load shed)."""

    def __init__(self, reason: str, kind: str = "rejected"):
        super().__init__(reason)
        self.kind = kind  # "quota" | "shed"


@dataclass(frozen=True)
class SchedulerPolicy:
    #: max new pending flights one tenant may hold (0 = unlimited)
    max_pending_per_tenant: int = 0
    #: pending-queue depth at which batch-tier submissions are shed
    #: (0 = never shed)
    shed_queue_depth: int = 0
    #: batch flights waiting at least this long are promoted to
    #: interactive-class priority (<= 0 disables aging)
    age_priority_s: float = 30.0

    @property
    def active(self) -> bool:
        return bool(
            self.max_pending_per_tenant
            or self.shed_queue_depth
            or self.age_priority_s > 0
        )

    def priority_class(self, interactive: bool, created_at: float,
                       now: Optional[float] = None) -> int:
        """0 = dispatch-first class, 1 = normal batch backlog."""
        if interactive:
            return 0
        if self.age_priority_s > 0:
            now = time.time() if now is None else now
            if now - created_at >= self.age_priority_s:
                return 0
        return 1
