"""Admission policy: which program points get the device tier.

The port's counterpart of ``mythril_tpu/devsolver/admission.py``, edited
down to the per-point give-up rule.  The JAX module also always admits the
top points of the solver-hotspot ledger (``observability/exploration``);
the port has no such ledger yet (ROADMAP Queue A item 5), so that rule is
left out.  ``point_context``'s caller is the pipelined frontier's
feasibility pool (``frontier/pipeline.py`` ``FeasibilityPool._work``): its
queries carry their JUMPI's point; every other query carries the empty
point and is admitted.

Structural admission (does the query blast to <= budget free bits?) is
decided inside ``devsolver.blaster``; this module decides whether a query
is worth *attempting* at all: a point that keeps falling through
(``GIVE_UP_AFTER`` attempts with zero decided) stops being tried, so the
blaster's rejection cost is paid O(1) times per cold point rather than per
query.  Queries with no point attribution (empty label) are always tried.

The program point travels on a context variable (``point_context``) rather
than through solver signatures; ``smt/solver.py``'s callers set it and
``devsolver.decide_batch`` reads it back here.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from contextvars import ContextVar
from typing import Dict

__all__ = ["point_context", "current_point", "AdmissionPolicy", "policy",
           "reset_state"]

GIVE_UP_AFTER = 12     # fallthroughs with zero decided before a point is cold

_point: ContextVar[str] = ContextVar("devsolver_point", default="")


@contextmanager
def point_context(point: str):
    """Attribute devsolver admission decisions to a program point."""
    tok = _point.set(point or "")
    try:
        yield
    finally:
        _point.reset(tok)


def current_point() -> str:
    return _point.get()


class AdmissionPolicy:
    """Per-point hit/fallthrough accounting."""

    def __init__(self):
        self._lock = threading.Lock()
        # point -> [attempted, decided, fallthrough]
        self._stats: Dict[str, list] = {}

    def admit(self, point: str) -> bool:
        """Should this query attempt the device tier?"""
        if not point:
            return True
        with self._lock:
            st = self._stats.get(point)
            return st is None or st[1] > 0 or st[2] < GIVE_UP_AFTER

    def note(self, point: str, decided: bool) -> None:
        """Record one attempt's outcome for a point."""
        with self._lock:
            st = self._stats.setdefault(point or "", [0, 0, 0])
            st[0] += 1
            st[1 if decided else 2] += 1


policy = AdmissionPolicy()


def reset_state() -> None:
    """Drop accumulated per-point accounting."""
    global policy
    policy = AdmissionPolicy()
