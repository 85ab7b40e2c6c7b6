"""Admission policy: which program points get the device tier.

A copy of ``mythril_tpu/devsolver/admission.py`` (the package renamed; this
docstring names the ledger by its module).  The hotspot rule reads the
port's exploration ledger (``observability/exploration.py``), fed by the
frontier's prune and its feasibility pool.  As in the JAX package, only the
pipelined frontier's feasibility pool (``frontier/pipeline.py``
``FeasibilityPool._work``) enters ``point_context``; the synchronous prune
(``frontier/engine.py`` ``_prune_running``) records its solver wall in the
ledger but queries with no point, so with ``--no-pipeline`` every query is
tried and the hotspot rule acts on pipelined runs alone.

Structural admission (does the query blast to <= budget free bits?) is
decided inside ``devsolver.blaster``; this module decides whether a
query is worth *attempting* at all, using the exploration ledger's
solver-hotspot accounting:

* program points with the highest attributed Z3 wall are always tried —
  they are exactly where the device tier pays for itself;
* a point that keeps falling through (``GIVE_UP_AFTER`` attempts with
  zero decided) stops being tried unless it is a current hotspot, so the
  blaster's rejection cost is paid O(1) times per cold point rather than
  per query;
* queries with no point attribution (empty label) are always tried.

The program point travels on a context variable (``point_context``)
rather than through solver signatures: the feasibility pool already
knows the point label it attributes solver wall to, and
``smt/solver.py`` reads it back here —
zero churn on the long-stable ``check_satisfiable_batch`` contract.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from contextvars import ContextVar
from typing import Dict

__all__ = ["point_context", "current_point", "AdmissionPolicy", "policy",
           "reset_state"]

GIVE_UP_AFTER = 12     # fallthroughs with zero decided before a point is cold
HOTSPOT_TOP = 8        # ledger ranks always admitted
_HOTSPOT_REFRESH = 64  # admit() calls between hotspot re-ranks

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
    """Per-point hit/fallthrough accounting over the hotspot ledger."""

    def __init__(self):
        self._lock = threading.Lock()
        # point -> [attempted, decided, fallthrough]
        self._stats: Dict[str, list] = {}
        self._hot: set = set()
        self._calls = 0

    def _refresh_hot_locked(self) -> None:
        try:
            from mythril_tpu_torch.observability.exploration import (
                get_exploration_ledger,
            )

            ranked = get_exploration_ledger().solver_hotspots(top=HOTSPOT_TOP)
            self._hot = {h["point"] for h in ranked}
        except Exception:
            self._hot = set()

    def admit(self, point: str = None) -> bool:
        """Should this query attempt the device tier?"""
        if point is None:
            point = current_point()
        with self._lock:
            self._calls += 1
            if self._calls % _HOTSPOT_REFRESH == 1:
                self._refresh_hot_locked()
            if not point or point in self._hot:
                return True
            st = self._stats.get(point)
            if st is None:
                return True
            attempted, decided, fallthrough = st
            return decided > 0 or fallthrough < GIVE_UP_AFTER

    def note(self, point: str, decided: bool) -> None:
        """Record one attempt's outcome for a point."""
        with self._lock:
            st = self._stats.setdefault(point or "", [0, 0, 0])
            st[0] += 1
            if decided:
                st[1] += 1
            else:
                st[2] += 1

    def snapshot(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {
                p: {"attempted": s[0], "decided": s[1], "fallthrough": s[2]}
                for p, s in self._stats.items()
            }


policy = AdmissionPolicy()


def reset_state() -> None:
    """Test hook: drop accumulated per-point accounting."""
    global policy
    policy = AdmissionPolicy()
