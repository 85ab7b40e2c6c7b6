"""Pure steering planner for coverage-guided adaptive exploration.

The planner is the deliberative half of the adaptive controller (the
reactive half — actuation at engine/pipeline sync points — lives in
:mod:`mythril_tpu_torch.adaptive.controller`).  It consumes the observability
stack's raw products:

* per-codehash coverage bitmaps + static reachability masks
  (:meth:`ExplorationLedger.bitmaps`),
* termination attribution (:data:`TERM_CLASSES` counts),
* solver-hotspot labels (``exploration.solver_hotspot_s``),
* the static pass's ranked ``interesting_points``,

and emits a :class:`SteeringPlan`:

* **weights** — per-codehash frontier slot-budget shares biased toward
  uncovered REACHABLE edges (saturated and plateaued codes decay to an
  epsilon floor, never to zero, so no code is starved outright),
* **requeue** — parked ``budget_exhausted`` path tokens worth
  resurrecting when arena slots free,
* **flip_targets** — uncovered JUMPI edges ranked by the static pass's
  ``interesting_points`` priorities, for targeted concolic flips,
* **plateaued** — per-codehash diminishing-returns verdicts (coverage
  delta below epsilon over a sliding window).

Everything here is pure numpy over plain inputs — no engine state, no
registry, no locks — mirroring ``pipeline.plan_rebalance`` /
``choose_free_slot``: the policy is unit-testable on its own and the
actuation sites stay mechanical.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "EPS_WEIGHT",
    "PLATEAU_EPSILON",
    "PLATEAU_WINDOW",
    "SteeringPlan",
    "uncovered_reachable",
    "steer_weights",
    "requeue_candidates",
    "rank_flip_targets",
    "plateau_verdict",
    "build_plan",
]

#: Weight floor per codehash: a saturated or plateaued code keeps at
#: least this share (pre-normalization) so it is deprioritized, never
#: starved — a late-widening contract can still earn slots back.
EPS_WEIGHT = 0.05

#: Coverage-percent delta (reachable denominator) below which a sliding
#: window counts as a plateau.
PLATEAU_EPSILON = 0.5

#: Sliding-window length (plan ticks) for the plateau verdict.
PLATEAU_WINDOW = 4

#: Damping strength for solver-hotspot wall: a code that ate ALL the
#: observed solver seconds has its weight divided by (1 + this).
_HOTSPOT_DAMP = 0.5


@dataclass(frozen=True)
class SteeringPlan:
    """One planner emission.  All maps are keyed by FULL codehash."""

    #: per-codehash slot-budget shares; values sum to 1.0 when non-empty
    weights: Dict[str, float] = field(default_factory=dict)
    #: parked-path tokens (opaque to the planner) to resurrect, in order
    requeue: Tuple[Any, ...] = ()
    #: per-codehash uncovered-JUMPI addrs, highest priority first
    flip_targets: Dict[str, Tuple[int, ...]] = field(default_factory=dict)
    #: per-codehash diminishing-returns verdict
    plateaued: Dict[str, bool] = field(default_factory=dict)
    #: per-codehash uncovered reachable-edge counts (the bias signal)
    uncovered_edges: Dict[str, int] = field(default_factory=dict)

    def weight(self, code_hash: str) -> float:
        """Share for one code; unknown codes get the mean share (new
        code is neither favored nor starved until it reports coverage)."""
        if code_hash in self.weights:
            return self.weights[code_hash]
        if not self.weights:
            return 1.0
        return 1.0 / len(self.weights)


def uncovered_reachable(bitmap: Mapping[str, Any]
                        ) -> Tuple[np.ndarray, np.ndarray, int]:
    """(uncovered_taken_idx, uncovered_fall_idx, uncovered_instr_count)
    for one :meth:`ExplorationLedger.bitmaps` entry.

    An edge is "uncovered reachable" when the static mask marks it live
    and the executed plane has not seen it.  With no registered masks
    every JUMPI site whose instruction WAS reached counts — the dynamic
    frontier itself proved the branch point reachable."""
    instr = np.asarray(bitmap["instr"], bool)
    taken = np.asarray(bitmap["edge_taken"], bool)
    fall = np.asarray(bitmap["edge_fall"], bool)
    reach_taken = bitmap.get("reach_taken")
    reach_fall = bitmap.get("reach_fall")
    reach_instr = bitmap.get("reach_instr")
    if reach_taken is None or reach_fall is None:
        # no oracle: branch sites we reached but whose edges we did not
        # exhaust (taken|fall seen marks a JUMPI site)
        sites = taken | fall
        un_taken = np.flatnonzero(sites & ~taken)
        un_fall = np.flatnonzero(sites & ~fall)
        n_un_instr = 0
    else:
        un_taken = np.flatnonzero(np.asarray(reach_taken, bool) & ~taken)
        un_fall = np.flatnonzero(np.asarray(reach_fall, bool) & ~fall)
        n_un_instr = (
            int((np.asarray(reach_instr, bool) & ~instr).sum())
            if reach_instr is not None else 0
        )
    return un_taken, un_fall, n_un_instr


def steer_weights(uncovered: Mapping[str, int],
                  plateaued: Optional[Mapping[str, bool]] = None,
                  hotspot_s: Optional[Mapping[str, float]] = None,
                  eps: float = EPS_WEIGHT) -> Dict[str, float]:
    """Per-codehash slot-budget shares.

    Raw mass is the uncovered reachable-edge count (+1 so brand-new codes
    with zero observed edges still attract compute), damped by the code's
    share of observed solver wall (a hotspot code pays for its queries),
    floored at ``eps`` and collapsed TO the floor for plateaued codes,
    then normalized to a valid distribution.  Deterministic: equal inputs
    give equal weights, and iteration order never matters."""
    keys = sorted(uncovered)
    if not keys:
        return {}
    plateaued = plateaued or {}
    hotspot_s = hotspot_s or {}
    total_hot = sum(max(float(v), 0.0) for v in hotspot_s.values())
    mass = np.empty(len(keys), np.float64)
    for i, k in enumerate(keys):
        m = float(max(int(uncovered[k]), 0) + 1)
        if total_hot > 0:
            share = max(float(hotspot_s.get(k, 0.0)), 0.0) / total_hot
            m /= 1.0 + _HOTSPOT_DAMP * share
        if plateaued.get(k) or uncovered[k] <= 0:
            m = 0.0
        mass[i] = m
    # epsilon floor relative to the mean mass keeps the floor meaningful
    # whatever the edge-count scale (10 edges or 10k)
    floor = eps * max(float(mass.mean()), 1.0)
    mass = np.maximum(mass, floor)
    mass /= mass.sum()
    return {k: float(mass[i]) for i, k in enumerate(keys)}


def requeue_candidates(parked: Sequence[Tuple[Any, str]],
                       live: Iterable[Any],
                       limit: int = 16) -> List[Any]:
    """Parked-path tokens to resurrect when arena slots free.

    ``parked`` is ``[(token, reason), ...]`` in park order; only
    ``budget_exhausted`` parks qualify (every other class is a verdict,
    not a resource accident), a token currently LIVE is never named
    (exactly-once: a resurrected path must not run twice), and FIFO
    order is preserved so resurrection replays the original exploration
    order.  Duplicate tokens are named once."""
    live_set = set(live)
    out: List[Any] = []
    seen = set()
    for token, reason in parked:
        if len(out) >= max(int(limit), 0):
            break
        if reason != "budget_exhausted":
            continue
        if token in live_set or token in seen:
            continue
        seen.add(token)
        out.append(token)
    return out


def rank_flip_targets(un_taken: np.ndarray, un_fall: np.ndarray,
                      interesting_points: Sequence[Mapping[str, Any]] = (),
                      limit: int = 32) -> Tuple[int, ...]:
    """Uncovered-JUMPI addrs ranked for concolic flipping.

    Each uncovered edge's JUMPI addr scores by the highest-priority
    static ``interesting_point`` at or after it (the point the untaken
    branch guards); addrs with no downstream point score 0.  Sort is
    score-descending, then addr-ascending — fully deterministic."""
    addrs = np.union1d(np.asarray(un_taken, np.int64),
                       np.asarray(un_fall, np.int64))
    if addrs.size == 0:
        return ()
    pts = sorted(
        (int(p.get("addr", -1)), float(p.get("score", 0)))
        for p in interesting_points
        if int(p.get("addr", -1)) >= 0
    )
    pt_addrs = np.asarray([a for a, _ in pts], np.int64)
    pt_scores = np.asarray([s for _, s in pts], np.float64)
    scores = np.zeros(addrs.size, np.float64)
    if pt_addrs.size:
        for i, a in enumerate(addrs):
            j = int(np.searchsorted(pt_addrs, a))
            if j < pt_addrs.shape[0]:
                scores[i] = float(pt_scores[j:].max())
    order = np.lexsort((addrs, -scores))
    return tuple(int(a) for a in addrs[order][:max(int(limit), 0)])


def plateau_verdict(history: Sequence[float],
                    epsilon: float = PLATEAU_EPSILON,
                    window: int = PLATEAU_WINDOW) -> bool:
    """True when coverage gained less than ``epsilon`` percentage points
    over the last ``window`` plan ticks.  Short histories are never a
    plateau (the code has not had its chance yet), and the verdict is
    monotone in growth: appending a sample that lifts the window's total
    gain to ``epsilon`` or more always clears it."""
    if window <= 0 or len(history) <= window:
        return False
    return (float(history[-1]) - float(history[-1 - window])) < epsilon


def build_plan(bitmaps: Mapping[str, Mapping[str, Any]],
               history: Optional[Mapping[str, Sequence[float]]] = None,
               parked: Sequence[Tuple[Any, str]] = (),
               live: Iterable[Any] = (),
               points: Optional[Mapping[str, Sequence[Mapping[str, Any]]]]
               = None,
               hotspot_s: Optional[Mapping[str, float]] = None,
               epsilon: float = PLATEAU_EPSILON,
               window: int = PLATEAU_WINDOW,
               requeue_limit: int = 16,
               flip_limit: int = 32) -> SteeringPlan:
    """Compose one :class:`SteeringPlan` from ledger-shaped inputs.

    ``bitmaps`` is :meth:`ExplorationLedger.bitmaps` output; ``history``
    maps codehash → recent reachable-coverage percentages (controller-
    maintained); ``parked`` / ``live`` feed :func:`requeue_candidates`;
    ``points`` maps codehash → static ``interesting_points``; and
    ``hotspot_s`` maps codehash → attributed solver seconds."""
    history = history or {}
    points = points or {}
    uncovered: Dict[str, int] = {}
    plateaued: Dict[str, bool] = {}
    flips: Dict[str, Tuple[int, ...]] = {}
    for h, bm in bitmaps.items():
        un_taken, un_fall, n_un_instr = uncovered_reachable(bm)
        uncovered[h] = int(un_taken.size + un_fall.size) + (
            # edge-less codes (no JUMPI) steer on uncovered instructions
            n_un_instr if not bm.get("jumpis") else 0
        )
        plateaued[h] = plateau_verdict(history.get(h, ()), epsilon, window)
        targets = rank_flip_targets(
            un_taken, un_fall, points.get(h, ()), flip_limit
        )
        if targets:
            flips[h] = targets
    return SteeringPlan(
        weights=steer_weights(uncovered, plateaued, hotspot_s),
        requeue=tuple(requeue_candidates(parked, live, requeue_limit)),
        flip_targets=flips,
        plateaued=plateaued,
        uncovered_edges=uncovered,
    )
