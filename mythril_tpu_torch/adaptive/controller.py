"""Adaptive controller: actuation-facing state for coverage steering.

The planner (:mod:`mythril_tpu_torch.adaptive.plan`) is pure; this module owns
the process-wide mutable half the actuation sites need:

* a throttled **plan cache** rebuilt from live
  :meth:`ExplorationLedger.bitmaps` snapshots (plus per-codehash coverage
  history for the plateau verdict),
* the static pass's **interesting points** per codehash, registered at
  engine table-packing time,
* a deterministic **deficit scheduler** (``pick_seed``) that grants
  dispatch slots per the plan's weights — the actual re-steering,
* the **coverage-target** verdict (``--coverage-target``): stop on bar
  reached or on an all-codes plateau,
* the ``adaptive.*`` counters, named into the metrics registry so the
  fleet fabric exports worker-labeled ``fleet_adaptive_*`` series with no
  extra wiring.

Everything degrades to a no-op when ``--no-adaptive`` is set: callers
gate on :attr:`AdaptiveController.enabled`, and the scheduler's FIFO
fallback is exactly the pre-adaptive injection order (the on/off parity
contract the bench ``--adaptive-compare`` mode asserts).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from mythril_tpu_torch.adaptive.plan import (
    PLATEAU_WINDOW,
    SteeringPlan,
    build_plan,
    requeue_candidates,
)
from mythril_tpu_torch.support.support_args import args

log = logging.getLogger(__name__)

__all__ = ["AdaptiveController", "get_adaptive_controller"]

# plan rebuild throttle: sync points arrive per segment (ms apart); the
# bitmaps snapshot + planning is O(code size) and the signal only moves
# at harvest granularity, so a short wall floor loses nothing
_PLAN_MIN_INTERVAL_S = 0.1

# bounded registries (a long-lived worker process must not grow them)
_MAX_POINT_CODES = 512
_MAX_HISTORY = PLATEAU_WINDOW + 8


class AdaptiveController:
    """Process-wide adaptive-steering state (one per worker process)."""

    def __init__(self, registry=None):
        self._lock = threading.RLock()
        self._registry = registry
        self._points: Dict[str, Tuple[dict, ...]] = {}
        self._history: Dict[str, List[float]] = {}
        self._granted: Dict[str, int] = {}
        self._plan: Optional[SteeringPlan] = None
        self._plan_at = 0.0
        self._stop: Optional[Dict[str, Any]] = None

    # -- wiring ---------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return bool(getattr(args, "adaptive", True))

    def _reg(self):
        if self._registry is not None:
            return self._registry
        from mythril_tpu_torch.observability.metrics import get_registry

        return get_registry()

    def _c(self, name: str):
        return self._reg().counter("adaptive." + name)

    def _ledger(self):
        from mythril_tpu_torch.observability.exploration import (
            get_exploration_ledger,
        )

        return get_exploration_ledger()

    # -- inputs ---------------------------------------------------------

    def register_points(self, code_hash: str,
                        points: Sequence[dict]) -> None:
        """Static ``interesting_points`` for one code (engine table
        packing calls this next to ``publish_reachability``)."""
        if not code_hash or not points:
            return
        with self._lock:
            if (code_hash not in self._points
                    and len(self._points) >= _MAX_POINT_CODES):
                self._points.clear()
            self._points[code_hash] = tuple(points)

    # -- planning -------------------------------------------------------

    def plan(self, parked: Sequence[Tuple[Any, str]] = (),
             live: Sequence[Any] = (),
             force: bool = False) -> SteeringPlan:
        """The current steering plan, rebuilt from a fresh ledger snapshot
        at most every ``_PLAN_MIN_INTERVAL_S`` (``force`` skips the
        throttle; requeue inputs always re-evaluate on the cached
        weights' plan when throttled)."""
        now = time.monotonic()
        with self._lock:
            if (self._plan is not None and not force
                    and now - self._plan_at < _PLAN_MIN_INTERVAL_S):
                if parked:
                    return SteeringPlan(
                        weights=self._plan.weights,
                        requeue=tuple(requeue_candidates(parked, live)),
                        flip_targets=self._plan.flip_targets,
                        plateaued=self._plan.plateaued,
                        uncovered_edges=self._plan.uncovered_edges,
                    )
                return self._plan
            led = self._ledger()
            bitmaps = led.bitmaps()
            # coverage history tick (reachable denominator — the same
            # number the plateau contract is quoted in)
            for h in bitmaps:
                pct = led.coverage_pct_reachable(h)
                if pct is None:
                    continue
                hist = self._history.setdefault(h, [])
                hist.append(float(pct))
                del hist[:-_MAX_HISTORY]
            # solver hotspots: labels are "hash10:0xPC"; fold seconds onto
            # the full codehash by prefix
            hot: Dict[str, float] = {}
            for spot in led.solver_hotspots(top=64):
                tag = str(spot.get("point", "")).split(":", 1)[0]
                for h in bitmaps:
                    if h.startswith(tag) and tag not in ("", "?", "other"):
                        hot[h] = hot.get(h, 0.0) + float(
                            spot.get("solver_s", 0.0)
                        )
                        break
            self._plan = build_plan(
                bitmaps,
                history=self._history,
                parked=parked,
                live=live,
                points=self._points,
                hotspot_s=hot,
            )
            self._plan_at = now
            self._c("plans").inc()
            return self._plan

    def current_plan(self) -> Optional[SteeringPlan]:
        with self._lock:
            return self._plan

    # -- actuation: dispatch-slot steering ------------------------------

    def pick_seed(self, hashes: Sequence[str]) -> int:
        """Queue position of the next seed to inject.

        ``hashes[i]`` is the codehash of the i-th queued seed.  FIFO (0)
        whenever steering cannot help: controller disabled, a single code
        queued, or no plan yet.  Otherwise a deterministic deficit
        scheduler: grant the queued code with the highest
        ``weight / (grants + 1)`` ratio (ties break FIFO), so realized
        slot shares converge on the plan's weights without randomness.
        Counts ``adaptive.resteered_slots`` when the pick differs from
        FIFO order."""
        if not self.enabled or len(set(hashes)) <= 1:
            return 0
        with self._lock:
            plan = self._plan
            if plan is None or not plan.weights:
                return 0
            best_pos, best_ratio = 0, -1.0
            seen = set()
            for pos, h in enumerate(hashes):
                if h in seen:
                    continue
                seen.add(h)
                ratio = plan.weight(h) / (self._granted.get(h, 0) + 1)
                if ratio > best_ratio + 1e-12:
                    best_ratio = ratio
                    best_pos = pos
            h = hashes[best_pos]
            self._granted[h] = self._granted.get(h, 0) + 1
            if best_pos != 0:
                self._c("resteered_slots").inc()
            return best_pos

    # -- actuation: park/requeue ----------------------------------------

    def select_requeue(self, parked: Sequence[Tuple[Any, str]],
                       live: Sequence[Any] = (),
                       limit: int = 16) -> List[Any]:
        """Parked-path tokens to resurrect now (free slots exist).  The
        caller owns the carriers; this only applies plan policy and
        counts ``adaptive.requeued_paths``."""
        if not self.enabled or not parked:
            return []
        picked = list(self.plan(parked=parked, live=live).requeue[:limit])
        if picked:
            self._c("requeued_paths").inc(len(picked))
        return picked

    # -- actuation: concolic flips --------------------------------------

    def flip_targets_for(self, code_hash: str) -> Tuple[int, ...]:
        """Planned flip addrs for one code (empty when disabled/unknown)."""
        if not self.enabled or not code_hash:
            return ()
        with self._lock:
            plan = self._plan
        if plan is None:
            plan = self.plan()
        for h, targets in plan.flip_targets.items():
            if h == code_hash or h.startswith(code_hash):
                return targets
        return ()

    def count_flips(self, planned: int = 0, hit: int = 0) -> None:
        if planned:
            self._c("flips_planned").inc(planned)
        if hit:
            self._c("flips_hit").inc(hit)

    # -- coverage-target contract ---------------------------------------

    def coverage_stop(self,
                      target: Optional[float] = None) -> Optional[str]:
        """``"target"`` when reachable coverage reached the bar,
        ``"plateau"`` when every explored code flat-lined below it
        (diminishing returns), None to keep exploring.  The first stop
        verdict is latched for the service to stamp into request meta."""
        if target is None:
            target = getattr(args, "coverage_target", None)
        if not self.enabled or not target:
            return None
        led = self._ledger()
        pct = led.coverage_pct_reachable()
        reason = None
        if pct is not None and pct >= float(target):
            reason = "target"
        else:
            plan = self.plan()
            with self._lock:
                codes = [h for h in plan.plateaued
                         if len(self._history.get(h, ())) > PLATEAU_WINDOW]
            if codes and len(codes) == len(plan.plateaued) \
                    and all(plan.plateaued.values()):
                reason = "plateau"
        if reason is None:
            return None
        with self._lock:
            if self._stop is None:
                self._stop = {
                    "reason": reason,
                    "coverage_target": float(target),
                    "coverage_pct_reachable": pct,
                    "coverage_target_met": True,
                }
                if reason == "plateau":
                    self._c("plateau_stops").inc()
                self._c("coverage_stops").inc()
        return reason

    def stop_state(self) -> Optional[Dict[str, Any]]:
        """The latched coverage-stop verdict (None while exploring)."""
        with self._lock:
            return dict(self._stop) if self._stop else None

    # -- lifecycle ------------------------------------------------------

    def reset_scope(self) -> None:
        """Per-analysis sweep, alongside ``ledger.reset_scope``."""
        with self._lock:
            self._history.clear()
            self._granted.clear()
            self._plan = None
            self._plan_at = 0.0
            self._stop = None

    def meta(self) -> Dict[str, Any]:
        """The ``meta.adaptive`` block for jsonv2 reports and bench."""
        out = {
            "enabled": self.enabled,
            "plans": int(self._c("plans").value),
            "resteered_slots": int(self._c("resteered_slots").value),
            "requeued_paths": int(self._c("requeued_paths").value),
            "flips_planned": int(self._c("flips_planned").value),
            "flips_hit": int(self._c("flips_hit").value),
            "plateau_stops": int(self._c("plateau_stops").value),
        }
        stop = self.stop_state()
        if stop:
            out["coverage_stop"] = stop
        return out


_controller: Optional[AdaptiveController] = None
_controller_lock = threading.Lock()


def get_adaptive_controller() -> AdaptiveController:
    global _controller
    if _controller is None:
        with _controller_lock:
            if _controller is None:
                _controller = AdaptiveController()
    return _controller
