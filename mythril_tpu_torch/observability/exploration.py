"""Exploration ledger: analysis-quality observability for the frontier.

The operational plane (request telemetry, fleet fabric) says how fast the
service runs; this module says how *well* it explored.  Three channels,
one process-wide ledger:

* **Coverage** — per-contract instruction and JUMPI branch-edge bitmaps.
  The device frontier marks a three-plane ``[3, C, I]`` bool array per
  step (plane 0 = instruction executed, plane 1 = taken edge, plane 2 =
  fall-through edge); ``engine._merge_coverage`` folds the host readback
  into this ledger, and the host-side :class:`InstructionCoverage` plugin
  contributes the pcs the walker/host engine executed.  Edge coverage is
  quoted against ``2 * |JUMPI|`` resolvable edges per contract.

* **Termination attribution** — every path that stops exploring is
  stamped with exactly ONE of :data:`TERM_CLASSES`.  ``stamp`` increments
  the per-class labeled counter and the total counter together, so the
  partition invariant (sum over classes == total terminated) holds by
  construction and is asserted in tests, bench rows, and the CI smoke.

* **Solver hotspots** — feasibility-solve wall time attributed to the
  program point (codehash-tagged pc) whose query burned the budget, as a
  pair of labeled series (``solver_hotspot_s`` / ``solver_hotspot_n``)
  that render as a labeled histogram in Prometheus exposition.

Everything lands in the metrics registry under ``exploration.*`` so the
fleet publisher exports worker-labeled ``fleet_exploration_*`` series with
no extra wiring; bitmaps (not registry-shaped) live on the ledger itself
and reset with the analysis scope.

A copy of ``mythril_tpu/observability/exploration.py`` (the package
renamed; this docstring names no history).  The port has no fleet
publisher or Prometheus exposition yet (ROADMAP Queue A item 13): its
readers are the report's ``meta.exploration``, ``--coverage-out``, the
adaptive controller and the devsolver's admission.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Iterable, List, Optional

import numpy as np

__all__ = [
    "TERM_CLASSES",
    "VERDICT_CLASS",
    "ExplorationLedger",
    "exploration_meta",
    "get_exploration_ledger",
]

#: The termination taxonomy.  Exactly one class per terminated path:
#:   completed      — ran to a terminal halt (STOP/RETURN/REVERT/
#:                    SELFDESTRUCT/INVALID) or the host replay ended it
#:   prefilter_killed — the abstract interval/known-bits pass proved the
#:                    path condition UNSAT before any exact solve
#:   solver_unsat   — an exact solver verdict killed the path
#:   solver_timeout_unknown — the solver answered UNKNOWN at budget and
#:                    the engine's unknown-as-unsat policy pruned it
#:   staticpass_pruned — a plugin/static gate (PluginSkipState) dropped
#:                    the path pre-execution, subtree included
#:   loop_bound     — the device loop detector hit --loop-bound
#:   budget_exhausted — max-depth halt or the execution timeout parked
#:                    the path with no host budget left to resume it
#:   shed           — the service admission plane refused the request
TERM_CLASSES = (
    "completed",
    "prefilter_killed",
    "solver_unsat",
    "solver_timeout_unknown",
    "staticpass_pruned",
    "loop_bound",
    "budget_exhausted",
    "shed",
)

#: Solver batch statuses (check_satisfiable_batch ``statuses_out``) to
#: termination classes, for kill attribution at the prune/verdict points.
#: Every status a tier can emit MUST be mapped here explicitly — the
#: lookup sites default to "solver_unsat", so a missing entry silently
#: misattributes terminations (tests/devsolver/test_integration.py keeps
#: this table in sync with the statuses solver.py can emit).
VERDICT_CLASS = {
    "unsat": "solver_unsat",
    "unknown": "solver_timeout_unknown",
    "prefilter": "prefilter_killed",
    # the device SAT tier's UNSAT is an exact solver verdict — it differs
    # from "prefilter" (abstraction) in mechanism, not in exactness
    "devsolver": "solver_unsat",
}

# visited-array plane indices (frontier/step.py writes these on device)
PLANE_INSTR = 0
PLANE_EDGE_TAKEN = 1
PLANE_EDGE_FALL = 2
N_PLANES = 3

# labeled-series cardinality guard: distinct program-point labels beyond
# this fold into "other" so a pathological contract cannot balloon the
# registry (or the fleet wire format)
_MAX_HOTSPOT_LABELS = 256


class _CodeCoverage:
    __slots__ = ("total", "jumpis", "instr", "edge_taken", "edge_fall",
                 "reach_instr", "reach_taken", "reach_fall")

    def __init__(self, total: int, jumpis: int):
        self.total = max(int(total), 0)
        self.jumpis = max(int(jumpis), 0)
        n = max(self.total, 1)
        self.instr = np.zeros(n, bool)
        self.edge_taken = np.zeros(n, bool)
        self.edge_fall = np.zeros(n, bool)
        # static reachability masks (the staticpass reachable-edge
        # oracle); None until a summary is registered — then the
        # *_reachable variants fall back to the raw denominators
        self.reach_instr: Optional[np.ndarray] = None
        self.reach_taken: Optional[np.ndarray] = None
        self.reach_fall: Optional[np.ndarray] = None

    def set_static(self, instr_mask, taken_mask, fall_mask) -> None:
        """Install the static reachability masks, aligned to this
        entry's instruction space (truncate/pad as needed)."""
        def fit(mask):
            m = np.zeros(self.instr.shape[0], bool)
            src = np.asarray(mask, bool)
            n = min(m.shape[0], src.shape[0])
            m[:n] = src[:n]
            return m

        self.reach_instr = fit(instr_mask)
        self.reach_taken = fit(taken_mask)
        self.reach_fall = fit(fall_mask)

    def _reach_counts(self):
        """(reachable_instructions, reachable_edges) with the executed
        bits unioned in, so executed ⊆ reachable holds by construction
        and the reachable percentages can never dip below the raw ones
        even if a registered mask is misaligned."""
        if self.reach_instr is None:
            return None, None
        r_instr = int((self.reach_instr | self.instr).sum()) \
            if self.total else 0
        r_edges = int((self.reach_taken | self.edge_taken).sum()) \
            + int((self.reach_fall | self.edge_fall).sum())
        return min(r_instr, self.total), min(r_edges, 2 * self.jumpis)

    def as_dict(self) -> Dict[str, Any]:
        seen = int(self.instr.sum())
        taken = int(self.edge_taken.sum())
        fall = int(self.edge_fall.sum())
        edges_total = 2 * self.jumpis
        instr_pct = round(100.0 * seen / self.total, 2) if self.total else 0.0
        edge_pct = round(100.0 * (taken + fall) / edges_total, 2) \
            if edges_total else None
        r_instr, r_edges = self._reach_counts()
        instr_pct_reach = (
            round(100.0 * seen / r_instr, 2)
            if r_instr else instr_pct
        )
        edge_pct_reach = (
            round(100.0 * (taken + fall) / r_edges, 2)
            if r_edges else edge_pct
        )
        return {
            "instructions_total": self.total,
            "instructions_seen": seen,
            "instructions_reachable": r_instr,
            "instruction_pct": instr_pct,
            "instruction_pct_raw": instr_pct,
            "instruction_pct_reachable": instr_pct_reach,
            "jumpis": self.jumpis,
            "edges_total": edges_total,
            "edges_seen": taken + fall,
            "edges_reachable": r_edges,
            "edge_taken_seen": taken,
            "edge_fall_seen": fall,
            "edge_pct": edge_pct,
            "edge_pct_raw": edge_pct,
            "edge_pct_reachable": edge_pct_reach,
        }


class ExplorationLedger:
    """Process-wide exploration accounting (one per worker process).

    Counter-shaped channels live in the metrics registry (named under
    ``exploration.*`` — scoped like the ``prefilter.*`` counters, swept by
    ``reset_analysis_metrics``); the coverage bitmaps live here and are
    swept by the same scope reset through :func:`reset_scope`.
    """

    def __init__(self, registry=None):
        self._lock = threading.Lock()
        self._codes: Dict[str, _CodeCoverage] = {}
        self._registry = registry

    # -- registry handles ----------------------------------------------

    def _reg(self):
        if self._registry is not None:
            return self._registry
        from mythril_tpu_torch.observability.metrics import get_registry

        return get_registry()

    def _terminated_counter(self):
        return self._reg().labeled_counter(
            "exploration.terminated", label_name="class"
        )

    # -- coverage -------------------------------------------------------

    def _entry(self, code_hash: str, total: int, jumpis: int = -1
               ) -> _CodeCoverage:
        entry = self._codes.get(code_hash)
        if entry is None:
            entry = _CodeCoverage(total, max(jumpis, 0))
            self._codes[code_hash] = entry
        elif jumpis >= 0 and entry.jumpis == 0:
            entry.jumpis = int(jumpis)
        return entry

    def record_device_planes(self, code_hash: str, total: int, jumpis: int,
                             planes: np.ndarray) -> None:
        """Fold a device-harvested ``[3, >=total]`` bool plane stack for
        one contract into the ledger (union; planes are cumulative)."""
        planes = np.asarray(planes, bool)
        with self._lock:
            entry = self._entry(code_hash, total, jumpis)
            n = min(entry.instr.shape[0], planes.shape[1])
            entry.instr[:n] |= planes[PLANE_INSTR, :n]
            entry.edge_taken[:n] |= planes[PLANE_EDGE_TAKEN, :n]
            entry.edge_fall[:n] |= planes[PLANE_EDGE_FALL, :n]
        self._publish_gauge()

    def record_instr(self, code_hash: str, total: int,
                     indices: Iterable[int]) -> None:
        """Fold host-observed instruction indices (the coverage plugin's
        bitmap: walker replay + host-engine stepping) into the ledger.
        Out-of-range indices count into ``exploration.pc_overflow``."""
        overflow = 0
        with self._lock:
            entry = self._entry(code_hash, total)
            limit = entry.instr.shape[0]
            for i in indices:
                i = int(i)
                if 0 <= i < limit:
                    entry.instr[i] = True
                else:
                    overflow += 1
        if overflow:
            self.record_pc_overflow(overflow)
        self._publish_gauge()

    def register_static(self, code_hash: str, instr_mask,
                        taken_mask, fall_mask) -> None:
        """Install the static pass's reachability masks for one code
        (the reachable-edge oracle): `coverage_pct_reachable` quotes
        coverage against the statically reachable denominator instead
        of all decoded instructions (padding, metadata, dead code)."""
        with self._lock:
            entry = self._entry(code_hash, len(np.asarray(instr_mask)))
            entry.set_static(instr_mask, taken_mask, fall_mask)
        self._publish_gauge()

    def record_pc_overflow(self, n: int = 1) -> None:
        """An out-of-range pc was observed (and dropped, not clamped)."""
        self._reg().counter("exploration.pc_overflow").inc(n)

    @property
    def pc_overflow(self) -> int:
        return int(self._reg().counter("exploration.pc_overflow").value)

    def coverage(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {h: c.as_dict() for h, c in self._codes.items()}

    def coverage_pct(self, code_hash: Optional[str] = None
                     ) -> Optional[float]:
        """Raw instruction coverage percent (denominator = every decoded
        instruction): one contract, or the aggregate weighted by
        instruction counts when ``code_hash`` is None."""
        with self._lock:
            if code_hash is not None:
                entry = self._codes.get(code_hash)
                if entry is None or not entry.total:
                    return None
                return round(100.0 * int(entry.instr.sum()) / entry.total, 2)
            total = sum(c.total for c in self._codes.values())
            if not total:
                return None
            seen = sum(int(c.instr.sum()) for c in self._codes.values())
            return round(100.0 * seen / total, 2)

    def coverage_pct_reachable(self, code_hash: Optional[str] = None
                               ) -> Optional[float]:
        """Instruction coverage percent over the STATICALLY REACHABLE
        denominator.  Codes with no registered static masks contribute
        their raw denominator, so this is always ≥ `coverage_pct` and
        degrades to it when the static pass is off."""
        with self._lock:
            if code_hash is not None:
                entry = self._codes.get(code_hash)
                if entry is None or not entry.total:
                    return None
                r_instr, _ = entry._reach_counts()
                denom = r_instr if r_instr else entry.total
                return round(100.0 * int(entry.instr.sum()) / denom, 2)
            total = seen = 0
            for c in self._codes.values():
                if not c.total:
                    continue
                r_instr, _ = c._reach_counts()
                total += r_instr if r_instr else c.total
                seen += int(c.instr.sum())
            if not total:
                return None
            return round(100.0 * seen / total, 2)

    def _publish_gauge(self) -> None:
        """Per-codehash instruction coverage as dict-valued gauges —
        ``prometheus_text`` renders dict gauges as labeled samples, so the
        percentages reach Prometheus / ``--metrics-out`` directly.  Both
        denominators are published: raw (all decoded instructions) and
        statically reachable (the staticpass oracle)."""
        with self._lock:
            raw = {}
            reach = {}
            for h, c in self._codes.items():
                if not c.total:
                    continue
                seen = int(c.instr.sum())
                raw[h[:10]] = round(100.0 * seen / c.total, 2)
                r_instr, _ = c._reach_counts()
                denom = r_instr if r_instr else c.total
                reach[h[:10]] = round(100.0 * seen / denom, 2)
        self._reg().gauge("exploration.coverage_pct", default={}).set(raw)
        self._reg().gauge(
            "exploration.coverage_pct_reachable", default={}
        ).set(reach)

    # -- termination attribution ---------------------------------------

    def stamp(self, term_class: str, n: int = 1) -> None:
        """Record ``n`` paths terminating with ``term_class``.  The class
        counter and the total increment together, so the partition
        invariant cannot drift."""
        if term_class not in TERM_CLASSES:
            raise ValueError(f"unknown termination class {term_class!r}")
        self._terminated_counter().inc(term_class, n)
        self._reg().counter("exploration.terminated_total").inc(n)

    def terminated(self) -> Dict[str, int]:
        snap = self._terminated_counter().snapshot()
        return {cls: int(snap.get(cls, 0)) for cls in TERM_CLASSES}

    def terminated_total(self) -> int:
        return int(self._reg().counter("exploration.terminated_total").value)

    # -- solver hotspots -----------------------------------------------

    def record_solver_time(self, label: str, seconds: float) -> None:
        """Attribute feasibility-solve wall time to a program point."""
        if seconds < 0:
            return
        reg = self._reg()
        s = reg.labeled_counter("exploration.solver_hotspot_s",
                                label_name="point")
        if label not in s and len(s) >= _MAX_HOTSPOT_LABELS:
            label = "other"
        s.inc(label, round(float(seconds), 6))
        reg.labeled_counter("exploration.solver_hotspot_n",
                            label_name="point").inc(label)

    def solver_hotspots(self, top: int = 10) -> List[Dict[str, Any]]:
        reg = self._reg()
        secs = reg.labeled_counter("exploration.solver_hotspot_s",
                                   label_name="point").snapshot()
        counts = reg.labeled_counter("exploration.solver_hotspot_n",
                                     label_name="point").snapshot()
        ranked = sorted(secs.items(), key=lambda kv: -kv[1])[:max(top, 0)]
        return [
            {
                "point": label,
                "solver_s": round(float(sec), 4),
                "queries": int(counts.get(label, 0)),
            }
            for label, sec in ranked
        ]

    # -- snapshots ------------------------------------------------------

    def meta(self) -> Dict[str, Any]:
        """The ``meta.exploration`` block for jsonv2 reports and bench."""
        terminated = self.terminated()
        total = self.terminated_total()
        return {
            "coverage_pct": self.coverage_pct(),
            "coverage_pct_raw": self.coverage_pct(),
            "coverage_pct_reachable": self.coverage_pct_reachable(),
            "coverage": self.coverage(),
            "terminated": terminated,
            "terminated_total": total,
            "partition_ok": sum(terminated.values()) == total,
            "solver_hotspots": self.solver_hotspots(),
            "pc_overflow": int(
                self._reg().counter("exploration.pc_overflow").value
            ),
        }

    def snapshot(self) -> Dict[str, Any]:
        """The ``--coverage-out`` artifact: meta plus raw bitmaps (as
        index lists, JSON-serializable)."""
        out = self.meta()
        with self._lock:
            out["bitmaps"] = {
                h: {
                    "instr": np.flatnonzero(c.instr).tolist(),
                    "edge_taken": np.flatnonzero(c.edge_taken).tolist(),
                    "edge_fall": np.flatnonzero(c.edge_fall).tolist(),
                }
                for h, c in self._codes.items()
            }
        return out

    def bitmaps(self) -> Dict[str, Dict[str, Any]]:
        """Per-codehash coverage/reachability arrays, COPIED out under the
        lock — the adaptive planner's raw input.  Each entry carries the
        executed planes, the static reachability masks (or None when no
        summary was registered), and the denominators; callers own the
        copies and may mutate them freely."""
        with self._lock:
            return {
                h: {
                    "total": c.total,
                    "jumpis": c.jumpis,
                    "instr": c.instr.copy(),
                    "edge_taken": c.edge_taken.copy(),
                    "edge_fall": c.edge_fall.copy(),
                    "reach_instr": None if c.reach_instr is None
                    else c.reach_instr.copy(),
                    "reach_taken": None if c.reach_taken is None
                    else c.reach_taken.copy(),
                    "reach_fall": None if c.reach_fall is None
                    else c.reach_fall.copy(),
                }
                for h, c in self._codes.items()
            }

    def reset_scope(self) -> None:
        """Per-analysis sweep (the registry counters reset separately via
        ``reset_analysis_metrics``; this clears the bitmap side)."""
        with self._lock:
            self._codes.clear()


_ledger: Optional[ExplorationLedger] = None
_ledger_lock = threading.Lock()


def get_exploration_ledger() -> ExplorationLedger:
    global _ledger
    if _ledger is None:
        with _ledger_lock:
            if _ledger is None:
                _ledger = ExplorationLedger()
    return _ledger


def exploration_meta() -> Dict[str, Any]:
    """Module-level accessor mirroring ``observability_meta()``."""
    return get_exploration_ledger().meta()
