"""Drift doctor: ranked attribution of perf movement between two runs.

Diagnosing a bench regression used to be a ritual: open two
``BENCH_*.json`` files side by side and eyeball which of the ~40 numbers
per workload moved.  This module makes attribution a tool.  It is a
*pure differ* — no registry access, no jax — over two inputs:

* two bench artifacts (``myth drift A.json B.json``), in any of the
  formats bench.py itself accepts (snapshot, driver wrapper, truncated
  tail); or
* two adjacent windows of a metrics history ring
  (``myth drift --history DIR``), via ``HistoryReader`` samples.

For every workload it extracts a fixed set of metrics (speedup, rates,
TTFE, harvest share and per-phase split, compile wall and cache
hit/miss, prefilter kill rate, coverage, spread noise), computes the
relative movement of each, weights it by how much that metric is known
to matter, and ranks the result.  The top of the ranking *names the
most-moved phase/counter* — which is exactly what ``bench.py``'s
``regression_gate`` prints on failure, so a breached threshold arrives
with its probable cause attached.

Torn inputs are data, not errors: workloads present on only one side
are reported (``only_in_prior`` / ``only_in_current``), metrics missing
from a row are skipped, non-numeric values are skipped.  The differ
never raises on artifact shape.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "attribute",
    "diff_history_windows",
    "diff_tables",
    "format_drift",
    "load_bench_table",
]

# movement below this fraction is noise, not a finding
MIN_REL = 0.02
# relative movement is clipped here so a 0 -> something transition cannot
# drown every real finding (appears as ">=300%")
REL_CAP = 3.0
_EPS = 1e-9


def _get(row: Dict[str, Any], path: Sequence[str]) -> Optional[float]:
    cur: Any = row
    for key in path:
        if not isinstance(cur, dict) or key not in cur:
            return None
        cur = cur[key]
    if isinstance(cur, bool) or not isinstance(cur, (int, float)):
        return None
    return float(cur)


def _spread_width(row: Dict[str, Any]) -> Optional[float]:
    """Production spread width as % of the production rate (noise)."""
    spread = row.get("spread")
    mid = row.get("production")
    if (not isinstance(spread, dict)
            or not isinstance(mid, (int, float)) or not mid):
        return None
    lohi = spread.get("production")
    if (not isinstance(lohi, (list, tuple)) or len(lohi) != 2
            or not all(isinstance(v, (int, float)) for v in lohi)):
        return None
    return 100.0 * (float(lohi[1]) - float(lohi[0])) / abs(float(mid))


# (metric label, extractor, higher_is_better, weight).  Weights encode
# how directly each metric explains a speedup movement: the headline
# ratio and the phase walls that compose it rank above ambient
# counters.  higher_is_better=None means movement is reported neutrally.
_SPECS: List[Tuple[str, Callable[[Dict[str, Any]], Optional[float]],
                   Optional[bool], float]] = [
    ("speedup", lambda r: _get(r, ("speedup",)), True, 3.0),
    ("production_rate", lambda r: _get(r, ("production",)), True, 2.0),
    ("baseline_rate", lambda r: _get(r, ("baseline",)), True, 1.0),
    ("ttfe_s.production", lambda r: _get(r, ("ttfe_s", "production")),
     False, 2.5),
    ("ttfe_s.baseline", lambda r: _get(r, ("ttfe_s", "baseline")),
     False, 1.0),
    ("harvest_share_pct", lambda r: _get(r, ("harvest_share_pct",)),
     False, 1.5),
    ("harvest_phase_s.ingest",
     lambda r: _get(r, ("harvest_phase_s", "ingest")), False, 2.0),
    ("harvest_phase_s.solver",
     lambda r: _get(r, ("harvest_phase_s", "solver")), False, 2.0),
    ("harvest_phase_s.replay",
     lambda r: _get(r, ("harvest_phase_s", "replay")), False, 2.0),
    ("harvest_phase_s.commit",
     lambda r: _get(r, ("harvest_phase_s", "commit")), False, 2.0),
    ("compile_s.production", lambda r: _get(r, ("compile_s", "production")),
     False, 2.0),
    ("device.compile_wall_s",
     lambda r: _get(r, ("device", "compile_wall_s")), False, 2.0),
    ("device.recompiles", lambda r: _get(r, ("device", "recompiles")),
     False, 1.5),
    ("compilecache.production.misses",
     lambda r: _get(r, ("compilecache", "production", "misses")),
     False, 1.0),
    ("prefilter.kill_rate",
     lambda r: _get(r, ("prefilter", "kill_rate")), True, 1.5),
    ("devsolver.decide_rate",
     lambda r: _get(r, ("devsolver", "decide_rate")), True, 1.5),
    ("devsolver.decided",
     lambda r: _get(r, ("devsolver", "decided")), True, 1.0),
    ("exploration.coverage_pct",
     lambda r: _get(r, ("exploration", "coverage_pct")), True, 1.5),
    ("exploration.coverage_pct_reachable",
     lambda r: _get(r, ("exploration", "coverage_pct_reachable")),
     True, 1.5),
    # the reachable-edge denominator itself: movement means the corpus
    # or the static oracle changed, not that the run got better/worse
    ("staticpass.reachable_edge_pct",
     lambda r: _get(r, ("staticpass", "reachable_edge_pct")), None, 1.0),
    ("device_residency_pct", lambda r: _get(r, ("device_residency_pct",)),
     True, 1.0),
    # large-code frontier pad economics: pad waste is padded cells the
    # device computes but the corpus never uses — lower is strictly
    # better.  Paging pressure is reported neutrally (faults trade
    # against pad waste; neither direction alone means regression)
    ("frontier.pad_waste_pct",
     lambda r: _get(r, ("frontier", "pad_waste_pct")), False, 2.0),
    ("frontier.bucket_classes",
     lambda r: _get(r, ("frontier", "bucket_classes")), None, 1.0),
    ("frontier.page_faults",
     lambda r: _get(r, ("frontier", "page_faults")), None, 1.0),
    ("frontier.page_repacks",
     lambda r: _get(r, ("frontier", "page_repacks")), None, 1.0),
    ("frontier.page_resident_pct",
     lambda r: _get(r, ("frontier", "page_resident_pct")), True, 1.0),
    # adaptive steering: fewer dispatched segments at equal issue sets is
    # the controller doing its job; resteer/requeue volume is reported
    # neutrally (more steering is not inherently better or worse)
    ("segments_dispatched", lambda r: _get(r, ("segments_dispatched",)),
     False, 1.5),
    ("adaptive.resteered_slots",
     lambda r: _get(r, ("adaptive", "resteered_slots")), None, 1.0),
    ("adaptive.requeued_paths",
     lambda r: _get(r, ("adaptive", "requeued_paths")), None, 1.0),
    ("adaptive.flip_hit_rate",
     lambda r: _get(r, ("adaptive", "flip_hit_rate")), True, 1.0),
    ("spread.production.width_pct", _spread_width, False, 1.0),
]


def _finding(workload: str, metric: str, prior: float, current: float,
             higher_is_better: Optional[bool],
             weight: float) -> Optional[Dict[str, Any]]:
    delta = current - prior
    rel = delta / max(abs(prior), _EPS)
    rel = max(-REL_CAP, min(REL_CAP, rel))
    if abs(rel) < MIN_REL:
        return None
    if higher_is_better is None:
        direction = "moved"
    elif (rel > 0) == higher_is_better:
        direction = "improved"
    else:
        direction = "regressed"
    score = weight * abs(rel)
    if direction == "regressed":
        # a regression outranks an equally-sized improvement: the tool's
        # job is to answer "what went wrong", not "what happened"
        score *= 1.5
    return {
        "workload": workload,
        "metric": metric,
        "prior": round(prior, 6),
        "current": round(current, 6),
        "delta": round(delta, 6),
        "rel_pct": round(100.0 * rel, 1),
        "direction": direction,
        "score": round(score, 4),
    }


def diff_tables(prior: Dict[str, Any], current: Dict[str, Any],
                prior_name: str = "prior",
                current_name: str = "current") -> Dict[str, Any]:
    """Rank per-workload metric movement between two workload tables.

    ``prior``/``current`` are bench ``workloads`` tables (name -> row).
    Pure function; tolerant of torn rows and missing workloads.
    """
    prior = prior if isinstance(prior, dict) else {}
    current = current if isinstance(current, dict) else {}
    shared = [w for w in current if w in prior
              and isinstance(prior[w], dict) and isinstance(current[w], dict)]
    findings: List[Dict[str, Any]] = []
    for workload in shared:
        p_row, c_row = prior[workload], current[workload]
        for metric, extract, better, weight in _SPECS:
            p_v, c_v = extract(p_row), extract(c_row)
            if p_v is None or c_v is None:
                continue
            f = _finding(workload, metric, p_v, c_v, better, weight)
            if f is not None:
                findings.append(f)
    findings.sort(key=lambda f: -f["score"])
    report = {
        "mode": "bench",
        "prior": prior_name,
        "current": current_name,
        "workloads_compared": sorted(shared),
        "only_in_prior": sorted(w for w in prior if w not in current),
        "only_in_current": sorted(w for w in current if w not in prior),
        "ranked": findings,
    }
    report["headline"] = attribute(report)
    return report


def attribute(report: Dict[str, Any],
              workload: Optional[str] = None) -> str:
    """One line naming the most-moved metric (optionally per workload).

    This is what the regression gate prints next to a breached
    threshold, so ``workload`` lets the gate ask about the violator.
    """
    ranked = report.get("ranked") or []
    if workload is not None:
        ranked = [f for f in ranked if f.get("workload") == workload]
    if not ranked:
        return "drift: no metric moved beyond noise"
    top = ranked[0]
    return (
        "drift: most-moved {w}: {m} {p:g} -> {c:g} ({r:+.1f}%, {d})".format(
            w=top.get("workload", "?"), m=top["metric"], p=top["prior"],
            c=top["current"], r=top["rel_pct"], d=top["direction"],
        )
    )


def format_drift(report: Dict[str, Any], limit: int = 15) -> str:
    """Render a ranked attribution report for terminals."""
    lines = [
        "drift report  {} -> {}".format(report.get("prior", "?"),
                                        report.get("current", "?")),
    ]
    compared = report.get("workloads_compared")
    if compared is not None:
        lines.append("compared workloads: "
                     + (", ".join(compared) or "(none)"))
    for side, key in (("prior", "only_in_prior"),
                      ("current", "only_in_current")):
        extra = report.get(key)
        if extra:
            lines.append(f"only in {side}: " + ", ".join(extra))
    ranked = report.get("ranked") or []
    if not ranked:
        lines.append("no metric moved beyond noise")
        return "\n".join(lines)
    lines.append("")
    lines.append(f"{'#':>3} {'workload':<18} {'metric':<30}"
                 f"{'prior':>12} {'current':>12} {'move':>9}  verdict")
    for i, f in enumerate(ranked[:limit], 1):
        lines.append(
            f"{i:>3} {f.get('workload', '?'):<18} {f['metric']:<30}"
            f"{f['prior']:>12g} {f['current']:>12g}"
            f"{f['rel_pct']:>+8.1f}%  {f['direction'].upper()}"
        )
    if len(ranked) > limit:
        lines.append(f"    ... and {len(ranked) - limit} more")
    lines.append("")
    lines.append(report.get("headline") or attribute(report))
    return "\n".join(lines)


# -- history-window mode ---------------------------------------------------

# direction hints for live service/frontier series; anything unlisted is
# reported neutrally ("moved")
_HISTORY_LOWER_IS_BETTER = (
    "service.request_errors", "service.shed_total",
    "service.quota_rejections", "heartbeat.device_recompiles",
    "heartbeat.device_shape_churn", "heartbeat.device_compile_s",
    "slo.breaches_total",
)


def diff_history_windows(samples: Sequence[Tuple[float, Dict[str, Any]]],
                         window_s: float,
                         bounds: Optional[Dict[str, Tuple[float, ...]]]
                         = None) -> Dict[str, Any]:
    """Compare the last ``window_s`` of a history ring to the window
    before it.

    ``samples`` is a time-ordered ``[(t, values)]`` sequence in the
    history wire format (counters as numbers, histograms as
    ``{"c","s","mn","mx","bc"}`` dicts, label maps as flat dicts).
    Counters and histogram sums compare as per-window deltas (rates);
    histogram windows additionally compare the window p50 when bucket
    ``bounds`` are known.  Pure over the sample list.
    """
    from mythril_tpu_torch.observability.history import (
        counter_window,
        window_percentile,
    )

    samples = list(samples)
    report_base = {
        "mode": "history",
        "prior": f"window [-{2 * window_s:g}s, -{window_s:g}s)",
        "current": f"window [-{window_s:g}s, now]",
        "ranked": [],
    }
    if not samples:
        report_base["headline"] = "drift: history is empty"
        return report_base
    t_end = samples[-1][0]
    a0, a1 = t_end - 2 * window_s, t_end - window_s
    b0, b1 = t_end - window_s, t_end

    names: Dict[str, Any] = {}
    for _, vals in samples:
        for k, v in vals.items():
            names.setdefault(k, v)

    findings: List[Dict[str, Any]] = []

    def _rank(metric: str, prior_v: float, current_v: float) -> None:
        better = (False if metric.split(".p")[0]
                  in _HISTORY_LOWER_IS_BETTER
                  or metric.rsplit(".", 1)[0] in _HISTORY_LOWER_IS_BETTER
                  else None)
        f = _finding("(window)", metric, prior_v, current_v, better, 1.0)
        if f is not None:
            findings.append(f)

    for name, example in sorted(names.items()):
        if isinstance(example, dict) and "bc" in example:
            # histogram: compare per-window observation rate and p50
            da = _hist_window_sum(samples, name, a0, a1)
            db = _hist_window_sum(samples, name, b0, b1)
            if da is not None and db is not None:
                _rank(name + ".rate_hz", da[0] / max(window_s, _EPS),
                      db[0] / max(window_s, _EPS))
                if da[0] and db[0]:
                    _rank(name + ".avg_s", da[1] / da[0], db[1] / db[0])
            if bounds and name in bounds:
                pa, _na = window_percentile(samples, name, 0.5, a0, a1,
                                            bounds)
                pb, _nb = window_percentile(samples, name, 0.5, b0, b1,
                                            bounds)
                if pa is not None and pb is not None:
                    _rank(name + ".p50", pa, pb)
        elif isinstance(example, dict):
            # label map: total per-window delta
            da = _labeled_window(samples, name, a0, a1)
            db = _labeled_window(samples, name, b0, b1)
            _rank(name + ".total", da, db)
        elif isinstance(example, (int, float)):
            _rank(name, counter_window(samples, name, a0, a1),
                  counter_window(samples, name, b0, b1))

    findings.sort(key=lambda f: -f["score"])
    report = dict(report_base)
    report["ranked"] = findings
    report["headline"] = attribute(report)
    return report


def _hist_window_sum(samples, name: str, t0: float,
                     t1: float) -> Optional[Tuple[float, float]]:
    """(count delta, sum delta) of histogram ``name`` over ``(t0, t1]``."""
    s0 = s1 = None
    for t, vals in samples:
        if t > t1:
            break
        if t <= t0:
            s0 = vals
        s1 = vals
    end = (s1 or {}).get(name)
    if not isinstance(end, dict) or "c" not in end:
        return None
    base = (s0 or {}).get(name)
    c0 = base.get("c", 0) if isinstance(base, dict) else 0
    sum0 = base.get("s", 0.0) if isinstance(base, dict) else 0.0
    c1, sum1 = end.get("c", 0), end.get("s", 0.0)
    if not isinstance(c1, (int, float)) or c1 < c0:
        # restart seam: take everything since the restart
        return float(c1 or 0), float(sum1 or 0.0)
    return float(c1 - c0), float((sum1 or 0.0) - (sum0 or 0.0))


def _labeled_window(samples, name: str, t0: float, t1: float) -> float:
    s0 = s1 = None
    for t, vals in samples:
        if t > t1:
            break
        if t <= t0:
            s0 = vals
        s1 = vals
    end = (s1 or {}).get(name)
    base = (s0 or {}).get(name)
    total1 = (sum(v for v in end.values() if isinstance(v, (int, float)))
              if isinstance(end, dict) else 0.0)
    total0 = (sum(v for v in base.values() if isinstance(v, (int, float)))
              if isinstance(base, dict) else 0.0)
    return float(total1 if total1 < total0 else total1 - total0)


# -- artifact loading ------------------------------------------------------


def load_bench_table(path: str) -> Dict[str, Any]:
    """Load a bench artifact's workload table (mirrors bench.py's
    loader contract: snapshot, driver wrapper, or raw stdout tail —
    the last parseable snapshot line wins).  Returns ``{}`` when no
    table can be recovered (torn artifacts are tolerated, not fatal).
    """
    try:
        raw = Path(path).read_text()
    except OSError:
        return {}
    try:
        doc = json.loads(raw)
    except ValueError:
        doc = None
    text = raw
    if isinstance(doc, dict):
        if isinstance(doc.get("workloads"), dict):
            return doc["workloads"]
        parsed = doc.get("parsed")
        if isinstance(parsed, dict) and isinstance(parsed.get("workloads"),
                                                   dict):
            return parsed["workloads"]
        text = doc.get("tail") or ""
    for line in reversed(text.splitlines()):
        line = line.strip()
        if not line.startswith("{"):
            continue
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        if isinstance(obj, dict) and isinstance(obj.get("workloads"), dict):
            return obj["workloads"]
    return {}
