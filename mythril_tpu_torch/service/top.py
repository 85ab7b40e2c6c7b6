"""``myth top`` — a live operator view of a running analysis daemon.

Polls the daemon's ``stats`` verb and renders a refreshing terminal
table: admission depths, cache hit rates, per-phase latency percentiles
(the request-scoped telemetry histograms), per-tenant totals, and the
in-flight request list with each request's current phase and age.

``format_top`` is a pure function over one stats payload so tests can
assert the rendering against a canned dict; ``run_top`` owns the
connection/refresh loop.
"""

from __future__ import annotations

import sys
import time
from typing import Any, Dict, Optional, TextIO

from mythril_tpu_torch.service.client import ServiceClient

__all__ = ["format_health", "format_top", "run_top"]

# ANSI: clear screen + home.  Only emitted between refreshes, never in
# --once mode, so piped output stays clean.
_CLEAR = "\x1b[2J\x1b[H"

_PHASE_ORDER = ("queue_wait", "batch_wait", "execute", "stream",
                "ttfe", "probe")


def _ms(v: Any) -> str:
    if not isinstance(v, (int, float)):
        return "-"
    return f"{v * 1000:.1f}ms" if v < 1.0 else f"{v:.2f}s"


def format_top(stats: Dict[str, Any], address: Optional[str] = None) -> str:
    """Render one stats payload as the ``myth top`` screen."""
    lines = []
    title = "mythril-tpu service"
    if address:
        title += f" @ {address}"
    scope = stats.get("scope")
    if scope:
        title += f"  [{scope}]"
    lines.append(title)
    health = stats.get("health")
    if health and health.get("enabled"):
        breaching = health.get("breaching") or []
        if breaching:
            lines.append("!! SLO BREACH: " + ", ".join(breaching)
                         + f"  (breaches_total {health.get('breaches_total', 0)})")
        else:
            n = len(health.get("objectives") or [])
            line = f"slo: ok ({n} objective{'s' if n != 1 else ''}"
            warning = health.get("warning") or []
            if warning:
                line += f", warn: {', '.join(warning)}"
            if health.get("breaches_total"):
                line += f", breaches_total {health['breaches_total']}"
            lines.append(line + ")")
    hb = stats.get("heartbeat") or {}
    if hb.get("sources_dropped"):
        lines.append("WARN heartbeat: dropped sources "
                     + ", ".join(hb["sources_dropped"])
                     + " (repeated sampling errors)")
    cache = stats.get("cache") or {}
    lines.append(
        "queue {q}  inflight {i}  cached {c}  |  requests {r}  "
        "batches {b}  errors {e}  |  dedup {d:.0%}  replay {p:.0%}".format(
            q=stats.get("service.queue_depth", 0),
            i=stats.get("service.inflight", 0),
            c=stats.get("service.result_cache", 0),
            r=stats.get("service.requests", 0),
            b=stats.get("service.batches", 0),
            e=stats.get("service.request_errors", 0),
            d=cache.get("dedup_hit_rate", 0.0),
            p=cache.get("replay_hit_rate", 0.0),
        )
    )

    device = stats.get("device") or {}
    if device.get("compile_wall_s") or device.get("recompiles"):
        cache_d = device.get("cache") or {}
        line = "device: compile {c:.1f}s  cache {h}h/{m}m  recompiles {r}".format(
            c=device.get("compile_wall_s", 0.0),
            h=cache_d.get("hits", 0), m=cache_d.get("misses", 0),
            r=device.get("recompiles", 0),
        )
        if device.get("shape_churn"):
            line += f"  shape-churn {device['shape_churn']}"
        hbm = device.get("hbm_bytes") or {}
        if hbm:
            line += "  hbm {:.1f}MB".format(
                max(hbm.values()) / 1e6 if isinstance(hbm, dict) else 0.0
            )
        lines.append(line)

    workers = stats.get("workers") or []
    if workers:
        states = [w.get("state", "?") for w in workers]
        restarts = stats.get("service.worker_restarts", 0) or 0
        summary = (
            f"workers {len(workers)}  idle {states.count('idle')}  "
            f"busy {states.count('busy')}"
        )
        if restarts:
            summary += f"  restarts {restarts}"
        shed = stats.get("service.shed_total", 0) or 0
        quota = stats.get("service.quota_rejections", 0) or 0
        if shed or quota:
            summary += f"  |  shed {shed}  quota-rejected {quota}"
        lines.append(summary)
        if not (len(workers) == 1 and workers[0].get("state") == "inline"):
            lines.append(f"{'worker':<8}{'pid':>8} {'state':<10}"
                         f"{'batches':>9}{'restarts':>10}{'age':>9}"
                         f"{'exec p50':>10}{'kill%':>7}"
                         f"{'compile':>9}{'rcmp':>6}  rids")
            for w in workers:
                exec_p50 = ((w.get("phase_s") or {}).get("execute")
                            or {}).get("p50_s")
                pf = w.get("prefilter") or {}
                kill = (f"{pf['kill_rate'] * 100:.0f}%"
                        if pf.get("evaluated") else "-")
                dev = w.get("device") or {}
                compile_s = (_ms(dev["compile_s"])
                             if dev.get("compile_s") else "-")
                rcmp = (str(dev.get("recompiles", 0))
                        if dev else "-")
                rids = ",".join(w.get("active_rids") or []) or "-"
                lines.append(
                    f"w{w.get('id', '?'):<7}{str(w.get('pid', '-')):>8} "
                    f"{w.get('state', '?'):<10}{w.get('batches', 0):>9}"
                    f"{w.get('restarts', 0):>10}"
                    f"{_ms(w.get('age_s')) if w.get('age_s') else '-':>9}"
                    f"{_ms(exec_p50):>10}{kill:>7}"
                    f"{compile_s:>9}{rcmp:>6}  {rids}"
                )

    frontier = stats.get("frontier") or {}
    if frontier.get("bucket_classes") or frontier.get("page_faults"):
        line = (
            "frontier: {c} bucket classes  pad-waste {w:.1f}%"
            " (single-bucket {s:.1f}%)".format(
                c=frontier.get("bucket_classes", 0),
                w=frontier.get("pad_waste_pct", 0.0),
                s=frontier.get("pad_waste_single_bucket_pct", 0.0),
            )
        )
        if frontier.get("page_faults") or frontier.get("page_repacks"):
            line += "  |  paging: {f} faults  {r} repacks  {p:.0f}% resident".format(
                f=frontier.get("page_faults", 0),
                r=frontier.get("page_repacks", 0),
                p=frontier.get("page_resident_pct", 100.0),
            )
        lines.append(line)

    prefilter = stats.get("prefilter") or {}
    if prefilter.get("evaluated"):
        lines.append(
            "prefilter: {e} evaluated  {k} killed  ({r:.0%} kill rate)".format(
                e=prefilter.get("evaluated", 0),
                k=prefilter.get("killed", 0),
                r=prefilter.get("kill_rate", 0.0),
            )
        )

    devsolver = stats.get("devsolver") or {}
    if devsolver.get("admitted"):
        line = (
            "devsolver: {a} admitted  {s} sat  {u} unsat  {n} unknown  "
            "({r:.0%} decide rate)".format(
                a=devsolver.get("admitted", 0),
                s=devsolver.get("decided_sat", 0),
                u=devsolver.get("decided_unsat", 0),
                n=devsolver.get("unknown", 0),
                r=devsolver.get("decide_rate", 0.0),
            )
        )
        bad = devsolver.get("model_validation_failures", 0)
        if bad:
            line += f"  bad-models {bad}"
        lines.append(line)

    exploration = stats.get("exploration") or {}
    if exploration.get("terminated_total"):
        terminated = exploration.get("terminated") or {}
        cov = exploration.get("coverage_pct") or {}
        cov_reach = exploration.get("coverage_pct_reachable") or {}
        # compact class breakdown: only nonzero classes, largest first
        classes = "  ".join(
            f"{cls}={n}" for cls, n in
            sorted(terminated.items(), key=lambda kv: -kv[1]) if n
        )
        cov_txt = ""
        if cov:
            vals = list(cov.values())
            cov_txt = "  cov(avg) {:.1f}% raw".format(sum(vals) / len(vals))
            if cov_reach:
                rvals = list(cov_reach.values())
                cov_txt += " / {:.1f}% reachable".format(
                    sum(rvals) / len(rvals)
                )
            cov_txt += f" over {len(vals)} contracts"
        lines.append(
            "exploration: {t} paths terminated{c}".format(
                t=exploration.get("terminated_total", 0), c=cov_txt
            )
        )
        if classes:
            lines.append("  " + classes)

    adaptive = stats.get("adaptive") or {}
    if adaptive.get("plans"):
        line = (
            "adaptive: {p} plans  {s} resteered  {q} requeued  "
            "flips {h}/{f}".format(
                p=adaptive.get("plans", 0),
                s=adaptive.get("resteered_slots", 0),
                q=adaptive.get("requeued_paths", 0),
                h=adaptive.get("flips_hit", 0),
                f=adaptive.get("flips_planned", 0),
            )
        )
        if adaptive.get("plateau_stops"):
            line += f"  plateau-stops {adaptive['plateau_stops']}"
        stop = adaptive.get("coverage_stop") or {}
        if stop:
            line += "  last-stop {r}@{c:.1f}%".format(
                r=stop.get("reason", "?"),
                c=float(stop.get("coverage_pct_reachable") or 0.0),
            )
        lines.append(line)

    staticpass = stats.get("staticpass") or {}
    disabled = staticpass.get("gate_disabled") or {}
    if disabled:
        reasons = "  ".join(
            f"{r}={n}" for r, n in
            sorted(disabled.items(), key=lambda kv: -kv[1]) if n
        )
        lines.append(
            "WARN staticpass: gate self-disabled (nothing pruned)  "
            + reasons
        )

    phases = stats.get("phases") or {}
    if any((phases.get(p) or {}).get("count") for p in _PHASE_ORDER):
        lines.append("")
        lines.append(f"{'phase':<12}{'count':>7}{'avg':>10}{'p50':>10}"
                     f"{'p95':>10}{'p99':>10}")
        for p in _PHASE_ORDER:
            row = phases.get(p) or {}
            if not row.get("count"):
                continue
            lines.append(
                f"{p:<12}{row['count']:>7}{_ms(row.get('avg')):>10}"
                f"{_ms(row.get('p50')):>10}{_ms(row.get('p95')):>10}"
                f"{_ms(row.get('p99')):>10}"
            )

    tenants = stats.get("tenants") or {}
    if tenants:
        lines.append("")
        lines.append(f"{'tenant':<16}{'requests':>9}{'issues':>8}"
                     f"{'dedup':>7}{'compute_s':>11}")
        for tenant, row in sorted(tenants.items()):
            lines.append(
                f"{tenant:<16}{row.get('requests', 0):>9}"
                f"{row.get('issues', 0):>8}{row.get('dedup_hits', 0):>7}"
                f"{row.get('compute_s', 0.0):>11.3f}"
            )

    inflight = stats.get("inflight_requests") or []
    lines.append("")
    lines.append(f"in flight: {len(inflight)}")
    for req in inflight[:32]:
        lines.append(
            f"  {req.get('request_id', '?'):<10}"
            f"{(req.get('tenant') or '-'):<14}"
            f"{req.get('tier', '?'):<13}{req.get('phase', '?'):<12}"
            f"{_ms(req.get('age_s'))}"
        )
    if len(inflight) > 32:
        lines.append(f"  ... and {len(inflight) - 32} more")
    return "\n".join(lines)


_STATE_MARK = {"ok": "ok    ", "warn": "WARN  ", "breach": "BREACH",
               "no_data": "-     "}


def _fmt_value(v: Any, kind: str) -> str:
    if v is None:
        return "-"
    if kind == "ratio":
        return f"{v:.1%}"
    if kind == "quantile":
        return _ms(v)
    return f"{v:g}"


def format_health(health: Dict[str, Any],
                  address: Optional[str] = None) -> str:
    """Render one ``health`` payload as the ``myth health`` report.

    Pure over the payload (tests assert against canned dicts), mirroring
    ``format_top``.
    """
    if not health.get("enabled"):
        return "watchtower: disabled (daemon runs without --slo/watchtower)"
    lines = []
    title = "watchtower"
    if address:
        title += f" @ {address}"
    objectives = health.get("objectives") or []
    breaching = health.get("breaching") or []
    verdict = "BREACH" if breaching else "ok"
    n = len(objectives)
    title += (f": {verdict}  ({n} objective{'s' if n != 1 else ''}, "
              f"breaches_total {health.get('breaches_total', 0)}, "
              f"tick {health.get('interval_s', 0):g}s, "
              f"overhead {health.get('overhead_pct', 0):g}%)")
    lines.append(title)
    for e in objectives:
        kind = e.get("kind", "")
        win = ""
        if kind in ("quantile", "ratio"):
            win = (f"  [fast {e.get('fast_window_s', 0):g}s"
                   f"/slow {e.get('slow_window_s', 0):g}s"
                   f", n={e.get('window_count', 0)}]")
        lines.append(
            f"  {_STATE_MARK.get(e.get('state'), '?     ')} "
            f"{e.get('name', '?'):<22}"
            f"{_fmt_value(e.get('value'), kind):>10}  "
            f"{e.get('op', '?')} {_fmt_value(e.get('target'), kind)}"
            f"{win}"
        )
    for cap in health.get("captures") or []:
        lines.append(
            f"  capture: {cap.get('objective', '?')}"
            + (f"  bundle {cap['bundle']}" if cap.get("bundle") else "")
            + (f"  profile worker {cap['profile_worker']}"
               if "profile_worker" in cap else "")
        )
    return "\n".join(lines)


def run_top(
    host: str = "127.0.0.1",
    port: int = 7344,
    interval: float = 2.0,
    once: bool = False,
    iterations: Optional[int] = None,
    out: Optional[TextIO] = None,
) -> int:
    """Poll ``host:port`` and render until interrupted; returns exit code."""
    client = ServiceClient(host, port, timeout=10.0)
    out = out or sys.stdout
    n = 0
    while True:
        try:
            stats = client.stats()
        except OSError as exc:
            print(f"cannot reach analysis service at {host}:{port}: {exc}",
                  file=sys.stderr)
            return 1
        if not once and n:
            out.write(_CLEAR)
        out.write(format_top(stats, address=f"{host}:{port}") + "\n")
        out.flush()
        n += 1
        if once or (iterations is not None and n >= iterations):
            return 0
        try:
            time.sleep(interval)
        except KeyboardInterrupt:
            return 0
