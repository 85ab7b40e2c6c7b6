"""The port's span tracer, device plane and metrics surfaces against the JAX
package's.

* The JAX ``tests/observability/test_tracer.py`` cases run on the port's
  tracer (a copy, but for ``device_annotation``), and the
  ``test_facades.py`` cases on the registry facades (``as_dict`` compared
  on the JAX package's keys: the port appends ``replay_errors`` and
  ``commit_errors``).
* The device plane's own cases: dispatch scopes, a kernel build tagged by
  its bucket (a stand-in ``nvcc``), recompiles per dispatch session, the
  labeled segment series, host-clock stamps on the CPU, the memory
  analysis's degradation, ``device_meta``'s key set.
* The segment microbench (``tests/frontier/test_microbench.py`` on the
  port, both loops) and the benchmark plugin's cases of
  ``tests/analysis/test_plugin_system.py``.
* Span parity: the recording ``tests/testdata/torch_trace_runs.json`` holds,
  for each recorded command line, what the JAX CLI wrote under
  ``--trace-out`` and ``--metrics-out`` (the forced frontier,
  ``--no-pipeline --harvest-workers 0``, the device probe, every other
  default tier on but the mesh): the count of every span, flow and
  metadata event by name and phase, the metric names, and the integer
  counters.  The port's CLI, replayed in process on the CPU, must write the
  same counts exactly, the same metric names but the deviations
  ``JAX_ONLY_METRICS`` and ``PORT_ONLY_METRICS`` (ROADMAP Known
  deviations), and the same integers.

    JAX_PLATFORMS=cpu python tests/test_torch_observability.py --write

records the fixture (each JAX run in a process of its own with a fresh
HOME; about two minutes).
"""

from __future__ import annotations

import collections
import json
import os
import re
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "testdata" / "torch_trace_runs.json"
if str(REPO) not in sys.path:  # run as a script (--write)
    sys.path.insert(0, str(REPO))
from tests._torch_parity import _one_torch_thread  # noqa: E402,F401  (autouse fixture)

KILL_SIMPLE = "60003560e01c6341c0e1b51460145760006000fd5b33ff"
KILLBILLY = ("60003560e01c80630a11ce0014601e576341c0e1b51460255760006000fd5b6001600055"
             "005b60005460011460345760006000fd5b33ff")
# the recorded command lines: (name, argv the port runs); the JAX CLI gets
# JAX_PINS in place of PORT_PINS
FRONTIER = ["-o", "jsonv2", "--frontier", "--frontier-force"]
RUNS = (
    ("kill_simple-1tx/frontier",
     ["analyze", "-c", KILL_SIMPLE, "--bin-runtime", "-t", "1", *FRONTIER]),
    ("killbilly_2tx/frontier",
     ["analyze", "-c", KILLBILLY, "--bin-runtime", "-t", "2", *FRONTIER]),
)
PORT_PINS = ["--probe-backend", "device", "--no-pipeline", "--harvest-workers", "0"]
JAX_PINS = ["--probe-backend", "jax", "--no-pipeline", "--harvest-workers", "0", "--no-mesh"]

# metrics the JAX CLI writes on its CPU that the port has no counterpart for
# (ROADMAP Known deviations): XLA's trace, lower and compile events and its
# cost analysis (the port's kernels are built by nvcc, once, and only on the
# card); the allocator's peak, which the CPU has no caching allocator for
JAX_ONLY_METRICS = {
    "device.trace_wall_s", "device.trace_wall_s_total",
    "device.lower_wall_s", "device.lower_wall_s_total",
    "device.compile_wall_s", "device.compile_wall_s_total", "device.compile_wall_s_by_bucket",
    "device.shapes_compiled_total", "device.shape_churn_total",
    "device.cache_hits", "device.cache_hits_by_bucket",
    "device.cache_misses", "device.cache_misses_by_bucket",
    "device.flops_per_segment", "device.bytes_accessed_per_segment", "device.hbm_bytes",
}
# the port's own: the two frontier error counters, the solver's three device
# counters, and the analysis the plane cannot make (a reason, never a zero)
PORT_ONLY_METRICS = {
    "frontier.replay_errors", "frontier.commit_errors",
    "solver.tape_unsupported", "solver.lowering_unsupported", "solver.device_dispatches",
    "device.analysis_unavailable",
}
# meta.device keys the JAX CLI's CPU run has and the port's cannot
JAX_ONLY_DEVICE_META = {"flops_per_segment", "hbm_bytes"}
PORT_ONLY_DEVICE_META = {"analysis_unavailable"}
# the report meta blocks the port does not carry (none since the
# watchtower's health was ported)
JAX_ONLY_REPORT_META = set()


def port_cases(path: Path, name: str, subs=(), extra=None) -> types.ModuleType:
    """The JAX test module at ``path`` with the package renamed, as a module
    of its own: its test functions and fixtures then run on the port.
    ``subs``: further (pattern, replacement) rewrites; ``extra``: names put
    in the module before its source runs."""
    src = re.sub(r"\bmythril_tpu(?!_torch)\b", "mythril_tpu_torch", path.read_text())
    for pattern, repl in subs:
        src, n = re.subn(pattern, repl, src)
        assert n, f"{path.name}: the rewrite {pattern!r} matched nothing"
    mod = types.ModuleType(name)
    mod.__file__ = str(path)
    mod.__dict__.update(extra or {})
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


def _adopt(mod: types.ModuleType, prefix: str, names=None) -> None:
    """The module's ``test_*`` functions (those in ``names``, or all) and its
    fixtures, here under ``test_port_<prefix>_*``."""
    for key, value in vars(mod).items():
        if key.startswith("test_") and (names is None or key in names):
            globals()[f"test_port_{prefix}_{key[5:]}"] = value
        elif hasattr(value, "_fixture_function_marker"):
            globals()[key] = value


# ---------------------------------------------------------------------------
# the JAX package's cases on the port
# ---------------------------------------------------------------------------

_OBS = REPO / "tests" / "observability"
_adopt(port_cases(_OBS / "test_tracer.py", "port_test_tracer"), "tracer")


def _jax_keys(d: dict) -> dict:
    """A ``FrontierStatistics.as_dict()`` on the JAX package's keys."""
    return {k: v for k, v in d.items() if k not in ("replay_errors", "commit_errors")}


_adopt(port_cases(_OBS / "test_facades.py", "port_test_facades",
                  subs=[(r"json\.dumps\((\w+(?:\(\))?)\.as_dict\(\)\)",
                         r"json.dumps(_jax_keys(\1.as_dict()))")],
                  extra={"_jax_keys": _jax_keys}), "facades")
_adopt(port_cases(REPO / "tests" / "analysis" / "test_plugin_system.py", "port_test_plugins",
                  subs=[(r"execution_timeout=30,\n", "execution_timeout=30, device=\"cpu\",\n")]),
       "plugins", names={"test_benchmark_plugin_writes_series_and_svg",
                         "test_render_series_svg_empty_series",
                         "test_render_series_svg_escapes_markup",
                         "test_benchmark_long_series_downsampled_not_truncated",
                         "test_frontier_stats_in_report_meta"})


def test_facade_as_dict_appends_the_port_counters():
    from mythril_tpu_torch.frontier.stats import FrontierStatistics

    stats = FrontierStatistics()
    stats.reset()
    try:
        stats.count("replay_errors")
        d = stats.as_dict()
        assert list(d)[-2:] == ["replay_errors", "commit_errors"]
        assert (d["replay_errors"], d["commit_errors"]) == (1, 0)
    finally:
        stats.reset()


def test_solver_facade_keeps_the_port_counters():
    from mythril_tpu_torch.observability import get_registry
    from mythril_tpu_torch.smt.solver import SolverStatistics

    stats = SolverStatistics()
    stats.reset()
    stats.inc("device_dispatches", 3)
    assert stats.as_dict()["device_dispatches"] == 3
    assert get_registry().snapshot()["solver.device_dispatches"] == 3
    stats.reset()
    assert stats.device_dispatches == 0


def test_views_read_the_registry():
    """The port's older names read the registry, and create nothing."""
    from mythril_tpu_torch import absdomain, devsolver, staticpass
    from mythril_tpu_torch.frontier import pipeline
    from mythril_tpu_torch.observability import get_registry
    from mythril_tpu_torch.querycache import cache

    reg = get_registry()
    reg.reset()
    before = set(reg.snapshot())
    assert dict(staticpass.GATE_DISABLED) == {} and cache.ENTRY_HITS.get("confirm") is None
    assert pipeline.COUNTERS["delta_pulls"] == 0 and absdomain.killed == 0
    assert devsolver.unknown == 0
    assert set(reg.snapshot()) == before
    reg.counter("staticpass.contracts").inc(2)
    reg.labeled_counter("staticpass.gate_disabled", label_name="reason").inc("x")
    pipeline.count("delta_pulls")
    reg.counter("prefilter.killed").inc()
    assert staticpass.COUNTERS["contracts"] == 2 and dict(staticpass.GATE_DISABLED) == {"x": 1}
    assert pipeline.COUNTERS["delta_pulls"] == 1 and absdomain.killed == 1
    staticpass.reset_counters()
    pipeline.reset_counters()
    absdomain.reset_counters()
    assert staticpass.COUNTERS["contracts"] == 0 and pipeline.COUNTERS["delta_pulls"] == 0
    assert absdomain.killed == 0


def test_device_annotation_is_a_profiler_range_when_tracing():
    import torch

    from mythril_tpu_torch.observability import tracer as tr

    t = tr.get_tracer()
    assert tr.device_annotation("x") is tr._NULL_CONTEXT
    t.reset()
    t.enabled = True
    try:
        with torch.profiler.profile() as prof:
            with tr.device_annotation("frontier.segment"):
                torch.ones(4).sum()
        assert any(e.key == "frontier.segment" for e in prof.key_averages())
    finally:
        t.enabled = False
        t.reset()


# ---------------------------------------------------------------------------
# the device plane
# ---------------------------------------------------------------------------


@pytest.fixture
def plane():
    from mythril_tpu_torch.observability import deviceplane as dp

    dp.reset_for_tests()
    yield dp
    dp.reset_for_tests()


def _counter(name):
    from mythril_tpu_torch.observability import get_registry

    return get_registry().counter(name, persistent=True).value or 0


def _labeled(name):
    from mythril_tpu_torch.observability import get_registry

    m = get_registry()._metrics.get(name)
    return dict(m) if isinstance(m, dict) else {}


def test_scope_nesting(plane):
    assert plane.bucket_tag((1, 2, 3, 4)) == "1x2x3x4"
    assert plane.current_bucket() is None
    with plane.dispatch_scope((1, 2, 3, 4)):
        assert plane.current_bucket() == "1x2x3x4"
        with plane.dispatch_scope("8x16x4x2"):
            assert plane.current_bucket() == "8x16x4x2"
        assert plane.current_bucket() == "1x2x3x4"
    assert plane.current_bucket() is None


def test_kernel_build_is_a_compile_event_tagged_by_its_bucket(plane, tmp_path, monkeypatch):
    """``_build.build`` with a stand-in nvcc: the first build is a cache
    miss and a compile event tagged with the dispatch scope, the second a
    cache hit."""
    from mythril_tpu_torch.ops import _build

    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nwhile [ $# -gt 1 ]; do [ "$1" = -o ] && touch "$2"; shift; done\n')
    fake.chmod(0o755)
    src = tmp_path / "k.cu"
    src.write_text("// a kernel\n")
    monkeypatch.setattr(_build, "nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(plane, "_installed", True)
    wall0 = _labeled("device.compile_wall_s_by_bucket").get("4x8x2x1", 0)
    miss0 = _labeled("device.cache_misses_by_bucket").get("4x8x2x1", 0)
    hit0 = _labeled("device.cache_hits_by_bucket").get("4x8x2x1", 0)
    with plane.dispatch_scope((4, 8, 2, 1)):
        lib = _build.build([src], name="probe")
        assert lib.exists()
        _build.build([src], name="probe")
    assert _labeled("device.compile_wall_s_by_bucket")["4x8x2x1"] > wall0
    assert _labeled("device.cache_misses_by_bucket")["4x8x2x1"] == miss0 + 1
    assert _labeled("device.cache_hits_by_bucket")["4x8x2x1"] == hit0 + 1


def test_build_reports_nothing_before_install(plane, tmp_path, monkeypatch):
    from mythril_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(plane, "_installed", False)
    src = tmp_path / "k.cu"
    src.write_text("// a kernel\n")
    _build.library_path([src], "probe").write_text("")
    hits = _counter("device.cache_hits")
    _build.build([src], name="probe")
    assert _counter("device.cache_hits") == hits


def test_recompile_counted_per_session_not_per_event(plane):
    rcmp0 = _counter("device.recompiles_total")
    churn0 = _counter("device.shape_churn_total")
    shapes0 = _counter("device.shapes_compiled_total")
    with plane.dispatch_scope("9x9x9x9"):
        plane.on_compile(0.1)
        plane.on_compile(0.1)  # same-session burst
    assert _counter("device.recompiles_total") == rcmp0
    assert _counter("device.shapes_compiled_total") == shapes0 + 1
    with plane.dispatch_scope("7x7x7x7"):
        plane.on_compile(0.1)
    assert _counter("device.shape_churn_total") == churn0 + 1
    assert _counter("device.recompiles_total") == rcmp0
    with plane.dispatch_scope("9x9x9x9"):
        plane.on_compile(0.1)
        plane.on_compile(0.1)
    assert _counter("device.recompiles_total") == rcmp0 + 1
    assert _labeled("device.recompiles_by_bucket")["9x9x9x9"] >= 1


def test_unscoped_build_lands_in_untagged(plane):
    plane.on_compile(0.05)
    plane.on_cache(True)
    assert _labeled("device.compile_wall_s_by_bucket")["untagged"] > 0
    assert _labeled("device.cache_hits_by_bucket")["untagged"] >= 1


def test_observe_segment_emits_labeled_series(plane):
    from mythril_tpu_torch.observability.metrics import prometheus_text

    count0 = _labeled("frontier.segment_device_s_count").get("5x5x5x5", 0)
    plane.observe_segment(0.25, "5x5x5x5")
    plane.observe_segment(0.75, "5x5x5x5")
    assert _labeled("frontier.segment_device_s_count")["5x5x5x5"] == count0 + 2
    assert _labeled("frontier.segment_device_s_sum")["5x5x5x5"] >= 1.0
    assert 'frontier_segment_device_s_sum{bucket="5x5x5x5"}' in prometheus_text()


def test_cpu_stamps_are_host_clocks_published_at_settle(plane):
    count0 = _labeled("frontier.pull_device_s_count").get("3x3x3x3", 0)
    with plane.dispatch_scope("3x3x3x3"):
        stamp = plane.stamp_begin("cpu")
        time.sleep(0.002)
        plane.stamp_end(stamp, "frontier.pull_device_s")
    assert _labeled("frontier.pull_device_s_count").get("3x3x3x3", 0) == count0
    assert plane.settle(final=True) == 1
    assert _labeled("frontier.pull_device_s_count")["3x3x3x3"] == count0 + 1
    assert plane.settle(final=True) == 0


def test_a_stamp_in_flight_at_the_final_settle_raises(plane):
    class Pending:
        base, tag = "frontier.segment_device_s", "x"

        def done(self):
            return False

    plane._pending.append(Pending())
    assert plane.settle() == 0
    with pytest.raises(RuntimeError, match="still in flight"):
        plane.settle(final=True)


def test_memory_analysis_degrades_to_reasons_on_the_cpu(plane, monkeypatch):
    reasons0 = _labeled("device.analysis_unavailable")
    with plane.harvest_analysis("cpu", "6x6x6x6"):
        pass
    with plane.harvest_analysis("cpu", "6x6x6x6"):  # once per tag
        pass
    got = _labeled("device.analysis_unavailable")
    for reason in ("cost_analysis:none", "memory_analysis:none"):
        assert got[reason] == reasons0.get(reason, 0) + 1
    assert "6x6x6x6" not in plane.device_meta().get("hbm_bytes", {})
    monkeypatch.setenv("MYTHRIL_DEVICE_ANALYSIS", "0")
    with plane.harvest_analysis("cpu", "7x7x7x7"):
        pass
    assert _labeled("device.analysis_unavailable") == got


def test_install_env_gate(plane, monkeypatch):
    monkeypatch.setattr(plane, "_installed", False)
    monkeypatch.setenv("MYTHRIL_DEVICEPLANE", "0")
    assert plane.install() is False
    assert plane.installed() is False


def test_device_meta_reads_registry(plane):
    with plane.dispatch_scope("1x1x1x1"):
        plane.on_compile(0.5)
    plane.observe_segment(2.0, "1x1x1x1")
    plane.note_backend("cpu")
    meta = plane.device_meta()
    assert meta["backend"] == "cpu"
    assert meta["compile_wall_s"] > 0 and "1x1x1x1" in meta["compile_wall_s_by_bucket"]
    assert meta["segment_device_s"]["count"] >= 1
    assert isinstance(meta["overhead_pct"], float)
    assert meta["cache"].keys() == {"hits", "misses"}
    assert plane.heartbeat_source()["heartbeat.device_compile_s"] == meta["compile_wall_s"]


# ---------------------------------------------------------------------------
# the segment microbench
# ---------------------------------------------------------------------------


def _wide_contract(n_branches: int) -> bytes:
    out = b""
    for k in range(n_branches):
        dest = len(out) + 10
        out += bytes([0x60, k, 0x35, 0x60, 0x01, 0x16,
                      0x61, (dest >> 8) & 0xFF, dest & 0xFF, 0x57, 0x5B])
    return out + bytes([0x33, 0xFF])


@pytest.mark.parametrize("pipeline", [False, True], ids=["sync", "pipelined"])
def test_microbench_records_device_compute(pipeline):
    """``tests/frontier/test_microbench.py`` on the port, in both loops, at
    8 paths on 3 branches (the JAX case: 64 on 6)."""
    from mythril_tpu_torch.analysis.security import fire_lasers, reset_callback_modules
    from mythril_tpu_torch.analysis.symbolic import SymExecWrapper
    from mythril_tpu_torch.frontier.stats import FrontierStatistics
    from mythril_tpu_torch.support.support_args import args
    from tests._torch_parity import _reset

    _reset("mythril_tpu_torch")
    saved = (args.frontier, args.frontier_force, args.frontier_width,
             args.frontier_microbench, args.pipeline)
    args.frontier, args.frontier_force, args.frontier_width = True, True, 8
    args.frontier_microbench, args.pipeline = True, pipeline
    reset_callback_modules()
    FrontierStatistics().reset()
    try:
        sym = SymExecWrapper(_wide_contract(3), address=0x0901D12E, strategy="bfs",
                             transaction_count=1, execution_timeout=120,
                             modules=["AccidentallyKillable"], device="cpu")
        issues = fire_lasers(sym, white_list=["AccidentallyKillable"])
        assert any(i.swc_id == "106" for i in issues)
        mb = FrontierStatistics().microbench
        assert mb, "microbench never recorded"
        assert 0 < mb["segment_compute_s"] and mb["instructions_per_s"] > 0
        assert mb["n_exec_per_segment"] > 0 and mb["bytes_pushed_per_segment"] > 0
        assert mb["width"] == 8 and mb["reps"] == 4
        assert FrontierStatistics().as_dict()["microbench"] == mb
    finally:
        (args.frontier, args.frontier_force, args.frontier_width,
         args.frontier_microbench, args.pipeline) = saved
        FrontierStatistics().reset()


# ---------------------------------------------------------------------------
# span parity with the JAX CLI
# ---------------------------------------------------------------------------


def load_runs() -> dict:
    return {r["name"]: r for r in json.loads(FIXTURE.read_text())["runs"]}


def event_counts(trace: dict) -> dict:
    """{"name|phase": count} of a Chrome trace's events."""
    c = collections.Counter(f"{e['name']}|{e['ph']}" for e in trace["traceEvents"])
    return dict(sorted(c.items()))


def integer_counters(metrics: dict) -> dict:
    """The integer metrics of one analysis: not the process-scoped ones
    (the device plane's, the compile cache's, the frontier's per-code
    verdicts), which count whatever ran before in the process."""
    return {k: v for k, v in sorted(metrics.items())
            if type(v) is int and not k.startswith(("device.", "compilecache."))
            and not k.endswith("_verdicts")}


def fresh_process_telemetry() -> None:
    """The registry, the device plane's attribution and the tracer as a
    fresh process has them: metrics an earlier run created (and the sweep
    only zeroed) gone, so the metric names are this run's."""
    from mythril_tpu_torch.observability import deviceplane, get_registry, get_tracer

    reg = get_registry()
    with reg._lock:
        reg._metrics.clear()
    deviceplane.reset_for_tests()
    get_tracer().reset()


def unmatched_flows(trace: dict) -> list:
    """Flow ids whose "s" has no "f" (or the other way round)."""
    ends = collections.defaultdict(set)
    for e in trace["traceEvents"]:
        if e["ph"] in ("s", "f"):
            ends[e["id"]].add(e["ph"])
    return sorted(i for i, phs in ends.items() if phs != {"s", "f"})


def run_port_traced(argv, tmp_path) -> tuple:
    """The port's CLI in process on the CPU with ``--trace-out`` and
    ``--metrics-out`` -> (exit code, stdout, trace, metrics)."""
    from tests.test_torch_cli import run_port

    trace, metrics = tmp_path / "trace.json", tmp_path / "metrics.json"
    fresh_process_telemetry()
    rc, out = run_port(argv + PORT_PINS + ["--trace-out", str(trace),
                                           "--metrics-out", str(metrics)])
    return rc, out, json.loads(trace.read_text()), json.loads(metrics.read_text())


@pytest.fixture
def mythril_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("MYTHRIL_DIR", str(tmp_path / "mythril"))


@pytest.mark.parametrize("name", [n for n, _argv in RUNS])
def test_span_counts_and_metrics_equal_the_jax_cli(name, tmp_path, mythril_dir):
    run = load_runs()[name]
    rc, out, trace, metrics = run_port_traced(run["argv"], tmp_path)
    assert rc == run["rc"] == 0
    assert event_counts(trace) == run["events"]
    assert unmatched_flows(trace) == []
    assert os.path.isfile(tmp_path / "trace.json.jsonl")
    got = metrics["metrics"]
    assert set(run["metrics"]) - set(got) == JAX_ONLY_METRICS & set(run["metrics"])
    assert set(got) - set(run["metrics"]) == PORT_ONLY_METRICS
    ints = integer_counters(got)
    assert {k: v for k, v in ints.items() if k in run["integers"]} == run["integers"]
    assert metrics["trace"]["spans"] == sum(v for k, v in run["events"].items()
                                            if not k.endswith("|M"))
    report = json.loads(out.splitlines()[-1])[0]
    assert [i["swcID"] for i in report["issues"]] == run["swc_ids"]
    assert set(report["meta"]) == set(run["report_meta"]) - JAX_ONLY_REPORT_META
    assert (set(report["meta"]["device"])
            == set(run["device_meta"]) - JAX_ONLY_DEVICE_META | PORT_ONLY_DEVICE_META)
    assert report["meta"]["device"]["segment_device_s"]["count"] == ints["frontier.segments"]
    assert report["meta"]["observability"]["trace"]["enabled"] is True


def test_tracer_off_leaves_the_run_unchanged(tmp_path, mythril_dir):
    """The same command line without the two options: no span recorded, the
    same issues and integer counters as the traced run."""
    from mythril_tpu_torch.observability import get_registry, get_tracer
    from tests.test_torch_cli import run_port

    name, argv = RUNS[1]
    run = load_runs()[name]
    fresh_process_telemetry()
    rc, out = run_port(argv + PORT_PINS)
    assert rc == 0 and len(get_tracer()) == 0 and not get_tracer().enabled
    report = json.loads(out.splitlines()[-1])[0]
    assert [i["swcID"] for i in report["issues"]] == run["swc_ids"]
    ints = integer_counters(get_registry().snapshot())
    assert {k: v for k, v in ints.items() if k in run["integers"]} == run["integers"]
    assert "trace" not in report["meta"]["observability"]


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


def test_cli_writes_trace_metrics_and_benchmark(tmp_path, mythril_dir):
    from tests.test_torch_cli import run_port

    files = {k: tmp_path / f"{k}.json" for k in ("trace", "metrics", "bench")}
    rc, _out = run_port(["analyze", "-c", KILL_SIMPLE, "--bin-runtime", "-t", "1",
                         "-o", "json", "--trace-out", str(files["trace"]),
                         "--metrics-out", str(files["metrics"]),
                         "--benchmark", str(files["bench"])])
    assert rc == 0
    trace = json.loads(files["trace"].read_text())
    assert any(e["name"] == "analysis.sym_exec" for e in trace["traceEvents"])
    assert "solver.query_count" in json.loads(files["metrics"].read_text())["metrics"]
    bench = json.loads(files["bench"].read_text())
    assert bench["executed_instructions"] > 0
    assert (tmp_path / "bench.json.svg").read_text().startswith("<svg")


def _refused_argv():
    from mythril_tpu_torch.interfaces import cli

    clean = ["analyze", "-c", "0x60006000f3", "--bin-runtime", "-t", "1", "-o", "json"]
    for opt in sorted(cli.NOT_YET_PORTED):
        if not opt.startswith("-"):
            yield pytest.param([opt], id=opt)
        else:
            yield pytest.param(clean + [opt, "x"], id=opt)


@pytest.mark.parametrize("argv", list(_refused_argv()))
def test_the_rest_is_still_refused(argv, capsys):
    from mythril_tpu_torch.interfaces import cli

    assert not {"--trace-out", "--metrics-out", "--benchmark"} & set(cli.NOT_YET_PORTED)
    assert cli.main(argv + ["--device", "cpu"]) == 2
    assert "ROADMAP Queue A item 13)" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# recording the JAX CLI
# ---------------------------------------------------------------------------


def _record(name: str, argv: list) -> dict:
    """One run of the JAX CLI in a fresh process with a fresh HOME."""
    import tempfile

    home = tempfile.mkdtemp(prefix="jax-trace-home-")
    trace, metrics = os.path.join(home, "trace.json"), os.path.join(home, "metrics.json")
    env = {**os.environ, "HOME": home, "MYTHRIL_DIR": os.path.join(home, ".mythril_tpu"),
           "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(REPO)}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "mythril_tpu", *argv, *JAX_PINS,
                           "--trace-out", trace, "--metrics-out", metrics],
                          capture_output=True, text=True, env=env, cwd=home)
    seconds = time.perf_counter() - t0
    report = json.loads(proc.stdout.splitlines()[-1])[0]
    with open(trace) as f:
        tr = json.load(f)
    with open(metrics) as f:
        met = json.load(f)["metrics"]
    return {"name": name, "argv": argv, "pins": JAX_PINS, "rc": proc.returncode,
            "stdout": proc.stdout, "swc_ids": [i["swcID"] for i in report["issues"]],
            "events": event_counts(tr), "metrics": sorted(met),
            "integers": integer_counters(met), "report_meta": sorted(report["meta"]),
            "device_meta": sorted(report["meta"]["device"]), "jax_cpu_seconds": seconds}


def write_fixture() -> None:
    runs = []
    for name, argv in RUNS:
        rec = _record(name, argv)
        print(f"{name}: rc {rec['rc']}, {sum(rec['events'].values())} events, "
              f"{rec['jax_cpu_seconds']:.1f} s", flush=True)
        runs.append(rec)
    FIXTURE.write_text(json.dumps({"runs": runs}, indent=1) + "\n")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--write"]:
        write_fixture()
    else:
        print(__doc__)
