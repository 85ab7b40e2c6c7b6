"""The port's health surfaces against the JAX package's: the heartbeat, the
flight recorder, the metrics history, the watchtower and drift.

* The JAX package's ``tests/observability/test_heartbeat.py``,
  ``test_flightrecorder.py``, ``test_history.py``, ``test_drift.py`` and
  ``test_watchtower.py`` cases run on the port's copies (``port_cases``).
* ``history`` and ``drift``: the port's CLI prints what the JAX CLI prints,
  byte for byte, on two of the repository's ``BENCH_r*.json`` files and on
  a history ring.
* ``meta.health``: ``health_meta()`` and the report's block equal the JAX
  package's, with and without a watchtower.
* The runner's heartbeat: a pipelined run on the CPU samples the JAX
  package's queue-depth keys while it runs; the sampler starts with the run
  and stops after it; every retired segment beats the flight recorder's
  watchdog, in both loops; SIGUSR1 mid-run and an unhandled exception write
  a bundle that holds the device plane's block.
* Every option and subcommand this slice took out of the CLI's refusals
  runs.
"""

from __future__ import annotations

import contextlib
import inspect
import io
import json
import os
import re
import signal
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
from tests._torch_parity import _one_torch_thread  # noqa: E402,F401  (autouse fixture)
from tests.test_torch_cli import CLEAN, KILL_SIMPLE, run_port  # noqa: E402
from tests.test_torch_observability import port_cases  # noqa: E402

_OBS = REPO / "tests" / "observability"
JAX_CASES = ("heartbeat", "flightrecorder", "history", "drift", "watchtower")


def _adopt(mod, prefix: str) -> None:
    """The module's ``test_*`` functions, here as ``test_port_<prefix>_*``,
    and its fixtures."""
    for key, value in vars(mod).items():
        if key.startswith("test_"):
            globals()[f"test_port_{prefix}_{key[5:]}"] = value
        elif hasattr(value, "_fixture_function_marker"):
            globals()[key] = value


for _case in JAX_CASES:
    _adopt(port_cases(_OBS / f"test_{_case}.py", f"port_test_{_case}"), _case)


@pytest.fixture(autouse=True)
def _mythril_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("MYTHRIL_DIR", str(tmp_path / "mythril"))


def run_jax_cli(argv) -> str:
    """The JAX CLI's stdout for ``argv`` (a subcommand that runs no
    analysis), in process."""
    from mythril_tpu.interfaces import cli as jax_cli

    saved, out = sys.argv, io.StringIO()
    sys.argv = ["myth", *argv]
    try:
        with contextlib.redirect_stdout(out):
            jax_cli.main()
    finally:
        sys.argv = saved
    return out.getvalue()


def run_port_cli(argv) -> str:
    from mythril_tpu_torch.interfaces import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(argv) == 0
    return out.getvalue()


# ---------------------------------------------------------------------------
# history and drift, byte for byte
# ---------------------------------------------------------------------------

BENCH_PAIRS = (("BENCH_r13.json", "BENCH_r15.json"), ("BENCH_r03.json", "BENCH_r20.json"))


@pytest.mark.parametrize("pair", BENCH_PAIRS, ids=lambda p: "-".join(x[6:9] for x in p))
@pytest.mark.parametrize("form", [["-o", "json"], ["-o", "text"], ["--limit", "5"]],
                         ids=["json", "text", "limit"])
def test_drift_equals_the_jax_cli(pair, form):
    argv = ["drift", *(str(REPO / p) for p in pair), *form]
    assert run_port_cli(argv) == run_jax_cli(argv)


def _history_ring(path: Path) -> None:
    """A history ring of eight records from a registry of its own: a
    counter, a gauge, a labeled counter and a histogram."""
    from mythril_tpu_torch.observability.history import MetricsHistory
    from mythril_tpu_torch.observability.metrics import MetricsRegistry

    reg = MetricsRegistry()
    hist = MetricsHistory(str(path), registry=reg)
    lat = reg.histogram("service.lat_s", buckets=(0.1, 1.0, 10.0))
    for i in range(8):
        reg.counter("frontier.segments").inc(3 + i)
        reg.gauge("pipeline.pool_queue_depth").set(i % 3)
        reg.labeled_counter("device.cache_hits_by_bucket", label_name="bucket").inc("4x8")
        lat.observe(0.05 * (i + 1))
        hist.record(t=1000.0 + 60.0 * i)
    hist.close()


@pytest.mark.parametrize("argv", [
    ["history", "query"],
    ["history", "query", "--metric", "frontier.segments", "--metric", "service.lat_s"],
    ["history", "segments"],
    ["drift", "--history", "{dir}", "--window", "120", "-o", "json"],
    ["drift", "--history", "{dir}", "--window", "120"],
], ids=["query", "query-metrics", "segments", "drift-history-json", "drift-history-text"])
def test_history_equals_the_jax_cli(argv, tmp_path):
    ring = tmp_path / "history"
    _history_ring(ring)
    argv = [str(ring) if a == "{dir}" else a for a in argv]
    if argv[0] == "history":
        argv += ["--dir", str(ring)]
    port = run_port_cli(argv)
    assert port and port == run_jax_cli(argv)


def test_history_reads_the_cache_root(tmp_path):
    _history_ring(tmp_path / "history")
    assert run_port_cli(["history", "query", "--cache-root", str(tmp_path)]).count("\n") == 8


# ---------------------------------------------------------------------------
# meta.health
# ---------------------------------------------------------------------------


def _health(base: str, tmp_path) -> list:
    """``health_meta()`` without a watchtower, then with one whose liveness
    objective breaches on a scripted source, after two ticks."""
    obs = __import__(f"{base}.observability.watchtower", fromlist=["x"])
    out = [obs.health_meta()]
    values = {"service.workers": 2}
    wt = obs.Watchtower(str(tmp_path / base), interval_s=1.0,
                        objectives=[obs.Objective("liveness", "gauge", "service.workers",
                                                  target=1.0, op=">=", min_count=0)],
                        source=lambda: (dict(values), {}))
    obs.set_watchtower(wt)
    try:
        wt.tick(now=100.0)
        out.append(obs.health_meta())
        values["service.workers"] = 0
        wt.tick(now=101.0)
        out.append(obs.health_meta())
    finally:
        obs.set_watchtower(None)
        wt.stop()
    return out


def test_health_meta_equals_the_jax_package(tmp_path):
    from mythril_tpu_torch.analysis.report import Report

    port = _health("mythril_tpu_torch", tmp_path)
    assert port == _health("mythril_tpu", tmp_path)
    assert port[0] == {"enabled": False} and port[2]["breaching"] == ["liveness"]
    assert json.loads(Report().as_swc_standard_format())[0]["meta"]["health"] == port[0]


# ---------------------------------------------------------------------------
# the runner's heartbeat and the flight recorder on a pipelined run
# ---------------------------------------------------------------------------

PIPELINED = ["analyze", "-c", KILL_SIMPLE.read_text().strip(), "--bin-runtime", "-t", "2",
             "-o", "jsonv2", "--frontier", "--frontier-force"]


def _jax_sample_keys() -> set:
    """The metric names the JAX runner's ``_heartbeat_sample`` returns."""
    from mythril_tpu.frontier.pipeline import PipelinedRunner

    return set(re.findall(r'"((?:pipeline|frontier)\.[a-z_]+)"',
                          inspect.getsource(PipelinedRunner._heartbeat_sample)))


def test_the_card_check_knows_the_jax_sample_keys():
    """``chip_smoke.py`` phase 8k holds the card's samples to these keys."""
    import chip_smoke

    assert chip_smoke.HEARTBEAT_KEYS == _jax_sample_keys()


@pytest.fixture
def slow_harvest(monkeypatch):
    """Each harvest takes 50 ms longer, so a run outlasts several heartbeat
    periods; ``calls`` sees the heartbeat's state in each."""
    import time

    from mythril_tpu_torch.frontier import engine
    from mythril_tpu_torch.observability import get_heartbeat

    harvest, calls = engine.FrontierEngine._harvest, []

    def slow(self, *a, **k):
        calls.append(get_heartbeat().running)
        time.sleep(0.05)
        return harvest(self, *a, **k)

    monkeypatch.setattr(engine.FrontierEngine, "_harvest", slow)
    return calls


def test_a_pipelined_run_samples_the_jax_keys_while_it_runs(tmp_path, slow_harvest):
    out = tmp_path / "hb.jsonl"
    rc, _ = run_port(PIPELINED + ["--heartbeat-out", str(out), "--heartbeat-interval", "0.005"])
    assert rc == 0 and slow_harvest
    lines = [json.loads(line) for line in out.read_text().splitlines()]
    during = [s for s in lines if "pipeline.pool_queue_depth" in s]
    # the last sample is the CLI's, after the runner unregistered its source
    assert len(during) >= 2 and "pipeline.pool_queue_depth" not in lines[-1]
    keys = _jax_sample_keys()
    assert keys and all(keys <= set(s) for s in during)
    assert all(s["pipeline.free_slots_by_shard"].keys() == {"shard0"} for s in during)
    assert "heartbeat.device_compile_s" in lines[-1]  # the device plane's source


def test_the_runner_starts_and_stops_the_heartbeat(slow_harvest):
    from mythril_tpu_torch.observability import get_heartbeat

    assert not get_heartbeat().running
    rc, _ = run_port(PIPELINED)
    assert rc == 0 and slow_harvest and all(slow_harvest)
    assert not get_heartbeat().running


@pytest.mark.parametrize("pipeline", [True, False], ids=["pipelined", "synchronous"])
def test_every_retired_segment_beats_the_watchdog(pipeline, monkeypatch):
    from mythril_tpu_torch.frontier.stats import FrontierStatistics
    from mythril_tpu_torch.observability import flightrecorder

    beats, windows = [], []
    recorder = flightrecorder.FlightRecorder("unused")
    monkeypatch.setattr(flightrecorder, "_recorder", recorder)
    monkeypatch.setattr(recorder, "beat", lambda: beats.append(recorder._active))
    activity = recorder.activity
    monkeypatch.setattr(recorder, "activity", lambda: (windows.append(1), activity())[1])
    rc, _ = run_port(PIPELINED + ([] if pipeline else ["--no-pipeline"]))
    assert rc == 0
    assert len(beats) == FrontierStatistics().segments > 0
    assert windows and all(active >= 1 for active in beats[1:])
    assert recorder._active == 0


def test_sigusr1_mid_run_writes_a_bundle_with_the_device_plane(tmp_path, monkeypatch):
    from mythril_tpu_torch.frontier import engine
    from mythril_tpu_torch.observability import get_flight_recorder

    harvest, sent = engine.FrontierEngine._harvest, []

    def signalling(self, *a, **k):
        if not sent:
            sent.append(get_flight_recorder())
            os.kill(os.getpid(), signal.SIGUSR1)
        return harvest(self, *a, **k)

    monkeypatch.setattr(engine.FrontierEngine, "_harvest", signalling)
    before = signal.getsignal(signal.SIGUSR1)
    rc, _ = run_port(PIPELINED + ["--flight-recorder", str(tmp_path / "fr"),
                                  "--heartbeat-out", str(tmp_path / "hb.jsonl")])
    assert rc == 0 and sent[0] is not None
    assert get_flight_recorder() is None and signal.getsignal(signal.SIGUSR1) == before
    [path] = (tmp_path / "fr").glob("flight-sigusr1-*.json")
    bundle = json.loads(path.read_text())
    assert bundle["device"]["backend"] == "cpu" and bundle["device"]["enabled"] is True
    assert "heartbeat_tail" in bundle and bundle["spans_tail"]
    assert "metrics" in bundle["observability"]


def test_an_unhandled_exception_writes_a_bundle_and_disarms(tmp_path, monkeypatch):
    from mythril_tpu_torch.facade import mythril_analyzer
    from mythril_tpu_torch.observability import get_flight_recorder

    def boom(*_a, **_k):
        raise RuntimeError("host bug")

    monkeypatch.setattr(mythril_analyzer.MythrilAnalyzer, "fire_lasers", boom)
    hook = sys.excepthook
    with pytest.raises(RuntimeError, match="host bug"):
        run_port(CLEAN + ["--flight-recorder", str(tmp_path)])
    assert get_flight_recorder() is None and sys.excepthook is hook
    [path] = tmp_path.glob("flight-exception-*.json")
    bundle = json.loads(path.read_text())
    assert "host bug" in bundle["exception"] and bundle["device"]["backend"] == "cpu"


# ---------------------------------------------------------------------------
# the options and subcommands that were refused
# ---------------------------------------------------------------------------


def _during_run(monkeypatch) -> dict:
    """What the analysis saw: the flags, the build cache's directory, the
    flight recorder and the tracer, read once the facade applied them."""
    from mythril_tpu_torch import observability as obs
    from mythril_tpu_torch.facade import warm
    from mythril_tpu_torch.ops import _build
    from mythril_tpu_torch.support.support_args import args

    seen, apply = {}, warm.apply_analyzer_args

    def recording(cmd_args):
        apply(cmd_args)
        seen.update(args=dict(vars(args)), build_dir=_build.build_dir(),
                    recorder=obs.get_flight_recorder(), tracing=obs.get_tracer().enabled,
                    heartbeat=obs.get_heartbeat().running, watchtower=obs.get_watchtower())

    monkeypatch.setattr(warm, "apply_analyzer_args", recording)
    return seen


def _write_checkpoint(path: Path) -> None:
    assert run_port(CLEAN + ["--checkpoint-file", str(path)])[0] == 0


PORTED = ("--checkpoint-file", "--resume-from", "--compile-cache-dir", "--cache-root",
          "--heartbeat-out", "--heartbeat-interval", "--flight-recorder",
          "--watchdog-deadline", "--history-dir", "history", "drift")


@pytest.mark.parametrize("what", PORTED)
def test_a_ported_option_or_subcommand_runs(what, tmp_path, monkeypatch):
    from mythril_tpu_torch import observability as obs
    from mythril_tpu_torch.interfaces import cli
    from mythril_tpu_torch.ops import _build

    assert what not in cli.NOT_YET_PORTED
    if what == "history":
        _history_ring(tmp_path / "h")
        assert run_port_cli(["history", "segments", "--dir", str(tmp_path / "h")])
        return
    if what == "drift":
        out = run_port_cli(["drift", *(str(REPO / p) for p in BENCH_PAIRS[0])])
        assert out.startswith("drift report") and "drift: most-moved" in out
        return
    seen = _during_run(monkeypatch)
    target = tmp_path / "x"
    extra = {"--resume-from": [what, str(target)],
             "--heartbeat-interval": [what, "2"],
             "--watchdog-deadline": [what, "5", "--flight-recorder", str(target)]}
    if what == "--resume-from":
        _write_checkpoint(target)
    rc, out = run_port(CLEAN + extra.get(what, [what, str(target)]))
    assert rc == 0 and json.loads(out)["success"] is True
    flags = seen["args"]
    if what == "--checkpoint-file":
        assert json.loads(target.read_text())["completed_transactions"] == 1
    elif what == "--resume-from":
        assert flags["resume_from"] == str(target)
    elif what == "--compile-cache-dir":
        assert seen["build_dir"] == target
    elif what == "--cache-root":
        assert seen["build_dir"] == target / "kernels"
        assert flags["query_cache_dir"] == str(target / "querycache")
    elif what == "--heartbeat-out":
        assert seen["heartbeat"] and target.read_text().count("\n") >= 1
    elif what == "--heartbeat-interval":
        assert flags["heartbeat_interval"] == 2.0
    elif what == "--flight-recorder":
        assert seen["recorder"].out_dir == str(target) and seen["tracing"]
    elif what == "--watchdog-deadline":
        assert seen["recorder"].watchdog_deadline_s == 5.0
    elif what == "--history-dir":
        assert seen["watchtower"] is not None and list(target.glob("*.jsonl"))
    # all of it as it was once the command line returned
    assert _build.build_dir() == _build.BUILD_DIR
    assert obs.get_flight_recorder() is None and obs.get_watchtower() is None
    assert not obs.get_heartbeat().running and not obs.get_tracer().enabled


def test_no_module_of_the_port_imports_yaml(tmp_path):
    """With PyYAML blocked (the card's machine has none), every module of
    the port imports, and ``load_slo_file`` reads a JSON SLO file."""
    import subprocess

    slo = tmp_path / "slo.json"
    slo.write_text(json.dumps({"objectives": [
        {"name": "liveness", "kind": "gauge", "metric": "service.workers", "target": 1,
         "op": ">="}]}))
    child = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['yaml'] = None\n"
        "import mythril_tpu_torch\n"
        "for m in pkgutil.walk_packages(mythril_tpu_torch.__path__, 'mythril_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from mythril_tpu_torch.observability import load_slo_file\n"
        f"objectives, _ = load_slo_file({str(slo)!r})\n"
        "print(objectives[0].name)\n")
    proc = subprocess.run([sys.executable, "-c", child], capture_output=True, text=True,
                          timeout=300, cwd=str(REPO), env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split() == ["liveness"]
