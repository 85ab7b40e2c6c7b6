"""The port's analysis service against the JAX package's: the in-process
service, its admission plane, streaming and telemetry, and the fleet
fabric's wire format.

* The JAX package's ``tests/service/`` cases of ``test_codehash.py``,
  ``test_admission.py``, ``test_scheduling.py``, ``test_streaming.py``,
  ``test_service_core.py`` and ``test_telemetry.py``, and
  ``tests/observability/test_fleet.py``, run on the port (``port_cases``):
  every ``ServiceConfig`` gets ``device="cpu"``, and the kernel build cache
  under ``--cache-root`` is ``DIR/kernels`` (the JAX package's ``DIR/xla``).
  The ``scoped_args`` fixture of ``tests/service/conftest.py`` is the port's
  (its args, query cache and analysis scope).  ``test_serve_integration.py``
  runs here too and keeps its ``slow`` mark.  The pooled cases are in
  ``tests/test_torch_service_pool.py``, the watchtower's and the command
  line's in ``tests/test_torch_service_cli.py``.
* Recorded JAX service runs: ``tests/testdata/torch_service_runs.json``
  holds what the JAX ``AnalysisService`` (inline, frontier on and forced,
  the interactive probe on) answered to ``etherstore_like``,
  ``rubixi_like`` and ``kill_simple`` from two tenants plus a duplicate of
  ``etherstore_like``: each request's terminal event, dedup flag, final
  issue digests and streamed digests.  The port's inline service on the
  CPU must answer the same, and each digest set must equal the port's
  solo ``analyze`` of the contract.
* Device faults: a ``torch.AcceleratorError`` or ``torch.OutOfMemoryError``
  at the frontier, the probe or one job's host continuation errors every
  request of its batch, naming the fault, and stops the inline service;
  a plain ``RuntimeError`` in one job still errors only that job.
* ``run_cooperative_batch``'s own contract, the issue sink, and the
  ``profile`` verb's ``torch.profiler`` window.

    JAX_PLATFORMS=cpu python tests/test_torch_service.py --write

records the fixture (the JAX service in a process of its own with a fresh
HOME; a few minutes).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import types
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:  # run as a script (--write)
    sys.path.insert(0, str(REPO))
from tests._torch_parity import _one_torch_thread  # noqa: E402,F401  (autouse fixture)
from tests.test_torch_observability import port_cases  # noqa: E402

FIXTURE = REPO / "tests" / "testdata" / "torch_service_runs.json"
_SVC = REPO / "tests" / "service"
_OBS = REPO / "tests" / "observability"
# every ServiceConfig of a ported case runs on the CPU
ON_CPU = [(r"\bServiceConfig\(", 'ServiceConfig(device="cpu", ')]


def adopt(namespace: dict, mod: types.ModuleType, prefix: str, mark=None) -> None:
    """The module's ``test_*`` functions and ``Test*`` classes, in
    ``namespace`` as ``test_port_<prefix>_*`` and ``TestPort<Prefix>*``
    (with ``mark`` applied), and its fixtures."""
    for key, value in vars(mod).items():
        if key.startswith("test_") and callable(value):
            namespace[f"test_port_{prefix}_{key[5:]}"] = mark(value) if mark else value
        elif key.startswith("Test") and isinstance(value, type):
            camel = "".join(p.title() for p in prefix.split("_"))
            namespace[f"TestPort{camel}{key[4:]}"] = mark(value) if mark else value
        elif hasattr(value, "_fixture_function_marker"):
            namespace[key] = value


# ---------------------------------------------------------------------------
# the JAX package's cases on the port
# ---------------------------------------------------------------------------

adopt(globals(), port_cases(_SVC / "conftest.py", "port_service_conftest"), "conftest")
for _case in ("codehash", "admission", "streaming"):
    adopt(globals(), port_cases(_SVC / f"test_{_case}.py", f"port_test_{_case}"), _case)
_core = port_cases(_SVC / "test_service_core.py", "port_test_service_core",
                   subs=ON_CPU + [(r'root / "xla"', 'root / "kernels"')])
adopt(globals(), _core, "service_core")
adopt(globals(), port_cases(
    _SVC / "test_scheduling.py", "port_test_scheduling",
    subs=ON_CPU + [(r"from tests\.service\.test_service_core import _config",
                    "_config = _core_config")],
    extra={"_core_config": _core._config}), "scheduling")
adopt(globals(), port_cases(_SVC / "test_telemetry.py", "port_test_telemetry", subs=ON_CPU),
      "telemetry")
adopt(globals(), port_cases(_OBS / "test_fleet.py", "port_test_fleet"), "fleet")
adopt(globals(), port_cases(_SVC / "test_serve_integration.py", "port_test_serve_integration",
                            subs=ON_CPU + [(r"isolate_errors=False,\n",
                                            'isolate_errors=False, device="cpu",\n')]),
      "serve_integration", mark=pytest.mark.slow)


# ---------------------------------------------------------------------------
# recorded JAX service runs
# ---------------------------------------------------------------------------

# (contract, tenant, tier): two tenants, the interactive tier's probe on the
# first, and a duplicate of the first that must be deduplicated
SUBMISSIONS = (
    ("etherstore_like", "t1", "interactive"),
    ("rubixi_like", "t2", "batch"),
    ("kill_simple", "t1", "batch"),
    ("etherstore_like", "t2", "batch"),
)
TX, TIMEOUT = 2, 60


def contract_hex(name: str) -> str:
    if name == "kill_simple":
        return (REPO / "tests" / "testdata" / "inputs" / "kill_simple.bin-runtime").read_text().strip()
    import bench_contracts

    return getattr(bench_contracts, name)().hex()


def service_config(pkg: str, **extra):
    """The recorded service's configuration in ``pkg``: inline unless
    ``workers`` says otherwise, the frontier on, the probe on, no warmup."""
    import importlib

    svc = importlib.import_module(f"{pkg}.service")
    return svc.ServiceConfig(
        default_options=svc.AnalysisOptions(transaction_count=TX, execution_timeout=TIMEOUT),
        max_batch_width=8, batch_window_s=0.3, frontier=True, probe=True, warmup=False,
        **extra)


def serve_recorded(pkg: str, service) -> list:
    """Submit ``SUBMISSIONS`` to a started service of ``pkg`` and collect
    each request's record: terminal event, dedup flag, final and streamed
    issue digests (as lists, sorted)."""
    import importlib

    digest = importlib.import_module(f"{pkg}.service").issue_digest
    subs = [service.submit(contract_hex(name), name=name, tier=tier, tenant=tenant)
            for name, tenant, tier in SUBMISSIONS]
    runs = []
    for (name, tenant, tier), (_req, stream, deduped) in zip(SUBMISSIONS, subs):
        events = list(stream.events(timeout=900))
        kind, payload = events[-1]
        runs.append({
            "contract": name, "tenant": tenant, "tier": tier, "deduped": deduped,
            "terminal": kind,
            "digests": sorted(list(digest(i)) for i in payload["issues"])
            if kind == "done" else payload,
            "streamed": sorted(list(digest(p)) for k, p in events if k == "issue"),
        })
    return runs


def record_jax_runs() -> list:
    """The JAX service's answers (run in a process of its own)."""
    from mythril_tpu.service import AnalysisService
    from mythril_tpu.support.support_args import args

    service = AnalysisService(service_config("mythril_tpu")).start()
    args.frontier_force = True  # after the inline worker configured the flags
    try:
        return serve_recorded("mythril_tpu", service)
    finally:
        assert service.stop(drain=True, timeout=300)


def load_fixture() -> dict:
    return json.loads(FIXTURE.read_text())


def solo_digests(name: str) -> list:
    """The port's solo ``analyze`` of one contract on the CPU (the
    service's defaults: ``-t 2``, bfs, 60 s), as issue digests."""
    from mythril_tpu_torch.service import canonical_codehash
    from tests.test_torch_cli import run_port

    code = contract_hex(name)
    rc, out = run_port(["analyze", "-c", code, "--bin-runtime", "-t", str(TX),
                        "--execution-timeout", str(TIMEOUT), "-o", "json"])
    assert rc == 0, out
    codehash = canonical_codehash(code)
    return sorted([i["swc-id"], i["address"], codehash, i["title"], i["function"]]
                  for i in json.loads(out)["issues"])


@pytest.fixture(scope="module")
def solo():
    return {name: solo_digests(name) for name in dict.fromkeys(n for n, _t, _r in SUBMISSIONS)}


def check_recorded(runs: list, solo: dict) -> None:
    """``runs`` (the port's) equal the JAX record, and each digest set the
    port's solo run of its contract."""
    recorded = load_fixture()["runs"]
    assert runs == recorded
    for run in runs:
        assert run["terminal"] == "done" and run["digests"] == solo[run["contract"]], run["contract"]
    assert [r["deduped"] for r in runs] == [False, False, False, True]


def test_inline_service_equals_the_jax_record_and_solo_runs(scoped_args, solo):
    from mythril_tpu_torch.service import AnalysisService
    from mythril_tpu_torch.support.support_args import args

    service = AnalysisService(service_config("mythril_tpu_torch", device="cpu")).start()
    args.frontier_force = True  # the record's flags, once the inline worker configured them
    try:
        runs = serve_recorded("mythril_tpu_torch", service)
        stats = service.stats()
    finally:
        assert service.stop(drain=True, timeout=300)
    check_recorded(runs, solo)
    assert stats["workers"][0]["state"] == "inline" and stats["service.batches"] >= 1


def test_the_recording_has_the_submissions_and_issues():
    data = load_fixture()
    assert [(r["contract"], r["tenant"], r["tier"]) for r in data["runs"]] == \
        list(SUBMISSIONS)
    assert all(r["digests"] for r in data["runs"])  # every contract has findings
    assert data["runs"][0]["digests"] == data["runs"][3]["digests"]


# ---------------------------------------------------------------------------
# run_cooperative_batch and the issue sink
# ---------------------------------------------------------------------------

KILL = bytes.fromhex(contract_hex("kill_simple"))
CLEAN = bytes.fromhex("60006000f3")


def fail_nth_exec(monkeypatch, n: int, exc: BaseException) -> None:
    """``LaserEVM.exec`` raises ``exc`` at its ``n``-th call (1-based): in a
    cooperative round the lasers' host continuations run in job order."""
    from mythril_tpu_torch.core.svm import LaserEVM

    real, calls = LaserEVM.exec, []

    def exec_(self, *a, **kw):
        calls.append(self)
        if len(calls) == n:
            raise exc
        return real(self, *a, **kw)

    monkeypatch.setattr(LaserEVM, "exec", exec_)


def test_cooperative_batch_isolates_a_jobs_host_error(scoped_args, monkeypatch):
    """A plain exception in one job's host continuation costs that job
    only, as in the JAX package; the other job keeps its issues."""
    from mythril_tpu_torch.analysis.cooperative import run_cooperative_batch

    fail_nth_exec(monkeypatch, 2, RuntimeError("host bug"))
    issues, errors, _states = run_cooperative_batch(
        [("kill", KILL), ("clean", CLEAN)], transaction_count=1, device="cpu")
    assert set(errors) == {"clean"} and "host bug" in errors["clean"]
    assert [i.swc_id for i in issues["kill"]] == ["106"] and "clean" not in issues


def test_the_issue_sink_sees_each_confirmation(scoped_args):
    from mythril_tpu_torch.analysis.cooperative import run_cooperative_batch
    from mythril_tpu_torch.analysis.module import base
    from mythril_tpu_torch.facade.warm import reset_analysis_scope

    reset_analysis_scope()
    seen = []
    with base.issue_sink_scope(seen.extend):
        assert base._ISSUE_SINK is not None
        issues, errors, _ = run_cooperative_batch([("kill", KILL)], transaction_count=1,
                                                  device="cpu")
    assert base._ISSUE_SINK is None and not errors
    assert [i.swc_id for i in seen] == ["106"] == [i.swc_id for i in issues["kill"]]


@pytest.mark.parametrize("pipeline", [True, False], ids=["pipelined", "synchronous"])
def test_segment_spans_carry_the_batchs_requests(pipeline, scoped_args):
    """Traced, an inline batch on the forced frontier tags every
    ``frontier.segment`` span with its request ids, and each request's
    ``flow.request`` arrow has both endpoints (the "f" inside the first
    segment span), in both frontier loops."""
    from mythril_tpu_torch.observability import get_tracer
    from mythril_tpu_torch.service import AnalysisOptions, AnalysisService, ServiceConfig
    from mythril_tpu_torch.support.support_args import args

    tracer = get_tracer()
    tracer.reset()
    tracer.enabled = True
    service = AnalysisService(ServiceConfig(
        device="cpu", default_options=AnalysisOptions(transaction_count=1, execution_timeout=30),
        batch_window_s=0.3, probe=False, warmup=False)).start()
    args.frontier_force, args.pipeline = True, pipeline
    try:
        subs = [service.submit(KILL.hex(), name="kill"), service.submit(CLEAN.hex(), name="clean")]
        for _r, stream, _d in subs:
            assert stream.result(timeout=120)
        spans = tracer.spans()
    finally:
        tracer.enabled = False
        tracer.reset()
        assert service.stop(drain=True, timeout=60)
    rids = ",".join(r.request_id for r, _s, _d in subs)
    segments = [s for s in spans if s["name"] == "frontier.segment"]
    assert segments and all(s["args"].get("requests") == rids for s in segments)
    assert any(s["args"].get("pipelined") for s in segments) == pipeline
    flows = [s for s in spans if s["name"] == "flow.request"]
    assert sorted(s["ph"] for s in flows) == ["f", "f", "s", "s"]
    assert len({s["flow_id"] for s in flows}) == 2


# ---------------------------------------------------------------------------
# device faults reach the requests and stop the inline service
# ---------------------------------------------------------------------------

FAULTS = ("AcceleratorError", "OutOfMemoryError")


def make_fault(name: str) -> BaseException:
    import torch

    return getattr(torch, name)("injected")


def inject(site: str, exc: BaseException, monkeypatch) -> None:
    """Raise ``exc`` at ``site``: the frontier's shared drain, the
    interactive probe, or the first job's host continuation."""
    if site == "frontier":
        from mythril_tpu_torch.frontier import engine

        def drain_lasers(*_a, **_kw):
            raise exc

        monkeypatch.setattr(engine, "drain_lasers", drain_lasers)
    elif site == "probe":
        import contextlib

        from mythril_tpu_torch.facade.warm import WorkerContext

        @contextlib.contextmanager
        def probe_scope(_self):
            raise exc
            yield

        monkeypatch.setattr(WorkerContext, "probe_scope", probe_scope)
    else:
        fail_nth_exec(monkeypatch, 1, exc)


def inline_service():
    from mythril_tpu_torch.service import AnalysisOptions, AnalysisService, ServiceConfig

    return AnalysisService(ServiceConfig(
        device="cpu", default_options=AnalysisOptions(transaction_count=1, execution_timeout=30),
        max_batch_width=4, batch_window_s=0.3, frontier=True, probe=True, warmup=False)).start()


def submit_pair(service, site: str):
    """CLEAN then KILL, one batch; KILL is interactive (probed) at the
    probe site.  Returns each stream's events."""
    subs = [service.submit(CLEAN.hex(), name="clean", tenant="t1"),
            service.submit(KILL.hex(), name="kill", tenant="t2",
                           tier="interactive" if site == "probe" else "batch")]
    return [list(stream.events(timeout=300)) for _r, stream, _d in subs]


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("site", ["frontier", "probe", "host"])
def test_a_device_fault_errors_its_batch_and_stops_the_inline_service(site, fault, scoped_args,
                                                                      monkeypatch):
    """Every request of the batch errors naming the fault, the service
    takes no further batch and refuses submissions, and stops cleanly (the
    JAX package falls back to the host at the frontier, carries on after a
    probe's error, and isolates a job's)."""
    from mythril_tpu_torch.observability import get_registry

    batches = get_registry().counter("service.batches", persistent=True)
    before = batches.snapshot() or 0
    exc = make_fault(fault)
    inject(site, exc, monkeypatch)
    service = inline_service()
    try:
        answers = submit_pair(service, site)
        for events in answers:
            kind, payload = events[-1]
            assert kind == "error" and f"device fault: {fault}('injected')" in payload, events
        assert service.fault is exc
        with pytest.raises(RuntimeError, match="not accepting"):
            service.submit(KILL.hex(), name="late")
    finally:
        assert service.stop(drain=True, timeout=60)
    assert batches.snapshot() - before == 1


def test_a_fault_stops_the_loop_before_another_batch(scoped_args, monkeypatch):
    """Flights still pending when the fault struck error without reaching
    the engine, and the fault is the service's."""
    from mythril_tpu_torch.analysis import cooperative

    exc, calls = make_fault("OutOfMemoryError"), []

    def run_cooperative_batch(jobs, **kw):
        calls.append([name for name, _code in jobs])
        release.wait(30)
        raise exc

    release = threading.Event()
    monkeypatch.setattr(cooperative, "run_cooperative_batch", run_cooperative_batch)
    from mythril_tpu_torch.service import AnalysisOptions, AnalysisService, ServiceConfig

    service = AnalysisService(ServiceConfig(
        device="cpu", default_options=AnalysisOptions(transaction_count=1, execution_timeout=30),
        max_batch_width=1, batch_window_s=0.0, frontier=False, probe=False, warmup=False)).start()
    try:
        _r1, first, _ = service.submit(KILL.hex(), name="first")
        while not calls:
            threading.Event().wait(0.01)
        _r2, second, _ = service.submit(CLEAN.hex(), name="second")  # pending
        release.set()
        assert "device fault" in list(first.events(timeout=60))[-1][1]
        kind, payload = list(second.events(timeout=60))[-1]
        assert kind == "error" and "service stopped by a device fault" in payload
        assert len(calls) == 1 and service.fault is exc
    finally:
        release.set()
        assert service.stop(drain=True, timeout=60)


def test_a_plain_error_costs_only_its_job(scoped_args, monkeypatch):
    """A ``RuntimeError`` of host code in one job's continuation errors that
    request only; its batchmate completes and the service goes on."""
    inject("host", RuntimeError("host bug"), monkeypatch)
    service = inline_service()
    try:
        clean, kill = submit_pair(service, "host")
        assert clean[-1][0] == "error" and "host bug" in clean[-1][1]
        assert kill[-1][0] == "done" and [i["swc_id"] for i in kill[-1][1]["issues"]] == ["106"]
        _r, again, _ = service.submit(CLEAN.hex(), name="again")
        assert again.result(timeout=120)["issues"] == []
        assert service.fault is None
    finally:
        assert service.stop(drain=True, timeout=60)


# ---------------------------------------------------------------------------
# the profile verb
# ---------------------------------------------------------------------------


def test_profile_verb_writes_a_torch_profiler_trace(scoped_args, tmp_path):
    """The inline ``profile`` verb opens a ``torch.profiler`` window and
    returns the JAX package's result dict; the window's Chrome trace is in
    its directory, under ``--cache-root``."""
    from mythril_tpu_torch.service import AnalysisService, ServiceConfig

    service = AnalysisService(ServiceConfig(device="cpu", frontier=False, warmup=False,
                                            cache_root=str(tmp_path))).start()
    try:
        result = service.profile(worker_id=0, duration_s=0.1, tag="slo ttfe")
    finally:
        service.stop()
    assert set(result) == {"ok", "dir", "duration_s", "worker"} and result["ok"], result
    assert result["dir"] == str(tmp_path / "profiles" / "slo-ttfe-w0-1")
    trace = json.loads((Path(result["dir"]) / "trace.json").read_text())
    assert "traceEvents" in trace and result["worker"] == 0


def test_profile_window_failure_is_a_result():
    """A window that cannot open answers ``ok: False`` with the error, as
    the JAX package's does."""
    from mythril_tpu_torch.service.worker import _run_profile

    with tempfile.NamedTemporaryFile() as f:
        result = _run_profile(0.05, f.name, threading.Event())  # a file, not a directory
    assert result["ok"] is False and result["dir"] == f.name and "error" in result


# ---------------------------------------------------------------------------
# recording
# ---------------------------------------------------------------------------


def _write() -> None:
    """Record the JAX service's runs, in a process of its own with a fresh
    HOME (the JAX package's caches and signature database start empty)."""
    with tempfile.TemporaryDirectory() as home:
        env = dict(os.environ, HOME=home, JAX_PLATFORMS="cpu")
        code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
                "from tests.test_torch_service import record_jax_runs; "
                "print(json.dumps(record_jax_runs()))")
        out = subprocess.run([sys.executable, "-c", code, str(REPO)], env=env, cwd=home,
                             check=True, capture_output=True, text=True).stdout
    runs = json.loads(out.strip().splitlines()[-1])
    FIXTURE.write_text(json.dumps({
        "config": {"tx": TX, "execution_timeout": TIMEOUT, "frontier": True,
                   "frontier_force": True, "probe": True, "workers": 1},
        "runs": runs,
    }, indent=1) + "\n")
    print(f"wrote {FIXTURE}")


if __name__ == "__main__":
    if "--write" in sys.argv:
        _write()
