"""The port's own pooled service cases: the recorded runs through a pool,
the spawned workers' import boundary, and device faults in a worker.

* The recorded JAX service runs of ``tests/testdata/torch_service_runs.json``
  through a pool of two workers: each request's answer equals the JAX
  record (which ``tests/test_torch_service.py`` holds equal to the port's
  solo ``analyze`` runs), the fleet rollup carries the workers' segment
  dispatches and their device plane's times, and the spawned workers load
  neither ``jax`` nor a module of the JAX package.
* A ``torch.AcceleratorError`` or ``torch.OutOfMemoryError`` in a worker,
  at its frontier, its probe or a job's host continuation, errors that
  batch's requests naming the fault and ends the worker, which the pool
  respawns; the next submission succeeds and the service goes on.

The pools spawn ``tests/_torch_service_workers.py``'s worker, which sets up
what these cases ask of the child (a test's monkeypatch does not reach a
spawned process), and inherit one intra-op thread (``OMP_NUM_THREADS``,
``MKL_NUM_THREADS``).
"""

from __future__ import annotations

import json
import re
import time

import pytest

from tests._torch_parity import _one_torch_thread  # noqa: F401  (autouse fixture)
from tests.test_torch_service import (
    CLEAN,
    FAULTS,
    KILL,
    load_fixture,
    serve_recorded,
    service_config,
)
from tests.test_torch_service_pool import _one_thread_workers, scoped_args  # noqa: F401


@pytest.fixture
def test_workers(monkeypatch):
    """The pool spawns ``tests/_torch_service_workers.py``'s worker."""
    from mythril_tpu_torch.service import pool
    from tests import _torch_service_workers

    monkeypatch.setattr(pool, "worker_main", _torch_service_workers.worker_main)


def _wait(predicate, timeout=60.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(0.1)
    return False


def test_pooled_service_equals_the_jax_record(scoped_args, test_workers, monkeypatch, tmp_path):
    from mythril_tpu_torch.service import AnalysisService

    monkeypatch.setenv("MYTHRIL_TORCH_TEST_FORCE", "1")
    monkeypatch.setenv("MYTHRIL_TORCH_TEST_MODULES", str(tmp_path))
    service = AnalysisService(service_config("mythril_tpu_torch", device="cpu", workers=2,
                                             cache_root=str(tmp_path / "cache"))).start()
    try:
        assert service.wait_warm(timeout=300)
        runs = serve_recorded("mythril_tpu_torch", service)
        stats = service.stats()
        metrics = service.fleet_prometheus_text()
    finally:
        assert service.stop(drain=True, timeout=300)
    assert runs == load_fixture()["runs"]
    assert stats["scope"] == "fleet" and len({w["pid"] for w in stats["workers"]}) == 2
    # the fleet's rollup carries the workers' frontier dispatches and their
    # device plane's segment times
    roll = stats["fleet"]["rollup"]
    assert roll["counters"].get("frontier.segments", 0) > 0, roll["counters"]
    count = [line for line in metrics.splitlines()
             if line.startswith("fleet_frontier_segment_device_s_count ")]
    assert count and float(count[0].split()[1]) > 0, metrics
    # the spawned workers ran with jax blocked and loaded nothing of the JAX package
    loaded = [json.loads(p.read_text()) for p in tmp_path.glob("*.json")]
    assert len(loaded) == 2
    for modules in loaded:
        assert "mythril_tpu_torch.service.worker" in modules
        assert not [m for m in modules if re.match(r"(jax|jaxlib|mythril_tpu)(\.|$)", m)]


@pytest.mark.parametrize("fault, site", [
    (FAULTS[0], "frontier"), (FAULTS[1], "frontier"), (FAULTS[1], "probe"), (FAULTS[0], "host"),
])
def test_a_device_fault_ends_the_pool_worker(fault, site, scoped_args, test_workers,
                                             monkeypatch, tmp_path):
    """The batch's requests error naming the fault, the worker exits, the
    pool respawns it (``service.worker_restarts``), and the next request is
    answered; the service itself goes on.  Each torch error at the
    frontier, and one at the probe and one at a job's host continuation."""
    from mythril_tpu_torch.observability import get_registry
    from mythril_tpu_torch.service import AnalysisOptions, AnalysisService, ServiceConfig

    once = tmp_path / "fault-once"
    once.write_text("")
    monkeypatch.setenv("MYTHRIL_TORCH_TEST_FAULT", f"{fault}:{site}:{once}")
    restarts = get_registry().counter("service.worker_restarts", persistent=True)
    before = restarts.snapshot() or 0
    service = AnalysisService(ServiceConfig(
        device="cpu", default_options=AnalysisOptions(transaction_count=1, execution_timeout=30),
        max_batch_width=2, batch_window_s=0.3, frontier=True, probe=True, warmup=False,
        workers=2)).start()
    try:
        assert service.wait_warm(timeout=300)
        pids = {w["pid"] for w in service.stats()["workers"]}
        subs = [service.submit(CLEAN.hex(), name="clean"),
                service.submit(KILL.hex(), name="kill",
                               tier="interactive" if site == "probe" else "batch")]
        for _r, stream, _d in subs:
            kind, payload = list(stream.events(timeout=120))[-1]
            assert kind == "error" and f"device fault: {fault}('injected')" in payload
        assert _wait(lambda: (restarts.snapshot() or 0) - before >= 1)
        assert _wait(lambda: all(w["state"] == "idle" for w in service.stats()["workers"]))
        assert {w["pid"] for w in service.stats()["workers"]} != pids
        _r, again, _ = service.submit(KILL.hex(), name="again")
        assert [i["swc_id"] for i in again.result(timeout=120)["issues"]] == ["106"]
        assert service.fault is None
    finally:
        assert service.stop(drain=True, timeout=60)
