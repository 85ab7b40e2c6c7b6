"""The port's worker pool and fleet fabric against the JAX package's: N
spawned worker processes behind one admission plane.

The JAX package's ``tests/service/test_pool.py`` and
``test_fleet_integration.py`` cases run on the port (``port_cases``, every
``ServiceConfig`` on ``device="cpu"``).  The port's own pooled cases (the
recorded runs, device faults) are in ``tests/test_torch_service_faults.py``,
so that no one test worker holds every pool.

The spawned workers inherit one intra-op thread (``OMP_NUM_THREADS``,
``MKL_NUM_THREADS``): the tests' one-thread fixture does not reach them.
"""

from __future__ import annotations

from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
from tests._torch_parity import _one_torch_thread  # noqa: E402,F401  (autouse fixture)
from tests.test_torch_observability import port_cases  # noqa: E402
from tests.test_torch_service import ON_CPU, adopt  # noqa: E402

_SVC = REPO / "tests" / "service"


@pytest.fixture(autouse=True)
def _one_thread_workers(monkeypatch):
    """Before any pool starts: its spawned workers run one intra-op thread,
    as the fixture gives this process."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("MKL_NUM_THREADS", "1")


adopt(globals(), port_cases(_SVC / "conftest.py", "port_service_conftest"), "conftest")
_pool = port_cases(_SVC / "test_pool.py", "port_test_pool", subs=ON_CPU)
adopt(globals(), _pool, "pool")
adopt(globals(), port_cases(
    _SVC / "test_fleet_integration.py", "port_test_fleet_integration",
    subs=ON_CPU + [(r"from \.test_pool import CLEAN_HEX, KILL_SIMPLE_HEX", "pass")],
    extra={"CLEAN_HEX": _pool.CLEAN_HEX, "KILL_SIMPLE_HEX": _pool.KILL_SIMPLE_HEX}),
    "fleet_integration")
