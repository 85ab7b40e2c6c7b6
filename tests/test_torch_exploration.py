"""The exploration ledger and the metrics registry
(``mythril_tpu_torch/observability/``) against the JAX package's.

The JAX ``tests/observability/test_exploration.py``,
``test_exploration_reachable.py`` and ``test_metrics.py`` cases run here on
the port (their source with the package renamed; the JAX package runs them
in their own files), but ``test_exploration_delta_measures_scope``, whose
``WorkerContext`` belongs to the analysis service (ROADMAP Queue A item
13).  Beside them, both packages' ledgers take the same seeded sequence of
``register_static``, ``record_device_planes`` on ``[3, I]`` planes,
``record_instr``, ``stamp``, ``record_solver_time`` and
``record_pc_overflow`` calls, and their ``meta()``, ``snapshot()``,
``bitmaps()`` and registry snapshots are equal, exactly.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from tests._torch_parity import _one_torch_thread  # noqa: E402,F401  (autouse fixture)
from tests.test_torch_adaptive import port_cases  # noqa: E402

# the service's per-worker accounting seam (facade/warm.py WorkerContext)
SERVICE_ONLY = {"test_exploration_delta_measures_scope"}

_OBS = REPO / "tests" / "observability"
_EXPLORATION = port_cases(_OBS / "test_exploration.py", "port_test_exploration")
_REACHABLE = port_cases(_OBS / "test_exploration_reachable.py", "port_test_exploration_reachable")
_METRICS = port_cases(_OBS / "test_metrics.py", "port_test_metrics")
reg = _METRICS.reg  # the JAX cases' fixture, on the port
for _mod, _prefix in ((_EXPLORATION, "ledger"), (_REACHABLE, "reachable"),
                      (_METRICS, "metrics")):
    for _name, _fn in vars(_mod).items():
        if _name.startswith("test_") and callable(_fn) and _name not in SERVICE_ONLY:
            globals()[f"test_port_{_prefix}_{_name[5:]}"] = _fn
del _mod, _prefix, _name, _fn


def ledger_script(rng: np.random.Generator, n_codes: int, steps: int = 80) -> list:
    """A seeded sequence of ledger calls over ``n_codes`` codes: static
    masks (some longer or shorter than the code), ``[3, I]`` device planes
    (some wider than the code), host instruction indices (some out of
    range), termination stamps, solver times (past the label cap) and pc
    overflows."""
    from mythril_tpu_torch.observability.exploration import TERM_CLASSES

    codes = [("%064x" % int(rng.integers(1 << 62)), int(rng.integers(3, 60)))
             for _ in range(n_codes)]
    script = []
    for h, n in codes:
        if rng.random() < 0.7:
            m = n + int(rng.integers(-2, 3))
            script.append(("static", h, rng.random(m) < 0.8, rng.random(m) < 0.5,
                           rng.random(m) < 0.5))
    for _ in range(steps):
        h, n = codes[int(rng.integers(len(codes)))]
        r = rng.random()
        if r < 0.3:
            width = n + int(rng.integers(0, 4))
            script.append(("planes", h, n, int(rng.integers(0, 6)),
                           rng.random((3, width)) < 0.3))
        elif r < 0.45:
            script.append(("instr", h, n, [int(i) for i in rng.integers(-2, n + 3, size=5)]))
        elif r < 0.7:
            script.append(("stamp", TERM_CLASSES[int(rng.integers(len(TERM_CLASSES)))],
                           int(rng.integers(1, 4))))
        elif r < 0.95:
            script.append(("solver", "%s:%#x" % (h[:10], int(rng.integers(400))),
                           float(rng.integers(0, 1000)) / 1000))
        else:
            script.append(("overflow", int(rng.integers(1, 3))))
    return script


def _ledger_trace(base: str, script: list) -> dict:
    import importlib

    metrics = importlib.import_module(f"{base}.observability.metrics")
    exploration = importlib.import_module(f"{base}.observability.exploration")
    reg = metrics.MetricsRegistry()
    led = exploration.ExplorationLedger(registry=reg)
    for op, *a in script:
        if op == "static":
            led.register_static(*a)
        elif op == "planes":
            led.record_device_planes(*a)
        elif op == "instr":
            led.record_instr(*a)
        elif op == "stamp":
            led.stamp(*a)
        elif op == "solver":
            led.record_solver_time(*a)
        else:
            led.record_pc_overflow(*a)
    bitmaps = {h: {k: (v.tolist() if isinstance(v, np.ndarray) else v) for k, v in bm.items()}
               for h, bm in led.bitmaps().items()}
    return {"meta": led.meta(), "snapshot": led.snapshot(), "bitmaps": bitmaps,
            "hotspots": led.solver_hotspots(top=1000), "registry": reg.snapshot(),
            "pct": [led.coverage_pct(), led.coverage_pct_reachable()]}


@pytest.mark.parametrize("n_codes", (1, 2, 4))
def test_ledger_equals_jax_on_seeded_calls(n_codes):
    script = ledger_script(np.random.default_rng(3700 + n_codes), n_codes)
    want, got = _ledger_trace("mythril_tpu", script), _ledger_trace("mythril_tpu_torch", script)
    assert got == want
    assert got["meta"]["partition_ok"] and got["meta"]["terminated_total"] > 0


def test_hotspot_labels_fold_into_other_past_the_cap():
    """Past 256 distinct points the ledger folds new labels into "other",
    in both packages alike."""
    script = [("solver", "%010x:%#x" % (7, pc), 0.001 * (pc % 5)) for pc in range(300)]
    want, got = _ledger_trace("mythril_tpu", script), _ledger_trace("mythril_tpu_torch", script)
    assert got == want
    assert any(h["point"] == "other" for h in got["hotspots"])
