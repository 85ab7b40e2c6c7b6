"""The ``auto`` probe backend's link calibration
(``mythril_tpu_torch/support/calibration.py``) and its two gates, the
solver's ``_device_worthwhile`` and the frontier engine's, against the JAX
package's (``mythril_tpu/support/calibration.py``).

The JAX ``tests/core/test_calibration.py`` cases run here on the port (their
source with the package renamed, and the pinned measurement taking the
port's device argument).  Both packages' ``calibrate`` at pinned round trips
must rescale the same constants to the same values; both solver gates must
take the same decision on numpy-seeded conjunctions and candidate counts at
each pinned threshold; both engine gates the same admission on seed sets of
seeded widths and JUMPI counts after calibrating at each pinned round trip.
On the CPU the port's ``auto`` never dispatches and never measures, as a JAX
run under ``JAX_PLATFORMS=cpu`` does.  Tolerance 0: every value is an
integer or a decision.
"""

from __future__ import annotations

import contextlib
import importlib
from pathlib import Path

import numpy as np
import pytest
import torch

from tests._torch_parity import _one_torch_thread  # noqa: E402,F401  (autouse fixture)
from tests.test_torch_adaptive import port_cases

REPO = Path(__file__).resolve().parent.parent
BASES = ("mythril_tpu", "mythril_tpu_torch")
# round trips (ms) pinned in both packages: none measured, a card's PCIe
# link, a local accelerator, the anchor, a slow tunnel
RTTS = (None, 0.02, 2.0, 100.0, 500.0)

_CASES = port_cases(REPO / "tests" / "core" / "test_calibration.py", "port_test_calibration",
                    subs=((r"lambda: rtt", "lambda device=None: rtt"),
                          (r"def fake\(\):", "def fake(device=None):")))
for _name, _case in vars(_CASES).items():
    if _name.startswith("test_"):
        globals()[f"test_port_{_name[5:]}"] = _case
del _name, _case


def _cal(base: str):
    return importlib.import_module(f"{base}.support.calibration")


@contextlib.contextmanager
def pinned(base: str, rtt, monkeypatch):
    """``base``'s calibration fresh, its measurement pinned to ``rtt``, and
    the constants it rescales restored on exit."""
    cal = _cal(base)
    args = importlib.import_module(f"{base}.support.support_args").args
    engine = importlib.import_module(f"{base}.frontier.engine")
    saved_state = dict(cal._state)
    saved = (args.device_probe_threshold, engine._MIN_STATIC_JUMPIS, engine._MIN_SEED_WIDTH)
    cal._state.clear()
    cal._state.update({"done": False, "rtt_ms": None, "applied": {}})
    monkeypatch.setattr(cal, "measure_dispatch_rtt_ms", lambda *device: rtt)
    try:
        yield cal
    finally:
        args.device_probe_threshold, engine._MIN_STATIC_JUMPIS, engine._MIN_SEED_WIDTH = saved
        cal._state.clear()
        cal._state.update(saved_state)


def _constants(base: str) -> tuple:
    args = importlib.import_module(f"{base}.support.support_args").args
    engine = importlib.import_module(f"{base}.frontier.engine")
    return args.device_probe_threshold, engine._MIN_STATIC_JUMPIS, engine._MIN_SEED_WIDTH


@pytest.mark.parametrize("rtt", RTTS)
def test_calibrate_rescales_as_the_jax_package(rtt, monkeypatch):
    got = {}
    for base in BASES:
        with pinned(base, rtt, monkeypatch) as cal:
            # the port's decision is taken for the card (a torch device
            # needs no card to exist)
            applied = cal.calibrate() if base == "mythril_tpu" else cal.calibrate("cuda")
            got[base] = (applied, cal.telemetry(), _constants(base), cal.calibrate(),
                         dict(cal._state))
    assert got["mythril_tpu"] == got["mythril_tpu_torch"]
    if rtt is not None and rtt < 1:
        # a card's round trip puts every constant at its clamp
        assert got["mythril_tpu_torch"][2] == (20_000, 2, 8)


def test_a_cpu_decision_measures_nothing(monkeypatch):
    """The port's counterpart of the JAX ``JAX_PLATFORMS`` check: a decision
    for the CPU measures nothing, leaves the memo untouched (the first
    decision for the card still measures) and reports nothing."""
    cal = _cal("mythril_tpu_torch")
    assert cal.measure_dispatch_rtt_ms("cpu") is None
    calls = []
    with pinned("mythril_tpu_torch", 0.02, monkeypatch):
        monkeypatch.setattr(cal, "measure_dispatch_rtt_ms",
                            lambda device: calls.append(device) or 0.02)
        before = _constants("mythril_tpu_torch")
        assert cal.calibrate("cpu") == {} and cal.telemetry() == {}
        assert cal._state == {"done": False, "rtt_ms": None, "applied": {}} and not calls
        assert _constants("mythril_tpu_torch") == before
        assert cal.calibrate(torch.device("cuda"))["device_probe_threshold"] == 20_000
        assert [d.type for d in calls] == ["cuda"]


# ---------------------------------------------------------------------------
# the solver's gate on seeded conjunctions
# ---------------------------------------------------------------------------

_OPS = ("add", "mul", "band", "bxor", "sub")


def seeded_conjunction(rng: np.random.Generator) -> list:
    """A JAX conjunction of 1-4 comparisons over random expression DAGs of
    a few 256-bit variables (sharing subterms, so DAG size and tree size
    differ)."""
    from mythril_tpu.smt import terms as jt

    names = [f"cal_v{int(i)}" for i in rng.integers(0, 50, size=int(rng.integers(1, 5)))]
    pool = [jt.var(n, 256) for n in names] + [jt.const(int(rng.integers(1, 1 << 30)), 256)]
    for _ in range(int(rng.integers(1, 400))):
        op = _OPS[int(rng.integers(len(_OPS)))]
        a, b = (pool[int(i)] for i in rng.integers(0, len(pool), size=2))
        pool.append(getattr(jt, op)(a, b))
    conj = []
    for _ in range(int(rng.integers(1, 5))):
        a, b = (pool[int(i)] for i in rng.integers(len(pool) // 2, len(pool), size=2))
        conj.append(jt.ult(a, b) if rng.random() < 0.5 else jt.eq(a, b))
    return conj


@pytest.mark.parametrize("threshold", [20_000, 120_000, 600_000, 5_000_000])
def test_the_solver_gates_decide_alike(threshold, monkeypatch):
    from mythril_tpu.smt import solver as J
    from mythril_tpu.support.support_args import args as jargs
    from mythril_tpu_torch.smt import solver as P
    from mythril_tpu_torch.support.support_args import args as pargs
    from tests._torch_parity import to_port

    rng = np.random.default_rng(threshold)
    decisions = []
    with pinned("mythril_tpu", None, monkeypatch), pinned("mythril_tpu_torch", None, monkeypatch):
        monkeypatch.setattr(jargs, "probe_backend", "auto")
        monkeypatch.setattr(pargs, "probe_backend", "auto")
        jargs.device_probe_threshold = pargs.device_probe_threshold = threshold
        for _ in range(40):
            conj = seeded_conjunction(rng)
            n = int(rng.choice([1, 8, 24, 48, 96, 192, 1024, 8192, 65536]))
            want = J._device_worthwhile(conj, n)
            got = P._device_worthwhile(to_port(conj), n, torch.device("cpu"))
            assert got == want, (threshold, n, len(conj))
            decisions.append(want)
    assert any(decisions) and not all(decisions)


def test_auto_asks_for_the_device_only_on_the_card(monkeypatch):
    from mythril_tpu_torch.smt import solver as P
    from mythril_tpu_torch.support.support_args import args

    for backend, cpu, cuda in (("auto", False, True), ("device", True, True),
                               ("host", False, False), ("cdcl", False, False)):
        monkeypatch.setattr(args, "probe_backend", backend)
        assert P._device_backend_requested(torch.device("cpu")) is cpu, backend
        assert P._device_backend_requested(torch.device("cuda")) is cuda, backend


def test_auto_on_the_cpu_probes_on_the_host_as_the_jax_package(monkeypatch):
    """The same query under ``auto``: the JAX package under
    ``JAX_PLATFORMS=cpu`` and the port on ``device="cpu"`` both evaluate on
    the host (no device dispatch), with the same verdict and model."""
    from mythril_tpu.smt import solver as J
    from mythril_tpu.support.support_args import args as jargs
    from mythril_tpu_torch.smt import solver as P
    from mythril_tpu_torch.smt.concrete_eval import evaluate
    from tests._torch_parity import jax_same_tiers, port_device_backend, port_probe_backend, to_port

    def dispatched(*a, **kw):
        raise AssertionError("auto on the CPU compiled a query for the device")

    for solver in (J, P):
        monkeypatch.setattr(solver, "_try_compile_device", dispatched)
    rng = np.random.default_rng(7)
    conjs = [seeded_conjunction(rng) for _ in range(6)]
    for conj in conjs:
        with jax_same_tiers():
            jargs.probe_backend = "auto"
            jstatus, jasg = J.solve_conjunction(conj)
        with port_device_backend(), port_probe_backend("auto"):
            P.SolverStatistics().reset()
            pconj = to_port(conj)
            pstatus, pasg = P.solve_conjunction(pconj, device="cpu")
            assert P.SolverStatistics().device_dispatches == 0
        assert pstatus == jstatus
        if jasg is not None:
            assert _by_name(pasg) == _by_name(jasg)
            vals = evaluate(pconj, pasg)
            assert all(vals[c] for c in pconj)


def _by_name(asg) -> dict:
    """A model's scalar values by variable name."""
    return {var.aux: value for var, value in asg.scalars.items()}


# ---------------------------------------------------------------------------
# the frontier engine's admission gate, calibrated
# ---------------------------------------------------------------------------


class _Env:
    def __init__(self, code):
        self.code = code


class _Seed:
    def __init__(self, code):
        self.environment = _Env(code)


def _code(base: str, jumpis: int):
    """A runtime code with ``jumpis`` JUMPIs (PUSH1 0 PUSH1 0 JUMPI each)."""
    dis = importlib.import_module(f"{base}.frontend.disassembler")
    return dis.Disassembly("6000600057" * jumpis + "00")


@pytest.mark.parametrize("rtt", RTTS)
def test_the_engine_gates_admit_alike_after_calibration(rtt, monkeypatch):
    rng = np.random.default_rng(int((rtt or 0) * 100) + 1)
    shapes = [(int(rng.integers(1, 30)), int(rng.integers(0, 12))) for _ in range(24)]
    got = {}
    for base in BASES:
        engine_mod = importlib.import_module(f"{base}.frontier.engine")
        state = importlib.import_module(f"{base}.frontier.state")
        args = importlib.import_module(f"{base}.support.support_args").args
        monkeypatch.setattr(args, "frontier_force", False)
        with pinned(base, rtt, monkeypatch):
            for memo in ("_NARROW_CODES", "_SLOW_CODES"):
                monkeypatch.setattr(engine_mod, memo, set())
            engine = engine_mod.FrontierEngine.__new__(engine_mod.FrontierEngine)
            engine.caps = state.Caps(B=64)
            engine.device = torch.device("cuda")  # read by the port's gate alone
            decisions = []
            for width, jumpis in shapes:
                code = _code(base, jumpis)
                decisions.append(engine._device_worthwhile([(None, _Seed(code))] * width))
            got[base] = (decisions, _constants(base))
    assert got["mythril_tpu"] == got["mythril_tpu_torch"]


def test_the_engine_gate_calibrates_for_its_device(monkeypatch):
    """The port's engine calibrates after the ``frontier_force`` check, for
    the laser's device: nothing under force, nothing on the CPU."""
    from mythril_tpu_torch.frontier import engine as engine_mod
    from mythril_tpu_torch.frontier import state
    from mythril_tpu_torch.support import calibration
    from mythril_tpu_torch.support.support_args import args

    seen = []
    monkeypatch.setattr(calibration, "calibrate", lambda device=None: seen.append(device) or {})
    engine = engine_mod.FrontierEngine.__new__(engine_mod.FrontierEngine)
    engine.caps, engine.device = state.Caps(B=64), torch.device("cpu")
    pairs = [(None, _Seed(_code("mythril_tpu_torch", 3)))] * 40
    monkeypatch.setattr(args, "frontier_force", True)
    assert engine._device_worthwhile(pairs) and seen == []
    monkeypatch.setattr(args, "frontier_force", False)
    assert engine._device_worthwhile(pairs) and seen == [torch.device("cpu")]
