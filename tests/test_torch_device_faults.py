"""Every device fault reaches the caller (``mythril_tpu_torch/device.py``
``is_device_fault``).

A kernel that faults while it runs surfaces at the next synchronization as
``torch.AcceleratorError``, a failed allocation as ``torch.OutOfMemoryError``;
the port's own ``DeviceError`` covers a missing card and a kernel that did
not build or launch.  The four places that drop one path's or one
contract's error must let all three through: the harvest's replay and its
commit (``frontier/harvest.py``), ``FrontierEngine._park_all`` and the
analyzer facade.  Any other ``RuntimeError`` is host code's and still costs
only its path, or its contract.  The JAX package catches every exception
in its replay (``mythril_tpu/frontier/harvest.py`` ``_replay_group``), so
this is the port's own rule, held without a JAX counterpart.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mythril_tpu_torch.device import DeviceError, is_device_fault
from tests._torch_parity import _one_torch_thread  # noqa: E402,F401  (autouse fixture)
from tests.test_torch_harvest import _FakeEngine, _finished, _Laser

FAULTS = {
    "DeviceError": lambda: DeviceError("injected: the kernel did not build"),
    "AcceleratorError": lambda: torch.AcceleratorError("injected"),
    "OutOfMemoryError": lambda: torch.OutOfMemoryError("injected"),
}


def test_the_predicate_takes_device_faults_and_no_other_runtime_error():
    assert all(is_device_fault(make()) for make in FAULTS.values())
    assert not is_device_fault(RuntimeError("host code"))
    assert not is_device_fault(ValueError("host code"))


@pytest.mark.parametrize("workers", [0, 4])
@pytest.mark.parametrize("fault", FAULTS)
def test_a_replay_fault_reaches_the_harvests_caller(fault, workers):
    from mythril_tpu_torch.frontier import harvest

    lasers = [_Laser(), _Laser()]
    caps, st, records, walker = _finished("mythril_tpu_torch", 8, 4, lasers)
    walker.fail_on, walker.fail_on_error = 2, FAULTS[fault]()
    try:
        with pytest.raises(type(walker.fail_on_error), match="injected"):
            harvest.HarvestExecutor(_FakeEngine(caps), workers=workers).harvest(
                st, records, walker, np.zeros(caps.B, np.int64))
    finally:
        harvest.shutdown_replay_pool()


@pytest.mark.parametrize("workers", [0, 4])
def test_a_host_error_in_a_replay_costs_only_its_path(workers):
    from mythril_tpu_torch.frontier import harvest
    from mythril_tpu_torch.frontier.stats import FrontierStatistics

    FrontierStatistics().reset()
    lasers = [_Laser(), _Laser()]
    caps, st, records, walker = _finished("mythril_tpu_torch", 8, 4, lasers)
    walker.fail_on, walker.fail_on_error = 2, RuntimeError("host code")
    try:
        harvest.HarvestExecutor(_FakeEngine(caps), workers=workers).harvest(
            st, records, walker, np.zeros(caps.B, np.int64))
    finally:
        harvest.shutdown_replay_pool()
    assert FrontierStatistics().replay_errors == 1
    assert len(walker.committed) == 7


class _FailingCommit:
    """A walker's ``commit`` that raises ``error`` on the record in slot
    ``slot``."""

    def __init__(self, walker, slot, error):
        self.walker, self.slot, self.error = walker, slot, error

    def __getattr__(self, name):
        return getattr(self.walker, name)

    def commit(self, rec):
        if self.walker.slot_of[id(rec)] == self.slot:
            raise self.error
        self.walker.commit(rec)


@pytest.mark.parametrize("fault", [*FAULTS, "host RuntimeError"])
def test_a_commit_fault_reaches_the_harvests_caller(fault):
    from mythril_tpu_torch.frontier import harvest
    from mythril_tpu_torch.frontier.stats import FrontierStatistics

    FrontierStatistics().reset()
    caps, st, records, walker = _finished("mythril_tpu_torch", 6, 3, [_Laser()])
    error = FAULTS[fault]() if fault in FAULTS else RuntimeError("host code")
    failing = _FailingCommit(walker, 1, error)
    run = lambda: harvest.HarvestExecutor(_FakeEngine(caps), workers=0).harvest(  # noqa: E731
        st, records, failing, np.zeros(caps.B, np.int64))
    if fault in FAULTS:
        with pytest.raises(type(error), match="injected"):
            run()
    else:
        run()
        assert FrontierStatistics().commit_errors == 1
        assert len(walker.committed) == 5


class _FailingFinish:
    def __init__(self, error):
        self.error, self.finished = error, 0

    def finish(self, rec):
        self.finished += 1
        raise self.error


@pytest.mark.parametrize("fault", [*FAULTS, "host RuntimeError"])
def test_a_park_fault_reaches_the_engines_caller(fault):
    from mythril_tpu_torch.frontier import records as records_mod
    from mythril_tpu_torch.frontier import state
    from mythril_tpu_torch.frontier.engine import FrontierEngine
    from mythril_tpu_torch.frontier.stats import FrontierStatistics

    FrontierStatistics().reset()
    engine = FrontierEngine.__new__(FrontierEngine)
    engine.caps = state.Caps(B=8)
    st = state.empty_state(engine.caps, 4)
    records = {i: None for i in range(engine.caps.B)}
    for slot in (1, 3, 5):
        records[slot] = records_mod.PathRecord(seed_idx=0)
    error = FAULTS[fault]() if fault in FAULTS else RuntimeError("host code")
    walker = _FailingFinish(error)
    if fault in FAULTS:
        with pytest.raises(type(error), match="injected"):
            engine._park_all(st, records, walker)
        assert walker.finished == 1
    else:
        engine._park_all(st, records, walker)
        assert FrontierStatistics().replay_errors == 3
        assert all(r is None for r in records.values())


@pytest.mark.parametrize("fault", [*FAULTS, "host RuntimeError"])
def test_an_analysis_fault_reaches_the_analyzers_caller(fault, monkeypatch):
    """A device fault inside one contract's analysis fails the analysis;
    any other exception degrades to that contract's partial results."""
    from mythril_tpu_torch.facade import mythril_analyzer
    from mythril_tpu_torch.facade.mythril_analyzer import AnalyzerArgs, MythrilAnalyzer
    from mythril_tpu_torch.facade.mythril_disassembler import MythrilDisassembler

    error = FAULTS[fault]() if fault in FAULTS else RuntimeError("host code")

    def broken(*a, **kw):
        raise error

    monkeypatch.setattr(mythril_analyzer, "SymExecWrapper", broken)
    disassembler = MythrilDisassembler()
    disassembler.load_from_bytecode("0x60006000f3", bin_runtime=True)
    analyzer = MythrilAnalyzer(disassembler, AnalyzerArgs(transaction_count=1), device="cpu")
    if fault in FAULTS:
        with pytest.raises(type(error), match="injected"):
            analyzer.fire_lasers()
    else:
        report = analyzer.fire_lasers()
        assert len(report.exceptions) == 1 and "host code" in report.exceptions[0]
