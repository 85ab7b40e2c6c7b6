"""Concolic execution (``mythril_tpu_torch/concolic/``, the concolic strategy
and transaction driver, the CLI's ``concolic`` subcommand) against the JAX
package's (``mythril_tpu/concolic/``).

The JAX ``tests/integration/test_concolic.py`` cases (the branch-flip unit
contract), ``tests/core/test_strategies.py::test_bounded_loops_strategy_caps_repetition``
(which drives the concolic transaction driver) and
``tests/conformance/test_vmtests.py`` on the in-repo fixtures
(``tests/testdata/vmtests``) run here on the port: their source with the
package renamed and ``device="cpu"`` given to the port's entry points.

Real traffic: ``tests/testdata/torch_concolic_runs.json`` holds concrete
transactions replayed and flipped by the JAX package under its default
tiers with the probe pinned to ``jax`` (``_torch_parity.jax_solver_tiers``
with the query cache on; the port runs them under ``device``, its
counterpart): ``bench_contracts``' ``bectoken_like`` (the owner and the
caller's balance at its keccak-addressed slot in storage; one
``transfer(address,uint256)`` that succeeds, and one
``batchTransfer(address[],uint256)`` to two receivers), ``etherstore_like``
(``depositFunds()`` then ``withdrawFunds(uint256)``, a two-step trace) and
``rubixi_like`` (``dynamicPyramid()`` with value).  Each case holds the
concrete data, the branches requested (every JUMPI address on the concrete
trace, in the order the trace first reaches them), the JAX output list,
which requested flips produced an input, the native CDCL calls and the
ones cut by their wall-clock budget (``timeouts``), and the JAX CPU
seconds.  Regenerate with

    JAX_PLATFORMS=cpu python tests/test_torch_concolic.py --write [name ...]

(each case in a process of its own).  Under pytest the port on the CPU
reproduces the small cases (``SMALL``) output for output; ``chip_smoke.py``
phase 8i runs every case on the card.  Here also: the CLI's ``concolic``
output against the JAX CLI's on the unit contract, the frontier's
``_is_concolic`` guard, and the adaptive controller's flip counters against
the JAX package's.  Tolerance 0: the outputs are integers and strings.
"""

from __future__ import annotations

import contextlib
import io
import json
import sys
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from tests._torch_parity import _one_torch_thread  # noqa: E402,F401  (autouse fixture)
from tests.test_torch_adaptive import port_cases  # noqa: E402

FIXTURE = REPO / "tests" / "testdata" / "torch_concolic_runs.json"
VMTESTS = REPO / "tests" / "testdata" / "vmtests"
CONTRACT = "0x" + "ab" * 20
CALLER = "0x" + "cd" * 20
OWNER = "0x" + "ee" * 20
RECEIVERS = ("0x" + "11" * 20, "0x" + "22" * 20)
# replayed under pytest on the CPU (the others on the card only)
SMALL = ("rubixi_like", "etherstore_like", "bectoken_like/transfer")
CPU = 'device="cpu"'

# the JAX package's own cases, on the port
_CONCOLIC = port_cases(REPO / "tests" / "integration" / "test_concolic.py", "port_test_concolic",
                       subs=((r"solver_timeout=30000\)", f"solver_timeout=30000, {CPU})"),
                             (r"concrete_execution\((_concrete_data\([^)]*\))\)",
                              rf"concrete_execution(\1, {CPU})")))
for _name, _case in vars(_CONCOLIC).items():
    if _name.startswith("test_"):
        globals()[f"test_port_{_name[5:]}"] = _case
del _name, _case
_STRATEGIES = port_cases(REPO / "tests" / "core" / "test_strategies.py", "port_test_strategies",
                         subs=((r"LaserEVM\(max_depth=10_000\)",
                                f"LaserEVM(max_depth=10_000, {CPU})"),))
_VMTESTS = port_cases(REPO / "tests" / "conformance" / "test_vmtests.py", "port_test_vmtests",
                      subs=((r"LaserEVM\(max_depth=100_000\)",
                             f"LaserEVM(max_depth=100_000, {CPU})"),))
VM_CASES = [(name, data) for path in sorted(VMTESTS.glob("*/*.json"))
            for name, data in json.loads(path.read_text()).items()]


def on_the_cpu():
    """The analysis scope of a CPU run (``args.device``): these JAX cases
    drive ``LaserEVM`` directly, whose pruning queries read it."""
    import torch

    from mythril_tpu_torch.analysis.symbolic import analysis_device

    return analysis_device(torch.device("cpu"))


def test_port_bounded_loops_strategy_caps_repetition():
    with on_the_cpu():
        _STRATEGIES.test_bounded_loops_strategy_caps_repetition()


@pytest.mark.conformance
@pytest.mark.parametrize("name, data", VM_CASES, ids=[c[0] for c in VM_CASES])
def test_port_vmtest(name, data):
    with on_the_cpu():
        _VMTESTS.test_vmtest(name, data)


def test_the_vmtests_are_the_in_repo_fixtures():
    assert len(sorted(VMTESTS.glob("*/*.json"))) == 6 and len(VM_CASES) >= 6


# ---------------------------------------------------------------------------
# the recorded traffic
# ---------------------------------------------------------------------------


def _word(value: int) -> str:
    return "%064x" % value


def _step(selector: int, args: str = "", value: int = 0) -> dict:
    return {"address": CONTRACT, "blockCoinbase": "0x" + "00" * 20, "blockDifficulty": "0x0",
            "blockGasLimit": "0x989680", "blockNumber": "0x1", "blockTime": "0x1",
            "gasLimit": "0x100000", "gasPrice": "0x0", "input": "0x%08x" % selector + args,
            "origin": CALLER, "value": hex(value)}


def _data(code: bytes, storage: dict, steps: list) -> dict:
    return {"initialState": {"accounts": {CONTRACT: {
        "balance": "0x0", "code": "0x" + code.hex(), "nonce": 0,
        "storage": {hex(k): hex(v) for k, v in storage.items()}}}}, "steps": steps}


def recorded_cases() -> dict:
    """name -> concrete data, built from ``bench_contracts`` (the recorder
    alone needs it: it imports the JAX package)."""
    import bench_contracts as bc
    from mythril_tpu.support.support_utils import keccak256

    def slot_of(key: str, slot: int) -> int:
        return int.from_bytes(keccak256(bytes.fromhex(_word(int(key, 16)) + _word(slot))), "big")

    bec = bc.bectoken_like()
    storage = {bc.SLOT_OWNER: int(OWNER, 16), slot_of(CALLER, bc.SLOT_BALANCES): 1000}
    r1, r2 = (int(r, 16) for r in RECEIVERS)
    return {
        "bectoken_like/transfer": _data(bec, storage, [
            _step(bc.SEL_TRANSFER, _word(r1) + _word(100))]),
        "bectoken_like/batch_transfer": _data(bec, storage, [
            _step(bc.SEL_BATCH_TRANSFER, _word(0x40) + _word(10) + _word(2) + _word(r1)
                  + _word(r2))]),
        "etherstore_like": _data(bc.etherstore_like(), {bc.ES_SLOT_LIMIT: 10 ** 18}, [
            _step(bc.SEL_DEPOSIT, value=1000), _step(bc.SEL_WITHDRAW, _word(500))]),
        "rubixi_like": _data(bc.rubixi_like(), {}, [
            _step(bc.SEL_DYNAMIC_PYRAMID, value=10 ** 17)]),
    }


def jumpi_branches(data: dict, trace: list) -> list:
    """Every JUMPI address on a concrete trace, in the order the trace
    first reaches it."""
    from mythril_tpu_torch.frontend.disassembler import Disassembly

    code = data["initialState"]["accounts"][CONTRACT]["code"]
    ops = {i.address: i.opcode for i in Disassembly(code[2:]).instruction_list}
    return list(dict.fromkeys(pc for pc, _tx in trace if ops.get(pc) == "JUMPI"))


def flip(base: str, data: dict, branches: list, device=None,
         solver_timeout: int = 100000) -> dict:
    """``base``'s concrete replay and branch flips, as ``concolic_execution``
    runs them (its solver budget set, then restored), every cache cleared
    first -> {"trace", "outputs", "hits" (the requested flips that
    produced an input), "cdcl" (``counting_cdcl``'s counts), "seconds"}."""
    import importlib

    from tests._torch_parity import _reset, counting_cdcl

    find_trace = importlib.import_module(f"{base}.concolic.find_trace")
    execution = importlib.import_module(f"{base}.concolic.concolic_execution")
    args = importlib.import_module(f"{base}.support.support_args").args
    kw = {} if base == "mythril_tpu" else {"device": device}
    _reset(base)
    saved, args.solver_timeout = args.solver_timeout, solver_timeout
    native: dict = {}
    try:
        with counting_cdcl(base, native):
            t0 = time.perf_counter()
            init_state, trace = find_trace.concrete_execution(data, **kw)
            hits: dict = {}
            outputs = execution.flip_branches(init_state, data, branches, trace,
                                              hits_out=hits, **kw)
            seconds = time.perf_counter() - t0
    finally:
        args.solver_timeout = saved
    return {"trace": [list(t) for t in trace], "outputs": outputs,
            "hits": sorted(a for a, ok in hits.items() if ok), "cdcl": native,
            "seconds": seconds}


def _record(name: str) -> dict:
    """One case on the JAX package (this process): its default tiers, the
    probe pinned to ``jax``."""
    from tests._torch_parity import _jax_tiers

    data = recorded_cases()[name]
    with _jax_tiers(cdcl=True, tiers=True, query_cache=True):
        from mythril_tpu.concolic.find_trace import concrete_execution

        _init, trace = concrete_execution(data)
        branches = jumpi_branches(data, trace)
        got = flip("mythril_tpu", data, branches)
    return {"name": name, "data": data, "branches": branches, "outputs": got["outputs"],
            "hits": got["hits"], "trace": got["trace"], "cdcl": got["cdcl"],
            "jax_cpu_seconds": got["seconds"]}


def load_runs() -> dict:
    return {r["name"]: r for r in json.loads(FIXTURE.read_text())["runs"]}


def run_port(run: dict, device, backend: str = "device") -> dict:
    """A recorded case through the port on ``device`` under ``backend``
    (the port's default tiers)."""
    from tests._torch_parity import port_probe_backend

    with port_probe_backend(backend):
        return flip("mythril_tpu_torch", run["data"], run["branches"], device=device)


def output_differences(run: dict, got: dict) -> list:
    """Where a port run's outputs and hits differ from the recording's."""
    bad = []
    if got["hits"] != run["hits"]:
        bad.append(f"hits {got['hits']} != {run['hits']}")
    if got["outputs"] != run["outputs"]:
        bad.append(f"outputs differ: {json.dumps(got['outputs'])[:300]} != "
                   f"{json.dumps(run['outputs'])[:300]}")
    return bad


def flip_check(run: dict, output: dict, device) -> list:
    """An output of a flip, replayed by the port's ``concrete_execution``:
    its trace must leave the recorded trace at a requested JUMPI (the
    flipped branch) and not before.  -> where it does not."""
    from mythril_tpu_torch.concolic.find_trace import concrete_execution

    _init, trace = concrete_execution(output, device=device)
    recorded = [tuple(t) for t in run["trace"]]
    trace = [tuple(t) for t in trace]
    n = next((i for i, (a, b) in enumerate(zip(trace, recorded)) if a != b),
             min(len(trace), len(recorded)))
    if n == 0 or n >= len(recorded) or trace[n - 1][0] not in run["branches"]:
        return [f"the replayed input leaves the trace at step {n}, after "
                f"{trace[n - 1] if n else None}, not at a requested JUMPI"]
    return []


@pytest.mark.parametrize("name", SMALL)
def test_recorded_case_equals_the_jax_packages(name):
    run = load_runs()[name]
    got = run_port(run, "cpu")
    assert got["trace"] == run["trace"]
    assert jumpi_branches(run["data"], got["trace"]) == run["branches"]
    assert output_differences(run, got) == []
    assert run["hits"], "the recording flips nothing"
    for output in got["outputs"]:
        assert flip_check(run, output, "cpu") == []


def test_fixture_holds_the_cases_it_names():
    runs = load_runs()
    assert list(runs) == ["bectoken_like/transfer", "bectoken_like/batch_transfer",
                          "etherstore_like", "rubixi_like"]
    for run in runs.values():
        assert run["branches"] and len(run["outputs"]) == len(run["hits"]) > 0
        assert set(run["hits"]) <= set(run["branches"])
    assert len(runs["etherstore_like"]["data"]["steps"]) == 2


def test_the_frontier_never_steps_a_concolic_laser(monkeypatch):
    """With the frontier forced on, a concolic run's output is unchanged and
    no seed set reaches the device (``_is_concolic``), as in the JAX
    package."""
    from mythril_tpu_torch.frontier import engine
    from mythril_tpu_torch.support.support_args import args

    run = load_runs()["rubixi_like"]
    drained = []
    real = engine.FrontierEngine._drain_pairs

    def recording(self, pairs, **kw):
        drained.append(len(pairs))
        return real(self, pairs, **kw)

    monkeypatch.setattr(engine.FrontierEngine, "_drain_pairs", recording)
    monkeypatch.setattr(args, "frontier", True)
    monkeypatch.setattr(args, "frontier_force", True)
    got = run_port(run, "cpu")
    assert drained == []
    assert output_differences(run, got) == []


# ---------------------------------------------------------------------------
# the unit contract: the CLI and the flip counters
# ---------------------------------------------------------------------------


def _unit_data(input_hex: str) -> dict:
    return _CONCOLIC._concrete_data(input_hex)


def test_cli_concolic_equals_the_jax_cli(tmp_path, monkeypatch):
    from mythril_tpu.interfaces import cli as jax_cli
    from mythril_tpu_torch.interfaces import cli

    path = tmp_path / "input.json"
    path.write_text(json.dumps(_unit_data("0x" + "00" * 32)))
    argv = ["concolic", str(path), "--branches", str(_CONCOLIC.JUMPI_ADDRESS),
            "--solver-timeout", "30000"]
    monkeypatch.setenv("MYTHRIL_DIR", str(tmp_path / "mythril"))
    from tests._torch_parity import _reset

    outs = []
    for base in ("mythril_tpu", "mythril_tpu_torch"):
        _reset(base)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            if base == "mythril_tpu":
                monkeypatch.setattr(sys, "argv", ["myth", *argv])
                jax_cli.main()
            else:
                assert cli.main(argv + ["--device", "cpu"]) == 0
        outs.append(json.loads(out.getvalue()))
    assert outs[0] == outs[1] and len(outs[1]) == 1
    word = int(outs[1][0]["steps"][0]["input"][2:66].ljust(64, "0"), 16)
    assert word == 5


def test_cli_concolic_needs_a_card_unless_asked_for_the_cpu(tmp_path, monkeypatch, caplog):
    import torch

    from mythril_tpu_torch.interfaces import cli

    path = tmp_path / "input.json"
    path.write_text(json.dumps(_unit_data("0x" + "00" * 32)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["c", str(path), "--branches", "8"]) == 1
    assert "NoCudaDevice" in caplog.text


@pytest.mark.parametrize("planned", [[8], [8, 3], [3]])
def test_planned_flips_feed_the_counters_as_in_the_jax_package(planned):
    """``flip_targets`` merge into the requested branches and feed
    ``adaptive.flips_planned`` and ``flips_hit`` (address 3 is no JUMPI:
    planned, never hit)."""
    from mythril_tpu.concolic import concolic_execution as jax_concolic
    from mythril_tpu_torch.concolic import concolic_execution as port_concolic
    from tests._torch_parity import _reset, adaptive_counters

    got = {}
    for base, mod in (("mythril_tpu", jax_concolic), ("mythril_tpu_torch", port_concolic)):
        _reset(base)
        kw = {} if base == "mythril_tpu" else {"device": "cpu"}
        out = mod.concolic_execution(_unit_data("0x" + "00" * 32), [], solver_timeout=30000,
                                     flip_targets=planned, **kw)
        got[base] = (out, adaptive_counters(base))
    assert got["mythril_tpu"] == got["mythril_tpu_torch"]
    counters = got["mythril_tpu_torch"][1]
    assert (counters["flips_planned"], counters["flips_hit"]) == (len(planned), int(8 in planned))


def write_fixture(names=()) -> None:
    import subprocess

    old = load_runs() if FIXTURE.is_file() else {}
    for name in recorded_cases():
        if names and name not in names:
            continue
        out = subprocess.run([sys.executable, __file__, "--record", name], capture_output=True,
                             text=True, check=True, cwd=str(REPO))
        old[name] = json.loads(out.stdout.strip().splitlines()[-1])
        run = old[name]
        print(f"{name}: {len(run['branches'])} branches, {len(run['outputs'])} outputs, hits "
              f"{run['hits']}, CDCL {run['cdcl']}, {run['jax_cpu_seconds']:.1f} s", flush=True)
    order = list(recorded_cases())
    FIXTURE.write_text(json.dumps({"runs": [old[n] for n in order if n in old]}, indent=1) + "\n")


if __name__ == "__main__":
    import os

    if sys.argv[1:2] == ["--record"]:
        print(json.dumps(_record(sys.argv[2])), flush=True)
        # the JAX package's worker threads outlive the run; leave without
        # tearing them down
        os._exit(0)
    if "--write" not in sys.argv:
        sys.exit("usage: JAX_PLATFORMS=cpu python tests/test_torch_concolic.py --write [name ...]")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    write_fixture([a for a in sys.argv[1:] if a != "--write"])
