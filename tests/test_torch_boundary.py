"""The port's import boundary: it runs with JAX blocked and loads nothing of
the JAX package.

A fresh interpreter with ``sys.modules["jax"] = None`` (so any ``import
jax`` raises) imports the port, replays one batch group and one single
query of the probe fixture on the CPU, imports the frontier modules
(``frontier/{ops,arena,code,state,step}``, ``support/opcodes``) and runs one
small plain segment on the CPU, evaluates a lowering batch sharded over a
mesh of 2 logical shards of the CPU (``parallel``), builds and loads the port's native library
(``native/bitblast``, g++ into ``mythril_tpu_torch/_build/``) and has its
CDCL refute one formula, runs the prefilter's ``prefilter_batch`` and the
devsolver's ``decide_batch`` on the CPU, imports the pipelined frontier
(``frontier/pipeline``) and runs a ``CorrectionLedger`` through a dispatch,
a pull and a carry, imports every module of the port, runs one
whole analysis of ``kill_simple.bin-runtime`` (``SymExecWrapper`` +
``fire_lasers`` on the CPU, with the host engine and with the frontier
forced, which runs pipelined by default, and reads the exploration
ledger after each), runs a cooperative batch of two contracts
(``analysis.cooperative``, the adaptive controller on), runs the command line in process (``interfaces.cli.main``:
``analyze`` of the same contract with ``--device cpu``), flips the JAX
package's concolic unit contract's branch on the CPU, asks the link
calibration for a CPU decision, and reports which modules it loaded.  The same process shows that,
without a card, entry points called without ``device="cpu"`` (the solver,
``cached_segment``, ``SymExecWrapper``) raise instead of moving to the CPU.
"""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "mythril_tpu_torch"

_CHILD = r"""
import json, sys
sys.modules["jax"] = None
sys.path.insert(0, sys.argv[1])
import torch
from mythril_tpu_torch.device import NoCudaDevice
from mythril_tpu_torch.smt import solver as P
from mythril_tpu_torch.smt.serialize import from_jax_dump
from mythril_tpu_torch.support.support_args import args

data = json.load(open(sys.argv[2]))
roots = from_jax_dump(data["terms"])
queries = data["contracts"][0]["queries"]
batch = next(q for q in queries if q["kind"] == "batch")
solve = next(q for q in queries if q["kind"] == "solve")
args.probe_backend = "device"
keep = P.check_satisfiable_batch([[roots[i] for i in s] for s in batch["sets"]], device="cpu")
status, _ = P.solve_conjunction([roots[i] for i in solve["conj"]], device="cpu")
raised = None
if not torch.cuda.is_available():
    try:
        P.solve_conjunction([roots[i] for i in solve["conj"]], use_cache=False)
    except NoCudaDevice:
        raised = True
    else:
        raised = False

from mythril_tpu_torch.frontier import arena, code, interop, ops, state, step
from mythril_tpu_torch.support import opcodes
from tests._torch_parity import _one_torch_thread  # noqa: E402,F401  (autouse fixture)
from tests import _torch_frontier_cases as cases

case = cases.family_case(ops.F_JUMPI, False)
segment = step.cached_segment(cases.CAPS, *cases.BUCKET, device="cpu")
out = segment(*interop.inputs_from_numpy(case["state"], case["arena"], case["arena_len"],
                                         case["visited"], case["code"], case["cfg"], "cpu"))
n_exec = int(out[3])
seg_raised = None
if not torch.cuda.is_available():
    try:
        step.cached_segment(cases.CAPS, *cases.BUCKET)
    except NoCudaDevice:
        seg_raised = True
    else:
        seg_raised = False
from mythril_tpu_torch.native import bitblast, build
from mythril_tpu_torch.smt import terms
native = {"available": bitblast.available(), "library": str(build.library_path())}
if native["available"]:
    x = terms.var("boundary_x", 32)
    native["status"] = bitblast.solve(
        [terms.ult(x, terms.const(5, 32)), terms.ult(terms.const(10, 32), x)], 10.0)[0]
from mythril_tpu_torch.ops import lowering
from mythril_tpu_torch.smt.concrete_eval import Assignment
k = terms.var("boundary_k", 256)
pre = terms.concat(*[terms.extract(255 - 8 * i, 248 - 8 * i, k) for i in range(32)],
                   *[terms.const(3, 8)] * 32)
low_conj = [terms.ult(terms.keccak(pre), terms.const(1 << 255, 256)), terms.ult(k, terms.const(9, 256))]
low_asgs = []
for v in (0, 5, 12):
    a = Assignment()
    a.scalars[k] = v
    low_asgs.append(a)
compiled = lowering.compile_cached(low_conj)
low = {"truth": compiled.evaluate_batch(low_asgs, "cpu").tolist(), "raised": None}
if not torch.cuda.is_available():
    try:
        compiled.evaluate_batch(low_asgs)
    except NoCudaDevice:
        low["raised"] = True
    else:
        low["raised"] = False
from mythril_tpu_torch.parallel import evaluate_batch_sharded, make_frontier_mesh
from mythril_tpu_torch.parallel.mesh import logical_shards, mesh_devices
with logical_shards(2):
    par_mesh = make_frontier_mesh(mesh_devices("cpu"))
par = {"truth": evaluate_batch_sharded(compiled, low_asgs, par_mesh).tolist(),
       "shape": par_mesh.shape}
from mythril_tpu_torch import absdomain, devsolver
y = terms.var("boundary_y", 8)
tier_rows = [[terms.ult(y, terms.const(5, 8)), terms.ult(terms.const(10, 8), y)],
             [terms.eq(y, terms.const(3, 8))]]
tiers = {"prefilter": absdomain.prefilter_batch(tier_rows, "cpu"),
         "devsolver": [s for s, _a in devsolver.decide_batch(tier_rows, "cpu")]}
import numpy as np
from mythril_tpu_torch.frontier import pipeline
led = pipeline.CorrectionLedger(4)
led.consume(np.full(4, -1))
led.touch(2)
ledger_mask = led.consume(np.array([5, -1, 7, -1])).tolist()
prev_st, new_st = state.empty_state(state.Caps(B=4), 4), state.empty_state(state.Caps(B=4), 4)
prev_st.pc[2], new_st.pc[2], new_st.ev_len[2] = 42, 7, 3
ledger = {"mask": ledger_mask, "carried": led.carry_forward(new_st, prev_st),
          "pc": int(new_st.pc[2]), "ev_len": int(new_st.ev_len[2])}
import importlib, pkgutil
import mythril_tpu_torch
for m in pkgutil.walk_packages(mythril_tpu_torch.__path__, "mythril_tpu_torch."):
    importlib.import_module(m.name)
from mythril_tpu_torch.analysis.module.loader import ModuleLoader
from mythril_tpu_torch.analysis.security import fire_lasers
from mythril_tpu_torch.analysis.symbolic import SymExecWrapper
from mythril_tpu_torch.frontier.stats import FrontierStatistics
code = bytes.fromhex(open(sys.argv[3]).read().strip())
found = {}
for frontier in (False, True):
    args.frontier = args.frontier_force = frontier
    FrontierStatistics().reset()
    pipeline.reset_counters()
    for m in ModuleLoader().get_detection_modules():
        m.cache.clear()
    sym = SymExecWrapper(code, address=0x0901D12E, transaction_count=1, execution_timeout=60,
                         modules=["AccidentallyKillable"], device="cpu")
    found[str(frontier)] = [[i.swc_id, FrontierStatistics().segments]
                            for i in fire_lasers(sym, white_list=["AccidentallyKillable"])]
    found[str(frontier) + "_pipelined"] = pipeline.COUNTERS["segments_pipelined"]
    from mythril_tpu_torch.observability import exploration_meta
    meta = exploration_meta()
    found[str(frontier) + "_ledger"] = [meta["partition_ok"], meta["terminated_total"],
                                        meta["coverage_pct"]]
from mythril_tpu_torch.adaptive import get_adaptive_controller
from mythril_tpu_torch.analysis.cooperative import analyze_cooperative
from mythril_tpu_torch.analysis.security import reset_callback_modules
reset_callback_modules()
for m in ModuleLoader().get_detection_modules():
    m.cache.clear()
args.frontier = args.frontier_force = True
coop_issues, _states = analyze_cooperative(
    [("kill", code), ("gated", bytes.fromhex(
        "60003580600a9010600c57005b80600514601c5780601414601c57005b33ff"))],
    transaction_count=1, modules=["AccidentallyKillable"], device="cpu")
coop = {"issues": sorted((n, i.swc_id) for n, found_ in coop_issues.items() for i in found_),
        "adaptive": get_adaptive_controller().meta()}
sym_raised = None
if not torch.cuda.is_available():
    try:
        SymExecWrapper(code, address=0x0901D12E, transaction_count=1)
    except NoCudaDevice:
        sym_raised = True
    else:
        sym_raised = False
import contextlib, io, os, tempfile
from mythril_tpu_torch.interfaces import cli
os.environ["MYTHRIL_DIR"] = tempfile.mkdtemp()
for m in ModuleLoader().get_detection_modules():
    m.cache.clear()
out = io.StringIO()
with contextlib.redirect_stdout(out):
    cli_rc = cli.main(["analyze", "-f", sys.argv[3], "--bin-runtime", "-t", "1", "-m",
                       "AccidentallyKillable", "-o", "json", "--device", "cpu"])
cli_issues = [i["swc-id"] for i in json.loads(out.getvalue())["issues"]]
from mythril_tpu_torch.concolic.concolic_execution import concolic_execution
from mythril_tpu_torch.support import calibration
# the JAX package's branch-flip unit contract (tests/integration/test_concolic.py)
unit = {"initialState": {"accounts": {"0x" + "ab" * 20: {
            "balance": "0x0", "code": "0x600035600514600f576002600055005b600160005500",
            "nonce": 0, "storage": {}}}},
        "steps": [{"address": "0x" + "ab" * 20, "gasLimit": "0x100000", "gasPrice": "0x0",
                   "input": "0x" + "00" * 32, "origin": "0x" + "cd" * 20, "value": "0x0"}]}
flips = concolic_execution(unit, [8], solver_timeout=30000, device="cpu")
concolic = [int(f["steps"][0]["input"][2:66].ljust(64, "0"), 16) for f in flips]
cal = [calibration.calibrate("cpu"), calibration.measure_dispatch_rtt_ms("cpu"),
       calibration.telemetry()]
print(json.dumps({"cli": [cli_rc, cli_issues], "concolic": concolic, "calibration": cal,
                  "keep": keep, "status": status,
                  "raised": raised, "n_exec": n_exec, "seg_raised": seg_raised,
                  "opcodes": len(opcodes.OPCODES), "found": found, "sym_raised": sym_raised, "native": native, "tiers": tiers,
                  "ledger": ledger, "lowering": low, "coop": coop, "parallel": par, "modules": sorted(m for m, mod in sys.modules.items() if mod is not None)}))
"""


def test_port_runs_with_jax_blocked_and_imports_no_jax_package():
    fixture = REPO / "tests" / "testdata" / "torch_probe_queries.json"
    kill_simple = REPO / "tests" / "testdata" / "inputs" / "kill_simple.bin-runtime"
    out = subprocess.run(
        [sys.executable, "-c", _CHILD, str(REPO), str(fixture), str(kill_simple)],
        capture_output=True, text=True, timeout=300, cwd=str(REPO.parent),
    )
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    leaked = [m for m in got["modules"] if re.match(r"(mythril_tpu(?!_torch)|jax)(\.|$)", m)]
    assert leaked == []
    assert got["keep"] and all(isinstance(k, bool) for k in got["keep"])
    assert got["status"] in ("sat", "unsat", "unknown")
    assert got["raised"] in (True, None)  # None: a card is visible
    assert got["n_exec"] > 0 and got["opcodes"] > 100
    assert got["seg_raised"] in (True, None)
    assert got["tiers"] == {"prefilter": [True, False], "devsolver": ["unsat", "sat"]}
    # the per-conjunction lowering (a byte-built keccak preimage) on the CPU
    from mythril_tpu_torch.ops.keccak import keccak256_int

    want = [[keccak256_int(int.from_bytes(v.to_bytes(32, "big") + bytes([3] * 32), "big"), 64)
             < 1 << 255, v < 9] for v in (0, 5, 12)]
    assert got["lowering"] == {"truth": want, "raised": got["lowering"]["raised"]}
    assert got["lowering"]["raised"] in (True, None)
    # the device mesh: the same candidates sharded over 2 logical shards of
    # the CPU (3 candidates padded to 4)
    assert got["parallel"] == {"truth": want, "shape": {"path": 1, "cand": 2}}
    for mod in ("parallel", "parallel.mesh", "parallel.probe", "parallel.corpus"):
        assert f"mythril_tpu_torch.{mod}" in got["modules"]
    for mod in ("frontier.ops", "frontier.arena", "frontier.code", "frontier.state",
                "frontier.step", "support.opcodes", "frontier.engine", "frontier.walker",
                "frontier.harvest", "frontier.pipeline", "core.svm", "analysis.symbolic", "analysis.security",
                "analysis.module.modules.suicide", "plugins.plugins.dependency_pruner"):
        assert f"mythril_tpu_torch.{mod}" in got["modules"]
    # the host engine finds the issue without the device; the forced
    # frontier finds it through at least one segment
    assert got["found"]["False"] == [["106", 0]]
    assert got["found"]["True"][0][0] == "106" and got["found"]["True"][0][1] > 0
    # ... pipelined, by default
    assert got["found"]["True_pipelined"] > 0 and got["found"]["False_pipelined"] == 0
    # the exploration ledger saw both runs: the frontier's terminations
    # partition, its coverage planes merged
    partition_ok, terminated, coverage = got["found"]["True_ledger"]
    assert partition_ok and terminated > 0 and coverage > 0
    # a cooperative batch of two contracts on one frontier, the controller
    # on by default
    assert got["coop"]["issues"] == [["gated", "106"], ["kill", "106"]]
    assert got["coop"]["adaptive"]["enabled"] and got["coop"]["adaptive"]["plans"] > 0
    for mod in ("adaptive.controller", "adaptive.plan", "observability.exploration",
                "observability.metrics", "analysis.cooperative"):
        assert f"mythril_tpu_torch.{mod}" in got["modules"]
    # the correction ledger: slot 2's write rode dispatch 1, so the pull of
    # dispatch 0 carries it from the host mirror, events cleared
    assert got["ledger"] == {"mask": [False, False, True, False], "carried": 1, "pc": 42,
                             "ev_len": 0}
    assert got["sym_raised"] in (True, None)
    # the command line ran the same analysis
    assert "mythril_tpu_torch.interfaces.cli" in got["modules"]
    assert "mythril_tpu_torch.facade.mythril_analyzer" in got["modules"]
    assert got["cli"] == [0, ["106"]]
    # concolic execution flipped the unit contract's branch on the CPU; the
    # calibration measured nothing for the CPU
    assert got["concolic"] == [5]
    assert got["calibration"] == [{}, None, {}]
    for mod in ("concolic.concolic_execution", "concolic.find_trace", "concolic.concrete_data",
                "core.strategy.concolic", "core.transaction.concolic", "support.calibration",
                # the analysis service and the fleet fabric, with jax blocked
                "service.daemon", "service.worker", "service.pool", "service.server",
                "observability.fleet"):
        assert f"mythril_tpu_torch.{mod}" in got["modules"]
    # the native CDCL builds from the port's own sources wherever g++ is
    if shutil.which("g++") or shutil.which("c++"):
        assert got["native"]["available"] and got["native"]["status"] == "unsat"
        assert Path(got["native"]["library"]).parent == PKG / "_build"


def test_port_sources_name_no_jax_package():
    pattern = re.compile(r"^\s*(from|import)\s+(jax|mythril_tpu(?!_torch))\b", re.M)
    offenders = [
        str(p.relative_to(REPO)) for p in PKG.rglob("*.py") if pattern.search(p.read_text())
    ]
    assert offenders == []
    smoke = (REPO / "chip_smoke.py").read_text()
    assert not pattern.search(smoke)


def test_copied_modules_differ_from_the_jax_package_only_by_name():
    """The port's host modules listed in ``scripts/torch_port_copy.py`` are
    the JAX package's with the package name renamed, nothing else."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_port_copy", REPO / "scripts" / "torch_port_copy.py")
    copy = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(copy)
    assert copy.main(["--check"]) == 0
    assert len(copy.COPIED) > 50


_SERVICE_CHILD = r"""
import importlib.abc, json, sys
sys.modules["jax"] = None


class _Blocked(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "mythril_tpu" or name.startswith("mythril_tpu."):
            raise ImportError(f"blocked: {name}")
        return None


sys.meta_path.insert(0, _Blocked())
sys.path.insert(0, sys.argv[1])
import chip_smoke

codes = {name: chip_smoke.service_contract(name) for name, _tenant, _tier in
         chip_smoke.SERVICE_SUBMISSIONS}
print(json.dumps({"codes": codes,
                  "modules": sorted(m for m, mod in sys.modules.items() if mod is not None)}))
"""


def test_chip_smoke_service_contracts_load_no_jax_package():
    """``chip_smoke.py``'s ``service_contract``, which phase 8l calls for
    every recorded submission, runs with ``jax`` and ``mythril_tpu`` blocked
    on import and loads no module of the JAX package: the hand-assembled
    contracts come from the port's copy of ``bench_contracts.py``
    (``tests/_torch_contracts.py``), whose selectors hash with the port's
    keccak."""
    out = subprocess.run(
        [sys.executable, "-c", _SERVICE_CHILD, str(REPO)],
        capture_output=True, text=True, timeout=300, cwd=str(REPO.parent),
    )
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    leaked = [m for m in got["modules"] if re.match(r"(mythril_tpu(?!_torch)|jax)(\.|$)", m)]
    assert leaked == []
    assert sorted(got["codes"]) == ["etherstore_like", "kill_simple", "rubixi_like"]
    assert all(len(bytes.fromhex(code)) > 10 for code in got["codes"].values())


@pytest.mark.parametrize("name", ["bectoken_like", "etherstore_like", "rubixi_like"])
def test_copied_contract_builders_equal_bench_contracts(name):
    """The port's copy of the three builders assembles the same bytes as
    ``bench_contracts.py``, selectors included."""
    import bench_contracts

    from tests import _torch_contracts

    assert getattr(_torch_contracts, name)() == getattr(bench_contracts, name)()
    assert _torch_contracts.SEL_BATCH_TRANSFER == bench_contracts.SEL_BATCH_TRANSFER
