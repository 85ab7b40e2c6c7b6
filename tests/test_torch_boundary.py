"""The port's import boundary: it runs with JAX blocked and loads nothing of
the JAX package.

A fresh interpreter with ``sys.modules["jax"] = None`` (so any ``import
jax`` raises) imports the port, replays one batch group and one single
query of the probe fixture on the CPU, and reports which modules it
loaded.  The same process shows that, without a card, an entry point called
without ``device="cpu"`` raises instead of moving to the CPU.
"""

import json
import re
import subprocess
import sys
from pathlib import Path

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
print(json.dumps({"keep": keep, "status": status, "raised": raised,
                  "modules": sorted(m for m, mod in sys.modules.items() if mod is not None)}))
"""


def test_port_runs_with_jax_blocked_and_imports_no_jax_package():
    fixture = REPO / "tests" / "testdata" / "torch_probe_queries.json"
    out = subprocess.run(
        [sys.executable, "-c", _CHILD, str(REPO), str(fixture)],
        capture_output=True, text=True, timeout=300, cwd=str(REPO.parent),
    )
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    leaked = [m for m in got["modules"] if re.match(r"(mythril_tpu(?!_torch)|jax)(\.|$)", m)]
    assert leaked == []
    assert got["keep"] and all(isinstance(k, bool) for k in got["keep"])
    assert got["status"] in ("sat", "unsat", "unknown")
    assert got["raised"] in (True, None)  # None: a card is visible


def test_port_sources_name_no_jax_package():
    pattern = re.compile(r"^\s*(from|import)\s+(jax|mythril_tpu(?!_torch))\b", re.M)
    offenders = [
        str(p.relative_to(REPO)) for p in PKG.rglob("*.py") if pattern.search(p.read_text())
    ]
    assert offenders == []
    smoke = (REPO / "chip_smoke.py").read_text()
    assert not pattern.search(smoke)
