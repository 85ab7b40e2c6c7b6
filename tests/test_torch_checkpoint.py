"""The port's frontier checkpoint and resume against the JAX package's.

* The JAX package's ``tests/core/test_checkpoint.py`` cases run on the port
  (``port_cases``; the resumed analysis on ``device="cpu"``).
* The recording ``tests/testdata/torch_checkpoint_runs.json`` holds, for
  KillBilly with its creation code (``bench.KILLBILLY_CREATION``, whose
  issue needs the second message call) and ``bench_contracts.etherstore_like``, what the JAX CLI
  did on its default command line (``AUTO_PINS``: its ``auto`` probe, on
  its CPU the host probe) with ``-t 1 --checkpoint-file F`` (the report and
  the checkpoint file it wrote), with ``-t 2 --resume-from F`` on that
  file, and with ``-t 2`` uninterrupted.  The port's CLI on the CPU must
  write the same checkpoint (equal JSON) and report, resume the JAX
  package's file to the JAX package's resumed report, whose issue keys
  equal the uninterrupted run's; the JAX package must load the port's file
  and write it back unchanged.
* A checkpoint that cannot be written only logs, as in the JAX package
  (``mythril_tpu/core/svm.py:234-235``); a kernel that fails in a resumed
  run raises out of the analysis.

    JAX_PLATFORMS=cpu python tests/test_torch_checkpoint.py --write

records the fixture (each JAX run in a process of its own with a fresh
HOME; about a minute).
"""

from __future__ import annotations

import contextlib
import io
import json
import logging
import os
import sys
import tempfile
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:  # run as a script (--write)
    sys.path.insert(0, str(REPO))
from tests._torch_parity import _one_torch_thread  # noqa: E402,F401  (autouse fixture)
from tests.test_torch_cli import (  # noqa: E402
    AUTO_PINS,
    OUT,
    _last_json_line,
    differences,
    port_argv,
    run_port,
)
from tests.test_torch_observability import port_cases  # noqa: E402

FIXTURE = REPO / "tests" / "testdata" / "torch_checkpoint_runs.json"
# the checkpoint file a resumed command line reads
CKPT = "{ckpt}"
CONTRACTS = ("killbilly", "etherstore_like")


def contract_argv(name: str, tx: int) -> list:
    import bench
    import bench_contracts

    if name == "killbilly":
        return ["analyze", "-c", bench.KILLBILLY_CREATION, "-t", str(tx),
                "-m", "AccidentallyKillable", "-o", "jsonv2"]
    return ["analyze", "-c", bench_contracts.etherstore_like().hex(), "--bin-runtime",
            "-t", str(tx), "-o", "jsonv2"]


def recorded_runs() -> list:
    """Per contract: ``-t 1`` writing the checkpoint, ``-t 2`` resuming from
    it, and ``-t 2`` uninterrupted (the port's argv; the JAX CLI gets
    ``AUTO_PINS`` on top)."""
    runs = []
    for name in CONTRACTS:
        runs += [
            {"name": f"{name}/t1-checkpoint",
             "argv": contract_argv(name, 1) + ["--checkpoint-file", OUT]},
            {"name": f"{name}/t2-resume",
             "argv": contract_argv(name, 2) + ["--resume-from", CKPT]},
            {"name": f"{name}/t2", "argv": contract_argv(name, 2)},
        ]
    return runs


def load_runs() -> dict:
    return {r["name"]: r for r in json.loads(FIXTURE.read_text())["runs"]}


def issue_keys(stdout: str) -> list:
    return sorted((i["swcID"], i["swcTitle"], i["severity"], i["locations"][0]["sourceMap"],
                   i["description"]["head"]) for i in _last_json_line(stdout)[0]["issues"])


@pytest.fixture(autouse=True)
def _fresh_process(tmp_path, monkeypatch):
    """A configuration directory of the test's own, and the creation's
    address counter where a fresh process starts it (the recorded JAX runs
    each ran in one; KillBilly's created address lands in the checkpoint)."""
    from mythril_tpu_torch.core.state.world_state import WorldState

    monkeypatch.setenv("MYTHRIL_DIR", str(tmp_path / "mythril"))
    monkeypatch.setattr(WorldState, "next_address_seed", 0x6B6579)


# ---------------------------------------------------------------------------
# the JAX package's cases on the port
# ---------------------------------------------------------------------------

_ported = port_cases(REPO / "tests" / "core" / "test_checkpoint.py", "port_test_checkpoint",
                     subs=[(r"execution_timeout=120,\n", "execution_timeout=120, device=\"cpu\",\n")])
for _name, _fn in vars(_ported).items():
    if _name.startswith("test_"):
        globals()[f"test_port_checkpoint_{_name[5:]}"] = _fn


# ---------------------------------------------------------------------------
# the recorded command lines
# ---------------------------------------------------------------------------


def test_fixture_holds_the_runs_it_names():
    runs = load_runs()
    assert [r["name"] for r in recorded_runs()] == list(runs)
    for name in CONTRACTS:
        assert all(runs[f"{name}/{k}"]["rc"] == 0 for k in ("t1-checkpoint", "t2-resume", "t2"))
        ckpt = json.loads(runs[f"{name}/t1-checkpoint"]["file"])
        assert ckpt["version"] == 1 and ckpt["completed_transactions"] == 1
        assert ckpt["open_states"]
    # KillBilly's issue needs the second transaction: the resumed run finds
    # what the first did not
    assert issue_keys(runs["killbilly/t1-checkpoint"]["stdout"]) == []
    assert [k[0] for k in issue_keys(runs["killbilly/t2-resume"]["stdout"])] == ["SWC-106"]


@pytest.mark.parametrize("name", CONTRACTS)
def test_port_writes_the_jax_checkpoint(name):
    """``-t 1 --checkpoint-file``: the JAX CLI's report and the same file."""
    from mythril_tpu_torch.support.checkpoint import FORMAT_VERSION

    run = load_runs()[f"{name}/t1-checkpoint"]
    rc, ckpt, stdout = run_port(port_argv(run), with_stdout=True)
    assert rc == run["rc"] == 0
    assert differences("jsonv2", run["stdout"], stdout) == []
    assert FORMAT_VERSION == 1
    assert json.loads(ckpt) == json.loads(run["file"])


@pytest.mark.parametrize("name", CONTRACTS)
def test_port_resumes_the_jax_checkpoint(name, tmp_path):
    """``-t 2 --resume-from`` the JAX package's file: the JAX CLI's resumed
    report, whose issue keys equal the uninterrupted run's."""
    runs = load_runs()
    run = runs[f"{name}/t2-resume"]
    path = tmp_path / "ckpt.json"
    path.write_text(runs[f"{name}/t1-checkpoint"]["file"])
    rc, out = run_port([str(path) if a == CKPT else a for a in port_argv(run)])
    assert rc == run["rc"] == 0
    assert differences("jsonv2", run["stdout"], out) == []
    assert issue_keys(out) == issue_keys(runs[f"{name}/t2"]["stdout"])


@pytest.mark.parametrize("name", CONTRACTS)
def test_jax_package_loads_the_port_checkpoint(name, tmp_path):
    """The port's file loads in the JAX package, which writes it back
    unchanged."""
    from mythril_tpu.support import checkpoint as jax_checkpoint

    run = load_runs()[f"{name}/t1-checkpoint"]
    rc, ckpt = run_port(port_argv(run))
    assert rc == 0
    path, again = tmp_path / "port.json", tmp_path / "jax.json"
    path.write_text(ckpt)
    done, states, address = jax_checkpoint.load_checkpoint(str(path))
    assert done == 1 and len(states) == len(json.loads(ckpt)["open_states"])
    jax_checkpoint.save_checkpoint(str(again), done, states, target_address=address)
    assert json.loads(again.read_text()) == json.loads(ckpt)


def test_a_failed_checkpoint_write_only_logs(tmp_path, caplog):
    """A checkpoint path that cannot be written (its parent is a file): the
    analysis finishes with the issue, and the failure is one warning, as in
    the JAX package."""
    import bench

    from mythril_tpu_torch.analysis.security import fire_lasers
    from mythril_tpu_torch.analysis.symbolic import SymExecWrapper
    from mythril_tpu_torch.frontend.evmcontract import EVMContract
    from tests._torch_parity import _reset

    _reset("mythril_tpu_torch")
    (tmp_path / "blocker").write_text("")
    contract = EVMContract(code=bench.KILLBILLY, creation_code=bench.KILLBILLY_CREATION,
                           name="KB")
    with caplog.at_level(logging.WARNING, logger="mythril_tpu_torch.core.svm"):
        sym = SymExecWrapper(contract, address=0x0901D12E, strategy="bfs", transaction_count=2,
                             execution_timeout=120, modules=["AccidentallyKillable"],
                             checkpoint_path=str(tmp_path / "blocker" / "ckpt.json"),
                             device="cpu")
    issues = fire_lasers(sym, white_list=["AccidentallyKillable"])
    assert [i.swc_id for i in issues] == ["106"]
    failed = [r for r in caplog.records if "checkpoint write failed" in r.getMessage()]
    assert len(failed) == 2  # one per completed transaction


def test_a_kernel_failure_in_a_resumed_run_raises(tmp_path, monkeypatch):
    """The frontier forced on a resumed run: a segment launch that fails
    raises out of the analysis (no host-only fallback), and the CLI exits 1
    naming it."""
    from mythril_tpu_torch.frontier import engine
    from mythril_tpu_torch.ops import _build

    runs = load_runs()
    path = tmp_path / "ckpt.json"
    path.write_text(runs["killbilly/t1-checkpoint"]["file"])
    calls = []

    def failing(*_a, **_k):
        calls.append(1)
        raise _build.KernelLaunchError("frontier_segment: CUDA error 700 at launch")

    monkeypatch.setattr(engine, "cached_segment", lambda *a, **k: failing)
    argv = [str(path) if a == CKPT else a for a in port_argv(runs["killbilly/t2-resume"])]
    rc, out = run_port(argv + ["--frontier", "--frontier-force", "--no-pipeline"])
    assert calls and rc == 1
    assert "KernelLaunchError" in _last_json_line(out)["error"]


# ---------------------------------------------------------------------------
# recording the fixture
# ---------------------------------------------------------------------------


def _record(run: dict, ckpt_text: str = "") -> dict:
    """One run of the JAX CLI in process (a fresh process and HOME) -> the
    run with its pins, exit code, stdout, seconds and, for a checkpoint
    writer, the file."""
    home = tempfile.mkdtemp(prefix="jax-ckpt-home-")
    os.environ.update(HOME=home, MYTHRIL_DIR=os.path.join(home, ".mythril_tpu"),
                      JAX_PLATFORMS="cpu")
    from mythril_tpu.interfaces import cli as jax_cli

    out_path, ckpt_path = os.path.join(home, "out"), os.path.join(home, "ckpt.json")
    Path(ckpt_path).write_text(ckpt_text)
    sys.argv = ["myth", *[out_path if a == OUT else ckpt_path if a == CKPT else a
                          for a in run["argv"]], *AUTO_PINS]
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        try:
            jax_cli.main()
            rc = 0
        except SystemExit as e:
            rc = e.code or 0
    seconds = time.perf_counter() - t0
    exported = {"file": Path(out_path).read_text()} if OUT in run["argv"] else {}
    return {**run, "pins": AUTO_PINS, "rc": rc, "stdout": out.getvalue(),
            "jax_cpu_seconds": seconds, **exported}


def write_fixture() -> None:
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    os.environ["MYTHRIL_TPU_COMPILATION_CACHE"] = tempfile.mkdtemp(prefix="jax-ckpt-xla-")
    runs = {r["name"]: r for r in recorded_runs()}
    done = {}
    with ProcessPoolExecutor(2, mp_context=multiprocessing.get_context("spawn"),
                             max_tasks_per_child=1) as pool:
        firsts = [runs[f"{c}/t1-checkpoint"] for c in CONTRACTS]
        for rec in pool.map(_record, firsts):
            done[rec["name"]] = rec
        rest = [r for r in runs.values() if r["name"] not in done]
        texts = [done[r["name"].split("/")[0] + "/t1-checkpoint"]["file"] for r in rest]
        for rec in pool.map(_record, rest, texts):
            done[rec["name"]] = rec
    for rec in done.values():
        print(f"{rec['name']}: rc {rec['rc']}, {rec['jax_cpu_seconds']:.1f} s", flush=True)
    FIXTURE.write_text(json.dumps({"runs": [done[n] for n in runs]}, indent=1) + "\n")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--write"]:
        write_fixture()
    else:
        print(__doc__)
