"""The port's service command line and watchtower against the JAX package's.

* The JAX package's ``tests/service/test_watchtower_integration.py`` cases
  run on the port (``port_cases``, ``device="cpu"``).
* ``python -m mythril_tpu_torch serve --device cpu --no-warmup`` on a free
  port, as a process of its own: ``submit -o json`` prints the event lines
  the JAX CLI printed against its own ``serve`` (recorded under ``cli`` in
  ``tests/testdata/torch_service_runs.json``, the wall-clock fields left
  out), the text form and a duplicate's dedup line, ``top --once`` and
  ``health`` answer with code 0, and SIGTERM drains the service to exit
  code 0.  Without a card, ``serve`` without ``--device cpu`` exits 1
  naming ``NoCudaDevice``.

    JAX_PLATFORMS=cpu python tests/test_torch_service_cli.py --write

records the JAX CLI's events (its ``serve`` in a process of its own with a
fresh HOME; about a minute).
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:  # run as a script (--write)
    sys.path.insert(0, str(REPO))
from tests._torch_parity import _one_torch_thread  # noqa: E402,F401  (autouse fixture)
from tests.test_torch_observability import port_cases  # noqa: E402
from tests.test_torch_service import FIXTURE, ON_CPU, adopt, contract_hex  # noqa: E402

_SVC = REPO / "tests" / "service"
adopt(globals(), port_cases(_SVC / "conftest.py", "port_service_conftest"), "conftest")
adopt(globals(), port_cases(_SVC / "test_watchtower_integration.py",
                            "port_test_watchtower_integration", subs=ON_CPU),
      "watchtower_integration")

# what the recorded submissions leave out: wall-clock readings
VOLATILE = ("elapsed_s", "discovery_time")


def normalized(events: list) -> list:
    def strip(d):
        return {k: ([strip(i) for i in v] if k == "issues" else v)
                for k, v in d.items() if k not in VOLATILE}

    return [strip(e) for e in events]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def serving(pkg: str, extra=(), env=None):
    """``python -m <pkg> serve --no-warmup -t 1`` on a free port, until
    SIGTERM; yields ``(port, proc)``.  The process's exit code is in
    ``proc.returncode`` after the block."""
    port = free_port()
    with tempfile.TemporaryDirectory() as home:
        run_env = dict(os.environ, HOME=home, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
                       PYTHONPATH=str(REPO), **(env or {}))
        proc = subprocess.Popen(
            [sys.executable, "-m", pkg, "serve", "--no-warmup", "-t", "1", "--port", str(port),
             "--cache-root", os.path.join(home, "cache"), *extra],
            cwd=home, env=run_env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            from mythril_tpu_torch.service.server import wait_for_server

            assert wait_for_server("127.0.0.1", port, timeout=180), proc.stderr.read()
            yield port, proc
        finally:
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(timeout=120)
            finally:
                if proc.poll() is None:
                    proc.kill()


def submissions(port: int) -> list:
    """The recorded submissions' argv: ``kill_simple`` from tenant t1 as
    JSON, then its duplicate from tenant t2."""
    base = ["submit", "-c", contract_hex("kill_simple"), "--port", str(port), "-o", "json"]
    return [base + ["--tenant", "t1"], base + ["--tenant", "t2"]]


def port_cli(argv) -> tuple:
    from mythril_tpu_torch.interfaces import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    return rc, out.getvalue()


def test_serve_submit_top_health_and_sigterm():
    recorded = json.loads(FIXTURE.read_text())["cli"]
    with serving("mythril_tpu_torch", ["--device", "cpu"]) as (port, proc):
        got = []
        for argv in submissions(port):
            rc, out = port_cli(argv)
            assert rc == 0, out
            got.append(normalized([json.loads(line) for line in out.splitlines()]))
        assert got == recorded["submit"]
        rc, out = port_cli(["submit", "-c", contract_hex("kill_simple"), "--port", str(port)])
        assert rc == 0 and out.splitlines() == [
            "accepted r000003 (deduplicated)",
            "issue SWC-106 Unprotected Selfdestruct @ kill()",
            out.splitlines()[-1]]
        assert out.splitlines()[-1].startswith("done: 1 issues in ")
        rc, out = port_cli(["top", "--once", "--port", str(port)])
        assert rc == 0 and "service" in out
        rc, out = port_cli(["health", "--port", str(port), "-o", "json"])
        assert rc == recorded["health_rc"] and sorted(json.loads(out)) == recorded["health_keys"]
    assert proc.returncode == 0, proc.stderr.read()


def test_serve_without_a_card_names_it(caplog, monkeypatch):
    """Without a card (made so here if one is visible), ``serve`` on the
    default device fails before it binds, naming ``NoCudaDevice``."""
    import torch

    from mythril_tpu_torch.interfaces import cli
    from mythril_tpu_torch.service import server

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(server, "run_server", lambda *a, **kw: pytest.fail("served"))
    assert cli.main(["serve", "--no-warmup", "--port", str(free_port())]) == 1
    assert "NoCudaDevice" in caplog.text


def _record() -> dict:
    """The JAX CLI against its own ``serve``."""
    with serving("mythril_tpu", env={"JAX_PLATFORMS": "cpu"}) as (port, proc):
        got = []
        for argv in submissions(port):
            out = subprocess.run([sys.executable, "-m", "mythril_tpu", *argv], check=True,
                                 capture_output=True, text=True,
                                 env=dict(os.environ, JAX_PLATFORMS="cpu")).stdout
            got.append(normalized([json.loads(line) for line in out.splitlines()]))
        health = subprocess.run([sys.executable, "-m", "mythril_tpu", "health", "--port",
                                 str(port), "-o", "json"], capture_output=True, text=True,
                                env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0
    return {"submit": got, "health_rc": health.returncode,
            "health_keys": sorted(json.loads(health.stdout))}


if __name__ == "__main__":
    if "--write" in sys.argv:
        data = json.loads(FIXTURE.read_text())
        data["cli"] = _record()
        FIXTURE.write_text(json.dumps(data, indent=1) + "\n")
        print(f"wrote {FIXTURE}")
