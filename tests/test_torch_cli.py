"""The port's command line (``python -m mythril_tpu_torch``) against the JAX
package's (``python -m mythril_tpu``).

The fixture ``tests/testdata/torch_cli_runs.json`` holds what the JAX CLI
printed for each recorded command line, run with the JAX-only flags that pin
it to the port's tiers (``JAX_PINS``: the forced device probe, and the static
pass, pipeline, prefilter, devsolver, query cache, mesh, adaptive controller
and harvest pool off; native CDCL on in both packages).  The port's argv gets
the pins' switches that the port has too (``port_argv``: ``--no-prefilter
--no-devsolver --no-staticpass --no-staticpass-interproc --no-query-cache
--no-pipeline --harvest-workers 0``), as the JAX CLI ran.  The runs named
``.../tiers`` were recorded with the prefilter and the devsolver on in the JAX
CLI (``TIER_PINS``), the runs named ``.../defaults`` with the static pass and
the query cache on as well (``DEFAULT_PINS``), the runs named ``.../pipeline``
with the pipelined frontier and the replay workers on besides
(``PIPELINE_PINS``: the JAX CLI's defaults but the forced device probe, the
mesh and the adaptive controller), and the port runs them with its own on,
its default; the port's argv gets ``--no-adaptive`` wherever the pins had
it.  ``loop_tail/frontier/coverage-target`` (``bench.LOOP_TAIL`` on a
forced frontier with ``--coverage-target 90 --coverage-out``) was recorded
with the JAX CLI's defaults but the forced device probe and the mesh
(``COVERAGE_PINS``), the adaptive controller on in both.  The runs named
``.../auto`` (``AUTO``: ``kill_simple``, ``etherstore_like`` and
``rubixi_like`` at two transactions on the host engine) were recorded with
the JAX CLI's defaults but the mesh (``AUTO_PINS``: its ``auto`` probe
backend, which on its CPU probes on the host), and the port runs them with
no ``--probe-backend``, its default ``auto``; wherever the pins force the
JAX CLI's ``jax`` backend the port's argv gets ``--probe-backend device``.
The port's link calibration is held as on the JAX CLI's CPU, nothing
measured (``_torch_parity.port_uncalibrated``), but in ``chip_smoke.py``
phase 8h, which replays the ``auto`` runs calibrated on the card.  The
``static/...`` runs are the ``static`` subcommand, which takes no pins, and
``.../staticpass-report`` writes ``--staticpass-report``.  Under pytest the
port's CLI replays the small runs (all but the bench contracts of
``CARD_ONLY``) in process with ``--device cpu`` (``static`` has no device);
its output must equal the JAX CLI's field by field (``differences``), except
the issues' ``discoveryTime``, the wall-time fields of the execution info and
of the static pass's reports (``wall_s``), the calibration block (a
measurement; neither CPU run has one), the report meta blocks of a
surface the port does not carry yet (``JAX_ONLY_META``, none since the
watchtower's ``health`` was ported), the meta blocks
of measurements and registry snapshots that both carry (``MEASURED_META``,
held by ``tests/test_torch_observability.py``) and the seconds of the
exploration ledger's solver hotspots.  ``chip_smoke.py`` replays the bench runs the same way
on the card.

    JAX_PLATFORMS=cpu python tests/test_torch_cli.py --write [names]

records the fixture: each run of the JAX CLI in a process of its own (a
fresh HOME, so no signature database or cache carries between runs), four
at a time; the bench runs take a few minutes.

Also here: the port's parser against the JAX parser, the refusals, the
missing card, ``read-storage`` and ``--address`` against a mocked JSON-RPC
node, the facade's device after the wrapper returns, and subprocess mirrors
of ``tests/integration/test_cli_integration.py``.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import os
import subprocess
import sys
from pathlib import Path
from typing import Optional

import pytest

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:  # run as a script (--write)
    sys.path.insert(0, str(REPO))
from tests._torch_parity import _one_torch_thread  # noqa: E402,F401  (autouse fixture)
FIXTURE = REPO / "tests" / "testdata" / "torch_cli_runs.json"
KILL_SIMPLE = REPO / "tests" / "testdata" / "inputs" / "kill_simple.bin-runtime"

# the JAX CLI's flags that hold it to the port's tiers (not passed to the port)
JAX_PINS = [
    "--probe-backend", "jax", "--no-staticpass", "--no-staticpass-interproc", "--no-pipeline",
    "--no-prefilter", "--no-devsolver", "--no-query-cache", "--no-mesh", "--no-adaptive",
    "--harvest-workers", "0",
]
# the JAX CLI's pins for the runs recorded with its prefilter and devsolver on
TIER_PINS = [a for a in JAX_PINS if a not in ("--no-prefilter", "--no-devsolver")]
# ... and with its static pass and query cache on as well
HOST_TIER_SWITCHES = ("--no-staticpass", "--no-staticpass-interproc", "--no-query-cache")
DEFAULT_PINS = [a for a in TIER_PINS if a not in HOST_TIER_SWITCHES]
# ... and with its pipelined frontier and harvest replay workers on as well
PIPELINE_PINS = ["--probe-backend", "jax", "--no-mesh", "--no-adaptive"]
# ... and with its adaptive controller on as well
COVERAGE_PINS = ["--probe-backend", "jax", "--no-mesh"]
# ... and with its default probe backend, auto (on the JAX package's CPU:
# the host probe), as well
AUTO_PINS = ["--probe-backend", "auto", "--no-mesh"]
# the jsonv2 meta blocks of a surface the port does not carry yet (none:
# the watchtower's health is compared since it was ported)
JAX_ONLY_META = set()
# meta blocks both carry that hold measurements or the registry's snapshot;
# tests/test_torch_observability.py compares them
MEASURED_META = {"device", "devsolver", "frontier", "observability", "prefilter"}
WALL_FIELDS = ("solver_time_s",)
FRONTIER_WALL_FIELDS = ("segment_s", "harvest_s")
# the file argument of --statespace-json and --graph in a recorded argv
OUT = "{out}"
# replayed on the card (chip_smoke.py); every run but CARD_ONLY is small and
# also replayed under pytest on the CPU
BENCH = ("etherstore_like/frontier-256", "rubixi_like/frontier-256",
         "kill_simple/frontier-256", "etherstore_like/frontier-256/tiers",
         "etherstore_like/frontier-256/defaults")
# the default command line (no --probe-backend: auto) on the host engine,
# replayed calibrated on the card (chip_smoke.py phase 8h)
AUTO = ("kill_simple/host/auto", "etherstore_like/host/auto", "rubixi_like/host/auto")
CARD_ONLY = ("etherstore_like/frontier-256", "rubixi_like/frontier-256",
             "etherstore_like/frontier-256/tiers", "etherstore_like/frontier-256/defaults",
             "etherstore_like/frontier-256/pipeline", "etherstore_like/host/auto",
             "rubixi_like/host/auto")
SMALL = tuple(r["name"] for r in json.loads(FIXTURE.read_text())["runs"]
              if r["name"] not in CARD_ONLY) if FIXTURE.is_file() else ()


def recorded_runs() -> list:
    """Every recorded command line (the port's argv; the JAX CLI gets
    ``JAX_PINS`` on top): the contracts of ``_torch_parity.engine_contracts``
    on the host engine and on the forced frontier as jsonv2, ``clean`` as
    json, ``kill_simple`` at one transaction as text and markdown, its
    statespace and call graph exports at two, and ``bench_contracts``'
    ``etherstore_like`` and ``rubixi_like`` and ``kill_simple`` at two
    transactions on a forced frontier of 256 paths; and with the JAX CLI's
    prefilter and devsolver on (``TIER_PINS``), ``kill_simple`` at two
    transactions on the host engine and ``etherstore_like`` on the forced
    frontier of 256; with its static pass and query cache on too
    (``DEFAULT_PINS``), the same two, ``killbilly_2tx`` and the dead-code
    contract (``_torch_parity.dead_code_contract``) on a forced frontier of
    64, and ``kill_simple``'s ``--staticpass-report``; with the pipeline and
    the replay workers on too (``PIPELINE_PINS``), ``kill_simple`` on a
    forced frontier of 64 and ``etherstore_like`` of 256; with the adaptive
    controller on too (``COVERAGE_PINS``), ``bench.LOOP_TAIL`` on a forced
    frontier with ``--coverage-target 90`` and ``--coverage-out``; and
    ``static -o json`` on ``kill_simple`` and on KillBilly with its creation
    code, and ``static`` text on ``kill_simple``."""
    sys.path.insert(0, str(REPO))
    import bench_contracts
    from bench import KILLBILLY, KILLBILLY_CREATION

    from tests.test_torch_adaptive import LOOP_TAIL
    from tests._torch_parity import dead_code_contract, engine_contracts

    def analyze(code, tx, modules=None):
        return (["analyze", "-c", code, "--bin-runtime", "-t", str(tx)]
                + (["-m", ",".join(modules)] if modules else []))

    frontier = ["--frontier", "--frontier-force"]
    runs = []
    for name, (code, tx, modules) in engine_contracts().items():
        runs.append({"name": f"{name}/host", "argv": analyze(code, tx, modules) + ["-o", "jsonv2"]})
        runs.append({"name": f"{name}/frontier",
                     "argv": analyze(code, tx, modules) + ["-o", "jsonv2", *frontier]})
    contracts = engine_contracts()
    runs.append({"name": "clean/host/json", "argv": analyze(contracts["clean"][0], 1) + ["-o", "json"]})
    for outform in ("text", "markdown"):
        runs.append({"name": f"kill_simple-1tx/host/{outform}",
                     "argv": analyze(contracts["kill_simple"][0], 1) + ["-o", outform]})
    for flag in ("--statespace-json", "--graph"):
        runs.append({"name": f"kill_simple/host/{flag[2:]}",
                     "argv": analyze(contracts["kill_simple"][0], 2) + [flag, OUT]})
    bench = {"etherstore_like": bench_contracts.etherstore_like().hex(),
             "rubixi_like": bench_contracts.rubixi_like().hex(),
             "kill_simple": contracts["kill_simple"][0]}
    for name, code in bench.items():
        runs.append({"name": f"{name}/frontier-256",
                     "argv": analyze(code, 2) + ["-o", "jsonv2", *frontier,
                                                 "--frontier-width", "256"]})
    runs.append({"name": "kill_simple/host/tiers", "pins": TIER_PINS,
                 "argv": analyze(contracts["kill_simple"][0], 2) + ["-o", "jsonv2"]})
    runs.append({"name": "etherstore_like/frontier-256/tiers", "pins": TIER_PINS,
                 "argv": analyze(bench["etherstore_like"], 2) + [
                     "-o", "jsonv2", *frontier, "--frontier-width", "256"]})
    runs.append({"name": "kill_simple/host/defaults", "pins": DEFAULT_PINS,
                 "argv": analyze(contracts["kill_simple"][0], 2) + ["-o", "jsonv2"]})
    runs.append({"name": "etherstore_like/frontier-256/defaults", "pins": DEFAULT_PINS,
                 "argv": analyze(bench["etherstore_like"], 2) + [
                     "-o", "jsonv2", *frontier, "--frontier-width", "256"]})
    for name, code in (("killbilly_2tx", KILLBILLY), ("dead_code", dead_code_contract())):
        runs.append({"name": f"{name}/frontier/defaults", "pins": DEFAULT_PINS,
                     "argv": analyze(code, 2) + ["-o", "jsonv2", *frontier]})
    runs.append({"name": "kill_simple/frontier/pipeline", "pins": PIPELINE_PINS,
                 "argv": analyze(contracts["kill_simple"][0], 2) + ["-o", "jsonv2", *frontier]})
    runs.append({"name": "etherstore_like/frontier-256/pipeline", "pins": PIPELINE_PINS,
                 "argv": analyze(bench["etherstore_like"], 2) + [
                     "-o", "jsonv2", *frontier, "--frontier-width", "256"]})
    runs.append({"name": "loop_tail/frontier/coverage-target", "pins": COVERAGE_PINS,
                 "argv": analyze(LOOP_TAIL, 1) + ["-o", "jsonv2", *frontier, "--coverage-target",
                                                  "90", "--coverage-out", OUT]})
    runs.append({"name": "kill_simple/host/staticpass-report", "pins": DEFAULT_PINS,
                 "argv": analyze(contracts["kill_simple"][0], 2) + [
                     "-o", "json", "--staticpass-report", OUT]})
    for name in AUTO:
        code = bench[name.split("/")[0]]
        runs.append({"name": name, "pins": AUTO_PINS, "argv": analyze(code, 2) + ["-o", "jsonv2"]})
    static = ["static", "-c", contracts["kill_simple"][0], "--bin-runtime"]
    runs.append({"name": "static/kill_simple/json", "pins": [], "argv": static + ["-o", "json"]})
    runs.append({"name": "static/kill_simple/text", "pins": [], "argv": static})
    runs.append({"name": "static/killbilly-creation/json", "pins": [],
                 "argv": ["static", "-c", KILLBILLY_CREATION, "-o", "json"]})
    return runs


def port_argv(run: dict) -> list:
    """A recorded run's argv for the port: the JAX pins' tier switches that
    the port has (the prefilter's, the devsolver's, the static pass's, the
    query cache's, the pipeline's and the adaptive controller's, and the
    replay workers' count) added, and ``--probe-backend device`` where the
    pins force the JAX package's ``jax`` backend (the ``auto`` runs get no
    ``--probe-backend``: the port's default)."""
    pins = run["pins"]
    extra = [a for a in ("--no-prefilter", "--no-devsolver", *HOST_TIER_SWITCHES,
                         "--no-pipeline", "--no-adaptive") if a in pins]
    if "jax" in pins:
        extra += ["--probe-backend", "device"]
    if "--harvest-workers" in pins:
        extra += pins[pins.index("--harvest-workers"):][:2]
    return run["argv"] + extra


def device_of(run: dict):
    """The ``--device`` the port's replay passes: none for ``static``."""
    return None if run["argv"][0] == "static" else "cpu"


def load_runs() -> dict:
    return {r["name"]: r for r in json.loads(FIXTURE.read_text())["runs"]}


def outform_of(argv) -> str:
    return argv[argv.index("-o") + 1] if "-o" in argv else "text"


# ---------------------------------------------------------------------------
# comparing reports
# ---------------------------------------------------------------------------


def _last_json_line(text: str):
    return json.loads([line for line in text.splitlines() if line.strip()][-1])


def without_hotspot_seconds(exploration: dict) -> dict:
    """An exploration ledger's ``meta()`` or ``snapshot()`` with its solver
    hotspots as (point, queries) pairs sorted by point: their seconds, and
    the order by seconds, are timings."""
    exploration = dict(exploration)
    exploration["solver_hotspots"] = sorted(
        [h["point"], h["queries"]] for h in exploration["solver_hotspots"])
    return exploration


def _jsonv2_normalized(report: list, jax: bool) -> list:
    """A jsonv2 report without what may differ: the issues' discovery time,
    the execution info's wall times and calibration, the exploration
    ledger's hotspot seconds, the meta blocks in ``MEASURED_META`` and (JAX
    side) those in ``JAX_ONLY_META``, which must all be there."""
    report = copy.deepcopy(report)
    for entry in report:
        for issue in entry["issues"]:
            issue["extra"].pop("discoveryTime")
        meta = entry["meta"]
        dropped = MEASURED_META | (JAX_ONLY_META if jax else set())
        missing = dropped - set(meta)
        assert not missing, f"the {'JAX' if jax else 'port'} report lacks meta blocks {missing}"
        for key in dropped:
            meta.pop(key)
        if "exploration" in meta:
            meta["exploration"] = without_hotspot_seconds(meta["exploration"])
        info = meta.get("mythril_execution_info", {})
        info.pop("calibration", None)
        for key in WALL_FIELDS:
            info.pop(key, None)
        for key in FRONTIER_WALL_FIELDS:
            info.get("frontier", {}).pop(key, None)
    return report


def _paths(a, b, path="") -> list:
    """Where two JSON values differ (first few paths)."""
    if isinstance(a, dict) and isinstance(b, dict):
        out = [f"{path}/{k}: only in {'JAX' if k in a else 'port'}"
               for k in sorted(set(a) ^ set(b))]
        for k in sorted(set(a) & set(b)):
            out += _paths(a[k], b[k], f"{path}/{k}")
        return out
    if isinstance(a, list) and isinstance(b, list) and len(a) == len(b):
        return [d for i, (x, y) in enumerate(zip(a, b)) for d in _paths(x, y, f"{path}[{i}]")]
    return [] if a == b else [f"{path}: JAX {json.dumps(a)[:200]} port {json.dumps(b)[:200]}"]


def without_walls(value):
    """A static-pass report (``static -o json``, ``--staticpass-report``)
    without its ``wall_s`` fields."""
    if isinstance(value, dict):
        return {k: without_walls(v) for k, v in value.items() if k != "wall_s"}
    if isinstance(value, list):
        return [without_walls(v) for v in value]
    return value


def differences(outform: str, jax_out: str, port_out: str) -> list:
    """Where the port's CLI output differs from the JAX CLI's; [] when equal
    field by field up to the exceptions in the module docstring
    (``outform`` "static" for a static-pass JSON document)."""
    if outform == "static":
        return _paths(without_walls(json.loads(jax_out)), without_walls(json.loads(port_out)))[:10]
    if outform == "jsonv2":
        return _paths(_jsonv2_normalized(_last_json_line(jax_out), jax=True),
                      _jsonv2_normalized(_last_json_line(port_out), jax=False))[:10]
    if outform == "json":
        return _paths(_last_json_line(jax_out), _last_json_line(port_out))[:10]
    return [] if jax_out == port_out else [f"{outform} output differs"]


# ---------------------------------------------------------------------------
# running the port's CLI in process
# ---------------------------------------------------------------------------


def run_port(argv, device="cpu", with_stdout=False, calibrated=False):
    """One in-process run of the port's CLI as in a fresh process: every
    cache that carries state between analyses cleared, the statespace's node
    numbering from 1 -> (exit code, stdout, or for an export the file written
    in place of ``OUT``; with ``with_stdout`` the stdout after the file).
    ``device`` None passes no ``--device`` (the card).  The link calibration
    is held as the CPU recordings had it (``_torch_parity.port_uncalibrated``)
    unless ``calibrated``."""
    import tempfile

    from mythril_tpu_torch.core import cfg
    from mythril_tpu_torch.interfaces import cli
    from tests._torch_parity import _reset, port_uncalibrated

    _reset("mythril_tpu_torch")
    cfg.gbl_next_uid[0] = 0
    out = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "out")
        argv = [path if a == OUT else a for a in argv]
        with contextlib.redirect_stdout(out), (
                contextlib.nullcontext() if calibrated else port_uncalibrated()):
            rc = cli.main(argv + (["--device", device] if device else []))
        if path in argv:
            exported = Path(path).read_text()
            return (rc, exported, out.getvalue()) if with_stdout else (rc, exported)
    return rc, out.getvalue()


@pytest.fixture(autouse=True)
def _mythril_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("MYTHRIL_DIR", str(tmp_path / "mythril"))


def compare(run: dict, rc: int, out: str, stdout: Optional[str] = None) -> list:
    """Where a replay of ``run`` (exit code, output or exported file, and
    for ``--coverage-out`` the stdout beside the file) differs from the
    recorded JAX CLI run; [] when equal."""
    if rc != run["rc"]:
        return [f"exit {rc} != {run['rc']}"]
    if "--staticpass-report" in run["argv"]:
        return differences("static", run["file"], out)
    if "--coverage-out" in run["argv"]:
        return (_paths(without_hotspot_seconds(json.loads(run["file"])),
                       without_hotspot_seconds(json.loads(out)))[:10]
                + differences(outform_of(run["argv"]), run["stdout"], stdout))
    if OUT in run["argv"]:
        return [] if out == run["file"] else ["exported file differs"]
    if run["argv"][0] == "static" and outform_of(run["argv"]) == "json":
        return differences("static", run["stdout"], out)
    return differences(outform_of(run["argv"]), run["stdout"], out)


@pytest.mark.parametrize("name", SMALL)
def test_port_cli_equals_jax_cli(name):
    run = load_runs()[name]
    both = "--coverage-out" in run["argv"]
    rc, out, *stdout = run_port(port_argv(run), device=device_of(run), with_stdout=both)
    assert rc == run["rc"] == 0
    assert compare(run, rc, out, *stdout) == []
    if name.endswith(("/tiers", "/defaults")):
        assert tier_counter_differences(run) == []


def tier_counter_differences(run: dict) -> list:
    """Where the port's prefilter and devsolver counters after a run differ
    from the JAX report's ``prefilter`` and ``devsolver`` meta blocks."""
    from tests._torch_parity import tier_counters

    meta = _last_json_line(run["stdout"])[0]["meta"]
    got = tier_counters("mythril_tpu_torch")
    return [f"{tier}.{k}: JAX {meta[tier][k]} port {v}" for tier, counts in got.items()
            for k, v in counts.items() if meta[tier][k] != v]


def test_fixture_holds_the_runs_it_names():
    runs = load_runs()
    assert set(runs) == {r["name"] for r in recorded_runs()}
    pins = {r["name"]: r.get("pins", JAX_PINS) for r in recorded_runs()}
    assert all(r["rc"] == 0 and r["pins"] == pins[n] for n, r in runs.items())
    # the tier runs' JAX reports show both tiers at work
    for name in ("kill_simple/host/tiers", "etherstore_like/frontier-256/tiers"):
        meta = _last_json_line(runs[name]["stdout"])[0]["meta"]
        assert meta["prefilter"]["evaluated"] > 0 and meta["devsolver"]["admitted"] > 0
    # the defaults runs' reports show the static pass at work, the pinned
    # runs' show it off
    for name, run in runs.items():
        if outform_of(run["argv"]) != "jsonv2" or OUT in run["argv"]:
            continue
        meta = _last_json_line(run["stdout"])[0]["meta"]["staticpass"]
        assert (meta["contracts"] > 0) == name.endswith(
            ("/defaults", "/pipeline", "/coverage-target", "/auto")), name
    assert _last_json_line(runs["dead_code/frontier/defaults"]["stdout"])[0][
        "meta"]["staticpass"]["modules_skipped"]
    report = json.loads(runs["static/killbilly-creation/json"]["stdout"])
    assert [c["is_creation"] for c in report["contracts"][0]["codes"]] == [True]
    assert json.loads(runs["kill_simple/host/staticpass-report"]["file"])["contracts"]
    # kill_simple's exploit calls kill() at the last step
    for name in ("kill_simple/frontier-256", "kill_simple/host"):
        issues = _last_json_line(runs[name]["stdout"])[0]["issues"]
        steps = [i["extra"]["testCases"][0]["steps"] for i in issues if i["swcID"] == "SWC-106"]
        assert steps and steps[0][-1]["input"].startswith("0x41c0e1b5")


def test_differences_sees_a_changed_field():
    run = load_runs()["selfdestruct/host"]
    port = _last_json_line(run["stdout"])
    health = port[0]["meta"].pop("health")
    assert differences("jsonv2", run["stdout"], json.dumps(port)) != []  # a meta block missing
    port[0]["meta"]["health"] = health
    port[0]["issues"][0]["extra"]["discoveryTime"] += 1
    port[0]["meta"]["mythril_execution_info"]["solver_time_s"] += 1
    assert differences("jsonv2", run["stdout"], json.dumps(port)) == []
    port[0]["issues"][0]["extra"]["testCases"][0]["steps"][-1]["input"] = "0x00"
    assert differences("jsonv2", run["stdout"], json.dumps(port)) != []


# ---------------------------------------------------------------------------
# the parser
# ---------------------------------------------------------------------------


def _subcommands(parser) -> dict:
    action = next(a for a in parser._actions if a.dest == "command")
    return action.choices  # name and aliases -> subparser


def _options(subparser) -> dict:
    return {max(a.option_strings, key=len): a for a in subparser._actions
            if a.option_strings and a.dest != "help"}


def test_parser_keeps_the_jax_options_and_lists_what_it_lacks():
    from mythril_tpu.interfaces import cli as jax_cli
    from mythril_tpu_torch.interfaces import cli

    jax_subs, port_subs = _subcommands(jax_cli.create_parser()), _subcommands(cli.create_parser())
    missing_subs = set(jax_subs) - set(port_subs)
    assert set(port_subs) <= set(jax_subs)
    missing_opts = set()
    for name, port_sub in port_subs.items():
        jax_opts, port_opts = _options(jax_subs[name]), _options(port_sub)
        assert set(port_opts) - set(jax_opts) <= {"--device"}, name
        missing_opts |= set(jax_opts) - set(port_opts)
        for opt in set(jax_opts) & set(port_opts):
            j, p = jax_opts[opt], port_opts[opt]
            assert (p.dest, p.option_strings) == (j.dest, j.option_strings), (name, opt)
            if opt == "--probe-backend":  # the port's backends, "device" for "jax"
                assert set(p.choices) == set(j.choices) - {"jax"} | {"device"}
                assert j.default == p.default == "auto"
                continue
            assert (p.default, p.choices, p.type, p.nargs) == (j.default, j.choices, j.type,
                                                               j.nargs), (name, opt)
        if name in cli.ANALYSIS_COMMANDS:
            assert port_opts["--device"].default == "cuda"
    table = set(cli.NOT_YET_PORTED)
    assert {k for k in table if k.startswith("-") and " " not in k} == missing_opts
    assert {k for k in table if not k.startswith("-")} == missing_subs


def test_runs_without_switches_are_accepted_and_named(capsys, monkeypatch):
    """Every JAX switch that turns a default-on tier off is a real switch of
    the port since the device mesh was ported: ``--no-mesh`` parses into
    ``frontier_mesh = False`` (``--no-pipeline`` and ``--no-adaptive`` as
    before) and reaches ``args.frontier_mesh`` for the run, which ``main``
    restores; none is left to name, and ``analyze`` prints no line naming
    tiers it runs without."""
    from mythril_tpu_torch.facade import warm
    from mythril_tpu_torch.interfaces import cli
    from mythril_tpu_torch.support.support_args import args

    seen, apply = [], warm.apply_analyzer_args

    def recording(cmd_args):
        apply(cmd_args)
        seen.append(args.frontier_mesh)

    monkeypatch.setattr(warm, "apply_analyzer_args", recording)

    parsed = cli.create_parser().parse_args(
        ["analyze", "-c", "0x00", "--no-pipeline", "--no-adaptive", "--no-mesh"])
    assert (parsed.pipeline, parsed.adaptive, parsed.frontier_mesh) == (False, False, False)
    assert cli.create_parser().parse_args(["analyze", "-c", "0x00"]).frontier_mesh
    assert cli.RUNS_WITHOUT == {}
    capsys.readouterr()
    for extra in ([], ["--no-mesh"]):
        rc, out = run_port(CLEAN + extra)
        assert rc == 0 and json.loads(out)["success"]
        err = capsys.readouterr().err
        assert "runs without" not in err and "default tiers" not in err
    assert seen == [True, False] and args.frontier_mesh


# ---------------------------------------------------------------------------
# refusals and the missing card
# ---------------------------------------------------------------------------

CLEAN = ["analyze", "-c", "0x60006000f3", "--bin-runtime", "-t", "1", "-o", "json"]


@pytest.mark.parametrize("argv, item", [
    # the service's subcommands, refused until ROADMAP Queue A item 13 ported them
    (["submit", "-c", "0x60006000f3", "--port", "7396"], 13),
    (["health", "--port=7396"], 13),
    (["top", "--interval", "2", "--port", "7396"], 13),
    (["serve", "--port", "7396"], 13),
], ids=["value-option", "value-option-eq", "non-default-workers", "subcommand"])
def test_refused(argv, item, capsys, monkeypatch):
    """Nothing of the JAX command line is refused any more: the subcommands
    item 13 ported run.  With no service on the port, ``submit``, ``health``
    and ``top`` cannot reach it (exit 1); ``serve`` builds its service on the
    ``--device`` asked for."""
    from mythril_tpu_torch.interfaces import cli
    from mythril_tpu_torch.service import server

    assert item == 13 and not cli.NOT_YET_PORTED
    if argv[0] == "serve":
        seen = {}
        monkeypatch.setattr(server, "run_server",
                            lambda config, host, port: seen.update(config=config, port=port))
        assert cli.main(argv + ["--device", "cpu"]) == 0
        assert seen["port"] == 7396 and seen["config"].device == "cpu"
        assert seen["config"].frontier and seen["config"].probe and seen["config"].warmup
        return
    assert cli.main(argv) == 1
    captured = capsys.readouterr()
    assert "not ported yet" not in captured.err + captured.out


@pytest.mark.parametrize("backend", [None, "auto", "device", "host"])
def test_probe_backends_are_accepted_and_auto_is_the_default(backend, monkeypatch):
    """``--probe-backend auto`` is the port's default, as in the JAX
    package; on the CPU it probes on the host (no device dispatch), and
    the report carries no calibration block (nothing was measured)."""
    from mythril_tpu_torch.facade import warm
    from mythril_tpu_torch.interfaces import cli
    from mythril_tpu_torch.smt.solver import SolverStatistics

    seen = []
    real = warm.apply_analyzer_args
    monkeypatch.setattr(warm, "apply_analyzer_args",
                        lambda a: (seen.append(a.probe_backend), real(a)))
    assert cli.screen(CLEAN + (["--probe-backend", backend] if backend else [])) == (
        CLEAN + (["--probe-backend", backend] if backend else []))
    argv = ["analyze", "-c", KILL_SIMPLE.read_text().strip(), "--bin-runtime", "-t", "1",
            "-o", "jsonv2"] + (["--probe-backend", backend] if backend else [])
    rc, out = run_port(argv)
    assert rc == 0 and seen == [backend or "auto"]
    report = _last_json_line(out)
    assert "calibration" not in report[0]["meta"]["mythril_execution_info"]
    if (backend or "auto") in ("auto", "host"):
        assert SolverStatistics().device_dispatches == 0


def test_default_only_options_run_at_their_default():
    from mythril_tpu_torch.interfaces import cli

    workers = ["--harvest-workers", "4", "--solver-workers=2"]
    argv = CLEAN + workers + ["--heartbeat-interval", "0.50"]
    assert cli.screen(argv) == argv  # the worker counts and the period are real
    rc, out = run_port(argv)
    assert rc == 0 and json.loads(out)["issues"] == []


def test_pipeline_and_worker_switches_are_real():
    """``--no-pipeline``, ``--solver-workers`` and ``--harvest-workers`` (0:
    the serial harvest) reach the engine's flags at any value, and ``main``
    restores them."""
    from mythril_tpu_torch.facade import warm
    from mythril_tpu_torch.interfaces import cli
    from mythril_tpu_torch.support.support_args import args

    seen, apply = [], warm.apply_analyzer_args

    def recording(cmd_args):
        apply(cmd_args)
        seen.append((args.pipeline, args.solver_workers, args.harvest_workers))

    saved = (args.pipeline, args.solver_workers, args.harvest_workers)
    assert saved == (True, 2, 4)
    warm.apply_analyzer_args = recording
    try:
        for extra, want in ((["--solver-workers", "1", "--harvest-workers", "0"], (True, 1, 0)),
                            (["--no-pipeline", "--solver-workers=7"], (False, 7, 4)),
                            ([], (True, 2, 4))):
            assert cli.screen(CLEAN + extra) == CLEAN + extra
            rc, out = run_port(CLEAN + extra)
            assert rc == 0 and json.loads(out)["issues"] == []
            assert seen[-1] == want
            assert (args.pipeline, args.solver_workers, args.harvest_workers) == saved
    finally:
        warm.apply_analyzer_args = apply


def test_adaptive_switches_are_real(tmp_path):
    """The adaptive controller runs by default; ``--no-adaptive`` switches
    it off (no plan), ``--coverage-target=90`` is accepted and reaches the
    engine's flags, ``--coverage-out`` writes the exploration ledger; none
    is refused, and ``main`` restores the flags."""
    from mythril_tpu_torch.facade import warm
    from mythril_tpu_torch.interfaces import cli
    from mythril_tpu_torch.support.support_args import args
    from tests._torch_parity import adaptive_counters

    kill = ["analyze", "-c", KILL_SIMPLE.read_text().strip(), "--bin-runtime", "-t", "1",
            "-o", "json", "--frontier", "--frontier-force"]
    ledger = tmp_path / "coverage.json"
    real = ["--coverage-target=90", "--coverage-out", str(ledger)]
    assert cli.screen(kill + real + ["--no-adaptive"]) == kill + real + ["--no-adaptive"]
    assert not {"--coverage-target", "--coverage-out", "--no-adaptive"} & set(cli.NOT_YET_PORTED)
    seen, apply = [], warm.apply_analyzer_args

    def recording(cmd_args):
        apply(cmd_args)
        seen.append((args.adaptive, args.coverage_target))

    warm.apply_analyzer_args = recording
    try:
        for extra, want in ((real, (True, 90.0)), (["--no-adaptive"], (False, None))):
            rc, out = run_port(kill + extra)
            assert rc == 0 and len(json.loads(out)["issues"]) == 1
            assert seen[-1] == want
            plans = adaptive_counters("mythril_tpu_torch")["plans"]
            assert (plans > 0) == want[0]
    finally:
        warm.apply_analyzer_args = apply
    assert (args.adaptive, args.coverage_target) == (True, None)
    snap = json.loads(ledger.read_text())
    assert snap["partition_ok"] and snap["bitmaps"] and snap["terminated_total"] > 0


def test_prefilter_and_devsolver_switches_are_real(monkeypatch):
    """Both tiers run by default; ``--no-prefilter``, ``--no-devsolver`` and
    the devsolver's budgets reach the solver, and ``main`` restores them."""
    from mythril_tpu_torch import absdomain
    from mythril_tpu_torch.facade import warm
    from mythril_tpu_torch.interfaces import cli
    from mythril_tpu_torch.support.support_args import args

    real = ["--no-prefilter", "--no-devsolver", "--devsolver-bit-budget", "32",
            "--devsolver-iters=100"]
    assert cli.screen(CLEAN + real) == CLEAN + real
    assert not {"prefilter", "devsolver"} & set(cli.RUNS_WITHOUT)
    seen, apply = [], warm.apply_analyzer_args

    def recording(cmd_args):
        apply(cmd_args)
        seen.append((args.prefilter, args.devsolver, args.devsolver_bit_budget,
                     args.devsolver_iters))

    monkeypatch.setattr(warm, "apply_analyzer_args", recording)
    kill = ["analyze", "-c", KILL_SIMPLE.read_text().strip(), "--bin-runtime", "-t", "1",
            "-o", "json"]
    for extra in (real, []):
        rc, out = run_port(kill + extra)
        assert rc == 0 and len(json.loads(out)["issues"]) == 1
        # the counters of the run: the prefilter evaluated only when on
        assert (absdomain.evaluated > 0) == (not extra)
    assert seen == [(False, False, 32, 100), (True, True, 64, 2048)]
    assert (args.prefilter, args.devsolver, args.devsolver_bit_budget,
            args.devsolver_iters) == (True, True, 64, 2048)


def test_static_pass_and_query_cache_switches_are_real(tmp_path):
    """``analyze`` runs the static pass and the query cache by default;
    ``--no-staticpass``, ``--no-staticpass-interproc`` and
    ``--no-query-cache`` switch them off, ``--query-cache-dir`` adds the
    disk store and ``--staticpass-report`` writes the report; none is
    refused, and ``main`` restores the flags and the cache."""
    from mythril_tpu_torch import querycache, staticpass
    from mythril_tpu_torch.interfaces import cli
    from mythril_tpu_torch.querycache.cache import COUNTERS
    from mythril_tpu_torch.support.support_args import args

    kill = ["analyze", "-c", KILL_SIMPLE.read_text().strip(), "--bin-runtime", "-t", "1",
            "-o", "json"]
    report, qc_dir = tmp_path / "static.json", tmp_path / "qc"
    real = ["--staticpass-report", str(report), "--query-cache-dir", str(qc_dir)]
    assert cli.screen(kill + real) == kill + real
    static = ["static", "-c", "0x60006000f3", "--bin-runtime", "-o", "json"]
    assert cli.screen(static) == static
    assert not {"static", "--staticpass-report", "--query-cache-dir"} & set(cli.NOT_YET_PORTED)
    seen = []
    for extra in (real, ["--no-staticpass", "--no-query-cache"], ["--no-staticpass-interproc"]):
        rc, out = run_port(kill + extra)
        assert rc == 0 and len(json.loads(out)["issues"]) == 1
        seen.append((staticpass.COUNTERS.get("contracts", 0),
                     staticpass.COUNTERS.get("interproc_refined", 0), COUNTERS["lookups"] > 0))
    assert seen == [(1, 1, True), (0, 0, False), (1, 0, True)]
    written = json.loads(report.read_text())
    assert written["contracts"][0]["codes"][0]["interproc"] is True
    assert any(qc_dir.rglob("*.json"))
    assert (args.staticpass, args.staticpass_interproc, args.query_cache,
            args.query_cache_dir) == (True, True, True, None)
    qc = querycache.get_query_cache()
    assert qc.enabled and not qc.stats()["disk"]


def test_analyze_without_a_card_fails(monkeypatch, capsys):
    import torch

    from mythril_tpu_torch.interfaces import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(CLEAN) == 1
    out = json.loads(capsys.readouterr().out)
    assert out["success"] is False and out["error"].startswith("NoCudaDevice:")
    # --frontier on the CPU has no width limit to check
    rc, _ = run_port(CLEAN + ["--frontier", "--frontier-width", "100000"])
    assert rc == 0


def test_solidity_input_without_solc(tmp_path, monkeypatch):
    source = tmp_path / "A.sol"
    source.write_text("pragma solidity ^0.8.0;\ncontract A {}\n")
    monkeypatch.setenv("PATH", str(tmp_path))  # no solc on it
    rc, out = run_port(["analyze", str(source), "-o", "json"])
    assert rc == 1 and "Compiler not found: solc" in json.loads(out)["error"]


def test_main_restores_the_flags_it_wrote():
    from mythril_tpu_torch.support.support_args import args

    before = dict(vars(args))
    rc, _ = run_port(["safe-functions", "-c", "0x60006000f3", "--bin-runtime", "--frontier",
                      "--solver-timeout", "5000"])
    assert rc == 0 and dict(vars(args)) == before


# ---------------------------------------------------------------------------
# on-chain mode against a mocked JSON-RPC node
# ---------------------------------------------------------------------------

KILL_RUNTIME = "60003560e01c6341c0e1b51460145760006000fd5b33ff"
ADDR = "0x2222222222222222222222222222222222222222"


@pytest.fixture()
def node(monkeypatch):
    calls = []
    storage = {0: "0x" + "00" * 31 + "2a"}

    def handle(payload):
        method, params = payload["method"], payload.get("params", [])
        calls.append((method, params))
        if method == "eth_getCode":
            return "0x" + KILL_RUNTIME if params[0].lower() == ADDR else "0x"
        if method == "eth_getStorageAt":
            return storage.get(int(params[1], 16), "0x" + "00" * 32)
        if method == "eth_getBalance":
            return hex(10**18)
        raise ValueError(f"unexpected method {method}")

    def fake_urlopen(req, timeout=10):
        payload = json.loads(req.data.decode())
        body = json.dumps({"jsonrpc": "2.0", "id": payload["id"], "result": handle(payload)})
        return contextlib.closing(io.BytesIO(body.encode()))

    monkeypatch.setattr("mythril_tpu_torch.frontend.rpc._urlreq.urlopen", fake_urlopen)
    return calls


def test_read_storage_slot_and_mapping(node):
    from mythril_tpu_torch.ops.keccak import keccak256

    rc, out = run_port(["read-storage", ADDR, "0", "2", "--rpc", "localhost:8545"], device=None)
    assert rc == 0
    lines = out.splitlines()
    assert lines[0].startswith("0:") and lines[0].endswith("2a") and lines[1].startswith("1:")
    rc, out = run_port(["read-storage", ADDR, "mapping", "1", "5", "--rpc", "localhost:8545"],
                       device=None)
    slot = int(out.splitlines()[0].split(":")[0], 16)
    assert rc == 0 and slot == int.from_bytes(
        keccak256((5).to_bytes(32, "big") + (1).to_bytes(32, "big")), "big")
    assert [m for m, _ in node].count("eth_getStorageAt") == 3


def test_analyze_address_end_to_end(node):
    rc, out = run_port(["analyze", "-a", ADDR, "--rpc", "localhost:8545", "-t", "1",
                        "-m", "AccidentallyKillable", "-o", "jsonv2"])
    assert rc == 0
    issues = _last_json_line(out)[0]["issues"]
    assert [i["swcID"] for i in issues] == ["SWC-106"]
    assert issues[0]["extra"]["testCases"][0]["steps"][-1]["input"].startswith("0x41c0e1b5")
    assert ("eth_getCode", [ADDR, "latest"]) in node


# ---------------------------------------------------------------------------
# the facade: solver calls after the wrapper returns run on its device
# ---------------------------------------------------------------------------


def test_facade_solves_after_the_wrapper_on_its_device(monkeypatch):
    """A CPU analysis whose post pass (a POST detection module, run by
    ``fire_lasers`` after ``SymExecWrapper`` returned) reaches the solver
    through ``args.device``, with every CUDA resolution made to fail: the
    module must solve on the CPU, and the report must carry no exception."""
    import torch

    from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
    from mythril_tpu_torch.analysis.module.loader import ModuleLoader
    from mythril_tpu_torch.device import NoCudaDevice
    from mythril_tpu_torch.facade.mythril_analyzer import AnalyzerArgs, MythrilAnalyzer
    from mythril_tpu_torch.facade.mythril_disassembler import MythrilDisassembler
    from mythril_tpu_torch.smt import ULT, symbol_factory
    from mythril_tpu_torch.support.model import get_model
    from mythril_tpu_torch.support.support_args import args
    from tests._torch_parity import _reset

    class SolvesAfter(DetectionModule):
        name = "solves after the wrapper"
        entry_point = EntryPoint.POST
        seen = []

        def _execute(self, statespace):
            x = symbol_factory.BitVecSym("facade_x", 256)
            model = get_model([ULT(x, symbol_factory.BitVecVal(3, 256)),
                               ULT(symbol_factory.BitVecVal(1, 256), x)])
            self.seen.append((args.device, model.eval(x.raw)))
            return []

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _reset("mythril_tpu_torch")
    module = SolvesAfter()
    loader = ModuleLoader()
    loader.register_module(module)
    try:
        with pytest.raises(NoCudaDevice):
            module._execute(None)  # outside an analysis: the card, which is missing
        disassembler = MythrilDisassembler()
        disassembler.load_from_bytecode("0x60006000f3", bin_runtime=True)
        analyzer = MythrilAnalyzer(disassembler, AnalyzerArgs(transaction_count=1),
                                   device="cpu")
        report = analyzer.fire_lasers(modules=["SolvesAfter"])
    finally:
        loader._modules.remove(module)
    assert report.exceptions == []
    assert [(d.type, v) for d, v in SolvesAfter.seen] == [("cpu", 2)]
    assert args.device is None


def test_facade_fails_on_a_device_error(monkeypatch):
    """A device failure inside the wrapper fails the analysis instead of
    degrading to a partial report."""
    from mythril_tpu_torch.device import DeviceError
    from mythril_tpu_torch.facade import mythril_analyzer
    from mythril_tpu_torch.facade.mythril_analyzer import AnalyzerArgs, MythrilAnalyzer
    from mythril_tpu_torch.facade.mythril_disassembler import MythrilDisassembler

    def broken(*a, **kw):
        raise DeviceError("kernel did not launch")

    monkeypatch.setattr(mythril_analyzer, "SymExecWrapper", broken)
    disassembler = MythrilDisassembler()
    disassembler.load_from_bytecode("0x60006000f3", bin_runtime=True)
    analyzer = MythrilAnalyzer(disassembler, AnalyzerArgs(transaction_count=1), device="cpu")
    with pytest.raises(DeviceError):
        analyzer.fire_lasers()


# ---------------------------------------------------------------------------
# the command line as a user runs it (tests/integration/test_cli_integration.py)
# ---------------------------------------------------------------------------

DETECTORS = ["ArbitraryJump", "ArbitraryStorage", "ArbitraryDelegateCall", "PredictableVariables",
             "TxOrigin", "EtherThief", "Exceptions", "ExternalCalls", "IntegerArithmetics",
             "MultipleSends", "StateChangeAfterCall", "AccidentallyKillable", "UncheckedRetval",
             "UserAssertions"]


def _check_selfdestruct(out):
    issues = _last_json_line(out)[0]["issues"]
    assert len(issues) == 1 and issues[0]["swcID"] == "SWC-106"
    assert issues[0]["severity"] == "High"
    assert issues[0]["extra"]["testCases"][0]["steps"][-1]["input"].startswith("0x41c0e1b5")


@pytest.mark.parametrize("argv, check", [
    (["analyze", "-f", str(KILL_SIMPLE), "--bin-runtime", "-t", "1", "-m", "AccidentallyKillable",
      "-o", "jsonv2", "--device", "cpu"], _check_selfdestruct),
    (["analyze", "-c", "0x60006000f3", "--bin-runtime", "-t", "1", "-o", "json", "--device", "cpu"],
     lambda out: _last_json_line(out)["issues"] == [] or pytest.fail(out)),
    (["disassemble", "-c", "0x6001600101"],
     lambda out: ("PUSH1" in out and "ADD" in out) or pytest.fail(out)),
    (["list-detectors"], lambda out: all(n in out for n in DETECTORS) or pytest.fail(out)),
    (["function-to-hash", "transfer(address,uint256)"],
     lambda out: "0xa9059cbb" in out or pytest.fail(out)),
    (["version"], lambda out: out.strip() or pytest.fail("no version")),
    (["safe-functions", "-f", str(KILL_SIMPLE), "--bin-runtime", "--device", "cpu"],
     lambda out: "functions found to be safe" in out or pytest.fail(out)),
], ids=["analyze-jsonv2-selfdestruct", "analyze-clean", "disassemble", "list-detectors",
        "function-to-hash", "version", "safe-functions"])
def test_python_m_mythril_tpu_torch(argv, check, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""),
               MYTHRIL_DIR=str(tmp_path))
    proc = subprocess.run([sys.executable, "-m", "mythril_tpu_torch", *argv], capture_output=True,
                          text=True, timeout=300, env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-2000:]
    check(proc.stdout)


# ---------------------------------------------------------------------------
# recording the fixture
# ---------------------------------------------------------------------------


def _record(run: dict) -> dict:
    """One run of the JAX CLI in process (this is a fresh process with a
    fresh HOME): -> the run with the pins, exit code, stdout and seconds."""
    import tempfile
    import time

    home = tempfile.mkdtemp(prefix="jax-cli-home-")
    os.environ.update(HOME=home, MYTHRIL_DIR=os.path.join(home, ".mythril_tpu"),
                      JAX_PLATFORMS="cpu")
    sys.path.insert(0, str(REPO))
    from mythril_tpu.interfaces import cli as jax_cli

    path = os.path.join(home, "out")
    pins = run.get("pins", JAX_PINS)
    sys.argv = ["myth", *[path if a == OUT else a for a in run["argv"]], *pins]
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        try:
            jax_cli.main()
            rc = 0
        except SystemExit as e:
            rc = e.code or 0
    seconds = time.perf_counter() - t0
    exported = {"file": Path(path).read_text()} if OUT in run["argv"] else {}
    return {**run, "pins": pins, "rc": rc, "stdout": out.getvalue(),
            "jax_cpu_seconds": seconds, **exported}


def write_fixture(names) -> None:
    import multiprocessing
    import tempfile
    from concurrent.futures import ProcessPoolExecutor

    runs = [r for r in recorded_runs() if not names or r["name"] in names]
    old = load_runs() if FIXTURE.is_file() else {}
    os.environ["MYTHRIL_TPU_COMPILATION_CACHE"] = tempfile.mkdtemp(prefix="jax-cli-xla-")
    with ProcessPoolExecutor(4, mp_context=multiprocessing.get_context("spawn"),
                             max_tasks_per_child=1) as pool:
        for rec in pool.map(_record, runs):
            print(f"{rec['name']}: rc {rec['rc']}, {rec['jax_cpu_seconds']:.1f} s", flush=True)
            old[rec["name"]] = rec
    order = [r["name"] for r in recorded_runs()]
    FIXTURE.write_text(json.dumps({"runs": [old[n] for n in order if n in old]}, indent=1) + "\n")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--write"]:
        write_fixture(sys.argv[2:])
    else:
        print(__doc__)
