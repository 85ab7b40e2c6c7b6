#!/usr/bin/env python3
"""Copy the JAX package's host modules into the port, imports renamed.

Most of the analysis engine is host Python that touches no device: the
state classes, the detection modules, the plugins.  The port keeps its own
copies of them under the same relative paths (it imports nothing of
``mythril_tpu``).  ``COPIED`` lists the modules whose copy differs from the
original only by the package name (``mythril_tpu`` -> ``mythril_tpu_torch``
in imports, comments and strings), and the C++ sources of ``native/src/``,
which are copied byte for byte.  ``EDITED`` lists copies that differ by
the package name and by the named top-level functions, classes or methods
(``Class.method``), which are the port's own (the rewrite keeps them; the
check compares everything else).  ``SUBSTITUTED`` lists literal rewrites of
a copy's prose (docstrings and comments that name the JAX package's
runtime), applied before the check.  ``OUTSIDE`` lists copies of files
outside the JAX package (the port's test helpers), compared the same way
with the package name renamed.  Every other port module of the engine is
edited by hand.

    python3 scripts/torch_port_copy.py            # (re)write the copies
    python3 scripts/torch_port_copy.py --check    # exit 1 if a copy drifted
"""

from __future__ import annotations

import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "mythril_tpu"
DST = ROOT / "mythril_tpu_torch"

COPIED = (
    "support/support_utils.py",
    "support/time_handler.py",
    "core/__init__.py",
    "core/util.py",
    "core/evm_exceptions.py",
    "core/instruction_data.py",
    "core/cfg.py",
    "core/natives.py",
    "core/call.py",
    "core/instructions.py",
    "core/state/__init__.py",
    "core/state/annotation.py",
    "core/state/account.py",
    "core/state/calldata.py",
    "core/state/environment.py",
    "core/state/machine_state.py",
    "core/state/memory.py",
    "core/state/world_state.py",
    "core/state/global_state.py",
    "core/transaction/__init__.py",
    "core/transaction/transaction_models.py",
    "core/transaction/symbolic.py",
    "core/strategy/__init__.py",
    "core/strategy/basic.py",
    "core/strategy/extensions/__init__.py",
    "core/strategy/extensions/bounded_loops.py",
    "frontend/__init__.py",
    "frontend/disassembler.py",
    "plugins/__init__.py",
    "plugins/signals.py",
    "plugins/interface.py",
    "plugins/loader.py",
    "plugins/plugin_annotations.py",
    "plugins/plugins/__init__.py",
    "plugins/plugins/call_depth_limiter.py",
    "analysis/__init__.py",
    "analysis/swc_data.py",
    "analysis/issue_annotation.py",
    "analysis/ops.py",
    "analysis/module/__init__.py",
    "analysis/module/util.py",
    "analysis/module/modules/__init__.py",
    "analysis/module/modules/arbitrary_jump.py",
    "analysis/module/modules/arbitrary_write.py",
    "analysis/module/modules/delegatecall.py",
    "analysis/module/modules/dependence_on_origin.py",
    "analysis/module/modules/dependence_on_predictable_vars.py",
    "analysis/module/modules/ether_thief.py",
    "analysis/module/modules/exceptions.py",
    "analysis/module/modules/external_calls.py",
    "analysis/module/modules/integer.py",
    "analysis/module/modules/multiple_sends.py",
    "analysis/module/modules/state_change_external_calls.py",
    "analysis/module/modules/suicide.py",
    "analysis/module/modules/unchecked_retval.py",
    "analysis/module/modules/user_assertions.py",
    "analysis/potential_issues.py",
    "frontier/records.py",
    "frontier/taint.py",
    "frontier/walker.py",
    "native/keccak.py",
    "native/bitblast.py",
    "native/src/bitblast.cpp",
    "native/src/keccak.cpp",
    "frontend/rpc.py",
    "support/loader.py",
    "frontend/evmcontract.py",
    "frontend/soliditycontract.py",
    "facade/__init__.py",
    "facade/mythril_config.py",
    "facade/mythril_disassembler.py",
    "analysis/traceexplore.py",
    "analysis/callgraph.py",
    "plugin/__init__.py",
    "plugin/interface.py",
    "plugin/discovery.py",
    "plugin/loader.py",
    "interfaces/__init__.py",
    "interfaces/epic.py",
    "absdomain/tape.py",
    "devsolver/blaster.py",
    "staticpass/errors.py",
    "staticpass/tables.py",
    "staticpass/cfg.py",
    "staticpass/stackheight.py",
    "staticpass/taintflow.py",
    "staticpass/interproc.py",
    "staticpass/functions.py",
    "staticpass/callgraph.py",
    "querycache/canon.py",
    "querycache/store.py",
    "querycache/__init__.py",
    "observability/metrics.py",
    "adaptive/plan.py",
    "adaptive/controller.py",
    "plugins/plugins/coverage.py",
    "concolic/__init__.py",
    "concolic/concrete_data.py",
    "core/strategy/concolic.py",
    "core/transaction/concolic.py",
    "plugins/plugins/benchmark.py",
    "staticpass/summary.py",
    "staticpass/gate.py",
    "staticpass/report.py",
    "analysis/module/loader.py",
    "frontier/code.py",
    "support/checkpoint.py",
    "observability/heartbeat.py",
    "observability/history.py",
    "observability/watchtower.py",
    "observability/drift.py",
    "analysis/module/base.py",
    "service/codehash.py",
    "service/request.py",
    "service/scheduling.py",
    "service/admission.py",
    "service/resultstore.py",
    "service/telemetry.py",
    "service/pool.py",
    "service/client.py",
    "service/top.py",
    "service/__init__.py",
    "observability/fleet.py",
)

# copies whose named top-level functions are the port's own: module ->
# (function, ...), each one's difference stated in its docstring
EDITED = {
    # torch.profiler.record_function in place of jax.profiler.TraceAnnotation
    "observability/tracer.py": ("device_annotation",),
    # the bundle carries the device plane's device_meta() beside the metrics
    "observability/flightrecorder.py": ("build_bundle",),
    # the batch's device on each batch and probe; a device fault is never
    # isolated, and a worker that hit one answers its batch and exits
    "service/worker.py": ("worker_config", "_make_context", "_run_job",
                          "_run_profile", "worker_main"),
    # ServiceConfig.device; a device fault errors the inline batch and
    # stops the service; a pool worker's fault errors its batch
    "service/daemon.py": ("ServiceConfig", "AnalysisService.__init__",
                          "AnalysisService._configure_process",
                          "AnalysisService._warmup",
                          "AnalysisService._worker_loop",
                          "AnalysisService._run_batch",
                          "AnalysisService._probe",
                          "AnalysisService._on_worker_event"),
    # serve returns non-zero when a device fault stopped the service
    "service/server.py": ("run_server",),
    # the shard identity from torch.distributed's rank and world size; a
    # device fault stops the sweep
    "parallel/corpus.py": ("shard_identity", "run_corpus"),
}

# literal rewrites of a copy's prose: module -> ((JAX text, port text), ...)
_PROFILER = ("``jax.profiler``", "``torch.profiler``")
SUBSTITUTED = {
    "service/__init__.py": (("re-pays XLA compilation", "re-pays its kernel builds"),),
    "service/client.py": (_PROFILER,),
    "service/server.py": (_PROFILER,),
    "service/resultstore.py": (("XLA compile cache", "kernel build cache"),),
    "service/worker.py": (
        ("hold a live JAX runtime", "hold a live CUDA context"),
        ("the XLA compile cache", "the kernel build cache"),
        ("# windowed jax.profiler", "# windowed torch.profiler"),
        ("""    ("profiled", worker_id, profile_id, result_dict)
""", """    ("profiled", worker_id, profile_id, result_dict)
    ("device_fault", worker_id, job_id, payload)   # the done keys; exits
"""),
    ),
    "service/daemon.py": (
        ("XLA compile cache", "kernel build cache"),
        ("compiled XLA programs", "built kernel libraries"),
        ("a cold XLA bucket compile", "a cold kernel build"),
        _PROFILER,
    ),
    "observability/fleet.py": (
        ("PR 12 moved analysis", "The worker pool moved analysis"),
        ("XLA-facing totals", "device-facing totals"),
    ),
    "service/scheduling.py": (("PR 9's tenant accounting", "The tenant accounting"),),
    "parallel/corpus.py": (
        ("ICI carries", "the mesh carries"),
        ("""shard identity comes from the JAX
distributed runtime when initialized, or from""", """shard identity comes from
``torch.distributed`` (rank and world size) once its process group is
initialised, or from"""),
        ("""from typing import Callable, List, Optional, Sequence, Tuple
""", """from typing import Callable, List, Optional, Sequence, Tuple

from mythril_tpu_torch.device import is_device_fault
"""),
    ),
}

# copies of files outside the JAX package: the port's path -> the original's,
# both relative to the repo's root
OUTSIDE = {
    # bench_contracts.py's assembler and builders, hashing selectors with
    # the port's keccak (chip_smoke.py loads nothing of the JAX package)
    "tests/_torch_contracts.py": "bench_contracts.py",
}

_NAME = re.compile(r"\bmythril_tpu(?!_torch)\b")


def ported(rel: str) -> str:
    """The port's text of one JAX module: the package name renamed in
    Python, the C++ sources unchanged, and the functions ``EDITED`` names
    taken from the port's file."""
    text = (SRC / rel).read_text()
    if not rel.endswith(".py"):
        return text
    text = _NAME.sub("mythril_tpu_torch", text)
    for old, new in SUBSTITUTED.get(rel, ()):
        if old not in text:
            raise SystemExit(f"{rel}: no {old!r} to rewrite")
        text = text.replace(old, new)
    for name in EDITED.get(rel, ()):
        own = (DST / rel).read_text()
        text = text.replace(_function(text, name), _function(own, name))
    return text


def _function(text: str, name: str) -> str:
    """The source of the top-level function or class ``name``, or of the
    method ``Class.method``: its ``def``/``class`` line (and decorators) up
    to the next statement at its own indentation or less, trailing blank
    and comment lines left out."""
    indent = ""
    if "." in name:
        cls, name = name.split(".")
        start = re.search(rf"^class {cls}\b", text, re.M)
        if start is None:
            raise SystemExit(f"no top-level class {cls}")
        indent, pos = "    ", start.end()
    else:
        pos = 0
    match = re.compile(
        rf"^((?:{indent}@.*\n)*){indent}(?:def|class) {name}\b", re.M
    ).search(text, pos)
    if match is None:
        raise SystemExit(f"no definition of {name}")
    # the body starts after the signature's closing colon
    body = re.compile(r":[ \t]*(?:#.*)?\n").search(text, match.end())
    end = re.compile(rf"^(?:{indent})?(?=[^\s#])", re.M).search(
        text, body.end())
    lines = text[match.start(): end.start() if end else len(text)].split("\n")
    # the comments and blank lines before the next statement are not its
    while lines and (not lines[-1].strip() or lines[-1].lstrip().startswith("#")):
        lines.pop()
    return "\n".join(lines) + "\n"


def main(argv) -> int:
    check = "--check" in argv
    drifted = []
    for rel in (*COPIED, *EDITED):
        text, dst = ported(rel), DST / rel
        if check:
            if not dst.is_file() or dst.read_text() != text:
                drifted.append(rel)
            continue
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_text(text)
    for rel, original in OUTSIDE.items():
        text, dst = _NAME.sub("mythril_tpu_torch", (ROOT / original).read_text()), ROOT / rel
        if check:
            if not dst.is_file() or dst.read_text() != text:
                drifted.append(rel)
            continue
        dst.write_text(text)
    if drifted:
        print("drifted from the JAX package:", *drifted, sep="\n  ")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
