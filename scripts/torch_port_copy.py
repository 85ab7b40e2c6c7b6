#!/usr/bin/env python3
"""Copy the JAX package's host modules into the port, imports renamed.

Most of the analysis engine is host Python that touches no device: the
state classes, the detection modules, the plugins.  The port keeps its own
copies of them under the same relative paths (it imports nothing of
``mythril_tpu``).  ``COPIED`` lists the modules whose copy differs from the
original only by the package name (``mythril_tpu`` -> ``mythril_tpu_torch``
in imports, comments and strings), and the C++ sources of ``native/src/``,
which are copied byte for byte.  ``EDITED`` lists copies that differ by
the package name and by the named top-level functions, which are the
port's own (the rewrite keeps them; the check compares everything else).
Every other port module of the engine is edited by hand.

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
)

# copies whose named top-level functions are the port's own: module ->
# (function, ...), each one's difference stated in its docstring
EDITED = {
    # torch.profiler.record_function in place of jax.profiler.TraceAnnotation
    "observability/tracer.py": ("device_annotation",),
    # the bundle carries the device plane's device_meta() beside the metrics
    "observability/flightrecorder.py": ("build_bundle",),
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
    for name in EDITED.get(rel, ()):
        own = (DST / rel).read_text()
        text = text.replace(_function(text, name), _function(own, name))
    return text


def _function(text: str, name: str) -> str:
    """The source of the top-level function ``name``: its ``def`` line up to
    the next top-level statement, trailing blank lines left out."""
    match = re.search(rf"^def {name}\(", text, re.M)
    if match is None:
        raise SystemExit(f"no top-level function {name}")
    end = re.compile(r"^[^\s#]", re.M).search(text, match.end())
    block = text[match.start(): end.start() if end else len(text)]
    return block.rstrip("\n") + "\n"


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
    if drifted:
        print("drifted from the JAX package:", *drifted, sep="\n  ")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
