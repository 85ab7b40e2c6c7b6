"""Static bytecode pre-analysis (once per contract, before any execution).

Three vectorized passes over the decoded instruction stream — the same
flat tables ``frontier/code.py`` builds its device dispatch from:

1. **CFG recovery** (:mod:`cfg`): basic blocks, static resolution of
   PUSH-then-JUMP/JUMPI targets via a bounded abstract constant stack,
   reachability from entry, unreachable-code spans.
2. **Abstract stack height** (:mod:`stackheight`): per-block max-entry-
   height fixpoint; a statically guaranteed underflow marks the rest of
   the block (and its edges) dead.
3. **Static taint reachability** (:mod:`taintflow`): per
   ``frontier/taint.py`` source bit, the set of opcodes its value may
   influence (``may_reach``), with global-channel escalation for flows
   the CFG cannot order (storage, calls, creation returns).

On top of the base passes sits the INTERPROCEDURAL layer:

4. **Value-set refinement** (:mod:`interproc`): a bounded fixpoint of a
   value-set abstract interpreter over the whole frame resolves jump
   destinations the per-block fold cannot, prunes JUMPI edges whose
   condition folds constant, and leaves converged abstract stacks at
   every block entry.  Falls back to the base CFG on budget exhaustion
   or any invariant trip (``staticpass.interproc_fallback``).
5. **Function recovery** (:mod:`functions`): the solc selector-dispatch
   idiom (PUSH4/EQ/JUMPI ladders, GT/LT splits, the CALLDATASIZE
   fallback guard) partitions the CFG into per-function regions keyed
   by 4-byte selector, each summarized (storage read/write key sets,
   constant-folded call sites, CALLER guards, SELFDESTRUCT/DELEGATECALL
   reachability) and ranked into interesting points.  Degrades to "one
   function: the whole contract" on anything non-idiomatic.
6. **Cross-contract call graph** (:mod:`callgraph`): constant call
   targets link code objects into a process-wide static call graph.

Everything is OVER-approximate: a may_reach miss or a reachable
instruction marked dead is impossible by construction, so issue sets are
identical with and without the pass (asserted in tests and by
``bench.py --staticpass-compare``).  Consumers:

* ``analysis/module/loader.py`` skips statically irrelevant detectors,
* ``analysis/symbolic.py`` never registers their hooks (hooks elided),
* ``frontier/engine.py`` / ``frontier/code.py`` clear event bits on
  unreachable instructions, skip their loop slots, and export statically
  resolved jump targets,
* ``observability/exploration.py`` consumes the reachable-edge oracle as
  the corrected coverage denominator (``coverage_pct_reachable``),
* ``--staticpass-report`` / `myth static` / ``meta.staticpass`` dump the
  CFG/taint/function/call-graph summary as JSON, and the ``staticpass.*``
  counters flow through the observability registry into report meta,
  ``--metrics-out`` and bench JSON.

``--no-staticpass`` (args.staticpass = False) disables all of it;
``--no-staticpass-interproc`` keeps the base passes but disables the
interprocedural layer.  Invariants in this package raise typed errors
from :mod:`errors` (never bare ``assert`` — enforced by ruff S101).

The port's copy of ``mythril_tpu/staticpass`` (numpy only, no device
program) adds ``COUNTERS`` (a view of the ``staticpass.*`` registry
counters by name without the prefix), ``GATE_DISABLED`` (a view of the
``staticpass.gate_disabled{reason}`` labeled counter) and
``reset_counters``.
"""

from mythril_tpu_torch.staticpass.callgraph import (  # noqa: F401
    StaticCallGraph,
    get_callgraph,
)
from mythril_tpu_torch.staticpass.errors import (  # noqa: F401
    StaticInvariantError,
    StaticPassError,
)
from mythril_tpu_torch.staticpass.functions import (  # noqa: F401
    FunctionMap,
    StaticFunction,
    interesting_points,
    recover_functions,
)
from mythril_tpu_torch.staticpass.gate import (  # noqa: F401
    GateView,
    filter_modules,
    gate_view_for_contract,
    module_relevant,
    summarize_contract,
)
from mythril_tpu_torch.staticpass.interproc import (  # noqa: F401
    RefinedFlow,
    refine,
)
from mythril_tpu_torch.staticpass.report import (  # noqa: F401
    export_report,
    report_dict,
    reset_views,
    staticpass_meta,
)
from mythril_tpu_torch.staticpass.summary import (  # noqa: F401
    StaticSummary,
    clear_cache,
    publish_reachability,
    record_summary_metrics,
    summarize,
    summary_for_code,
)

from mythril_tpu_torch.observability import views as _views  # noqa: E402

COUNTERS = _views.CounterView("staticpass.")
GATE_DISABLED = _views.LabeledView("staticpass.gate_disabled")


def reset_counters() -> None:
    from mythril_tpu_torch.observability.metrics import get_registry

    get_registry().reset(prefix="staticpass.")
