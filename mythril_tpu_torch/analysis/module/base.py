"""DetectionModule base class.

Reference parity: mythril/analysis/module/base.py:20-116 — CALLBACK (per-state
hook) vs POST (whole statespace) entry points, pre/post opcode hook lists, and
the (address, bytecode-hash) issue cache that stops re-analysis of already
flagged program points.
"""

from __future__ import annotations

import logging
from contextlib import contextmanager
from enum import Enum
from types import MappingProxyType
from typing import List, Mapping, Optional, Set, Tuple

from mythril_tpu_torch.analysis.report import Issue
from mythril_tpu_torch.core.state.global_state import GlobalState
from mythril_tpu_torch.observability import tracer as _otrace

log = logging.getLogger(__name__)

# Optional process-wide issue sink: called with each freshly confirmed issue
# list the moment a module's execute() accepts it, BEFORE end-of-run
# collection.  The service daemon installs one to stream issues per request
# as they confirm; one-shot runs leave it None (a single global load + None
# check on the hot path).  Installed/removed only between runs from the
# thread that owns the analysis, so no lock is needed.
_ISSUE_SINK = None


def set_issue_sink(sink):
    """Install ``sink(issues: List[Issue]) -> None`` as the confirmation
    tap; returns the previous sink so callers can restore it.  Sink errors
    are swallowed (streaming must never fail an analysis)."""
    global _ISSUE_SINK
    prev = _ISSUE_SINK
    _ISSUE_SINK = sink
    return prev


@contextmanager
def issue_sink_scope(sink):
    """Scoped form of ``set_issue_sink``: install ``sink`` for the body
    and restore the previous sink on exit.  The explicit-context entry
    point (``facade.warm.WorkerContext``) uses this so the sink's
    lifetime is structurally tied to the analysis that owns it."""
    prev = set_issue_sink(sink)
    try:
        yield sink
    finally:
        set_issue_sink(prev)


class EntryPoint(Enum):
    POST = 1
    CALLBACK = 2


class DetectionModule:
    name = "detection module"
    swc_id = ""
    description = ""
    entry_point = EntryPoint.CALLBACK
    pre_hooks: List[str] = []
    post_hooks: List[str] = []
    # opcodes whose hook is provably a NO-OP when every popped operand is a
    # concrete value: the device frontier evaluates that predicate per event
    # (operand concreteness is a device-resident bit) and suppresses the
    # event entirely — the batched probe-then-confirm form of the hook
    # (SURVEY.md §7.2 item 7).  Declare ONLY when _execute provably returns
    # without observable effect for all-concrete operands.
    concrete_nop_hooks: frozenset = frozenset()
    # taint-source hooks: opcode -> frontier taint bit.  Declares that this
    # module's hook on the opcode does nothing but annotate the pushed
    # result with the annotation class registered for the bit
    # (frontier/taint.py) — the arena row graph reproduces that dataflow
    # exactly, so the device emits NO event for the opcode at all (the
    # engine seeds the bit on the source's env row and the walker
    # synthesizes the annotation at sinks from the row's taint closure).
    # Declare ONLY for hooks whose sole observable effect is that
    # annotation.  (Immutable default: a mutation would otherwise write
    # into a dict shared by every module class.)
    taint_source_hooks: Mapping[str, int] = MappingProxyType({})
    # value-gated hooks: the hook on this opcode is provably a NO-OP unless
    # the value operand is CONCRETE with the solc Panic(uint256) selector
    # in its top 32 bits (UserAssertions' MSTORE check — symbolic values
    # no-op there too, value.value is None).  The device then events only
    # those stores — memory writes are the densest op class in solc
    # output, and carrier memory is rebuilt from the device word table at
    # terminals/parks instead of per-write replay.
    value_gated_hooks: frozenset = frozenset()
    # -- static-pass gating declarations (mythril_tpu_torch/staticpass/gate) ----
    # Over-approximate CLAIMS about when the module can raise an issue;
    # the static pre-analysis skips a module (and never registers its
    # hooks) when a claim is statically refuted for a contract.  Declare
    # conservatively: a wrong claim silently disables the detector.
    #
    # any-of occurrence: the module can only raise when at least one of
    # these opcodes occurs on a statically reachable instruction.  None
    # disables the gate (undeclared/custom modules are never skipped).
    static_required_ops: Optional[frozenset] = None
    # taint flow: the module only raises when a source opcode's value
    # (carrying the mapped frontier/taint bit) may influence a sink
    # opcode.  Skipped when no reachable source may_reach any sink.
    # Both must be declared for the gate to apply.
    static_taint_sources: Mapping[str, int] = MappingProxyType({})
    static_taint_sinks: frozenset = frozenset()

    def __init__(self):
        self.issues: List[Issue] = []
        self.cache: Set[Tuple[int, str]] = set()

    def reset_module(self) -> None:
        self.issues = []

    def update_cache(self, issues: Optional[List[Issue]] = None) -> None:
        issues = issues if issues is not None else self.issues
        for issue in issues:
            self.cache.add((issue.address, issue.bytecode_hash))

    def _cache_key(self, state: GlobalState) -> Tuple[int, str]:
        # local import breaks the potential_issues <-> base cycle; memoized
        # because hooks consult the cache once per hooked opcode per state
        from mythril_tpu_torch.analysis.potential_issues import get_bytecode_hash

        address = state.get_current_instruction()["address"]
        code_hash = get_bytecode_hash(state.environment.code.bytecode)
        return address, code_hash

    def execute(self, target) -> Optional[List[Issue]]:
        """Entry point called by the engine hook or fire_lasers.

        This runs once per hooked opcode per state, so the tracing hook
        must stay one attribute check when the tracer is disabled.
        """
        log.debug("entering module %s", type(self).__name__)
        if not _otrace.get_tracer().enabled:
            result = self._execute(target)
        else:
            with _otrace.span(
                "module." + type(self).__name__, cat="analysis"
            ) as sp:
                result = self._execute(target)
                if result:
                    sp.set(issues=len(result))
        if result:
            self.issues.extend(result)
            self.update_cache(result)
            if _ISSUE_SINK is not None:
                try:
                    _ISSUE_SINK(result)
                except Exception:
                    log.exception("issue sink failed; analysis continues")
        return result

    def _execute(self, target) -> Optional[List[Issue]]:
        raise NotImplementedError

    def __repr__(self):
        return f"<{type(self).__name__} swc={self.swc_id}>"
