"""Detector gating: skip modules statically proven irrelevant.

Two over-approximate gates, both declared by the module itself
(analysis/module/base.py):

* occurrence gate — ``static_required_ops``: the module can only raise an
  issue when at least one of these opcodes occurs on a reachable
  instruction.  None disables the gate (custom/undeclared modules are
  never skipped).
* taint gate — ``static_taint_sources``/``static_taint_sinks``: the
  module only raises when a source's value influences a sink; skipped
  when no reachable source bit may_reach any declared sink.

The gate sees the contract's WHOLE static code set (creation + runtime)
through a GateView: a bit escalated in one code (it hit a global channel,
e.g. a constructor SSTORE) may reach sinks in every other code.  When any
executable code is statically unknown — dynloader active, creation-only
inputs, checkpoint resume — no view is built and nothing is pruned; that
self-disable is no longer silent: each occurrence increments
``staticpass.gate_disabled{reason=…}``, logs a WARN, and surfaces in
``meta.staticpass`` and `myth top`.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Tuple

from mythril_tpu_torch.staticpass.summary import (
    StaticSummary,
    publish_reachability,
    record_summary_metrics,
    summary_for_code,
)

log = logging.getLogger(__name__)

# gate_disabled reasons (the explicit --no-staticpass opt-out is not one:
# the user asked for that, the others are the gate protecting itself)
REASON_RESUME = "resume_from"
REASON_DYNLOADER = "dynloader_active"
REASON_CREATION_ONLY = "creation_only"
REASON_SUMMARY_UNAVAILABLE = "summary_unavailable"
REASON_EXCEPTION = "exception"


def _gate_disabled(reason: str, contract=None) -> None:
    """Count + WARN one self-disable of the static gate."""
    from mythril_tpu_torch.observability import get_registry

    get_registry().labeled_counter(
        "staticpass.gate_disabled", label_name="reason"
    ).inc(reason)
    log.warning(
        "static gate disabled for %s (reason=%s): nothing will be pruned",
        getattr(contract, "name", contract.__class__.__name__
                if contract is not None else "?"),
        reason,
    )


class GateView:
    """Union view over every code object a contract can execute."""

    def __init__(self, summaries: List[StaticSummary], contract_name: str = "?"):
        self.summaries = summaries
        self.contract_name = contract_name
        self.reachable_opcodes = frozenset().union(
            *(s.reachable_opcodes for s in summaries)
        ) if summaries else frozenset()
        self.skipped_modules: List[str] = []

    def taint_reach(self, bit: int) -> frozenset:
        reached = frozenset().union(
            *(s.taint_reach(bit) for s in self.summaries)
        ) if self.summaries else frozenset()
        if any(bit in s.escalated_bits for s in self.summaries):
            # an escalated bit crosses code boundaries (storage persists
            # between the constructor and every runtime tx)
            reached |= self.reachable_opcodes
        return reached


def module_relevant(module, view: GateView) -> bool:
    """Can ``module`` possibly raise an issue on this contract?"""
    required = getattr(module, "static_required_ops", None)
    if required is not None and not (view.reachable_opcodes & required):
        return False
    sources = getattr(module, "static_taint_sources", None)
    sinks = getattr(module, "static_taint_sinks", None)
    if sources and sinks:
        return any(
            src_op in view.reachable_opcodes and (view.taint_reach(bit) & sinks)
            for src_op, bit in sources.items()
        )
    return True


def filter_modules(modules: List, view: Optional[GateView]) -> Tuple[List, List]:
    """(kept, skipped) — identity when no view is available."""
    if view is None:
        return modules, []
    kept, skipped = [], []
    for m in modules:
        (kept if module_relevant(m, view) else skipped).append(m)
    if skipped:
        view.skipped_modules = sorted(type(m).__name__ for m in skipped)
        log.info(
            "static pass: skipping statically irrelevant modules for %s: %s",
            view.contract_name, ", ".join(view.skipped_modules),
        )
    return kept, skipped


def _register_code(code, summary: Optional[StaticSummary],
                   name: str, address=None) -> None:
    """Cross-cutting observe-only registrations for one summarized code:
    the exploration ledger's reachable denominator and the static call
    graph node."""
    if summary is None:
        return
    publish_reachability(code, summary)
    try:
        from mythril_tpu_torch.staticpass.callgraph import get_callgraph
        from mythril_tpu_torch.support.support_utils import get_code_hash

        bytecode = getattr(code, "bytecode", None) or b""
        hex_code = bytes(bytecode).hex() if isinstance(
            bytecode, (bytes, bytearray)) else bytecode
        get_callgraph().register(
            get_code_hash(hex_code), name=name, address=address,
            function_map=summary.function_map,
        )
    except Exception as e:  # observe-only: never fatal
        log.debug("call graph registration failed: %s", e)


def summarize_contract(contract) -> Optional[GateView]:
    """Summarize every code object a contract carries and record the
    view for reporting — with NO gating-eligibility checks.  `myth
    static` uses this: a creation-only input (where the gate rightly
    refuses to prune) is still worth static analysis on its own.
    Returns None when no code produced a summary."""
    name = getattr(contract, "name", "Unknown")
    address = getattr(contract, "address", None)
    summaries: List[StaticSummary] = []
    runtime = getattr(contract, "disassembly", None)
    creation = getattr(contract, "creation_disassembly", None)
    if runtime is not None:
        s = summary_for_code(runtime)
        if s is not None:
            summaries.append(s)
            _register_code(runtime, s, name=name, address=address)
    if creation is not None:
        s = summary_for_code(creation, is_creation=True)
        if s is not None:
            summaries.append(s)
            _register_code(creation, s, name=f"{name}:creation")
    if not summaries:
        return None
    for s in summaries:
        record_summary_metrics(s)
    view = GateView(summaries, contract_name=name)
    from mythril_tpu_torch.staticpass import report as sp_report

    sp_report.record_view(view)
    return view


def gate_view_for_contract(contract, dynloader=None,
                           resume_from=None) -> Optional[GateView]:
    """Build the gating view for one contract, or None when the full
    executable code set is not statically known (then nothing is gated)."""
    from mythril_tpu_torch.support.support_args import args

    if not getattr(args, "staticpass", True):
        return None  # explicit opt-out, not a self-disable
    if resume_from:
        # restored states may sit mid-flow past a gate point
        _gate_disabled(REASON_RESUME, contract)
        return None
    if dynloader is not None and getattr(dynloader, "active", False):
        # on-chain code loading: other bytecode can run
        _gate_disabled(REASON_DYNLOADER, contract)
        return None
    try:
        summaries: List[StaticSummary] = []
        name = getattr(contract, "name", "Unknown")
        address = getattr(contract, "address", None)
        if isinstance(contract, (bytes, bytearray)):
            from mythril_tpu_torch.frontend.disassembler import Disassembly

            code = Disassembly(bytes(contract))
            s = summary_for_code(code)
            summaries.append(s)
            _register_code(code, s, name="bytecode", address=None)
        else:
            runtime = getattr(contract, "disassembly", None)
            creation = getattr(contract, "creation_disassembly", None)
            if creation is not None and runtime is None:
                # creation-only input: the deployed runtime code is the
                # creation tx's return value, not statically available
                _gate_disabled(REASON_CREATION_ONLY, contract)
                return None
            if runtime is not None:
                s = summary_for_code(runtime)
                summaries.append(s)
                _register_code(runtime, s, name=name, address=address)
            if creation is not None:
                s = summary_for_code(creation, is_creation=True)
                summaries.append(s)
                _register_code(creation, s, name=f"{name}:creation")
        if not summaries or any(s is None for s in summaries):
            _gate_disabled(REASON_SUMMARY_UNAVAILABLE, contract)
            return None
        for s in summaries:
            record_summary_metrics(s)
        view = GateView(summaries, contract_name=name)
        from mythril_tpu_torch.staticpass import report as sp_report

        sp_report.record_view(view)
        return view
    except Exception as e:  # never fatal: analysis continues ungated
        log.warning("static gate unavailable for this contract: %s", e)
        _gate_disabled(REASON_EXCEPTION, contract)
        return None
