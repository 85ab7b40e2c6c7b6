"""PredictableVariables: control flow depends on predictable block values
(SWC-116 timestamp/number, SWC-120 weak randomness from blockhash/coinbase).

Reference parity: mythril/analysis/module/modules/dependence_on_predictable_vars.py:1-195.
"""

from __future__ import annotations

from typing import List, Optional

from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.analysis.report import Issue
from mythril_tpu_torch.analysis.solver import get_transaction_sequence
from mythril_tpu_torch.analysis.swc_data import TIMESTAMP_DEPENDENCE, WEAK_RANDOMNESS
from mythril_tpu_torch.core.state.global_state import GlobalState
from mythril_tpu_torch.exceptions import UnsatError
from mythril_tpu_torch.frontier import taint

DESCRIPTION = (
    "Check whether important control flow decisions are influenced by block.coinbase, "
    "block.gaslimit, block.timestamp or block.number."
)

PREDICTABLE_OPS = ["COINBASE", "GASLIMIT", "TIMESTAMP", "NUMBER"]


class PredictableValueAnnotation:
    def __init__(self, operation: str, add_constraints=None):
        self.operation = operation
        self.add_constraints = add_constraints or []


class PredictablePathAnnotation:
    def __init__(self, operation: str, location: int):
        self.operation = operation
        self.location = location


# one taint bit per predictable source: the operation name feeds both the
# issue text and the SWC id split (coinbase/blockhash -> weak randomness),
# so the bit must round-trip to the exact operation
_TAINT_OPS = {
    "TIMESTAMP": (taint.TAINT_TIMESTAMP, "block.timestamp"),
    "NUMBER": (taint.TAINT_NUMBER, "block.number"),
    "COINBASE": (taint.TAINT_COINBASE, "block.coinbase"),
    "GASLIMIT": (taint.TAINT_GASLIMIT, "block.gaslimit"),
    "BLOCKHASH": (taint.TAINT_BLOCKHASH, "blockhash"),
}

for _bit, _op in _TAINT_OPS.values():
    taint.register(
        _bit,
        (lambda op: lambda: PredictableValueAnnotation(op))(_op),
        (lambda op: lambda a: isinstance(a, PredictableValueAnnotation)
         and a.operation == op)(_op),
    )


class PredictableVariables(DetectionModule):
    name = "Control flow depends on a predictable environment variable"
    swc_id = f"{TIMESTAMP_DEPENDENCE}.{WEAK_RANDOMNESS}"
    description = DESCRIPTION
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["JUMPI", "BLOCKHASH"]
    post_hooks = ["BLOCKHASH"] + PREDICTABLE_OPS
    # the post-hooks on the four block-attribute pushes only annotate the
    # result; seeded taint bits on their env rows reproduce that, so the
    # device ships no events for them.  BLOCKHASH stays undeclared: it has
    # a pre-hook too and parks on device anyway.
    taint_source_hooks = {
        op: _TAINT_OPS[op][0] for op in PREDICTABLE_OPS
    }
    # staticpass: issues only exist where a predictable value (BLOCKHASH
    # included — its host hook annotates too) may influence a JUMPI
    static_required_ops = frozenset(_TAINT_OPS)
    static_taint_sources = {op: bit for op, (bit, _) in _TAINT_OPS.items()}
    static_taint_sinks = frozenset({"JUMPI"})

    def _execute(self, state: GlobalState) -> Optional[List[Issue]]:
        if self._cache_key(state) in self.cache:
            return None
        return self._analyze_state(state)

    def _analyze_state(self, state: GlobalState) -> List[Issue]:
        opcode = state.get_current_instruction()["opcode"]

        if opcode != "JUMPI":
            # post hook on a predictable-value op: taint its result
            if state.mstate.stack:
                op = {
                    "COINBASE": "block.coinbase",
                    "GASLIMIT": "block.gaslimit",
                    "TIMESTAMP": "block.timestamp",
                    "NUMBER": "block.number",
                    "BLOCKHASH": "blockhash",
                }.get(opcode, opcode.lower())
                state.mstate.stack[-1].annotate(PredictableValueAnnotation(op))
            return []

        condition = state.mstate.stack[-2]
        annotations = [
            a for a in condition.annotations if isinstance(a, PredictableValueAnnotation)
        ]
        if not annotations:
            return []
        try:
            transaction_sequence = get_transaction_sequence(
                state, state.world_state.constraints.get_all_constraints()
            )
        except UnsatError:
            return []
        # one issue per distinct tainting operation, in sorted order: the
        # reference loops over every annotation on the condition
        # (dependence_on_predictable_vars.py:74-110); sorting makes the set
        # identical whether annotations arrived in host insertion order or
        # were synthesized from device taint bits in ascending-bit order
        # (frontier/taint.annotations_for_mask)
        operations = sorted({a.operation for a in annotations})
        issues = []
        for operation in operations:
            swc_id = (
                WEAK_RANDOMNESS
                if operation in ("block.coinbase", "blockhash")
                else TIMESTAMP_DEPENDENCE
            )
            issues.append(
                Issue(
                    contract=state.environment.active_account.contract_name,
                    function_name=state.node.function_name if state.node else "unknown",
                    address=state.get_current_instruction()["address"],
                    swc_id=swc_id,
                    title="Dependence on predictable environment variable",
                    severity="Low",
                    bytecode=state.environment.code.bytecode,
                    description_head=f"A control flow decision is made based on {operation}.",
                    description_tail=(
                        f"The {operation} environment variable is used to determine a "
                        "control flow decision. Note that the values of variables like "
                        "coinbase, gaslimit, block number and timestamp are predictable "
                        "and can be manipulated by a malicious miner. Also keep in mind "
                        "that attackers know hashes of earlier blocks. Don't use any of "
                        "those environment variables as sources of randomness and be "
                        "aware that use of these variables introduces a certain level "
                        "of trust into miners."
                    ),
                    gas_used=(state.mstate.min_gas_used, state.mstate.max_gas_used),
                    transaction_sequence=transaction_sequence,
                )
            )
        return issues


detector = PredictableVariables
