"""MultipleSends: multiple external calls in a single transaction (SWC-113).

Reference parity: mythril/analysis/module/modules/multiple_sends.py:1-105.
"""

from __future__ import annotations

from typing import List, Optional

from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.analysis.report import Issue
from mythril_tpu_torch.analysis.solver import get_transaction_sequence
from mythril_tpu_torch.analysis.swc_data import MULTIPLE_SENDS
from mythril_tpu_torch.core.state.annotation import StateAnnotation
from mythril_tpu_torch.core.state.global_state import GlobalState
from mythril_tpu_torch.exceptions import UnsatError

DESCRIPTION = "Check for multiple sends in a single transaction."


class MultipleSendsAnnotation(StateAnnotation):
    def __init__(self):
        self.call_offsets: List[int] = []

    def __copy__(self):
        out = MultipleSendsAnnotation()
        out.call_offsets = list(self.call_offsets)
        return out


class MultipleSends(DetectionModule):
    name = "Multiple external calls in the same transaction"
    swc_id = MULTIPLE_SENDS
    description = DESCRIPTION
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["CALL", "DELEGATECALL", "STATICCALL", "CALLCODE", "RETURN", "STOP"]
    # staticpass: the RETURN/STOP hooks only report sends recorded by the
    # call hooks, so no call-family op means no possible issue
    static_required_ops = frozenset({"CALL", "DELEGATECALL", "STATICCALL", "CALLCODE"})

    def _execute(self, state: GlobalState) -> Optional[List[Issue]]:
        if self._cache_key(state) in self.cache:
            return None
        return self._analyze_state(state)

    def _analyze_state(self, state: GlobalState) -> List[Issue]:
        annotations = state.get_annotations(MultipleSendsAnnotation)
        if not annotations:
            annotation = MultipleSendsAnnotation()
            state.annotate(annotation)
        else:
            annotation = annotations[0]

        opcode = state.get_current_instruction()["opcode"]
        if opcode in ("CALL", "DELEGATECALL", "STATICCALL", "CALLCODE"):
            annotation.call_offsets.append(state.get_current_instruction()["address"])
            return []

        # RETURN / STOP
        if len(annotation.call_offsets) < 2:
            return []
        try:
            transaction_sequence = get_transaction_sequence(
                state, state.world_state.constraints.get_all_constraints()
            )
        except UnsatError:
            return []
        return [
            Issue(
                contract=state.environment.active_account.contract_name,
                function_name=state.node.function_name if state.node else "unknown",
                address=annotation.call_offsets[1],
                swc_id=MULTIPLE_SENDS,
                title="Multiple Calls in a Single Transaction",
                severity="Low",
                bytecode=state.environment.code.bytecode,
                description_head="Multiple calls are executed in the same transaction.",
                description_tail=(
                    "This call is executed following another call within the same "
                    "transaction. It is possible that the call never gets executed "
                    "if a prior call fails permanently. This might be caused "
                    "intentionally by a malicious callee. If possible, refactor "
                    "the code such that each transaction only executes one "
                    "external call or make sure that all callees can be trusted "
                    "(i.e. they're part of your own codebase)."
                ),
                gas_used=(state.mstate.min_gas_used, state.mstate.max_gas_used),
                transaction_sequence=transaction_sequence,
            )
        ]


detector = MultipleSends
