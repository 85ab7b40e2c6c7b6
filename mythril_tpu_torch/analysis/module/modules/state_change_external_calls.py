"""StateChangeAfterCall: state modified after an external call (SWC-107).

Reference parity: mythril/analysis/module/modules/state_change_external_calls.py:44-201.
"""

from __future__ import annotations

from typing import List, Optional

from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.analysis.potential_issues import (
    PotentialIssue,
    get_potential_issues_annotation,
)
from mythril_tpu_torch.analysis.swc_data import REENTRANCY
from mythril_tpu_torch.core.state.annotation import StateAnnotation
from mythril_tpu_torch.core.state.global_state import GlobalState
from mythril_tpu_torch.smt import UGT, symbol_factory

DESCRIPTION = "Check whether the account state is accessed after an external call."

CALL_LIST = ["CALL", "DELEGATECALL", "CALLCODE"]
STATE_READ_WRITE_LIST = ["SSTORE", "SLOAD", "CREATE", "CREATE2"]


class StateChangeCallsAnnotation(StateAnnotation):
    def __init__(self, call_state: GlobalState, user_defined_address: bool):
        self.call_state = call_state
        self.user_defined_address = user_defined_address
        self.state_change_states: List[GlobalState] = []

    def __copy__(self):
        out = StateChangeCallsAnnotation(self.call_state, self.user_defined_address)
        out.state_change_states = list(self.state_change_states)
        return out


class StateChangeAfterCall(DetectionModule):
    name = "State change after an external call"
    swc_id = REENTRANCY
    description = DESCRIPTION
    entry_point = EntryPoint.CALLBACK
    pre_hooks = CALL_LIST + STATE_READ_WRITE_LIST
    # staticpass: a state change AFTER a call needs one of the calls
    static_required_ops = frozenset(CALL_LIST)

    def _execute(self, state: GlobalState) -> None:
        # NO cache short-circuit here: this module is STATEFUL — the
        # annotation marking (first-access bookkeeping) must run on every
        # path even when the report for this address is already confirmed,
        # or a later path reaches the NEXT access unmarked and reports it
        # (a confirmation-timing-dependent extra issue; caught by the
        # frontier/host differential on the etherstore shape).  The cache
        # gates only report creation (_report).
        self._analyze_state(state)
        return None

    def _analyze_state(self, state: GlobalState) -> None:
        opcode = state.get_current_instruction()["opcode"]
        annotations = state.get_annotations(StateChangeCallsAnnotation)

        if opcode in STATE_READ_WRITE_LIST:
            for annotation in annotations:
                if annotation.state_change_states:
                    continue
                annotation.state_change_states.append(state)
                self._report(state, annotation)
            return

        # CALL-family: start tracking if the callee might be user-controlled
        # and enough gas is forwarded for the callee to re-enter
        if opcode in ("CALL", "CALLCODE", "DELEGATECALL"):
            gas = state.mstate.stack[-1]
            to = state.mstate.stack[-2]
            user_defined = to.value is None
            if gas.value is not None and gas.value <= 2300:
                return
            state.annotate(StateChangeCallsAnnotation(state, user_defined))

    def _report(self, state: GlobalState, annotation: StateChangeCallsAnnotation) -> None:
        if self._cache_key(state) in self.cache:
            return
        severity = "Medium" if annotation.user_defined_address else "Low"
        call_address = annotation.call_state.get_current_instruction()["address"]
        potential_issue = PotentialIssue(
            contract=state.environment.active_account.contract_name,
            function_name=state.node.function_name if state.node else "unknown",
            address=state.get_current_instruction()["address"],
            swc_id=REENTRANCY,
            title="State access after external call",
            severity=severity,
            bytecode=state.environment.code.bytecode,
            description_head=(
                f"Read or write to persistent state following the external call at "
                f"address {call_address}."
            ),
            description_tail=(
                "The contract account state is accessed after an external call. "
                "To prevent reentrancy issues, consider accessing the state only "
                "before the call, especially if the callee is untrusted. "
                "Alternatively, a reentrancy lock can be used to prevent "
                "untrusted callees from re-entering the contract in an "
                "intermediate state."
            ),
            detector=self,
            constraints=[],
        )
        get_potential_issues_annotation(state).potential_issues.append(potential_issue)


detector = StateChangeAfterCall
