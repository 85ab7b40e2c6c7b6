"""ArbitraryDelegateCall: DELEGATECALL into an attacker-chosen contract (SWC-112).

Reference parity: mythril/analysis/module/modules/delegatecall.py:1-99.
"""

from __future__ import annotations

from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.analysis.potential_issues import (
    PotentialIssue,
    get_potential_issues_annotation,
)
from mythril_tpu_torch.analysis.swc_data import DELEGATECALL_TO_UNTRUSTED_CONTRACT
from mythril_tpu_torch.core.state.global_state import GlobalState
from mythril_tpu_torch.core.transaction.symbolic import ACTORS

DESCRIPTION = "Check for invocations of delegatecall to a user-supplied address."


class ArbitraryDelegateCall(DetectionModule):
    name = "Delegatecall to a user-specified address"
    swc_id = DELEGATECALL_TO_UNTRUSTED_CONTRACT
    description = DESCRIPTION
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["DELEGATECALL"]
    # staticpass: nothing to report without a DELEGATECALL
    static_required_ops = frozenset({"DELEGATECALL"})

    def _execute(self, state: GlobalState) -> None:
        if self._cache_key(state) in self.cache:
            return None
        self._analyze_state(state)
        return None

    def _analyze_state(self, state: GlobalState) -> None:
        target = state.mstate.stack[-2]
        if target.value is not None:
            return  # fixed library target: fine
        constraints = [target == ACTORS.attacker]
        potential_issue = PotentialIssue(
            contract=state.environment.active_account.contract_name,
            function_name=state.node.function_name if state.node else "unknown",
            address=state.get_current_instruction()["address"],
            swc_id=DELEGATECALL_TO_UNTRUSTED_CONTRACT,
            title="Delegatecall to user-supplied address",
            severity="High",
            bytecode=state.environment.code.bytecode,
            description_head="The contract delegates execution to another contract with a user-supplied address.",
            description_tail=(
                "The smart contract delegates execution to a user-supplied "
                "address. This could allow an attacker to execute arbitrary code "
                "in the context of this contract account and manipulate the state "
                "of the contract account or execute actions on its behalf."
            ),
            detector=self,
            constraints=constraints,
        )
        get_potential_issues_annotation(state).potential_issues.append(potential_issue)


detector = ArbitraryDelegateCall
