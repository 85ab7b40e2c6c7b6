"""ExternalCalls: call to a user-supplied address with enough gas for
reentrancy (SWC-107).

Reference parity: mythril/analysis/module/modules/external_calls.py:1-118.
"""

from __future__ import annotations

from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.analysis.potential_issues import (
    PotentialIssue,
    get_potential_issues_annotation,
)
from mythril_tpu_torch.analysis.swc_data import REENTRANCY
from mythril_tpu_torch.core.state.global_state import GlobalState
from mythril_tpu_torch.core.transaction.symbolic import ACTORS
from mythril_tpu_torch.smt import UGT, symbol_factory

DESCRIPTION = """
Search for external calls with unrestricted gas to a user-specified address.
"""


class ExternalCalls(DetectionModule):
    name = "External call to another contract"
    swc_id = REENTRANCY
    description = DESCRIPTION
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["CALL"]
    # staticpass: external-call issues need a CALL
    static_required_ops = frozenset({"CALL"})

    def _execute(self, state: GlobalState) -> None:
        if self._cache_key(state) in self.cache:
            return None
        self._analyze_state(state)
        return None

    def _analyze_state(self, state: GlobalState) -> None:
        gas = state.mstate.stack[-1]
        to = state.mstate.stack[-2]
        if to.value is not None:
            return  # fixed target
        constraints = [
            to == ACTORS.attacker,
            UGT(gas, symbol_factory.BitVecVal(2300, 256)),
        ]
        potential_issue = PotentialIssue(
            contract=state.environment.active_account.contract_name,
            function_name=state.node.function_name if state.node else "unknown",
            address=state.get_current_instruction()["address"],
            swc_id=REENTRANCY,
            title="External Call To User-Supplied Address",
            severity="Low",
            bytecode=state.environment.code.bytecode,
            description_head="A call to a user-supplied address is executed.",
            description_tail=(
                "An external message call to an address specified by the caller "
                "is executed. Note that the callee account might contain "
                "arbitrary code and could re-enter any function within this "
                "contract. Reentering the contract in an intermediate state may "
                "lead to unexpected behaviour. Make sure that no state "
                "modifications are executed after this call and/or reentrancy "
                "guards are in place."
            ),
            detector=self,
            constraints=constraints,
        )
        get_potential_issues_annotation(state).potential_issues.append(potential_issue)


detector = ExternalCalls
