"""EtherThief: attacker can withdraw more ether than deposited (SWC-105).

Reference parity: mythril/analysis/module/modules/ether_thief.py:54-99 —
value-transferring CALL with every tx sent by the attacker and the attacker's
net balance strictly increased; parked as a PotentialIssue.
"""

from __future__ import annotations

from typing import List, Optional

from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.analysis.potential_issues import (
    PotentialIssue,
    get_potential_issues_annotation,
)
from mythril_tpu_torch.analysis.swc_data import UNPROTECTED_ETHER_WITHDRAWAL
from mythril_tpu_torch.core.state.global_state import GlobalState
from mythril_tpu_torch.core.transaction.symbolic import ACTORS
from mythril_tpu_torch.core.transaction.transaction_models import ContractCreationTransaction
from mythril_tpu_torch.smt import UGT, symbol_factory

DESCRIPTION = """
Search for cases where Ether can be withdrawn to a user-specified address.
An issue is reported if there is a valid end state where the attacker has sent ether to the contract
and can withdraw more than deposited.
"""


class EtherThief(DetectionModule):
    name = "Any sender can withdraw ETH from the contract account"
    swc_id = UNPROTECTED_ETHER_WITHDRAWAL
    description = DESCRIPTION
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["CALL"]
    # staticpass: value exfiltration needs a CALL
    static_required_ops = frozenset({"CALL"})

    def _execute(self, state: GlobalState) -> None:
        if self._cache_key(state) in self.cache:
            return None
        self._analyze_state(state)
        return None

    def _analyze_state(self, state: GlobalState) -> None:
        instruction = state.get_current_instruction()
        stack = state.mstate.stack
        value = stack[-3]
        target = stack[-2]

        constraints = []
        for tx in state.world_state.transaction_sequence:
            if not isinstance(tx, ContractCreationTransaction):
                constraints.append(tx.caller == ACTORS.attacker)

        # attacker ends up strictly ahead: transferred value exceeds the sum
        # the attacker paid in across the sequence
        total_paid = symbol_factory.BitVecVal(0, 256)
        for tx in state.world_state.transaction_sequence:
            if not isinstance(tx, ContractCreationTransaction):
                total_paid = total_paid + tx.call_value
        constraints += [
            target == ACTORS.attacker,
            UGT(value, total_paid),
        ]

        potential_issue = PotentialIssue(
            contract=state.environment.active_account.contract_name,
            function_name=state.node.function_name if state.node else "unknown",
            address=instruction["address"],
            swc_id=UNPROTECTED_ETHER_WITHDRAWAL,
            title="Unprotected Ether Withdrawal",
            severity="High",
            bytecode=state.environment.code.bytecode,
            description_head="Any sender can withdraw Ether from the contract account.",
            description_tail=(
                "Arbitrary senders other than the contract creator can profitably "
                "extract Ether from the contract account. Verify the business logic "
                "carefully and make sure that appropriate security controls are in "
                "place to prevent unexpected loss of funds."
            ),
            detector=self,
            constraints=constraints,
        )
        get_potential_issues_annotation(state).potential_issues.append(potential_issue)


detector = EtherThief
