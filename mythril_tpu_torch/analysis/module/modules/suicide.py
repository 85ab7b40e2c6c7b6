"""AccidentallyKillable: anyone can reach SELFDESTRUCT (SWC-106).

Reference parity: mythril/analysis/module/modules/suicide.py:54-126 — try
proving the attacker controls the beneficiary first, fall back to plain
reachability by the attacker.
"""

from __future__ import annotations

import logging
from typing import List, Optional

from mythril_tpu_torch.analysis.issue_annotation import IssueAnnotation
from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.analysis.report import Issue
from mythril_tpu_torch.analysis.solver import get_transaction_sequence
from mythril_tpu_torch.analysis.swc_data import UNPROTECTED_SELFDESTRUCT
from mythril_tpu_torch.core.state.global_state import GlobalState
from mythril_tpu_torch.core.transaction.symbolic import ACTORS
from mythril_tpu_torch.exceptions import UnsatError
from mythril_tpu_torch.smt import And

log = logging.getLogger(__name__)

DESCRIPTION = """
Check if the contact can be 'accidentally' killed by anyone.
For kill-able contracts, also check whether it is possible to direct the contract balance to the attacker.
"""


class AccidentallyKillable(DetectionModule):
    name = "Contract can be accidentally killed by anyone"
    swc_id = UNPROTECTED_SELFDESTRUCT
    description = DESCRIPTION
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["SELFDESTRUCT"]
    # staticpass: nothing to report without a SELFDESTRUCT
    static_required_ops = frozenset({"SELFDESTRUCT"})

    def __init__(self):
        super().__init__()
        self._cache_address = {}

    def _execute(self, state: GlobalState) -> Optional[List[Issue]]:
        if self._cache_key(state) in self.cache:
            return None
        return self._analyze_state(state)

    def _analyze_state(self, state: GlobalState) -> List[Issue]:
        instruction = state.get_current_instruction()
        to = state.mstate.stack[-1]

        log.debug("SELFDESTRUCT in function %s", state.node.function_name if state.node else "?")

        description_head = "Any sender can cause the contract to self-destruct."

        constraints = state.world_state.constraints.get_all_constraints()
        attacker_constraints = [
            tx.caller == ACTORS.attacker
            for tx in state.world_state.transaction_sequence
            if not _is_creation(tx)
        ]

        try:
            # strongest claim first: attacker receives the balance
            try:
                transaction_sequence = get_transaction_sequence(
                    state,
                    constraints
                    + attacker_constraints
                    + [to == ACTORS.attacker],
                )
                description_tail = (
                    "Any sender can trigger execution of the SELFDESTRUCT instruction to "
                    "destroy this contract and withdraw its balance to an arbitrary "
                    "address. Review the transaction sequence to see how this is possible."
                )
            except UnsatError:
                transaction_sequence = get_transaction_sequence(
                    state, constraints + attacker_constraints
                )
                description_tail = (
                    "Any sender can trigger execution of the SELFDESTRUCT instruction to "
                    "destroy this contract. Review the transaction sequence to see how "
                    "this is possible."
                )
        except UnsatError:
            return []

        issue = Issue(
            contract=state.environment.active_account.contract_name,
            function_name=state.node.function_name if state.node else "unknown",
            address=instruction["address"],
            swc_id=UNPROTECTED_SELFDESTRUCT,
            bytecode=state.environment.code.bytecode,
            title="Unprotected Selfdestruct",
            severity="High",
            description_head=description_head,
            description_tail=description_tail,
            gas_used=(state.mstate.min_gas_used, state.mstate.max_gas_used),
            transaction_sequence=transaction_sequence,
        )
        state.annotate(
            IssueAnnotation(conditions=[And(*constraints)], issue=issue, detector=self)
        )
        return [issue]


def _is_creation(tx) -> bool:
    from mythril_tpu_torch.core.transaction.transaction_models import ContractCreationTransaction

    return isinstance(tx, ContractCreationTransaction)


detector = AccidentallyKillable
