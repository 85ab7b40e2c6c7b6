"""ArbitraryStorage: write to an attacker-controlled storage slot (SWC-124).

Reference parity: mythril/analysis/module/modules/arbitrary_write.py:1-78.
"""

from __future__ import annotations

from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.analysis.potential_issues import (
    PotentialIssue,
    get_potential_issues_annotation,
)
from mythril_tpu_torch.analysis.swc_data import WRITE_TO_ARBITRARY_STORAGE
from mythril_tpu_torch.core.state.global_state import GlobalState
from mythril_tpu_torch.smt import symbol_factory

DESCRIPTION = """
Search for any writes to an arbitrary storage slot.
"""


class ArbitraryStorage(DetectionModule):
    name = "Caller can write to arbitrary storage locations"
    swc_id = WRITE_TO_ARBITRARY_STORAGE
    description = DESCRIPTION
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["SSTORE"]
    # staticpass: a write-to-arbitrary-slot issue needs an SSTORE
    static_required_ops = frozenset({"SSTORE"})

    def _execute(self, state: GlobalState) -> None:
        if self._cache_key(state) in self.cache:
            return None
        self._analyze_state(state)
        return None

    def _analyze_state(self, state: GlobalState) -> None:
        write_slot = state.mstate.stack[-1]
        if write_slot.value is not None:
            return
        # can the slot index be forced to an arbitrary magic value?
        constraints = [
            write_slot == symbol_factory.BitVecVal(324345425435, 256)
        ]
        potential_issue = PotentialIssue(
            contract=state.environment.active_account.contract_name,
            function_name=state.node.function_name if state.node else "unknown",
            address=state.get_current_instruction()["address"],
            swc_id=WRITE_TO_ARBITRARY_STORAGE,
            title="Write to an arbitrary storage location",
            severity="High",
            bytecode=state.environment.code.bytecode,
            description_head="The caller can write to arbitrary storage locations.",
            description_tail=(
                "It is possible to write to arbitrary storage locations. By "
                "modifying the values of storage variables, attackers may bypass "
                "security controls or manipulate the business logic of the smart "
                "contract."
            ),
            detector=self,
            constraints=constraints,
        )
        get_potential_issues_annotation(state).potential_issues.append(potential_issue)


detector = ArbitraryStorage
