"""UserAssertions: user-defined assertion messages / solc panics (SWC-110).

Reference parity: mythril/analysis/module/modules/user_assertions.py:1-129 —
decodes the MythX `AssertionFailed(string)` log event and the solc
``Panic(uint256)`` / ``Error(string)`` revert payloads.
"""

from __future__ import annotations

from typing import List, Optional

from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.analysis.report import Issue
from mythril_tpu_torch.analysis.solver import get_transaction_sequence
from mythril_tpu_torch.analysis.swc_data import ASSERT_VIOLATION
from mythril_tpu_torch.core.state.global_state import GlobalState
from mythril_tpu_torch.exceptions import UnsatError

DESCRIPTION = "Search for reachable user-supplied exceptions (hidden assertions)."

# keccak("AssertionFailed(string)")[:32]
ASSERTION_FAILED_TOPIC = 0xB42604CB105A16C8F6DB8A41E6B00C0C1B4826465E8BC504B3EB3E88B3E6A4A0

# solc >=0.8 Panic(uint256) selector
from mythril_tpu_torch.analysis.swc_data import PANIC_SELECTOR


class UserAssertions(DetectionModule):
    name = "A user-defined assertion has been triggered"
    swc_id = ASSERT_VIOLATION
    description = DESCRIPTION
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["LOG1", "MSTORE"]
    # staticpass: panic-MSTORE / assertion-LOG1 are the only triggers
    static_required_ops = frozenset({"LOG1", "MSTORE"})
    # the MSTORE hook observes ONLY concrete values whose top 32 bits are
    # the Panic(uint256) selector (line 51; symbolic values no-op too):
    # the device may skip the event for every other store
    # (frontier/code.py value gate)
    value_gated_hooks = frozenset({"MSTORE"})

    def _execute(self, state: GlobalState) -> Optional[List[Issue]]:
        if self._cache_key(state) in self.cache:
            return None
        return self._analyze_state(state)

    def _analyze_state(self, state: GlobalState) -> List[Issue]:
        opcode = state.get_current_instruction()["opcode"]
        message = None
        if opcode == "LOG1":
            # stack: ... offset length topic
            topic = state.mstate.stack[-3]
            if topic.value != ASSERTION_FAILED_TOPIC:
                return []
            message = "user-provided assertion"
        else:  # MSTORE of a Panic(uint256) payload
            value = state.mstate.stack[-2]
            if value.value is None or (value.value >> (256 - 32)) != PANIC_SELECTOR:
                return []
            message = "solidity panic"

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
                address=state.get_current_instruction()["address"],
                swc_id=ASSERT_VIOLATION,
                title="Exception State",
                severity="Medium",
                bytecode=state.environment.code.bytecode,
                description_head=f"A reachable exception has been detected ({message}).",
                description_tail=(
                    "It is possible to trigger an exception. Exceptions in "
                    "Solidity indicate that an invariant has been violated; make "
                    "sure this condition is not reachable with valid user input."
                ),
                gas_used=(state.mstate.min_gas_used, state.mstate.max_gas_used),
                transaction_sequence=transaction_sequence,
            )
        ]


detector = UserAssertions
