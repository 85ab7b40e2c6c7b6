"""ArbitraryJump: jump destination controllable by the caller (SWC-127).

Reference parity: mythril/analysis/module/modules/arbitrary_jump.py:1-86.
"""

from __future__ import annotations

from typing import List, Optional

from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.analysis.report import Issue
from mythril_tpu_torch.analysis.solver import get_transaction_sequence
from mythril_tpu_torch.analysis.swc_data import ARBITRARY_JUMP
from mythril_tpu_torch.core.state.global_state import GlobalState
from mythril_tpu_torch.exceptions import UnsatError

DESCRIPTION = "Check for jumps to a user-specified location."


class ArbitraryJump(DetectionModule):
    name = "Caller can redirect execution to arbitrary bytecode locations"
    swc_id = ARBITRARY_JUMP
    description = DESCRIPTION
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["JUMP", "JUMPI"]
    # staticpass: issues come only from jump-target checks
    static_required_ops = frozenset({"JUMP", "JUMPI"})
    # _analyze_state returns [] for a concrete jump destination; the device
    # executes only concrete-dest JUMPs (symbolic dests park to the host),
    # so device JUMP events exist purely for this hook and can be suppressed
    concrete_nop_hooks = frozenset({"JUMP"})

    def _execute(self, state: GlobalState) -> Optional[List[Issue]]:
        if self._cache_key(state) in self.cache:
            return None
        return self._analyze_state(state)

    def _analyze_state(self, state: GlobalState) -> List[Issue]:
        jump_dest = state.mstate.stack[-1]
        if jump_dest.value is not None:
            return []
        # destination is symbolic: can the caller actually choose it?
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
                swc_id=ARBITRARY_JUMP,
                title="Jump to an arbitrary instruction",
                severity="High",
                bytecode=state.environment.code.bytecode,
                description_head="The caller can redirect execution to arbitrary bytecode locations.",
                description_tail=(
                    "It is possible to redirect the control flow to arbitrary locations "
                    "in the code. This may allow an attacker to bypass security "
                    "controls or manipulate the business logic of the smart contract. "
                    "Avoid using low-level-operations and assembly to prevent this issue."
                ),
                gas_used=(state.mstate.min_gas_used, state.mstate.max_gas_used),
                transaction_sequence=transaction_sequence,
            )
        ]


detector = ArbitraryJump
