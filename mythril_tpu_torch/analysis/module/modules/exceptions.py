"""Exceptions: reachable assert-fail / INVALID opcode (SWC-110).

Reference parity: mythril/analysis/module/modules/exceptions.py:1-136.
"""

from __future__ import annotations

from typing import List, Optional

from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.analysis.report import Issue
from mythril_tpu_torch.analysis.solver import get_transaction_sequence
from mythril_tpu_torch.analysis.swc_data import ASSERT_VIOLATION
from mythril_tpu_torch.core.state.global_state import GlobalState
from mythril_tpu_torch.exceptions import UnsatError

DESCRIPTION = """
Checks whether any exception states are reachable.
"""

def _is_assertion_failure(state: GlobalState) -> bool:
    """REVERT carrying Panic(0x01) — a solc >=0.8 assert failure (reference
    exceptions.py:123-133: concrete return data starting with the Panic
    selector whose last byte is panic code 1).  The selector is checked
    FIRST so the dominant non-assert revert class (Error(string) from
    require) costs four byte reads, not a scan of its whole return data."""
    from mythril_tpu_torch.analysis.swc_data import PANIC_SELECTOR_BYTES
    from mythril_tpu_torch.core.util import get_concrete_int

    mstate = state.mstate
    try:
        offset = get_concrete_int(mstate.stack[-1])
        length = get_concrete_int(mstate.stack[-2])
    except (TypeError, IndexError):
        return False
    if length < 5 or length > 4096:
        return False
    try:
        selector = [get_concrete_int(mstate.memory[offset + i]) for i in range(4)]
        if selector != PANIC_SELECTOR_BYTES:
            return False
        return get_concrete_int(mstate.memory[offset + length - 1]) == 1
    except (TypeError, KeyError):
        return False


class Exceptions(DetectionModule):
    name = "Assertion violation"
    swc_id = ASSERT_VIOLATION
    description = DESCRIPTION
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["INVALID", "REVERT"]
    # staticpass: assert-violation issues come only from these halts
    static_required_ops = frozenset({"INVALID", "ASSERT_FAIL", "REVERT"})

    def _execute(self, state: GlobalState) -> Optional[List[Issue]]:
        # solc >= 0.8 routes EVERY assert through one shared panic block,
        # so the revert pc alone cannot tell two assert sites apart — key
        # the dedup by the active function as well (the reference gets the
        # same distinction from its last-JUMP source_location annotation,
        # exceptions.py:24-29; the function entry works identically for
        # one-assert-per-function layouts and needs no JUMP hook, which
        # would re-inflate the device event diet)
        function = state.node.function_name if state.node else "unknown"
        key = self._cache_key(state) + (function,)
        if key in self.cache:
            return None
        issues = self._analyze_state(state)
        if issues:
            self.cache.add(key)
        return issues

    def _analyze_state(self, state: GlobalState) -> List[Issue]:
        # solve immediately: INVALID/REVERT halt this path exceptionally,
        # so a deferred (tx-end) check would never fire for it
        instruction = state.get_current_instruction()
        if instruction["opcode"] == "REVERT" and not _is_assertion_failure(state):
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
                address=instruction["address"],
                swc_id=ASSERT_VIOLATION,
                title="Exception State",
                severity="Medium",
                bytecode=state.environment.code.bytecode,
                description_head="An assertion violation was triggered.",
                description_tail=(
                    "It is possible to trigger an assertion violation. Note that "
                    "Solidity assert() statements should only be used to check "
                    "invariants. Review the transaction sequence to see if this "
                    "condition can be triggered by user input."
                ),
                gas_used=(state.mstate.min_gas_used, state.mstate.max_gas_used),
                transaction_sequence=transaction_sequence,
            )
        ]


detector = Exceptions
