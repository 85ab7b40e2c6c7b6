"""UncheckedRetval: call return value never checked before tx end (SWC-104).

Reference parity: mythril/analysis/module/modules/unchecked_retval.py:1-141.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.analysis.report import Issue
from mythril_tpu_torch.analysis.solver import get_transaction_sequence
from mythril_tpu_torch.analysis.swc_data import UNCHECKED_RET_VAL
from mythril_tpu_torch.core.state.annotation import StateAnnotation
from mythril_tpu_torch.core.state.global_state import GlobalState
from mythril_tpu_torch.exceptions import UnsatError
from mythril_tpu_torch.smt import symbol_factory

DESCRIPTION = """
Test whether CALL return value is checked.
For direct calls, the Solidity compiler auto-generates this check. E.g.:
    Alice c = Alice(address);
    c.ping(42);
Here the CALL will be followed by IZSERO(retval).
For low-level-calls this check is omitted. E.g.:
    c.call.value(0)(bytes4(sha3("ping(uint256)")),1);
"""


class RetvalAnnotation(StateAnnotation):
    def __init__(self):
        self.retvals: List[Dict] = []

    def __copy__(self):
        out = RetvalAnnotation()
        out.retvals = [dict(r) for r in self.retvals]
        return out


class UncheckedRetval(DetectionModule):
    name = "Return value of an external call is not checked"
    swc_id = UNCHECKED_RET_VAL
    description = DESCRIPTION
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["STOP", "RETURN"]
    # staticpass: STOP/RETURN only check retvals recorded by the call
    # post-hooks, so no call-family op means no possible issue
    static_required_ops = frozenset({"CALL", "DELEGATECALL", "STATICCALL", "CALLCODE"})
    post_hooks = ["CALL", "DELEGATECALL", "STATICCALL", "CALLCODE"]

    def _execute(self, state: GlobalState) -> Optional[List[Issue]]:
        if self._cache_key(state) in self.cache:
            return None
        return self._analyze_state(state)

    def _analyze_state(self, state: GlobalState) -> List[Issue]:
        instruction = state.get_current_instruction()
        annotations = state.get_annotations(RetvalAnnotation)
        if not annotations:
            annotation = RetvalAnnotation()
            state.annotate(annotation)
        else:
            annotation = annotations[0]

        if instruction["opcode"] in ("STOP", "RETURN"):
            issues = []
            for retval in annotation.retvals:
                try:
                    # the tx can end successfully even when the call failed
                    transaction_sequence = get_transaction_sequence(
                        state,
                        state.world_state.constraints
                        + [retval["retval"] == symbol_factory.BitVecVal(0, 256)],
                    )
                except UnsatError:
                    continue
                issues.append(
                    Issue(
                        contract=state.environment.active_account.contract_name,
                        function_name=state.node.function_name if state.node else "unknown",
                        address=retval["address"],
                        swc_id=UNCHECKED_RET_VAL,
                        title="Unchecked return value from external call.",
                        severity="Medium",
                        bytecode=state.environment.code.bytecode,
                        description_head="The return value of a message call is not checked.",
                        description_tail=(
                            "External calls return a boolean value. If the callee "
                            "halts with an exception, 'false' is returned and "
                            "execution continues in the caller. The caller should "
                            "check whether an exception happened and react "
                            "accordingly to avoid unexpected behavior. For example "
                            "it is often desirable to wrap external calls in "
                            "require() so the transaction is reverted if the call "
                            "fails."
                        ),
                        gas_used=(state.mstate.min_gas_used, state.mstate.max_gas_used),
                        transaction_sequence=transaction_sequence,
                    )
                )
            return issues

        # post-CALL: remember the pushed return-value symbol
        if state.mstate.stack:
            retval = state.mstate.stack[-1]
            if retval.value is None:
                annotation.retvals.append(
                    {"address": state.instruction["address"] - 1, "retval": retval}
                )
        return []


detector = UncheckedRetval
