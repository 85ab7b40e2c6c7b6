"""TxOrigin: control flow depends on tx.origin (SWC-115).

Reference parity: mythril/analysis/module/modules/dependence_on_origin.py:1-112
— ORIGIN results are taint-annotated; a JUMPI whose condition carries the
taint raises the issue.
"""

from __future__ import annotations

from typing import List, Optional

from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.analysis.report import Issue
from mythril_tpu_torch.analysis.solver import get_transaction_sequence
from mythril_tpu_torch.analysis.swc_data import TX_ORIGIN_USAGE
from mythril_tpu_torch.core.state.global_state import GlobalState
from mythril_tpu_torch.exceptions import UnsatError
from mythril_tpu_torch.frontier import taint

DESCRIPTION = "Check whether control flow decisions are influenced by tx.origin."


class TxOriginAnnotation:
    """Taint marker set on the ORIGIN opcode's result."""


taint.register(
    taint.TAINT_ORIGIN,
    TxOriginAnnotation,
    lambda a: isinstance(a, TxOriginAnnotation),
)


class TxOrigin(DetectionModule):
    name = "Control flow depends on tx.origin"
    swc_id = TX_ORIGIN_USAGE
    description = DESCRIPTION
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["JUMPI"]
    post_hooks = ["ORIGIN"]
    # the ORIGIN post-hook only annotates the pushed value; the frontier
    # reproduces it from the seeded taint bit on the origin env row, so
    # device-executed ORIGINs ship no event (frontier/taint.py)
    taint_source_hooks = {"ORIGIN": taint.TAINT_ORIGIN}
    # staticpass: issues only exist where an ORIGIN value may influence a
    # JUMPI condition
    static_required_ops = frozenset({"ORIGIN"})
    static_taint_sources = {"ORIGIN": taint.TAINT_ORIGIN}
    static_taint_sinks = frozenset({"JUMPI"})

    def _execute(self, state: GlobalState) -> Optional[List[Issue]]:
        if self._cache_key(state) in self.cache:
            return None
        return self._analyze_state(state)

    def _analyze_state(self, state: GlobalState) -> List[Issue]:
        if state.get_current_instruction()["opcode"] != "JUMPI":
            # post-ORIGIN: annotate the pushed value
            state.mstate.stack[-1].annotate(TxOriginAnnotation())
            return []

        condition = state.mstate.stack[-2]
        if not any(isinstance(a, TxOriginAnnotation) for a in condition.annotations):
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
                address=state.get_current_instruction()["address"],
                swc_id=TX_ORIGIN_USAGE,
                title="Dependence on tx.origin",
                severity="Low",
                bytecode=state.environment.code.bytecode,
                description_head="Use of tx.origin as a part of authorization control.",
                description_tail=(
                    "The tx.origin environment variable has been found to "
                    "influence a control flow decision. Note that using tx.origin "
                    "as a security control might cause a situation where a user "
                    "inadvertently authorizes a smart contract to perform an "
                    "action on their behalf. It is recommended to use msg.sender "
                    "instead."
                ),
                gas_used=(state.mstate.min_gas_used, state.mstate.max_gas_used),
                transaction_sequence=transaction_sequence,
            )
        ]


detector = TxOrigin
