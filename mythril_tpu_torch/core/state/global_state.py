"""GlobalState: the per-path execution state; its copy is THE fork primitive.

Reference parity: mythril/laser/ethereum/state/global_state.py:21-165.
"""

from __future__ import annotations

import copy as _copy
from typing import Dict, Iterable, List, Optional, Tuple

from mythril_tpu_torch.core.state.annotation import StateAnnotation
from mythril_tpu_torch.core.state.environment import Environment
from mythril_tpu_torch.core.state.machine_state import MachineState
from mythril_tpu_torch.core.state.world_state import WorldState
from mythril_tpu_torch.smt import BitVec, symbol_factory


class GlobalState:
    def __init__(
        self,
        world_state: WorldState,
        environment: Environment,
        node=None,
        machine_state: Optional[MachineState] = None,
        transaction_stack=None,
        last_return_data=None,
        annotations: Optional[Iterable[StateAnnotation]] = None,
    ):
        self.world_state = world_state
        self.environment = environment
        self.node = node
        self.mstate = (
            machine_state if machine_state is not None else MachineState(gas_limit=8_000_000)
        )
        self.transaction_stack: List[Tuple] = list(transaction_stack or [])
        self.last_return_data = last_return_data
        self.op_code = ""
        self._annotations: List[StateAnnotation] = list(annotations or [])

    def __copy__(self) -> "GlobalState":
        world_state = _copy.copy(self.world_state)
        environment = _copy.copy(self.environment)
        # re-point environment at the copied account so storage writes fork
        addr = environment.active_account.address.value
        if addr is not None and addr in world_state.accounts:
            environment.active_account = world_state.accounts[addr]
        mstate = _copy.copy(self.mstate)
        out = GlobalState(
            world_state,
            environment,
            node=self.node,
            machine_state=mstate,
            transaction_stack=list(self.transaction_stack),
            last_return_data=self.last_return_data,
            annotations=[_copy.copy(a) for a in self._annotations],
        )
        out.op_code = self.op_code
        return out

    # -- accessors ----------------------------------------------------------
    @property
    def accounts(self) -> Dict:
        return self.world_state.accounts

    def get_current_instruction(self) -> Dict:
        """Instruction at ``mstate.pc``.

        ``pc`` is an *index* into the instruction list (reference semantics:
        StateTransition increments by one instruction; JUMP resolves a byte
        address to an index).  Falling off the end is an implicit STOP.
        """
        instructions = self.environment.code.instruction_list
        if self.mstate.pc >= len(instructions):
            return {"address": self.mstate.pc, "opcode": "STOP"}
        ins = instructions[self.mstate.pc]
        d = {"address": ins.address, "opcode": ins.opcode}
        if ins.argument is not None:
            d["argument"] = "0x" + ins.argument.hex()
        return d

    @property
    def current_transaction(self):
        try:
            return self.transaction_stack[-1][0]
        except IndexError:
            return None

    @property
    def instruction(self) -> Dict:
        return self.get_current_instruction()

    def new_bitvec(self, name: str, size: int = 256, annotations=None) -> BitVec:
        txid = self.current_transaction.id if self.current_transaction else "pre"
        return symbol_factory.BitVecSym(f"{txid}_{name}", size, annotations)

    # -- annotations --------------------------------------------------------
    def annotate(self, annotation: StateAnnotation) -> None:
        self._annotations.append(annotation)

    @property
    def annotations(self) -> List[StateAnnotation]:
        return self._annotations

    def get_annotations(self, annotation_type: type) -> List:
        return [a for a in self._annotations if isinstance(a, annotation_type)]
