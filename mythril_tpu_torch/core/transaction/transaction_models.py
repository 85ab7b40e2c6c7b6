"""Transaction models and the engine's control-transfer signals.

Reference parity: mythril/laser/ethereum/transaction/transaction_models.py:
signals (:35-54), BaseTransaction (:57), MessageCallTransaction (:159),
ContractCreationTransaction (:194), TxIdManager (:20-32).  Control transfer
between call frames is exception-driven in the worklist engine — a deliberate
parity choice: the host orchestrates frames; device kernels only ever see
single-frame segments.
"""

from __future__ import annotations

import copy as _copy
from typing import Optional

from mythril_tpu_torch.core.state.account import Account
from mythril_tpu_torch.core.state.calldata import (
    BaseCalldata,
    ConcreteCalldata,
    SymbolicCalldata,
)
from mythril_tpu_torch.core.state.constraints import Constraints
from mythril_tpu_torch.core.state.environment import Environment
from mythril_tpu_torch.core.state.global_state import GlobalState
from mythril_tpu_torch.core.state.machine_state import MachineState
from mythril_tpu_torch.core.state.world_state import WorldState
from mythril_tpu_torch.smt import BitVec, UGE, symbol_factory


class TxIdManager:
    """Monotone transaction-id source (reference :20-32)."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
            cls._instance._next = 0
        return cls._instance

    def get_next_tx_id(self) -> str:
        self._next += 1
        return str(self._next)

    def restart_counter(self) -> None:
        self._next = 0

    def ensure_above(self, used_id: str) -> None:
        """Advance past an id restored from a checkpoint: new transactions
        must never reuse a restored id (symbols are named by tx id and
        interned, so a collision aliases variables across transactions)."""
        try:
            self._next = max(self._next, int(used_id))
        except ValueError:
            pass


tx_id_manager = TxIdManager()


class TransactionStartSignal(Exception):
    """Raised by CALL-family handlers to push a new frame."""

    def __init__(self, transaction, op_code: str, global_state: GlobalState):
        self.transaction = transaction
        self.op_code = op_code
        self.global_state = global_state


class TransactionEndSignal(Exception):
    """Raised by terminal handlers (STOP/RETURN/REVERT/SELFDESTRUCT)."""

    def __init__(self, global_state: GlobalState, revert: bool = False):
        self.global_state = global_state
        self.revert = revert


class BaseTransaction:
    def __init__(
        self,
        world_state: WorldState,
        callee_account: Optional[Account] = None,
        caller: Optional[BitVec] = None,
        call_data: Optional[BaseCalldata] = None,
        identifier: Optional[str] = None,
        gas_price=None,
        gas_limit: int = 8_000_000,
        origin=None,
        code=None,
        call_value=None,
        init_call_data: bool = True,
        static: bool = False,
        base_fee=None,
        block_env: Optional[dict] = None,
    ):
        self.world_state = world_state
        self.id = identifier or tx_id_manager.get_next_tx_id()
        self.gas_limit = gas_limit
        self.gas_price = (
            gas_price
            if gas_price is not None
            else symbol_factory.BitVecSym(f"{self.id}_gasprice", 256)
        )
        self.base_fee = (
            base_fee
            if base_fee is not None
            else symbol_factory.BitVecSym(f"{self.id}_basefee", 256)
        )
        self.origin = (
            origin if origin is not None else symbol_factory.BitVecSym(f"{self.id}_origin", 256)
        )
        self.code = code
        self.caller = caller
        self.callee_account = callee_account
        if call_data is None and init_call_data:
            # symbolic, not empty-concrete (reference transaction_models.py:
            # 103-104): creation transactions read constructor arguments
            # through the calldata model (codesize_/codecopy_ route reads
            # past the code end there), so the default must be able to
            # carry symbolic argument bytes
            call_data = SymbolicCalldata(self.id)
        self.call_data = call_data
        self.call_value = (
            call_value
            if call_value is not None
            else symbol_factory.BitVecSym(f"{self.id}_callvalue", 256)
        )
        self.static = static
        self.return_data = None
        # optional concrete block parameters (Environment attribute -> BitVec)
        # applied to every Environment this tx spawns; used by fixture replay
        self.block_env = block_env

    def _apply_block_env(self, environment) -> None:
        for attr, value in (self.block_env or {}).items():
            setattr(environment, attr, value)

    def initial_global_state_from_environment(self, environment, active_function):
        """Seed a GlobalState for this tx + the sender-balance constraint."""
        from mythril_tpu_torch.core.state.machine_state import MachineState

        global_state = GlobalState(
            self.world_state,
            environment,
            machine_state=MachineState(gas_limit=self.gas_limit),
        )
        global_state.environment.active_function_name = active_function
        sender = environment.sender
        value = environment.callvalue
        # sender must afford the transfer (reference :120-145)
        global_state.world_state.constraints.append(
            UGE(global_state.world_state.balances[sender], value)
        )
        global_state.world_state.balances[sender] -= value
        global_state.world_state.balances[environment.active_account.address] += value
        return global_state

    def __str__(self):
        addr = (
            self.callee_account.address
            if self.callee_account is not None
            else "<creating>"
        )
        return f"{type(self).__name__} {self.id} to {addr}"


class MessageCallTransaction(BaseTransaction):
    """A symbolic or concrete message call (reference :159)."""

    def initial_global_state(self) -> GlobalState:
        environment = Environment(
            self.callee_account,
            self.caller,
            self.call_data,
            self.gas_price,
            self.call_value,
            self.origin,
            code=self.code or self.callee_account.code,
            basefee=self.base_fee,
            static=self.static,
        )
        self._apply_block_env(environment)
        return super().initial_global_state_from_environment(
            environment, active_function="fallback"
        )

    def end(self, global_state: GlobalState, return_data=None, revert: bool = False):
        self.return_data = return_data
        raise TransactionEndSignal(global_state, revert)


class ContractCreationTransaction(BaseTransaction):
    """Creation tx: executes init code, assigns runtime code on RETURN.

    Reference :194-271 — snapshots ``prev_world_state`` for exploit-report
    initial-state reconstruction, and ``end()`` installs the returned runtime
    bytecode into the created account.
    """

    def __init__(self, *args, contract_name=None, **kwargs):
        # snapshot the pre-state before the account is created
        world_state = kwargs.get("world_state") if "world_state" in kwargs else args[0]
        self.prev_world_state = _copy.copy(world_state)
        super().__init__(*args, **kwargs)
        self.contract_name = contract_name or "unknown_contract"
        if self.callee_account is None:
            self.callee_account = self.world_state.create_account(
                0, concrete_storage=True
            )
        self.callee_account.contract_name = self.contract_name

    def initial_global_state(self) -> GlobalState:
        environment = Environment(
            self.callee_account,
            self.caller,
            self.call_data,
            self.gas_price,
            self.call_value,
            self.origin,
            code=self.code,
            basefee=self.base_fee,
        )
        self._apply_block_env(environment)
        return super().initial_global_state_from_environment(
            environment, active_function="constructor"
        )

    def end(self, global_state: GlobalState, return_data=None, revert: bool = False):
        from mythril_tpu_torch.frontend.disassembler import Disassembly

        if not revert and return_data is not None:
            if not isinstance(return_data, (bytes, bytearray)):
                # runtime code with SYMBOLIC bytes: solc >= 0.8 writes
                # immutable values into PUSH operands of the returned code
                # before RETURN, and a constructor-argument-derived
                # immutable is symbolic.  DELIBERATE DEVIATION from the
                # reference (ROADMAP.md "Known deviations"): Mythril keeps
                # such entries symbolic — its Disassembly accepts BitVec
                # operand bytes (reference transaction_models.py:249-253),
                # so message-call analysis can still constrain the
                # immutable's value through the PUSHed symbol.  This build
                # concretizes the symbolic operand bytes to ZERO and
                # deploys.  The code STRUCTURE (opcodes, jump targets) is
                # identical, but any issue whose trigger depends on the
                # actual immutable value (e.g. an owner-address immutable
                # gating a selfdestruct) can be missed or mis-confirmed —
                # a recall risk accepted to keep deployed code fully
                # concrete for the device frontier's packed code buffers.
                return_data = bytes(
                    (b.value or 0) if hasattr(b, "value") else int(b)
                    for b in return_data
                )
            global_state.environment.active_account.code = Disassembly(bytes(return_data))
            self.return_data = global_state.environment.active_account.address
        elif not revert:
            self.return_data = None
        raise TransactionEndSignal(global_state, revert)
