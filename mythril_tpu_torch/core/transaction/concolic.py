"""Concrete (concolic) transaction drivers: replay recorded transactions.

Reference parity: mythril/laser/ethereum/transaction/concolic.py:23-172.
"""

from __future__ import annotations

from typing import List, Optional

from mythril_tpu_torch.core.state.calldata import ConcreteCalldata
from mythril_tpu_torch.core.transaction.transaction_models import (
    ContractCreationTransaction,
    MessageCallTransaction,
    tx_id_manager,
)
from mythril_tpu_torch.frontend.disassembler import Disassembly
from mythril_tpu_torch.smt import symbol_factory


def execute_message_call(
    laser_evm,
    callee_address,
    caller_address,
    origin_address,
    code,
    data: List[int],
    gas_limit: int,
    gas_price: int,
    value: int,
    track_gas: bool = False,
    block_env: Optional[dict] = None,
):
    """Replay one concrete message call (reference :75-130).

    ``block_env`` maps Environment attribute names (block_number, timestamp,
    coinbase, difficulty, block_gaslimit) to concrete BitVecs so fixtures
    with known block parameters replay exactly."""
    open_states = laser_evm.open_states[:]
    del laser_evm.open_states[:]
    result = []
    for open_world_state in open_states:
        next_tx_id = tx_id_manager.get_next_tx_id()
        transaction = MessageCallTransaction(
            world_state=open_world_state,
            identifier=next_tx_id,
            gas_limit=gas_limit,
            origin=_bv(origin_address),
            caller=_bv(caller_address),
            callee_account=open_world_state[_to_int(callee_address)],
            call_data=ConcreteCalldata(next_tx_id, data),
            gas_price=_bv(gas_price),
            call_value=_bv(value),
            static=False,
            block_env=block_env,
        )
        _setup(laser_evm, transaction)
        result = laser_evm.exec(track_gas=track_gas)
    return result


def execute_contract_creation(
    laser_evm,
    contract_initialization_code: str,
    caller_address,
    origin_address,
    world_state=None,
    gas_limit: int = 8_000_000,
    gas_price: int = 0,
    value: int = 0,
    contract_name: Optional[str] = None,
    track_gas: bool = False,
):
    """Replay a concrete creation transaction (reference :23-72)."""
    from mythril_tpu_torch.core.state.world_state import WorldState

    world_state = world_state or WorldState()
    del laser_evm.open_states[:]
    next_tx_id = tx_id_manager.get_next_tx_id()
    transaction = ContractCreationTransaction(
        world_state=world_state,
        identifier=next_tx_id,
        gas_limit=gas_limit,
        origin=_bv(origin_address),
        caller=_bv(caller_address),
        code=Disassembly(bytes.fromhex(contract_initialization_code.replace("0x", ""))),
        # concrete replay: constructor args are embedded in the creation
        # hex — the symbolic constructor-arg default must not apply
        call_data=ConcreteCalldata(next_tx_id, []),
        gas_price=_bv(gas_price),
        call_value=_bv(value),
        contract_name=contract_name,
    )
    _setup(laser_evm, transaction)
    result = laser_evm.exec(create=True, track_gas=track_gas)
    return transaction.callee_account, result


def _setup(laser_evm, transaction) -> None:
    global_state = transaction.initial_global_state()
    global_state.transaction_stack.append((transaction, None))
    global_state.world_state.transaction_sequence.append(transaction)
    if laser_evm.requires_statespace:
        from mythril_tpu_torch.core.cfg import Node

        node = Node(
            transaction.callee_account.contract_name
            if transaction.callee_account
            else "unknown"
        )
        laser_evm.nodes[node.uid] = node
        global_state.node = node
        global_state.world_state.node = node
    laser_evm.work_list.append(global_state)


def _bv(value):
    if isinstance(value, int):
        return symbol_factory.BitVecVal(value, 256)
    if isinstance(value, str):
        return symbol_factory.BitVecVal(int(value, 16), 256)
    return value


def _to_int(value) -> int:
    if isinstance(value, str):
        return int(value, 16)
    if isinstance(value, int):
        return value
    return value.value
