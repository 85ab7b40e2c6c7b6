"""CALL-family parameter plumbing: pop args, resolve callee, build calldata.

Reference parity: mythril/laser/ethereum/call.py:31-258 — including the
``Storage[n]`` regex trick for resolving callee addresses stored in storage
via the dynamic loader (reference :103-115) and precompile routing (:207-258).
"""

from __future__ import annotations

import logging
import re
from typing import List, Optional, Tuple, Union

from mythril_tpu_torch.core.state.calldata import (
    BaseCalldata,
    ConcreteCalldata,
    SymbolicCalldata,
)
from mythril_tpu_torch.core.state.global_state import GlobalState
from mythril_tpu_torch.core import natives
from mythril_tpu_torch.core.instruction_data import calculate_native_gas
from mythril_tpu_torch.smt import BitVec, symbol_factory

log = logging.getLogger(__name__)

SYMBOLIC_CALLDATA_SIZE = 320  # reference call.py:31

PRECOMPILE_COUNT = len(natives.PRECOMPILE_FUNCTIONS)


class SymbolicCalleeError(Exception):
    """Callee address cannot be resolved to anything executable."""


def get_call_output_location(global_state: GlobalState, op_code: str):
    """Peek (not pop) the ret-out memory window operands."""
    stack = global_state.mstate.stack
    if op_code in ("CALL", "CALLCODE"):
        return stack[-6], stack[-7]
    return stack[-5], stack[-6]


def get_call_parameters(
    global_state: GlobalState, dynamic_loader, with_value: bool = False
):
    """Pop and resolve all CALL-family operands.

    Returns (callee_address, callee_account, call_data, value, gas,
    memory_out_offset, memory_out_size).
    """
    stack = global_state.mstate.stack
    gas = stack.pop()
    to = stack.pop()
    value = stack.pop() if with_value else symbol_factory.BitVecVal(0, 256)
    memory_input_offset = stack.pop()
    memory_input_size = stack.pop()
    memory_out_offset = stack.pop()
    memory_out_size = stack.pop()

    callee_address = get_callee_address(global_state, dynamic_loader, to)
    callee_account = None
    call_data = get_call_data(global_state, memory_input_offset, memory_input_size)

    if isinstance(callee_address, BitVec) and callee_address.value is None:
        # fully symbolic callee — caller decides how to model it
        raise SymbolicCalleeError()

    addr_int = (
        callee_address.value
        if isinstance(callee_address, BitVec)
        else int(callee_address, 16)
    )
    if not (0 < addr_int <= PRECOMPILE_COUNT):
        callee_account = global_state.world_state.accounts_exist_or_load(
            addr_int, dynamic_loader
        )
    if isinstance(callee_address, str):
        callee_address = symbol_factory.BitVecVal(int(callee_address, 16), 256)
    return (
        callee_address,
        callee_account,
        call_data,
        value,
        gas,
        memory_out_offset,
        memory_out_size,
    )


def get_callee_address(global_state: GlobalState, dynamic_loader, symbolic_to_address):
    """Resolve the callee: concrete value, or a storage-slot load via RPC.

    Reference parity: call.py:83-126 — a symbolic address whose term is a
    storage read of the active account triggers a dynamic-loader lookup.
    """
    if symbolic_to_address.value is not None:
        return symbolic_to_address

    # match select(Storage[addr], <const idx>) terms
    raw = symbolic_to_address.raw
    if (
        raw.op == "select"
        and raw.args[0].op == "array_var"
        and raw.args[1].is_const
        and dynamic_loader is not None
        and getattr(dynamic_loader, "active", False)
    ):
        m = re.match(r"Storage\[0x([0-9a-f]+)\]", raw.args[0].aux or "")
        if m:
            contract_addr = f"0x{int(m.group(1), 16):040x}"
            try:
                slot = raw.args[1].value
                value = dynamic_loader.read_storage(contract_addr, slot)
                return "0x" + value[-40:].rjust(40, "0")
            except Exception:  # noqa: BLE001 — loader failure = unresolvable
                log.debug("dynamic callee resolution failed")
    return symbolic_to_address


def get_call_data(global_state: GlobalState, memory_start, memory_size) -> BaseCalldata:
    """Build the child tx's calldata view from caller memory (reference :151-205)."""
    mstate = global_state.mstate
    tx_id = f"{global_state.current_transaction.id}_internalcall"
    if memory_start.value is not None and memory_size.value is not None:
        size = min(memory_size.value, 0x10000)
        raw_bytes = mstate.memory.read_bytes(memory_start.value, size)
        if all(b.value is not None for b in raw_bytes):
            return ConcreteCalldata(tx_id, [b.value for b in raw_bytes])
        # symbolic bytes present: keep a basic concrete view over the terms
        from mythril_tpu_torch.core.state.calldata import BasicConcreteCalldata

        class _TermCalldata(BaseCalldata):
            def __init__(self, tx_id_, data):
                super().__init__(tx_id_)
                self._data = data

            @property
            def size(self):
                return len(self._data)

            def _load(self, item):
                if isinstance(item, int):
                    return (
                        self._data[item]
                        if 0 <= item < len(self._data)
                        else symbol_factory.BitVecVal(0, 8)
                    )
                value = symbol_factory.BitVecVal(0, 8)
                from mythril_tpu_torch.smt import If

                for i in range(len(self._data) - 1, -1, -1):
                    value = If(
                        item == symbol_factory.BitVecVal(i, 256), self._data[i], value
                    )
                return value

            def concrete(self, model):
                return [
                    b.value if b.value is not None else int(model.eval(b)) if model else 0
                    for b in self._data
                ]

        return _TermCalldata(tx_id, raw_bytes)
    log.debug("symbolic calldata window for inner call; using symbolic calldata")
    return SymbolicCalldata(tx_id)


def native_call(
    global_state: GlobalState,
    callee_address,
    call_data: BaseCalldata,
    memory_out_offset,
    memory_out_size,
) -> Optional[List[GlobalState]]:
    """Execute a precompile inline; None if the target is not a precompile.

    Reference parity: call.py:207-258 — symbolic input raises
    NativeContractException and degrades to fresh symbols in the out window.
    """
    if not isinstance(callee_address, BitVec) or callee_address.value is None:
        return None
    addr_int = callee_address.value
    if not (0 < addr_int <= PRECOMPILE_COUNT):
        return None

    contract_name = natives.PRECOMPILE_NAMES[addr_int - 1]
    instr = global_state.get_current_instruction()

    try:
        data = call_data.concrete(None)
        gmin, gmax = calculate_native_gas(len(data), contract_name)
        global_state.mstate.min_gas_used += gmin
        global_state.mstate.max_gas_used += gmax
        result_bytes = natives.native_contracts(addr_int, data)
        success = True
    except natives.NativeContractException:
        result_bytes = None
        success = False

    mem_out_start = memory_out_offset.value
    mem_out_size = memory_out_size.value if memory_out_size.value is not None else 32
    if result_bytes is not None and mem_out_start is not None:
        n = min(len(result_bytes), mem_out_size)
        for i in range(n):
            global_state.mstate.memory.set_byte(mem_out_start + i, result_bytes[i])
        global_state.last_return_data = bytes(result_bytes)
    elif mem_out_start is not None:
        # symbolic precompile input: fresh symbols in the out window
        for i in range(min(mem_out_size, 32)):
            global_state.mstate.memory.set_byte(
                mem_out_start + i,
                global_state.new_bitvec(f"{contract_name}_out_{instr['address']}_{i}", 8),
            )
        global_state.last_return_data = None

    ret = global_state.new_bitvec(f"retval_{instr['address']}", 256)
    global_state.mstate.stack.append(ret)
    global_state.world_state.constraints.append(
        ret == symbol_factory.BitVecVal(1 if success or result_bytes is None else 0, 256)
    )
    return [global_state]
