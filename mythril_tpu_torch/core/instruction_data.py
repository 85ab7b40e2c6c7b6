"""Per-opcode gas bounds + dynamic gas formulas.

Reference parity: mythril/laser/ethereum/instruction_data.py:17-56.
"""

from __future__ import annotations

from typing import Tuple

from mythril_tpu_torch.support.opcodes import OPCODES, gas_bounds, stack_inputs

GAS_CALLSTIPEND = 2300
GAS_SHA3WORD = 6
GAS_ECRECOVER = 3000
GAS_SHA256BASE = 60
GAS_SHA256WORD = 12
GAS_RIPEMD160BASE = 600
GAS_RIPEMD160WORD = 120
GAS_IDENTITYBASE = 15
GAS_IDENTITYWORD = 3


def get_required_stack_elements(opcode: str) -> int:
    return stack_inputs(opcode)


def get_opcode_gas(opcode: str) -> Tuple[int, int]:
    return gas_bounds(opcode)


def calculate_sha3_gas(length: int) -> Tuple[int, int]:
    gas = 30 + GAS_SHA3WORD * ((length + 31) // 32)
    return gas, gas


def calculate_native_gas(size: int, contract: str) -> Tuple[int, int]:
    words = (size + 31) // 32
    if contract == "ecrecover":
        gas = GAS_ECRECOVER
    elif contract == "sha256":
        gas = GAS_SHA256BASE + words * GAS_SHA256WORD
    elif contract == "ripemd160":
        gas = GAS_RIPEMD160BASE + words * GAS_RIPEMD160WORD
    elif contract == "identity":
        gas = GAS_IDENTITYBASE + words * GAS_IDENTITYWORD
    else:
        gas = 0
    return gas, gas
