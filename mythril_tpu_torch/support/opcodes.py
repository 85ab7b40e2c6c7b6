"""EVM opcode table: byte value, stack arity, and static gas bounds.

Role parity with the reference's table (mythril/support/opcodes.py:16-144):
maps mnemonic -> (byte, #stack-inputs, #stack-outputs, min_gas, max_gas).
Dynamic gas components (memory expansion, sha3 words, call stipends, ...) are
added by the interpreter via instruction_data.get_opcode_gas.

Covers the Shanghai instruction set (incl. PUSH0, BASEFEE, PREVRANDAO).
"""

from __future__ import annotations

from typing import Dict, Tuple

# mnemonic: (opcode byte, stack inputs, stack outputs, gas_min, gas_max)
OPCODES: Dict[str, Tuple[int, int, int, int, int]] = {}


def _op(name, byte, ins, outs, gmin, gmax=None):
    OPCODES[name] = (byte, ins, outs, gmin, gmax if gmax is not None else gmin)


_op("STOP", 0x00, 0, 0, 0)
_op("ADD", 0x01, 2, 1, 3)
_op("MUL", 0x02, 2, 1, 5)
_op("SUB", 0x03, 2, 1, 3)
_op("DIV", 0x04, 2, 1, 5)
_op("SDIV", 0x05, 2, 1, 5)
_op("MOD", 0x06, 2, 1, 5)
_op("SMOD", 0x07, 2, 1, 5)
_op("ADDMOD", 0x08, 3, 1, 8)
_op("MULMOD", 0x09, 3, 1, 8)
_op("EXP", 0x0A, 2, 1, 10, 10 + 50 * 32)
_op("SIGNEXTEND", 0x0B, 2, 1, 5)

_op("LT", 0x10, 2, 1, 3)
_op("GT", 0x11, 2, 1, 3)
_op("SLT", 0x12, 2, 1, 3)
_op("SGT", 0x13, 2, 1, 3)
_op("EQ", 0x14, 2, 1, 3)
_op("ISZERO", 0x15, 1, 1, 3)
_op("AND", 0x16, 2, 1, 3)
_op("OR", 0x17, 2, 1, 3)
_op("XOR", 0x18, 2, 1, 3)
_op("NOT", 0x19, 1, 1, 3)
_op("BYTE", 0x1A, 2, 1, 3)
_op("SHL", 0x1B, 2, 1, 3)
_op("SHR", 0x1C, 2, 1, 3)
_op("SAR", 0x1D, 2, 1, 3)

_op("SHA3", 0x20, 2, 1, 30, 30 + 6 * 8)
_op("KECCAK256", 0x20, 2, 1, 30, 30 + 6 * 8)

_op("ADDRESS", 0x30, 0, 1, 2)
_op("BALANCE", 0x31, 1, 1, 700)
_op("ORIGIN", 0x32, 0, 1, 2)
_op("CALLER", 0x33, 0, 1, 2)
_op("CALLVALUE", 0x34, 0, 1, 2)
_op("CALLDATALOAD", 0x35, 1, 1, 3)
_op("CALLDATASIZE", 0x36, 0, 1, 2)
_op("CALLDATACOPY", 0x37, 3, 0, 2, 2 + 3 * 768)
_op("CODESIZE", 0x38, 0, 1, 2)
_op("CODECOPY", 0x39, 3, 0, 2, 2 + 3 * 768)
_op("GASPRICE", 0x3A, 0, 1, 2)
_op("EXTCODESIZE", 0x3B, 1, 1, 700)
_op("EXTCODECOPY", 0x3C, 4, 0, 700, 700 + 3 * 768)
_op("RETURNDATASIZE", 0x3D, 0, 1, 2)
_op("RETURNDATACOPY", 0x3E, 3, 0, 3)
_op("EXTCODEHASH", 0x3F, 1, 1, 700)

_op("BLOCKHASH", 0x40, 1, 1, 20)
_op("COINBASE", 0x41, 0, 1, 2)
_op("TIMESTAMP", 0x42, 0, 1, 2)
_op("NUMBER", 0x43, 0, 1, 2)
_op("DIFFICULTY", 0x44, 0, 1, 2)
_op("PREVRANDAO", 0x44, 0, 1, 2)
_op("GASLIMIT", 0x45, 0, 1, 2)
_op("CHAINID", 0x46, 0, 1, 2)
_op("SELFBALANCE", 0x47, 0, 1, 5)
_op("BASEFEE", 0x48, 0, 1, 2)

_op("POP", 0x50, 1, 0, 2)
_op("MLOAD", 0x51, 1, 1, 3, 96)
_op("MSTORE", 0x52, 2, 0, 3, 98)
_op("MSTORE8", 0x53, 2, 0, 3, 98)
_op("SLOAD", 0x54, 1, 1, 800)
_op("SSTORE", 0x55, 2, 0, 5000, 25000)
_op("JUMP", 0x56, 1, 0, 8)
_op("JUMPI", 0x57, 2, 0, 10)
_op("PC", 0x58, 0, 1, 2)
_op("MSIZE", 0x59, 0, 1, 2)
_op("GAS", 0x5A, 0, 1, 2)
_op("JUMPDEST", 0x5B, 0, 0, 1)
_op("PUSH0", 0x5F, 0, 1, 2)

for _n in range(1, 33):
    _op(f"PUSH{_n}", 0x5F + _n, 0, 1, 3)
for _n in range(1, 17):
    _op(f"DUP{_n}", 0x7F + _n, _n, _n + 1, 3)
for _n in range(1, 17):
    _op(f"SWAP{_n}", 0x8F + _n, _n + 1, _n + 1, 3)
for _n in range(0, 5):
    _op(f"LOG{_n}", 0xA0 + _n, _n + 2, 0, 375 + 375 * _n, 375 + 375 * _n + 8 * 32)

_op("CREATE", 0xF0, 3, 1, 32000, 32000)
_op("CALL", 0xF1, 7, 1, 700, 700 + 9000 + 25000)
_op("CALLCODE", 0xF2, 7, 1, 700, 700 + 9000 + 25000)
_op("RETURN", 0xF3, 2, 0, 0)
_op("DELEGATECALL", 0xF4, 6, 1, 700, 700 + 9000 + 25000)
_op("CREATE2", 0xF5, 4, 1, 32000, 32000 + 6 * 768)
_op("STATICCALL", 0xFA, 6, 1, 700, 700 + 9000 + 25000)
_op("REVERT", 0xFD, 2, 0, 0)
_op("INVALID", 0xFE, 0, 0, 0)
_op("SELFDESTRUCT", 0xFF, 1, 0, 5000, 30000 + 25000)

# byte -> mnemonic (PREVRANDAO/KECCAK256 aliases resolve to canonical names)
BYTE_TO_NAME: Dict[int, str] = {}
for _name, (_byte, *_rest) in OPCODES.items():
    if _name in ("PREVRANDAO", "KECCAK256"):
        continue
    BYTE_TO_NAME.setdefault(_byte, _name)


def opcode_byte(name: str) -> int:
    return OPCODES[name][0]


def stack_inputs(name: str) -> int:
    return OPCODES[name][1]


def stack_outputs(name: str) -> int:
    return OPCODES[name][2]


def gas_bounds(name: str) -> Tuple[int, int]:
    _, _, _, gmin, gmax = OPCODES[name]
    return gmin, gmax
