"""Bytecode disassembler + function-selector recovery.

Reference parity: mythril/disassembler/asm.py (instruction listing, PUSH
argument capture, metadata trim) and mythril/disassembler/disassembly.py:40-115
(dispatcher-pattern scan recovering selector -> entrypoint maps).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

from mythril_tpu_torch.support.opcodes import BYTE_TO_NAME, OPCODES


class EvmInstruction:
    __slots__ = ("address", "opcode", "argument")

    def __init__(self, address: int, opcode: str, argument: Optional[bytes] = None):
        self.address = address
        self.opcode = opcode
        self.argument = argument  # PUSH payload, big-endian bytes

    @property
    def arg_int(self) -> Optional[int]:
        return int.from_bytes(self.argument, "big") if self.argument is not None else None

    def to_dict(self) -> Dict:
        d = {"address": self.address, "opcode": self.opcode}
        if self.argument is not None:
            d["argument"] = "0x" + self.argument.hex()
        return d

    def __repr__(self):
        if self.argument is not None:
            return f"{self.address} {self.opcode} 0x{self.argument.hex()}"
        return f"{self.address} {self.opcode}"


_METADATA_RE = re.compile(
    rb"\xa1\x65bzzr[01]|\xa2\x64ipfs|\xa2\x65bzzr[01]|\xa3\x64ipfs"
)


def strip_metadata(bytecode: bytes) -> bytes:
    """Trim trailing solc CBOR metadata (swarm/ipfs hash).

    The last two bytes encode the metadata length; verify it lands on a known
    marker before trimming (reference asm.py:94-140 trims by regex).
    """
    if len(bytecode) < 4:
        return bytecode
    meta_len = int.from_bytes(bytecode[-2:], "big")
    if 0 < meta_len <= len(bytecode) - 2:
        meta = bytecode[-(meta_len + 2) : -2]
        if _METADATA_RE.search(meta):
            return bytecode[: -(meta_len + 2)]
    return bytecode


def disassemble(bytecode: bytes) -> List[EvmInstruction]:
    """Linear sweep: bytecode -> [EvmInstruction]; unknown bytes -> INVALID."""
    instructions = []
    pc = 0
    n = len(bytecode)
    while pc < n:
        byte = bytecode[pc]
        name = BYTE_TO_NAME.get(byte)
        if name is None:
            instructions.append(EvmInstruction(pc, "INVALID"))
            pc += 1
            continue
        if name.startswith("PUSH") and name != "PUSH0":
            width = int(name[4:])
            arg = bytes(bytecode[pc + 1 : pc + 1 + width])
            arg = arg + b"\x00" * (width - len(arg))  # implicit zero padding at EOF
            instructions.append(EvmInstruction(pc, name, arg))
            pc += 1 + width
        else:
            instructions.append(EvmInstruction(pc, name))
            pc += 1
    return instructions


def find_op_code_sequence(pattern: List[List[str]], instruction_list) -> List[int]:
    """Indices where ``pattern`` (list of allowed-opcode lists) matches.

    Reference parity: mythril/disassembler/asm.py:60.
    """
    hits = []
    n = len(instruction_list)
    k = len(pattern)
    for i in range(n - k + 1):
        if all(instruction_list[i + j].opcode in pattern[j] for j in range(k)):
            hits.append(i)
    return hits


def _selector_dispatch_sites(instructions: List[EvmInstruction]) -> List[Tuple[int, int]]:
    """(selector, entry_pc) pairs from solc dispatcher patterns.

    Matches both the classic ``DUP1 PUSH4 sel EQ PUSHn dest JUMPI`` and the
    via-IR / optimizer variants where the DUP is elsewhere.
    """
    out = []
    pattern = [["PUSH4", "PUSH3", "PUSH2", "PUSH1"], ["EQ"], ["PUSH2", "PUSH1", "PUSH3"], ["JUMPI"]]
    for i in find_op_code_sequence(pattern, instructions):
        sel = instructions[i].arg_int
        dest = instructions[i + 2].arg_int
        out.append((sel, dest))
    # GT/LT-split dispatchers still end in the EQ pattern per function, so the
    # scan above covers them; also catch `PUSH4 sel DUP2 EQ PUSHn dest JUMPI`.
    pattern2 = [["PUSH4"], ["DUP2", "DUP1"], ["EQ"], ["PUSH2", "PUSH1", "PUSH3"], ["JUMPI"]]
    for i in find_op_code_sequence(pattern2, instructions):
        sel = instructions[i].arg_int
        dest = instructions[i + 3].arg_int
        out.append((sel, dest))
    return out


class Disassembly:
    """Disassembly of one bytecode blob + recovered function entry points.

    Reference parity: mythril/disassembler/disassembly.py:9-115.
    """

    def __init__(self, code, enable_online_lookup: bool = False):
        if isinstance(code, str):
            code = bytes.fromhex(code[2:] if code.startswith("0x") else code)
        self.bytecode: bytes = bytes(code)
        stripped = strip_metadata(self.bytecode)
        self.instruction_list: List[EvmInstruction] = disassemble(stripped)
        self._index_by_address = {
            ins.address: i for i, ins in enumerate(self.instruction_list)
        }

        self.func_hashes: List[int] = []
        self.function_name_to_address: Dict[str, int] = {}
        self.address_to_function_name: Dict[int, str] = {}

        from mythril_tpu_torch.support.signatures import SignatureDB

        sigdb = SignatureDB(enable_online_lookup=enable_online_lookup)
        for selector, dest in _selector_dispatch_sites(self.instruction_list):
            self.func_hashes.append(selector)
            names = sigdb.get(f"0x{selector:08x}")
            name = names[0] if names else f"_function_0x{selector:08x}"
            self.function_name_to_address[name] = dest
            self.address_to_function_name[dest] = name

    def get_easm(self) -> str:
        lines = []
        for ins in self.instruction_list:
            if ins.argument is not None:
                lines.append(f"{ins.address} {ins.opcode} 0x{ins.argument.hex()}")
            else:
                lines.append(f"{ins.address} {ins.opcode}")
        return "\n".join(lines) + "\n"

    def instruction_at(self, address: int) -> Optional[EvmInstruction]:
        i = self._index_by_address.get(address)
        return self.instruction_list[i] if i is not None else None

    def index_of_address(self, address: int) -> Optional[int]:
        return self._index_by_address.get(address)

    def __len__(self):
        return len(self.instruction_list)
