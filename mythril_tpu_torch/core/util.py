"""Concrete/symbolic conversion helpers (reference parity: laser/ethereum/util.py:36-176)."""

from __future__ import annotations

from typing import List, Optional, Union

from mythril_tpu_torch.smt import BitVec, symbol_factory


def get_concrete_int(item: Union[int, BitVec]) -> int:
    """Int value of a concrete BitVec; TypeError if symbolic (reference util.py:89)."""
    if isinstance(item, int):
        return item
    if isinstance(item, BitVec):
        if item.value is None:
            raise TypeError("symbolic value where concrete value expected")
        return item.value
    raise TypeError(f"cannot convert {type(item)} to concrete int")


def get_instruction_index(instruction_list, address: int) -> Optional[int]:
    """Index of the instruction at byte ``address`` (reference util.py:36)."""
    for i, ins in enumerate(instruction_list):
        if ins.address == address:
            return i
    return None


def concrete_int_from_bytes(data: List, offset: int) -> int:
    word = data[offset : offset + 32]
    out = 0
    for b in word:
        v = b if isinstance(b, int) else b.value
        out = (out << 8) | (v or 0)
    out <<= 8 * (32 - len(word))
    return out


def extract_copy(destination, source: bytes, dest_offset: int, offset: int, size: int) -> None:
    for i in range(size):
        destination[dest_offset + i] = source[offset + i] if offset + i < len(source) else 0


def pretty_state(global_state) -> str:
    ms = global_state.mstate
    return f"pc={ms.pc} op={global_state.get_current_instruction()['opcode']} stack={ms.stack}"
