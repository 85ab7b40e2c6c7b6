"""Symbolic EVM memory: byte-addressed, keyed by interned index terms.

Reference parity: mythril/laser/ethereum/state/memory.py:28-210.  Hash-consing
makes index canonicalization free (the reference re-simplifies every index);
missing bytes read as zero per EVM semantics.  Symbolic-length copies are
capped (reference APPROX_ITR=100, memory.py:25).
"""

from __future__ import annotations

from typing import Dict, List, Union

from mythril_tpu_torch.smt import BitVec, Concat, Extract, symbol_factory
from mythril_tpu_torch.smt.terms import Term

APPROX_ITR = 100


class Memory:
    def __init__(self):
        # raw index term -> byte BitVec
        self._memory: Dict[Term, BitVec] = {}

    def __copy__(self) -> "Memory":
        out = Memory.__new__(Memory)
        out._memory = dict(self._memory)
        return out

    copy = __copy__

    def _key(self, index: Union[int, BitVec]) -> Term:
        if isinstance(index, int):
            index = symbol_factory.BitVecVal(index, 256)
        return index.raw

    def __getitem__(self, index) -> BitVec:
        if isinstance(index, slice):
            start, stop = index.start, index.stop
            return [self.get_byte(start + i) for i in range(stop - start)]
        return self.get_byte(index)

    def __setitem__(self, index, value) -> None:
        if isinstance(index, slice):
            start = index.start
            for i, b in enumerate(value):
                self.set_byte(start + i, b)
            return
        self.set_byte(index, value)

    def get_byte(self, index) -> BitVec:
        key = self._key(index)
        v = self._memory.get(key)
        return v if v is not None else symbol_factory.BitVecVal(0, 8)

    def set_byte(self, index, value) -> None:
        if isinstance(value, int):
            value = symbol_factory.BitVecVal(value, 8)
        if value.size() != 8:
            value = Extract(7, 0, value)
        self._memory[self._key(index)] = value

    def __len__(self) -> int:
        return len(self._memory)

    def concrete_addresses(self):
        """Sorted concrete byte addresses of every written byte, or None if
        any index is symbolic (used by the frontier's mid-frame encoder to
        decide whether this memory can be packed into device entries)."""
        out = []
        for key in self._memory:
            if key.is_const:
                out.append(key.value)
            else:
                return None
        return sorted(out)

    def get_word_at(self, index) -> BitVec:
        """Big-endian 32-byte word at byte offset ``index``."""
        if isinstance(index, int):
            index = symbol_factory.BitVecVal(index, 256)
        return Concat(*[self.get_byte(index + i) for i in range(32)])

    def write_word_at(self, index, value) -> None:
        if isinstance(index, int):
            index = symbol_factory.BitVecVal(index, 256)
        if isinstance(value, int):
            value = symbol_factory.BitVecVal(value, 256)
        if isinstance(value, bool):
            value = symbol_factory.BitVecVal(1 if value else 0, 256)
        if hasattr(value, "is_true"):  # Bool -> 0/1 word
            from mythril_tpu_torch.smt import If

            value = If(value, symbol_factory.BitVecVal(1, 256), symbol_factory.BitVecVal(0, 256))
        assert value.size() == 256
        for i in range(32):
            self.set_byte(index + i, Extract(255 - 8 * i, 248 - 8 * i, value))

    def write_bytes(self, index, data) -> None:
        """Write a run of bytes (ints or 8-bit BitVecs) starting at index."""
        if isinstance(index, int):
            index = symbol_factory.BitVecVal(index, 256)
        for i, b in enumerate(data):
            self.set_byte(index + i, b)

    def read_bytes(self, index, length: int) -> List[BitVec]:
        if isinstance(index, int):
            index = symbol_factory.BitVecVal(index, 256)
        return [self.get_byte(index + i) for i in range(length)]
