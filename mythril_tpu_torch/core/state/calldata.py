"""Calldata models: concrete, symbolic, and their list-backed variants.

Reference parity: mythril/laser/ethereum/state/calldata.py (4 models:
ConcreteCalldata :113, BasicConcreteCalldata :160, SymbolicCalldata :206,
BasicSymbolicCalldata :257).  ``concrete(model)`` reifies actual attack bytes
from a solver model for exploit reports (reference :233-246).
"""

from __future__ import annotations

from typing import List, Optional, Union

from mythril_tpu_torch.smt import Array, BitVec, If, K, symbol_factory
from mythril_tpu_torch.smt.concrete_eval import evaluate
from mythril_tpu_torch.smt.solver import Model


class BaseCalldata:
    def __init__(self, tx_id):
        self.tx_id = tx_id

    @property
    def calldatasize(self) -> BitVec:
        return self.size if isinstance(self.size, BitVec) else symbol_factory.BitVecVal(
            self.size, 256
        )

    @property
    def size(self):
        raise NotImplementedError

    def get_word_at(self, offset: Union[int, BitVec]) -> BitVec:
        """32-byte big-endian word starting at byte ``offset``."""
        if isinstance(offset, int):
            offset = symbol_factory.BitVecVal(offset, 256)
        from mythril_tpu_torch.smt import Concat

        return Concat(*[self._load(offset + i) for i in range(32)])

    def __getitem__(self, item) -> BitVec:
        if isinstance(item, slice):
            start = item.start or 0
            stop = item.stop
            from mythril_tpu_torch.smt import Concat

            parts = [self._load(start + i) for i in range(stop - start)]
            return Concat(*parts) if len(parts) > 1 else parts[0]
        return self._load(item)

    def _load(self, item) -> BitVec:
        raise NotImplementedError

    def concrete(self, model: Optional[Model]) -> List[int]:
        raise NotImplementedError


class ConcreteCalldata(BaseCalldata):
    """Fixed bytes backed by a constant array (reads fold to constants)."""

    def __init__(self, tx_id, calldata: List[int]):
        super().__init__(tx_id)
        self._calldata = list(calldata)
        arr = K(256, 8, 0)
        for i, b in enumerate(self._calldata):
            arr[symbol_factory.BitVecVal(i, 256)] = symbol_factory.BitVecVal(b, 8)
        self._array = arr

    @property
    def size(self) -> int:
        return len(self._calldata)

    def _load(self, item) -> BitVec:
        if isinstance(item, int):
            item = symbol_factory.BitVecVal(item, 256)
        return self._array[item]

    def concrete(self, model=None) -> List[int]:
        return list(self._calldata)


class BasicConcreteCalldata(BaseCalldata):
    """Plain-list calldata; symbolic reads become an ITE chain."""

    def __init__(self, tx_id, calldata: List[int]):
        super().__init__(tx_id)
        self._calldata = list(calldata)

    @property
    def size(self) -> int:
        return len(self._calldata)

    def _load(self, item) -> BitVec:
        if isinstance(item, int):
            if 0 <= item < len(self._calldata):
                return symbol_factory.BitVecVal(self._calldata[item], 8)
            return symbol_factory.BitVecVal(0, 8)
        value = symbol_factory.BitVecVal(0, 8)
        for i in range(len(self._calldata) - 1, -1, -1):
            value = If(
                item == symbol_factory.BitVecVal(i, 256),
                symbol_factory.BitVecVal(self._calldata[i], 8),
                value,
            )
        return value

    def concrete(self, model=None) -> List[int]:
        return list(self._calldata)


class SymbolicCalldata(BaseCalldata):
    """Fully symbolic: array variable + size symbol; OOB reads are zero."""

    def __init__(self, tx_id):
        super().__init__(tx_id)
        self._size = symbol_factory.BitVecSym(f"{tx_id}_calldatasize", 256)
        self._array = Array(f"{tx_id}_calldata", 256, 8)

    @property
    def size(self) -> BitVec:
        return self._size

    def _load(self, item) -> BitVec:
        if isinstance(item, int):
            item = symbol_factory.BitVecVal(item, 256)
        from mythril_tpu_torch.smt import ULT

        return If(ULT(item, self._size), self._array[item], symbol_factory.BitVecVal(0, 8))

    def concrete(self, model: Model) -> List[int]:
        size = model.eval(self._size)
        size = min(int(size), 5000)  # cap mirrors reference's sanity bound
        return [int(model.eval(self._load(i))) for i in range(size)]


class BasicSymbolicCalldata(BaseCalldata):
    """Symbolic calldata tracking each read (index, value) pair."""

    def __init__(self, tx_id):
        super().__init__(tx_id)
        self._size = symbol_factory.BitVecSym(f"{tx_id}_calldatasize", 256)
        self._reads: List = []

    @property
    def size(self) -> BitVec:
        return self._size

    def _load(self, item) -> BitVec:
        if isinstance(item, int):
            item = symbol_factory.BitVecVal(item, 256)
        sym = symbol_factory.BitVecSym(f"{self.tx_id}_calldata[{item.raw.tid}]", 8)
        for idx, val in self._reads:
            sym = If(item == idx, val, sym)
        self._reads.append((item, sym))
        return sym

    def concrete(self, model: Model) -> List[int]:
        size = min(int(model.eval(self._size)), 5000)
        out = [0] * size
        for idx, val in self._reads:
            i = int(model.eval(idx))
            if i < size:
                out[i] = int(model.eval(val))
        return out
