"""EVM machine state: pc, bounds-checked stack, memory, gas accounting.

Reference parity: mythril/laser/ethereum/state/machine_state.py
(MachineStack :18-92 with the 1024 limit, MachineState :94-262,
mem_extend :170, calculate_memory_gas :147).
"""

from __future__ import annotations

from typing import List, Union

from mythril_tpu_torch.core.evm_exceptions import StackOverflowException, StackUnderflowException
from mythril_tpu_torch.core.state.memory import Memory

STACK_LIMIT = 1024


def ceil32(n: int) -> int:
    return (n + 31) // 32 * 32


class MachineStack(list):
    def append(self, element) -> None:
        if len(self) >= STACK_LIMIT:
            raise StackOverflowException(
                f"reached stack limit {STACK_LIMIT}, no room for a new element"
            )
        super().append(element)

    def pop(self, index: int = -1):
        try:
            return super().pop(index)
        except IndexError:
            raise StackUnderflowException("trying to pop from an empty stack")

    def __getitem__(self, item):
        try:
            return super().__getitem__(item)
        except IndexError:
            raise StackUnderflowException("stack index out of range")

    def __add__(self, other):
        raise NotImplementedError("concatenating machine stacks is not supported")

    def __iadd__(self, other):
        raise NotImplementedError("concatenating machine stacks is not supported")


class MachineState:
    def __init__(
        self,
        gas_limit: int,
        pc: int = 0,
        stack=None,
        memory: Memory = None,
        min_gas_used: int = 0,
        max_gas_used: int = 0,
        depth: int = 0,
    ):
        self.gas_limit = gas_limit
        self.pc = pc
        self.stack = MachineStack(stack if stack is not None else [])
        self.memory = memory if memory is not None else Memory()
        self.min_gas_used = min_gas_used  # lower bound along this path
        self.max_gas_used = max_gas_used  # upper bound along this path
        self.depth = depth
        self.memory_size = 0
        self.subroutine_stack: List[int] = []

    # -- gas ----------------------------------------------------------------
    def check_gas(self) -> None:
        from mythril_tpu_torch.core.evm_exceptions import OutOfGasException

        if self.min_gas_used > self.gas_limit:
            raise OutOfGasException("minimum gas used exceeds gas limit")

    @staticmethod
    def calculate_memory_gas(start: int, size: int) -> int:
        """Gas for extending memory to cover [start, start+size)."""
        if size == 0:
            return 0
        new_words = ceil32(start + size) // 32
        return 3 * new_words + new_words * new_words // 512

    def mem_extend(self, start: int, size: int) -> None:
        """Grow tracked memory size; charge the incremental expansion gas."""
        if size == 0:
            return
        new_size = ceil32(start + size)
        if new_size <= self.memory_size:
            return
        old_words = self.memory_size // 32
        new_words = new_size // 32
        old_cost = 3 * old_words + old_words * old_words // 512
        new_cost = 3 * new_words + new_words * new_words // 512
        cost = new_cost - old_cost
        self.min_gas_used += cost
        self.max_gas_used += cost
        self.memory_size = new_size
        self.check_gas()

    @property
    def gas_left(self) -> int:
        return self.gas_limit - self.min_gas_used

    def __copy__(self) -> "MachineState":
        out = MachineState(
            gas_limit=self.gas_limit,
            pc=self.pc,
            stack=list(self.stack),
            memory=self.memory.copy(),
            min_gas_used=self.min_gas_used,
            max_gas_used=self.max_gas_used,
            depth=self.depth,
        )
        out.memory_size = self.memory_size
        out.subroutine_stack = list(self.subroutine_stack)
        return out

    def __str__(self):
        return f"MachineState(pc={self.pc}, stack_size={len(self.stack)})"
