"""Flat numpy instruction tables for the static pass.

The pass operates on the same decoded instruction stream
``frontier/code.py`` consumes (``EvmInstruction`` lists produced by
``frontend/disassembler.disassemble``), re-expressed as dense per-
instruction numpy arrays indexed by *instruction index* — the identical
pc convention CodeTables uses, so every mask the pass produces aligns
1:1 with the device dispatch tables.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

# ops that end a basic block with no successors
TERMINATORS = frozenset(
    {"STOP", "RETURN", "REVERT", "SELFDESTRUCT", "INVALID", "ASSERT_FAIL"}
)


class InstrTables:
    """Per-instruction arrays: the static pass's working representation."""

    def __init__(self, instruction_list: List):
        from mythril_tpu_torch.support.opcodes import OPCODES

        n = len(instruction_list)
        self.n = n
        self.names: List[str] = [ins.opcode for ins in instruction_list]
        self.addr = np.zeros(n, np.int32)
        self.width = np.ones(n, np.int32)  # byte length incl. PUSH payload
        self.arity = np.zeros(n, np.int32)  # stack pops
        self.pushes = np.zeros(n, np.int32)  # stack pushes
        self.arg = [None] * n  # PUSH immediate (int) or None
        self.is_jumpdest = np.zeros(n, bool)
        self.is_jump = np.zeros(n, bool)
        self.is_jumpi = np.zeros(n, bool)
        self.is_terminator = np.zeros(n, bool)
        self.jumpdest_at_addr: Dict[int, int] = {}  # byte addr -> instr idx

        for i, ins in enumerate(instruction_list):
            name = ins.opcode
            self.addr[i] = ins.address
            if ins.argument is not None:
                self.width[i] = 1 + len(ins.argument)
                self.arg[i] = ins.arg_int
            info = OPCODES.get(name)
            if info is not None:
                self.arity[i] = info[1]
                self.pushes[i] = info[2]
            if name == "JUMPDEST":
                self.is_jumpdest[i] = True
                self.jumpdest_at_addr[ins.address] = i
            elif name == "JUMP":
                self.is_jump[i] = True
            elif name == "JUMPI":
                self.is_jumpi[i] = True
            elif name in TERMINATORS:
                self.is_terminator[i] = True

        self.delta = self.pushes - self.arity
