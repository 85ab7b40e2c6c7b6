"""Concrete-vs-symbolic variable wrappers + the Call op record.

Reference parity: mythril/analysis/ops.py:9-93 and call_helpers.py:10.
"""

from __future__ import annotations

from enum import Enum

from mythril_tpu_torch.smt import BitVec


class VarType(Enum):
    SYMBOLIC = 1
    CONCRETE = 2


class Variable:
    def __init__(self, val, var_type: VarType):
        self.val = val
        self.type = var_type

    def __str__(self):
        return str(self.val)


def get_variable(i) -> Variable:
    try:
        from mythril_tpu_torch.core.util import get_concrete_int

        return Variable(get_concrete_int(i), VarType.CONCRETE)
    except TypeError:
        return Variable(i, VarType.SYMBOLIC)


class Op:
    def __init__(self, node, state, state_index):
        self.node = node
        self.state = state
        self.state_index = state_index


class Call(Op):
    def __init__(self, node, state, state_index, call_type, to, gas, value=None):
        super().__init__(node, state, state_index)
        self.to = to
        self.gas = gas
        self.type = call_type
        self.value = value if value is not None else Variable(0, VarType.CONCRETE)
