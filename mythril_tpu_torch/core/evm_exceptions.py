"""VM-level exception family (reference parity: laser/ethereum/evm_exceptions.py:1-43)."""


class VmException(Exception):
    """Base for exceptional halts inside the symbolic VM."""


class StackUnderflowException(IndexError, VmException):
    pass


class StackOverflowException(VmException):
    pass


class InvalidJumpDestination(VmException):
    pass


class InvalidInstruction(VmException):
    pass


class OutOfGasException(VmException):
    pass


class WriteProtection(VmException):
    """State modification attempted inside STATICCALL context."""
