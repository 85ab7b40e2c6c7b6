"""Exception hierarchy (reference parity: mythril/exceptions.py:4-44)."""


class MythrilBaseException(Exception):
    """Base for all framework exceptions."""


class CompilerError(MythrilBaseException):
    """solc invocation failed."""


class UnsatError(MythrilBaseException):
    """Constraint set has no model (or none could be found in budget)."""


class NoContractFoundError(MythrilBaseException):
    """Input file contained no contract."""


class CriticalError(MythrilBaseException):
    """User-facing fatal error (bad args, unreachable RPC, ...)."""


class AddressNotFoundError(MythrilBaseException):
    """Function address not found in disassembly."""


class DetectorNotFoundError(MythrilBaseException):
    """Unknown detection module name."""


class IllegalArgumentError(ValueError, MythrilBaseException):
    """Bad argument to an API entry point."""
