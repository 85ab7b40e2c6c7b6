"""Shared helpers: singleton metaclass, keccak conveniences, code hashing.

Reference parity: mythril/support/support_utils.py:10-73.
"""

from __future__ import annotations

from typing import Dict

from mythril_tpu_torch.ops.keccak import keccak256


class Singleton(type):
    """Classic metaclass singleton (reference support_utils.py:10)."""

    _instances: Dict[type, object] = {}

    def __call__(cls, *args, **kwargs):
        if cls not in cls._instances:
            cls._instances[cls] = super().__call__(*args, **kwargs)
        return cls._instances[cls]

    @classmethod
    def reset_all(mcs) -> None:
        """Drop every singleton instance (test isolation)."""
        mcs._instances.clear()


def sha3(data) -> bytes:
    """keccak256 over bytes or a hex string (0x-prefixed or bare)."""
    if isinstance(data, str):
        data = bytes.fromhex(data[2:] if data.startswith("0x") else data)
    return keccak256(bytes(data))


def get_code_hash(code) -> str:
    """0x-prefixed keccak of runtime bytecode (reference support_utils.py:50-60)."""
    if isinstance(code, str):
        code = bytes.fromhex(code[2:] if code.startswith("0x") else code)
    return "0x" + keccak256(bytes(code)).hex()


def zpad(data: bytes, size: int) -> bytes:
    return data.rjust(size, b"\x00")
