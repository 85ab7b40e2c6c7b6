"""ctypes wrapper for the native batched keccak-256.

Drop-in accelerator for the pure-Python host implementation
(mythril_tpu_torch/ops/keccak.py) — the counterpart of the reference's pysha3 C
extension (mythril/support/support_utils.py:5).  Returns None handles when
the library is unavailable so callers can fall back.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional

_lib = None
_lib_tried = False


def _load():
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    from mythril_tpu_torch.native.build import library_path

    path = library_path()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
        lib.keccak256_single.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8)
        ]
        lib.keccak256_batch.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        _lib = lib
    except OSError:
        pass
    return _lib


def available() -> bool:
    return _load() is not None


def keccak256(data: bytes) -> Optional[bytes]:
    lib = _load()
    if lib is None:
        return None
    out = (ctypes.c_uint8 * 32)()
    lib.keccak256_single(data, len(data), out)
    return bytes(out)


def keccak256_batch(messages: List[bytes]) -> Optional[List[bytes]]:
    """Uniform-length batch; None if unavailable or lengths differ."""
    lib = _load()
    if lib is None or not messages:
        return None
    n, ln = len(messages), len(messages[0])
    if any(len(m) != ln for m in messages):
        return None
    blob = b"".join(messages)
    out = (ctypes.c_uint8 * (32 * n))()
    lib.keccak256_batch(blob, n, ln, out)
    raw = bytes(out)
    return [raw[32 * i : 32 * (i + 1)] for i in range(n)]
