"""Keccak-256 — host implementation for the PyTorch port.

Pure-Python copy of ``mythril_tpu/ops/keccak.py`` (FIPS-202 family with the
original Keccak padding 0x01, as Ethereum uses it), without the native
library dispatch.  It is the oracle for the device hash
(``ops/keccak_torch.py`` and the CUDA kernel) and the hash that
``smt/concrete_eval.py`` and constant folding use.
"""

from __future__ import annotations

from functools import lru_cache

_MASK64 = (1 << 64) - 1

# Rotation offsets r[x][y] from the Keccak spec.
_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

# Round constants for Keccak-f[1600].
_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]


def _rol(x: int, n: int) -> int:
    n %= 64
    return ((x << n) | (x >> (64 - n))) & _MASK64


def keccak_f1600(lanes):
    """One permutation of the 5x5 lane state (list of 25 ints, row-major x + 5*y)."""
    a = list(lanes)
    for rnd in range(24):
        # theta
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rol(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                a[x + 5 * y] ^= d[x]
        # rho + pi
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rol(a[x + 5 * y], _ROT[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                a[x + 5 * y] = b[x + 5 * y] ^ ((~b[(x + 1) % 5 + 5 * y]) & b[(x + 2) % 5 + 5 * y] & _MASK64)
        # iota
        a[0] ^= _RC[rnd]
    return a


def keccak256(data: bytes) -> bytes:
    """Ethereum's keccak256 (rate 1088, capacity 512, pad 0x01)."""
    return keccak256_py(data)


def keccak256_py(data: bytes) -> bytes:
    """Pure-Python keccak256 (reference oracle)."""
    rate = 136  # bytes
    # pad10*1 with Keccak domain byte 0x01
    padded = bytearray(data)
    pad_len = rate - (len(padded) % rate)
    if pad_len == 1:
        padded += b"\x81"
    else:
        padded += b"\x01" + b"\x00" * (pad_len - 2) + b"\x80"
    lanes = [0] * 25
    for block_start in range(0, len(padded), rate):
        block = padded[block_start : block_start + rate]
        for i in range(rate // 8):
            lanes[i] ^= int.from_bytes(block[8 * i : 8 * i + 8], "little")
        lanes = keccak_f1600(lanes)
    out = bytearray()
    for i in range(4):  # 32 bytes = 4 lanes
        out += lanes[i].to_bytes(8, "little")
    return bytes(out)


@lru_cache(maxsize=65536)
def _keccak256_cached(data: bytes) -> bytes:
    return keccak256(data)


def keccak256_int(value: int, nbytes: int) -> int:
    """keccak256 of ``value`` encoded big-endian in ``nbytes`` bytes, as int."""
    return int.from_bytes(_keccak256_cached(value.to_bytes(nbytes, "big")), "big")
