"""The 9 EVM precompiled contracts, concretely executed on host.

Reference parity: mythril/laser/ethereum/natives.py:76-253.  The reference
leans on native wheels (coincurve/py_ecc/blake2b-py); none exist in this
environment, so the math is carried in-repo: secp256k1 recovery and bn128
group ops in pure modular arithmetic, RIPEMD-160 from spec (OpenSSL 3 often
drops it), blake2b F from EIP-152.  Symbolic input raises
NativeContractException; the caller degrades to fresh symbols
(reference call.py:241-250).  bn128 *pairing* is the one op still deferred
(raises NativeContractException → safely over-approximated).
"""

from __future__ import annotations

import hashlib
from typing import List

from mythril_tpu_torch.ops.keccak import keccak256


class NativeContractException(Exception):
    """Input not fully concrete, or unsupported — degrade to symbols."""


def _concrete_bytes(data: List) -> bytes:
    out = bytearray()
    for b in data:
        if isinstance(b, int):
            out.append(b)
        elif getattr(b, "value", None) is not None:
            out.append(b.value)
        else:
            raise NativeContractException("symbolic byte in native call input")
    return bytes(out)


def _word(data: bytes, i: int) -> int:
    return int.from_bytes(data[32 * i : 32 * (i + 1)].ljust(32, b"\x00"), "big")


# ---------------------------------------------------------------------------
# secp256k1 (for ecrecover)
# ---------------------------------------------------------------------------

_P = 2**256 - 2**32 - 977
_N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
_GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
_GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8


def _inv_mod(a: int, m: int) -> int:
    return pow(a, -1, m)


def _ec_add_jac(p1, p2, p):
    """Affine point addition on y^2 = x^3 + ax + b over F_p (a irrelevant here
    since we never add a point to itself via this path without doubling)."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % p == 0:
            return None
        # doubling (secp256k1/bn128 both have a=0)
        lam = (3 * x1 * x1) * _inv_mod(2 * y1, p) % p
    else:
        lam = (y2 - y1) * _inv_mod(x2 - x1, p) % p
    x3 = (lam * lam - x1 - x2) % p
    y3 = (lam * (x1 - x3) - y1) % p
    return (x3, y3)


def _ec_mul_point(point, scalar: int, p: int):
    result = None
    addend = point
    while scalar:
        if scalar & 1:
            result = _ec_add_jac(result, addend, p)
        addend = _ec_add_jac(addend, addend, p)
        scalar >>= 1
    return result


def ecrecover_address(msg_hash: bytes, v: int, r: int, s: int) -> bytes:
    """Recover the signer address; b'' on any failure (EVM returns empty)."""
    if v not in (27, 28):
        return b""
    if not (0 < r < _N and 0 < s < _N):
        return b""
    x = r
    if x >= _P:
        return b""
    # lift x to a curve point
    y_sq = (pow(x, 3, _P) + 7) % _P
    y = pow(y_sq, (_P + 1) // 4, _P)
    if (y * y) % _P != y_sq:
        return b""
    if (y % 2) != ((v - 27) % 2):
        y = _P - y
    R = (x, y)
    e = int.from_bytes(msg_hash, "big") % _N
    r_inv = _inv_mod(r, _N)
    u1 = (-e * r_inv) % _N
    u2 = (s * r_inv) % _N
    q = _ec_add_jac(
        _ec_mul_point((_GX, _GY), u1, _P), _ec_mul_point(R, u2, _P), _P
    )
    if q is None:
        return b""
    qx, qy = q
    pub = qx.to_bytes(32, "big") + qy.to_bytes(32, "big")
    return keccak256(pub)[12:]


def ecrecover(data: List) -> List[int]:
    data_bytes = _concrete_bytes(data).ljust(128, b"\x00")
    msg_hash = data_bytes[0:32]
    v = _word(data_bytes, 1)
    r = _word(data_bytes, 2)
    s = _word(data_bytes, 3)
    try:
        addr = ecrecover_address(msg_hash, v, r, s)
    except Exception:  # noqa: BLE001 — any math failure = empty result
        return []
    if not addr:
        return []
    return list(addr.rjust(32, b"\x00"))


# ---------------------------------------------------------------------------
# sha256 / ripemd160 / identity / modexp
# ---------------------------------------------------------------------------


def sha256(data: List) -> List[int]:
    return list(hashlib.sha256(_concrete_bytes(data)).digest())


def _ripemd160_py(data: bytes) -> bytes:
    """Pure-python RIPEMD-160 (spec implementation; OpenSSL 3 drops it)."""
    import struct

    def rol(x, n):
        return ((x << n) | (x >> (32 - n))) & 0xFFFFFFFF

    K1 = [0x00000000, 0x5A827999, 0x6ED9EBA1, 0x8F1BBCDC, 0xA953FD4E]
    K2 = [0x50A28BE6, 0x5C4DD124, 0x6D703EF3, 0x7A6D76E9, 0x00000000]
    R1 = [
        0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
        7, 4, 13, 1, 10, 6, 15, 3, 12, 0, 9, 5, 2, 14, 11, 8,
        3, 10, 14, 4, 9, 15, 8, 1, 2, 7, 0, 6, 13, 11, 5, 12,
        1, 9, 11, 10, 0, 8, 12, 4, 13, 3, 7, 15, 14, 5, 6, 2,
        4, 0, 5, 9, 7, 12, 2, 10, 14, 1, 3, 8, 11, 6, 15, 13,
    ]
    R2 = [
        5, 14, 7, 0, 9, 2, 11, 4, 13, 6, 15, 8, 1, 10, 3, 12,
        6, 11, 3, 7, 0, 13, 5, 10, 14, 15, 8, 12, 4, 9, 1, 2,
        15, 5, 1, 3, 7, 14, 6, 9, 11, 8, 12, 2, 10, 0, 4, 13,
        8, 6, 4, 1, 3, 11, 15, 0, 5, 12, 2, 13, 9, 7, 10, 14,
        12, 15, 10, 4, 1, 5, 8, 7, 6, 2, 13, 14, 0, 3, 9, 11,
    ]
    S1 = [
        11, 14, 15, 12, 5, 8, 7, 9, 11, 13, 14, 15, 6, 7, 9, 8,
        7, 6, 8, 13, 11, 9, 7, 15, 7, 12, 15, 9, 11, 7, 13, 12,
        11, 13, 6, 7, 14, 9, 13, 15, 14, 8, 13, 6, 5, 12, 7, 5,
        11, 12, 14, 15, 14, 15, 9, 8, 9, 14, 5, 6, 8, 6, 5, 12,
        9, 15, 5, 11, 6, 8, 13, 12, 5, 12, 13, 14, 11, 8, 5, 6,
    ]
    S2 = [
        8, 9, 9, 11, 13, 15, 15, 5, 7, 7, 8, 11, 14, 14, 12, 6,
        9, 13, 15, 7, 12, 8, 9, 11, 7, 7, 12, 7, 6, 15, 13, 11,
        9, 7, 15, 11, 8, 6, 6, 14, 12, 13, 5, 14, 13, 13, 7, 5,
        15, 5, 8, 11, 14, 14, 6, 14, 6, 9, 12, 9, 12, 5, 15, 8,
        8, 5, 12, 9, 12, 5, 14, 6, 8, 13, 6, 5, 15, 13, 11, 11,
    ]

    def f(j, x, y, z):
        if j < 16:
            return x ^ y ^ z
        if j < 32:
            return (x & y) | (~x & z)
        if j < 48:
            return (x | ~z) ^ y
        if j < 64:
            return (x & z) | (y & ~z)
        return x ^ (y | ~z)

    msg = bytearray(data)
    ml = len(data) * 8
    msg.append(0x80)
    while len(msg) % 64 != 56:
        msg.append(0)
    msg += struct.pack("<Q", ml)

    h = [0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0]
    for block_start in range(0, len(msg), 64):
        x = list(struct.unpack("<16L", bytes(msg[block_start : block_start + 64])))
        al, bl, cl, dl, el = h
        ar, br, cr, dr, er = h
        for j in range(80):
            t = (
                rol((al + f(j, bl, cl, dl) + x[R1[j]] + K1[j // 16]) & 0xFFFFFFFF, S1[j])
                + el
            ) & 0xFFFFFFFF
            al, el, dl, cl, bl = el, dl, rol(cl, 10), bl, t
            t = (
                rol(
                    (ar + f(79 - j, br, cr, dr) + x[R2[j]] + K2[j // 16]) & 0xFFFFFFFF,
                    S2[j],
                )
                + er
            ) & 0xFFFFFFFF
            ar, er, dr, cr, br = er, dr, rol(cr, 10), br, t
        t = (h[1] + cl + dr) & 0xFFFFFFFF
        h[1] = (h[2] + dl + er) & 0xFFFFFFFF
        h[2] = (h[3] + el + ar) & 0xFFFFFFFF
        h[3] = (h[4] + al + br) & 0xFFFFFFFF
        h[4] = (h[0] + bl + cr) & 0xFFFFFFFF
        h[0] = t
    return struct.pack("<5L", *h)


def ripemd160(data: List) -> List[int]:
    raw = _concrete_bytes(data)
    try:
        digest = hashlib.new("ripemd160", raw).digest()
    except ValueError:
        digest = _ripemd160_py(raw)
    return list(digest.rjust(32, b"\x00"))


def identity(data: List) -> List[int]:
    return [b if isinstance(b, int) else b for b in data]


def mod_exp(data: List) -> List[int]:
    raw = _concrete_bytes(data)
    base_len = _word(raw, 0)
    exp_len = _word(raw, 1)
    mod_len = _word(raw, 2)
    if base_len > 4096 or exp_len > 4096 or mod_len > 4096:
        raise NativeContractException("modexp operand too large")
    off = 96
    base = int.from_bytes(raw[off : off + base_len].ljust(base_len, b"\x00"), "big")
    off += base_len
    exp = int.from_bytes(raw[off : off + exp_len].ljust(exp_len, b"\x00"), "big")
    off += exp_len
    mod = int.from_bytes(raw[off : off + mod_len].ljust(mod_len, b"\x00"), "big")
    if mod == 0:
        return [0] * mod_len
    result = pow(base, exp, mod)
    return list(result.to_bytes(mod_len, "big"))


# ---------------------------------------------------------------------------
# alt_bn128 group ops
# ---------------------------------------------------------------------------

_BN_P = 21888242871839275222246405745257275088696311157297823662689037894645226208583


def _bn_on_curve(pt):
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - 3) % _BN_P == 0


def _bn_decode(x: int, y: int):
    if x == 0 and y == 0:
        return None
    if x >= _BN_P or y >= _BN_P:
        raise NativeContractException("bn128 coordinate out of field")
    pt = (x, y)
    if not _bn_on_curve(pt):
        raise NativeContractException("point not on bn128 curve")
    return pt


def _bn_encode(pt) -> List[int]:
    if pt is None:
        return [0] * 64
    x, y = pt
    return list(x.to_bytes(32, "big") + y.to_bytes(32, "big"))


def ec_add(data: List) -> List[int]:
    raw = _concrete_bytes(data).ljust(128, b"\x00")
    p1 = _bn_decode(_word(raw, 0), _word(raw, 1))
    p2 = _bn_decode(_word(raw, 2), _word(raw, 3))
    return _bn_encode(_ec_add_jac(p1, p2, _BN_P))


def ec_mul(data: List) -> List[int]:
    raw = _concrete_bytes(data).ljust(96, b"\x00")
    p1 = _bn_decode(_word(raw, 0), _word(raw, 1))
    scalar = _word(raw, 2)
    if p1 is None:
        return _bn_encode(None)
    return _bn_encode(_ec_mul_point(p1, scalar, _BN_P))


def ec_pair(data: List) -> List[int]:
    """bn128 pairing check — deferred: over-approximated as symbolic.

    The full Fp12-tower Miller loop is not yet carried in-repo; raising
    NativeContractException makes the caller treat the output as fresh
    symbols, which is sound for detection purposes.
    """
    raise NativeContractException("bn128 pairing not implemented")


# ---------------------------------------------------------------------------
# blake2b F compression (EIP-152)
# ---------------------------------------------------------------------------

_BLAKE2B_IV = [
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B, 0xA54FF53A5F1D36F1,
    0x510E527FADE682D1, 0x9B05688C2B3E6C1F, 0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
]

_BLAKE2B_SIGMA = [
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
    [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
    [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
    [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
    [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
    [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
    [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
    [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
    [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0],
]

_M64 = (1 << 64) - 1


def _ror64(x, n):
    return ((x >> n) | (x << (64 - n))) & _M64


def _blake2b_g(v, a, b, c, d, x, y):
    v[a] = (v[a] + v[b] + x) & _M64
    v[d] = _ror64(v[d] ^ v[a], 32)
    v[c] = (v[c] + v[d]) & _M64
    v[b] = _ror64(v[b] ^ v[c], 24)
    v[a] = (v[a] + v[b] + y) & _M64
    v[d] = _ror64(v[d] ^ v[a], 16)
    v[c] = (v[c] + v[d]) & _M64
    v[b] = _ror64(v[b] ^ v[c], 63)


def blake2b_fcompress(data: List) -> List[int]:
    raw = _concrete_bytes(data)
    if len(raw) != 213:
        raise NativeContractException("blake2b F input must be 213 bytes")
    rounds = int.from_bytes(raw[0:4], "big")
    if rounds > 0xFFFFFF:
        raise NativeContractException("blake2b round count too large")
    h = [int.from_bytes(raw[4 + 8 * i : 12 + 8 * i], "little") for i in range(8)]
    m = [int.from_bytes(raw[68 + 8 * i : 76 + 8 * i], "little") for i in range(16)]
    t0 = int.from_bytes(raw[196:204], "little")
    t1 = int.from_bytes(raw[204:212], "little")
    final = raw[212]
    if final not in (0, 1):
        raise NativeContractException("blake2b final flag must be 0/1")

    v = h[:] + _BLAKE2B_IV[:]
    v[12] ^= t0
    v[13] ^= t1
    if final:
        v[14] ^= _M64
    for r in range(rounds):
        s = _BLAKE2B_SIGMA[r % 10]
        _blake2b_g(v, 0, 4, 8, 12, m[s[0]], m[s[1]])
        _blake2b_g(v, 1, 5, 9, 13, m[s[2]], m[s[3]])
        _blake2b_g(v, 2, 6, 10, 14, m[s[4]], m[s[5]])
        _blake2b_g(v, 3, 7, 11, 15, m[s[6]], m[s[7]])
        _blake2b_g(v, 0, 5, 10, 15, m[s[8]], m[s[9]])
        _blake2b_g(v, 1, 6, 11, 12, m[s[10]], m[s[11]])
        _blake2b_g(v, 2, 7, 8, 13, m[s[12]], m[s[13]])
        _blake2b_g(v, 3, 4, 9, 14, m[s[14]], m[s[15]])
    out = bytearray()
    for i in range(8):
        out += ((h[i] ^ v[i] ^ v[i + 8]) & _M64).to_bytes(8, "little")
    return list(out)


PRECOMPILE_FUNCTIONS = [
    ecrecover,
    sha256,
    ripemd160,
    identity,
    mod_exp,
    ec_add,
    ec_mul,
    ec_pair,
    blake2b_fcompress,
]
PRECOMPILE_NAMES = [
    "ecrecover",
    "sha256",
    "ripemd160",
    "identity",
    "mod_exp",
    "ec_add",
    "ec_mul",
    "ec_pair",
    "blake2b_fcompress",
]


def native_contracts(address: int, data: List) -> List[int]:
    """Dispatch by precompile address 1..9 (reference natives.py:253-282)."""
    if not (1 <= address <= len(PRECOMPILE_FUNCTIONS)):
        raise NativeContractException(f"no precompile at address {address}")
    return PRECOMPILE_FUNCTIONS[address - 1](data)
