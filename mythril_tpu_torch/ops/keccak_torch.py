"""Batched keccak-256 on tensors: the port's counterpart of ``keccak_jax.py``.

The state is ``[..., 25, 4]``: 25 lanes of four little-endian 16-bit limbs,
the JAX package's layout (lane index ``x + 5*y``).  ``keccak_f1600`` is the
public permutation: on a CUDA tensor it launches the hand-written kernel
(``ops/keccak_cuda.py``, ``csrc/keccak_f1600.cu``), on a CPU tensor it runs
``keccak_f1600_reference``, the plain PyTorch version that the CPU tests and
``chip_smoke.py`` hold the kernel against.

``keccak256`` hashes the big-endian byte serialization of a limb bitvector
(keccak padding, absorb, permute, squeeze), as ``keccak_jax.keccak256`` does;
the tape VM's plain version hashes ``OP_KECCAK32/64`` preimages through it.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from mythril_tpu_torch.ops.bitvec import LIMB_BITS, LIMB_MASK
from mythril_tpu_torch.ops.keccak import _RC, _ROT

RATE_BYTES = 136  # 1088-bit rate for keccak-256

# Round constants as [24, 4] little-endian 16-bit limbs.
_RC_LIMBS = np.array(
    [[(rc >> (16 * i)) & LIMB_MASK for i in range(4)] for rc in _RC], np.int64
)

# Static lane shuffles of one round over lane index i = x + 5*y.
# rho+pi: output lane y + 5*((2x+3y)%5) takes input lane x+5y rotated by
# _ROT[x][y]; chi: out[i] = b[i] ^ (~b[i+1 (mod x)] & b[i+2 (mod x)]).
_PI_SRC = np.zeros(25, np.int64)
_PI_ROT = np.zeros(25, np.int64)
for _x in range(5):
    for _y in range(5):
        _PI_SRC[_y + 5 * ((2 * _x + 3 * _y) % 5)] = _x + 5 * _y
        _PI_ROT[_y + 5 * ((2 * _x + 3 * _y) % 5)] = _ROT[_x][_y] % 64
_CHI1 = np.array([(i % 5 + 1) % 5 + 5 * (i // 5) for i in range(25)], np.int64)
_CHI2 = np.array([(i % 5 + 2) % 5 + 5 * (i // 5) for i in range(25)], np.int64)
_MOD5 = np.arange(25, dtype=np.int64) % 5
_XM1 = np.array([(x + 4) % 5 for x in range(5)], np.int64)
_XP1 = np.array([(x + 1) % 5 for x in range(5)], np.int64)
# Per-lane limb gather for the rho rotations: new[j] = old[(j - q) % 4].
_ROT_Q, _ROT_S = _PI_ROT // LIMB_BITS, _PI_ROT % LIMB_BITS
_ROT_JIDX = (np.arange(4)[None, :] - _ROT_Q[:, None]) % 4  # [25, 4]

_TABLES = {}


def _tables(device) -> dict:
    key = str(device)
    t = _TABLES.get(key)
    if t is None:
        t = {
            name: torch.from_numpy(np.ascontiguousarray(arr)).to(device)
            for name, arr in (
                ("rc", _RC_LIMBS), ("pi_src", _PI_SRC), ("chi1", _CHI1),
                ("chi2", _CHI2), ("mod5", _MOD5), ("xm1", _XM1), ("xp1", _XP1),
                ("jidx", _ROT_JIDX), ("jprev", (_ROT_JIDX - 1) % 4),
                ("rot_s", _ROT_S[:, None]),
            )
        }
        _TABLES[key] = t
    return t


def _rotl1(lane: torch.Tensor) -> torch.Tensor:
    """Rotate [..., 4]-limb 64-bit lanes left by one bit."""
    prev = torch.roll(lane, 1, dims=-1)
    return ((lane << 1) | (prev >> (LIMB_BITS - 1))) & LIMB_MASK


def _round(state: torch.Tensor, rc: torch.Tensor, t: dict) -> torch.Tensor:
    """One keccak-f round on the [..., 25, 4] int64 state."""
    s5 = state.reshape(*state.shape[:-2], 5, 5, 4)  # [..., y, x, limb]
    c = s5[..., 0, :, :] ^ s5[..., 1, :, :] ^ s5[..., 2, :, :] ^ s5[..., 3, :, :] ^ s5[..., 4, :, :]
    d = c.index_select(-2, t["xm1"]) ^ _rotl1(c.index_select(-2, t["xp1"]))
    a = state ^ d.index_select(-2, t["mod5"])
    src = a.index_select(-2, t["pi_src"])
    jidx = t["jidx"].expand(src.shape)
    rolled = torch.take_along_dim(src, jidx, dim=-1)
    prev = torch.take_along_dim(src, t["jprev"].expand(src.shape), dim=-1)
    s = t["rot_s"]
    b = ((rolled << s) | (prev >> (LIMB_BITS - s))) & LIMB_MASK
    chi = b ^ ((b.index_select(-2, t["chi1"]) ^ LIMB_MASK) & b.index_select(-2, t["chi2"]))
    chi[..., 0, :] ^= rc
    return chi


def keccak_f1600_reference(state: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch keccak-f[1600]: [..., 25, 4] limbs -> same shape/dtype."""
    t = _tables(state.device)
    st = state.to(torch.int64)
    for r in range(24):
        st = _round(st, t["rc"][r], t)
    return st.to(state.dtype)


def keccak_f1600(state: torch.Tensor) -> torch.Tensor:
    """The permutation: the CUDA kernel for a CUDA tensor, else the plain one."""
    if state.is_cuda:
        from mythril_tpu_torch.ops import keccak_cuda

        flat = state.reshape(-1, 25, 4).to(torch.int32).contiguous()
        return keccak_cuda.keccak_f1600(flat).reshape(state.shape).to(state.dtype)
    return keccak_f1600_reference(state)


def _gather_bytes(data: torch.Tensor, width: int) -> list:
    """Big-endian byte list of a [..., L]-limb bitvector (MSB first)."""
    n = width // 8
    out = []
    for j in range(n):
        k = n - 1 - j  # numeric little-endian byte index
        out.append((data[..., k // 2] >> (8 * (k % 2))) & 0xFF)
    return out


def keccak256(
    data: torch.Tensor,
    width: int,
    permute: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> torch.Tensor:
    """keccak-256 of the big-endian byte serialization of a bitvector.

    ``data``: [..., nlimbs(width)] integer limbs; ``width`` a multiple of 8.
    Returns [..., 16] int64 limbs (a 256-bit word).  ``permute`` defaults to
    the public ``keccak_f1600``; pass ``keccak_f1600_reference`` for a
    computation that launches no kernel."""
    assert width % 8 == 0, "keccak input must be byte-aligned"
    permute = permute or keccak_f1600
    data = data.to(torch.int64)
    msg = _gather_bytes(data, width)
    n = len(msg)
    zero = torch.zeros(data.shape[:-1], dtype=torch.int64, device=data.device)
    nblocks = n // RATE_BYTES + 1
    padded = msg + [zero] * (nblocks * RATE_BYTES - n)
    padded[n] = padded[n] | 0x01
    padded[-1] = padded[-1] | 0x80

    state = torch.zeros((*zero.shape, 25, 4), dtype=torch.int64, device=data.device)
    for blk in range(nblocks):
        block = padded[blk * RATE_BYTES:(blk + 1) * RATE_BYTES]
        limbs = [block[2 * u] | (block[2 * u + 1] << 8) for u in range(RATE_BYTES // 2)]
        absorb = torch.stack(limbs, dim=-1).reshape(*zero.shape, 17, 4)
        state = state.clone()
        state[..., :17, :] ^= absorb
        state = permute(state)

    # squeeze 32 bytes = lanes 0..3; the output word is big-endian bytes
    out_bytes = []
    for lane in range(4):
        for u in range(8):
            out_bytes.append((state[..., lane, u // 2] >> (8 * (u % 2))) & 0xFF)
    limbs = [out_bytes[31 - 2 * i] | (out_bytes[30 - 2 * i] << 8) for i in range(16)]
    return torch.stack(limbs, dim=-1)
