"""Parity: the port's keccak (mythril_tpu_torch/ops/keccak_torch.py) against
the JAX package's Pallas kernel in interpret mode, its portable JAX path,
and the host keccak-256, bit for bit.

States and messages come from seeded numpy generators and reach both sides
as the same numpy arrays; every comparison is exact (tolerance 0).  The
CUDA kernel itself runs only on a card (tests/test_torch_cuda.py and
chip_smoke.py); here its arithmetic is held against the plain version by
tests/test_torch_csrc_host.py.
"""

import numpy as np
import pytest
import torch

from mythril_tpu.ops import keccak_jax, keccak_pallas
from mythril_tpu.ops.bitvec import from_ints
from mythril_tpu.ops.keccak import keccak256_py as jax_host_keccak256
from mythril_tpu_torch.ops import keccak_torch
from mythril_tpu_torch.ops.keccak import keccak256_int, keccak256_py


def _states(batch: int) -> np.ndarray:
    rng = np.random.default_rng(batch)
    return rng.integers(0, 1 << 16, size=(batch, 25, 4), dtype=np.uint32)


@pytest.mark.parametrize("batch", [1, 3, 130])
def test_reference_matches_pallas_interpret(batch):
    state = _states(batch)
    want = np.asarray(keccak_pallas.keccak_f1600(state, interpret=True))
    got = keccak_torch.keccak_f1600_reference(torch.from_numpy(state.astype(np.int32)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))


@pytest.mark.parametrize("batch", [1, 3, 130])
def test_reference_matches_keccak_jax(batch):
    state = _states(batch)
    want = np.asarray(keccak_jax.keccak_f1600(state))
    got = keccak_torch.keccak_f1600_reference(torch.from_numpy(state.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_public_permutation_on_cpu_is_the_reference():
    state = torch.from_numpy(_states(5).astype(np.int32))
    np.testing.assert_array_equal(
        keccak_torch.keccak_f1600(state).numpy(),
        keccak_torch.keccak_f1600_reference(state).numpy(),
    )


def _words_np(width: int, n: int) -> list:
    rng = np.random.default_rng(width)
    edge = [0, 1, (1 << width) - 1, 1 << (width - 1)]
    return edge + [int.from_bytes(rng.bytes(width // 8), "big") for _ in range(n)]


@pytest.mark.parametrize("width", [256, 512])
def test_keccak256_matches_host_and_jax(width):
    values = _words_np(width, 8)
    limbs = from_ints(values, width)
    got = keccak_torch.keccak256(torch.from_numpy(limbs.astype(np.int64)), width)
    want_jax = np.asarray(keccak_jax.keccak256(limbs, width))
    np.testing.assert_array_equal(got.numpy(), want_jax.astype(np.int64))
    for row, v in zip(got.numpy(), values):
        digest = sum(int(limb) << (16 * i) for i, limb in enumerate(row))
        assert digest == keccak256_int(v, width // 8)
        assert digest == int.from_bytes(jax_host_keccak256(v.to_bytes(width // 8, "big")), "big")


@pytest.mark.parametrize("message", [b"", bytes(32), bytes(range(64)), b"\xab" * 135, b"\xcd" * 136])
def test_host_keccak_matches_jax_host(message):
    assert keccak256_py(message) == jax_host_keccak256(message)


def test_known_vectors():
    assert keccak256_py(b"").hex() == (
        "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"
    )
    assert keccak256_py(bytes(32)).hex() == (
        "290decd9548b62a8d60345a988386fc84ba6bc95484008f6362f93160ef3e563"
    )
