"""Launch wrapper of the keccak-f[1600] CUDA kernel.

Replaces ``mythril_tpu/ops/keccak_pallas.py`` (``keccak_f1600`` around the
``pl.pallas_call`` of ``_permute_tile``).  The kernel is
``csrc/keccak_f1600.cu``: one thread per state, 25 uint64_t lanes in
registers.  Its plain version is ``keccak_torch.keccak_f1600_reference``.

``launches`` counts the kernel's launches, so a run can show that its main
path went through the kernel.
"""

from __future__ import annotations

import torch

from mythril_tpu_torch.ops import _build

launches = 0


def keccak_f1600(state: torch.Tensor) -> torch.Tensor:
    """[N, 25, 4] int32 16-bit limbs on a CUDA device -> permuted copy."""
    global launches
    if not state.is_cuda:
        raise ValueError("keccak_cuda.keccak_f1600 takes a CUDA tensor")
    if state.dtype != torch.int32 or state.dim() != 3 or tuple(state.shape[1:]) != (25, 4):
        raise ValueError(f"expected [N, 25, 4] int32, got {tuple(state.shape)} {state.dtype}")
    if not state.is_contiguous() or state.data_ptr() % 16:
        raise ValueError("state must be contiguous and 16-byte aligned (int4 loads)")
    out = torch.empty_like(state)
    n = state.shape[0]
    if n == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream(state.device).cuda_stream
        _build.check(
            lib.mk_keccak_f1600(state.data_ptr(), out.data_ptr(), n, stream),
            "keccak_f1600",
        )
    launches += 1
    return out
