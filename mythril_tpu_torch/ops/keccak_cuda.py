"""Launch wrapper of the keccak-f[1600] CUDA kernel.

Replaces ``mythril_tpu/ops/keccak_pallas.py`` (``keccak_f1600`` around the
``pl.pallas_call`` of ``_permute_tile``).  The kernel is
``csrc/keccak_f1600.cu`` in two layouts: ``"thread"``, one thread per state
with 25 uint64_t lanes in registers, and ``"warp"``, one warp per state with
a lane per thread, whose shorter dependent chain wins when there are too
few states to fill the card.  ``keccak_f1600`` takes the warp layout up to
``WARP_MAX_N`` states: on an H100 (700 W) it was faster through N=2048 and
slower from N=4096 (``chip_smoke.py``'s layout sweep, ``PERF.md``).  Its
plain version is ``keccak_torch.keccak_f1600_reference``.

``launches`` counts the kernel's launches, both layouts, so a run can show
that its main path went through the kernel; ``variant_launches`` splits
them by layout.
"""

from __future__ import annotations

from typing import Optional

import torch

from mythril_tpu_torch.ops import _build

VARIANTS = {"thread": "mk_keccak_f1600", "warp": "mk_keccak_f1600_warp"}
WARP_MAX_N = 2048

launches = 0
variant_launches = {name: 0 for name in VARIANTS}


def pick_variant(n: int) -> str:
    return "warp" if n <= WARP_MAX_N else "thread"


def keccak_f1600(state: torch.Tensor, variant: Optional[str] = None) -> torch.Tensor:
    """[N, 25, 4] int32 16-bit limbs on a CUDA device -> permuted copy.
    ``variant``: ``"thread"`` or ``"warp"``, else chosen by N."""
    global launches
    if not state.is_cuda:
        raise ValueError("keccak_cuda.keccak_f1600 takes a CUDA tensor")
    if state.dtype != torch.int32 or state.dim() != 3 or tuple(state.shape[1:]) != (25, 4):
        raise ValueError(f"expected [N, 25, 4] int32, got {tuple(state.shape)} {state.dtype}")
    if not state.is_contiguous() or state.data_ptr() % 16:
        raise ValueError("state must be contiguous and 16-byte aligned (int4 loads)")
    n = state.shape[0]
    variant = variant or pick_variant(n)
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {sorted(VARIANTS)}, got {variant!r}")
    out = torch.empty_like(state)
    if n == 0:
        return out
    entry = getattr(_build.load(), VARIANTS[variant])
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream(state.device).cuda_stream
        _build.check(entry(state.data_ptr(), out.data_ptr(), n, stream), "keccak_f1600")
    launches += 1
    variant_launches[variant] += 1
    return out
