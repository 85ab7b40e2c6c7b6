"""Launch wrapper of the batched DPLL kernel (the devsolver's search).

Replaces ``mythril_tpu/devsolver/device.py`` (``_get_jitted`` -> ``_run``,
the jitted ``while_loop`` over ``kernel.step``).  The kernel is
``csrc/dpll.cu``, one block per query; its plain version is
``kernel.run_plain``.  ``dpll`` launches the kernel for CUDA tensors and
runs the plain version only for CPU tensors.  There is no warm-up thread
and no "host until compiled" phase: the kernel library is built at first
use, and a build or launch failure raises.

``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from mythril_tpu_torch.devsolver import kernel
from mythril_tpu_torch.devsolver.kernel import MAX_DECISIONS, Plane
from mythril_tpu_torch.ops import _build

launches = 0


class DpllArgs(ctypes.Structure):
    """Mirror of ``mk::dpll::DpllArgs`` in ``csrc/dpll.cuh``."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "lits", "dec", "status", "assign", "steps",
    )] + [(name, ctypes.c_int32) for name in ("Q", "C", "V", "max_iters")]


def dpll_args(lits, dec, status, assign, steps, n_vars: int, max_iters: int) -> DpllArgs:
    return DpllArgs(lits.data_ptr(), dec.data_ptr(), status.data_ptr(), assign.data_ptr(),
                    steps.data_ptr(), lits.shape[0], lits.shape[1], n_vars, max_iters)


def dpll(lits: torch.Tensor, dec: torch.Tensor, n_vars: int, max_iters: int
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The search on a plane's tensors -> (status int8 [Q], assign int8
    [Q, n_vars], steps int32 [Q]): the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    global launches
    q, c = lits.shape[0], lits.shape[1]
    if lits.dtype != torch.int32 or lits.dim() != 3 or lits.shape[2] != 3 \
            or not lits.is_contiguous():
        raise ValueError(f"lits: expected contiguous int32 [Q, C, 3], got {lits.dtype} "
                         f"{tuple(lits.shape)}")
    if dec.dtype != torch.int32 or tuple(dec.shape) != (q, MAX_DECISIONS) \
            or not dec.is_contiguous() or dec.device != lits.device:
        raise ValueError(f"dec: expected contiguous int32 [{q}, {MAX_DECISIONS}] beside lits, "
                         f"got {dec.dtype} {tuple(dec.shape)} on {dec.device}")
    if n_vars < 2:
        raise ValueError(f"n_vars {n_vars}: the plane has two anchor variables")
    if not lits.is_cuda:
        return kernel.run_plain(lits, dec, n_vars, max_iters)
    status = torch.empty(q, dtype=torch.int8, device=lits.device)
    assign = torch.empty((q, n_vars), dtype=torch.int8, device=lits.device)
    steps = torch.empty(q, dtype=torch.int32, device=lits.device)
    if q == 0:
        return status, assign, steps
    args = dpll_args(lits, dec, status, assign, steps, n_vars, max_iters)
    lib = _build.load()
    with torch.cuda.device(lits.device):
        stream = torch.cuda.current_stream(lits.device).cuda_stream
        _build.check(lib.mk_dpll(ctypes.byref(args), stream), "dpll")
    launches += 1
    return status, assign, steps


def run_device(plane: Plane, max_iters: int, device) -> Tuple[np.ndarray, np.ndarray]:
    """The search on ``plane`` on ``device`` -> (status [Q], assign [Q, V])
    as numpy int8, for the host's model rebuild; bit for bit the JAX
    package's ``kernel.run_host``."""
    lits = torch.from_numpy(np.ascontiguousarray(plane.lits, np.int32)).to(device)
    dec = torch.from_numpy(np.ascontiguousarray(plane.dec, np.int32)).to(device)
    status, assign, _steps = dpll(lits, dec, plane.n_vars, max_iters)
    return status.cpu().numpy(), assign.cpu().numpy()
