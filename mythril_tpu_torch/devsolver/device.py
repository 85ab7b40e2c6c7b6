"""Launch wrapper of the batched DPLL kernel (the devsolver's search).

Replaces ``mythril_tpu/devsolver/device.py`` (``_get_jitted`` -> ``_run``,
the jitted ``while_loop`` over ``kernel.step``).  The kernel is
``csrc/dpll.cu``, one block per query; its plain version is
``kernel.run_plain``.  ``dpll`` launches the kernel for CUDA tensors and
runs the plain version only for CPU tensors.  There is no warm-up thread
and no "host until compiled" phase: the kernel library is built at first
use, and a build or launch failure raises.

``run_device`` moves a plane in one upload (``lits`` and ``dec`` side by
side) and its results in one download (status, assignment and steps in
one int8 buffer).

``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from mythril_tpu_torch.devsolver import kernel
from mythril_tpu_torch.devsolver.kernel import MAX_DECISIONS, Plane
from mythril_tpu_torch.ops import _build

launches = 0

# the largest variable bucket: the kernel keeps a literal in 16 bits and a
# snapshot of the assignment per decision slot (csrc/dpll.cuh kMaxVars)
MAX_VARS = 4096


class DpllArgs(ctypes.Structure):
    """Mirror of ``mk::dpll::DpllArgs`` in ``csrc/dpll.cuh``."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "lits", "dec", "status", "assign", "steps",
    )] + [(name, ctypes.c_int32) for name in ("Q", "C", "V", "max_iters", "threads")]


def block_threads(c: int) -> int:
    """The kernel's block size for ``c`` clause slots a query: 256 threads
    for the small bucket, 1024 (4 clauses a thread) for the large one."""
    return 256 if c <= 512 else 1024


def dpll_args(lits, dec, status, assign, steps, n_vars: int, max_iters: int,
              threads: Optional[int] = None) -> DpllArgs:
    q, c = lits.shape[0], lits.shape[1]
    return DpllArgs(lits.data_ptr(), dec.data_ptr(), status.data_ptr(), assign.data_ptr(),
                    steps.data_ptr(), q, c, n_vars, max_iters,
                    block_threads(c) if threads is None else threads)


def _check_shape(q: int, c: int, k: int, dec_shape, n_vars: int, on_card: bool) -> None:
    if k != 3:
        raise ValueError(f"lits: expected [Q, C, 3], got [{q}, {c}, {k}]")
    if tuple(dec_shape) != (q, MAX_DECISIONS):
        raise ValueError(f"dec: expected [{q}, {MAX_DECISIONS}], got {tuple(dec_shape)}")
    if n_vars < 2:
        raise ValueError(f"n_vars {n_vars}: the plane has two anchor variables")
    if n_vars > MAX_VARS and on_card:
        raise ValueError(f"n_vars {n_vars}: the kernel takes at most {MAX_VARS} variables")


def _launch(args: DpllArgs, device) -> None:
    global launches
    lib = _build.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _build.check(lib.mk_dpll(ctypes.byref(args), stream), "dpll")
    launches += 1


def dpll(lits: torch.Tensor, dec: torch.Tensor, n_vars: int, max_iters: int
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The search on a plane's tensors -> (status int8 [Q], assign int8
    [Q, n_vars], steps int32 [Q]): the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if lits.dtype != torch.int32 or lits.dim() != 3 or not lits.is_contiguous():
        raise ValueError(f"lits: expected contiguous int32 [Q, C, 3], got {lits.dtype} "
                         f"{tuple(lits.shape)}")
    if dec.dtype != torch.int32 or not dec.is_contiguous() or dec.device != lits.device:
        raise ValueError(f"dec: expected contiguous int32 beside lits, got {dec.dtype} on "
                         f"{dec.device}")
    q, c, k = lits.shape
    _check_shape(q, c, k, dec.shape, n_vars, lits.is_cuda)
    if not lits.is_cuda:
        return kernel.run_plain(lits, dec, n_vars, max_iters)
    status = torch.empty(q, dtype=torch.int8, device=lits.device)
    assign = torch.empty((q, n_vars), dtype=torch.int8, device=lits.device)
    steps = torch.empty(q, dtype=torch.int32, device=lits.device)
    if q:
        _launch(dpll_args(lits, dec, status, assign, steps, n_vars, max_iters), lits.device)
    return status, assign, steps


def run_device(plane: Plane, max_iters: int, device) -> Tuple[np.ndarray, np.ndarray]:
    """The search on ``plane`` on ``device`` -> (status [Q], assign [Q, V])
    as numpy int8, for the host's model rebuild; bit for bit the JAX
    package's ``kernel.run_host``.  On the card: one upload (``lits`` and
    ``dec`` side by side) and one download (the assignment, the steps and
    the status in one int8 buffer)."""
    dev = torch.device(device)
    lits_np = np.ascontiguousarray(plane.lits, np.int32)
    dec_np = np.ascontiguousarray(plane.dec, np.int32)
    if dev.type != "cuda":
        status, assign, _steps = dpll(torch.from_numpy(lits_np).to(dev),
                                      torch.from_numpy(dec_np).to(dev), plane.n_vars, max_iters)
        return status.cpu().numpy(), assign.cpu().numpy()
    q, c, k = lits_np.shape
    v = plane.n_vars
    _check_shape(q, c, k, dec_np.shape, v, True)
    staged = torch.from_numpy(np.concatenate((lits_np.reshape(-1), dec_np.reshape(-1)))).to(dev)
    at = -(-q * v // 4) * 4  # the steps, 4-byte aligned, after the assignment
    out = torch.empty(at + 5 * q, dtype=torch.int8, device=dev)
    if q:
        up, down = staged.data_ptr(), out.data_ptr()
        _launch(DpllArgs(up, up + 4 * lits_np.size, down + at + 4 * q, down, down + at,
                         q, c, v, max_iters, block_threads(c)), staged.device)
    host = out.cpu().numpy()
    return host[at + 4 * q:], host[:q * v].reshape(q, v)
