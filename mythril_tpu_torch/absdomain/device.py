"""Launch wrapper of the known-bits kernel (the prefilter's device pass).

Replaces ``mythril_tpu/absdomain/device.py`` (``_get_jitted`` -> ``_run``,
the jitted interpreter over the packed tape).  The kernel is
``csrc/known_bits.cu``, one thread per row walking the nodes; its plain
version is ``domains.eval_kb_plain``.  ``known_bits`` launches the kernel
for CUDA tensors and runs the plain version only for CPU tensors.  There is
no warm-up thread and no "host until compiled" phase: the kernel library is
built at first use, as every kernel of the port is, and a build or launch
failure raises.

``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from mythril_tpu_torch.absdomain import domains
from mythril_tpu_torch.absdomain.tape import LIMBS, PackedBatch
from mythril_tpu_torch.ops import _build

launches = 0


class KbArgs(ctypes.Structure):
    """Mirror of ``mk::kb::KbArgs`` in ``csrc/known_bits.cuh``."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "nodes", "wm", "cl", "okm", "okv", "zero", "km", "kv", "refuted",
    )] + [("N", ctypes.c_int32), ("R", ctypes.c_int32)]


def kb_args(nodes, wm, cl, okm, okv, zero, km, kv, refuted) -> KbArgs:
    ptr = lambda t: t.data_ptr() if t.numel() else None  # noqa: E731
    return KbArgs(ptr(nodes), ptr(wm), ptr(cl), ptr(okm), ptr(okv), ptr(zero), ptr(km),
                  ptr(kv), ptr(refuted), nodes.shape[0], refuted.shape[0])


def _check_inputs(nodes, wm, cl, okm, okv, n_rows: int) -> None:
    n = nodes.shape[0]
    shapes = {"nodes": (nodes, (n, domains.NODE_W)), "wm": (wm, (n, LIMBS)),
              "cl": (cl, (n, LIMBS)), "okm": (okm, (okm.shape[0], n_rows, LIMBS)),
              "okv": (okv, (okm.shape[0], n_rows, LIMBS))}
    for name, (t, shape) in shapes.items():
        if t.dtype != torch.int32 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous int32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != nodes.device:
            raise ValueError(f"{name} is on {t.device}, nodes on {nodes.device}")


def known_bits(nodes, wm, cl, okm, okv, n_rows: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One known-bits pass over ``domains.kb_inputs``' tensors -> (km, kv
    [N, R, 16] int32 bit patterns, refuted [R] bool): the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors."""
    global launches
    _check_inputs(nodes, wm, cl, okm, okv, n_rows)
    if not nodes.is_cuda:
        return domains.eval_kb_plain(nodes, wm, cl, okm, okv, n_rows)
    n = nodes.shape[0]
    km = torch.empty((n, n_rows, LIMBS), dtype=torch.int32, device=nodes.device)
    kv = torch.empty_like(km)
    refuted = torch.zeros(n_rows, dtype=torch.bool, device=nodes.device)
    if n == 0 or n_rows == 0:
        return km, kv, refuted
    zero = torch.zeros(LIMBS, dtype=torch.int32, device=nodes.device)
    args = kb_args(nodes, wm, cl, okm, okv, zero, km, kv, refuted)
    lib = _build.load()
    with torch.cuda.device(nodes.device):
        stream = torch.cuda.current_stream(nodes.device).cuda_stream
        _build.check(lib.mk_known_bits(ctypes.byref(args), stream), "known_bits")
    launches += 1
    return km, kv, refuted


def run_kb(pack: PackedBatch, device) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The known-bits pass of ``pack`` on ``device`` -> (km, kv uint32 [N, R,
    16], refuted bool [R]) as numpy, for the host's verdicts; bit for bit
    the JAX package's ``domains.eval_kb_host``."""
    km, kv, refuted = known_bits(*domains.kb_inputs(pack, device), pack.n_rows)
    return (km.cpu().numpy().view(np.uint32), kv.cpu().numpy().view(np.uint32),
            refuted.cpu().numpy())
