"""Launch wrapper of the known-bits kernel (the prefilter's device pass).

Replaces ``mythril_tpu/absdomain/device.py`` (``_get_jitted`` -> ``_run``,
the jitted interpreter over the packed tape).  The kernel is
``csrc/known_bits.cu``: a block per row walks the nodes level by level, a
node's limbs across half a warp; its plain version is
``domains.eval_kb_plain``.  ``level_plan`` is the port's own host structure
beside ``domains.kb_inputs``' tensors (which stay those of the JAX
package): the node indices ordered by dependency level and each level's
first position, built once per pack.  ``known_bits`` launches the kernel
for CUDA tensors and runs the plain version only for CPU tensors.  There
is no warm-up thread and no "host until compiled" phase: the kernel
library is built at first use, as every kernel of the port is, and a build
or launch failure raises.

``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from mythril_tpu_torch.absdomain import domains
from mythril_tpu_torch.absdomain.tape import LIMBS, PackedBatch
from mythril_tpu_torch.ops import _build
from mythril_tpu_torch.ops.lowering import SMEM_BUDGET

launches = 0

# int32 fields of a record staged in the kernel's shared memory
# (csrc/known_bits.cuh Field)
KREC = 10


class KbArgs(ctypes.Structure):
    """Mirror of ``mk::kb::KbArgs`` in ``csrc/known_bits.cuh``."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "nodes", "wm", "cl", "okm", "okv", "zero", "plan", "km", "kv", "refuted",
    )] + [(name, ctypes.c_int32) for name in ("N", "R", "n_levels", "in_smem", "smem_words")]


@dataclass(frozen=True)
class LevelPlan:
    """The nodes by dependency level: ``order`` [N] node indices, each
    node's children (those before it) at lower levels; ``levels``
    [n_levels + 1] each level's first position in ``order``."""

    order: np.ndarray
    levels: np.ndarray

    @property
    def n_levels(self) -> int:
        return len(self.levels) - 1

    def packed(self) -> np.ndarray:
        """``order`` then ``levels``, one int32 array: the kernel's plan."""
        return np.concatenate([self.order, self.levels]).astype(np.int32)


def level_plan(children) -> LevelPlan:
    """The level plan of a tape whose node ``i`` reads the nodes
    ``children[i]`` ([N, 3]: a0, a1, a2).  A negative child is missing, and a
    child at or after its node reads zeros as a missing one does (the plain
    version reads it before it is written), so neither orders anything; a
    child past the last node is refused."""
    ch = np.asarray(children, dtype=np.int64).reshape(-1, 3)
    n = ch.shape[0]
    if n and int(ch.max()) >= n:
        raise ValueError(f"known_bits: a child index {int(ch.max())} of {n} nodes")
    ch = np.where((ch >= 0) & (ch < np.arange(n)[:, None]), ch, -1)
    lv = [0] * n + [-1]  # lv[-1]: the missing child's level
    for i, x, y, z in zip(range(n), ch[:, 0].tolist(), ch[:, 1].tolist(), ch[:, 2].tolist()):
        a, b, c = lv[x], lv[y], lv[z]
        if b > a:
            a = b
        if c > a:
            a = c
        lv[i] = a + 1
    lv_np = np.asarray(lv[:n], dtype=np.int32)
    order = np.argsort(lv_np, kind="stable").astype(np.int32)
    counts = np.bincount(lv_np) if n else np.zeros(0, np.int64)
    levels = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return LevelPlan(order, levels)


def pack_plan(pack: PackedBatch) -> LevelPlan:
    """``level_plan`` of a packed batch, from its host fields."""
    return level_plan(np.stack([pack.a0, pack.a1, pack.a2], 1))


def smem_words(n: int, n_levels: int, in_smem: bool) -> int:
    """Shared-memory words of one block, the layout of ``csrc/known_bits.cuh``
    ``stage``: the staged records and level offsets, and on the
    shared-memory route a zero row, the row's km and kv and the width
    masks."""
    words = n * KREC + n_levels + 1
    return words + LIMBS + 3 * n * LIMBS if in_smem else words


def in_smem(n: int, n_levels: int) -> bool:
    """Whether a row's values fit the block's shared memory (else they stay
    in the output planes)."""
    return 4 * smem_words(n, n_levels, True) <= SMEM_BUDGET


def kb_args(nodes, wm, cl, okm, okv, zero, plan, n_levels, km, kv, refuted,
            smem: Optional[bool] = None) -> KbArgs:
    """The kernel's arguments; ``smem`` forces a route (default: shared
    memory where the row fits)."""
    ptr = lambda t: t.data_ptr() if t is not None and t.numel() else None  # noqa: E731
    n = nodes.shape[0]
    route = in_smem(n, n_levels) if smem is None else smem
    return KbArgs(ptr(nodes), ptr(wm), ptr(cl), ptr(okm), ptr(okv), ptr(zero), ptr(plan),
                  ptr(km), ptr(kv), ptr(refuted), n, refuted.shape[0], n_levels, int(route),
                  smem_words(n, n_levels, route))


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


def known_bits(nodes, wm, cl, okm, okv, n_rows: int, plan: Optional[LevelPlan]
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One known-bits pass over ``domains.kb_inputs``' tensors -> (km, kv
    [N, R, 16] int32 bit patterns, refuted [R] bool): the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors.  ``plan``: the nodes'
    ``level_plan`` (``pack_plan`` of the pack; CPU tensors need none)."""
    global launches
    _check_inputs(nodes, wm, cl, okm, okv, n_rows)
    if not nodes.is_cuda:
        return domains.eval_kb_plain(nodes, wm, cl, okm, okv, n_rows)
    n = nodes.shape[0]
    km = torch.empty((n, n_rows, LIMBS), dtype=torch.int32, device=nodes.device)
    kv = torch.empty_like(km)
    refuted = torch.empty(n_rows, dtype=torch.bool, device=nodes.device)
    if n == 0 or n_rows == 0:
        return km, kv, refuted.zero_()
    if plan is None or len(plan.order) != n:
        raise ValueError(f"known_bits: no level plan of {n} nodes")
    if 4 * smem_words(n, plan.n_levels, False) > SMEM_BUDGET:
        raise ValueError(f"known_bits: {n} nodes in {plan.n_levels} levels exceed a block's "
                         f"shared memory")
    route = in_smem(n, plan.n_levels)
    plan_t = torch.from_numpy(plan.packed()).to(nodes.device)
    zero = None if route else torch.zeros(LIMBS, dtype=torch.int32, device=nodes.device)
    args = kb_args(nodes, wm, cl, okm, okv, zero, plan_t, plan.n_levels, km, kv, refuted, route)
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
    inputs = domains.kb_inputs(pack, device)
    plan = pack_plan(pack) if inputs[0].is_cuda else None
    km, kv, refuted = known_bits(*inputs, pack.n_rows, plan)
    return (km.cpu().numpy().view(np.uint32), kv.cpu().numpy().view(np.uint32),
            refuted.cpu().numpy())
