"""Mesh-sharded probe evaluation: the frontier step and flat batched eval.

The port's counterpart of ``mythril_tpu/parallel/probe.py``.
``frontier_step(compiled)`` is one round of the probe solver over a stacked
frontier of P independent paths x B candidate assignments each: every
conjunct evaluated for every candidate, then per-path best scores and a
global sat count.  The JAX package jits it and lets XLA place the
all-reduces; here the truth columns come from the lowering kernel
(``csrc/lowering.cu``), one launch per mesh block on that block's device
(``shard_probe_args``), and the small reductions (``sum``, ``where``,
``max``, the first ``argmax``) run in plain torch on the mesh's first
device after the blocks' truth is copied there.

The reference's counterpart is strictly sequential: one Z3 ``check()`` per
path per prune (mythril/laser/ethereum/svm.py:287-292,
mythril/laser/smt/solver/solver.py:51-66).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from mythril_tpu_torch.ops.lowering import CompiledConjunction, pack_assignments, run_lowering
from mythril_tpu_torch.parallel.mesh import (
    FrontierMesh,
    ShardedLeaf,
    make_frontier_mesh,
    shard_probe_args,
)


def _truth(compiled: CompiledConjunction, scalars, bools, array_tabs) -> torch.Tensor:
    """truth [*batch, C] bool: one ``run_lowering`` over the flattened batch
    of plain tensors (the kernel on a CUDA device, the plain version on the
    CPU), or one per block of ``ShardedLeaf`` inputs, each on its block's
    device, gathered onto the first block's device."""

    def flat(x: torch.Tensor, nb: int) -> torch.Tensor:
        return x.reshape((-1,) + tuple(x.shape[nb:])).contiguous()

    if not isinstance(bools, ShardedLeaf):
        nb = bools.dim() - 1
        out = run_lowering(compiled, [flat(s, nb) for s in scalars], flat(bools, nb),
                           [tuple(flat(x, nb) for x in tab) for tab in array_tabs])
        return out.reshape(tuple(bools.shape[:nb]) + (out.shape[-1],))
    nb = len(bools.shape)
    leader = bools.devices[0]
    full = torch.empty(bools.shape + (len(compiled.conjuncts),), dtype=torch.bool,
                       device=leader)
    for k, ix in enumerate(bools.index):
        block = bools.blocks[k]
        out = run_lowering(
            compiled, [flat(s.blocks[k], nb) for s in scalars], flat(block, nb),
            [tuple(flat(x.blocks[k], nb) for x in tab) for tab in array_tabs])
        full[ix] = out.reshape(tuple(block.shape[:nb]) + (out.shape[-1],)).to(leader)
    return full


def frontier_step(compiled: CompiledConjunction):
    """The one-round frontier program for a conjunction.

    Returns ``step(scalars, bools, array_tabs, valid)`` expecting leading
    [P, B] batch dims on every args leaf (tensors, or ``ShardedLeaf``s from
    ``shard_probe_args(..., batch_dims=2)``) and the [P, B] ``valid`` mask
    from ``pack_frontier``, producing int32 tensors on the (first) inputs'
    device:
      * ``scores``      [P, B] — satisfied-conjunct count per candidate,
                                 ``-1`` in masked (padding) slots,
      * ``best_score``  [P]    — per-path max,
      * ``best_idx``    [P]    — the first maximal candidate per path, as
                                 ``jnp.argmax`` picks it,
      * ``n_sat``       []     — global count of full models, padding
                                 excluded.
    """
    n_conj = len(compiled.conjuncts)

    def step(scalars, bools, array_tabs, valid):
        truth = _truth(compiled, scalars, bools, array_tabs)  # [P, B, C] bool
        scores = truth.sum(dim=-1, dtype=torch.int32)  # [P, B]
        # Padding rows (ragged frontier made rectangular) must never win
        # the argmax nor count as models.
        valid = torch.as_tensor(np.asarray(valid, dtype=bool)).to(scores.device)
        scores = torch.where(valid, scores, torch.full_like(scores, -1))
        best_score = scores.max(dim=-1).values  # [P]
        cols = torch.arange(scores.shape[-1], dtype=torch.int32, device=scores.device)
        best_idx = torch.where(scores == best_score[:, None], cols,
                               torch.iinfo(torch.int32).max).min(dim=-1).values  # [P]
        n_sat = (scores == n_conj).sum(dtype=torch.int32)  # []
        return scores, best_score, best_idx, n_sat

    return step


def pack_frontier(
    compiled: CompiledConjunction, assignments_per_path: Sequence[Sequence]
):
    """Pack P lists of assignments into stacked [P, B, ...] probe inputs
    (int32 tensors on the CPU).

    All paths share the conjunction DAG (one program); array tables take the
    union of keys across the whole frontier so every leaf is rectangular.
    Paths may carry different candidate counts: short paths are padded to
    the longest by repeating their last candidate, and the returned
    ``valid`` [P, B] mask marks the real rows.  Feed ``valid`` to the
    ``frontier_step`` program so padding can't double-count in ``n_sat`` or
    win ``best_idx``.

    Returns ``(args_tree, valid)``.
    """
    P_ = len(assignments_per_path)
    counts = [len(a) for a in assignments_per_path]
    if not counts or not all(counts):
        raise ValueError("every path needs at least one candidate")
    B = max(counts)
    flat: List = []
    for path in assignments_per_path:
        flat.extend(path)
        flat.extend([path[-1]] * (B - len(path)))
    scalars, bools, array_tabs = pack_assignments(compiled, flat)

    def unflatten(leaf):
        return leaf.reshape((P_, B) + tuple(leaf.shape[1:]))

    valid = np.zeros((P_, B), dtype=bool)
    for p, c in enumerate(counts):
        valid[p, :c] = True
    return (tuple(unflatten(s) for s in scalars), unflatten(bools),
            tuple(tuple(unflatten(x) for x in tab) for tab in array_tabs)), valid


def _pad_batch(args_tree, pad_to: int, batch: int):
    """Pad the leading candidate dim by repeating the last row.

    Returns ``(args_tree, valid)`` where ``valid`` [pad_to] marks real rows —
    consumers reducing over the batch (n_sat, argmax) must apply it; slicing
    ``[:batch]`` off a gathered result is the equivalent for element-wise use.
    """
    valid = np.arange(pad_to) < batch
    if pad_to == batch:
        return args_tree, valid

    def pad(leaf: torch.Tensor) -> torch.Tensor:
        last = leaf[batch - 1: batch]
        return torch.cat([leaf[:batch], last.expand((pad_to - batch,) + tuple(last.shape[1:]))])

    scalars, bools, array_tabs = args_tree
    return (tuple(pad(s) for s in scalars), pad(bools),
            tuple(tuple(pad(x) for x in tab) for tab in array_tabs)), valid


def evaluate_batch_sharded(
    compiled: CompiledConjunction,
    assignments: Sequence,
    mesh: Optional[FrontierMesh] = None,
) -> np.ndarray:
    """[B, C] truth matrix with the candidate batch sharded over all devices.

    The flat data-parallel path the solver takes when a mesh on its device
    spans more than one device: candidates spread over the whole mesh (both
    axes flattened), one lowering launch per block on its device, the truth
    gathered to the first device and then to the host.  Padding rows (batch
    made divisible by the device count) are sliced off before return.
    ``mesh=None``: ``make_frontier_mesh()``, the card's mesh.
    """
    mesh = mesh or make_frontier_mesh()
    n_dev = mesh.size
    B = len(assignments)
    pad_to = -(-B // n_dev) * n_dev
    args_tree = pack_assignments(compiled, assignments)
    args_tree, _valid = _pad_batch(args_tree, pad_to, B)
    scalars, bools, array_tabs = shard_probe_args(args_tree, mesh, batch_dims=1)
    truth = _truth(compiled, scalars, bools, array_tabs)
    return truth.cpu().numpy()[:B]
