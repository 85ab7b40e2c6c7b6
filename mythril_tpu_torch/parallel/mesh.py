"""Frontier mesh construction and probe-input sharding.

Axes:
  * ``path`` — independent symbolic-execution paths (each with its own
    constraint conjunction data).  The data-parallel axis: no communication
    is needed between paths except the final best-score/issue reductions.
  * ``cand`` — the candidate-assignment batch evaluated for one path.  The
    intra-problem axis: conjunct truth columns are computed shard-locally,
    score reductions cross it.

The port's counterpart of ``mythril_tpu/parallel/mesh.py``.  The JAX mesh
is a ``jax.sharding.Mesh`` that GSPMD partitions jitted programs over; here
a ``FrontierMesh`` is a ``(path, cand)`` array of ``torch.device``s in one
process, and the work on it is placed by hand:

* the probe's candidate blocks (``shard_probe_args``) each go to their
  shard's device, where ``parallel/probe.py`` launches the lowering kernel
  once per block; their truth comes back to the mesh's first device (the
  leader), where the small reductions run in plain torch;
* the frontier state is partitioned over the path axis
  (``shard_frontier_inputs``): shard k is slot block k (``slot_shard``),
  a block of the state in allocations of its own on shard k's device (a
  ``step.ShardedState``), which the runner's injection, rebalance, pull
  attribution and replay key work on.  The arena, the coverage planes and
  the code tables stay on the leader (the segment copies the tables to
  each card).  The segment is the partitioned kernel
  (``step.segment_partitioned``): one launch per card over its block,
  the fork grant's ranks and free slots across cards on every step, a
  child's row copied into another card's block, the cards meeting at a
  barrier in the leader's memory (which needs peer access between every
  pair: building the mesh raises and names ``--no-mesh`` without it); or,
  for logical shards of one device, one launch holding every block.  Its
  outputs are the unsharded segment's bit for bit, as GSPMD's are.

A mesh may name one device several times: logical shards, the counterpart
of XLA's forced host device count.  ``mesh_devices`` tells the engine and
the solver which devices a mesh on a device spans: every visible CUDA
device for a CUDA device, the CPU alone for the CPU, or, inside
``logical_shards(n)``, ``n`` shards of that one device.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import numpy as np
import torch

from mythril_tpu_torch.device import resolve

PATH_AXIS = "path"
CAND_AXIS = "cand"

# the number of logical shards a mesh spans inside ``logical_shards``
_LOGICAL_SHARDS: Optional[int] = None


def _factor_2d(n: int) -> tuple:
    """Split n devices into (path, cand) with path the largest divisor <= sqrt(n)."""
    best = 1
    d = 1
    while d * d <= n:
        if n % d == 0:
            best = d
        d += 1
    return best, n // best


@contextlib.contextmanager
def logical_shards(n: int):
    """Inside the block, a mesh on any device spans ``n`` logical shards of
    that one device (``mesh_devices``).  For tests on the CPU and checks on
    one card; the command line never sets it."""
    global _LOGICAL_SHARDS
    if n < 1:
        raise ValueError(f"logical shards: {n} < 1")
    saved, _LOGICAL_SHARDS = _LOGICAL_SHARDS, n
    try:
        yield
    finally:
        _LOGICAL_SHARDS = saved


def mesh_devices(device) -> List[torch.device]:
    """The devices a mesh on ``device`` spans, ``device`` first (a CUDA
    device with its index): inside ``logical_shards(n)`` ``n`` times
    ``device``; else for a CUDA device every visible card, for any other
    device that device alone."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if _LOGICAL_SHARDS is not None:
        return [dev] * _LOGICAL_SHARDS
    if dev.type != "cuda":
        return [dev]
    return [dev] + [torch.device("cuda", i) for i in range(torch.cuda.device_count())
                    if i != dev.index]


class FrontierMesh:
    """A 2-D ``(path, cand)`` array of devices (``devices``, numpy object
    array), ``jax.sharding.Mesh``'s fields for the port: ``axis_names``,
    ``shape`` (axis -> size), ``size``; ``leader`` is the first device,
    ``path_devices`` the path axis's."""

    def __init__(self, devices: np.ndarray):
        self.devices = devices
        self.axis_names = (PATH_AXIS, CAND_AXIS)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def leader(self) -> torch.device:
        return self.devices.flat[0]

    @property
    def path_devices(self) -> List[torch.device]:
        """The devices along the path axis (the first of each row): where
        the frontier state's slot blocks live."""
        return list(self.devices[:, 0])


def make_frontier_mesh(devices: Optional[Sequence] = None,
                       path_size: Optional[int] = None) -> FrontierMesh:
    """Build the 2-D (path, cand) mesh over the given devices (default:
    ``mesh_devices`` of the card, every visible CUDA device; raises
    ``NoCudaDevice`` without one).  Over several cards it turns on peer
    access between every pair, which the partitioned segment needs, and
    raises a ``DeviceError`` naming ``--no-mesh`` where a pair cannot
    reach each other's memory."""
    devices = [torch.device(d) for d in (
        devices if devices is not None else mesh_devices(resolve(None)))]
    n = len(devices)
    if len({d for d in devices if d.type == "cuda"}) > 1:
        from mythril_tpu_torch.frontier.step import enable_peer_access

        enable_peer_access(devices)
    if path_size is None:
        p, c = _factor_2d(n)
    else:
        if n % path_size:
            raise ValueError(f"path_size {path_size} does not divide {n} devices")
        p, c = path_size, n // path_size
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return FrontierMesh(grid.reshape(p, c))


def pad_batch(b: int, n_shards: int) -> int:
    """Smallest multiple of ``n_shards`` >= ``b``: the slot-batch width that
    shards evenly over the path axis.  The extra slots are dead (seed -1
    free slots) and cost only their share of the packed transfers."""
    if n_shards <= 1:
        return b
    return b + (-b) % n_shards


def shard_size(b: int, n_shards: int) -> int:
    """Slots per path-shard; ``b`` must already be a multiple (pad_batch)."""
    assert n_shards >= 1 and b % n_shards == 0, (b, n_shards)
    return b // n_shards


def slot_shard(slot: int, b: int, n_shards: int) -> int:
    """Owning path-shard of a slot: the path axis splits [B] into
    ``n_shards`` contiguous blocks, matching GSPMD's dim-0 partitioning."""
    return slot // shard_size(b, n_shards)


def shard_slots(b: int, n_shards: int) -> np.ndarray:
    """[B] vector mapping every slot to its owning shard."""
    return np.arange(b) // shard_size(b, n_shards)


def shard_frontier_inputs(state, arena_dev, visited, code_dev, mesh: FrontierMesh):
    """Place the segment's inputs for ``mesh``: the state (a host numpy
    mirror, pushed with ``push_state``, or tensors of the whole batch)
    partitioned over the path axis, slot block k on the mesh's k-th device
    (a ``ShardedState``); the arena, the coverage planes and the code
    tables on the leader.  Returns (state, arena_dev, visited, code_dev);
    pass them to the ordinary segment, which takes a ``ShardedState`` as
    the partitioned segment."""
    from mythril_tpu_torch.frontier.state import FrontierState
    from mythril_tpu_torch.frontier.step import ShardedState, push_state

    leader = mesh.leader
    devices = mesh.path_devices
    if isinstance(state.pc, torch.Tensor):
        bs = shard_size(int(state.pc.shape[0]), len(devices))
        state = ShardedState([FrontierState(*[f[k * bs:(k + 1) * bs].to(d, copy=True)
                                              for f in state])
                              for k, d in enumerate(devices)])
    else:
        state = push_state(state, device=leader, devices=devices)
    arena_dev = type(arena_dev)(*[x.to(leader) for x in arena_dev])
    visited = torch.as_tensor(visited).to(leader)
    code_dev = type(code_dev)(*[x.to(leader) for x in code_dev])
    return state, arena_dev, visited, code_dev


class ShardedLeaf:
    """One probe-input leaf cut into the mesh's blocks (a ``jax.Array``
    with a ``NamedSharding``, for the port): ``blocks[k]`` lies on
    ``devices[k]`` and holds ``index[k]``, a tuple of slices over the leaf's
    leading batch dims, whose whole extent is ``shape``."""

    def __init__(self, shape: tuple, blocks: list, devices: list, index: list):
        self.shape, self.blocks, self.devices, self.index = shape, blocks, devices, index


def _block_index(batch_shape: tuple, mesh: FrontierMesh, batch_dims: int) -> list:
    """The slices of each block, in the mesh's device order (path major)."""
    p, c = mesh.devices.shape
    if batch_dims == 2:
        P_, B = batch_shape
        if P_ % p or B % c:
            raise ValueError(f"batch {batch_shape} does not split over the mesh {(p, c)}")
        return [(slice(i * (P_ // p), (i + 1) * (P_ // p)),
                 slice(j * (B // c), (j + 1) * (B // c))) for i in range(p) for j in range(c)]
    (B,) = batch_shape
    n = p * c
    if B % n:
        raise ValueError(f"batch {B} does not split over {n} devices")
    return [(slice(k * (B // n), (k + 1) * (B // n)),) for k in range(n)]


def shard_probe_args(args_tree, mesh: FrontierMesh, batch_dims: int = 1):
    """Cut every probe-input leaf into its mesh blocks, each block copied to
    its shard's device (a ``ShardedLeaf``).

    ``args_tree`` is the (scalars, bools, array_tabs) tuple produced by
    mythril_tpu_torch/ops/lowering.pack_assignments (or ``pack_frontier``'s
    stacked variant).  ``batch_dims == 2``: leaves carry [P, B, ...], dim 0
    split over ``path`` and dim 1 over ``cand``; ``batch_dims == 1``: flat
    [B, ...] candidate batches split over both axes flattened.  Trailing
    structure dims stay whole; the batch must split evenly."""
    devices = list(mesh.devices.flat)
    scalars, bools, array_tabs = args_tree
    index = _block_index(tuple(bools.shape[:batch_dims]), mesh, batch_dims)

    def shard(leaf: torch.Tensor) -> ShardedLeaf:
        return ShardedLeaf(tuple(leaf.shape[:batch_dims]),
                           [leaf[ix].contiguous().to(d) for ix, d in zip(index, devices)],
                           devices, index)

    return (tuple(shard(s) for s in scalars), shard(bools),
            tuple(tuple(shard(x) for x in tab) for tab in array_tabs))
