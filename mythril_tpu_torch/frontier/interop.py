"""The JAX layout in and out of the port's tensors, and digests of outputs.

The JAX package's frontier hands numpy arrays to its segment: a
``FrontierState`` of int32 fields, the ``ArenaDev`` columns with ``val`` as
``[T, 16]`` uint32 16-bit limbs, the stacked ``CodeDev`` tables and the
``CfgScalars``.  The port keeps that layout in its tensors (``val`` as
``[T, 16]`` int32, since this torch has no uint32 arithmetic; the CUDA
kernel packs rows into 64-bit words itself).  ``*_to_torch`` carries the
numpy arrays across, ``outputs_to_numpy`` brings a segment's outputs back in
the JAX layout, and ``output_digests`` hashes them, so that a run on the
card can be held against recorded JAX outputs without JAX.
``input_digests`` hashes a dispatch's inputs the same way, so a recorded
sequence of dispatches pins down what the engine handed the segment.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Sequence

import numpy as np
import torch

from mythril_tpu_torch.frontier.state import FrontierState
from mythril_tpu_torch.frontier.step import ArenaDev, CfgScalars, CodeDev

ARENA_COLUMNS = ("op", "a", "b", "c", "width", "val", "isconst")


def state_to_torch(st, device) -> FrontierState:
    """A numpy ``FrontierState`` (any namedtuple with its fields) -> int32
    tensors on ``device``."""
    return FrontierState(*[
        torch.from_numpy(np.ascontiguousarray(np.asarray(getattr(st, n)), np.int32)).to(device)
        for n in FrontierState._fields
    ])


def arena_to_torch(cols: Sequence, device) -> ArenaDev:
    """(op, a, b, c, width, val [T,16] uint32, isconst) -> ``ArenaDev``."""
    op, a, b, c, width, val, isconst = (np.asarray(x) for x in cols)
    i32 = [torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(device) for x in (op, a, b, c, width)]
    val = torch.from_numpy(np.ascontiguousarray(val.astype(np.uint32).view(np.int32))).to(device)
    return ArenaDev(*i32, val, torch.from_numpy(np.ascontiguousarray(isconst, bool)).to(device))


def code_to_torch(tables: Sequence, device) -> CodeDev:
    """The 11 arrays of ``stacked_device_tables`` (any namedtuple or list in
    ``CodeDev`` field order) -> ``CodeDev``."""
    out = []
    for name, x in zip(CodeDev._fields, tables):
        dtype = bool if name in ("event", "concskip", "valgate") else np.int32
        out.append(torch.from_numpy(np.ascontiguousarray(np.asarray(x), dtype)).to(device))
    return CodeDev(*out)


def visited_to_torch(visited, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(visited), bool)).to(device)


def inputs_from_numpy(state, arena_cols, arena_len, visited, code, cfg, device):
    """A segment's numpy inputs in the JAX layout -> the port's arguments
    ``(state, arena, arena_len, visited, code, cfg)`` on ``device``; ``cfg``
    is any sequence in ``CfgScalars`` order (the JAX ``CfgScalars`` too)."""
    return (state_to_torch(state, device), arena_to_torch(arena_cols, device), int(arena_len),
            visited_to_torch(visited, device), code_to_torch(code, device),
            CfgScalars(*[int(np.asarray(v)) for v in cfg]))


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def outputs_to_numpy(outputs, arena_rows=None):
    """A segment's ``(state, arena, arena_len, n_exec, max_live, visited)``,
    the port's or the JAX package's -> numpy in the JAX layout:
    ``(state fields dict, arena columns dict, arena_len, n_exec, max_live,
    visited)``, arena ``val`` as uint32.  ``arena_rows`` keeps only the
    first rows of the arena (sliced before the copy)."""
    state, arena, arena_len, n_exec, max_live, visited = outputs
    fields = {n: _np(getattr(state, n)).astype(np.int32) for n in FrontierState._fields}
    cols = {}
    for n in ARENA_COLUMNS:
        x = getattr(arena, n)
        x = _np(x if arena_rows is None else x[:arena_rows])
        cols[n] = (x.astype(np.int32).view(np.uint32) if n == "val"
                   else x.astype(bool) if n == "isconst" else x.astype(np.int32))
    return (fields, cols, int(_np(arena_len)), int(_np(n_exec)), int(_np(max_live)),
            _np(visited).astype(bool))


def _sha(x: np.ndarray) -> str:
    h = hashlib.sha256(str(x.shape).encode())
    h.update(np.ascontiguousarray(x).tobytes())
    return h.hexdigest()


def output_digests(outputs) -> Dict[str, object]:
    """sha256 of every output array in the JAX layout (state fields as
    int32, arena rows ``[0, arena_len)`` per column, ``val`` as uint32,
    ``isconst`` and ``visited`` as uint8), and the three scalars."""
    arena_len = int(_np(outputs[2]))
    fields, cols, arena_len, n_exec, max_live, visited = outputs_to_numpy(outputs, arena_len)
    out: Dict[str, object] = {f"state.{n}": _sha(x) for n, x in fields.items()}
    for n, x in cols.items():
        out[f"arena.{n}"] = _sha(x.astype(np.uint8) if n == "isconst" else x)
    out["visited"] = _sha(visited.astype(np.uint8))
    out.update(arena_len=arena_len, n_exec=n_exec, max_live=max_live)
    return out


def input_digests(state, arena, arena_len, visited, code, cfg) -> Dict[str, object]:
    """sha256 of a segment dispatch's inputs in the JAX layout, the port's
    tensors or the JAX package's arrays alike: the state's non-event fields
    as int32 (the engine pushes empty event buffers), each arena column's
    rows ``[0, arena_len)`` (``val`` as uint32, ``isconst`` as uint8),
    ``visited`` as uint8, each code table (the boolean ones as uint8), and
    ``arena_len`` and the cfg scalars as ints."""
    n = int(_np(arena_len))
    out: Dict[str, object] = {
        f"state.{f}": _sha(_np(getattr(state, f)).astype(np.int32))
        for f in FrontierState._fields if f not in ("events", "ev_len")
    }
    for name in ARENA_COLUMNS:
        x = _np(getattr(arena, name)[:n])
        x = (x.astype(np.int32).view(np.uint32) if name == "val"
             else x.astype(np.uint8) if name == "isconst" else x.astype(np.int32))
        out[f"arena.{name}"] = _sha(x)
    out["visited"] = _sha(_np(visited).astype(np.uint8))
    for name, x in zip(CodeDev._fields, code):
        x = _np(x)
        out[f"code.{name}"] = _sha(x.astype(np.uint8) if x.dtype == bool else x.astype(np.int32))
    out["arena_len"] = n
    out["cfg"] = [int(_np(v)) for v in cfg]
    return out
