"""Multi-host corpus sharding — the DCN scaling axis.

SURVEY.md §5.8: the mesh carries the candidate/frontier axes inside one host
(mythril_tpu_torch/parallel/mesh.py); ACROSS hosts the natural unit is a whole
contract, because contracts share nothing (no collectives needed — the DCN
traffic is just result gathering).  Each host analyzes a deterministic
round-robin slice of the corpus; shard identity comes from
``torch.distributed`` (rank and world size) once its process group is
initialised, or from ``MYTHRIL_TPU_SHARD``/
``MYTHRIL_TPU_NUM_SHARDS`` for process-per-host launches without it.
"""

from __future__ import annotations

import logging
import os
from typing import Callable, List, Optional, Sequence, Tuple

from mythril_tpu_torch.device import is_device_fault

log = logging.getLogger(__name__)


def shard_identity() -> Tuple[int, int]:
    """(shard index, shard count) for this process.

    Order of precedence: explicit env override, ``torch.distributed``'s
    process group once it is initialised with more than one process (its
    rank and world size, where the JAX package reads
    ``jax.process_index()``/``process_count()``), else single-shard.  A
    malformed or out-of-range env identity is a launcher bug that must fail
    loudly — an index outside the count would silently drop that host's
    slice of the corpus.
    """
    env_idx = os.environ.get("MYTHRIL_TPU_SHARD")
    env_cnt = os.environ.get("MYTHRIL_TPU_NUM_SHARDS")
    if (env_idx is None) != (env_cnt is None):
        raise ValueError(
            "set BOTH MYTHRIL_TPU_SHARD and MYTHRIL_TPU_NUM_SHARDS (or "
            "neither) — a partial override would silently duplicate the sweep"
        )
    if env_idx is not None and env_cnt is not None:
        try:
            index, count = int(env_idx), int(env_cnt)
        except ValueError as e:
            raise ValueError(
                "MYTHRIL_TPU_SHARD / MYTHRIL_TPU_NUM_SHARDS must be integers, "
                f"got {env_idx!r} / {env_cnt!r}"
            ) from e
        if not (count >= 1 and 0 <= index < count):
            raise ValueError(
                f"shard identity out of range: index {index}, count {count}"
            )
        return index, count
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _resolve_identity(
    index: Optional[int], count: Optional[int]
) -> Tuple[int, int]:
    """Both-or-neither: explicit (index, count) pair, else shard_identity()."""
    if (index is None) != (count is None):
        raise ValueError("pass both index and count, or neither")
    if index is None:
        return shard_identity()
    if not (count >= 1 and 0 <= index < count):
        raise ValueError(f"shard identity out of range: index {index}, count {count}")
    return index, count


def shard_corpus(
    items: Sequence, index: Optional[int] = None, count: Optional[int] = None
) -> List:
    """Deterministic round-robin slice of ``items`` for one shard.

    Round-robin (not contiguous blocks) so corpora sorted by size spread
    their heavy tail across hosts.
    """
    index, count = _resolve_identity(index, count)
    if count <= 1:
        return list(items)
    return [item for i, item in enumerate(items) if i % count == index]


def run_corpus(
    paths: Sequence[str],
    analyze_one: Callable[[str], object],
    index: Optional[int] = None,
    count: Optional[int] = None,
) -> List[Tuple[str, object]]:
    """Analyze this shard's slice; one contract's failure never kills the
    sweep (graceful degradation, the reference's fire_lasers discipline),
    except a device fault, which reaches the caller."""
    idx, cnt = _resolve_identity(index, count)
    mine = shard_corpus(list(paths), idx, cnt)
    log.info("corpus shard %d/%d: %d of %d contracts", idx, cnt, len(mine), len(paths))
    results: List[Tuple[str, object]] = []
    for path in mine:
        try:
            results.append((path, analyze_one(path)))
        except Exception as e:  # noqa: BLE001 - per-contract isolation
            if is_device_fault(e):
                raise
            log.exception("corpus item %s failed", path)
            results.append((path, e))
    return results


def assert_corpus_recall(
    shard_results: Sequence[Sequence[Tuple[str, object]]],
    expected: dict,
) -> None:
    """Aggregate recall across ALL shards' findings.

    ``shard_results``: one ``[(path, swc-id set | Exception)]`` list per
    shard (what each host's sweep returned).  Every contract in ``expected``
    must appear in exactly the union — a shard that never reported (or
    errored on) a contract carrying a known vulnerability fails the sweep
    loudly instead of weakening recall silently on multi-host runs.
    """
    import os

    found: dict = {}
    for shard in shard_results:
        for path, result in shard:
            name = os.path.basename(str(path))
            if isinstance(result, Exception):
                continue  # absence is caught by the coverage check below
            found.setdefault(name, set()).update(result)
    missing = [
        f"{name} (want SWC-{swc}, got {sorted(found.get(name, set()))})"
        for name, swc in expected.items()
        if swc not in found.get(name, set())
    ]
    if missing:
        raise AssertionError(
            "corpus recall lost across shards: " + "; ".join(missing)
        )
