"""Persistent SMT query cache (see cache.py for the tier/soundness story).

Process-wide singleton, mirroring the other telemetry/cache subsystems::

    from mythril_tpu_torch.querycache import get_query_cache, configure

    configure(enabled=True, cache_dir="/tmp/qc")   # facade/CLI do this
    hit = get_query_cache().lookup(conjuncts, budget_ms=2000)

The solver hooks (smt/solver.py) call ``lookup``/``record``; everything
else — bench's warm-vs-cold mode, the facade's flag propagation, tests —
goes through the module-level helpers below.
"""

from mythril_tpu_torch.querycache import canon  # noqa: F401  (import order matters:
# cache.py references this submodule through the package during its import)
from mythril_tpu_torch.querycache.canon import (  # noqa: F401
    QueryFingerprint,
    conjunct_fingerprint,
    fingerprint,
)
from mythril_tpu_torch.querycache.store import DiskStore  # noqa: F401
from mythril_tpu_torch.querycache.cache import (  # noqa: F401
    QueryCache,
    materialize_counters,
)
from mythril_tpu_torch.querycache.cache import _UNSET as _UNSET

from typing import Optional

_cache: Optional[QueryCache] = None


def get_query_cache() -> QueryCache:
    global _cache
    if _cache is None:
        _cache = QueryCache()
    return _cache


def configure(enabled=None, cache_dir=_UNSET) -> None:
    """Partial reconfiguration of the singleton (None/absent = keep)."""
    get_query_cache().configure(enabled=enabled, cache_dir=cache_dir)


def reset_query_cache() -> None:
    """Drop the in-process layers; a configured disk store survives."""
    if _cache is not None:
        _cache.reset()


def clear_query_cache_memos() -> None:
    """Drop term-id-keyed memos only (called with the solver's term-cache
    sweeps so interned DAGs can be collected)."""
    if _cache is not None:
        _cache.clear_memos()
    else:
        canon.clear_memos()
