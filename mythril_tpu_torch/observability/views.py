"""Read-only views of registry metrics under the port's older names.

The port kept some of the JAX package's registry metrics as module state of
their own packages before the registry held them (``staticpass.COUNTERS``
and ``GATE_DISABLED``, ``querycache.cache.COUNTERS`` and ``ENTRY_HITS``,
``frontier.pipeline.COUNTERS``).  They live in the registry now, under the
JAX package's names; these views keep the old names readable.  A view reads
the registry on every access and creates nothing, so a metric the run never
touched stays out of ``--metrics-out`` as it does in the JAX package.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Iterator, Optional, Sequence

from mythril_tpu_torch.observability.metrics import Counter, get_registry


class CounterView(Mapping):
    """``prefix + name`` counters as ``{name: value}``.  With ``names``, every
    one of them (0 for a counter not created yet); without, the counters
    (not gauges, histograms or labeled counters) that exist under the
    prefix."""

    def __init__(self, prefix: str, names: Optional[Sequence[str]] = None,
                 zero=0):
        self._prefix = prefix
        self._names = tuple(names) if names is not None else None
        self._zero = zero

    def _keys(self):
        if self._names is not None:
            return self._names
        reg = get_registry()
        with reg._lock:
            items = sorted(reg._metrics.items())
        n = len(self._prefix)
        return tuple(name[n:] for name, m in items
                     if name.startswith(self._prefix) and isinstance(m, Counter))

    def __getitem__(self, name: str):
        m = get_registry()._metrics.get(self._prefix + name)
        if isinstance(m, Counter):
            return m.value
        if self._names is not None and name in self._names:
            return 0.0 if name.endswith("_s") else self._zero
        raise KeyError(name)

    def __iter__(self) -> Iterator[str]:
        return iter(self._keys())

    def __len__(self) -> int:
        return len(self._keys())

    def __repr__(self) -> str:
        return repr(dict(self))


class LabeledView(Mapping):
    """The labeled counter ``name`` as ``{label: value}`` ({} until the
    first increment creates it)."""

    def __init__(self, name: str):
        self._name = name

    def _data(self) -> dict:
        m = get_registry()._metrics.get(self._name)
        return dict(m) if isinstance(m, dict) else {}

    def __getitem__(self, label: str):
        return self._data()[label]

    def __iter__(self) -> Iterator[str]:
        return iter(self._data())

    def __len__(self) -> int:
        return len(self._data())

    def __repr__(self) -> str:
        return repr(self._data())
