"""The solver's abstract prefilter (tier 0.58): intervals plus known bits.

The port's counterpart of ``mythril_tpu/absdomain``.  Before a constraint
set reaches the exact tiers, a sound abstraction of it (unsigned intervals
and known bits, ``domains.py``) is evaluated over the packed constraint rows
of a whole batch at once (``tape.pack``).  A row whose abstraction is bottom
has no concrete model: the conjunction is UNSAT.  Everything else falls
through to the other tiers unchanged.

The known-bits pass runs on the device (``device.run_kb``: the CUDA kernel
on the card, its plain PyTorch version on the CPU); the float64 interval
pass and the verdicts stay host numpy, as in the JAX package.

Entry points
------------
``prefilter_batch(rows, device)``
    One verdict per constraint row; ``True`` means *proven UNSAT*.
``refute(conjuncts, device)``
    The single-row form (the solver's tier 0.58).

Verdicts are memoized under the frozenset of conjunct tids.
``prefilter.{evaluated,killed,fallthrough}`` counters and the
``prefilter.eval_s`` histogram in the metrics registry account every fresh
evaluation, as in the JAX package; memo hits are not counted.  The module
attributes ``evaluated``, ``killed`` and ``fallthrough`` read the
counters.  Unsupported structure and
other errors of the host steps fall through (never a verdict); any error
of the device pass (no card, a kernel that did not build, launch or run)
propagates.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import List, Optional, Sequence

from mythril_tpu_torch.device import DeviceLike, resolve
from mythril_tpu_torch.native.bitblast import Unsupported
from mythril_tpu_torch.smt.terms import Term

__all__ = ["prefilter_batch", "refute", "reset_state", "reset_counters"]

# Verdict memo: frozenset of conjunct tids -> proven-UNSAT bool.  Terms are
# interned process-wide, so keys stay valid across analyses; UNSAT is a
# semantic fact and never expires.  Bounded FIFO to cap memory.
_MEMO_CAP = 8192
_memo: "OrderedDict[frozenset, bool]" = OrderedDict()
_memo_lock = threading.Lock()

_COUNTER_NAMES = ("evaluated", "killed", "fallthrough")


def _counters():
    from mythril_tpu_torch.observability import get_registry

    reg = get_registry()
    return (
        reg.counter("prefilter.evaluated"),
        reg.counter("prefilter.killed"),
        reg.counter("prefilter.fallthrough"),
        reg.histogram("prefilter.eval_s"),
    )


def __getattr__(name: str):
    """``evaluated``, ``killed``, ``fallthrough``: the registry counters."""
    if name in _COUNTER_NAMES:
        from mythril_tpu_torch.observability import get_registry

        m = get_registry()._metrics.get("prefilter." + name)
        return m.value if m is not None else 0
    raise AttributeError(name)


def reset_state() -> None:
    """Drop the verdict memo."""
    with _memo_lock:
        _memo.clear()


def reset_counters() -> None:
    from mythril_tpu_torch.observability import get_registry

    get_registry().reset(prefix="prefilter.")


def _memo_get(key: frozenset) -> Optional[bool]:
    with _memo_lock:
        return _memo.get(key)


def _memo_put(key: frozenset, verdict: bool) -> None:
    with _memo_lock:
        _memo[key] = verdict
        while len(_memo) > _MEMO_CAP:
            _memo.popitem(last=False)


class _HostFault(Exception):
    """A host-side step failed: the whole batch falls through, as in the
    JAX package, whose ``prefilter_batch`` catches it at the top."""


def _evaluate_rows(rows: List[Sequence[Term]], device) -> List[Optional[bool]]:
    """Pack + evaluate; ``None`` marks fallthrough (unsupported structure).

    Only the host steps (``tape.pack``, the interval pass, the verdicts) are
    guarded; the known-bits pass on ``device`` is not, so an error of the
    kernel, of its launch or of the syncs that read its outputs propagates.
    """
    from mythril_tpu_torch.absdomain import device as kb_device
    from mythril_tpu_torch.absdomain import domains, tape

    try:
        pack = tape.pack(rows)
    except Unsupported:
        if len(rows) == 1:
            return [None]
        # one poisoned row must not cost its siblings the pass
        out: List[Optional[bool]] = []
        for row in rows:
            out.extend(_evaluate_rows([row], device))
        return out
    except Exception as exc:
        raise _HostFault from exc

    km, kv, kb_ref = kb_device.run_kb(pack, device)
    try:
        lo, hi, iv_ref = domains.eval_iv_host(pack)
        v = domains.verdicts(pack, lo, hi, km, kv, iv_ref | kb_ref)
    except Exception as exc:
        raise _HostFault from exc
    return [bool(x) for x in v]


def prefilter_batch(conjunct_sets: Sequence[Sequence[Term]],
                    device: DeviceLike = None) -> List[bool]:
    """One abstract verdict per constraint row; True = proven UNSAT.

    Unsupported structure, oversized tapes and host-side errors degrade to
    False (fall through to the exact tiers); an error of the known-bits
    pass on the device (a ``DeviceError``, a fault that surfaces when its
    outputs are read, a wrapper's own check) raises.
    ``device``: None is the CUDA card; pass ``"cpu"`` for the plain path.
    """
    n = len(conjunct_sets)
    results: List[Optional[bool]] = [None] * n
    keys = [frozenset(t.tid for t in cs) for cs in conjunct_sets]

    fresh_idx: List[int] = []
    fresh_key_pos: dict = {}
    for i, key in enumerate(keys):
        hit = _memo_get(key)
        if hit is not None:
            results[i] = hit
        elif key in fresh_key_pos:
            results[i] = -1  # duplicate within the batch; filled below
        else:
            fresh_key_pos[key] = len(fresh_idx)
            fresh_idx.append(i)

    if fresh_idx:
        dev = resolve(device)
        c_eval, c_kill, c_fall, h_eval = _counters()
        t0 = time.perf_counter()
        try:
            verdicts = _evaluate_rows([list(conjunct_sets[i]) for i in fresh_idx], dev)
        except _HostFault:
            verdicts = [None] * len(fresh_idx)
        h_eval.observe(time.perf_counter() - t0)
        c_eval.inc(len(fresh_idx))
        for i, v in zip(fresh_idx, verdicts):
            if v is None:
                c_fall.inc()
                v = False
            elif v:
                c_kill.inc()
            _memo_put(keys[i], v)
            results[i] = v

    for i, key in enumerate(keys):
        if results[i] == -1:
            results[i] = _memo_get(key) or False
    return [bool(r) for r in results]


def refute(conjuncts: Sequence[Term], device: DeviceLike = None) -> bool:
    """True iff the abstraction PROVES ``conjuncts`` unsatisfiable."""
    return prefilter_batch([conjuncts], device)[0]
