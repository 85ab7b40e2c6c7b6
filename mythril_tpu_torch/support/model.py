"""get_model: the one model-query entry point used across the framework.

Reference parity: mythril/support/model.py:15-63 — memoized over the constraint
tuple, applies the solver timeout clamped by remaining execution time, raises
UnsatError on unsat/unknown.  Here the query routes to the port's probe/CDCL
stack (mythril_tpu_torch/smt/solver.py) on the analysis' device
(``args.device``, set by the entry for the run).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

from mythril_tpu_torch.exceptions import UnsatError
from mythril_tpu_torch.smt.solver import Model, Optimize, ProbeConfig, SAT, UNSAT
from mythril_tpu_torch.support.support_args import args
from mythril_tpu_torch.support.time_handler import time_handler


def get_model(
    constraints,
    minimize=(),
    maximize=(),
    enforce_execution_time: bool = True,
    solver_timeout: Optional[int] = None,
    session=None,
    session_enable: Sequence[int] = (),
) -> Model:
    """Solve ``constraints``; return a Model or raise UnsatError.

    ``session``/``session_enable``: an externally-owned live CDCL session
    (the tx-end issue gate's) that has already blasted this formula family —
    the Optimize answers its initial solve and every bound query under
    assumptions against it instead of re-blasting (caller keeps ownership)."""
    timeout = solver_timeout if solver_timeout is not None else args.solver_timeout
    if enforce_execution_time:
        timeout = min(timeout, int(max(time_handler.time_remaining(), 0) * 1000) // 2 + 1)
    if timeout <= 0:
        raise UnsatError("solver budget exhausted")

    raws = tuple(c.raw if hasattr(c, "raw") else c for c in constraints)
    min_raws = tuple(m.raw if hasattr(m, "raw") else m for m in minimize)
    max_raws = tuple(m.raw if hasattr(m, "raw") else m for m in maximize)
    # the cache key must NOT include the timeout: it is derived from the
    # REMAINING execution time, so it differs on every call and would
    # fragment the cache into all-misses.  A SAT result is valid under any
    # budget; UNSAT/UNKNOWN raise and are never cached.
    key = (raws, min_raws, max_raws)
    hit = _model_memo.get(key)
    if hit is not None:
        return hit
    model, proven = _get_model_cached(
        raws, min_raws, max_raws, timeout, session, session_enable
    )
    if proven:
        # only PROVEN-optimal (or objective-free) models memoize: a
        # budget-truncated refinement must re-solve under a later, larger
        # budget instead of serving its unrefined model forever
        if len(_model_memo) >= 2**18:
            _model_memo.pop(next(iter(_model_memo)))  # FIFO, not flush
        _model_memo[key] = model
    return model


_model_memo: dict = {}


def _get_model_cached(
    raws: tuple,
    min_raws: tuple,
    max_raws: tuple,
    timeout: int,
    session=None,
    session_enable: Sequence[int] = (),
) -> Tuple[Model, bool]:
    # (kept as a separate function so the memo layer above stays readable;
    # ``cache_clear`` mirrors the old lru_cache surface for bench/tests)
    opt = Optimize(
        ProbeConfig(
            max_rounds=args.probe_rounds,
            candidates_per_round=args.probe_candidates,
            timeout_ms=timeout,
        ),
        device=args.device,
        session=session,
        session_enable=session_enable,
    )
    opt.add(*raws)
    for m in min_raws:
        opt.minimize(m)
    for m in max_raws:
        opt.maximize(m)
    if args.solver_log:
        _dump_query(raws, args.solver_log)
    status = opt.check()
    if status != SAT:
        raise UnsatError(f"no model found ({status})")
    return opt.model(), opt.proven_optimal


# compatibility with the old lru_cache surface (bench/_clear_caches and the
# recall-differential suite call _get_model_cached.cache_clear())
_get_model_cached.cache_clear = _model_memo.clear

_dump_counter = [0]


def _dump_query(raws, directory: str) -> None:
    """Dump the query term dump (the .ir analogue of --solver-log .smt2 files)."""
    os.makedirs(directory, exist_ok=True)
    _dump_counter[0] += 1
    path = os.path.join(directory, f"query_{_dump_counter[0]:06d}.ir")
    with open(path, "w") as f:
        for r in raws:
            f.write(repr(r) + "\n")
