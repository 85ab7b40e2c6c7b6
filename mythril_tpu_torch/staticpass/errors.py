"""Typed errors for the static pass.

Over-approximation invariants in ``mythril_tpu_torch/staticpass`` MUST raise
these (never bare ``assert``): the pass gates what the engine executes
and what the detector loader registers, so an invariant stripped under
``python -O`` would silently turn a soundness bug into missed issues.
The repo-local ruff rule (``S101`` scoped to this package in
``pyproject.toml``) enforces the ban mechanically.

Every consumer of the pass treats an escaped :class:`StaticPassError`
as "no static information" (``summary_for_code`` catches and returns
None), so raising here degrades to the unpruned analysis — it never
takes the analysis down.
"""

from __future__ import annotations


class StaticPassError(Exception):
    """Base class: any failure inside the static pre-analysis."""


class StaticInvariantError(StaticPassError):
    """An over-approximation invariant the pass relies on was violated
    (e.g. a refined reachability mask wider than the base mask, or an
    edge-liveness array misaligned with the instruction tables).  Raised
    instead of ``assert`` so ``-O`` cannot strip the check."""


class DispatchRecoveryError(StaticPassError):
    """Selector-dispatch recovery hit an internal inconsistency.  The
    recoverer catches this itself and degrades to the whole-contract
    single function, so callers only ever see the degraded result."""


def invariant(condition: bool, message: str) -> None:
    """``assert`` replacement that survives ``python -O``."""
    if not condition:
        raise StaticInvariantError(message)
