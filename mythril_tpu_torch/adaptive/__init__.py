"""Coverage-guided adaptive exploration (the observe→steer loop).

The exploration ledger's coverage bitmaps and termination taxonomy, the
static reachable-edge oracle and the solver-hotspot attribution observe an
analysis; this package acts on them:

* :mod:`.plan` — the pure planner: ledger snapshots in, a
  :class:`~mythril_tpu_torch.adaptive.plan.SteeringPlan` out (slot-budget
  weights biased at uncovered reachable edges, a requeue list for
  ``budget_exhausted`` parks, ranked concolic flip targets, per-code
  plateau verdicts).
* :mod:`.controller` — the process-wide actuation state: the throttled
  plan cache, the deterministic deficit scheduler the frontier consults
  at sync points, the ``--coverage-target`` stop verdict, and the
  ``adaptive.*`` counters.

``--no-adaptive`` disables every actuation site; the steering is a
strict scheduling optimization, so the issue set is bit-identical either
way (bench ``--adaptive-compare`` asserts it).

A copy of ``mythril_tpu/adaptive/__init__.py`` (the package renamed).  The
controller's ``count_flips`` is fed by the concolic driver
(``concolic/concolic_execution.py``) for the planned flips it is given.
"""

from mythril_tpu_torch.adaptive.controller import (
    AdaptiveController,
    get_adaptive_controller,
)
from mythril_tpu_torch.adaptive.plan import (
    SteeringPlan,
    build_plan,
    plateau_verdict,
    rank_flip_targets,
    requeue_candidates,
    steer_weights,
    uncovered_reachable,
)

__all__ = [
    "AdaptiveController",
    "SteeringPlan",
    "build_plan",
    "get_adaptive_controller",
    "plateau_verdict",
    "rank_flip_targets",
    "requeue_candidates",
    "steer_weights",
    "uncovered_reachable",
]
