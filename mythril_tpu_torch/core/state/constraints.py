"""Path condition: an append-only list of Bool terms.

Reference parity: mythril/laser/ethereum/state/constraints.py:10-109.
``is_possible`` is the engine's pruning question — answered by the probe/CDCL
stack here rather than Z3.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

from mythril_tpu_torch.smt import Bool, symbol_factory
from mythril_tpu_torch.smt.solver import (
    ProbeConfig,
    SAT,
    UNKNOWN,
    SolverStatistics,
    solve_conjunction,
)
from mythril_tpu_torch.support.support_args import args


class Constraints(list):
    def __init__(self, constraint_list: Optional[Iterable[Bool]] = None):
        super().__init__(constraint_list or [])

    def append(self, constraint) -> None:
        if isinstance(constraint, bool):
            constraint = symbol_factory.BoolVal(constraint)
        super().append(constraint)

    @property
    def is_possible(self) -> bool:
        """Quick satisfiability probe used for successor pruning."""
        status, _ = solve_conjunction(
            self.get_all_raw(),
            ProbeConfig(
                max_rounds=2,
                candidates_per_round=24,
                timeout_ms=2000,
                prune_critical=True,
            ),
            device=args.device,
        )
        if status == UNKNOWN:
            SolverStatistics().unknown_as_unsat += 1
        return status == SAT

    def get_all_constraints(self) -> "Constraints":
        return Constraints(self)

    def get_all_raw(self) -> List:
        return [c.raw if hasattr(c, "raw") else c for c in self]

    def __copy__(self) -> "Constraints":
        return Constraints(self)

    def copy(self) -> "Constraints":
        return Constraints(self)

    def __add__(self, other) -> "Constraints":
        out = Constraints(self)
        for c in other:
            out.append(c)
        return out
