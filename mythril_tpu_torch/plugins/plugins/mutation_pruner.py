"""Mutation pruner: drop world states whose transaction changed nothing.

Reference parity: mythril/laser/plugin/plugins/mutation_pruner.py:36-89 —
SSTORE/CALL/STATICCALL mark the state with MutationAnnotation; at
add_world_state time, unannotated states with provably-zero callvalue are
skipped (a "clean" path cannot enable anything in later transactions).
"""

from __future__ import annotations

from mythril_tpu_torch.core.state.global_state import GlobalState
from mythril_tpu_torch.core.transaction.transaction_models import ContractCreationTransaction
from mythril_tpu_torch.plugins.interface import LaserPlugin, PluginBuilder
from mythril_tpu_torch.plugins.plugin_annotations import MutationAnnotation
from mythril_tpu_torch.plugins.signals import PluginSkipWorldState
from mythril_tpu_torch.smt import UGT, symbol_factory
from mythril_tpu_torch.smt.solver import (
    ProbeConfig,
    SAT,
    UNKNOWN,
    SolverStatistics,
    solve_conjunction,
)
from mythril_tpu_torch.support.support_args import args


# opcodes whose execution marks the state as mutating; the frontier engine's
# batched prefetch (frontier/engine.py) must classify paths identically
MUTATOR_OPCODES = ("SSTORE", "CALL", "STATICCALL", "CREATE", "CREATE2")

# the per-query probe budget for the "can callvalue exceed 0" check; shared
# with the frontier prefetch so its warmed memo entries match the hook's
MUTATION_PROBE_CONFIG = dict(
    max_rounds=1, candidates_per_round=16, timeout_ms=500, prune_critical=True,
    # "is a nonzero callvalue still possible" is satisfiable on almost every
    # path (callvalue is free up to the balance bound): answer it from a few
    # directed candidates before any exact-UNSAT machinery
    sat_biased=True,
)


class MutationPruner(LaserPlugin):
    def initialize(self, symbolic_vm) -> None:
        def mutator_hook(global_state: GlobalState):
            global_state.annotate(MutationAnnotation())

        symbolic_vm.register_hooks(
            "pre", {op: [mutator_hook] for op in MUTATOR_OPCODES}
        )

        def world_state_filter_hook(global_state: GlobalState):
            if isinstance(global_state.current_transaction, ContractCreationTransaction):
                return
            if global_state.get_annotations(MutationAnnotation):
                return
            # no mutation: only keep if the tx could have moved value
            value = global_state.current_transaction.call_value
            status, _ = solve_conjunction(
                global_state.world_state.constraints.get_all_raw()
                + [UGT(value, symbol_factory.BitVecVal(0, 256)).raw],
                ProbeConfig(**MUTATION_PROBE_CONFIG),
                device=args.device,
            )
            if status != SAT:
                if status == UNKNOWN:
                    SolverStatistics().unknown_as_unsat += 1
                raise PluginSkipWorldState

        symbolic_vm.register_laser_hooks("add_world_state", world_state_filter_hook)


class MutationPrunerBuilder(PluginBuilder):
    name = "mutation-pruner"

    def __call__(self, *args, **kwargs) -> LaserPlugin:
        return MutationPruner()
