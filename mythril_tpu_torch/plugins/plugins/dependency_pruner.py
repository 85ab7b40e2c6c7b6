"""Dependency pruner: skip blocks that can't touch storage written earlier.

Reference parity: mythril/laser/plugin/plugins/dependency_pruner.py:142-318 —
builds a cross-transaction map of storage locations read per basic block; in
transaction N >= 2, a path is skipped when the blocks it is about to execute
cannot read any location written by the previous transactions.  Symbolic
locations are handled the way the reference does (:142-195): a read/write
pair counts as a potential dependency iff ``read == write`` is satisfiable —
checked here as ONE batched feasibility sweep over all pairs (the same
batched-prune kernel the engine uses) instead of one Z3 call per pair.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Set

from mythril_tpu_torch.core.state.global_state import GlobalState
from mythril_tpu_torch.plugins.interface import LaserPlugin, PluginBuilder
from mythril_tpu_torch.plugins.plugin_annotations import (
    DependencyAnnotation,
    WSDependencyAnnotation,
)
from mythril_tpu_torch.plugins.signals import PluginSkipState
from mythril_tpu_torch.smt import terms as T

log = logging.getLogger(__name__)


def _loc_key(index):
    """Storage location as stored in the dependency maps: a concrete int for
    constants, the raw interned term for symbolic indices."""
    return index.value if index.value is not None else index.raw


def _as_term(loc):
    return T.const(loc, 256) if isinstance(loc, int) else loc


def _key_of(loc):
    return (0, loc) if isinstance(loc, int) else (1, loc.tid)


def may_intersect(reads: Set, written: Set, cache: Dict = None) -> bool:
    """Could any read location equal any written location?

    Fast paths: identical interned terms / equal ints.  A location term
    recorded during transaction N captures THAT transaction's symbolic
    inputs (e.g. ``1_calldata``); a later transaction re-derives the same
    expression over fresh inputs, so when two terms SHARE variables an
    UNSAT on ``r == w`` proves nothing about future instances — such pairs
    always count as potential dependencies.  Variable-disjoint pairs are
    decided by satisfiability of ``r == w``: one batched sweep first
    (reference dependency_pruner.py:169-195 solves each pair with Z3), then
    an exact-UNSAT confirmation for the survivors, because the batch treats
    UNKNOWN as unsat and pruning must explore on uncertainty.  Verdicts
    memoize in ``cache`` (symmetric keys) across the run."""
    if not reads or not written:
        return False
    if reads & written:  # interned terms: identity covers symbolic equality
        return True

    undecided = []  # (key, eq term)
    for r in reads:
        for w in written:
            key = tuple(sorted((_key_of(r), _key_of(w))))
            verdict = cache.get(key) if cache is not None else None
            if verdict is True:
                return True
            if verdict is False:
                continue
            if isinstance(r, int) and isinstance(w, int):
                if cache is not None:
                    cache[key] = r == w
                if r == w:
                    return True
                continue
            rt, wt = _as_term(r), _as_term(w)
            if set(T.free_vars([rt])) & set(T.free_vars([wt])):
                if cache is not None:
                    cache[key] = True
                return True
            undecided.append((key, T.eq(rt, wt)))
    if not undecided:
        return False

    from mythril_tpu_torch.smt.solver import UNSAT, check_satisfiable_batch, solve_conjunction
    from mythril_tpu_torch.support.support_args import args

    flags = check_satisfiable_batch([[eq] for _k, eq in undecided], device=args.device)
    hit = False
    for (key, eq), sat in zip(undecided, flags):
        if sat:
            if cache is not None:
                cache[key] = True
            hit = True
    if hit:
        return True
    for key, eq in undecided:
        status, _ = solve_conjunction([eq], device=args.device)
        if status != UNSAT:
            # uncertainty: explore (do not cache — a later budget may decide)
            return True
        if cache is not None:
            cache[key] = False
    return False


def get_dependency_annotation(state: GlobalState) -> DependencyAnnotation:
    annotations = state.get_annotations(DependencyAnnotation)
    if annotations:
        return annotations[0]
    # inherit from the world state's annotation stack if present
    ws_annotations = state.world_state.get_annotations(WSDependencyAnnotation)
    if ws_annotations and ws_annotations[0].annotations_stack:
        annotation = ws_annotations[0].annotations_stack[-1].__copy__()
    else:
        annotation = DependencyAnnotation()
    state.annotate(annotation)
    return annotation


def get_ws_dependency_annotation(state: GlobalState) -> WSDependencyAnnotation:
    ws_annotations = state.world_state.get_annotations(WSDependencyAnnotation)
    if ws_annotations:
        return ws_annotations[0]
    annotation = WSDependencyAnnotation()
    state.world_state.annotate(annotation)
    return annotation


class DependencyPruner(LaserPlugin):
    def __init__(self):
        self.sloads_on_path: Dict[int, Set] = {}
        self.iteration = 0
        self._pair_cache: Dict = {}

    def initialize(self, symbolic_vm) -> None:
        self.iteration = 0

        def start_sym_trans_hook():
            self.iteration += 1

        def sload_hook(global_state: GlobalState):
            annotation = get_dependency_annotation(global_state)
            key = _loc_key(global_state.mstate.stack[-1])
            annotation.storage_loaded.add(key)
            for block in annotation.path:
                self.sloads_on_path.setdefault(block, set()).add(key)

        def sstore_hook(global_state: GlobalState):
            annotation = get_dependency_annotation(global_state)
            key = _loc_key(global_state.mstate.stack[-1])
            annotation.extend_storage_write_cache(self.iteration, key)

        def call_hook(global_state: GlobalState):
            annotation = get_dependency_annotation(global_state)
            annotation.has_call = True

        def jump_hook(global_state: GlobalState):
            annotation = get_dependency_annotation(global_state)
            address = global_state.get_current_instruction()["address"]
            annotation.path.append(address)
            if self.iteration < 2:
                return
            if annotation.has_call:
                return
            # would this block possibly read something written before?
            written = set()
            for it in range(self.iteration):
                written |= annotation.storage_written.get(it, set())
            ws_annotation = get_ws_dependency_annotation(global_state)
            for dep in ws_annotation.annotations_stack:
                for it, keys in dep.storage_written.items():
                    written |= keys
            reads = self.sloads_on_path.get(address, None)
            if reads is None:
                return  # unknown block: explore it
            # SMT-checked footprint intersection (symbolic locations compare
            # by satisfiability, reference dependency_pruner.py:142-195);
            # the currently-influencing loads count as reads too
            if not may_intersect(
                reads | annotation.storage_loaded, written, self._pair_cache
            ):
                log.debug("pruning block at %d (no storage dependency)", address)
                raise PluginSkipState

        def add_world_state_hook(global_state: GlobalState):
            annotation = get_dependency_annotation(global_state)
            ws_annotation = get_ws_dependency_annotation(global_state)
            # reset per-tx tracking; only storage_written carries over to the
            # next transaction (reference dependency_pruner.py:331-336) — an
            # uncleared storage_loaded would make every later footprint check
            # intersect and silently disable the pruner
            annotation.path = [0]
            annotation.storage_loaded = set()
            ws_annotation.annotations_stack.append(annotation)

        symbolic_vm.register_laser_hooks("start_sym_trans", start_sym_trans_hook)
        symbolic_vm.register_laser_hooks("add_world_state", add_world_state_hook)
        symbolic_vm.register_hooks(
            "pre",
            {
                "SLOAD": [sload_hook],
                "SSTORE": [sstore_hook],
                "CALL": [call_hook],
                "STATICCALL": [call_hook],
                "JUMPDEST": [jump_hook],
            },
        )


class DependencyPrunerBuilder(PluginBuilder):
    name = "dependency-pruner"

    def __call__(self, *args, **kwargs) -> LaserPlugin:
        return DependencyPruner()
