"""SymExecWrapper: end-to-end orchestration of one contract's analysis.

Reference parity: mythril/analysis/symbolic.py:39-312 — strategy selection,
engine construction, bounded-loops wrapping, default plugin loading, detection
module hook registration, CREATOR/ATTACKER world-state seeding, creation vs
runtime execution, and post-hoc Call-op extraction from the statespace.

The port's wrapper resolves the analysis' device once (``device``: None is
the CUDA card and raises ``NoCudaDevice`` without one; ``"cpu"`` runs the
plain PyTorch kernels), carries it on the ``LaserEVM`` to the frontier
engine, and sets it as ``args.device`` for the solver calls made during the
run, restoring the previous value after.  The kernels build at first use;
a build or launch error raises.  The static pass gates the detection
modules before their hooks are registered, as in the JAX package, and
disables itself on a resumed run (``resume_from``: the checkpoint's open
states, not the contract, say what code runs).  ``checkpoint_path`` writes
the open states after every transaction (``support/checkpoint.py``, the
JAX package's format); ``resume_from`` continues from such a file, whichever
package wrote it.  ``defer_exec`` builds the analysis without running it,
for the cooperative driver (``analysis/cooperative.py``), which runs the
transactions and calls ``finalize``.
"""

from __future__ import annotations

import contextlib
import logging
from typing import List, Optional

from mythril_tpu_torch.analysis.module.base import EntryPoint
from mythril_tpu_torch.analysis.module.loader import ModuleLoader
from mythril_tpu_torch.analysis.module.util import get_detection_module_hooks
from mythril_tpu_torch.analysis.ops import Call, Variable, VarType, get_variable
from mythril_tpu_torch.core.state.world_state import WorldState
from mythril_tpu_torch.core.strategy.basic import (
    BasicSearchStrategy,
    BeamSearch,
    BreadthFirstSearchStrategy,
    DepthFirstSearchStrategy,
    ReturnRandomNaivelyStrategy,
    ReturnWeightedRandomStrategy,
)
from mythril_tpu_torch.core.strategy.extensions.bounded_loops import BoundedLoopsStrategy
from mythril_tpu_torch.core.svm import LaserEVM
from mythril_tpu_torch.core.transaction.symbolic import ACTORS
from mythril_tpu_torch.device import DeviceLike, resolve
from mythril_tpu_torch.observability import tracer as _otrace
from mythril_tpu_torch.plugins.loader import LaserPluginLoader
from mythril_tpu_torch.plugins.plugins.call_depth_limiter import CallDepthLimitBuilder
from mythril_tpu_torch.plugins.plugins.coverage import CoveragePluginBuilder
from mythril_tpu_torch.plugins.plugins.dependency_pruner import DependencyPrunerBuilder
from mythril_tpu_torch.plugins.plugins.instruction_profiler import InstructionProfilerBuilder
from mythril_tpu_torch.plugins.plugins.mutation_pruner import MutationPrunerBuilder
from mythril_tpu_torch.support.support_args import args

log = logging.getLogger(__name__)


@contextlib.contextmanager
def analysis_device(device):
    """``args.device`` set to ``device`` for the body, restored after; the
    device plane notes its type (the report's ``meta.device.backend``)."""
    from mythril_tpu_torch.observability.deviceplane import note_backend

    saved = args.device
    args.device = device
    note_backend(device)
    try:
        yield
    finally:
        args.device = saved


class SymExecWrapper:
    def __init__(
        self,
        contract,
        address,
        strategy: str = "dfs",
        dynloader=None,
        max_depth: int = 128,
        execution_timeout: Optional[int] = None,
        loop_bound: int = 3,
        create_timeout: Optional[int] = None,
        transaction_count: int = 2,
        modules: Optional[List[str]] = None,
        compulsory_statespace: bool = True,
        disable_dependency_pruning: bool = False,
        run_analysis_modules: bool = True,
        enable_coverage_strategy: bool = False,
        custom_modules_directory: str = "",
        checkpoint_path: Optional[str] = None,
        resume_from: Optional[str] = None,
        device: DeviceLike = None,
        defer_exec: bool = False,
    ):
        self.device = resolve(device)
        with analysis_device(self.device):
            if isinstance(address, str):
                address = int(address, 16)
            self.address = address

            strategy_cls = {
                "dfs": DepthFirstSearchStrategy,
                "bfs": BreadthFirstSearchStrategy,
                "naive-random": ReturnRandomNaivelyStrategy,
                "weighted-random": ReturnWeightedRandomStrategy,
                "beam-search": BeamSearch,
                "pending": DepthFirstSearchStrategy,
            }.get(strategy)
            if strategy_cls is None:
                raise ValueError(f"invalid search strategy: {strategy}")

            requires_statespace = compulsory_statespace or run_analysis_modules

            # seed world state with the actor accounts (reference symbolic.py:100-117)
            world_state = WorldState()
            world_state.accounts_exist_or_load(ACTORS.creator.value, dynloader)
            attacker_acct = world_state.accounts_exist_or_load(ACTORS.attacker.value, dynloader)

            self.laser = LaserEVM(
                dynamic_loader=dynloader,
                max_depth=max_depth,
                execution_timeout=execution_timeout,
                create_timeout=create_timeout,
                strategy=strategy_cls,
                transaction_count=transaction_count,
                requires_statespace=requires_statespace,
                device=self.device,
            )

            self.laser.checkpoint_path = checkpoint_path or args.checkpoint_path
            self._resume_from = resume_from or args.resume_from

            if loop_bound is not None:
                self.laser.extend_strategy(BoundedLoopsStrategy, loop_bound=loop_bound)

            plugin_loader = LaserPluginLoader()
            plugin_loader.load(CoveragePluginBuilder())
            plugin_loader.load(MutationPrunerBuilder())
            plugin_loader.load(CallDepthLimitBuilder())
            if args.enable_iprof:
                plugin_loader.load(InstructionProfilerBuilder())
            self._benchmark_plugin = None
            if args.benchmark_path:
                # instantiated directly (not via the loader) so the series can
                # be written out after execution
                from mythril_tpu_torch.plugins.plugins.benchmark import BenchmarkPlugin

                self._benchmark_plugin = BenchmarkPlugin()
                self._benchmark_plugin.initialize(self.laser)
            plugin_loader.add_args("call-depth-limit", call_depth_limit=args.call_depth_limit)
            if not disable_dependency_pruning:
                plugin_loader.load(DependencyPrunerBuilder())
            plugin_loader.instrument_virtual_machine(self.laser)

            if enable_coverage_strategy:
                from mythril_tpu_torch.plugins.plugins.coverage import (
                    CoverageStrategy,
                    InstructionCoverage,
                )

                coverage_plugin = InstructionCoverage()
                coverage_plugin.initialize(self.laser)
                self.laser.strategy = CoverageStrategy(self.laser.strategy, coverage_plugin)

            if custom_modules_directory:
                ModuleLoader().load_custom_modules(custom_modules_directory)

            if run_analysis_modules:
                # static pre-analysis gate: modules statically proven
                # irrelevant for this contract never register their hooks
                # (mythril_tpu_torch/staticpass — over-approximate, so the
                # issue set is unchanged; --no-staticpass restores blind wiring)
                from mythril_tpu_torch.staticpass import gate_view_for_contract

                static_view = gate_view_for_contract(
                    contract, dynloader=dynloader, resume_from=self._resume_from
                )
                analysis_modules = ModuleLoader().get_detection_modules(
                    EntryPoint.CALLBACK, white_list=modules, static_view=static_view
                )
                self.laser.register_hooks(
                    hook_type="pre",
                    hook_dict=get_detection_module_hooks(analysis_modules, "pre"),
                )
                self.laser.register_hooks(
                    hook_type="post",
                    hook_dict=get_detection_module_hooks(analysis_modules, "post"),
                )

            # deferred execution: the cooperative corpus driver owns the tx
            # loop (analysis/cooperative.py) — set up the account, stash
            # the world state, and skip both execution and statespace
            # post-processing
            self.deferred_world_state: Optional[WorldState] = None
            if defer_exec:
                if not isinstance(contract, (bytes, bytearray)):
                    raise ValueError("defer_exec supports raw runtime bytecode only")
                from mythril_tpu_torch.frontend.disassembler import Disassembly

                acct = world_state.create_account(
                    balance=0, address=address, concrete_storage=False
                )
                acct.code = Disassembly(bytes(contract))
                self.deferred_world_state = world_state
                return

            # execute (creation vs runtime, reference symbolic.py:168-220)
            with _otrace.span("analysis.sym_exec", cat="analysis"):
                if self._resume_from:
                    self._exec_resumed(address)
                elif isinstance(contract, (bytes, bytearray)):
                    # raw runtime bytecode
                    from mythril_tpu_torch.frontend.disassembler import Disassembly

                    acct = world_state.create_account(
                        balance=0, address=address, concrete_storage=False
                    )
                    acct.code = Disassembly(bytes(contract))
                    self.laser.sym_exec(
                        world_state=world_state, target_address=address
                    )
                elif getattr(contract, "creation_code", None):
                    self._exec_creation(contract, world_state)
                else:
                    acct = world_state.create_account(
                        balance=0, address=address, concrete_storage=False
                    )
                    acct.code = contract.disassembly
                    acct.contract_name = getattr(contract, "name", "Unknown")
                    self.laser.sym_exec(
                        world_state=world_state, target_address=address
                    )

            self._write_benchmark()

            if not requires_statespace:
                return

            self.nodes = self.laser.nodes
            self.edges = self.laser.edges
            self._parse_calls()

    def finalize(self) -> None:
        """Deferred-run epilogue: the benchmark series and the statespace
        post-processing the eager constructor path does after execution.
        Called by the cooperative driver once its transaction loop ends."""
        self._write_benchmark()
        if not self.laser.requires_statespace:
            return
        self.nodes = self.laser.nodes
        self.edges = self.laser.edges
        self._parse_calls()

    def _write_benchmark(self) -> None:
        if self._benchmark_plugin is not None:
            try:
                self._benchmark_plugin.write_to_file(args.benchmark_path)
            except OSError as e:
                log.warning("could not write benchmark series: %s", e)

    def _exec_resumed(self, address: int) -> None:
        """Continue a checkpointed run: reload the frontier and hand the
        engine the restored open states (LaserEVM.resume owns the framing)."""
        from mythril_tpu_torch.support.checkpoint import load_checkpoint

        completed, open_states, saved_address = load_checkpoint(
            self._resume_from, dynamic_loader=self.laser.dynamic_loader
        )
        if saved_address is not None:
            address = saved_address
        log.info(
            "resuming from %s: %d transactions done, %d open states",
            self._resume_from,
            completed,
            len(open_states),
        )
        self.laser.resume(open_states, completed, address)

    def _exec_creation(self, contract, world_state: WorldState) -> None:
        from mythril_tpu_torch.core.transaction import symbolic as sym_tx

        self.laser._fire("start_sym_exec")
        from mythril_tpu_torch.support.time_handler import time_handler

        time_handler.start_execution(self.laser.execution_timeout)
        created = sym_tx.execute_contract_creation(
            self.laser,
            contract.creation_code,
            getattr(contract, "name", "MAIN"),
            world_state=world_state,
        )
        if created is not None and created.address.value is not None:
            self.laser._execute_transactions(created.address.value)
        self.laser._fire("stop_sym_exec")

    # -- statespace post-processing (reference symbolic.py:228-308) ---------

    def _parse_calls(self) -> None:
        self.calls: List[Call] = []
        for key in self.nodes:
            for state in self.nodes[key].states:
                instruction = state.get_current_instruction()
                op = instruction["opcode"]
                if op in ("CALL", "CALLCODE", "DELEGATECALL", "STATICCALL"):
                    stack = state.mstate.stack
                    required = 7 if op in ("CALL", "CALLCODE") else 6
                    if len(stack) < required:
                        continue
                    if op in ("CALL", "CALLCODE"):
                        gas, to, value = (
                            get_variable(stack[-1]),
                            get_variable(stack[-2]),
                            get_variable(stack[-3]),
                        )
                        self.calls.append(
                            Call(self.nodes[key], state, None, op, to, gas, value)
                        )
                    else:
                        gas, to = get_variable(stack[-1]), get_variable(stack[-2])
                        self.calls.append(
                            Call(self.nodes[key], state, None, op, to, gas)
                        )
