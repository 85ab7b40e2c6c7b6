"""LaserEVM: the work-list symbolic execution engine.

Reference parity: mythril/laser/ethereum/svm.py:42-739 — strategy-driven main
loop (:261-304), per-instruction execution with plugin/module hooks (:336-449),
nested-call frame management via transaction signals (:451-504), CFG
bookkeeping (:506-532), the 9 laser hook types + per-opcode pre/post hooks
(:100-133, 596-739), and the multi-transaction loop with open-world-state
reseeding (:208-245).

The engine runs its solver queries and device frontier segments on
``self.device`` (resolved once; the CUDA card unless the caller asked for
the CPU).  An error of the frontier engine or of a kernel propagates out of
``exec``: it never turns into a host-only run.
"""

from __future__ import annotations

import copy as _copy
import logging
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

from mythril_tpu_torch.core.cfg import Edge, JumpType, Node, NodeFlags
from mythril_tpu_torch.core.evm_exceptions import StackUnderflowException, VmException
from mythril_tpu_torch.core.instructions import Instruction
from mythril_tpu_torch.core.state.global_state import GlobalState
from mythril_tpu_torch.core.state.world_state import WorldState
from mythril_tpu_torch.core.strategy.basic import BasicSearchStrategy, DepthFirstSearchStrategy
from mythril_tpu_torch.core.transaction.transaction_models import (
    ContractCreationTransaction,
    TransactionEndSignal,
    TransactionStartSignal,
)
from mythril_tpu_torch.device import DeviceLike, resolve
from mythril_tpu_torch.plugins.signals import PluginSkipState, PluginSkipWorldState
from mythril_tpu_torch.support.opcodes import OPCODES, stack_inputs
from mythril_tpu_torch.support.support_args import args
from mythril_tpu_torch.support.time_handler import time_handler

log = logging.getLogger(__name__)

# host steps executed before the production frontier's first drain attempt
# (multiple of the drain cadence 8): enough samples for host_step_rate, so
# the engine's throughput bail starts informed instead of blind
_FRONTIER_WARMUP_STEPS = 24

LASER_HOOK_TYPES = (
    "start_sym_exec",
    "stop_sym_exec",
    "start_sym_trans",
    "stop_sym_trans",
    "start_exec",
    "stop_exec",
    "execute_state",
    "add_world_state",
    "transaction_start",
    "transaction_end",
)


class LaserEVM:
    def __init__(
        self,
        dynamic_loader=None,
        max_depth: int = 128,
        execution_timeout: Optional[int] = None,
        create_timeout: Optional[int] = None,
        strategy=DepthFirstSearchStrategy,
        transaction_count: int = 2,
        requires_statespace: bool = True,
        iprof=None,
        device: DeviceLike = None,
    ):
        self.device = resolve(device)
        self.dynamic_loader = dynamic_loader
        self.open_states: List[WorldState] = []
        self.total_states = 0
        # host stepping telemetry (exec loop): wall and count of host-side
        # execute_state calls, consumed by the frontier's throughput bail
        self._host_steps = 0
        self._host_step_secs = 0.0

        self.work_list: List[GlobalState] = []
        self.strategy: BasicSearchStrategy = strategy(self.work_list, max_depth)
        self.max_depth = max_depth
        self.transaction_count = transaction_count
        self.execution_timeout = execution_timeout or args.execution_timeout
        self.create_timeout = create_timeout if create_timeout is not None else args.create_timeout

        self.requires_statespace = requires_statespace
        self.nodes: Dict[int, Node] = {}
        self.edges: List[Edge] = []

        self.time: Optional[float] = None
        self.executed_transactions = False

        # frontier checkpointing: snapshot path + number of transactions a
        # resumed run has already completed
        self.checkpoint_path: Optional[str] = None
        self.resume_offset: int = 0

        # hook registries
        self._hooks: Dict[str, List[Callable]] = {t: [] for t in LASER_HOOK_TYPES}
        self._pre_hooks: Dict[str, List[Callable]] = defaultdict(list)
        self._post_hooks: Dict[str, List[Callable]] = defaultdict(list)
        self.instr_pre_hook: Dict[str, List[Callable]] = defaultdict(list)
        self.instr_post_hook: Dict[str, List[Callable]] = defaultdict(list)

        self.iprof = iprof
        self.executed_instruction_count = 0
        # the concolic driver's concrete replay: its trace hook must see
        # every instruction, so the frontier engine never takes its states
        # (frontier/engine.py _is_concolic)
        self.concolic = False

    def host_step_rate(self) -> Optional[float]:
        """Measured host stepping rate (states/s) on this workload, or None
        until enough samples exist to be meaningful."""
        if self._host_steps < _FRONTIER_WARMUP_STEPS or self._host_step_secs <= 0:
            return None
        return self._host_steps / self._host_step_secs

    # ------------------------------------------------------------------
    # hook registration (reference svm.py:596-739)
    # ------------------------------------------------------------------

    def register_laser_hooks(self, hook_type: str, hook: Callable) -> None:
        if hook_type not in LASER_HOOK_TYPES:
            raise ValueError(f"unknown laser hook type {hook_type}")
        self._hooks[hook_type].append(hook)

    def register_hooks(self, hook_type: str, hook_dict: Dict[str, List[Callable]]) -> None:
        """Register detection-module hooks keyed by opcode name."""
        target = self._pre_hooks if hook_type == "pre" else self._post_hooks
        for op, funcs in hook_dict.items():
            target[op].extend(funcs)

    def register_instr_hooks(self, hook_type: str, opcode: Optional[str], hook: Callable) -> None:
        """Instruction-level hooks; opcode None means every opcode."""
        registry = self.instr_pre_hook if hook_type == "pre" else self.instr_post_hook
        registry["*" if opcode is None else opcode].append(hook)

    def _fire(self, hook_type: str, *hook_args) -> None:
        for hook in self._hooks[hook_type]:
            hook(*hook_args)

    def extend_strategy(self, extension, **kwargs) -> None:
        self.strategy = extension(self.strategy, **kwargs)

    # ------------------------------------------------------------------
    # top-level entry points (reference svm.py:139-245)
    # ------------------------------------------------------------------

    def sym_exec(
        self,
        world_state: Optional[WorldState] = None,
        target_address: Optional[int] = None,
        creation_code: Optional[bytes] = None,
        contract_name: Optional[str] = None,
    ) -> None:
        from mythril_tpu_torch.core.transaction import symbolic as sym_tx

        pre_configured = world_state is not None and target_address is not None
        self._fire("start_sym_exec")
        time_handler.start_execution(self.execution_timeout)
        self.time = time.time()

        if pre_configured:
            self.open_states = [world_state]
            self._execute_transactions(target_address)
        else:
            assert creation_code is not None
            created = sym_tx.execute_contract_creation(
                self, creation_code, contract_name or "MAIN"
            )
            log.info(
                "finished creation; %d open states, created address %s",
                len(self.open_states),
                created.address,
            )
            if created.address.value is not None:
                self._execute_transactions(created.address.value)

        self._fire("stop_sym_exec")

    def resume(
        self, open_states: List[WorldState], completed_transactions: int, address: int
    ) -> None:
        """Continue from a checkpointed frontier: same start/stop framing as
        ``sym_exec`` but seeded with restored open states and skipping the
        transactions a previous run already completed."""
        self._fire("start_sym_exec")
        time_handler.start_execution(self.execution_timeout)
        self.time = time.time()
        self.open_states = open_states
        self.resume_offset = completed_transactions
        self._execute_transactions(address)
        self._fire("stop_sym_exec")

    def _execute_transactions(self, address: int) -> None:
        """Symbolic-tx loop: each round reseeds from surviving open states.

        When ``checkpoint_path`` is set, the surviving frontier is written
        to disk after every completed transaction (``support/checkpoint.py``;
        a failed write only logs); ``resume_offset`` counts transactions
        already completed by a resumed run.
        """
        from mythril_tpu_torch.core.transaction import symbolic as sym_tx

        self.executed_transactions = True
        for i in range(self.resume_offset, self.transaction_count):
            if not self.open_states:
                break
            # prune unreachable open states before the next round (batched:
            # one device sweep over all open world states)
            if not args.sparse_pruning:
                from mythril_tpu_torch.smt.solver import check_satisfiable_batch

                flags = check_satisfiable_batch(
                    [s.constraints.get_all_raw() for s in self.open_states],
                    device=self.device,
                )
                self.open_states = [
                    s for s, ok in zip(self.open_states, flags) if ok
                ]
            if not self.open_states:
                break
            log.info(
                "starting message call transaction %d; %d open states",
                i,
                len(self.open_states),
            )
            self._fire("start_sym_trans")
            sym_tx.execute_message_call(self, address)
            self._fire("stop_sym_trans")
            if self.checkpoint_path:
                from mythril_tpu_torch.support.checkpoint import save_checkpoint

                try:
                    save_checkpoint(
                        self.checkpoint_path,
                        i + 1,
                        self.open_states,
                        target_address=address,
                    )
                except Exception as e:  # snapshots are best-effort
                    log.warning("checkpoint write failed: %s", e)

    # ------------------------------------------------------------------
    # main loop (reference svm.py:261-304)
    # ------------------------------------------------------------------

    def exec(self, create: bool = False, track_gas: bool = False) -> Optional[List[GlobalState]]:
        final_states: List[GlobalState] = []
        self._fire("start_exec")
        if args.frontier and args.frontier_force and not create and not track_gas:
            # forced mode (tests, explicit override): engage the device
            # before any host stepping.  The production path defers the
            # first drain past a short host warmup (loop below) so the
            # engine's throughput bail compares segment rates against the
            # MEASURED host stepping rate instead of a blind floor.
            from mythril_tpu_torch.frontier import FrontierEngine

            FrontierEngine(self).drain_work_list()
        start = time.perf_counter()
        deadline = (
            start + self.create_timeout
            if create and self.create_timeout
            else start + self.execution_timeout
        )
        frontier_live = args.frontier and not create and not track_gas
        frontier_enabled = frontier_live  # config verdict, never re-armed
        rearm_width = 0  # work-list width that re-arms a zero-drain disable
        pending_seeds = 0  # fresh frames added since the last drain attempt
        iteration = 0
        first_drain_attempted = False
        zero_drains = 0  # consecutive drain attempts that executed nothing
        for global_state in self.strategy:
            if time.perf_counter() > deadline or time_handler.time_remaining() <= 0:
                log.info("%s timeout reached; halting exec loop", "create" if create else "execution")
                break
            # --coverage-target: the request contract ends exploration at
            # the bar (or on an all-codes plateau); checked every 16 host
            # steps so the ledger scan stays off the per-step critical path
            if (args.coverage_target and not create and iteration % 16 == 0
                    and self._coverage_target_stop()):
                log.info("coverage target reached; halting exec loop")
                break
            t_step = time.perf_counter()
            new_states, op_code = self.execute_state(global_state)
            if self.requires_statespace:
                self.manage_cfg(op_code, new_states)
            if not args.sparse_pruning:
                new_states = self._prune_unsatisfiable(new_states)
            # host stepping pace (states/s over the FULL iteration,
            # including sibling pruning — the true wall cost of advancing
            # one state on the host): the frontier's mid-run throughput
            # bail compares device segment rates against it — the host's
            # own pace on a workload spans 5..900 states/s, so no fixed
            # floor can stand in for it
            self._host_step_secs += time.perf_counter() - t_step
            self._host_steps += 1
            self.work_list.extend(new_states)
            self.total_states += len(new_states)
            if track_gas and not new_states:
                final_states.append(global_state)
            # nested frontier segments (SURVEY.md §7.4 item 4): inner
            # message-call frames pushed by the CALL-family handlers are
            # fresh pc=0 seeds, and mid-frame states (resumed callers,
            # earlier spills) re-enter via the engine's mid-frame encoder —
            # periodically hand them to the device (the engine's own width
            # gate decides whether a drain pays)
            iteration += 1
            pending_seeds += len(new_states)
            # a zero-drain disable fires early (iterations ~24-40), when
            # work lists are still narrow; a contract whose fanout widens
            # later must get the device back.  Re-arm when the work list
            # clearly outgrows the width that was being rejected, doubling
            # the threshold each time so flapping decays geometrically.
            if (
                frontier_enabled
                and not frontier_live
                and rearm_width
                and len(self.work_list) >= rearm_width
            ):
                frontier_live = True
                zero_drains = 0
                rearm_width *= 2
            # attempt a drain only once enough seeds accumulated to clear
            # the engine's own width gate — a handful would bail there
            # anyway, and every attempt rescans the work list.  The FIRST
            # attempt waits until host_step_rate is measurable (production
            # mode) so the engine's throughput bail starts informed — the
            # samples persist on the laser, so only the first transaction
            # of an analysis ever pays the warmup; explorations shorter
            # than it are trivially host-fast and never engage the device.
            if frontier_live and iteration % 8 == 0 and (
                pending_seeds >= 8
                or (not first_drain_attempted and self.work_list)
            ) and (
                args.frontier_force or self.host_step_rate() is not None
            ):
                first_drain_attempted = True
                pending_seeds = 0
                from mythril_tpu_torch.frontier import FrontierEngine

                executed = FrontierEngine(self).drain_work_list()
                # three consecutive no-op attempts mean the engine's
                # gates (width / verdict memos) reject this workload:
                # stop paying the per-attempt work-list rescan for the
                # rest of this transaction
                zero_drains = zero_drains + 1 if executed == 0 else 0
                if zero_drains >= 3:
                    frontier_live = False
                    # never shrink below the last re-arm threshold, or
                    # a work list oscillating around it would flap the
                    # device on/off at a constant width forever
                    rearm_width = max(
                        2 * len(self.work_list), 32, rearm_width
                    )
        self._fire("stop_exec")
        return final_states if track_gas else None

    def _coverage_target_stop(self) -> bool:
        """True when the adaptive controller's --coverage-target verdict
        says exploration is over (bar reached or plateau)."""
        try:
            # the instruction-coverage plugin only lands its bitmap in
            # the exploration ledger at stop_sym_exec; the verdict needs
            # the LIVE view, so flush the in-memory planes first
            plugin = getattr(self, "coverage_plugin", None)
            if plugin is not None and getattr(plugin, "coverage", None):
                from mythril_tpu_torch.observability.exploration import (
                    get_exploration_ledger,
                )
                from mythril_tpu_torch.support.support_utils import get_code_hash

                led = get_exploration_ledger()
                for code, (total, seen) in plugin.coverage.items():
                    led.record_instr(
                        get_code_hash(code), total,
                        [i for i, hit in enumerate(seen) if hit],
                    )
            from mythril_tpu_torch.adaptive import get_adaptive_controller

            return get_adaptive_controller().coverage_stop() is not None
        except Exception:  # the contract must never break a run
            log.debug("coverage-target check failed", exc_info=True)
            return False

    def _prune_unsatisfiable(self, states: List[GlobalState]) -> List[GlobalState]:
        """Drop successors with unsatisfiable path conditions.

        Multiple successors (JUMPI siblings) are decided in ONE batched
        solver sweep — on device backends that is a single tape-VM dispatch
        for the whole fork instead of one per state (SURVEY.md §7: the
        pruner as a batched masked reduction over the frontier).
        """
        if not states:
            return states
        if len(states) == 1:
            return states if states[0].world_state.constraints.is_possible else []
        from mythril_tpu_torch.smt.solver import check_satisfiable_batch

        flags = check_satisfiable_batch(
            [s.world_state.constraints.get_all_raw() for s in states],
            device=self.device,
        )
        return [s for s, ok in zip(states, flags) if ok]

    # ------------------------------------------------------------------
    # single-instruction execution (reference svm.py:336-449)
    # ------------------------------------------------------------------

    def execute_state(
        self, global_state: GlobalState
    ) -> Tuple[List[GlobalState], Optional[str]]:
        instructions = global_state.environment.code.instruction_list
        try:
            instruction = instructions[global_state.mstate.pc]
            op_code = instruction.opcode
        except IndexError:
            # implicit STOP off the end of code
            self._add_world_state(global_state)
            return [], None
        global_state.op_code = op_code

        # required stack elements check (reference svm.py:351-357); an arity
        # miss is an exceptional halt, not an engine error
        if op_code in OPCODES and len(global_state.mstate.stack) < stack_inputs(op_code):
            return (
                self._handle_vm_exception(
                    global_state, op_code, f"not enough stack elements for {op_code}"
                ),
                op_code,
            )

        try:
            self._fire("execute_state", global_state)
        except PluginSkipState:
            return [], None

        # detection-module pre hooks
        for hook in self._pre_hooks[op_code]:
            try:
                hook(global_state)
            except PluginSkipState:
                return [], None

        self.executed_instruction_count += 1
        try:
            inst = Instruction(
                op_code,
                self.dynamic_loader,
                pre_hooks=self.instr_pre_hook[op_code] + self.instr_pre_hook["*"],
                post_hooks=self.instr_post_hook[op_code] + self.instr_post_hook["*"],
            )
            new_global_states = inst.evaluate(global_state)

        except VmException as error:
            log.debug("VM exception at pc %d: %s", global_state.mstate.pc, error)
            new_global_states = self._handle_vm_exception(global_state, op_code, str(error))

        except TransactionStartSignal as start_signal:
            self._fire("transaction_start", start_signal.global_state, start_signal.transaction)
            new_global_state = start_signal.transaction.initial_global_state()
            new_global_state.transaction_stack = list(
                start_signal.global_state.transaction_stack
            ) + [(start_signal.transaction, start_signal.global_state)]
            new_global_state.node = global_state.node
            new_global_state.mstate.depth = global_state.mstate.depth
            return [new_global_state], op_code

        except TransactionEndSignal as end_signal:
            transaction, return_global_state = end_signal.global_state.transaction_stack[-1]
            self._fire("transaction_end", end_signal.global_state, transaction, return_global_state, end_signal.revert)
            if return_global_state is None:
                # outermost frame
                if (
                    not isinstance(transaction, ContractCreationTransaction)
                    or transaction.return_data is not None
                ) and not end_signal.revert:
                    end_signal.global_state.world_state.node = global_state.node
                    self._check_potential_issues(end_signal.global_state)
                    self._add_world_state(end_signal.global_state)
                new_global_states = []
            else:
                new_global_states = self._end_message_call(
                    _copy.copy(return_global_state),
                    end_signal.global_state,
                    revert_changes=end_signal.revert,
                    return_data=transaction.return_data,
                    ended_transaction=transaction,
                )

        # detection-module post hooks
        if self._post_hooks[op_code]:
            kept = []
            for new_state in new_global_states:
                skip = False
                for hook in self._post_hooks[op_code]:
                    try:
                        hook(new_state)
                    except PluginSkipState:
                        skip = True
                        break
                if not skip:
                    kept.append(new_state)
            new_global_states = kept

        # depth counts control-flow transfers (JUMP/JUMPI bump it in their
        # handlers, reference instructions.py:1552,1603,1628) — NOT every
        # instruction, or max_depth=128 would cap runs at 128 opcodes
        return new_global_states, op_code

    def _handle_vm_exception(
        self, global_state: GlobalState, op_code: str, error: str
    ) -> List[GlobalState]:
        """Unwind the tx stack on exceptional halt (reference svm.py:317-334)."""
        transaction, return_global_state = global_state.transaction_stack[-1]
        if return_global_state is None:
            return []
        return self._end_message_call(
            _copy.copy(return_global_state),
            global_state,
            revert_changes=True,
            return_data=None,
            ended_transaction=transaction,
        )

    def _end_message_call(
        self,
        return_global_state: GlobalState,
        global_state: GlobalState,
        revert_changes: bool = False,
        return_data=None,
        ended_transaction=None,
    ) -> List[GlobalState]:
        """Resume the caller frame after a child tx (reference svm.py:451-504)."""
        if not revert_changes:
            # adopt the child's world (storage/balances) and its constraints
            return_global_state.world_state = global_state.world_state
            addr = return_global_state.environment.active_account.address.value
            if addr is not None and addr in global_state.world_state.accounts:
                return_global_state.environment.active_account = (
                    global_state.world_state.accounts[addr]
                )
        else:
            # reverted: state rolls back, path constraints remain
            for constraint in global_state.world_state.constraints[
                len(return_global_state.world_state.constraints) :
            ]:
                return_global_state.world_state.constraints.append(constraint)

        # child's gas is spent either way
        return_global_state.mstate.min_gas_used += global_state.mstate.min_gas_used
        return_global_state.mstate.max_gas_used += global_state.mstate.max_gas_used

        return_global_state.last_return_data = return_data
        if ended_transaction is not None:
            return_global_state.call_output_location = (
                getattr(ended_transaction, "memory_out_offset", None),
                getattr(ended_transaction, "memory_out_size", None),
            )

        # resume via the <op>_post handler of the call instruction
        op_code = return_global_state.environment.code.instruction_list[
            return_global_state.mstate.pc
        ].opcode
        try:
            new_states = Instruction(op_code, self.dynamic_loader).evaluate(
                return_global_state, post=True
            )
        except VmException:
            new_states = []
        return new_states

    def _check_potential_issues(self, global_state: GlobalState) -> None:
        """Solve deferred issues at tx end (reference svm.py:423)."""
        from mythril_tpu_torch.analysis.potential_issues import check_potential_issues

        check_potential_issues(global_state)

    def _add_world_state(self, global_state: GlobalState) -> None:
        """Archive a surviving world state as a seed for the next tx."""
        try:
            self._fire("add_world_state", global_state)
        except (PluginSkipState, PluginSkipWorldState):
            return
        self.open_states.append(global_state.world_state)

    # ------------------------------------------------------------------
    # CFG bookkeeping (reference svm.py:506-532)
    # ------------------------------------------------------------------

    def manage_cfg(self, opcode: Optional[str], new_states: List[GlobalState]) -> None:
        if opcode is None:
            return
        if opcode == "JUMP":
            for state in new_states:
                self._new_node_state(state)
        elif opcode == "JUMPI":
            for state in new_states:
                condition = (
                    state.world_state.constraints[-1]
                    if state.world_state.constraints
                    else None
                )
                self._new_node_state(state, JumpType.CONDITIONAL, condition)
        elif opcode in ("CALL", "CALLCODE", "DELEGATECALL", "STATICCALL", "CREATE", "CREATE2"):
            for state in new_states:
                self._new_node_state(state, JumpType.CALL)
        elif opcode in ("RETURN", "STOP"):
            for state in new_states:
                self._new_node_state(state, JumpType.RETURN)
        for state in new_states:
            if state.node is not None:
                state.node.states.append(state)

    def _new_node_state(self, state: GlobalState, edge_type=JumpType.UNCONDITIONAL, condition=None) -> None:
        if not self.requires_statespace:
            return
        old_node = state.node
        new_node = Node(state.environment.active_account.contract_name)
        new_node.start_addr = state.get_current_instruction()["address"]
        self.nodes[new_node.uid] = new_node
        if old_node is not None:
            self.edges.append(
                Edge(old_node.uid, new_node.uid, edge_type=edge_type, condition=condition)
            )
        state.node = new_node
        new_node.constraints = state.world_state.constraints.copy()
        # function-entry naming
        address = new_node.start_addr
        env = state.environment
        if env.code is not None and address in env.code.address_to_function_name:
            new_node.flags |= NodeFlags.FUNC_ENTRY
            new_node.function_name = env.code.address_to_function_name[address]
        elif old_node is not None:
            new_node.function_name = old_node.function_name
