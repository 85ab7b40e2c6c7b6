"""Symbolic transaction drivers: one fresh symbolic tx per open world state.

Reference parity: mythril/laser/ethereum/transaction/symbolic.py:29-258 —
the ACTORS triple (CREATOR/ATTACKER/SOMEGUY), per-world-state spawning with
fresh symbolic sender/calldata/callvalue, the caller∈ACTORS constraint
(:210-212), and optional function-selector constraints (:77-96).
"""

from __future__ import annotations

import logging
from typing import List, Optional

from mythril_tpu_torch.core.state.calldata import SymbolicCalldata
from mythril_tpu_torch.core.state.world_state import WorldState
from mythril_tpu_torch.core.transaction.transaction_models import (
    ContractCreationTransaction,
    MessageCallTransaction,
    tx_id_manager,
)
from mythril_tpu_torch.smt import And, BitVec, Or, symbol_factory
from mythril_tpu_torch.support.support_args import args

log = logging.getLogger(__name__)


class Actors:
    """The fixed cast of senders used to model who can call the contract."""

    def __init__(self):
        self.addresses = {
            "CREATOR": symbol_factory.BitVecVal(
                0xAFFEAFFEAFFEAFFEAFFEAFFEAFFEAFFEAFFEAFFE, 256
            ),
            "ATTACKER": symbol_factory.BitVecVal(
                0xDEADBEEFDEADBEEFDEADBEEFDEADBEEFDEADBEEF, 256
            ),
            "SOMEGUY": symbol_factory.BitVecVal(
                0xAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA, 256
            ),
        }

    @property
    def creator(self) -> BitVec:
        return self.addresses["CREATOR"]

    @property
    def attacker(self) -> BitVec:
        return self.addresses["ATTACKER"]

    @property
    def someguy(self) -> BitVec:
        return self.addresses["SOMEGUY"]

    def __getitem__(self, item: str) -> BitVec:
        return self.addresses[item]


ACTORS = Actors()


def generate_function_constraints(
    calldata: SymbolicCalldata, func_hashes: List[int], negate: bool = False
) -> List:
    """Constrain the selector to one of the given functions (reference :77-96).

    ``negate=True`` yields the COMPLEMENT (none of the given selectors
    match) — the last cell of the multi-selector seed partition, covering
    fallback dispatch and short-calldata paths."""
    if not func_hashes:
        return []
    from mythril_tpu_torch.smt import Concat

    selector = Concat(*[calldata[i] for i in range(4)])
    options = []
    for h in func_hashes:
        if h == -1:  # fallback: calldatasize < 4
            from mythril_tpu_torch.smt import ULT

            options.append(ULT(calldata.calldatasize, symbol_factory.BitVecVal(4, 256)))
        else:
            options.append(selector == symbol_factory.BitVecVal(h, 32))
    cond = Or(*options)
    if negate:
        from mythril_tpu_torch.smt import Not

        return [Not(cond)]
    return [cond]


def seed_message_call(
    laser_evm, callee_address: int, func_hashes: Optional[List[int]] = None
) -> None:
    """Seed the work list with one symbolic message-call tx per open world
    state WITHOUT executing (reference :99-144 minus the exec call) — the
    cooperative corpus driver seeds many lasers first, then runs all their
    seeds as one multi-code frontier batch.

    Multi-selector seeding (args.multi_selector_seeding): instead of one
    seed with a fully symbolic selector, partition the selector space into
    one seed per function-table entry plus a complement seed (fallback and
    short-calldata paths).  The union of the partition is exactly the
    single-seed state space — recall is unchanged (differentially tested)
    — but the work list starts |selectors|+1 wide, so the batched device
    frontier gets its width up front instead of growing it fork by fork
    through the dispatcher."""
    from copy import copy as _copy

    open_states = laser_evm.open_states[:]
    del laser_evm.open_states[:]

    for open_world_state in open_states:
        seed_groups = [(func_hashes or [], False)]
        if args.multi_selector_seeding and not func_hashes:
            code = getattr(open_world_state[callee_address], "code", None)
            hashes = [
                h for h in (getattr(code, "func_hashes", None) or []) if h != -1
            ]
            if hashes:
                seed_groups = [([h], False) for h in hashes] + [(hashes, True)]
        for gi, (group, negate) in enumerate(seed_groups):
            # each seed needs its OWN world state: the selector constraint
            # lands on world_state.constraints, which sibling seeds must
            # not observe.  The last group keeps the original object — one
            # copy per sibling, none for a single-seed partition.
            world_state = (
                _copy(open_world_state)
                if gi < len(seed_groups) - 1
                else open_world_state
            )
            next_tx_id = tx_id_manager.get_next_tx_id()
            external_sender = symbol_factory.BitVecSym(f"sender_{next_tx_id}", 256)
            calldata = SymbolicCalldata(next_tx_id)
            transaction = MessageCallTransaction(
                world_state=world_state,
                identifier=next_tx_id,
                gas_limit=8_000_000,
                origin=external_sender,
                caller=external_sender,
                callee_account=world_state[callee_address],
                call_data=calldata,
                call_value=symbol_factory.BitVecSym(f"call_value{next_tx_id}", 256),
            )
            constraints = generate_function_constraints(
                calldata, list(group), negate
            )
            _setup_global_state_for_execution(laser_evm, transaction, constraints)


def execute_message_call(
    laser_evm, callee_address: int, func_hashes: Optional[List[int]] = None
) -> None:
    """Spawn one symbolic message-call tx per open world state (reference :99-144)."""
    seed_message_call(laser_evm, callee_address, func_hashes)
    laser_evm.exec()


def execute_contract_creation(
    laser_evm,
    contract_initialization_code,
    contract_name: Optional[str] = None,
    world_state: Optional[WorldState] = None,
):
    """Run the creation tx; returns the created account (reference :147-192)."""
    if isinstance(contract_initialization_code, str):
        contract_initialization_code = bytes.fromhex(
            contract_initialization_code.replace("0x", "")
        )
    from mythril_tpu_torch.frontend.disassembler import Disassembly

    world_state = world_state or WorldState()
    open_states = [world_state]
    del laser_evm.open_states[:]
    new_account = None
    for open_world_state in open_states:
        next_tx_id = tx_id_manager.get_next_tx_id()
        # the creator sends the creation tx
        transaction = ContractCreationTransaction(
            world_state=open_world_state,
            identifier=next_tx_id,
            gas_limit=8_000_000,
            origin=ACTORS.creator,
            caller=ACTORS.creator,
            code=Disassembly(contract_initialization_code),
            call_value=symbol_factory.BitVecSym(f"call_value{next_tx_id}", 256),
            contract_name=contract_name,
        )
        _setup_global_state_for_execution(laser_evm, transaction, [])
        new_account = transaction.callee_account
    laser_evm.exec(create=True)
    return new_account


def _setup_global_state_for_execution(laser_evm, transaction, initial_constraints) -> None:
    """Seed the work list with the tx's initial state (reference :195-236)."""
    global_state = transaction.initial_global_state()
    global_state.transaction_stack.append((transaction, None))
    for c in initial_constraints:
        global_state.world_state.constraints.append(c)

    # the caller is one of the modeled actors (reference :210-212)
    global_state.world_state.constraints.append(
        Or(
            transaction.caller == ACTORS.creator,
            transaction.caller == ACTORS.attacker,
            transaction.caller == ACTORS.someguy,
        )
    )
    global_state.world_state.transaction_sequence.append(transaction)

    # CFG root node for this tx
    if laser_evm.requires_statespace:
        from mythril_tpu_torch.core.cfg import Node, NodeFlags

        active = global_state.environment.active_account
        node = Node(active.contract_name if active else "unknown")
        node.constraints = global_state.world_state.constraints.copy()
        if isinstance(transaction, ContractCreationTransaction):
            node.flags |= NodeFlags.FUNC_ENTRY
            node.function_name = "constructor"
        else:
            node.flags |= NodeFlags.FUNC_ENTRY
            node.function_name = "fallback"
        laser_evm.nodes[node.uid] = node
        global_state.node = node
        global_state.world_state.node = node

    laser_evm.work_list.append(global_state)
