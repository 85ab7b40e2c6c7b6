"""Concrete replay: execute a recorded tx sequence and record the trace.

Reference parity: mythril/concolic/find_trace.py:21-79, by way of the JAX
package's ``concolic/find_trace.py`` — the reference needs an external
MythX trace plugin; here trace recording is built in via the
TraceAnnotation strategy machinery.

The port's replay runs on one device (``device``: None is the CUDA card
and raises ``NoCudaDevice`` without one; ``"cpu"`` runs the plain PyTorch
kernels): the engine's solver queries and every query made without a laser
at hand (``analysis_device`` sets ``args.device`` for the replay).  Its
laser never reaches the device frontier (``LaserEVM.concolic``): the JAX
package's does when the frontier is forced, and its trace then misses the
instructions the device stepped.
"""

from __future__ import annotations

import binascii
from typing import List, Tuple

from mythril_tpu_torch.analysis.symbolic import analysis_device
from mythril_tpu_torch.concolic.concrete_data import ConcreteData
from mythril_tpu_torch.core.state.world_state import WorldState
from mythril_tpu_torch.core.strategy.basic import BreadthFirstSearchStrategy
from mythril_tpu_torch.core.svm import LaserEVM
from mythril_tpu_torch.core.transaction import concolic as concolic_tx
from mythril_tpu_torch.device import DeviceLike, resolve
from mythril_tpu_torch.frontend.disassembler import Disassembly
from mythril_tpu_torch.smt import symbol_factory


def setup_concrete_initial_state(concrete_data: ConcreteData) -> WorldState:
    """Build a WorldState from the JSON initial state (reference :21-40)."""
    world_state = WorldState()
    for address, details in concrete_data["initialState"]["accounts"].items():
        account = world_state.create_account(
            balance=int(details["balance"], 16) if isinstance(details["balance"], str) else details["balance"],
            address=int(address, 16),
            concrete_storage=True,
            nonce=details.get("nonce", 0),
        )
        if details.get("code"):
            account.code = Disassembly(details["code"].replace("0x", ""))
        for key, value in details.get("storage", {}).items():
            account.storage[symbol_factory.BitVecVal(int(key, 16), 256)] = (
                symbol_factory.BitVecVal(int(value, 16), 256)
            )
    return world_state


def concrete_execution(
    concrete_data: ConcreteData, device: DeviceLike = None
) -> Tuple[WorldState, List]:
    """Replay all steps on ``device``; returns (initial world state,
    [(pc, tx_id)] trace)."""
    from mythril_tpu_torch.core.transaction.transaction_models import tx_id_manager
    from mythril_tpu_torch.support.time_handler import time_handler

    dev = resolve(device)
    # the trace pairs (pc, tx_id) and flip_branches restarts the id counter
    # before the symbolic re-execution — the concrete replay must start from
    # the same ids or a second concolic run in one process never matches
    tx_id_manager.restart_counter()
    world_state = setup_concrete_initial_state(concrete_data)
    laser_evm = LaserEVM(
        execution_timeout=1000,
        transaction_count=len(concrete_data["steps"]),
        requires_statespace=False,
        strategy=BreadthFirstSearchStrategy,
        device=dev,
    )
    # every instruction steps on the host, where the trace hook sees it:
    # the frontier engine never takes this laser's states
    laser_evm.concolic = True
    # the exec loop consults the PROCESS-GLOBAL deadline too: an expired
    # budget left by an earlier analysis in this process would record an
    # empty trace (the laser's own execution_timeout is not enough)
    time_handler.start_execution(laser_evm.execution_timeout)
    trace: List[Tuple[int, str]] = []

    def execute_state_hook(global_state):
        instr = global_state.get_current_instruction()
        tx = global_state.current_transaction
        trace.append((instr["address"], tx.id if tx else "?"))

    laser_evm.register_laser_hooks("execute_state", execute_state_hook)
    laser_evm.open_states = [world_state]

    import copy as _copy

    initial_world_state = _copy.copy(world_state)
    with analysis_device(dev):
        for transaction in concrete_data["steps"]:
            concolic_tx.execute_message_call(
                laser_evm,
                callee_address=transaction["address"],
                caller_address=transaction["origin"],
                origin_address=transaction["origin"],
                code=transaction["address"],
                data=list(binascii.unhexlify(transaction["input"].replace("0x", ""))),
                gas_limit=int(transaction.get("gasLimit", "0x7a1200"), 16),
                gas_price=int(transaction.get("gasPrice", "0x0"), 16),
                value=int(transaction.get("value", "0x0"), 16),
            )
    return initial_world_state, trace
