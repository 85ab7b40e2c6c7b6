"""Concolic driver: replay a concrete input, then flip requested branches.

Reference parity: mythril/concolic/concolic_execution.py:22-85, by way of
the JAX package's ``concolic/concolic_execution.py``.

The port's driver runs on one device (``device``: None is the CUDA card and
raises ``NoCudaDevice`` without one; ``"cpu"`` runs the plain PyTorch
kernels), resolved once: the concrete replay, the symbolic re-execution and
every flip's solver query run on it (``analysis_device`` sets
``args.device`` for the run, and the flips' ``get_transaction_sequence``
reads it).  A concolic laser never reaches the device frontier
(``frontier/engine.py`` ``_is_concolic``).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from mythril_tpu_torch.analysis.symbolic import analysis_device
from mythril_tpu_torch.concolic.concrete_data import ConcreteData
from mythril_tpu_torch.concolic.find_trace import concrete_execution
from mythril_tpu_torch.core.strategy.concolic import ConcolicStrategy
from mythril_tpu_torch.core.svm import LaserEVM
from mythril_tpu_torch.core.transaction import symbolic as sym_tx
from mythril_tpu_torch.core.transaction.transaction_models import tx_id_manager
from mythril_tpu_torch.device import DeviceLike, resolve


def flip_branches(
    init_state, concrete_data: ConcreteData, jump_addresses: List[int],
    trace: List, hits_out: Optional[Dict] = None, device: DeviceLike = None,
) -> List[Dict]:
    """Re-execute symbolically along the trace on ``device``, flipping
    requested JUMPIs.

    ``hits_out`` (when given) is filled with addr → bool(result): which
    requested flips actually produced a new concrete input — the adaptive
    flip counters read it; output parity is untouched."""
    from mythril_tpu_torch.support.time_handler import time_handler

    dev = resolve(device)
    tx_id_manager.restart_counter()
    output_list = []
    laser_evm = LaserEVM(
        execution_timeout=600,
        transaction_count=len(concrete_data["steps"]),
        requires_statespace=False,
        device=dev,
    )
    laser_evm.open_states = [init_state]
    laser_evm.strategy = ConcolicStrategy(
        work_list=laser_evm.work_list,
        max_depth=128,
        trace=trace,
        flip_branch_addresses=jump_addresses,
    )

    time_handler.start_execution(laser_evm.execution_timeout)

    with analysis_device(dev):
        for transaction in concrete_data["steps"]:
            sym_tx.execute_message_call(
                laser_evm, int(transaction["address"], 16)
            )

    if isinstance(laser_evm.strategy, ConcolicStrategy):
        for addr, result in laser_evm.strategy.results.items():
            if hits_out is not None:
                hits_out[addr] = bool(result)
            if result:
                output_list.append(result)
    return output_list


def concolic_execution(
    concrete_data: ConcreteData,
    jump_addresses: List[int],
    solver_timeout: int = 100000,
    flip_targets: Optional[List[int]] = None,
    device: DeviceLike = None,
) -> List[Dict]:
    """Main entry (reference :67-85): returns new concrete inputs, one per
    flipped branch, computed on ``device``.

    ``flip_targets`` are PLANNED flips from the adaptive controller —
    uncovered-JUMPI addrs the steering plan ranked by static
    interesting-point priority.  They merge into ``jump_addresses``
    (dedup, caller order first so explicitly requested flips keep their
    precedence) and their outcomes feed the ``adaptive.flips_planned`` /
    ``adaptive.flips_hit`` counters: a planned addr whose flip produced a
    new concrete input is a hit."""
    from mythril_tpu_torch.support.support_args import args
    from mythril_tpu_torch.support.time_handler import time_handler

    dev = resolve(device)
    planned = [a for a in (flip_targets or []) if a not in set(jump_addresses)]
    if planned:
        jump_addresses = list(jump_addresses) + planned
    old_timeout = args.solver_timeout
    old_remaining = time_handler.time_remaining()
    args.solver_timeout = solver_timeout
    # (the replay and the flips each reset the process-global time budget
    # themselves; this frame only restores the caller's)
    try:
        init_state, trace = concrete_execution(concrete_data, dev)
        hits: Dict = {}
        out = flip_branches(init_state, concrete_data, jump_addresses,
                            trace, hits_out=hits, device=dev)
        if planned:
            _count_planned_flips(planned, hits)
        return out
    finally:
        # leaked process-global budgets silently reshape every later
        # analysis (solver_timeout feeds the engine's prune/confirm
        # deadlines; the time handler feeds every exec loop)
        args.solver_timeout = old_timeout
        time_handler.start_execution(max(0, old_remaining))


def _count_planned_flips(planned: List[int], hits: Dict) -> None:
    """Feed the adaptive flip counters; telemetry only, never raises."""
    try:
        from mythril_tpu_torch.adaptive import get_adaptive_controller

        get_adaptive_controller().count_flips(
            planned=len(planned),
            hit=sum(1 for a in planned if hits.get(a)),
        )
    except Exception:
        pass
