"""Solver glue: turn a satisfiable state into a concrete transaction sequence.

Reference parity: mythril/analysis/solver.py:51-256 — get_transaction_sequence
solves the path constraints with calldata-size/callvalue minimization and
balance sanity bounds, reifies concrete initial state and per-tx calldata, and
post-processes symbolic hash placeholders (here unnecessary: keccak terms are
concrete under any model by construction).
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

from mythril_tpu_torch.core.state.constraints import Constraints
from mythril_tpu_torch.core.state.global_state import GlobalState
from mythril_tpu_torch.core.transaction.transaction_models import (
    BaseTransaction,
    ContractCreationTransaction,
)
from mythril_tpu_torch.exceptions import UnsatError
from mythril_tpu_torch.observability import tracer as _otrace
from mythril_tpu_torch.smt import UGE, ULE, symbol_factory
from mythril_tpu_torch.smt.solver import Model
from mythril_tpu_torch.support.model import get_model

log = logging.getLogger(__name__)


def get_transaction_sequence(
    global_state: GlobalState,
    constraints: Constraints,
    session=None,
    session_enable=(),
) -> Dict:
    """Generate concrete transaction sequence satisfying ``constraints``.

    Raises UnsatError if no model exists/was found.

    ``session``/``session_enable``: the tx-end issue gate's live CDCL
    session (analysis/potential_issues.py), blasted once over the shared
    path prefix + sanity bounds + these same minimization objectives, with
    this issue's constraints behind the enable literal — the confirmation
    solve then answers everything under assumptions instead of re-blasting
    (the reference pays exactly one z3.Optimize per issue,
    mythril/analysis/solver.py:51-101; this matches that solve count).
    """
    transaction_sequence = global_state.world_state.transaction_sequence
    concrete_transactions = []

    tx_constraints, minimize = _set_minimisation_constraints(
        transaction_sequence, constraints.copy(), [], 5000, global_state.world_state
    )
    # issue confirmation is one of the query cache's entry points: the
    # solve below flows through the solver's cache hook; the span records
    # how much of it the cache absorbed
    from mythril_tpu_torch.querycache.cache import entry_hits

    with _otrace.span("analysis.confirm_solve", cat="analysis") as sp, \
            entry_hits("confirm", sp):
        model = get_model(
            tx_constraints,
            minimize=minimize,
            session=session,
            session_enable=session_enable,
        )

    # keccak terms evaluate concretely under the model — no sha replacement
    # pass needed (reference needed _replace_with_actual_sha, solver.py:128-164)
    min_price_dict: Dict[str, int] = {}
    for transaction in transaction_sequence:
        concrete_transaction = _get_concrete_transaction(model, transaction)
        concrete_transactions.append(concrete_transaction)
        caller = concrete_transaction["origin"]
        value = int(concrete_transaction["value"], 16)
        min_price_dict[caller] = min_price_dict.get(caller, 0) + value

    if isinstance(transaction_sequence[0], ContractCreationTransaction):
        initial_accounts = transaction_sequence[0].prev_world_state.accounts
    else:
        initial_accounts = transaction_sequence[0].world_state.accounts

    concrete_initial_state = _get_concrete_state(initial_accounts, min_price_dict)
    steps = {"initialState": concrete_initial_state, "steps": concrete_transactions}
    return steps


def _get_concrete_state(initial_accounts: Dict, min_price_dict: Dict[str, int]) -> Dict:
    """Concrete initial account states (reference solver.py:166-182)."""
    accounts = {}
    for address, account in initial_accounts.items():
        address_str = f"0x{address:040x}" if isinstance(address, int) else str(address)
        data: Dict = {"nonce": account.nonce, "code": account.serialised_code, "storage": {}}
        data["balance"] = hex(min_price_dict.get(address_str, 0))
        accounts[address_str] = data
    return {"accounts": accounts}


def _get_concrete_transaction(model: Model, transaction: BaseTransaction) -> Dict:
    """Reify one transaction's concrete inputs (reference solver.py:184-213)."""
    caller = f"0x{int(model.eval(transaction.caller)):040x}"
    value = hex(int(model.eval(transaction.call_value)))
    if isinstance(transaction, ContractCreationTransaction):
        address = ""
        # deployment input = creation bytecode || ABI-encoded constructor
        # arguments: the constructor reads them from the tail of the init
        # input, so a creation step without the model's calldata suffix is
        # not replayable (reference solver.py:195-198 emits both; calldata
        # size is minimized, so argument-less constructors append nothing)
        input_ = (
            transaction.code.bytecode.hex()
            + bytes(transaction.call_data.concrete(model)).hex()
        )
    else:
        address = f"0x{int(model.eval(transaction.callee_account.address)):040x}"
        input_ = bytes(transaction.call_data.concrete(model)).hex()
    return {
        "address": address,
        "calldata": "0x" + input_,
        "input": "0x" + input_,
        "name": "unknown",
        "origin": caller,
        "value": value,
    }


def _set_minimisation_constraints(
    transaction_sequence, constraints: Constraints, minimize: List, max_size: int, world_state
):
    """Add sanity bounds + minimization targets (reference solver.py:216-256)."""
    for transaction in transaction_sequence:
        # reasonable calldata size bound
        constraints.append(
            ULE(transaction.call_data.calldatasize, symbol_factory.BitVecVal(max_size, 256))
        )
        # no caller pays more than ~10 ETH (keeps models human-readable)
        constraints.append(
            ULE(transaction.call_value, symbol_factory.BitVecVal(10**19, 256))
        )
        minimize.append(transaction.call_data.calldatasize)
        minimize.append(transaction.call_value)
    return constraints, tuple(minimize)
