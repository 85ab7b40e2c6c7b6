"""Frontier checkpoint/resume between transactions.

The reference has no checkpoint/restart (SURVEY.md §5.4) — its closest
analogue is the ``open_states`` world-state snapshot list carried between
transactions (reference svm.py:306-315).  This module makes that snapshot
durable: after each symbolic transaction the surviving open world states are
serialized (accounts, storage/balance term DAGs, path constraints, and the
transaction records exploit reporting needs) so an interrupted multi-
transaction analysis resumes at the last completed transaction boundary
instead of restarting.  The same format is the DCN shipping unit for
multi-host corpus sharding.

Scope notes: state annotations (pruner bookkeeping) are intentionally NOT
persisted — they are performance hints, and resuming without them is sound
(pruners rebuild their caches); dynamic-loader bindings are re-attached by
the resuming process.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

from mythril_tpu_torch.smt import Array, Bool, symbol_factory
from mythril_tpu_torch.smt.serialize import dump_terms, load_terms

FORMAT_VERSION = 1


# ---------------------------------------------------------------------------
# World-state <-> dict
# ---------------------------------------------------------------------------


def _dump_world_state(ws) -> dict:
    """Collect every term the state depends on into ONE dump (shared DAG)."""
    roots = [ws.balances.raw, ws.starting_balances.raw]
    constraint_base = len(roots)
    roots.extend(c.raw if hasattr(c, "raw") else c for c in ws.constraints)

    accounts = []
    for addr, acct in ws.accounts.items():
        accounts.append(
            {
                "address": addr,
                "nonce": acct.nonce,
                "contract_name": acct.contract_name,
                "code": acct.code.bytecode.hex() if acct.code is not None else None,
                "storage_concrete": acct.storage.concrete,
                "storage_root": len(roots),
            }
        )
        roots.append(acct.storage._array.raw)

    txs = []
    for tx in ws.transaction_sequence:
        txs.append(_dump_transaction(tx, roots))

    return {
        "terms": dump_terms(roots),
        "n_constraints": len(ws.constraints),
        "constraint_base": constraint_base,
        "accounts": accounts,
        "transactions": txs,
    }


def _dump_transaction(tx, roots: List) -> dict:
    from mythril_tpu_torch.core.state.calldata import ConcreteCalldata
    from mythril_tpu_torch.core.transaction.transaction_models import (
        ContractCreationTransaction,
    )

    def term_ref(wrapped) -> int:
        roots.append(wrapped.raw if hasattr(wrapped, "raw") else wrapped)
        return len(roots) - 1

    record = {
        "kind": (
            "creation" if isinstance(tx, ContractCreationTransaction) else "call"
        ),
        "id": tx.id,
        "gas_limit": tx.gas_limit if isinstance(tx.gas_limit, int) else None,
        "origin": term_ref(tx.origin),
        "caller": term_ref(tx.caller),
        "gas_price": term_ref(tx.gas_price),
        "call_value": term_ref(tx.call_value),
        "static": tx.static,
        "callee_address": (
            tx.callee_account.address.value
            if tx.callee_account is not None
            and tx.callee_account.address.value is not None
            else None
        ),
        "code": tx.code.bytecode.hex() if getattr(tx, "code", None) else None,
    }
    if isinstance(tx.call_data, ConcreteCalldata):
        record["calldata"] = list(tx.call_data.concrete(None))
    else:
        record["calldata"] = None  # symbolic: rebuilt from the tx id
    return record


def _load_world_state(data: dict, dynamic_loader=None):
    from mythril_tpu_torch.core.state.account import Account, Storage
    from mythril_tpu_torch.core.state.world_state import WorldState

    roots = load_terms(data["terms"])
    ws = WorldState()
    ws.balances.raw = roots[0]
    ws.starting_balances.raw = roots[1]
    base = data["constraint_base"]
    for i in range(data["n_constraints"]):
        ws.constraints.append(Bool(roots[base + i]))

    from mythril_tpu_torch.frontend.disassembler import Disassembly

    for rec in data["accounts"]:
        acct = Account(
            rec["address"],
            code=Disassembly(rec["code"]) if rec["code"] else None,
            contract_name=rec["contract_name"],
            balances=ws.balances,
            concrete_storage=False,
            dynamic_loader=dynamic_loader,
            nonce=rec["nonce"],
        )
        acct.storage.concrete = rec["storage_concrete"]
        acct.storage._array.raw = roots[rec["storage_root"]]
        ws.put_account(acct)

    ws.transaction_sequence = [
        _load_transaction(rec, ws, roots) for rec in data["transactions"]
    ]
    return ws


def _load_transaction(rec: dict, ws, roots):
    from mythril_tpu_torch.core.state.calldata import ConcreteCalldata, SymbolicCalldata
    from mythril_tpu_torch.core.transaction.transaction_models import (
        ContractCreationTransaction,
        MessageCallTransaction,
        tx_id_manager,
    )

    tx_id_manager.ensure_above(rec["id"])
    from mythril_tpu_torch.frontend.disassembler import Disassembly
    from mythril_tpu_torch.smt import BitVec

    def term_at(i: int) -> BitVec:
        return BitVec(roots[i])

    callee = ws[rec["callee_address"]] if rec["callee_address"] is not None else None
    calldata = (
        ConcreteCalldata(rec["id"], rec["calldata"])
        if rec["calldata"] is not None
        else SymbolicCalldata(rec["id"])
    )
    cls = (
        ContractCreationTransaction if rec["kind"] == "creation" else MessageCallTransaction
    )
    tx = cls.__new__(cls)
    tx.world_state = ws
    tx.id = rec["id"]
    tx.gas_limit = rec["gas_limit"] if rec["gas_limit"] is not None else 8_000_000
    tx.origin = term_at(rec["origin"])
    tx.caller = term_at(rec["caller"])
    tx.gas_price = term_at(rec["gas_price"])
    tx.base_fee = symbol_factory.BitVecSym(f"{tx.id}_basefee", 256)
    tx.call_value = term_at(rec["call_value"])
    tx.static = rec["static"]
    tx.callee_account = callee
    tx.call_data = calldata
    tx.code = Disassembly(rec["code"]) if rec["code"] else None
    tx.return_data = None
    if rec["kind"] == "creation":
        # exploit reporting reconstructs the pre-state from here
        # (analysis/solver.py); the initial creation's pre-state is empty
        from mythril_tpu_torch.core.state.world_state import WorldState

        tx.prev_world_state = WorldState()
    return tx


# ---------------------------------------------------------------------------
# Checkpoint files
# ---------------------------------------------------------------------------


def save_checkpoint(
    path: str,
    completed_transactions: int,
    open_states: List,
    target_address: Optional[int] = None,
    shard: int = 0,
) -> None:
    """Atomically write one frontier snapshot."""
    payload = {
        "version": FORMAT_VERSION,
        "shard": shard,
        "completed_transactions": completed_transactions,
        "target_address": target_address,
        "open_states": [_dump_world_state(ws) for ws in open_states],
    }
    tmp = f"{path}.tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "w") as fh:
        json.dump(payload, fh)
    os.replace(tmp, path)


def load_checkpoint(
    path: str, dynamic_loader=None
) -> Tuple[int, List, Optional[int]]:
    """Read a snapshot -> (completed txs, open world states, target addr)."""
    with open(path) as fh:
        payload = json.load(fh)
    if payload.get("version") != FORMAT_VERSION:
        raise ValueError(
            f"unsupported checkpoint version {payload.get('version')}"
        )
    states = [
        _load_world_state(d, dynamic_loader) for d in payload["open_states"]
    ]
    return payload["completed_transactions"], states, payload.get("target_address")
