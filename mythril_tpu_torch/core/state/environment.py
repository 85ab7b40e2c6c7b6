"""Call-frame environment (reference parity: laser/ethereum/state/environment.py:12-82)."""

from __future__ import annotations

from typing import Optional

from mythril_tpu_torch.core.state.account import Account
from mythril_tpu_torch.core.state.calldata import BaseCalldata
from mythril_tpu_torch.smt import BitVec, symbol_factory


class Environment:
    def __init__(
        self,
        active_account: Account,
        sender: BitVec,
        calldata: BaseCalldata,
        gasprice: BitVec,
        callvalue: BitVec,
        origin: BitVec,
        code=None,
        basefee: Optional[BitVec] = None,
        static: bool = False,
    ):
        self.active_account = active_account
        self.address = active_account.address
        self.sender = sender
        self.calldata = calldata
        self.gasprice = gasprice
        self.callvalue = callvalue
        self.origin = origin
        self.basefee = (
            basefee if basefee is not None else symbol_factory.BitVecSym("basefee", 256)
        )
        self.code = code if code is not None else active_account.code
        self.static = static
        # fresh per-environment symbols (reference environment.py:47-48)
        self.block_number = symbol_factory.BitVecSym("block_number", 256)
        self.chainid = symbol_factory.BitVecSym("chain_id", 256)
        # optional CONCRETE block-env overrides (None -> fresh symbols at the
        # opcode): set by the conformance/concolic drivers replaying fixtures
        # with known block parameters (VMTests ``env`` section)
        self.timestamp: Optional[BitVec] = None
        self.coinbase: Optional[BitVec] = None
        self.difficulty: Optional[BitVec] = None
        self.block_gaslimit: Optional[BitVec] = None

    def __copy__(self) -> "Environment":
        out = Environment.__new__(Environment)
        out.__dict__.update(self.__dict__)
        return out

    def __str__(self):
        return f"Environment(account={self.active_account.contract_name})"
