"""World state: accounts, shared balance array, path constraints, tx history.

Reference parity: mythril/laser/ethereum/state/world_state.py:17-229 — the
global ``balances`` SMT array (:33), auto-creating account lookup (:45-56),
lazy on-chain account loading (:76), deterministic new-address generation (:208).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from mythril_tpu_torch.core.state.account import Account
from mythril_tpu_torch.core.state.annotation import StateAnnotation
from mythril_tpu_torch.core.state.constraints import Constraints
from mythril_tpu_torch.smt import Array, BitVec, symbol_factory


class WorldState:
    next_address_seed = 0x6B6579

    def __init__(self, transaction_sequence=None, annotations=None):
        self.balances = Array("balance", 256, 256)
        self.starting_balances = Array("balance", 256, 256)
        self.accounts: Dict[int, Account] = {}
        self._default_accounts: Dict = {}
        self.node = None  # CFG node of the tx that produced this state
        self.constraints = Constraints()
        self.transaction_sequence: List = list(transaction_sequence or [])
        self._annotations: List[StateAnnotation] = list(annotations or [])

    @property
    def annotations(self) -> List[StateAnnotation]:
        return self._annotations

    def annotate(self, annotation: StateAnnotation) -> None:
        self._annotations.append(annotation)

    def get_annotations(self, annotation_type: type) -> List:
        return [a for a in self._annotations if isinstance(a, annotation_type)]

    def __getitem__(self, item: BitVec) -> Account:
        """Account lookup by address; auto-creates an empty account."""
        if isinstance(item, int):
            item = symbol_factory.BitVecVal(item, 256)
        key = item.value
        if key is None:
            # symbolic address: create (or reuse) a tracked symbolic account
            tid = item.raw.tid
            if tid not in self._default_accounts:
                acct = Account(item, balances=self.balances)
                self._default_accounts[tid] = acct
            return self._default_accounts[tid]
        acct = self.accounts.get(key)
        if acct is None:
            acct = self.create_account(address=key)
        return acct

    def accounts_exist_or_load(self, address, dynamic_loader=None) -> Account:
        """Return the account; lazily fetch code via the loader if unknown."""
        if isinstance(address, str):
            address = int(address, 16)
        if isinstance(address, int):
            addr_val = address
        else:
            addr_val = address.value
        if addr_val is not None and addr_val in self.accounts:
            return self.accounts[addr_val]
        code = None
        if dynamic_loader is not None and getattr(dynamic_loader, "active", False) and addr_val:
            from mythril_tpu_torch.frontend.disassembler import Disassembly

            fetched = dynamic_loader.dynld(f"0x{addr_val:040x}")
            if fetched:
                code = fetched
        return self.create_account(address=addr_val, code=code)

    def create_account(
        self,
        balance=0,
        address: Optional[int] = None,
        concrete_storage: bool = False,
        dynamic_loader=None,
        creator=None,
        code=None,
        nonce: int = 0,
    ) -> Account:
        if address is None:
            address = self._generate_new_address()
        account = Account(
            address,
            code=code,
            balances=self.balances,
            concrete_storage=concrete_storage,
            dynamic_loader=dynamic_loader,
            nonce=nonce,
        )
        if creator is not None:
            account.creator = creator
        self.put_account(account)
        if isinstance(balance, int) and balance != 0:
            account.add_balance(symbol_factory.BitVecVal(balance, 256))
        elif not isinstance(balance, int):
            account.add_balance(balance)
        return account

    def put_account(self, account: Account) -> None:
        assert account.address.value is not None
        self.accounts[account.address.value] = account
        account.set_balances(self.balances)

    def _generate_new_address(self) -> int:
        """Deterministic fresh address (reference world_state.py:208)."""
        WorldState.next_address_seed += 1
        from mythril_tpu_torch.ops.keccak import keccak256

        h = keccak256(WorldState.next_address_seed.to_bytes(8, "big"))
        return int.from_bytes(h[12:], "big")

    def __copy__(self) -> "WorldState":
        import copy as _copy

        out = WorldState.__new__(WorldState)
        # fork the balance array reference (functional: stores create new terms)
        balances = Array.__new__(Array)
        balances.raw = self.balances.raw
        balances.domain, balances.range = 256, 256
        out.balances = balances
        out.starting_balances = self.starting_balances
        out.accounts = {}
        out._default_accounts = dict(self._default_accounts)
        out.node = self.node
        out.constraints = self.constraints.copy()
        out.transaction_sequence = list(self.transaction_sequence)
        out._annotations = [
            _copy.copy(a) for a in self._annotations
        ]
        for addr, acct in self.accounts.items():
            cloned = _copy.copy(acct)
            cloned.set_balances(out.balances)
            out.accounts[addr] = cloned
        return out
