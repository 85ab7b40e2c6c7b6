"""Accounts and storage.

Reference parity: mythril/laser/ethereum/state/account.py (Storage :18-99 with
symbolic-array/concrete-K split + lazy on-chain loads, Account :101-223).
"""

from __future__ import annotations

from typing import Dict, Optional

from mythril_tpu_torch.smt import Array, BitVec, K, symbol_factory
from mythril_tpu_torch.support.support_args import args


class Storage:
    """Contract storage: an SMT array plus bookkeeping for reports/pruners.

    ``concrete=True`` (creation txs) starts from an all-zero K array;
    otherwise a named symbolic array (unknown pre-state).  ``printable_storage``
    mirrors writes/reads for report rendering; ``storage_keys_loaded`` guards
    repeated on-chain loads via the dynamic loader.
    """

    def __init__(self, concrete: bool = False, address: Optional[BitVec] = None, dynamic_loader=None):
        self.concrete = concrete and not args.unconstrained_storage
        self.address = address
        self.dynld = dynamic_loader
        addr_tag = (
            hex(address.value) if address is not None and address.value is not None else "sym"
        )
        if self.concrete:
            self._array = K(256, 256, 0)
        else:
            self._array = Array(f"Storage[{addr_tag}]", 256, 256)
        self.printable_storage: Dict[BitVec, BitVec] = {}
        self.storage_keys_loaded: set = set()

    def __getitem__(self, item: BitVec) -> BitVec:
        if (
            self.dynld is not None
            and getattr(self.dynld, "active", False)
            and item.value is not None
            and item.value not in self.storage_keys_loaded
            and self.address is not None
            and self.address.value
        ):
            try:
                value = int(
                    self.dynld.read_storage(f"0x{self.address.value:040x}", item.value), 16
                )
                self.storage_keys_loaded.add(item.value)
                self[item] = symbol_factory.BitVecVal(value, 256)
            except ValueError:
                pass
        return self._array[item]

    def __setitem__(self, key: BitVec, value) -> None:
        if isinstance(value, int):
            value = symbol_factory.BitVecVal(value, 256)
        self.printable_storage[key] = value
        self._array[key] = value

    def __copy__(self) -> "Storage":
        out = Storage.__new__(Storage)
        out.concrete = self.concrete
        out.address = self.address
        out.dynld = self.dynld
        if isinstance(self._array, Array):
            cloned = Array.__new__(Array)
            cloned.raw = self._array.raw
            cloned.domain = self._array.domain
            cloned.range = self._array.range
        else:
            cloned = K.__new__(K)
            cloned.raw = self._array.raw
            cloned.domain = self._array.domain
            cloned.range = self._array.range
        out._array = cloned
        out.printable_storage = dict(self.printable_storage)
        out.storage_keys_loaded = set(self.storage_keys_loaded)
        return out


class Account:
    """An on-chain account: code, nonce, balance closure, storage."""

    def __init__(
        self,
        address,
        code=None,
        contract_name: Optional[str] = None,
        balances: Optional[Array] = None,
        concrete_storage: bool = False,
        dynamic_loader=None,
        nonce: int = 0,
    ):
        if isinstance(address, int):
            address = symbol_factory.BitVecVal(address, 256)
        elif isinstance(address, str):
            address = symbol_factory.BitVecVal(int(address, 16), 256)
        self.address = address
        self.code = code  # Disassembly (may be None for EOA)
        self.contract_name = contract_name or "Unknown"
        self.nonce = nonce
        self.deleted = False
        self.storage = Storage(
            concrete=concrete_storage, address=address, dynamic_loader=dynamic_loader
        )
        # balance reads/writes go through the world state's shared array
        self._balances = balances

    def set_balance(self, balance) -> None:
        if isinstance(balance, int):
            balance = symbol_factory.BitVecVal(balance, 256)
        assert self._balances is not None
        self._balances[self.address] = balance

    def add_balance(self, balance) -> None:
        assert self._balances is not None
        self._balances[self.address] = self._balances[self.address] + balance

    @property
    def balance(self):
        return lambda: self._balances[self.address]

    def set_balances(self, balances: Array) -> None:
        self._balances = balances

    @property
    def serialised_code(self) -> str:
        if self.code is None:
            return ""
        return "0x" + self.code.bytecode.hex()

    def as_dict(self) -> Dict:
        return {
            "nonce": self.nonce,
            "code": self.serialised_code,
            "balance": repr(self.balance()),
            "storage": {repr(k): repr(v) for k, v in self.storage.printable_storage.items()},
        }

    def __copy__(self) -> "Account":
        import copy as _copy

        out = Account.__new__(Account)
        out.address = self.address
        out.code = self.code  # immutable Disassembly shared
        out.contract_name = self.contract_name
        out.nonce = self.nonce
        out.deleted = self.deleted
        out.storage = _copy.copy(self.storage)
        out._balances = self._balances
        return out

    def __str__(self):
        return f"Account(address={self.address}, name={self.contract_name})"
