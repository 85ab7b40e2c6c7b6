"""DynLoader: cached mid-execution on-chain reads.

Reference parity: mythril/support/loader.py:15-102 — lru-cached read_storage /
read_balance / dynld code fetch, backed by the JSON-RPC client.
"""

from __future__ import annotations

import functools
import logging
from typing import Optional

from mythril_tpu_torch.frontend.rpc import EthJsonRpc, RPCError

log = logging.getLogger(__name__)


class DynLoader:
    def __init__(self, eth: Optional[EthJsonRpc], active: bool = True):
        self.eth = eth
        self.active = active and eth is not None

    @functools.lru_cache(2**10)
    def read_storage(self, contract_address: str, index: int) -> str:
        if not self.active:
            raise ValueError("dynamic loader is deactivated")
        value = self.eth.eth_getStorageAt(contract_address, index)
        return value

    @functools.lru_cache(2**10)
    def read_balance(self, address: str) -> str:
        if not self.active:
            raise ValueError("dynamic loader is deactivated")
        return hex(self.eth.eth_getBalance(address))

    @functools.lru_cache(2**10)
    def dynld(self, dependency_address: str):
        """Fetch and disassemble code at ``dependency_address``; None if EOA."""
        if not self.active:
            return None
        log.debug("dynld at contract %s", dependency_address)
        try:
            code = self.eth.eth_getCode(dependency_address)
        except RPCError as e:
            log.debug("dynld failed: %s", e)
            return None
        if not code or code == "0x":
            return None
        from mythril_tpu_torch.frontend.disassembler import Disassembly

        return Disassembly(code)
