"""Minimal JSON-RPC client for chain reads (geth/Infura compatible).

Reference parity: mythril/ethereum/interface/rpc/client.py:30+ — eth_getCode,
eth_getStorageAt, eth_getBalance, eth_getTransactionByHash &c.  Network access
is gated: in a zero-egress environment every call raises RPCError, which the
DynLoader treats as "unknown account".
"""

from __future__ import annotations

import json
from typing import Optional
from urllib import request as _urlreq


class RPCError(Exception):
    pass


class EthJsonRpc:
    def __init__(self, host: str = "localhost", port: int = 8545, tls: bool = False):
        self.host = host
        self.port = port
        self.tls = tls
        self._id = 0

    @property
    def endpoint(self) -> str:
        scheme = "https" if self.tls else "http"
        if self.host.startswith("http"):
            return self.host
        return f"{scheme}://{self.host}:{self.port}"

    def _call(self, method: str, params=None):
        self._id += 1
        payload = {
            "jsonrpc": "2.0",
            "method": method,
            "params": params or [],
            "id": self._id,
        }
        req = _urlreq.Request(
            self.endpoint,
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
        try:
            with _urlreq.urlopen(req, timeout=10) as resp:
                data = json.loads(resp.read())
        except Exception as e:  # noqa: BLE001 - every transport failure is an RPCError
            raise RPCError(f"RPC request to {self.endpoint} failed: {e}") from e
        if "error" in data and data["error"]:
            raise RPCError(str(data["error"]))
        return data.get("result")

    def eth_getCode(self, address: str, default_block: str = "latest") -> str:
        return self._call("eth_getCode", [address, default_block])

    def eth_getStorageAt(
        self, address: str, position: int, default_block: str = "latest"
    ) -> str:
        return self._call("eth_getStorageAt", [address, hex(position), default_block])

    def _call_int(self, method: str, params=None) -> int:
        result = self._call(method, params)
        return int(result, 16) if result else 0

    def eth_getBalance(self, address: str, default_block: str = "latest") -> int:
        return self._call_int("eth_getBalance", [address, default_block])

    def eth_getTransactionByHash(self, tx_hash: str):
        return self._call("eth_getTransactionByHash", [tx_hash])

    def eth_getTransactionReceipt(self, tx_hash: str):
        return self._call("eth_getTransactionReceipt", [tx_hash])

    def eth_blockNumber(self) -> int:
        return int(self._call("eth_blockNumber"), 16)

    def eth_coinbase(self) -> str:
        return self._call("eth_coinbase")

    def eth_getBlockByNumber(self, block="latest", tx_objects: bool = True):
        if isinstance(block, int):
            block = hex(block)
        return self._call("eth_getBlockByNumber", [block, tx_objects])

    def eth_getTransactionCount(self, address: str, default_block: str = "latest") -> int:
        return self._call_int("eth_getTransactionCount", [address, default_block])

    def eth_call(self, to: str, data: str, default_block: str = "latest") -> str:
        return self._call("eth_call", [{"to": to, "data": data}, default_block])

    def close(self) -> None:
        """API parity with the reference client; urllib holds no connection."""
