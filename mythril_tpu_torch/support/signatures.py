"""4-byte function-selector -> signature database.

Reference parity: mythril/support/signatures.py:15-80 — sqlite-backed, with a
built-in seed table of common signatures; the optional 4byte.directory online
lookup is gated off (zero-egress environment) but the hook is kept.  The
port's database lives in memory unless a path is given.
"""

from __future__ import annotations

import os
import sqlite3
import threading
from typing import List, Optional

from mythril_tpu_torch.ops.keccak import keccak256

_COMMON_SIGNATURES = [
    "transfer(address,uint256)",
    "transferFrom(address,address,uint256)",
    "approve(address,uint256)",
    "balanceOf(address)",
    "totalSupply()",
    "allowance(address,address)",
    "owner()",
    "name()",
    "symbol()",
    "decimals()",
    "mint(address,uint256)",
    "burn(uint256)",
    "withdraw()",
    "withdraw(uint256)",
    "deposit()",
    "kill()",
    "killbilly()",
    "selfdestruct()",
    "destroy()",
    "close()",
    "fallback()",
    "owner_changed(address)",
    "setOwner(address)",
    "transferOwnership(address)",
    "pause()",
    "unpause()",
    "batchTransfer(address[],uint256)",
    "collectAllocations()",
    "allocate(address,uint256)",
    "depositFunds()",
    "withdrawFunds(uint256)",
]


def selector_of(signature: str) -> str:
    return "0x" + keccak256(signature.encode()).hex()[:8]


class SignatureDB:
    """Thread-safe sqlite selector DB with in-memory fallback."""

    _lock = threading.RLock()
    _instance = None

    def __new__(cls, enable_online_lookup: bool = False, path: Optional[str] = None):
        with cls._lock:
            if cls._instance is None:
                inst = super().__new__(cls)
                inst._init(enable_online_lookup, path)
                cls._instance = inst
            return cls._instance

    def _init(self, enable_online_lookup: bool, path: Optional[str]):
        self.enable_online_lookup = enable_online_lookup
        self.path = path or ":memory:"
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.conn = sqlite3.connect(self.path, check_same_thread=False)
        self.conn.execute(
            "CREATE TABLE IF NOT EXISTS signatures "
            "(byte_sig VARCHAR(10), text_sig VARCHAR(255), "
            "PRIMARY KEY (byte_sig, text_sig))"
        )
        for sig in _COMMON_SIGNATURES:
            self.add(selector_of(sig), sig)
        self.conn.commit()

    def add(self, byte_sig: str, text_sig: str) -> None:
        with SignatureDB._lock:
            self.conn.execute(
                "INSERT OR IGNORE INTO signatures (byte_sig, text_sig) VALUES (?, ?)",
                (byte_sig, text_sig),
            )

    def get(self, byte_sig: str) -> List[str]:
        with SignatureDB._lock:
            rows = self.conn.execute(
                "SELECT text_sig FROM signatures WHERE byte_sig = ?", (byte_sig,)
            ).fetchall()
        return [r[0] for r in rows]

    def import_solidity_file(self, file_path: str) -> None:
        """Harvest ``function x(...)`` signatures from a .sol source file."""
        import re

        with open(file_path) as f:
            src = f.read()
        for m in re.finditer(r"function\s+(\w+)\s*\(([^)]*)\)", src):
            name, params = m.group(1), m.group(2)
            types = []
            for p in params.split(","):
                p = p.strip()
                if not p:
                    continue
                t = p.split()[0]
                t = {"uint": "uint256", "int": "int256", "byte": "bytes1"}.get(t, t)
                types.append(t)
            sig = f"{name}({','.join(types)})"
            self.add(selector_of(sig), sig)
        self.conn.commit()
