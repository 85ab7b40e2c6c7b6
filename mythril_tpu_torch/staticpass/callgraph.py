"""Cross-contract static call graph over every loaded code object.

Each analyzed contract registers its code hash, on-chain address (when
known) and per-function summaries; edges are drawn wherever a call
site's constant-folded target address matches another registered
contract.  Unresolved targets stay as dangling edges (callee ``None``)
so multi-contract scenario tooling can see "this contract calls out,
we don't know where" as a fact distinct from "no external calls".

The graph is process-wide observe-only state (like the report views in
:mod:`report`): nothing prunes or gates on it, it feeds `myth static`,
``meta.staticpass`` and the ROADMAP's multi-contract scenario work.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional


def _norm_address(address) -> Optional[int]:
    """Contract address as an int, or None when symbolic/unknown."""
    if address is None:
        return None
    if isinstance(address, int):
        return address
    try:
        s = str(address).strip()
        return int(s, 16) if s.lower().startswith("0x") else int(s)
    except (ValueError, TypeError):
        return None


class StaticCallGraph:
    """Registry of code objects + resolved constant-target call edges."""

    def __init__(self):
        self._lock = threading.Lock()
        self._nodes: Dict[str, dict] = {}  # code_hash -> node dict
        self._by_address: Dict[int, str] = {}  # address -> code_hash

    def register(self, code_hash: str, name: str = "?",
                 address=None, function_map=None) -> None:
        addr = _norm_address(address)
        with self._lock:
            node = self._nodes.setdefault(code_hash, {
                "code_hash": code_hash,
                "name": name,
                "address": None,
                "calls": [],  # raw call sites, resolved lazily in edges()
            })
            if name != "?" and node["name"] in ("?", ""):
                node["name"] = name
            if addr is not None:
                node["address"] = f"0x{addr:040x}"
                self._by_address[addr] = code_hash
            if function_map is not None:
                calls = []
                for fn in function_map.functions:
                    for c in fn.calls:
                        calls.append({
                            "function": fn.name,
                            "selector": (
                                f"0x{fn.selector:08x}"
                                if fn.selector is not None else None
                            ),
                            "addr": c.addr,
                            "opcode": c.opcode,
                            "to": list(c.to) if c.to is not None else None,
                            "value": list(c.value) if c.value is not None else None,
                        })
                node["calls"] = calls

    def edges(self) -> List[dict]:
        """One edge per (call site, constant target); targets that match
        a registered address resolve to that callee's code hash."""
        with self._lock:
            out: List[dict] = []
            for ch, node in self._nodes.items():
                for c in node["calls"]:
                    targets = c["to"] if c["to"] is not None else [None]
                    for tgt in targets:
                        out.append({
                            "caller": ch,
                            "caller_function": c["function"],
                            "caller_selector": c["selector"],
                            "site_addr": c["addr"],
                            "opcode": c["opcode"],
                            "target_address": (
                                f"0x{tgt:040x}" if tgt is not None else None
                            ),
                            "callee": self._by_address.get(tgt),
                        })
            return out

    def to_dict(self) -> dict:
        edges = self.edges()
        with self._lock:
            nodes = [
                {
                    "code_hash": n["code_hash"],
                    "name": n["name"],
                    "address": n["address"],
                    "n_call_sites": len(n["calls"]),
                }
                for n in self._nodes.values()
            ]
        return {
            "nodes": nodes,
            "edges": edges,
            "resolved_edges": sum(1 for e in edges if e["callee"] is not None),
        }

    def reset(self) -> None:
        with self._lock:
            self._nodes.clear()
            self._by_address.clear()


_GRAPH = StaticCallGraph()


def get_callgraph() -> StaticCallGraph:
    return _GRAPH
