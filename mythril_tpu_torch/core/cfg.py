"""Control-flow-graph bookkeeping: nodes, edges, jump types.

Reference parity: mythril/laser/ethereum/cfg.py:12-116.
"""

from __future__ import annotations

from enum import Enum
from typing import Dict, List, Optional

gbl_next_uid = [0]


class JumpType(Enum):
    CONDITIONAL = 1
    UNCONDITIONAL = 2
    CALL = 3
    RETURN = 4
    Transaction = 5


class NodeFlags:
    FUNC_ENTRY = 1
    CALL_RETURN = 2


class Node:
    def __init__(self, contract_name: str, start_addr: int = 0, constraints=None, function_name: str = "unknown"):
        from mythril_tpu_torch.core.state.constraints import Constraints

        self.contract_name = contract_name
        self.start_addr = start_addr
        self.constraints = constraints if constraints is not None else Constraints()
        self.function_name = function_name
        self.flags = 0
        self.states: List = []
        gbl_next_uid[0] += 1
        self.uid = gbl_next_uid[0]

    def get_dict(self) -> Dict:
        return {
            "contract_name": self.contract_name,
            "start_addr": self.start_addr,
            "function_name": self.function_name,
            "uid": self.uid,
            "flags": self.flags,
            "num_states": len(self.states),
        }

    def __repr__(self):
        return f"<Node {self.uid} {self.function_name}@{self.start_addr}>"


class Edge:
    def __init__(
        self,
        node_from: int,
        node_to: int,
        edge_type: JumpType = JumpType.UNCONDITIONAL,
        condition=None,
    ):
        self.node_from = node_from
        self.node_to = node_to
        self.type = edge_type
        self.condition = condition

    def as_dict(self) -> Dict:
        return {"from": self.node_from, "to": self.node_to, "type": self.type.name}

    def __repr__(self):
        return f"<Edge {self.node_from} -> {self.node_to} ({self.type.name})>"
