"""Serializable statespace export for --statespace-json.

Reference parity: mythril/analysis/traceexplore.py:44-164.
"""

from __future__ import annotations

import re
from typing import Dict

colors = [
    {"border": "#26996f", "background": "#2f7e5b"},
    {"border": "#9e42b3", "background": "#842899"},
    {"border": "#b82323", "background": "#991d1d"},
    {"border": "#4753bf", "background": "#3b46a1"},
]


def get_serializable_statespace(statespace) -> Dict:
    nodes = []
    edges = []

    color_map = {}
    i = 0
    for key in statespace.nodes:
        node = statespace.nodes[key]
        code = node.contract_name
        if code not in color_map:
            color_map[code] = colors[i % len(colors)]
            i += 1

    for key in statespace.nodes:
        node = statespace.nodes[key]
        code = node.contract_name
        instructions = []
        for state in node.states:
            instr = state.get_current_instruction()
            instructions.append(
                {
                    "address": instr["address"],
                    "opcode": instr["opcode"],
                    "argument": instr.get("argument"),
                }
            )
        nodes.append(
            {
                "id": str(node.uid),
                "func": node.function_name,
                "label": f"{node.function_name} {node.uid}",
                "code": code,
                "truncated": False,
                "instructions": instructions,
                "color": color_map.get(code, colors[0]),
            }
        )

    for edge in statespace.edges:
        condition = "" if edge.condition is None else re.sub(r"\s+", " ", repr(edge.condition))
        edges.append(
            {
                "from": str(edge.node_from),
                "to": str(edge.node_to),
                "arrows": "to",
                "label": condition[:200],
                "smooth": {"type": "cubicBezier"},
            }
        )

    return {"nodes": nodes, "edges": edges}
