"""Interactive HTML call-graph export (vis.js-style single-file report).

Reference parity: mythril/analysis/callgraph.py + templates/callgraph.html —
rendered with an inline template (no external assets; the vis.js payload is
loaded from a CDN tag so the file remains standalone-readable offline as a
plain node/edge listing).
"""

from __future__ import annotations

import json
import re

_TEMPLATE = """<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8">
<title>Call Graph</title>
<script src="https://cdnjs.cloudflare.com/ajax/libs/vis/4.21.0/vis.min.js"></script>
<link href="https://cdnjs.cloudflare.com/ajax/libs/vis/4.21.0/vis.min.css" rel="stylesheet" type="text/css">
<style type="text/css">
  body, html { margin: 0; height: 100%; background: #1a1a1a; color: #e0e0e0; }
  #mynetwork { width: 100%; height: 100%; }
</style>
</head>
<body>
<div id="mynetwork"></div>
<script>
  var nodes = new vis.DataSet(__NODES__);
  var edges = new vis.DataSet(__EDGES__);
  var container = document.getElementById("mynetwork");
  var data = { nodes: nodes, edges: edges };
  var options = {
    physics: { enabled: __PHYSICS__ },
    layout: { improvedLayout: true },
    nodes: { shape: "box", font: { face: "monospace", color: "#e0e0e0", size: 11 },
             color: { background: "#26262d", border: "#9e42b3" } },
    edges: { font: { color: "#aaaaaa", size: 9 }, arrows: "to", color: "#555" }
  };
  var network = new vis.Network(container, data, options);
</script>
</body>
</html>
"""


def _node_label(node, max_lines: int = 25) -> str:
    lines = [f"{node.function_name} (uid {node.uid})"]
    for state in node.states[:max_lines]:
        instr = state.get_current_instruction()
        arg = f" {instr.get('argument', '')}" if instr.get("argument") else ""
        lines.append(f"{instr['address']} {instr['opcode']}{arg}")
    if len(node.states) > max_lines:
        lines.append("...")
    return "\n".join(lines)


def generate_graph(statespace, physics: bool = False, phrackify: bool = False) -> str:
    """Render the statespace's nodes/edges into the HTML template."""
    nodes = [
        {"id": str(node.uid), "label": _node_label(node), "size": 150}
        for node in statespace.nodes.values()
    ]
    edges = []
    for edge in statespace.edges:
        label = ""
        if edge.condition is not None:
            label = re.sub(r"\s+", " ", repr(edge.condition))[:100]
        edges.append(
            {
                "from": str(edge.node_from),
                "to": str(edge.node_to),
                "label": label,
                "arrows": "to",
            }
        )
    html = _TEMPLATE.replace("__NODES__", json.dumps(nodes))
    html = html.replace("__EDGES__", json.dumps(edges))
    html = html.replace("__PHYSICS__", "true" if physics else "false")
    return html
