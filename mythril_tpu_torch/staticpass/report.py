"""JSON export of the static pass (--staticpass-report, meta.staticpass).

Blocks and edges are serialized through the same ``core/cfg.py``
Node/Edge structures the dynamic engine uses, so downstream tooling
consumes one CFG schema for both.  The interprocedural layer adds the
recovered function table, the per-JUMPI reachable-edge oracle numbers,
the ranked interesting points and the cross-contract call graph.
"""

from __future__ import annotations

import json
from typing import List

from mythril_tpu_torch.core.cfg import Edge, JumpType, Node
from mythril_tpu_torch.staticpass.summary import StaticSummary

# unresolved-jump fans (edges to every JUMPDEST) can be quadratic; the
# JSON export caps them and says so rather than ballooning the artifact
_MAX_EDGES = 4096
_META_POINTS_CAP = 16  # interesting points surfaced in report meta

_EDGE_TYPE = {
    "jump": JumpType.UNCONDITIONAL,
    "fall": JumpType.CONDITIONAL,
    "dyn": JumpType.UNCONDITIONAL,
}

_VIEWS: List = []  # GateView per analyzed contract, in analysis order


def record_view(view) -> None:
    _VIEWS.append(view)


def reset_views() -> None:
    del _VIEWS[:]


def function_to_dict(fn) -> dict:
    """One recovered function (functions.StaticFunction) as JSON."""
    return {
        "selector": f"0x{fn.selector:08x}" if fn.selector is not None else None,
        "name": fn.name,
        "entry_addr": fn.entry_addr,
        "n_blocks": fn.n_blocks,
        "storage_reads": list(fn.storage_reads),
        "storage_writes": list(fn.storage_writes),
        "reads_unknown": fn.reads_unknown,
        "writes_unknown": fn.writes_unknown,
        "calls": [
            {
                "addr": c.addr,
                "opcode": c.opcode,
                "to": list(c.to) if c.to is not None else None,
                "value": list(c.value) if c.value is not None else None,
                "unchecked": c.unchecked,
            }
            for c in fn.calls
        ],
        "caller_guarded": fn.caller_guarded,
        "selfdestruct": fn.has_selfdestruct,
        "delegatecall": fn.has_delegatecall,
        "writes_after_call": fn.writes_after_call,
    }


def summary_to_dict(summary: StaticSummary) -> dict:
    from mythril_tpu_torch.frontier import taint

    nodes = []
    for b in range(summary.n_blocks):
        node = Node(
            contract_name="static",
            start_addr=int(summary.block_addrs[b]),
            function_name=f"block_{b}",
        )
        d = node.get_dict()
        d["reachable"] = bool(summary.instr_reachable[summary.block_starts[b]])
        nodes.append(d)
    edges = []
    for frm, to, kind in summary.edges[:_MAX_EDGES]:
        e = Edge(frm, to, edge_type=_EDGE_TYPE.get(kind, JumpType.UNCONDITIONAL))
        d = e.as_dict()
        d["kind"] = kind
        edges.append(d)
    bit_names = {bit: name for bit, name in taint.SOURCE_OPCODES.items()}
    fmap = summary.function_map
    return {
        "is_creation": summary.is_creation,
        "code_size": summary.code_size,
        "instructions": summary.n_instructions,
        "blocks": summary.n_blocks,
        "reachable_blocks": summary.n_reachable_blocks,
        "jumps_resolved": summary.n_resolved_jumps,
        "underflow_blocks": summary.underflow_blocks,
        "unreachable_bytes": summary.unreachable_bytes,
        "unreachable_spans": [list(s) for s in summary.unreachable_spans],
        "nodes": nodes,
        "edges": edges,
        "edges_truncated": len(summary.edges) > _MAX_EDGES,
        "may_reach": {
            f"{bit_names.get(bit, bit)}": sorted(ops)
            for bit, ops in sorted(summary.may_reach.items())
        },
        "escalated_sources": sorted(
            bit_names.get(bit, str(bit)) for bit in summary.escalated_bits
        ),
        "interproc": summary.interproc_ok,
        "reachability": {
            "instructions": summary.n_instructions,
            "instructions_reachable": int(summary.instr_reachable.sum()),
            "edges_total": summary.n_edges_total,
            "edges_reachable": summary.n_edges_live,
            "reachable_edge_pct": round(summary.reachable_edge_pct, 3),
        },
        "dispatch": {
            "recovered": bool(fmap.dispatch_recovered) if fmap else False,
            "fallback_addr": fmap.fallback_addr if fmap else None,
        },
        "functions": [function_to_dict(f) for f in fmap.functions] if fmap else [],
        "interesting_points": [dict(p) for p in summary.interesting_points],
        "wall_s": round(summary.wall_s, 6),
    }


def report_dict() -> dict:
    """Everything recorded since process start, one entry per contract."""
    from mythril_tpu_torch.staticpass.callgraph import get_callgraph

    return {
        "contracts": [
            {
                "name": view.contract_name,
                "modules_skipped": view.skipped_modules,
                "codes": [summary_to_dict(s) for s in view.summaries],
            }
            for view in _VIEWS
        ],
        "callgraph": get_callgraph().to_dict(),
    }


def staticpass_meta() -> dict:
    """Compact block for the jsonv2 report ``meta.staticpass``: gate
    state, recovered-function counts, the reachable-edge oracle numbers,
    and the top ranked interesting points."""
    from mythril_tpu_torch.observability import get_registry
    from mythril_tpu_torch.staticpass.callgraph import get_callgraph

    disabled = dict(get_registry().labeled_counter(
        "staticpass.gate_disabled", label_name="reason"
    ).snapshot())

    edges_live = edges_total = 0
    functions = 0
    points: List[dict] = []
    interproc_ok = False
    for view in _VIEWS:
        for s in view.summaries:
            edges_live += s.n_edges_live
            edges_total += s.n_edges_total
            interproc_ok = interproc_ok or s.interproc_ok
            if s.function_map is not None:
                functions += len(s.function_map.functions)
            points.extend(dict(p) for p in s.interesting_points)
    points.sort(key=lambda p: -p["score"])
    cg = get_callgraph().to_dict()
    return {
        "contracts": len(_VIEWS),
        "modules_skipped": sorted({
            m for view in _VIEWS for m in view.skipped_modules
        }),
        "gate_disabled": disabled,
        "interproc": interproc_ok,
        "functions_recovered": functions,
        "edges_total": edges_total,
        "edges_reachable": edges_live,
        "reachable_edge_pct": (
            round(100.0 * edges_live / edges_total, 3) if edges_total else 100.0
        ),
        "interesting_points": points[:_META_POINTS_CAP],
        "callgraph": {
            "nodes": len(cg["nodes"]),
            "edges": len(cg["edges"]),
            "resolved_edges": cg["resolved_edges"],
        },
    }


def export_report(path: str) -> None:
    with open(path, "w") as f:
        json.dump(report_dict(), f, indent=2, sort_keys=True)
