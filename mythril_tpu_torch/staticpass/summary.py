"""StaticSummary: one immutable result object per analyzed bytecode.

``summarize`` runs the static passes (CFG recovery, interprocedural
value-set refinement, abstract stack height, taint reachability,
function recovery) once over a decoded instruction stream;
``summary_for_code`` adds a process-wide cache keyed by bytecode hash so
the frontier engine, the detector gate and the CLI report all share one
computation per contract.

The interprocedural layer (:mod:`interproc`/:mod:`functions`) is
best-effort on top of the base pass: refinement that exhausts its
budget, trips the reachability-subset invariant, or throws falls back
to the base CFG (counted under ``staticpass.interproc_fallback``) —
the summary is then exactly what the intra-procedural pass produced.
"""

from __future__ import annotations

import hashlib
import logging
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from mythril_tpu_torch.staticpass.cfg import E_FALL, StaticCFG
from mythril_tpu_torch.staticpass.errors import StaticPassError, invariant
from mythril_tpu_torch.staticpass.stackheight import underflow_points
from mythril_tpu_torch.staticpass.taintflow import may_reach

log = logging.getLogger(__name__)

_CACHE: Dict[tuple, "StaticSummary"] = {}
_CACHE_CAP = 512


@dataclass(frozen=True)
class StaticSummary:
    n_instructions: int
    code_size: int
    n_blocks: int
    n_reachable_blocks: int
    block_starts: np.ndarray  # instr idx per block
    block_addrs: np.ndarray  # byte addr per block
    edges: List[Tuple[int, int, str]]  # (from_block, to_block, kind)
    instr_reachable: np.ndarray  # bool [n]
    reachable_opcodes: frozenset
    static_target: np.ndarray  # int32 [n]: resolved jump dest instr or -1
    n_resolved_jumps: int
    underflow_blocks: int
    unreachable_spans: List[Tuple[int, int]]  # [start_addr, end_addr) bytes
    unreachable_bytes: int
    may_reach: Dict[int, frozenset] = field(default_factory=dict)
    escalated_bits: frozenset = frozenset()
    is_creation: bool = False
    wall_s: float = 0.0
    # interprocedural layer (all best-effort; defaults = "layer absent")
    interproc_ok: bool = False
    edge_taken_live: Optional[np.ndarray] = None  # bool [n] at JUMPIs
    edge_fall_live: Optional[np.ndarray] = None  # bool [n] at JUMPIs
    n_jumpis: int = 0
    n_edges_total: int = 0  # 2 * |JUMPI|
    n_edges_live: int = 0
    reachable_edge_pct: float = 100.0
    function_map: Optional[object] = None  # functions.FunctionMap
    interesting_points: Tuple[dict, ...] = ()

    def taint_reach(self, bit: int) -> frozenset:
        return self.may_reach.get(bit, frozenset())


def _edge_liveness(flow, block_reach, halting):
    """Per-JUMPI taken/fall edge liveness derived from the (refined)
    successor kinds, masked by block reachability: an edge is live iff
    its JUMPI sits in a reachable non-halting block and the flow kept
    an edge of that kind."""
    t = flow.tables
    n = t.n
    taken = np.zeros(n, bool)
    fall = np.zeros(n, bool)
    for b in range(flow.n_blocks):
        last = int(flow.block_end[b]) - 1
        if not t.is_jumpi[last]:
            continue
        if not block_reach[b] or halting[b]:
            continue
        for kind in flow.succ_kind[b]:
            if kind == E_FALL:
                fall[last] = True
            else:
                taken[last] = True
    return taken, fall


def summarize(instruction_list: List, code_size: int = 0,
              is_creation: bool = False) -> StaticSummary:
    """Run the full static pass over one decoded instruction stream."""
    from mythril_tpu_torch.frontier import taint
    from mythril_tpu_torch.staticpass.tables import InstrTables
    from mythril_tpu_torch.support.support_args import args

    t0 = time.perf_counter()
    tables = InstrTables(instruction_list)
    cfg = StaticCFG(tables)

    # interprocedural value-set refinement (best-effort, only removes
    # edges; any failure keeps the sound base CFG)
    refined = None
    if getattr(args, "staticpass_interproc", True):
        from mythril_tpu_torch.staticpass.interproc import refine

        try:
            refined = refine(cfg)
            if refined is None:
                _count("staticpass.interproc_fallback")
            else:
                # soundness net: refinement must not reach blocks the
                # base over-approximation proves unreachable
                base_reach = cfg.reachable_blocks()
                ref_reach = refined.reachable_blocks()
                invariant(
                    not bool((ref_reach & ~base_reach).any()),
                    "refined reachability exceeds base over-approximation",
                )
        except StaticPassError as e:
            log.warning("interprocedural refinement dropped: %s", e)
            _count("staticpass.interproc_fallback")
            refined = None
        except Exception as e:
            log.warning("interprocedural refinement failed: %s", e)
            _count("staticpass.interproc_fallback")
            refined = None
    flow = refined if refined is not None else cfg

    under = underflow_points(flow)
    halting = under >= 0
    block_reach = flow.reachable_blocks(halting=halting)

    n = tables.n
    instr_reach = np.zeros(n, bool)
    for b in np.flatnonzero(block_reach):
        s, e = int(flow.block_start[b]), int(flow.block_end[b])
        if halting[b]:
            # the underflowing instruction itself executes (and halts);
            # everything after it in the block is dead
            instr_reach[s: int(under[b]) + 1] = True
        else:
            instr_reach[s:e] = True

    spans: List[Tuple[int, int]] = []
    unreachable_bytes = 0
    dead = np.flatnonzero(~instr_reach)
    if len(dead):
        unreachable_bytes = int(tables.width[dead].sum())
        run_start = dead[0]
        prev = dead[0]
        for i in dead[1:]:
            if i != prev + 1:
                spans.append(_span(tables, run_start, prev))
                run_start = i
            prev = i
        spans.append(_span(tables, run_start, prev))

    reach_ops = frozenset(tables.names[i] for i in np.flatnonzero(instr_reach))
    flows, escalated = may_reach(
        flow, block_reach, instr_reach, halting,
        taint.SOURCE_OPCODES, is_creation=is_creation,
    )
    # resolved targets on unreachable jumps are meaningless downstream
    static_target = np.where(instr_reach, flow.static_target, -1).astype(np.int32)

    # reachable-edge oracle: per-JUMPI edge liveness + the corrected
    # coverage denominator
    taken_live, fall_live = _edge_liveness(flow, block_reach, halting)
    n_jumpis = int(tables.is_jumpi.sum())
    n_edges_total = 2 * n_jumpis
    n_edges_live = int(taken_live.sum()) + int(fall_live.sum())
    invariant(
        n_edges_live <= n_edges_total,
        "live edge count exceeds the total edge count",
    )
    reachable_edge_pct = (
        100.0 * n_edges_live / n_edges_total if n_edges_total else 100.0
    )

    # function recovery + per-function summaries (advisory part of the
    # interprocedural layer — gated with it)
    function_map = None
    points: Tuple[dict, ...] = ()
    if getattr(args, "staticpass_interproc", True):
        try:
            from mythril_tpu_torch.staticpass.functions import (
                interesting_points,
                recover_functions,
            )

            function_map = recover_functions(flow, instr_reach)
            points = tuple(interesting_points(function_map))
        except Exception as e:
            log.warning(
                "function recovery failed (summaries degraded): %s", e
            )
            _count("staticpass.function_recovery_failed")

    return StaticSummary(
        n_instructions=n,
        code_size=code_size or (int(tables.addr[-1] + tables.width[-1]) if n else 0),
        n_blocks=flow.n_blocks,
        n_reachable_blocks=int(block_reach.sum()),
        block_starts=flow.block_start,
        block_addrs=tables.addr[flow.block_start] if flow.n_blocks else np.zeros(0, np.int32),
        edges=flow.edge_list(),
        instr_reachable=instr_reach,
        reachable_opcodes=reach_ops,
        static_target=static_target,
        n_resolved_jumps=flow.n_resolved,
        underflow_blocks=int((halting & block_reach).sum()),
        unreachable_spans=spans,
        unreachable_bytes=unreachable_bytes,
        may_reach=flows,
        escalated_bits=escalated,
        is_creation=is_creation,
        wall_s=time.perf_counter() - t0,
        interproc_ok=refined is not None,
        edge_taken_live=taken_live,
        edge_fall_live=fall_live,
        n_jumpis=n_jumpis,
        n_edges_total=n_edges_total,
        n_edges_live=n_edges_live,
        reachable_edge_pct=reachable_edge_pct,
        function_map=function_map,
        interesting_points=points,
    )


def _span(tables, first: int, last: int) -> Tuple[int, int]:
    return (int(tables.addr[first]),
            int(tables.addr[last] + tables.width[last]))


def summary_for_code(code, is_creation: bool = False) -> Optional[StaticSummary]:
    """Cached summary for a Disassembly-like object (``.bytecode`` bytes +
    ``.instruction_list``).  Returns None when the pass is disabled or
    fails — every consumer treats None as "no static information"."""
    from mythril_tpu_torch.support.support_args import args

    if not getattr(args, "staticpass", True):
        return None
    try:
        bytecode = getattr(code, "bytecode", None) or b""
        if isinstance(bytecode, str):
            bytecode = bytes.fromhex(
                bytecode[2:] if bytecode.startswith("0x") else bytecode
            )
        instruction_list = code.instruction_list
        key = (
            hashlib.sha1(bytecode).hexdigest(),
            len(instruction_list),
            is_creation,
            bool(getattr(args, "staticpass_interproc", True)),
        )
        hit = _CACHE.get(key)
        if hit is not None:
            _count("staticpass.cache_hits")
            return hit
        _count("staticpass.cache_misses")
        summary = summarize(
            instruction_list, code_size=len(bytecode), is_creation=is_creation
        )
        if len(_CACHE) >= _CACHE_CAP:
            _CACHE.clear()
        _CACHE[key] = summary
        return summary
    except Exception as e:  # over-approximation escape hatch: never fatal
        log.warning("static pass failed (analysis continues without it): %s", e)
        return None


def publish_reachability(code, summary: Optional[StaticSummary]) -> None:
    """Register a summary's reachability masks with the exploration
    ledger, keyed by the same keccak code hash the engines use, so
    coverage can be reported over the statically reachable denominator
    (`coverage_pct_reachable`) next to the raw one."""
    if summary is None or summary.edge_taken_live is None:
        return
    try:
        from mythril_tpu_torch.observability.exploration import get_exploration_ledger
        from mythril_tpu_torch.support.support_utils import get_code_hash

        bytecode = getattr(code, "bytecode", None) or b""
        if isinstance(bytecode, (bytes, bytearray)):
            hex_code = bytes(bytecode).hex()
        else:
            hex_code = bytecode
        get_exploration_ledger().register_static(
            get_code_hash(hex_code),
            summary.instr_reachable,
            summary.edge_taken_live,
            summary.edge_fall_live,
        )
    except Exception as e:  # observe-only plumbing: never fatal
        log.debug("static reachability not published: %s", e)


def _count(name: str, n: int = 1) -> None:
    from mythril_tpu_torch.observability import get_registry

    get_registry().counter(name).inc(n)


# aggregate live/total edge counts across every recorded summary, so the
# staticpass.reachable_edge_pct gauge reflects the whole process
_EDGE_TOTALS = {"live": 0, "total": 0}


def record_summary_metrics(summary: StaticSummary) -> None:
    """Publish one summary's counters (report meta / --metrics-out)."""
    _count("staticpass.contracts")
    _count("staticpass.blocks", summary.n_blocks)
    _count("staticpass.unreachable_bytes", summary.unreachable_bytes)
    _count("staticpass.jumps_resolved", summary.n_resolved_jumps)
    _count("staticpass.underflow_blocks", summary.underflow_blocks)
    if summary.interproc_ok:
        _count("staticpass.interproc_refined")
    if summary.function_map is not None:
        _count("staticpass.functions_recovered",
               len(summary.function_map.functions))
    _count("staticpass.edges_live", summary.n_edges_live)
    _count("staticpass.edges_total", summary.n_edges_total)
    _count("staticpass.interesting_points", len(summary.interesting_points))
    from mythril_tpu_torch.observability import get_registry

    get_registry().counter("staticpass.wall_time_s").inc(round(summary.wall_s, 6))
    _EDGE_TOTALS["live"] += summary.n_edges_live
    _EDGE_TOTALS["total"] += summary.n_edges_total
    if _EDGE_TOTALS["total"]:
        get_registry().gauge("staticpass.reachable_edge_pct").set(
            round(100.0 * _EDGE_TOTALS["live"] / _EDGE_TOTALS["total"], 3)
        )


def clear_cache() -> None:
    _CACHE.clear()
    _EDGE_TOTALS["live"] = 0
    _EDGE_TOTALS["total"] = 0
