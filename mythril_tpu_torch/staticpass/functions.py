"""Function recovery: selector-dispatch idiom + per-function summaries.

Solc emits a dispatcher prologue that compares the first four calldata
bytes against each public selector (``DUP1 PUSH4 sel EQ PUSH2 dest
JUMPI`` ladders, optionally split by ``GT``/``LT`` binary search in
large contracts) with a ``CALLDATASIZE`` guard routing short calldata
to the fallback/receive tail.  :func:`recover_functions` walks that
prologue over the (refined) CFG and partitions the code into
per-function regions keyed by 4-byte selector.

Recovery is ADVISORY, never load-bearing for soundness: anything that
does not match — hand-written dispatchers, unusual ladder orderings,
non-solc code — degrades to "one function: the whole contract", and no
consumer prunes work based on function boundaries.  Issue sets are
bit-identical whether recovery succeeds or degrades.

Per-function summaries re-walk each region with the converged abstract
stacks from :mod:`interproc`, capturing storage read/write key sets,
external-call sites with constant-folded target/value, CALLER-guard
facts, SELFDESTRUCT/DELEGATECALL reachability and unchecked call
returns — the facts detection modules and the interesting-point ranking
consume.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from mythril_tpu_torch.staticpass.cfg import E_FALL
from mythril_tpu_torch.staticpass.interproc import _peek, walk_block

_LADDER_BLOCK_CAP = 256  # dispatcher prologue blocks examined at most
_KEY_SET_CAP = 64  # distinct constant storage keys kept per function

_CALL_OPS = frozenset({"CALL", "CALLCODE", "DELEGATECALL", "STATICCALL"})
# stack position (1 = top) of the target address per call opcode
_CALL_TO_POS = {"CALL": 2, "CALLCODE": 2, "DELEGATECALL": 2, "STATICCALL": 2}
_CALL_VALUE_POS = {"CALL": 3, "CALLCODE": 3}


@dataclass(frozen=True)
class CallSite:
    """One external-call instruction with constant-folded operands."""

    instr: int
    addr: int
    opcode: str
    to: Optional[Tuple[int, ...]]  # constant targets, None = unknown
    value: Optional[Tuple[int, ...]]  # constant wei values, None = unknown/NA
    unchecked: bool  # return value immediately POPped


@dataclass(frozen=True)
class StaticFunction:
    """Summary of one recovered function region."""

    selector: Optional[int]  # None for fallback / whole-contract
    name: str  # "0x01020304" | "fallback" | "contract"
    entry_block: int
    entry_addr: int
    n_blocks: int
    storage_reads: Tuple[int, ...]
    storage_writes: Tuple[int, ...]
    reads_unknown: bool  # some SLOAD key did not fold to constants
    writes_unknown: bool
    calls: Tuple[CallSite, ...]
    caller_guarded: bool  # a CALLER comparison gates a branch in-region
    has_selfdestruct: bool
    has_delegatecall: bool
    selfdestruct_addrs: Tuple[int, ...]
    writes_after_call: bool  # an SSTORE is CFG-reachable from a call site


@dataclass(frozen=True)
class FunctionMap:
    dispatch_recovered: bool
    fallback_addr: Optional[int]
    functions: Tuple[StaticFunction, ...]


def _fall_succ(flow, b: int) -> Optional[int]:
    for nb, kind in zip(flow.succ[b], flow.succ_kind[b]):
        if kind == E_FALL:
            return nb
    return None


def _classify_dispatch_block(flow, b: int):
    """('eq', (selector, target_block)) | ('split', target_block) |
    ('size', target_block) | ('stop', None)."""
    t = flow.tables
    s = int(flow.block_start[b])
    last = int(flow.block_end[b]) - 1
    if not t.is_jumpi[last]:
        return "stop", None
    tgt = int(flow.static_target[last])
    if tgt < 0:
        return "stop", None
    tgt_block = int(flow.block_id[tgt])
    for i in range(s, last):
        nm = t.names[i]
        if nm.startswith("PUSH") and t.arg[i] is not None \
                and 0 <= t.arg[i] <= 0xFFFFFFFF:
            # selector compare: the pushed constant is consumed by an EQ
            # before any other push intervenes
            for j in range(i + 1, min(i + 4, last + 1)):
                if t.names[j] == "EQ":
                    return "eq", (int(t.arg[i]), tgt_block)
                if t.names[j].startswith("PUSH"):
                    break
    names = set(t.names[s:last])
    if "CALLDATASIZE" in names and names & {"LT", "GT", "ISZERO"}:
        return "size", tgt_block
    if names & {"LT", "GT"}:
        return "split", tgt_block
    return "stop", None


def _region_of(flow, entry_block: int) -> Set[int]:
    """Forward closure from the entry block over the (refined) edges.
    Regions of different functions may overlap (shared internal helper
    code) — fine, summaries are over-approximate."""
    seen = {entry_block}
    stack = [entry_block]
    while stack:
        b = stack.pop()
        for nb in flow.succ[b]:
            if nb not in seen:
                seen.add(nb)
                stack.append(nb)
    return seen


def _entry_stack(flow, b: int):
    es = getattr(flow, "entry_stack", None)
    return es(b) if es is not None else []


def _vals(v, cap: int = 8) -> Optional[Tuple[int, ...]]:
    return tuple(sorted(v))[:cap] if v is not None else None


def _summarize_region(
    flow, selector: Optional[int], name: str, entry_block: int,
    region: Set[int], instr_reach,
) -> StaticFunction:
    t = flow.tables
    acc: Dict[str, object] = {
        "reads": set(), "writes": set(),
        "reads_unknown": False, "writes_unknown": False,
    }
    calls: List[CallSite] = []
    call_blocks: List[int] = []
    sd_addrs: List[int] = []
    caller_guarded = False
    has_dc = False

    for b in sorted(region):
        s, e = int(flow.block_start[b]), int(flow.block_end[b])
        last = e - 1
        block_names = set(t.names[s:e])
        if "CALLER" in block_names and ("EQ" in block_names or "XOR" in block_names) \
                and t.is_jumpi[last]:
            caller_guarded = True

        def observe(i, stk, _b=b):
            if instr_reach is not None and i < len(instr_reach) \
                    and not instr_reach[i]:
                return
            nm = t.names[i]
            if nm == "SLOAD" or nm == "SSTORE":
                which = "reads" if nm == "SLOAD" else "writes"
                key = _peek(stk, 1)
                keys: Set[int] = acc[which]  # type: ignore[assignment]
                if key is None or len(keys) >= _KEY_SET_CAP:
                    acc[which + "_unknown"] = True
                else:
                    keys.update(key)
            elif nm in _CALL_OPS:
                to = _peek(stk, _CALL_TO_POS[nm])
                value = _peek(stk, _CALL_VALUE_POS[nm]) if nm in _CALL_VALUE_POS else None
                calls.append(CallSite(
                    instr=i, addr=int(t.addr[i]), opcode=nm,
                    to=_vals(to), value=_vals(value),
                    unchecked=(i + 1 < t.n and t.names[i + 1] == "POP"),
                ))
                call_blocks.append(_b)
            elif nm == "SELFDESTRUCT":
                sd_addrs.append(int(t.addr[i]))

        walk_block(t, _entry_stack(flow, b), s, e, observe)
        if "DELEGATECALL" in block_names:
            has_dc = True

    # writes-after-external-call: any SSTORE in the forward closure of a
    # call-site block (the reentrancy-shaped ordering detectors care about)
    writes_after_call = False
    if call_blocks:
        seen = set(call_blocks)
        stack = list(call_blocks)
        while stack and not writes_after_call:
            b = stack.pop()
            s, e = int(flow.block_start[b]), int(flow.block_end[b])
            if "SSTORE" in t.names[s:e]:
                writes_after_call = True
                break
            for nb in flow.succ[b]:
                if nb not in seen:
                    seen.add(nb)
                    stack.append(nb)

    return StaticFunction(
        selector=selector,
        name=name,
        entry_block=entry_block,
        entry_addr=int(t.addr[int(flow.block_start[entry_block])]),
        n_blocks=len(region),
        storage_reads=tuple(sorted(acc["reads"]))[:_KEY_SET_CAP],  # type: ignore[arg-type]
        storage_writes=tuple(sorted(acc["writes"]))[:_KEY_SET_CAP],  # type: ignore[arg-type]
        reads_unknown=bool(acc["reads_unknown"]),
        writes_unknown=bool(acc["writes_unknown"]),
        calls=tuple(calls),
        caller_guarded=caller_guarded,
        has_selfdestruct=bool(sd_addrs),
        has_delegatecall=has_dc,
        selfdestruct_addrs=tuple(sd_addrs),
        writes_after_call=writes_after_call,
    )


def recover_functions(flow, instr_reach=None) -> FunctionMap:
    """Recover the selector dispatch and summarize each function region.
    Degrades to one whole-contract function when the prologue does not
    match the idiom (or the contract genuinely has no dispatcher)."""
    if flow.n_blocks == 0:
        return FunctionMap(False, None, ())
    entries: List[Tuple[int, int]] = []  # (selector, entry_block)
    fallback_block: Optional[int] = None
    queue = [0]
    seen: Set[int] = set()
    while queue and len(seen) < _LADDER_BLOCK_CAP:
        b = queue.pop()
        if b in seen:
            continue
        seen.add(b)
        kind, info = _classify_dispatch_block(flow, b)
        if kind == "eq":
            sel, tgt = info
            entries.append((sel, tgt))
            nb = _fall_succ(flow, b)
            if nb is not None:
                queue.append(nb)
        elif kind == "split":
            queue.append(info)
            nb = _fall_succ(flow, b)
            if nb is not None:
                queue.append(nb)
        elif kind == "size":
            if fallback_block is None:
                fallback_block = info
            nb = _fall_succ(flow, b)
            if nb is not None:
                queue.append(nb)
        else:
            if fallback_block is None and entries:
                fallback_block = b

    if not entries:
        # no ladder recognized: one function spanning the whole contract
        region = _region_of(flow, 0)
        fn = _summarize_region(flow, None, "contract", 0, region, instr_reach)
        return FunctionMap(False, None, (fn,))

    # dedupe selectors keeping the first (dispatch order) occurrence
    by_sel: Dict[int, int] = {}
    for sel, tgt in entries:
        by_sel.setdefault(sel, tgt)

    functions: List[StaticFunction] = []
    for sel, entry_block in by_sel.items():
        region = _region_of(flow, entry_block)
        functions.append(_summarize_region(
            flow, sel, f"0x{sel:08x}", entry_block, region, instr_reach
        ))
    fallback_addr = None
    if fallback_block is not None:
        region = _region_of(flow, fallback_block)
        fb = _summarize_region(
            flow, None, "fallback", fallback_block, region, instr_reach
        )
        functions.append(fb)
        fallback_addr = fb.entry_addr
    return FunctionMap(True, fallback_addr, tuple(functions))


# ranked interesting points (export schema: kind/score/function/selector/addr)
_POINT_SCORES = {
    "unauthenticated_selfdestruct": 100,
    "unauthenticated_delegatecall": 90,
    "write_after_external_call": 70,
    "unchecked_call_return": 40,
}


def interesting_points(fmap: FunctionMap) -> List[dict]:
    """Ranked program points worth symbolic attention, highest first.
    Purely advisory: consumed by `myth static`, meta.staticpass and the
    future coverage-guided controller — never by the pruning gates."""
    points: List[dict] = []

    def add(kind: str, fn: StaticFunction, addr: Optional[int]) -> None:
        points.append({
            "kind": kind,
            "score": _POINT_SCORES[kind],
            "function": fn.name,
            "selector": f"0x{fn.selector:08x}" if fn.selector is not None else None,
            "addr": addr,
        })

    for fn in fmap.functions:
        if fn.has_selfdestruct and not fn.caller_guarded:
            add("unauthenticated_selfdestruct", fn,
                fn.selfdestruct_addrs[0] if fn.selfdestruct_addrs else None)
        if fn.has_delegatecall and not fn.caller_guarded:
            dc = next((c for c in fn.calls if c.opcode == "DELEGATECALL"), None)
            add("unauthenticated_delegatecall", fn, dc.addr if dc else None)
        if fn.writes_after_call:
            add("write_after_external_call", fn,
                fn.calls[0].addr if fn.calls else None)
        for c in fn.calls:
            if c.unchecked:
                add("unchecked_call_return", fn, c.addr)
    points.sort(key=lambda p: (-p["score"], p["addr"] if p["addr"] is not None else 1 << 62))
    return points
