"""Per-instruction dispatch tables: bytecode -> dense device tables.

The host pre-decodes the instruction stream once per contract (the analogue of
``Disassembly`` feeding the host engine's dispatch,
mythril_tpu_torch/core/svm.py:274-317) into flat numpy tables indexed by
*instruction index* (not byte address — matching the host engine's pc
convention, reference mythril/laser/ethereum/svm.py:351):

  * ``fam``      handler family (``ops.F_*``) for the lax.switch dispatch
  * ``aux``      family-specific immediate (binop code, PUSH const row, ...)
  * ``arity``    required stack inputs (underflow -> exceptional halt)
  * ``gmin/gmax``  static gas bounds per opcode (dynamic parts added by
                 handlers, mirroring instruction_data.get_opcode_gas)
  * ``event``    whether executing this instruction records an event for the
                 host walker (always-evented ops + every opcode the engine
                 has detector hooks on)
  * ``addr``     byte address of the instruction (for PC, reports)
  * ``jumpmap``  byte address -> instruction index of a JUMPDEST (-1 if not)
  * ``loop_id``  dense id per JUMPDEST for loop-bound counting (-1 otherwise)
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Set

import numpy as np

from mythril_tpu_torch.frontier import ops as O
from mythril_tpu_torch.frontier.arena import HostArena

# ops that always record an event regardless of hooks: the walker needs them
# to keep carrier storage/constraints exact between hook sites.  MSTORE is
# NOT here: carrier memory is rebuilt from the device's word table at
# terminals/parks (records.snapshot_slot "mem" + walker._restore_memory),
# so memory writes — the densest op class in solc output — only event when
# a hook needs them (and the user_assertions panic gate suppresses even
# those for concrete non-panic values, see ``value_gate_opcodes``).
_ALWAYS_EVENT = {
    "JUMPI", "SSTORE", "SLOAD", "MSTORE8",
    "STOP", "RETURN", "REVERT", "SELFDESTRUCT", "INVALID", "ASSERT_FAIL",
}

_BINOP = {
    "ADD": O.A_ADD, "SUB": O.A_SUB, "MUL": O.A_MUL, "DIV": O.A_UDIV,
    "SDIV": O.A_SDIV, "MOD": O.A_UREM, "SMOD": O.A_SREM, "AND": O.A_AND,
    "OR": O.A_OR, "XOR": O.A_XOR, "EXP": O.A_EXP,
    "SHL": O.A_SHL, "SHR": O.A_LSHR, "SAR": O.A_ASHR,
}
_SHIFT_OPS = {"SHL", "SHR", "SAR"}  # pop order: (shift, value)

_CMP = {
    "LT": O.A_ULT, "GT": O.A_UGT, "SLT": O.A_SLT, "SGT": O.A_SGT, "EQ": O.A_EQ,
}

# env slots in the per-path context vector (state.ctx)
(
    CTX_CALLER, CTX_ORIGIN, CTX_CALLVALUE, CTX_ADDRESS, CTX_CDSIZE,
    CTX_BALANCES, CTX_STORAGE, CTX_GASPRICE, CTX_COINBASE, CTX_TIMESTAMP,
    CTX_NUMBER, CTX_DIFFICULTY, CTX_GASLIMIT, CTX_CHAINID, CTX_BASEFEE,
    CTX_SEED,
) = range(16)
CTX_W = 16

_ENVPUSH = {
    "CALLER": CTX_CALLER, "ORIGIN": CTX_ORIGIN, "CALLVALUE": CTX_CALLVALUE,
    "ADDRESS": CTX_ADDRESS, "CALLDATASIZE": CTX_CDSIZE,
    "GASPRICE": CTX_GASPRICE, "COINBASE": CTX_COINBASE,
    "TIMESTAMP": CTX_TIMESTAMP, "NUMBER": CTX_NUMBER,
    "DIFFICULTY": CTX_DIFFICULTY, "PREVRANDAO": CTX_DIFFICULTY,
    "GASLIMIT": CTX_GASLIMIT, "CHAINID": CTX_CHAINID, "BASEFEE": CTX_BASEFEE,
}


class CodeTables:
    def __init__(
        self,
        instruction_list: List,
        arena: HostArena,
        hooked_opcodes: Optional[Iterable[str]] = None,
        code_size: Optional[int] = None,
        conc_nop_opcodes: Optional[Iterable[str]] = None,
        value_gate_opcodes: Optional[Iterable[str]] = None,
        static_summary=None,
    ):
        from mythril_tpu_torch.support.opcodes import OPCODES

        hooked: Set[str] = set(hooked_opcodes or ())
        # hooked opcodes whose every hook is a declared no-op on all-concrete
        # operands (module concrete_nop_hooks): evented, but the device
        # suppresses the event when operand concreteness proves the no-op
        conc_nop: Set[str] = set(conc_nop_opcodes or ()) - _ALWAYS_EVENT
        # MSTORE panic gate (module value_gated_hooks): event only when the
        # stored value is concrete with the solc Panic(uint256) selector in
        # its top 32 bits — the single case the hook observes (symbolic
        # values no-op there too)
        val_gate: Set[str] = set(value_gate_opcodes or ()) & {"MSTORE"}
        n = len(instruction_list)
        self.n = n
        self.instruction_list = instruction_list
        self.fam = np.zeros(n + 1, np.int32)  # +1: implicit STOP off the end
        self.aux = np.zeros(n + 1, np.int32)
        self.arity = np.zeros(n + 1, np.int32)
        self.gmin = np.zeros(n + 1, np.int32)
        self.gmax = np.zeros(n + 1, np.int32)
        self.event = np.zeros(n + 1, bool)
        self.concskip = np.zeros(n + 1, bool)
        self.valgate = np.zeros(n + 1, bool)
        self.addr = np.zeros(n + 1, np.int32)
        self.opcode_names: List[str] = []

        max_addr = max((ins.address for ins in instruction_list), default=0)
        self.jumpmap = np.full(max_addr + 2, -1, np.int32)
        self.loop_id = np.full(n + 1, -1, np.int32)
        n_loops = 0

        # static pre-analysis (mythril_tpu_torch/staticpass): statically
        # unreachable instructions leave the packed event set (they can
        # never execute, so no walker replay depends on them) and their
        # JUMPDESTs claim no loop slot (the _LOOPS_CAP budget goes to
        # code that can actually loop).  jumpmap keeps EVERY JUMPDEST —
        # dynamic jump validity is the device's own check, not the
        # pass's.  ``static_target`` exports statically resolved
        # JUMP/JUMPI destinations (instruction index, -1 = dynamic) so
        # device/host consumers can skip the jumpmap fallback path.
        reach = None
        if (
            static_summary is not None
            and static_summary.n_instructions == n
        ):
            reach = static_summary.instr_reachable
        self.static_target = np.full(n + 1, -1, np.int32)
        events_pruned = 0
        jumpi_events_pruned = 0

        for i, ins in enumerate(instruction_list):
            name = ins.opcode
            self.opcode_names.append(name)
            self.addr[i] = ins.address
            info = OPCODES.get(name)
            if info is not None:
                _, arity, _, g0, g1 = info
                self.arity[i], self.gmin[i], self.gmax[i] = arity, g0, g1
            reachable = reach is None or bool(reach[i])
            event = name in _ALWAYS_EVENT or name in hooked
            self.event[i] = event and reachable
            if event and not reachable:
                events_pruned += 1
                if name == "JUMPI":
                    jumpi_events_pruned += 1
            self.concskip[i] = name in conc_nop
            self.valgate[i] = name in val_gate
            fam, aux = self._classify(ins, arena, code_size)
            self.fam[i], self.aux[i] = fam, aux
            if name == "JUMPDEST":
                self.jumpmap[ins.address] = i
                if reachable:
                    self.loop_id[i] = n_loops
                    n_loops += 1
            if reach is not None and reachable:
                self.static_target[i] = static_summary.static_target[i]

        if events_pruned:
            from mythril_tpu_torch.observability import get_registry

            get_registry().counter("staticpass.events_pruned").inc(
                events_pruned
            )
            if jumpi_events_pruned:
                get_registry().counter(
                    "staticpass.jumpi_events_pruned"
                ).inc(jumpi_events_pruned)

        # reachable-edge oracle accounting: JUMPI edges the interprocedural
        # layer proved dead (constant-folded condition or invalid/unreachable
        # destination).  The event bit itself stays at instruction
        # granularity — a reachable JUMPI with one dead edge still events
        # for the walker — but the dead-edge count is what the pruning
        # parity gate and the drift doctor watch.
        if (
            reach is not None
            and getattr(static_summary, "edge_taken_live", None) is not None
        ):
            taken_live = static_summary.edge_taken_live
            fall_live = static_summary.edge_fall_live
            edges_dead = 0
            for i, ins in enumerate(instruction_list):
                if ins.opcode == "JUMPI":
                    edges_dead += int(not taken_live[i]) + int(not fall_live[i])
            if edges_dead:
                from mythril_tpu_torch.observability import get_registry

                get_registry().counter(
                    "staticpass.jumpi_edges_pruned"
                ).inc(edges_dead)

        # implicit STOP past the end of code (reference svm.py:281-284)
        self.fam[n] = O.F_STOP
        self.event[n] = True
        self.addr[n] = max_addr + 1
        self.opcode_names.append("STOP")
        self.n_loops = max(n_loops, 1)

    def _classify(self, ins, arena: HostArena, code_size: Optional[int]):
        name = ins.opcode
        if name.startswith("PUSH"):
            value = ins.arg_int or 0
            return O.F_PUSH, arena.const_row(value, 256)
        if name.startswith("DUP"):
            return O.F_DUP, int(name[3:])
        if name.startswith("SWAP"):
            return O.F_SWAP, int(name[4:])
        if name.startswith("LOG"):
            return O.F_LOG, int(name[3:])
        if name in _BINOP:
            # aux low bits: arena op; bit 8: operands pop as (shift, value)
            swap = 256 if name in _SHIFT_OPS else 0
            return O.F_BINOP, _BINOP[name] | swap
        if name in _CMP:
            return O.F_CMP, _CMP[name]
        if name in _ENVPUSH:
            return O.F_ENVPUSH, _ENVPUSH[name]
        simple = {
            "STOP": (O.F_STOP, 0),
            "POP": (O.F_POP, 0),
            "ISZERO": (O.F_ISZERO, 0),
            "NOT": (O.F_NOTOP, 0),
            "CALLDATALOAD": (O.F_CALLDATALOAD, 0),
            "BALANCE": (O.F_BALANCE, 0),
            "SELFBALANCE": (O.F_SELFBALANCE, 0),
            "SHA3": (O.F_SHA3, 0),
            "KECCAK256": (O.F_SHA3, 0),
            "MLOAD": (O.F_MLOAD, 0),
            "MSTORE": (O.F_MSTORE, 0),
            "SLOAD": (O.F_SLOAD, 0),
            "SSTORE": (O.F_SSTORE, 0),
            "JUMP": (O.F_JUMP, 0),
            "JUMPI": (O.F_JUMPI, 0),
            "JUMPDEST": (O.F_JUMPDEST, 0),
            "GAS": (O.F_GASPUSH, 0),
            "MSIZE": (O.F_MSIZE, 0),
            "RETURN": (O.F_RETURN, 0),
            "REVERT": (O.F_RETURN, 1),
            "SELFDESTRUCT": (O.F_SELFDESTRUCT, 0),
            "INVALID": (O.F_INVALID, 0),
            "ASSERT_FAIL": (O.F_INVALID, 0),
            "SIGNEXTEND": (O.F_SIGNEXTEND, 0),
            "BYTE": (O.F_BYTEOP, 0),
            "ADDMOD": (O.F_ADDMODOP, O.A_ADDMOD),
            "MULMOD": (O.F_ADDMODOP, O.A_MULMOD),
        }
        if name == "PC":
            return O.F_PUSH, arena.const_row(ins.address, 256)
        if name == "CODESIZE" and code_size is not None:
            return O.F_PUSH, arena.const_row(code_size, 256)
        if name in simple:
            return simple[name]
        # everything else (CALL family, CREATE, copies, EXTCODE*, BLOCKHASH,
        # RETURNDATA*, ...) parks the path for the host engine
        return O.F_PARK, 0

    def size_bucket(self) -> tuple:
        """(instr_cap, addr_cap, loops_cap) — padded sizes so one compiled
        segment program serves every contract in the same bucket.  Base caps
        fit EIP-170 runtime code (24576 bytes); larger inputs (initcode,
        arbitrary files) grow the bucket instead of crashing.

        Under packed-code paging the instruction axis is capped at the
        residency budget: a paged code's device tables hold only the
        resident window, so an oversized code stops growing the bucket
        (pc stays the TRUE instruction index; the window check in step.py
        faults non-resident pcs to the host for a repack)."""
        instr_cap = _grow(_INSTR_BASE, _INSTR_GROWTH, self.fam.shape[0])
        budget = page_budget()
        if budget is not None and instr_cap > budget:
            instr_cap = budget
        addr_cap = _grow(_ADDR_BASE, _ADDR_GROWTH, self.jumpmap.shape[0])
        return instr_cap, addr_cap, _LOOPS_CAP

    def full_instr_cap(self) -> int:
        """Instruction-axis cap covering the WHOLE code (paging ignored) —
        the coverage-plane axis, which is indexed by true pc."""
        return _grow(_INSTR_BASE, _INSTR_GROWTH, self.fam.shape[0])

    def is_paged(self) -> bool:
        """True when the code's instruction axis exceeds the residency
        budget, i.e. its device tables hold a window, not the whole code."""
        budget = page_budget()
        return budget is not None and self.fam.shape[0] > budget

    def padded_device_tables(self, bucket: Optional[tuple] = None,
                             window_base: int = 0):
        """CodeDev-shaped numpy arrays padded to the size bucket; the pad
        region dispatches F_STOP (unreachable: pc never exceeds n).

        ``window_base`` selects the resident window of a paged code: the
        instruction-axis tables hold rows [window_base, window_base +
        instr_cap) and the device subtracts the base before every gather.
        jumpmap is NOT windowed (it is byte-address-indexed and maps to
        TRUE instruction indices, so jumps into cold spans resolve and
        then fault at the next dispatch).

        JUMPDESTs beyond the loops cap get loop_id -1 (no loop bound for
        them, rather than aliasing counters and killing loop-free paths);
        max_depth and the segment step cap still bound those paths."""
        instr_cap, addr_cap, loops_cap = bucket or self.size_bucket()

        def pad1(a, cap, fill, base=0):
            seg = a[base:base + cap]
            out = np.full(cap, fill, a.dtype)
            out[: seg.shape[0]] = seg
            return out

        b = int(window_base)
        loop_id = np.where(self.loop_id >= loops_cap, -1, self.loop_id)
        return (
            pad1(self.fam, instr_cap, O.F_STOP, b),
            pad1(self.aux, instr_cap, 0, b),
            pad1(self.arity, instr_cap, 0, b),
            pad1(self.gmin, instr_cap, 0, b),
            pad1(self.gmax, instr_cap, 0, b),
            pad1(self.event, instr_cap, True, b),
            pad1(self.jumpmap, addr_cap, -1),
            pad1(loop_id, instr_cap, -1, b),
            pad1(self.concskip, instr_cap, False, b),
            pad1(self.valgate, instr_cap, False, b),
        )


# bucket-growth bases shared by every sizing path (CodeTables.size_bucket,
# multi_size_bucket, bucket_hint) — ONE set of constants so a tuning change
# cannot desynchronize the cooperative driver's floor from the real bucket
# (a mismatch silently reintroduces mid-sweep XLA recompiles)
_INSTR_BASE, _INSTR_GROWTH = 512, 4
_ADDR_BASE, _ADDR_GROWTH = 32768, 2
_CODE_GROWTH = 8
_LOOPS_CAP = 512


def _grow(base: int, factor: int, need: int) -> int:
    cap = base
    while cap < need:
        cap *= factor
    return cap


def page_budget() -> Optional[int]:
    """Instruction-axis residency budget (a grown bucket size), or None
    when packed-code paging is off (--no-code-paging).  Codes whose
    instruction axis exceeds this keep only a window of that many rows
    resident on device; cold spans page in via host repacks."""
    from mythril_tpu_torch.support.support_args import args

    if not getattr(args, "code_paging", True):
        return None
    budget = int(getattr(args, "code_page_budget", 0) or 0)
    if budget <= 0:
        return None
    return _grow(_INSTR_BASE, _INSTR_GROWTH, budget)


def _hint_size_bucket(instruction_list: List) -> tuple:
    """CodeTables.size_bucket computed from the raw instruction list (no
    table build) — MUST mirror size_bucket exactly or the cooperative
    floor desynchronizes from the real bucket (mid-sweep recompiles)."""
    instr_cap = _grow(
        _INSTR_BASE, _INSTR_GROWTH, len(instruction_list) + 1
    )  # +1: implicit trailing STOP
    budget = page_budget()
    if budget is not None and instr_cap > budget:
        instr_cap = budget
    max_addr = max((ins.address for ins in instruction_list), default=0)
    addr_cap = _grow(_ADDR_BASE, _ADDR_GROWTH, max_addr + 2)
    return instr_cap, addr_cap, _LOOPS_CAP


def bucket_hint(instruction_lists: List[List]) -> tuple:
    """(code_cap, instr_cap, addr_cap, loops_cap) covering these codes
    WITHOUT building tables — the cooperative driver pins this as the
    bucket floor so every tx round of a sweep shares one compiled segment
    program even as the live code set shrinks."""
    code_cap = _grow(1, _CODE_GROWTH, len(instruction_lists))
    instr_cap, addr_cap = _INSTR_BASE, _ADDR_BASE
    for instruction_list in instruction_lists:
        ic, ac, _lc = _hint_size_bucket(instruction_list)
        instr_cap, addr_cap = max(instr_cap, ic), max(addr_cap, ac)
    return code_cap, instr_cap, addr_cap, _LOOPS_CAP


def bucket_hint_classes(instruction_lists: List[List]) -> List[tuple]:
    """Per-class bucket floors for a cooperative sweep: the codes cluster
    by their own size bucket (same rule as ``bucket_classes``), and each
    class gets a (code_cap, instr_cap, addr_cap, loops_cap) floor sized
    for ITS members only — tiny contracts stop compiling giant programs
    because one creation-heavy outlier rides the same sweep."""
    groups: Dict[tuple, int] = {}
    for instruction_list in instruction_lists:
        key = _hint_size_bucket(instruction_list)
        groups[key] = groups.get(key, 0) + 1
    return [
        (_grow(1, _CODE_GROWTH, n),) + key
        for key, n in sorted(groups.items())
    ]


def bucket_classes(tables: List["CodeTables"]) -> List[tuple]:
    """Cluster codes into bucket classes: members sharing the same
    per-code ``size_bucket`` form one class with its own
    (code_cap, instr_cap, addr_cap, loops_cap).  The growth factors are
    geometric, so a mixed corpus lands in a handful of classes — and a
    creation-heavy outlier pays for its own axes instead of taxing every
    small code in the batch.  Returns [(bucket, member_indices)] sorted
    small-to-large (deterministic across rounds of a sweep)."""
    groups: Dict[tuple, List[int]] = {}
    for i, t in enumerate(tables):
        groups.setdefault(t.size_bucket(), []).append(i)
    return [
        ((_grow(1, _CODE_GROWTH, len(idxs)),) + key, idxs)
        for key, idxs in sorted(groups.items())
    ]


def visited_instr_cap(tables: List["CodeTables"]) -> int:
    """Coverage-plane instruction axis: the FULL (unpaged) cap over the
    members.  Coverage is indexed by true pc, so the planes must cover
    whole codes even when the dispatch tables hold only a window."""
    return max((t.full_instr_cap() for t in tables), default=_INSTR_BASE)


def pad_waste_pct(tables: List["CodeTables"], bucket: tuple) -> float:
    """Percent of the bucket's [C, instr_cap] instruction plane that is
    padding (code slots beyond the corpus count entirely; per-member rows
    beyond the code's resident span).  The number the large-code tail is
    about: one outlier inflating a shared bucket shows up here directly."""
    code_cap, instr_cap, _ac, _lc = bucket
    if not tables or code_cap <= 0 or instr_cap <= 0:
        return 0.0
    used = sum(min(t.fam.shape[0], instr_cap) for t in tables)
    total = code_cap * instr_cap
    return 100.0 * (1.0 - used / total)


def multi_size_bucket(tables: List["CodeTables"]) -> tuple:
    """(code_cap, instr_cap, addr_cap, loops_cap) covering every table.

    The code axis buckets at 1/8/32/... so one compiled segment serves any
    corpus batch of similar shape; instr/addr caps are the max over members
    (each member's own bucket, so a corpus of small contracts stays small)."""
    code_cap = _grow(1, _CODE_GROWTH, len(tables))
    instr_cap = addr_cap = loops_cap = 0
    for t in tables:
        ic, ac, lc = t.size_bucket()
        instr_cap, addr_cap, loops_cap = (
            max(instr_cap, ic), max(addr_cap, ac), max(loops_cap, lc)
        )
    return code_cap, instr_cap, addr_cap, loops_cap


def stacked_device_tables(tables: List["CodeTables"], bucket: tuple,
                          page_bases: Optional[List[int]] = None):
    """Stack per-code padded tables into the [C, ...] CodeDev arrays the
    segment consumes — the dispatch tables become per-path inputs via one
    [B] gather per table (multi-code frontier batching: paths from different
    contracts share a single wide device segment).  Pad codes beyond
    ``len(tables)`` dispatch F_STOP everywhere (unreachable: code_id is
    always a real index).

    ``page_bases`` (one window start per member, default all 0) windows
    paged codes; the per-code starts ride along as the trailing ``pbase``
    [C] column so the device can subtract them before every table gather."""
    code_cap, instr_cap, addr_cap, loops_cap = bucket
    bases = list(page_bases) if page_bases is not None else [0] * len(tables)
    per_code = [
        t.padded_device_tables((instr_cap, addr_cap, loops_cap),
                               window_base=bases[i])
        for i, t in enumerate(tables)
    ]
    fills = (O.F_STOP, 0, 0, 0, 0, True, -1, -1, False, False)
    out = []
    for col, fill in enumerate(fills):
        first = per_code[0][col]
        stack = np.full((code_cap,) + first.shape, fill, first.dtype)
        for ci, cols in enumerate(per_code):
            stack[ci] = cols[col]
        out.append(stack)
    pbase = np.zeros(code_cap, np.int32)
    pbase[: len(bases)] = np.asarray(bases, np.int32)
    out.append(pbase)
    return out
