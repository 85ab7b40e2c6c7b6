"""Inputs for the frontier segment's parity tests, made with numpy from a seed.

One caps and one code bucket serve every case (the JAX segment compiles
once per (caps, bucket)): B=8 paths, K=16 steps, small stack, memory,
storage, constraint and event caps, an arena of 4096 rows, and two codes
(C=2) in a bucket of 512 instructions.  Code 0, ``CATALOG``, holds every
opcode class the device runs; code 1, ``PAGED``, is 640 instructions long
and is given the resident window [64, 576), so paths outside it fault
(``F_PAGEFAULT``).

A case is a dict of numpy inputs in the JAX layout: ``state`` (a
``FrontierState``), ``arena`` (the 7 columns, ``val`` uint32), ``arena_len``,
``visited``, ``code`` (the 11 stacked tables) and ``cfg`` (6 ints).
``special_cases()`` names the targeted ones; ``random_case(seed)`` draws a whole
batch at random, operands from a pool of concrete, symbolic and out-of-range
rows.  ``width_case(B, seed)`` is a batch of B slots (its own caps, under
``case["caps"]``) in which one path forks round after round (``FORKS``)
until the slots run out, beside random paths, with junk in the free slots'
event buffers (a child's buffer must come out reset).  Both ``tests/test_torch_frontier_segment.py`` (JAX against the plain
version) and ``tests/test_torch_frontier_host.py`` (the kernel body built
by g++ against the plain version) run them.
"""

from __future__ import annotations

from collections import namedtuple

import numpy as np

from mythril_tpu_torch.frontier import ops as O
from mythril_tpu_torch.frontier.arena import HostArena
from mythril_tpu_torch.frontier.code import CodeTables, stacked_device_tables
from mythril_tpu_torch.frontier.state import Caps, empty_state
from mythril_tpu_torch.smt import terms as T

Ins = namedtuple("Ins", "opcode address arg_int")

CAPS = Caps(B=8, STK=16, MEM=8, STO=8, CON=16, EVT=12, R=4, K=16, ARENA=4096)
BUCKET = (2, 512, 1024, 8)  # code_cap, instr_cap, addr_cap, loops_cap
VISIT_I = 1024
PAGE_BASES = [0, 64]
HOOKED = ("ADD", "SUB", "MUL", "MSTORE", "JUMP", "CALLER", "SLOAD", "LOG2", "SHA3", "BALANCE")
CONC_NOP = ("ADD", "SUB", "MUL", "JUMP")
VALUE_GATE = ("MSTORE",)

_CATALOG_OPS = [
    "JUMPDEST", "PUSH1", "DUP1", "DUP3", "SWAP1", "SWAP3", "POP",
    "ADD", "SUB", "MUL", "DIV", "SDIV", "MOD", "SMOD", "AND", "OR", "XOR", "EXP",
    "SHL", "SHR", "SAR", "LT", "GT", "SLT", "SGT", "EQ", "ISZERO", "NOT",
    "CALLER", "CALLVALUE", "CALLDATASIZE", "CALLDATALOAD", "BALANCE", "SELFBALANCE",
    "SHA3", "MLOAD", "MSTORE", "SLOAD", "SSTORE", "JUMP", "JUMPI", "JUMPDEST",
    "LOG0", "LOG2", "RETURN", "REVERT", "SELFDESTRUCT", "INVALID", "ASSERT_FAIL",
    "GAS", "MSIZE", "SIGNEXTEND", "BYTE", "ADDMOD", "MULMOD", "MSTORE8", "CALL", "PC",
    "STOP", "JUMPDEST", "PUSH2", "JUMPDEST", "TIMESTAMP", "ORIGIN",
]


def _program(ops, arg=0x40):
    out, addr = [], 0
    for name in ops:
        out.append(Ins(name, addr, arg if name.startswith("PUSH") else None))
        addr += 1 + (int(name[4:]) if name.startswith("PUSH") and name != "PUSH0" else 0)
    return out


CATALOG = _program(_CATALOG_OPS)
# 640 instructions: JUMPDESTs every 16th (more than the loops cap), the rest
# a mix of stack, arithmetic and control-flow ops
_PAGED_OPS = ["JUMPDEST" if i % 16 == 0 else
              ("PUSH1", "ADD", "DUP1", "POP", "JUMPI", "MSTORE", "ISZERO", "SWAP1", "JUMP")[i % 9]
              for i in range(640)]
PAGED = _program(_PAGED_OPS, arg=0x20)


def _fork_rounds(rounds: int):
    """Rounds of PUSH1 0; CALLDATALOAD; PUSH1 d; JUMPI; JUMPDEST (d: the
    JUMPDEST): a symbolic JUMPI whose branches meet, so every live path
    forks every fifth step."""
    out, addr = [], 0
    for _ in range(rounds):
        for name, arg in (("PUSH1", 0), ("CALLDATALOAD", None), ("PUSH1", addr + 6),
                          ("JUMPI", None), ("JUMPDEST", None)):
            out.append(Ins(name, addr, arg))
            addr += 2 if name == "PUSH1" else 1
    out.append(Ins("STOP", addr, None))
    return out


FORKS = _fork_rounds(12)

# the opcode that stands for each family in CATALOG.  CodeTables never
# emits F_MSTORE8 (MSTORE8 classifies as F_PARK), so its case patches the
# table; F_PAGEFAULT comes from code 1's window.
FAMILY_OPS = {
    O.F_PARK: "CALL", O.F_STOP: "STOP", O.F_PUSH: "PUSH1", O.F_DUP: "DUP3", O.F_SWAP: "SWAP3",
    O.F_POP: "POP", O.F_BINOP: "ADD", O.F_CMP: "SLT", O.F_ISZERO: "ISZERO",
    O.F_NOTOP: "NOT", O.F_ENVPUSH: "CALLER", O.F_CALLDATALOAD: "CALLDATALOAD",
    O.F_BALANCE: "BALANCE", O.F_SELFBALANCE: "SELFBALANCE", O.F_SHA3: "SHA3",
    O.F_MLOAD: "MLOAD", O.F_MSTORE: "MSTORE", O.F_SLOAD: "SLOAD", O.F_SSTORE: "SSTORE",
    O.F_JUMP: "JUMP", O.F_JUMPI: "JUMPI", O.F_JUMPDEST: "JUMPDEST", O.F_LOG: "LOG2",
    O.F_RETURN: "REVERT", O.F_SELFDESTRUCT: "SELFDESTRUCT", O.F_INVALID: "INVALID",
    O.F_GASPUSH: "GAS", O.F_MSIZE: "MSIZE", O.F_SIGNEXTEND: "SIGNEXTEND",
    O.F_BYTEOP: "BYTE", O.F_ADDMODOP: "MULMOD", O.F_MSTORE8: "MSTORE8",
    O.F_PAGEFAULT: "PUSH1",  # code 1 below its window
}
# binary and comparison opcodes: each one's own fold
BINOPS = ("ADD", "SUB", "MUL", "DIV", "SDIV", "MOD", "SMOD", "AND", "OR", "XOR", "EXP",
          "SHL", "SHR", "SAR", "LT", "GT", "SLT", "SGT", "EQ")

PANIC = 0x4E487B71 << 224


def assert_same(got, want):
    """Two segments' ``interop.outputs_to_numpy``: every array equal."""
    for name in want[0]:
        np.testing.assert_array_equal(got[0][name], want[0][name], err_msg=f"state.{name}")
    for name in want[1]:
        np.testing.assert_array_equal(got[1][name], want[1][name], err_msg=f"arena.{name}")
    assert got[2:5] == want[2:5], "arena_len, n_exec, max_live"
    np.testing.assert_array_equal(got[5], want[5], err_msg="visited")


def pc_of(name: str, program=CATALOG) -> int:
    return next(i for i, ins in enumerate(program) if ins.opcode == name)


class Pool:
    """Arena rows to draw operands from."""

    def __init__(self, arena: HostArena, rng, caps=CAPS):
        self.arena, self.rng = arena, rng
        small = [0, 1, 2, 3, 7, 31, 32, 33, 0x40, 0x60, 0x80, 255, 256, 1 << 19, 1 << 20]
        big = [1 << 255, (1 << 256) - 1, PANIC, PANIC | 0x1234, (1 << 255) - 1, 0xFF << 248,
               int.from_bytes(rng.bytes(32), "big"), int.from_bytes(rng.bytes(32), "big")]
        self.dests = [ins.address for ins in CATALOG if ins.opcode == "JUMPDEST"]
        self.const = [arena.const_row(v) for v in small + big + self.dests]
        self.addr = [arena.const_row(v) for v in (0, 0x20, 0x40, 0x60, 0x50, 0x44)]
        self.lens = [arena.const_row(v) for v in (0, 32, 64, 96, 128, 160, 33)]
        self.sym = [arena.var_row(T.var(f"v{i}", 256)) for i in range(6)]
        for k in range(4):  # device-shaped symbolic rows
            a, b = self.sym[k], self.sym[k + 1]
            self.sym.append(arena._append(O.A_ADD if k % 2 else O.A_ULT, a=a, b=b,
                                          width=256 if k % 2 else 0))
        self.wild = [-1, caps.ARENA + 3, caps.ARENA - 1]

    def pick(self, kind=None):
        kind = kind or self.rng.choice(["const", "sym", "addr", "wild"], p=[0.45, 0.35, 0.15, 0.05])
        return int(self.rng.choice(getattr(self, kind)))


def _tables(arena: HostArena, forks: bool = False):
    """Code 0 CATALOG and code 1 PAGED (its window at 64); with ``forks``,
    code 0 FORKS and code 1 CATALOG, both resident."""
    progs = (FORKS, CATALOG) if forks else (CATALOG, PAGED)
    tables = [CodeTables(prog, arena, hooked_opcodes=HOOKED, conc_nop_opcodes=CONC_NOP,
                         value_gate_opcodes=VALUE_GATE) for prog in progs]
    return stacked_device_tables(tables, BUCKET, page_bases=[0, 0] if forks else PAGE_BASES)


def base(seed: int, caps=CAPS, forks: bool = False):
    """Empty batch, the arena with the pool, tables, cfg; -> (case, pool)."""
    rng = np.random.default_rng(seed)
    arena = HostArena(caps.ARENA)
    row_zero, row_one = arena.const_row(0), arena.const_row(1)
    pool = Pool(arena, rng, caps)
    code = _tables(arena, forks)
    st = empty_state(caps, BUCKET[3])
    case = {
        "state": st, "arena": arena, "arena_len": None, "code": code,
        "visited": np.zeros((3, BUCKET[0], VISIT_I), bool),
        "cfg": [64, 0, row_zero, row_one, 0, caps.K],
        "rng": rng,
    }
    if caps != CAPS:
        case["caps"] = caps
    return case, pool


def occupy(case, pool, slot, pc, stack=(), code_id=0, **fields):
    """Make ``slot`` a running path at ``pc`` with ``stack`` (top last)."""
    st = case["state"]
    st.seed[slot], st.halt[slot], st.pc[slot], st.code_id[slot] = 0, O.H_RUNNING, pc, code_id
    st.stack[slot, :len(stack)] = stack
    st.stack_len[slot] = len(stack)
    for i in range(16):
        st.ctx[slot, i] = pool.const[0] if i == 15 else pool.sym[i % len(pool.sym)]
    for k, v in fields.items():
        getattr(st, k)[slot] = v


def finish(case):
    """-> the numpy inputs (arena columns copied, arena_len filled in)."""
    arena = case["arena"]
    out = dict(case)
    out["arena"] = [np.array(x) for x in arena.device_arrays()]
    if out["arena_len"] is None:
        out["arena_len"] = arena.length
    out.pop("rng")
    return out


# ---------------------------------------------------------------------------
# random batches
# ---------------------------------------------------------------------------


def random_case(seed: int, k_steps=None):
    case, pool = base(seed)
    _random_paths(case, pool, range(CAPS.B), 0.15)
    rng = case["rng"]
    case["visited"] = rng.random(case["visited"].shape) < 0.05
    case["cfg"] = [int(rng.integers(8, 70)), int(rng.choice([0, 2, 3])), case["cfg"][2],
                   case["cfg"][3], int(rng.integers(0, 5)),
                   int(k_steps or rng.integers(1, CAPS.K + 3))]
    return finish(case)


def _random_paths(case, pool, slots, p_free, code_ids=(0, 1, 1, 2, -1), programs=None):
    """Random paths in ``slots`` (a share ``p_free`` of them left free); a
    path's code id is drawn from ``code_ids``, its pc from the length of
    ``programs[code id]`` (CATALOG and PAGED by default)."""
    rng, st = case["rng"], case["state"]
    programs = programs or {1: PAGED}
    for b in slots:
        r = rng.random()
        if r < p_free:
            continue  # free slot
        code_id = int(rng.choice(code_ids, p=[0.6, 0.2, 0.1, 0.05, 0.05]))
        n = len(programs.get(code_id, CATALOG))
        pc = int(rng.integers(0, n + 1))
        depth = int(rng.integers(0, 70))
        STK = st.stack.shape[1]
        stack_len = int(rng.choice([0, 1, 2, 3, 5, 8, STK - 1, STK], p=[.04, .06, .2, .2, .2, .2, .05, .05]))
        stack = [pool.pick() for _ in range(stack_len)]
        occupy(case, pool, b, pc, stack, code_id=code_id, depth=depth)
        st.halt[b] = O.H_RUNNING if rng.random() < 0.85 else int(rng.integers(1, 11))
        st.seed[b] = int(rng.integers(0, 3))
        n_mem = int(rng.integers(0, CAPS.MEM + 1))
        st.mem_len[b] = n_mem
        st.mem_addr[b, :n_mem] = rng.choice([0, 0x20, 0x40, 0x60, 0x80, 0x50, 1 << 19], n_mem)
        st.mem_val[b, :n_mem] = [pool.pick() for _ in range(n_mem)]
        st.mem_size[b] = 32 * int(rng.integers(0, 8))
        n_sto = int(rng.integers(0, CAPS.STO + 1))
        st.sto_len[b] = n_sto
        st.sto_key[b, :n_sto] = [pool.pick() for _ in range(n_sto)]
        st.sto_val[b, :n_sto] = [pool.pick() for _ in range(n_sto)]
        st.ctx[b] = [pool.pick() for _ in range(16)]
        st.cons_len[b] = int(rng.choice([0, 3, CAPS.CON - 1, CAPS.CON]))
        st.cons[b, :st.cons_len[b]] = [pool.pick("sym") for _ in range(st.cons_len[b])]
        evt = st.events.shape[1]
        st.ev_len[b] = int(rng.choice([0, 0, 0, evt - 1, evt]))
        st.gas_min[b] = int(rng.integers(0, 1000))
        st.gas_max[b] = st.gas_min[b] + int(rng.integers(0, 1000))
        st.loops[b] = rng.integers(0, 4, BUCKET[3])
        st.static[b] = int(rng.random() < 0.1)
        st.score[b] = int(rng.integers(-5, 50))
        st.steps[b] = int(rng.integers(0, 5))


# widths on both sides of one block (128 paths), one cluster (1024) and
# more: every launch shape of the kernel
WIDTHS = (1, 127, 129, 1024, 1025)
# an event buffer of 5 x 13 words: most children's buffers start off a
# 16-byte boundary and end in a part of one, in each launch shape
ODD_EVT, ODD_EVT_WIDTHS = 5, (127, 129, 1025)


def width_case(B: int, seed: int, evt: int = 12):
    """B slots: slot 0 runs FORKS from its start (forks at steps 3, 8, 13,
    ... until the slots run out, then pends), an eighth of the rest random
    CATALOG paths, the others free with junk in their event buffers; each
    path has room for ``evt`` events."""
    caps = Caps(B=B, STK=16, MEM=8, STO=8, CON=16, EVT=evt, R=4, K=64, ARENA=1 << 15)
    case, pool = base(5000 + B + seed, caps, forks=True)
    rng, st = case["rng"], case["state"]
    occupy(case, pool, 0, 0, [])
    _random_paths(case, pool, range(1, B), 7 / 8, code_ids=(1, 1, 1, 1, -1),
                  programs={1: CATALOG})
    free = st.seed < 0
    st.events[free] = rng.integers(-5, 100, st.events[free].shape)
    st.ev_len[0] = 0
    case["visited"] = rng.random(case["visited"].shape) < 0.05
    case["cfg"] = [int(rng.integers(60, 200)), 0, case["cfg"][2], case["cfg"][3],
                   int(rng.integers(0, 5)), int(rng.integers(40, caps.K + 1))]
    return finish(case)


# ---------------------------------------------------------------------------
# targeted cases
# ---------------------------------------------------------------------------


def family_case(fam: int, concrete: bool):
    """Every slot runs the family's opcode from CATALOG, on concrete or on
    symbolic operands (the taken-branch JUMPI with a symbolic word forks)."""
    case, pool = base(1000 + 2 * fam + concrete)
    rng = case["rng"]
    name = FAMILY_OPS[fam]
    for b in range(CAPS.B - 2):  # two free slots for forks
        if name in ("MLOAD", "MSTORE", "SHA3"):
            stack = [pool.pick("lens" if concrete else "sym"), pool.pick("addr" if concrete else "sym")]
            if name == "MSTORE":
                stack = [pool.pick("const" if concrete else "sym"), pool.pick("addr")]
            if name == "SHA3":
                stack = [pool.pick("lens"), pool.pick("addr")] if concrete else \
                    [pool.pick("sym"), pool.pick("addr")]
        elif name in ("JUMP", "JUMPI"):
            dest = pool.arena.const_row(int(rng.choice(pool.dests)))
            word = pool.pick("const" if concrete else "sym")
            stack = [word, dest] if name == "JUMPI" else [dest]
        else:
            kind = "const" if concrete else "sym"
            stack = [pool.pick(kind) for _ in range(3 + (b % 3))]
        if fam == O.F_PAGEFAULT:
            occupy(case, pool, b, pc_of(name, PAGED) + 9 * b, stack, code_id=1, depth=b)
        else:
            occupy(case, pool, b, pc_of(name), stack, depth=b)
        st = case["state"]
        st.mem_len[b] = 3
        st.mem_addr[b, :3] = [0x40, 0x60, 0x20 if b % 2 else 0x90]
        st.mem_val[b, :3] = [pool.pick("const" if concrete else "sym") for _ in range(3)]
        st.sto_len[b] = 2
        st.sto_key[b, :2] = [stack[-1], pool.pick()]
        st.sto_val[b, :2] = [pool.pick(), pool.pick()]
    if fam == O.F_MSTORE8:
        case["code"][0][0, pc_of(name)] = O.F_MSTORE8
    case["cfg"][5] = 1
    return finish(case)


def binop_case(concrete: bool):
    """One slot per binary/comparison opcode (BINOPS), 8 at a time."""
    out = []
    for start in range(0, len(BINOPS), CAPS.B):
        case, pool = base(2000 + start + concrete)
        for b, name in enumerate(BINOPS[start:start + CAPS.B]):
            kind = "const" if concrete else "sym"
            occupy(case, pool, b, pc_of(name), [pool.pick(kind), pool.pick(kind)])
        case["cfg"][5] = 1
        out.append(finish(case))
    return out


def _jumpi_batch(seed, n_forking, depths=None, scores=None, sel=0, ev_len=None):
    case, pool = base(seed)
    dests = [pool.arena.const_row(d) for d in pool.dests]
    for b in range(n_forking):
        occupy(case, pool, b, pc_of("JUMPI"), [pool.sym[b % len(pool.sym)], dests[b % len(dests)]],
               depth=(depths or [0] * 8)[b], score=(scores or [0] * 8)[b])
        if ev_len is not None:
            case["state"].ev_len[b] = ev_len[b]
    case["cfg"][4] = sel
    return case, pool


def special_cases():
    """name -> case, the parity hazards and caps one by one."""
    cases = {}
    cat_n = len(CATALOG)

    case, pool = base(11)  # underflow: fewer operands than the arity
    for b, name in enumerate(("ADD", "SHA3", "JUMPI", "SSTORE", "ADDMOD", "SWAP3", "DUP3", "LOG2")):
        occupy(case, pool, b, pc_of(name), [pool.pick("const")])
    cases["underflow"] = finish(case)

    case, pool = base(12)  # stack cap: a full stack pushes
    for b, name in enumerate(("PUSH1", "DUP1", "CALLER", "MSIZE", "GAS", "SLOAD", "ISZERO", "POP")):
        occupy(case, pool, b, pc_of(name), [pool.pick("const") for _ in range(CAPS.STK)])
    cases["stack_cap"] = finish(case)

    case, pool = _jumpi_batch(13, 4, ev_len=[CAPS.EVT, CAPS.EVT - 1, CAPS.EVT, 0])
    for b, name in ((4, "SSTORE"), (5, "STOP"), (6, "ADD")):  # evented ops on a full buffer
        occupy(case, pool, b, pc_of(name), [pool.sym[0], pool.sym[1]], ev_len=CAPS.EVT)
    cases["event_full"] = finish(case)

    case, pool = base(14)  # depth cap and loop bound
    dest = pool.arena.const_row(CATALOG[pc_of("JUMPDEST")].address)
    for b in range(4):
        occupy(case, pool, b, pc_of("JUMP"), [dest], depth=62 + b)
    for b in range(4, 8):
        occupy(case, pool, b, 0, [], loops=np.arange(BUCKET[3]) % 4 + (b - 4))
    case["cfg"][0], case["cfg"][1], case["cfg"][5] = 63, 3, 4
    cases["depth_and_loop"] = finish(case)

    case, pool = base(15)  # static frame write violation
    for b, name in enumerate(("SSTORE", "LOG0", "LOG2", "SELFDESTRUCT", "MSTORE", "SLOAD", "SSTORE", "ADD")):
        occupy(case, pool, b, pc_of(name), [pool.pick("const") for _ in range(4)], static=int(b < 6))
    cases["static_write"] = finish(case)

    case, pool = base(16)  # MSTORE panic gate: concrete panic word, other words, symbolic
    words = [PANIC, PANIC | 77, 1, (1 << 256) - 1]
    for b in range(8):
        w = pool.arena.const_row(words[b % 4]) if b < 6 else pool.sym[b]
        occupy(case, pool, b, pc_of("MSTORE"), [w, pool.addr[b % 4]])
    cases["mstore_gate"] = finish(case)

    case, pool = base(17)  # paging: code 1's window is [64, 576)
    for b, pc in enumerate((0, 63, 64, 65, 575, 576, 639, 640)):
        occupy(case, pool, b, pc, [pool.pick("const") for _ in range(3)], code_id=1)
    case["cfg"][5] = 3
    cases["paging"] = finish(case)

    for sel in range(5):  # slot scarcity: 6 forks, 2 free slots
        case, pool = _jumpi_batch(20 + sel, 6, depths=[5, 9, 1, 9, 3, 7], scores=[3, 7, 50, 7, -2, 0],
                                  sel=sel)
        case["visited"][0, 0, CATALOG.index(next(i for i in CATALOG if i.opcode == "JUMPDEST"))] = True
        case["cfg"][5] = 2
        cases[f"sel_mode_{sel}"] = finish(case)

    case, pool = _jumpi_batch(30, 8)  # full batch: every fork pends
    cases["full_batch"] = finish(case)

    case, pool = base(31)  # arena exhaustion: the exit is by room
    for b in range(6):
        occupy(case, pool, b, pc_of("ADD"), [pool.sym[b], pool.sym[b + 1]] * 3)
    case["arena_len"] = CAPS.ARENA - 6 * CAPS.R * 2 - 3
    cases["arena_full"] = finish(case)

    case, pool = base(32)  # multi-code batch
    for b in range(8):
        code_id = b % 2
        pc = pc_of("ADD") if code_id == 0 else 64 + 8 * b
        occupy(case, pool, b, pc, [pool.pick("const") for _ in range(4)], code_id=code_id)
    case["cfg"][5] = 8
    cases["multi_code"] = finish(case)
    case, pool = base(33)  # gathers that clamp, scatters that drop
    code = case["code"]
    for b, (name, aux) in enumerate((("CALLER", -3), ("ORIGIN", 99), ("DUP3", 40), ("SWAP3", -7))):
        code[1][0, pc_of(name)] = aux  # the aux column: a ctx index, a DUP/SWAP depth
        occupy(case, pool, b, pc_of(name), [pool.pick("const") for _ in range(6)])
    first_dest = pc_of("JUMPDEST")
    code[7][0, first_dest] = BUCKET[3] + 3  # a loop id past the loops axis
    occupy(case, pool, 4, first_dest, [])
    occupy(case, pool, 5, pc_of("JUMP"), [pool.arena.const_row(BUCKET[2] + 5)])  # past jumpmap
    occupy(case, pool, 6, pc_of("ADD"), [CAPS.ARENA + 9, -1])  # rows past the arena
    occupy(case, pool, 7, pc_of("CALLER"), [], code_id=5)  # code id past the tables
    case["cfg"][5] = 2
    cases["gather_clamps"] = finish(case)

    case, pool = base(34)  # int32 wraps and floor division
    big = (1 << 31) - 40
    occupy(case, pool, 0, pc_of("ADD"), [pool.sym[0], pool.sym[1]], gas_min=big, gas_max=big)
    occupy(case, pool, 1, pc_of("MLOAD"), [pool.addr[2]], mem_size=(1 << 31) - 64)
    occupy(case, pool, 2, pc_of("MSTORE"), [pool.sym[0], pool.addr[3]], mem_size=-100)
    occupy(case, pool, 3, pc_of("SHA3"), [pool.lens[2], pool.addr[1]], gas_min=big, gas_max=-big)
    occupy(case, pool, 4, pc_of("JUMP"), [pool.arena.const_row(pool.dests[1])], depth=(1 << 31) - 1)
    occupy(case, pool, 5, pc_of("MSIZE"), [], mem_size=-64)
    occupy(case, pool, 6, pc_of("PUSH1"), [], steps=(1 << 31) - 1)
    occupy(case, pool, 7, pc_of("JUMPI"), [pool.sym[2], pool.arena.const_row(pool.dests[2])],
           score=-(1 << 31), depth=-(1 << 31))
    case["cfg"][0], case["cfg"][4] = (1 << 31) - 1, 2  # SEL_SHALLOW: -depth wraps
    cases["int32_wraps"] = finish(case)

    # steps that fork and steps that do not, one after another: FORKS from
    # one path (forks at steps 3, 8 and 13; the third round finds one free
    # slot for four forks) beside CATALOG paths (code 1) that never fork
    case, pool = base(35, forks=True)
    occupy(case, pool, 0, 0, [])
    for b, name in ((1, "ADD"), (2, "MSTORE"), (3, "SLOAD")):
        occupy(case, pool, b, pc_of(name), [pool.sym[b], pool.addr[b]] * 2, code_id=1)
    case["cfg"][5] = CAPS.K
    cases["fork_alternate"] = finish(case)

    case, pool = base(36)  # the step's only fork wants a slot but has no event room
    dest = pool.arena.const_row(pool.dests[1])
    occupy(case, pool, 0, pc_of("JUMPI"), [pool.sym[0], dest], ev_len=CAPS.EVT)
    for b, name in ((1, "ADD"), (2, "PUSH1"), (3, "ISZERO")):
        occupy(case, pool, b, pc_of(name), [pool.sym[b], pool.sym[b + 1]])
    case["cfg"][5] = 2
    cases["fork_no_room"] = finish(case)

    case, pool = base(37)  # the step's only fork finds no free slot
    occupy(case, pool, 0, pc_of("JUMPI"), [pool.sym[0], dest])
    for b in range(1, CAPS.B):
        occupy(case, pool, b, pc_of("ADD"), [pool.sym[b % 6], pool.sym[(b + 1) % 6]])
    case["cfg"][5] = 2
    cases["fork_no_slot"] = finish(case)

    # SEL_BEAM with a score of -(2^31 - 1): the wanting path's key is
    # INT32_MAX, so the non-wanting slot below it ranks before it and it
    # takes the second free slot
    case, pool = base(38)
    occupy(case, pool, 0, pc_of("ADD"), [pool.sym[0], pool.sym[1]])
    occupy(case, pool, 1, pc_of("JUMPI"), [pool.sym[2], dest], score=-(1 << 31) + 1)
    case["cfg"][4], case["cfg"][5] = 4, 2
    cases["beam_key_max"] = finish(case)
    assert all(len(c["state"].pc) == CAPS.B for c in cases.values()) and cat_n > 0
    return cases


def partition_cases():
    """name -> case for the segment partitioned over slot blocks (B = 8 as
    2, 4 or 8 shards): what crosses blocks, one hazard at a time."""
    out = {}
    # every fork in the first half, the free slots in the second: each
    # child lands in another shard's block (and, at 2 shards, the second
    # shard starts with no live path)
    case, pool = _jumpi_batch(60, 4, depths=[3, 1, 4, 1])
    case["cfg"][5] = 3
    out["child_in_another_block"] = finish(case)
    # six forks in shards 0-2, two free slots in the last shard: the wanting
    # paths outnumber the free slots across shards, the ranks decide (deep)
    case, pool = _jumpi_batch(61, 6, depths=[5, 9, 1, 9, 3, 7], sel=1)
    case["cfg"][5] = 2
    out["scarcity_across_shards"] = finish(case)
    # SEL_COVERAGE: the score reads the coverage planes, marked by every
    # shard's paths in the same step, before the grant
    case, pool = _jumpi_batch(62, 5, depths=[2, 2, 2, 2, 2], sel=3)
    case["visited"][0, 0, CATALOG.index(next(i for i in CATALOG if i.opcode == "JUMPDEST"))] = True
    case["cfg"][5] = 3
    out["coverage_across_shards"] = finish(case)
    # live paths in the last block only: the first shards have none (halted
    # and free slots), their lanes still take part in every barrier
    case, pool = base(63)
    for b in range(4, 8):
        occupy(case, pool, b, pc_of("JUMPI") if b % 2 else pc_of("ADD"),
               [pool.sym[b % 6], pool.arena.const_row(pool.dests[b % 4])])
    occupy(case, pool, 0, pc_of("ADD"), [pool.sym[0], pool.sym[1]])
    case["state"].halt[0] = O.H_STOP
    case["cfg"][5] = 4
    out["shards_with_no_live_path"] = finish(case)
    # the arena's stop: room for a few steps of every shard's paths, then
    # the loop ends on the global count
    case, pool = base(64, forks=True)
    occupy(case, pool, 0, 0, [])
    for b in (3, 5, 6):
        occupy(case, pool, b, pc_of("ADD"), [pool.sym[b], pool.sym[b + 1]] * 3)
    case["arena_len"] = CAPS.ARENA - 4 * CAPS.R * 5 - 1
    out["arena_stop"] = finish(case)
    # forks every fifth step from one path, its children's children in
    # every shard's block, until the slots of every shard are taken
    case, pool = base(65, forks=True)
    occupy(case, pool, 2, 0, [])
    case["cfg"][5] = CAPS.K
    out["fork_rounds"] = finish(case)
    return out


def odd_shapes_case():
    """An arena larger than caps.ARENA (dead slots' rows land at row
    caps.ARENA), coverage planes for one code of two (code 1's marks drop)
    and shorter than code 1's pcs (they clamp)."""
    case, pool = base(40)
    for b in range(6):
        occupy(case, pool, b, pc_of("JUMPI") if b < 3 else 64 + 7 * b,
               [pool.sym[b], pool.arena.const_row(pool.dests[b % 4])], code_id=int(b >= 3))
    out = finish(case)
    extra = 64
    fills = (0, -1, -1, -1, 0, 0, False)
    out["arena"] = [np.concatenate([x, np.full((extra,) + x.shape[1:], f, x.dtype)])
                    for x, f in zip(out["arena"], fills)]
    out["visited"] = np.zeros((3, 1, 600), bool)
    return out
