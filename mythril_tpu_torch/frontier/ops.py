"""Shared constants: arena term ops, handler families, halt kinds, event kinds.

The device arena is a flat table of rows ``(op, a, b, c, width, val[16],
isconst)``; ``a/b/c`` are row indices (or small immediates where noted).
Every row decodes to a host term (``mythril_tpu_torch/smt/terms.py``) — see
``arena.decode_row`` for the mapping.  Ops mirror the host IR's surface
(reference: mythril/laser/smt/bitvec_helper.py:30-240) plus a few macro ops
(CDLOAD, ADDMOD, ...) that decode into the exact composite structure the host
instruction handlers build (the JAX package's core/instructions.py).

A copy of ``mythril_tpu/frontier/ops.py``; the port imports nothing of
the JAX package.
"""

from __future__ import annotations

# ---------------------------------------------------------------------------
# Arena term ops (row.op)
# ---------------------------------------------------------------------------

A_FREE = 0  # unused/unwritten row
A_CONST = 1  # constant; value in val, width in width
A_VAR = 2  # opaque host term; a = index into the host var table
A_VARF = 3  # fresh symbol minted on device; name derived from row id; a = tag

# binary bv ops (a, b rows; result width = width)
A_ADD = 10
A_SUB = 11
A_MUL = 12
A_UDIV = 13
A_SDIV = 14
A_UREM = 15
A_SREM = 16
A_AND = 17
A_OR = 18
A_XOR = 19
A_SHL = 20
A_LSHR = 21
A_ASHR = 22
A_EXP = 23

# unary bv
A_NOT = 30  # bitwise not

# comparisons -> bool rows (width = 0)
A_ULT = 40
A_UGT = 41
A_ULE = 42
A_UGE = 43
A_SLT = 44
A_SGT = 45
A_EQ = 46  # bv == bv
A_NE = 47  # bv != bv
A_EQZ = 48  # bv == 0 (one arg)

# bool ops
A_BNOT = 50  # logical not (a: bool row)

# structure
A_ITEW = 60  # If(cond, a, b) over bv; a=cond row, b=then row, c=else row
A_CONCAT = 61  # concat2(hi, lo); widths: a.width + b.width == width
A_EXTRACT = 62  # extract(hi=b, lo=c, src=a)  (b, c immediates)
A_KECCAK = 63  # keccak(a)
A_SELECT = 64  # select(arr=a, key=b)   (256->256 arrays only on device)
A_STORE = 65  # store(arr=a, key=b, val=c)

# macro ops: decode into the composite the host handler builds
A_CDLOAD = 70  # calldata.get_word_at(offset=a); b = seed index
A_ADDMOD = 71  # Extract(255,0, URem(ZExt(a)+ZExt(b), ZExt(m=c)))
A_MULMOD = 72  # Extract(255,0, URem(ZExt(a)*ZExt(b), ZExt(m=c)))
A_SIGNEXT = 73  # host signextend_ composite; a = b-word row, b = x row
A_BYTE = 74  # host byte_ composite; a = index row, b = word row

# ---------------------------------------------------------------------------
# Handler families (per-instruction dispatch index, see code.py)
# ---------------------------------------------------------------------------

F_PARK = 0  # anything the device doesn't run: halt, hand to host engine
F_STOP = 1
F_PUSH = 2  # aux = const row id
F_DUP = 3  # aux = n
F_SWAP = 4  # aux = n
F_POP = 5
F_BINOP = 6  # aux = arena op code (A_ADD..A_EXP)
F_CMP = 7  # aux = arena cmp op (A_ULT/A_UGT/A_SLT/A_SGT/A_EQ)
F_ISZERO = 8
F_NOTOP = 9
F_ENVPUSH = 10  # aux = arena row id to push (caller, callvalue, pc-const, ...)
F_CALLDATALOAD = 11
F_BALANCE = 12  # aux = balances array row id (per-seed: resolved via seed)
F_SELFBALANCE = 13
F_SHA3 = 14
F_MLOAD = 15
F_MSTORE = 16
F_SLOAD = 17
F_SSTORE = 18
F_JUMP = 19
F_JUMPI = 20
F_JUMPDEST = 21
F_LOG = 22  # aux = topic count
F_RETURN = 23  # aux = 1 for REVERT
F_SELFDESTRUCT = 24
F_INVALID = 25
F_GASPUSH = 26  # GAS: fresh symbol
F_MSIZE = 27
F_SIGNEXTEND = 28
F_BYTEOP = 29
F_ADDMODOP = 30  # aux = A_ADDMOD / A_MULMOD
F_MSTORE8 = 31
# packed-code paging: synthesized when a path's pc leaves the resident
# window of a paged code (step.py window check) — never appears in a
# CodeTables.fam row.  The handler halts with H_PAGE_FAULT so the harvest
# can repack the window host-side and re-inject the path.
F_PAGEFAULT = 32

N_FAMILIES = 33

# ---------------------------------------------------------------------------
# Halt kinds (state.halt)
# ---------------------------------------------------------------------------

H_RUNNING = 0
H_STOP = 1  # STOP or implicit stop off code end
H_RETURN = 2
H_REVERT = 3
H_SELFDESTRUCT = 4
H_INVALID = 5  # INVALID / ASSERT_FAIL / bad jump / stack underflow: path dies
H_PARK = 6  # unsupported op or cap overflow: host engine continues the path
H_PENDING_FORK = 7  # JUMPI wanted to fork but the batch was full: re-inject
H_DEPTH = 8  # max_depth exceeded: silently dropped (host strategy parity)
H_LOOP = 9  # loop bound exceeded (bounded-loops parity)
H_PAGE_FAULT = 10  # pc left the resident window of a paged code: the host
# repacks the window (engine._note_page_fault) and the path re-injects as
# an ordinary park carrier — correctness never depends on the window guess

# ---------------------------------------------------------------------------
# Event kinds (events[b, i, 0])
# ---------------------------------------------------------------------------

E_HOOK = 1  # hooked opcode: walker replays it through laser.execute_state
E_FORK = 2  # JUMPI fork/branch decision
E_TERMINAL = 3  # STOP/RETURN/REVERT/SELFDESTRUCT/INVALID
E_PARK = 4  # path parked at this pc

# events row layout: [kind, instr_idx, gas_min, gas_max,
#                     op0..op6 (operand rows, pop order, -1 pad),
#                     res (result row, -1 if none), extra] -> width 13
EV_W = 13
EV_KIND, EV_PC, EV_GMIN, EV_GMAX, EV_OP0, EV_RES, EV_EXTRA = 0, 1, 2, 3, 4, 11, 12
