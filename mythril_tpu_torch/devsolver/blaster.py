"""Lower narrow path conditions from the bitblast tape to a 3-CNF plane.

Reuses ``native/bitblast.serialize`` wholesale (the same serialization
the abstract pre-filter packs, ``absdomain/tape.py``): the conjunction is
one append-only tape of word-level records, and this module re-lowers
each record to single-bit Tseitin gates with aggressive constant folding.
Every gate is binary, so no clause ever exceeds 3 literals — the search
kernel's clause plane is a fixed ``[C, 3]`` array.

Narrowing first: the same ``x == c`` / ``cnt <= 1`` range harvest the
pre-filter performs (``absdomain/tape._harvest``) pins the common-prefix
known bits of every harvested VAR node to constants *before* gate
construction.  The pins are implied by the asserted conjuncts, so adding
them preserves equisatisfiability (UNSAT stays exact), and they are what
makes engine queries "narrow": a 256-bit loop counter pinned to
``[0, 1]`` contributes one free bit, not 256.

Admission is structural and happens here: the decision set is the
narrowest VAR nodes whose unpinned bits fit ``bit_budget`` together;
wide incidental actors (an unconstrained sender riding along in a
module confirmation) stay as non-decision CNF variables.  Splitting
over a subset keeps UNSAT exact — a refutation exhausts conflicts, and
conflicts involve only implied assignments, so they hold for any value
of the undecided bits — while a search that runs out of decisions
lapses to UNKNOWN.  Queries whose narrowest var alone exceeds the
budget, or that blow the gate/clause caps, raise ``Unsupported`` and
fall through to the exact tiers — the blaster can reject, never
misdecide.

Soundness inventory (why a kernel UNSAT on this CNF proves the original
conjunction UNSAT): serialization abstractions only ADD behaviors
(fresh variables for base-array selects/keccak/apply, dropped select
congruence); narrowing pins are implied facts; the Tseitin lowering is
exact per record.  SAT is only ever a *candidate*: the caller rebuilds
the model through ``bitblast._rebuild_assignment`` and validates it with
``concrete_eval.evaluate`` against the ORIGINAL terms before trusting it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from mythril_tpu_torch.native import bitblast
from mythril_tpu_torch.native.bitblast import (
    OP_ADD, OP_AND, OP_ASHR, OP_BAND, OP_BNOT, OP_BOR, OP_BXOR, OP_CONCAT,
    OP_CONST, OP_EQ, OP_EXTRACT, OP_ITE, OP_LSHR, OP_MUL, OP_NEG, OP_NOT,
    OP_OR, OP_SEXT, OP_SHL, OP_SLE, OP_SLT, OP_SUB, OP_ULE, OP_ULT, OP_VAR,
    OP_XOR, OP_ZEXT, Unsupported,
)
from mythril_tpu_torch.smt import terms
from mythril_tpu_torch.smt.terms import Term

__all__ = ["Blasted", "blast", "model_bytes"]

# tape records above this are not worth a host-side gate build: the
# pre-filter and exact tiers handle the wide tail
MAX_TAPE_NODES = 768

# a "bit" is either a Python bool (folded constant) or an int literal
# (2*var positive / 2*var+1 negated); variable 1 is the constant-TRUE
# anchor shared with the kernel plane
_TRUE, _FALSE = True, False


class Blasted:
    """One lowered query: 3-CNF clauses + model-readback bookkeeping."""

    __slots__ = ("clauses", "n_vars", "dec_vars", "tape", "var_bits",
                 "verdict", "free_bits", "projected", "truncated",
                 "abstracted")

    def __init__(self):
        self.clauses: List[List[int]] = []
        self.n_vars = 2  # vars 0/1 are the kernel's false/true anchors
        self.dec_vars: List[int] = []
        self.tape = None
        # per OP_VAR tape node, in tape order: list of bits, each either
        # ("c", 0/1) or ("v", cnf_var)
        self.var_bits: List[List[tuple]] = []
        self.verdict: Optional[str] = None  # "unsat" when decided here
        self.free_bits = 0
        self.projected = 0  # roots dropped by narrow-core projection
        self.truncated = 0  # subtrees cut at a summary pseudo-var
        # True when the tape carries select/keccak/UF sites: the tier
        # runs no CEGAR loop, so a SAT candidate violating lazy
        # congruence is expected fallthrough, not a soundness alarm
        self.abstracted = False


class _Builder:
    def __init__(self, var_cap: int, clause_cap: int):
        self.out = Blasted()
        self.var_cap = var_cap
        self.clause_cap = clause_cap
        self._memo: Dict[tuple, object] = {}

    # -- CNF primitives ------------------------------------------------

    def new_var(self) -> int:
        v = self.out.n_vars
        self.out.n_vars = v + 1
        if v >= self.var_cap:
            raise Unsupported("devsolver: CNF variable cap")
        return v

    def add(self, *lits: int) -> None:
        self.out.clauses.append(list(lits))
        if len(self.out.clauses) > self.clause_cap:
            raise Unsupported("devsolver: CNF clause cap")

    @staticmethod
    def neg(b):
        return (not b) if isinstance(b, bool) else b ^ 1

    def land(self, a, b):
        if isinstance(a, bool):
            return b if a else _FALSE
        if isinstance(b, bool):
            return a if b else _FALSE
        if a == b:
            return a
        if a == b ^ 1:
            return _FALSE
        key = ("and", min(a, b), max(a, b))
        hit = self._memo.get(key)
        if hit is not None:
            return hit
        z = 2 * self.new_var()
        self.add(z ^ 1, a)
        self.add(z ^ 1, b)
        self.add(a ^ 1, b ^ 1, z)
        self._memo[key] = z
        return z

    def lor(self, a, b):
        return self.neg(self.land(self.neg(a), self.neg(b)))

    def lxor(self, a, b):
        if isinstance(a, bool):
            return self.neg(b) if a else b
        if isinstance(b, bool):
            return self.neg(a) if b else a
        if a == b:
            return _FALSE
        if a == b ^ 1:
            return _TRUE
        key = ("xor", min(a & ~1, b & ~1), max(a & ~1, b & ~1),
               (a & 1) ^ (b & 1))
        hit = self._memo.get(key)
        if hit is not None:
            return hit
        z = 2 * self.new_var()
        self.add(z ^ 1, a, b)
        self.add(z ^ 1, a ^ 1, b ^ 1)
        self.add(z, a ^ 1, b)
        self.add(z, a, b ^ 1)
        self._memo[key] = z
        return z

    def lmux(self, c, a, b):
        """c ? a : b."""
        if isinstance(c, bool):
            return a if c else b
        if a == b:
            return a
        return self.lor(self.land(c, a), self.land(self.neg(c), b))

    def assert_true(self, b) -> None:
        if isinstance(b, bool):
            if not b:
                self.out.verdict = "unsat"
            return
        self.add(b)

    # -- word-level helpers (bit lists are little-endian) --------------

    def w_add(self, a: List, b: List, cin=_FALSE) -> Tuple[List, object]:
        out, c = [], cin
        for ai, bi in zip(a, b):
            x = self.lxor(ai, bi)
            out.append(self.lxor(x, c))
            c = self.lor(self.land(ai, bi), self.land(c, x))
        return out, c

    def w_not(self, a: List) -> List:
        return [self.neg(x) for x in a]

    def w_sub(self, a: List, b: List) -> Tuple[List, object]:
        # a - b == a + ~b + 1; carry-out == NOT borrow (1 means a >= b)
        return self.w_add(a, self.w_not(b), _TRUE)

    def w_ult(self, a: List, b: List):
        _diff, carry = self.w_sub(a, b)
        return self.neg(carry)

    def w_eq(self, a: List, b: List):
        acc = _TRUE
        for ai, bi in zip(a, b):
            acc = self.land(acc, self.neg(self.lxor(ai, bi)))
        return acc

    def w_slt(self, a: List, b: List):
        sa, sb = a[-1], b[-1]
        same = self.neg(self.lxor(sa, sb))
        return self.lor(self.land(sa, self.neg(sb)),
                        self.land(same, self.w_ult(a, b)))


def _const_int(bits: List) -> Optional[int]:
    """Concrete value of a bit vector iff every bit folded constant."""
    v = 0
    for i, b in enumerate(bits):
        if not isinstance(b, bool):
            return None
        if b:
            v |= 1 << i
    return v


def _harvest_pins(conjuncts: Sequence[Term], tape):
    """Range-harvest the conjuncts; return ``(var_pins, node_known)``.

    ``var_pins``: {OP_VAR tape node: (known_mask, known_value)} — the
    common-prefix bits every value in the harvested range shares, sunk
    onto the leaf variables.  ``node_known``: the same facts kept at
    the narrowed node itself (any op), for output-bit assertions and
    decision summaries when the sink dies early.  Raises
    ``tape_mod._RowRefuted`` via the caller when harvested ranges are
    contradictory (the row is UNSAT outright).

    Engine conditions rarely narrow a raw VAR: a calldata word is a
    CONCAT of 32 lazily-selected byte VARs, so a range pin on the word
    must be PUSHED DOWN through the structural ops (concat / extract /
    zext / sext) to reach the leaf VARs it actually constrains — that
    push-down is what turns a 256-bit ``x < 10`` word into 4 free bits
    instead of 256.
    """
    from mythril_tpu_torch.absdomain import tape as tape_mod

    ranges: Dict[int, Tuple[int, int]] = {}
    widths: Dict[int, int] = {}

    def narrow(t: Term, lo: int, hi: int) -> None:
        node = tape.node_of.get(t.tid)
        if node is None:
            return
        w = t.width if terms.is_bv_sort(t.sort) else 1
        lo, hi = max(lo, 0), min(hi, (1 << w) - 1)
        cur = ranges.get(node)
        if cur is not None:
            lo, hi = max(lo, cur[0]), min(hi, cur[1])
        if lo > hi:
            raise tape_mod._RowRefuted
        ranges[node] = (lo, hi)
        widths[node] = w

    tape_mod._harvest_row(conjuncts, narrow)

    # node-level known bits for EVERY narrowed node — when the leaf
    # push-down below dies early (an ITE-guarded calldata byte), the
    # node itself still carries the fact as output-bit assertions and
    # as a decision summary
    node_known: Dict[int, Tuple[int, int]] = {}
    for node, (lo, hi) in ranges.items():
        w = widths[node]
        k = (lo ^ hi).bit_length()
        known = ((1 << w) - 1) & ~((1 << k) - 1)
        if known:
            node_known[node] = (known, lo & known)

    pins: Dict[int, Tuple[int, int]] = {}

    def pin(node: int, known: int, kv: int) -> None:
        """Sink a known-bits fact onto ``node``; recurse through the
        structural ops until it lands on VAR leaves (or dies trying —
        arithmetic ops don't distribute bitwise)."""
        if not known:
            return
        op, w, a0, a1, _a2, _x0, x1 = tape.records[node]
        if op == OP_VAR:
            pk, pv = pins.get(node, (0, 0))
            both = pk & known
            if (pv & both) != (kv & both):
                # two implied facts disagree on a shared bit: the
                # conjunction itself is contradictory
                raise tape_mod._RowRefuted
            pins[node] = (pk | known, pv | (kv & known))
        elif op == OP_CONCAT:
            w_hi = tape.records[a0][1]
            w_lo = w - w_hi
            lo_mask = (1 << w_lo) - 1
            pin(a1, known & lo_mask, kv & lo_mask)
            pin(a0, known >> w_lo, kv >> w_lo)
        elif op == OP_EXTRACT:
            pin(a0, known << x1, kv << x1)
        elif op == OP_ZEXT:
            wa = tape.records[a0][1]
            if (kv >> wa) & (known >> wa):
                raise tape_mod._RowRefuted  # zero-extension bit pinned 1
            pin(a0, known & ((1 << wa) - 1), kv & ((1 << wa) - 1))
        elif op == OP_SEXT:
            wa = tape.records[a0][1]
            lo_mask = (1 << wa) - 1
            k, v = known & lo_mask, kv & lo_mask
            hk = known >> wa  # high bits are all copies of the sign bit
            hv = (kv >> wa) & hk
            if hk:
                if hv and hv != hk:
                    raise tape_mod._RowRefuted  # copies disagree
                k |= 1 << (wa - 1)
                if hv:
                    v |= 1 << (wa - 1)
            pin(a0, k, v)

    for node, (known, kv) in node_known.items():
        pin(node, known, kv)
    return pins, node_known


def blast(conjuncts: Sequence[Term], bit_budget: int = 64,
          var_cap: int = 4096, clause_cap: int = 4096) -> Blasted:
    """Serialize + narrow + lower one conjunction to 3-CNF.

    Raises ``Unsupported`` for anything outside the narrow fragment; the
    returned object may carry ``verdict == "unsat"`` when narrowing or
    constant folding already refuted the query (no kernel run needed).
    """
    from mythril_tpu_torch.absdomain import tape as tape_mod

    tape = bitblast.serialize(conjuncts, lazy_selects=True)
    if len(tape.records) > MAX_TAPE_NODES:
        raise Unsupported("devsolver: tape too large")

    bld = _Builder(var_cap, clause_cap)
    out = bld.out
    out.tape = tape
    out.abstracted = bool(tape.selects or tape.keccaks or tape.applies)

    try:
        pins, node_known = _harvest_pins(conjuncts, tape)
    except tape_mod._RowRefuted:
        out.verdict = "unsat"
        return out

    # admission pre-scan: PROJECT the conjunction onto its narrow core.
    # Engine queries mix narrow pinned words with wide incidental actors
    # (sender, call value, balance selects); a root whose free support
    # fits the decision budget is kept, the rest are dropped before any
    # gate is built.  Refuting a SUBSET of the asserted conjuncts
    # refutes the whole conjunction, so UNSAT stays exact; a kernel SAT
    # on the projection is only a candidate and is validated against
    # the ORIGINAL conjuncts by the caller.  Within the kept core the
    # kernel branches only over decision bits — conflicts involve
    # implied assignments alone, so exhausting them holds for any value
    # of the undecided bits, while running out of decisions lapses to
    # UNKNOWN.
    #
    # A decision SOURCE is either a free VAR leaf or a harvested
    # interior node (a calldata word whose bytes hide behind ITE size
    # guards): the node's unpinned OUTPUT bits summarize its whole
    # subtree, so a 256-bit ``x < 16`` word costs 4 decision bits even
    # when no leaf pin can land.
    n_free: Dict[int, int] = {}
    for node, (op, w, *_rest) in enumerate(tape.records):
        if op == OP_VAR:
            known, _kv = pins.get(node, (0, 0))
            n_free[node] = w - bin(known).count("1")
    out.free_bits = sum(n_free.values())

    def src_cost(src: Tuple[str, int]) -> int:
        kind, node = src
        if kind == "var":
            return n_free[node]
        known, _kv = node_known[node]
        return tape.records[node][1] - bin(known).count("1")

    support: List[frozenset] = []  # per record: decision sources
    for node, rec in enumerate(tape.records):
        op = rec[0]
        if op == OP_VAR:
            s = frozenset((("var", node),)) if n_free[node] else frozenset()
        else:
            s = frozenset()
            for a in rec[2:5]:
                if a >= 0:
                    s |= support[a]
        if node in node_known:
            # summarize ONLY undecidable subtrees: truncation severs
            # the node from its inputs, so a subtree that fits the
            # budget is worth keeping intact (its relations to sibling
            # terms are exactly what the kernel refutes)
            subtree = sum(src_cost(x) for x in s)
            if subtree > bit_budget and src_cost(("node", node)) < subtree:
                s = frozenset((("node", node),))
        support.append(s)

    chosen: set = set()
    kept: set = set()  # positions into tape.roots
    spent = 0
    costed = sorted(
        (sum(src_cost(x) for x in support[r]), i, r)
        for i, r in enumerate(tape.roots)
    )
    for _cost, i, r in costed:
        extra = sum(src_cost(x) for x in support[r] - chosen)
        if spent + extra > bit_budget:
            continue  # shared sources can make a later root affordable
        spent += extra
        chosen |= support[r]
        kept.add(i)
    if not kept:
        raise Unsupported("devsolver: no root fits decision budget %d"
                          % bit_budget)
    out.projected = len(tape.roots) - len(kept)
    decide_vars = {n for k, n in chosen if k == "var"}
    decide_summ = {n for k, n in chosen if k == "node"}

    # records reachable from a kept root, CUT at summary nodes: a
    # summarized subtree (the ITE size-guard comparators under a
    # calldata word) is replaced wholesale by a fresh pseudo-variable,
    # so none of its gates are built
    needed: set = set()
    stack = [tape.roots[i] for i in kept]
    while stack:
        n = stack.pop()
        if n in needed:
            continue
        needed.add(n)
        if n in decide_summ:
            continue
        for a in tape.records[n][2:5]:
            if a >= 0 and a not in needed:
                stack.append(a)

    consts = bytes(tape.consts)
    bits: List[List] = []
    for node, rec in enumerate(tape.records):
        op, w, a0, a1, a2, x0, x1 = rec
        if op == OP_CONST:
            v = int.from_bytes(consts[x0:x0 + x1], "little") & ((1 << w) - 1)
            nb = [bool((v >> i) & 1) for i in range(w)]
        elif op == OP_VAR:
            known, kv = pins.get(node, (0, 0))
            decide = node in decide_vars
            nb, refs = [], []
            for i in range(w):
                if (known >> i) & 1:
                    bit = bool((kv >> i) & 1)
                    refs.append(("c", 1 if bit else 0))
                else:
                    cv = bld.new_var()
                    if decide:
                        out.dec_vars.append(cv)
                    bit = 2 * cv
                    refs.append(("v", cv))
                nb.append(bit)
            out.var_bits.append(refs)
        elif node not in needed:
            nb = None  # only feeds dropped roots or a cut subtree
        elif node in decide_summ:
            # truncate: the node becomes a fresh pseudo-variable with
            # its harvested known bits pinned and the rest decided —
            # an abstraction that only ADDS behaviors, so a refutation
            # of the truncated formula refutes the original
            known, kv = node_known[node]
            nb = []
            for i in range(w):
                if (known >> i) & 1:
                    nb.append(bool((kv >> i) & 1))
                else:
                    cv = bld.new_var()
                    out.dec_vars.append(cv)
                    nb.append(2 * cv)
            out.truncated += 1
        else:
            nb = _lower(bld, op, w, x0, x1,
                        bits[a0] if a0 >= 0 else None,
                        bits[a1] if a1 >= 0 else None,
                        bits[a2] if a2 >= 0 else None)
            if node in node_known:
                # implied output-bit facts: assert the harvested known
                # bits directly on the gate outputs (units that drive
                # propagation); unpinned bits become decisions when
                # this node was chosen as a summary source
                known, kv = node_known[node]
                summ = node in decide_summ
                for i in range(w):
                    b = nb[i]
                    if (known >> i) & 1:
                        want = bool((kv >> i) & 1)
                        if isinstance(b, bool):
                            if b != want:
                                out.verdict = "unsat"
                                return out
                        else:
                            bld.add(b if want else b ^ 1)
                    elif summ and not isinstance(b, bool):
                        out.dec_vars.append(b >> 1)
        bits.append(nb)
    # summary sources can alias gate vars already decided elsewhere
    out.dec_vars = list(dict.fromkeys(out.dec_vars))

    for i, root in enumerate(tape.roots):
        if i not in kept:
            continue
        bld.assert_true(bits[root][0])
        if out.verdict is not None:
            return out
    return out


def _lower(bld: _Builder, op: int, w: int, x0: int, x1: int,
           A: Optional[List], B: Optional[List], C: Optional[List]
           ) -> List:
    """Tseitin-lower one tape record; raises Unsupported outside the
    narrow fragment (division, symbolic shifts, symbolic multiply)."""
    if op == OP_EQ:
        return [bld.w_eq(A, B)]
    if op == OP_AND:
        return [bld.land(A[0], B[0])]
    if op == OP_OR:
        return [bld.lor(A[0], B[0])]
    if op == OP_NOT:
        return [bld.neg(A[0])]
    if op == OP_XOR:
        return [bld.lxor(A[0], B[0])]
    if op == OP_ITE:
        return [bld.lmux(A[0], B[i], C[i]) for i in range(w)]
    if op == OP_ADD:
        return bld.w_add(A, B)[0]
    if op == OP_SUB:
        return bld.w_sub(A, B)[0]
    if op == OP_BAND:
        return [bld.land(a, b) for a, b in zip(A, B)]
    if op == OP_BOR:
        return [bld.lor(a, b) for a, b in zip(A, B)]
    if op == OP_BXOR:
        return [bld.lxor(a, b) for a, b in zip(A, B)]
    if op == OP_BNOT:
        return bld.w_not(A)
    if op == OP_NEG:
        return bld.w_add(bld.w_not(A), [_FALSE] * w, _TRUE)[0]
    if op == OP_MUL:
        ca, cb = _const_int(A), _const_int(B)
        if ca is None and cb is None:
            raise Unsupported("devsolver: symbolic multiply")
        k, v = (A, cb) if cb is not None else (B, ca)
        acc = [_FALSE] * w
        for i in range(w):
            if (v >> i) & 1:
                shifted = [_FALSE] * i + k[: w - i]
                acc = bld.w_add(acc, shifted)[0]
        return acc
    if op in (OP_SHL, OP_LSHR, OP_ASHR):
        s = _const_int(B)
        if s is None:
            raise Unsupported("devsolver: symbolic shift")
        if op == OP_SHL:
            return ([_FALSE] * s + A[: w - s]) if s < w else [_FALSE] * w
        if op == OP_LSHR:
            return (A[s:] + [_FALSE] * s) if s < w else [_FALSE] * w
        # ashr: matches concrete_eval (shift clamped to w-1, sign fill)
        s = min(s, w - 1)
        return A[s:] + [A[-1]] * s
    if op == OP_CONCAT:
        return B + A  # low part is B (width w - len(A)), high part A
    if op == OP_EXTRACT:
        return A[x1:x1 + w]
    if op == OP_ZEXT:
        return A + [_FALSE] * (w - len(A))
    if op == OP_SEXT:
        return A + [A[-1]] * (w - len(A))
    if op == OP_ULT:
        return [bld.w_ult(A, B)]
    if op == OP_ULE:
        return [bld.neg(bld.w_ult(B, A))]
    if op == OP_SLT:
        return [bld.w_slt(A, B)]
    if op == OP_SLE:
        return [bld.neg(bld.w_slt(B, A))]
    raise Unsupported("devsolver: op %d" % op)


def model_bytes(blasted: Blasted, assign_row) -> bytes:
    """Pack a kernel assignment into ``bitblast._rebuild_assignment``'s
    model wire format: per OP_VAR node in tape order, ``(w+7)//8``
    little-endian bytes.  Unassigned CNF variables read as 0 — any
    extension of an all-clauses-satisfied partial assignment is a model,
    and host validation is the final authority either way."""
    out = bytearray()
    for refs in blasted.var_bits:
        v = 0
        for i, (kind, payload) in enumerate(refs):
            if kind == "c":
                bit = payload
            else:
                bit = 1 if int(assign_row[payload]) == 1 else 0
            v |= bit << i
        out += v.to_bytes((len(refs) + 7) // 8, "little")
    return bytes(out)
