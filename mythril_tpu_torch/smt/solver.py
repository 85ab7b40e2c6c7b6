"""Constraint solving without Z3: the probe tiers, ported to PyTorch.

The port's counterpart of ``mythril_tpu/smt/solver.py``, carrying the tiers
this slice runs:

  tier 0    eager constant folding (terms.py), the per-conjunct-set result
            memo and tier 0.5, recent-model replay;
  tier 0.55 a few directed candidates for sat-biased queries;
  tier 0.6  interval-bound refutation (intervals.py) — exact UNSAT;
  tier 0.75 the independence split;
  tier 1    directed probing: the candidate generator (seeded
            ``random.Random(config.rng_seed)`` host Python, so it yields
            the same candidates as the JAX package) feeds one batched
            evaluation of the conjunction on the tape VM (the CUDA kernel
            on the card), then the exact host evaluator validates the hit;
            local repair mutates the best candidate.

``check_satisfiable_batch`` merges the residue of many constraint sets into
one tape and one dispatch (``_batch_probe_device``).  A SAT answer always
carries a model that ``concrete_eval`` validated.

Not in this slice: the cross-run query cache, the abstract pre-filter, the
device bit-blast tier and native CDCL (an UNKNOWN stays UNKNOWN).  A kernel
error raises; there is no host fallback that would hide the card.  A
conjunction the tape cannot express (``TapeUnsupported``) is evaluated on
the host candidate stream and counted as ``tape_unsupported``.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from mythril_tpu_torch.device import DeviceLike, resolve
from mythril_tpu_torch.exceptions import UnsatError
from mythril_tpu_torch.smt import terms
from mythril_tpu_torch.smt.concrete_eval import ArrayValue, Assignment, evaluate
from mythril_tpu_torch.smt.terms import Term, mask
from mythril_tpu_torch.support.support_args import PROBE_BACKENDS
from mythril_tpu_torch.support.support_args import args as global_args

log = logging.getLogger(__name__)

SAT = "sat"
UNSAT = "unsat"
UNKNOWN = "unknown"


# ---------------------------------------------------------------------------
# Statistics
# ---------------------------------------------------------------------------


class SolverStatistics:
    """Process-wide solver counters (singleton).

    ``tape_unsupported`` counts conjunctions the tape VM could not express,
    whose candidates were evaluated on the host instead;
    ``device_dispatches`` counts tape evaluations of candidate batches."""

    _instance = None
    _fields = (
        "query_count", "solver_time", "probe_hits", "unknown_as_unsat",
        "tape_unsupported", "device_dispatches",
    )

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
            cls._instance._lock = threading.Lock()
            cls._instance.reset()
        return cls._instance

    def inc(self, attr: str, n=1) -> None:
        with self._lock:
            setattr(self, attr, getattr(self, attr) + n)

    def reset(self) -> None:
        for name in self._fields:
            setattr(self, name, 0.0 if name == "solver_time" else 0)

    def as_dict(self) -> dict:
        return {name: getattr(self, name) for name in self._fields}

    def __repr__(self):
        return "Solver statistics: " + ", ".join(
            f"{k}: {v}" for k, v in self.as_dict().items()
        )


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


class Model:
    """A satisfying assignment; eval() reifies any expression under it.

    Reference counterpart: mythril/laser/smt/model.py — but there is exactly
    one backing assignment here (no multi-model merging needed: the
    independence-split solver evaluates the joint assignment directly).
    """

    def __init__(self, assignment: Assignment):
        self.assignment = assignment

    def eval(self, expr, model_completion: bool = True):
        raw = expr.raw if hasattr(expr, "raw") else expr
        return evaluate([raw], self.assignment)[raw]

    def decls(self):
        return list(self.assignment.scalars.keys())


# ---------------------------------------------------------------------------
# Directed value propagation
# ---------------------------------------------------------------------------


class _PartialBits:
    """Per-variable partially-known bits (strong hints from equalities;
    the first directed hint for a bit wins)."""

    __slots__ = ("known", "value", "width")

    def __init__(self, width: int):
        self.known = 0
        self.value = 0
        self.width = width

    def set_bits(self, bitmask: int, bits: int) -> None:
        new = bitmask & ~self.known
        self.known |= new
        self.value |= bits & new

    def complete(self, fill: int) -> int:
        return (self.value & self.known) | (fill & ~self.known & ((1 << self.width) - 1))


def _clone_bits(h: "_PartialBits") -> "_PartialBits":
    out = _PartialBits(h.width)
    out.known, out.value = h.known, h.value
    return out


class _Seeder:
    """Collects directed hints from equality constraints and constant pools.

    Disjunctions wanted true are collected as *choice groups*: each probe
    candidate commits to one disjunct per group (rotating with the candidate
    index), so constraints like ``caller == A ∨ caller == B ∨ caller == C``
    or selector alternations are solved by construction, not by luck.
    """

    def __init__(self, conjuncts: Sequence[Term], collect_groups: bool = True):
        self.conjuncts = conjuncts
        self.scalar_hints: Dict[Term, _PartialBits] = {}
        self.bool_hints: Dict[Term, bool] = {}
        # (array_var term, concrete index) -> byte/word hints
        self.array_hints: Dict[Tuple[Term, int], int] = {}
        # selects at COMPUTED indices (ABI dynamic-array head indirection:
        # ``calldataload(4 + calldataload(4))``): (base array, index term,
        # value); installed at candidate-build time by evaluating the index
        # under the partial assignment (two passes = one indirection level)
        self.dyn_array_hints: List[Tuple[Term, Term, int]] = []
        # (base array, (lo, hi)) byte runs acting as data POINTERS inside a
        # dyn index term; unconstrained ones are pre-seeded past the hinted
        # head region so indirect writes never alias the pointer itself
        self.dyn_preseed: List[Tuple[Term, Tuple[int, int]]] = []
        self.const_pool: List[int] = []
        # weak full-variable hints (inequality boundaries): max-combined so
        # e.g. repeated ``i < calldatasize`` reads push the size upward
        self.weak_vals: Dict[Term, int] = {}
        # symbolic-symbolic equalities (e.g. caller == sload(owner_slot)):
        # resolved at assignment-build time by copying the evaluated side
        self.link_pairs: List[Tuple[Term, Term]] = []
        # symbolic-symbolic unsigned orderings (lo, hi, bump): lo + bump
        # must not exceed hi (e.g. callvalue <= balances[sender], the
        # balance-transfer constraint every message call carries); repaired
        # at build time by raising hi (preferred) or lowering lo
        self.order_pairs: List[Tuple[Term, Term, int]] = []
        # disequalities (a, b) wanted different (JUMPI taken branches are
        # Not(cond == 0)); repaired at build time by flipping the low bit
        # of one side through the invertible-op machinery
        self.neq_pairs: List[Tuple[Term, Term]] = []
        self.or_groups: List[List[Term]] = []
        self._overlay_cache: Dict[tuple, "_Seeder"] = {}
        self._collect_groups = collect_groups
        self._harvest()
        self._propagate_all()
        self._analyze_dyn_hints()

    def overlay_for(self, candidate_index: int) -> "_Seeder":
        """Base hints + one committed disjunct per or-group.

        Disjunct combinations are enumerated mixed-radix over the candidate
        index so every combination is eventually committed, and overlays are
        memoized per combination (only prod(len(g)) distinct ones exist).
        """
        if not self.or_groups:
            return self
        choices = []
        div = 1
        for group in self.or_groups:
            choices.append((candidate_index // div) % len(group))
            div *= len(group)
        key = tuple(choices)
        cached = self._overlay_cache.get(key)
        if cached is not None:
            return cached
        clone = _Seeder.__new__(_Seeder)
        clone.conjuncts = self.conjuncts
        clone.scalar_hints = {
            t: _clone_bits(h) for t, h in self.scalar_hints.items()
        }
        clone.bool_hints = dict(self.bool_hints)
        clone.array_hints = dict(self.array_hints)
        clone.weak_vals = dict(self.weak_vals)
        clone.dyn_array_hints = list(self.dyn_array_hints)
        clone.dyn_preseed = list(self.dyn_preseed)
        clone.link_pairs = list(self.link_pairs)
        clone.order_pairs = list(self.order_pairs)
        clone.neq_pairs = list(self.neq_pairs)
        clone.const_pool = self.const_pool
        clone.or_groups = []
        clone._collect_groups = False
        clone._overlay_cache = {}
        for gi, group in enumerate(self.or_groups):
            clone._propagate_bool(group[choices[gi]], True)
        self._overlay_cache[key] = clone
        return clone

    # -- constant pool: every literal in the DAG is an interesting value
    def _harvest(self):
        pool = set()
        for t in terms.topo_order(self.conjuncts):
            if t.op == "const" and t.sort is not terms.BOOL:
                v = t.aux
                for cand in (v, v - 1, v + 1, (1 << t.sort[1]) - v if v else 0):
                    pool.add(mask(cand, 256))
        pool |= {0, 1, 2, (1 << 256) - 1, (1 << 255), (1 << 160) - 1}
        self.const_pool = sorted(pool)

    def _hint(self, t: Term) -> _PartialBits:
        h = self.scalar_hints.get(t)
        if h is None:
            h = _PartialBits(t.width)
            self.scalar_hints[t] = h
        return h

    def _propagate_all(self):
        for c in self.conjuncts:
            self._propagate_bool(c, True)

    def _propagate_bool(self, t: Term, want: bool):
        if t.op == "var" and t.sort is terms.BOOL:
            self.bool_hints.setdefault(t, want)
            return
        if t.op == "and" and want:
            for a in t.args:
                self._propagate_bool(a, True)
            return
        if t.op == "or" and not want:
            for a in t.args:
                self._propagate_bool(a, False)
            return
        if t.op == "or" and want:
            if self._collect_groups:
                self.or_groups.append(list(t.args))
            else:
                self._propagate_bool(t.args[0], True)
            return
        if t.op == "not":
            self._propagate_bool(t.args[0], not want)
            return
        if t.op == "ite":
            # make the condition pick the branch that can satisfy `want`
            c, a, b = t.args
            if a.op == "const" and bool(a.aux) == want:
                self._propagate_bool(c, True)
                return
            if b.op == "const" and bool(b.aux) == want:
                self._propagate_bool(c, False)
                return
            return
        if t.op == "eq":
            a, b = t.args
            if not terms.is_bv_sort(a.sort):
                return
            if want:
                if a.is_const:
                    self._propagate_value(b, a.value)
                elif b.is_const:
                    self._propagate_value(a, b.value)
                else:
                    self.link_pairs.append((a, b))
            elif not (a.is_const and b.is_const):
                self.neq_pairs.append((a, b))
            return
        # Inequalities: lower bounds push the variable just past the bound;
        # upper bounds hint zero (weak hints max-combine, so lower bounds win
        # over the zero default and minimization-style caps stay harmless).
        if t.op in ("ult", "ule", "slt", "sle"):
            a, b = t.args
            if not want and t.op in ("ult", "ule"):
                # Not(a < b) == b <= a; Not(a <= b) == b < a
                bump = 1 if t.op == "ule" else 0
                if not (a.is_const and b.is_const):
                    self.order_pairs.append((b, a, bump))
                return
            if want and a.is_const and not b.is_const:
                # strict bounds need bound+1; non-strict are satisfied at the
                # bound itself (and must not wrap for an all-ones bound)
                bump = 1 if t.op in ("ult", "slt") else 0
                self._propagate_value(b, mask(a.value + bump, b.width), weak=True)
                if t.op in ("ult", "ule"):
                    # repairable at build time too: the weak hint dies inside
                    # non-invertible ops (``2^w <= mul(...)`` overflow bounds)
                    self.order_pairs.append((a, b, bump))
            elif want and not a.is_const:
                if b.is_const:
                    self._propagate_value(a, 0, weak=True)
                elif t.op in ("ult", "ule"):
                    # both sides symbolic: repairable ordering at build time.
                    # Plain VARIABLES on the low side keep the weak zero
                    # seed (call_value <= balance-chain constraints repair
                    # trivially at zero); computed terms do not — a zero
                    # hint through an ``idx < size`` bounds guard poisons
                    # the read index the repair satisfies by raising
                    # ``size`` instead.
                    if a.op == "var":
                        self._propagate_value(a, 0, weak=True)
                    self.order_pairs.append((a, b, 1 if t.op == "ult" else 0))
                else:
                    # signed orderings have no repair machinery: keep the
                    # weak zero seed as candidate guidance
                    self._propagate_value(a, 0, weak=True)

    def _analyze_dyn_hints(self) -> None:
        """Find pointer words inside computed-select index terms.

        A dyn index like ``bvadd(calldataload(4), 4+j)`` embeds const-index
        selects over the SAME array (the ABI head word holding the data
        offset).  Maximal runs of consecutive const indices are recorded as
        pointer words so candidate construction can pre-seed unconstrained
        ones to a canonical non-aliasing offset (solc would emit 0x20)."""
        if not self.dyn_array_hints:
            return
        seen_idx = set()
        seen_runs = set()
        for base, idx, _ in self.dyn_array_hints:
            if idx.tid in seen_idx:
                continue
            seen_idx.add(idx.tid)
            const_reads = set()
            for t in terms.topo_order([idx]):
                if t.op == "select" and t.args[1].is_const:
                    b = t.args[0]
                    while b.op == "store":
                        b = b.args[0]
                    if b is base:
                        const_reads.add(t.args[1].value)
            if not const_reads:
                continue
            ordered = sorted(const_reads)
            start = prev = ordered[0]
            runs = []
            for v in ordered[1:]:
                if v == prev + 1:
                    prev = v
                    continue
                runs.append((start, prev))
                start = prev = v
            runs.append((start, prev))
            for run in runs:
                key = (base.tid, run)
                if key not in seen_runs:
                    seen_runs.add(key)
                    self.dyn_preseed.append((base, run))

    def _propagate_value(self, t: Term, value: int, weak: bool = False):
        """Push ``t == value`` down into leaves where ops are invertible."""
        width = t.width if terms.is_bv_sort(t.sort) else 1
        self._propagate_bits(t, mask(value, width), (1 << width) - 1, weak)

    def _propagate_bits(self, t: Term, value: int, claim: int, weak: bool):
        """Propagate ``t & claim == value & claim`` — only bits set in
        ``claim`` are actually constrained.  Shifts/masks narrow the claim
        instead of fabricating zero bits (a full-width claim through
        ``lshr(x, 224) == selector`` would wrongly pin the low 224 bits)."""
        if claim == 0:
            return
        full = (1 << t.width) - 1 if terms.is_bv_sort(t.sort) else 1
        claim &= full
        value &= claim
        if t.op == "var":
            if weak:
                if claim == full:
                    self.weak_vals[t] = max(self.weak_vals.get(t, 0), value)
            else:
                self._hint(t).set_bits(claim, value)
            return
        if t.op == "select":
            arr, idx = t.args
            base = arr
            while base.op == "store":
                base = base.args[0]
            if base.op == "array_var":
                if idx.is_const:
                    # partial claims (e.g. a bit test through a mask) still
                    # make a useful hint: unclaimed bits default to zero
                    self.array_hints.setdefault((base, idx.value), value)
                else:
                    # computed index (Z3 array-theory territory, reference
                    # mythril/laser/smt/array.py:45-72): resolved against
                    # the partial assignment at candidate-build time
                    self.dyn_array_hints.append((base, idx, value))
            return
        if t.op == "ite":
            # steer toward the then-branch (calldata/memory models guard
            # every byte with a bounds check, ite(i < size, select, 0)) —
            # EXCEPT for WEAK zero propagation that the else-branch already
            # supplies (a zero byte behind an OOB guard): forcing such a
            # guard true would drag its bound (calldatasize) past explicit
            # caps like ``calldatasize <= 0x25``.  Strong claims keep full
            # steering: a selector equality's zero high bits legitimately
            # pin bytes AND their in-range guards.
            c, a, b = t.args
            if weak and b.is_const and (b.value & claim) == value:
                return
            self._propagate_bool(c, True)
            self._propagate_bits(a, value, claim, weak)
            return
        if t.op == "bvand":
            a, b = t.args
            for cst, other in ((a, b), (b, a)):
                if cst.is_const:
                    if value & ~cst.aux & claim:
                        return  # needs a 1 where the mask forces 0
                    self._propagate_bits(other, value, claim & cst.aux, weak)
                    return
            return
        if t.op == "bvor":
            a, b = t.args
            for cst, other in ((a, b), (b, a)):
                if cst.is_const:
                    if (value ^ cst.aux) & cst.aux & claim:
                        return  # needs a 0 where the mask forces 1
                    self._propagate_bits(other, value, claim & ~cst.aux, weak)
                    return
            return
        if t.op == "concat":
            hi, lo = t.args
            lw = lo.width
            self._propagate_bits(lo, value, claim, weak)
            self._propagate_bits(hi, value >> lw, claim >> lw, weak)
            return
        if t.op == "extract":
            hi_bit, lo_bit = t.aux
            self._propagate_bits(t.args[0], value << lo_bit, claim << lo_bit, weak)
            return
        if t.op == "zext":
            inner = t.args[0]
            iw = (1 << inner.width) - 1
            if value & ~iw:
                return  # impossible: high bits nonzero
            self._propagate_bits(inner, value, claim & iw, weak)
            return
        if t.op == "sext":
            inner = t.args[0]
            iw = (1 << inner.width) - 1
            self._propagate_bits(inner, value & iw, claim & iw, weak)
            return
        if t.op == "bvxor":
            a, b = t.args
            for c, x in ((a, b), (b, a)):
                if c.is_const:
                    self._propagate_bits(x, value ^ (c.value & claim), claim, weak)
                    return
            return
        if t.op == "bvnot":
            self._propagate_bits(t.args[0], ~value & claim, claim, weak)
            return
        if t.op == "bvshl":
            a, b = t.args
            if b.is_const:
                k = min(b.value, t.width)
                self._propagate_bits(a, value >> k, (claim >> k) & full, weak)
            return
        if t.op == "bvlshr":
            a, b = t.args
            if b.is_const:
                k = min(b.value, t.width)
                self._propagate_bits(a, (value << k) & full, (claim << k) & full, weak)
            return
        # arithmetic inversions are only exact on a full claim
        if claim != full:
            return
        if t.op == "bvadd":
            a, b = t.args
            if a.is_const:
                self._propagate_bits(b, mask(value - a.value, t.width), full, weak)
            elif b.is_const:
                self._propagate_bits(a, mask(value - b.value, t.width), full, weak)
            return
        if t.op == "bvsub":
            a, b = t.args
            if b.is_const:
                self._propagate_bits(a, mask(value + b.value, t.width), full, weak)
            elif a.is_const:
                self._propagate_bits(b, mask(a.value - value, t.width), full, weak)
            return
        if t.op == "bvmul":
            a, b = t.args
            for c, x in ((a, b), (b, a)):
                if c.is_const and c.value % 2 == 1:
                    inv = pow(c.value, -1, 1 << t.width)
                    self._propagate_bits(x, mask(value * inv, t.width), full, weak)
                    return
            return
        if t.op == "ite":
            # try to make the then-branch produce the value
            c, a, b = t.args
            self._propagate_bool(c, True)
            self._propagate_bits(a, value, claim, weak=True)
            return

# ---------------------------------------------------------------------------
# The probe solver
# ---------------------------------------------------------------------------


class ProbeConfig:
    def __init__(
        self,
        max_rounds: int = 4,
        candidates_per_round: int = 48,
        timeout_ms: int = 10_000,
        rng_seed: int = 0x5EED,
        prune_critical: bool = False,
        sat_biased: bool = False,
    ):
        self.max_rounds = max_rounds
        self.candidates_per_round = candidates_per_round
        self.timeout_ms = timeout_ms
        self.rng_seed = rng_seed
        # sat-biased queries (successor pruning, mutation-pruner sweeps) are
        # overwhelmingly satisfiable: a handful of directed candidates is
        # tried BEFORE the exact-UNSAT interval tier and the independence
        # split, so the common SAT answer skips their per-query DAG walks
        self.sat_biased = sat_biased
        # prune-critical queries (is_possible, frontier/batch pruning) kill
        # paths on UNSAT: the exact CDCL tier is guaranteed a time slice even
        # when the probe burned the whole deadline, so an UNKNOWN-driven
        # prune only happens when the exact tier genuinely ran out of road
        self.prune_critical = prune_critical


class CandidateGenerator:
    """Directed candidate construction for one conjunction.

    Wraps the _Seeder hint machinery (constant pools, bit hints, or-group
    overlays, symbolic-equality links) behind a simple ``generate(n)`` so
    both the single-query probe (solve_conjunction) and the frontier-batched
    prune (check_satisfiable_batch) build candidates the same way.
    """

    def __init__(self, conjuncts: Sequence[Term], config: "ProbeConfig"):
        self.conjuncts = list(conjuncts)
        free = terms.free_vars(self.conjuncts)
        self.scalar_vars = [v for v in free if v.op == "var"]
        self.array_vars = [v for v in free if v.op == "array_var"]
        self.seeder = _Seeder(self.conjuncts)
        self.rng = random.Random(config.rng_seed)
        self._fill_iter = _interesting_fills(
            self.rng, self.seeder.const_pool, 256
        )
        self._index = 0

    def generate(
        self, n: int, deadline: Optional[float] = None
    ) -> List[Assignment]:
        out = []
        for _ in range(n):
            if out and deadline is not None and time.perf_counter() > deadline:
                break
            out.append(self._build(self._index))
            self._index += 1
        return out

    def _build(self, candidate_index: int) -> Assignment:
        s = self.seeder.overlay_for(candidate_index)
        rng = self.rng
        use_weak = candidate_index % 3 != 2  # periodically explore past weak hints
        asg = Assignment()
        for v in self.scalar_vars:
            if v.sort is terms.BOOL:
                asg.scalars[v] = s.bool_hints.get(v, rng.random() < 0.5)
                continue
            hint = s.scalar_hints.get(v)
            if use_weak and v in s.weak_vals and (hint is None or hint.known == 0):
                fill = s.weak_vals[v]
            else:
                fill = next(self._fill_iter)
            if hint is not None:
                asg.scalars[v] = hint.complete(mask(fill, v.width))
            else:
                asg.scalars[v] = mask(fill, v.width)
        # every third candidate salts unhinted array reads: zero defaults
        # collapse distinct symbolic reads onto one value (array elements
        # hashing to the SAME storage slot), hiding distinctness models.
        # The salted SUBSET rotates per candidate — salting calldata makes
        # receiver keys distinct, while storage usually must keep its
        # zero default (fresh balances) for the same model to validate.
        salt_base = candidate_index + 1 if candidate_index % 3 == 1 else 0
        for k, av in enumerate(self.array_vars):
            backing = {
                idx: val for (a, idx), val in s.array_hints.items() if a is av
            }
            range_bits = av.sort[2] if len(av.sort) > 2 else 0
            salted = (
                salt_base
                if salt_base and ((candidate_index >> (k % 6)) & 1)
                else 0
            )
            asg.arrays[av] = ArrayValue(
                backing, default=0, salt=salted, range_bits=range_bits
            )
        self._apply_links(s, asg)
        self._apply_neq_pairs(s, asg)
        self._preseed_pointers(s, asg)
        self._apply_order_pairs(s, asg)
        self._apply_dyn_hints(s, asg)
        if s.dyn_array_hints:
            # indirect writes move evaluated indices (size guards, balance
            # orderings): repair orderings once more against the final state
            self._apply_order_pairs(s, asg)
        return asg

    @staticmethod
    def _preseed_pointers(s, asg: Assignment) -> None:
        """Give unconstrained pointer words a canonical non-aliasing value.

        For every pointer run found by ``_Seeder._analyze_dyn_hints``: if no
        byte of the run carries a hint or backing yet, write the first
        32-aligned offset past every hinted byte (big-endian into the run).
        This is the ABI-canonical shape — the dynamic data region starts
        after the argument head — and keeps the indirect write from landing
        on the pointer itself (off=0 would alias ``cnt`` with ``off``)."""
        if not s.dyn_preseed:
            return
        hi_water_by_arr: Dict[int, int] = {}
        for (arr, k) in s.array_hints:
            tid = arr.tid
            hi_water_by_arr[tid] = max(hi_water_by_arr.get(tid, 0), k)
        for base, (lo, hi) in s.dyn_preseed:
            backing = asg.arrays.setdefault(base, ArrayValue()).backing
            if any((base, k) in s.array_hints for k in range(lo, hi + 1)):
                continue
            if any(k in backing for k in range(lo, hi + 1)):
                continue  # link/force-written bytes (even zeros) are pinned
            hi_water = max(hi_water_by_arr.get(base.tid, 0), hi)
            ptr = ((hi_water + 32) // 32) * 32
            nbytes = hi - lo + 1
            if ptr.bit_length() > 8 * nbytes:
                continue
            for i, byte in enumerate(int(ptr).to_bytes(nbytes, "big")):
                backing.setdefault(lo + i, byte)

    @staticmethod
    def _apply_dyn_hints(s, asg: Assignment) -> None:
        """Install computed-index select hints (one indirection level).

        Each pass evaluates every index term under the current assignment
        and writes the hinted value at the resolved index (first write
        wins).  Two passes: pass one may move an index term's own inputs
        (e.g. writing the array length that a later read's index depends
        on), pass two lands the dependent hints."""
        if not s.dyn_array_hints:
            return
        idx_terms = [idx for _, idx, _ in s.dyn_array_hints]
        for _ in range(2):
            try:
                vals = evaluate(idx_terms, asg)
            except NotImplementedError:
                return
            changed = False
            for arr, idx, value in s.dyn_array_hints:
                backing = asg.arrays.setdefault(arr, ArrayValue()).backing
                iv = vals[idx]
                if iv not in backing:
                    backing[iv] = value
                    changed = True
            if not changed:
                return

    def _apply_neq_pairs(self, s, asg: Assignment) -> None:
        """Repair violated disequalities by flipping the low bit of one side
        through the invertible-op machinery (a != b is almost always a taken
        JUMPI branch, Not(cond == 0)).  All sides evaluate in ONE DAG walk —
        per-pair walks dominated candidate-build time on wide frontiers."""
        if not s.neq_pairs:
            return
        sides = [t for pair in s.neq_pairs for t in pair]
        try:
            vals = evaluate(sides, asg)
        except NotImplementedError:
            return
        for a, b in s.neq_pairs:
            if vals[a] != vals[b]:
                continue
            target = b if a.is_const else a
            self._force_value(target, mask(vals[target] ^ 1, target.width), asg)

    @staticmethod
    def _force_value(expr, desired: int, asg: Assignment) -> None:
        """Best-effort: drive ``expr`` toward ``desired`` by writing the
        scalar/array leaves the invertible-op propagation reaches."""
        tmp = _Seeder((), collect_groups=False)  # empty: a bare collector
        tmp._propagate_value(expr, desired)
        for v, hint in tmp.scalar_hints.items():
            if hint.known:
                asg.scalars[v] = hint.complete(asg.scalars.get(v, 0) or 0)
        for (arr, idx), val in tmp.array_hints.items():
            asg.arrays.setdefault(arr, ArrayValue()).backing[idx] = val
        if tmp.dyn_array_hints:
            idx_terms = [idx for _, idx, _ in tmp.dyn_array_hints]
            try:
                vals = evaluate(idx_terms, asg)
            except NotImplementedError:
                vals = None
            if vals is not None:
                for arr, idx, val in tmp.dyn_array_hints:
                    asg.arrays.setdefault(arr, ArrayValue()).backing[
                        vals[idx]
                    ] = val
        for v, bound in tmp.weak_vals.items():
            cur = asg.scalars.get(v, 0)
            if isinstance(cur, int) and cur < bound:
                asg.scalars[v] = bound

    @staticmethod
    def _link_target(t):
        """(kind, ...) if ``t`` is directly assignable in a candidate."""
        if t.op == "var" and t.sort is not terms.BOOL:
            return ("var", t)
        if t.op == "select" and t.args[0].op == "array_var" and t.args[1].is_const:
            return ("sel", t.args[0], t.args[1].value)
        return None

    @staticmethod
    def _dyn_target(t):
        """Like _link_target but also accepts a select whose key is any
        evaluable term (resolved against the assignment at write time) —
        e.g. ``balances[sender]`` with a symbolic sender."""
        info = CandidateGenerator._link_target(t)
        if info is not None:
            return info
        if t.op == "select" and t.args[0].op == "array_var":
            return ("dynsel", t.args[0], t.args[1])
        return None

    def _apply_order_pairs(self, s, asg: Assignment) -> None:
        """Repair violated symbolic orderings (lo + bump <= hi) by raising
        the upper side — writing through a var or an array cell whose key
        evaluates under the assignment — else lowering the lower side."""
        if not s.order_pairs:
            return
        sides = [t for lo, hi, _ in s.order_pairs for t in (lo, hi)]
        try:
            vals = evaluate(sides, asg)
        except NotImplementedError:
            return
        for lo, hi, bump in s.order_pairs:
            lo_v, hi_v = vals[lo], vals[hi]
            if lo_v + bump <= hi_v:
                continue
            hi_max = (1 << hi.width) - 1
            target = self._dyn_target(hi)
            if target is not None and lo_v + bump <= hi_max:
                self._dyn_write(target, lo_v + bump, asg, raise_only=True)
                continue
            if (
                hi.op == "bvmul"
                and lo_v + bump <= hi_max
                and self._raise_product(hi, lo_v + bump, asg)
            ):
                # product bound (overflow predicates: Not(BVMulNoOverflow)
                # is ``2^w <= mul(zext a, zext b)``): raise one FACTOR so
                # the product clears the bound — exact host arithmetic,
                # where the bit-blasted 2w-bit multiply is hopeless
                continue
            target = self._dyn_target(lo)
            if target is not None and hi_v >= bump:
                self._dyn_write(target, hi_v - bump, asg)

    def _raise_product(self, mul_term, target: int, asg: Assignment) -> bool:
        """Drive ``mul(x, y) >= target`` by forcing one factor to
        ceil(target / other) through the invertible-op write machinery.
        The side is randomized across candidates so a factor pinned by
        other constraints (a loop count with ``cnt <= 20``) gets the small
        role in half the attempts.  Returns False when nothing was written
        (caller falls back to lowering the other side of the pair)."""
        factors = [
            a.args[0] if a.op in ("zext", "sext") else a
            for a in mul_term.args[:2]
        ]
        try:
            vals = evaluate(factors, asg)
        except NotImplementedError:
            return False
        x, y = factors
        if self.rng.random() < 0.5:
            x, y = y, x
        base = vals[y]
        # the bound may exceed what x alone can supply (both factors at 1
        # for a 2^w overflow target): bump y to the SMALLEST value whose
        # cofactor fits in x — e.g. cnt=2, value=2^(w-1), respecting a tight
        # range constraint on y that a blunt 2^(w/2) split would violate
        min_base = -(-target // ((1 << x.width) - 1))
        if base < min_base:
            if min_base.bit_length() > y.width:
                return False
            self._force_value(y, min_base, asg)
            base = min_base
        need = -(-target // base)  # ceil
        if need.bit_length() > x.width:
            return False
        self._force_value(x, need, asg)
        return True

    @staticmethod
    def _dyn_write(
        info, value: int, asg: Assignment, raise_only: bool = False
    ) -> None:
        """``raise_only``: keep a larger already-written value (a batch of
        ``idx < size`` guards repaired in one sweep must leave ``size``
        above the LARGEST index, not whichever pair happened to come last)."""
        if info[0] == "var":
            cur = asg.scalars.get(info[1])
            if raise_only and isinstance(cur, int) and cur >= value:
                return
            asg.scalars[info[1]] = value
        elif info[0] == "sel":
            backing = asg.arrays.setdefault(info[1], ArrayValue()).backing
            cur = backing.get(info[2])
            if raise_only and isinstance(cur, int) and cur >= value:
                return
            backing[info[2]] = value
        else:  # dynsel: resolve the key against the current assignment
            try:
                key_v = evaluate([info[2]], asg)[info[2]]
            except NotImplementedError:
                return
            backing = asg.arrays.setdefault(info[1], ArrayValue()).backing
            cur = backing.get(key_v)
            if raise_only and isinstance(cur, int) and cur >= value:
                return
            backing[key_v] = value

    def _apply_links(self, s, asg: Assignment) -> None:
        """Copy evaluated values across symbolic equalities (two passes).

        Direction-aware: the determined side (strong hint, array hint, or a
        value written by an earlier link) is the source; the undetermined
        side is the target.  Both-determined pairs are left alone so
        constant-derived hints are never clobbered.
        """
        if not s.link_pairs:
            return
        written: set = set()
        link_target = self._link_target

        def determined(t) -> Optional[tuple]:
            info = link_target(t)
            if info is None:
                return ("expr",)  # complex expression: can only be a source
            if info[0] == "var":
                hint = s.scalar_hints.get(info[1])
                if (hint is not None and hint.known) or info[1] in written:
                    return ("set",)
                return None
            key = (info[1], info[2])
            if key in s.array_hints or key in written:
                return ("set",)
            return None

        def write(target, value) -> None:
            info = link_target(target)
            if info[0] == "var":
                asg.scalars[info[1]] = value
                written.add(info[1])
            else:
                asg.arrays.setdefault(info[1], ArrayValue()).backing[info[2]] = value
                written.add((info[1], info[2]))

        for _ in range(2):
            for a, b in s.link_pairs:
                da, db = determined(a), determined(b)
                if da is not None and db is None:
                    target, source = b, a
                elif db is not None and da is None:
                    target, source = a, b
                elif da is None and db is None:
                    target, source = a, b  # arbitrary: propagate left from right
                else:
                    continue  # both determined (or both unassignable)
                try:
                    value = evaluate([source], asg)[source]
                except NotImplementedError:
                    continue
                write(target, value)


def _interesting_fills(rng: random.Random, pool: Sequence[int], width: int):
    """Yield an endless stream of fill values for unknown bits."""
    yield 0
    yield (1 << width) - 1
    for v in pool:
        yield v
    while True:
        choice = rng.random()
        if choice < 0.35 and pool:
            yield rng.choice(pool)
        elif choice < 0.55:
            yield rng.getrandbits(8)
        elif choice < 0.75:
            # sparse random: few set bytes
            v = 0
            for _ in range(rng.randint(1, 4)):
                v |= rng.getrandbits(8) << (8 * rng.randint(0, max(0, width // 8 - 1)))
            yield v
        else:
            yield rng.getrandbits(width)


def independence_split(conjuncts: Sequence[Term]) -> List[List[Term]]:
    """Partition a conjunction into variable-independent buckets.

    Reference parity: the IndependenceSolver's shared-variable union-find
    (mythril/laser/smt/solver/independence_solver.py:38-83).  Buckets share
    no free variables, so they are solved separately and their models merged
    — each bucket is a smaller probe/CDCL instance, and per-bucket memoization
    means an engine query that extends one bucket leaves every other bucket's
    cached verdict intact.  Deterministic: buckets ordered by first conjunct.

    Memoized per conjunct set: a wide frontier poses hundreds of sibling
    queries per harvest and the union-find over the shared DAG was measured
    at ~20% of their solve time.
    """
    conjuncts = list(conjuncts)
    memo_key = frozenset(t.tid for t in conjuncts)
    hit = _split_cache.get(memo_key)
    if hit is not None:
        return hit
    # union-find over CONJUNCT indices
    parent = list(range(len(conjuncts)))

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(a: int, b: int) -> None:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb

    # ONE global pass over the shared DAG: compute per-node "contains a free
    # variable", and reject uninterpreted functions — they couple buckets
    # through congruence even without shared variables (two buckets may
    # assign f the same input different outputs).  keccak is safe: it
    # evaluates concretely, so per-bucket models are globally consistent.
    dag = terms.topo_order(conjuncts)
    has_var: Dict[int, bool] = {}
    for t in dag:
        if t.op == "apply":
            _split_remember(memo_key, [conjuncts])
            return [conjuncts]
        has_var[t.tid] = t.op in ("var", "array_var") or any(
            has_var[a.tid] for a in t.args
        )

    # ONE ownership sweep: each variable-bearing node is claimed by the
    # first conjunct to reach it; later conjuncts stop at claimed nodes and
    # union with the owner, so every node is descended into at most once
    # across ALL conjuncts (shared path prefixes are not re-traversed).
    owner: Dict[int, int] = {}
    for ci, c in enumerate(conjuncts):
        stack = [c]
        while stack:
            t = stack.pop()
            if not has_var[t.tid]:
                continue
            prev = owner.get(t.tid)
            if prev is not None:
                union(ci, prev)
                continue
            owner[t.tid] = ci
            stack.extend(t.args)

    buckets: Dict[Optional[int], List[Term]] = {}
    order: List[Optional[int]] = []
    for ci, c in enumerate(conjuncts):
        key = find(ci) if has_var[c.tid] else None
        if key not in buckets:
            buckets[key] = []
            order.append(key)
        buckets[key].append(c)
    result = [buckets[k] for k in order]
    _split_remember(memo_key, result)
    return result


_split_cache: Dict[frozenset, tuple] = {}

# guards the compound mutations of the shared solver memos (_split_cache,
# _ModelCache) against feasibility-pool worker threads; plain dict reads
# stay lock-free (atomic under the GIL, and a stale miss is harmless)
_cache_lock = threading.Lock()


def _split_remember(key: frozenset, result: List[List[Term]]) -> None:
    with _cache_lock:
        if len(_split_cache) >= 4096:
            _split_cache.clear()
        # tuples of tuples: the cache is shared, so accidental mutation by a
        # future caller raises instead of corrupting unrelated queries
        _split_cache[key] = tuple(tuple(group) for group in result)


# ---------------------------------------------------------------------------
# Device dispatch
# ---------------------------------------------------------------------------


def _device_backend_requested() -> bool:
    """Whether candidate batches are evaluated on the tape VM.

    ``args.probe_backend``: "device" always (the JAX package's forced "jax"
    backend), "host" never."""
    backend = global_args.probe_backend
    if backend not in PROBE_BACKENDS:
        raise ValueError(f"probe_backend must be one of {PROBE_BACKENDS}, got {backend!r}")
    return backend == "device"


def _try_compile_device(conjuncts: Sequence[Term]):
    """The tape for a conjunction, or None when the tape cannot express it
    (the candidates are then evaluated on the host)."""
    from mythril_tpu_torch.ops import tape_vm

    try:
        return tape_vm.compile_tape(conjuncts)
    except tape_vm.TapeUnsupported as e:
        log.debug("tape VM unsupported (%s); host candidate stream", e)
        SolverStatistics().inc("tape_unsupported")
        return None


def _evaluate_candidates_device(compiled, candidates, device):
    """One dispatch over all candidates -> truth [len(candidates), C] bool."""
    SolverStatistics().inc("device_dispatches")
    return compiled.evaluate_batch(candidates, device)


def _fast_path(
    conjuncts: Sequence[Term], use_cache: bool = True, replay: bool = True,
) -> Tuple[Optional[Tuple[str, Optional["Assignment"]]], List[Term], frozenset]:
    """Cheap solving tiers shared by single-query and batched entry points.

    Tier 0 (structural fold), result memo and tier 0.5 (recent-model
    replay).  Returns ``(resolved, folded_conjuncts, cache_key)`` where
    ``resolved`` is the final (status, assignment) when a cheap tier
    decided the query, else None.
    """
    folded = terms.land(*conjuncts)
    if folded.op == "const":
        if folded.aux:
            return (SAT, Assignment()), [], frozenset()
        return (UNSAT, None), [], frozenset()
    conj = list(folded.args) if folded.op == "and" else [folded]
    key = frozenset(c.tid for c in conj)
    if use_cache:
        hit = _model_cache.results.get(key)
        if hit is not None:
            return hit, conj, key
    if use_cache and replay:
        # replay only the freshest models: each miss costs a full DAG
        # evaluation, and hits overwhelmingly come from the last few
        # (sibling queries extend the immediately preceding one)
        for asg in reversed(_model_cache.models[-_REPLAY_DEPTH:]):
            try:
                vals = evaluate(conj, asg)
            except Exception:
                continue
            if all(vals[c] for c in conj):
                SolverStatistics().inc("probe_hits")
                _model_cache.remember(key, SAT, asg)
                return (SAT, asg), conj, key
    return None, conj, key


def check_satisfiable_batch(
    constraint_sets: Sequence[Sequence[Term]],
    config: Optional["ProbeConfig"] = None,
    statuses_out: Optional[List[str]] = None,
    device: DeviceLike = None,
) -> List[bool]:
    """Frontier-batched pruning: decide many path conditions in one sweep.

    The engine hands over every successor state's constraint set per
    iteration; cheap tiers (structural fold, result memo, recent-model
    reuse) resolve most, and the residue is merged into ONE tape — sibling
    states share their whole path prefix, so the interned DAGs overlap
    almost entirely — evaluated over a shared candidate pool in a single
    dispatch.  Anything still undecided goes through the per-set probe
    stack.

    Returns one bool per input set (True = keep the state).  When
    ``statuses_out`` is given, one status string per set is appended to it:
    ``"sat"`` / ``"unsat"`` / ``"unknown"`` (a timeout decided
    unknown-as-unsat).  ``device``: None is the CUDA card (raises without
    one); pass ``"cpu"`` for the plain PyTorch path.
    """
    dev = resolve(device)
    config = config or ProbeConfig(
        max_rounds=2, candidates_per_round=24, timeout_ms=2000,
        prune_critical=True, sat_biased=True,
    )
    results: List[Optional[bool]] = [None] * len(constraint_sets)
    statuses: List[Optional[str]] = [None] * len(constraint_sets)
    pending: List[Tuple[int, List[Term], frozenset]] = []

    for i, cs in enumerate(constraint_sets):
        # per-set model replay is deferred: it is batched below over the
        # UNION of pending conjuncts (sibling sets share their whole path
        # prefix, so N separate replays re-walk the same DAG N times)
        resolved, conj, key = _fast_path(cs, replay=False)
        if resolved is not None:
            results[i] = resolved[0] == SAT
        else:
            pending.append((i, conj, key))

    if pending and _model_cache.models:
        union: List[Term] = []
        seen_tids: set = set()
        for _i, conj, _k in pending:
            for c in conj:
                if c.tid not in seen_tids:
                    seen_tids.add(c.tid)
                    union.append(c)
        for asg in reversed(_model_cache.models[-_REPLAY_DEPTH:]):
            try:
                vals = evaluate(union, asg)
            except Exception:
                # one unevaluable conjunct must not cost every sibling set its
                # cache hit: per-set replay for this model instead
                vals = None
            still = []
            for i, conj, key in pending:
                try:
                    if vals is None:
                        per_set = evaluate(conj, asg)
                        sat_here = all(per_set[c] for c in conj)
                    else:
                        sat_here = all(vals[c] for c in conj)
                except Exception:
                    still.append((i, conj, key))
                    continue
                if sat_here:
                    SolverStatistics().inc("probe_hits")
                    _model_cache.remember(key, SAT, asg)
                    results[i] = True
                else:
                    still.append((i, conj, key))
            pending = still
            if not pending:
                break

    # The merged dispatch pays off only when it amortizes over enough sets:
    # a 2-sibling fork goes through the per-set stack, >= 3 pending sets
    # take the single merged dispatch.
    if len(pending) >= 3 and _device_backend_requested():
        _batch_probe_device(pending, results, config, dev)

    for i, conj, _key in pending:
        if results[i] is None:
            # replay already happened batched above; don't repeat per set
            status, _ = solve_conjunction(conj, config, replay=False, device=dev)
            if status == UNKNOWN:
                SolverStatistics().inc("unknown_as_unsat")
                statuses[i] = "unknown"
            results[i] = status == SAT
    if statuses_out is not None:
        statuses_out.extend(
            s if s is not None else ("sat" if r else "unsat")
            for s, r in zip(statuses, results)
        )
    return [bool(r) for r in results]


def _batch_probe_device(pending, results, config, device) -> None:
    """One tape dispatch deciding several constraint sets at once."""
    # union of conjuncts in deterministic first-seen order
    all_conjs: List[Term] = []
    col_of: Dict[int, int] = {}
    for _i, conj, _key in pending:
        for c in conj:
            if c.tid not in col_of:
                col_of[c.tid] = len(all_conjs)
                all_conjs.append(c)
    compiled = _try_compile_device(all_conjs)
    if compiled is None:
        return  # the per-set stack decides every set

    per_set = max(8, (config.max_rounds * config.candidates_per_round) // max(1, len(pending)))
    candidates: List[Assignment] = []
    for _i, conj, _key in pending:
        candidates.extend(CandidateGenerator(conj, config).generate(per_set))
    truth = _evaluate_candidates_device(compiled, candidates, device)  # [B, C_total]

    for i, conj, key in pending:
        cols = [col_of[c.tid] for c in conj]
        rows = truth[:, cols].all(axis=1)
        for b in rows.nonzero()[0]:
            asg = candidates[int(b)]
            try:
                vals = evaluate(conj, asg)
            except Exception:
                continue
            if all(vals[c] for c in conj):
                SolverStatistics().inc("probe_hits")
                _model_cache.remember(key, SAT, asg)
                results[i] = True
                break


# how many recent models the cheap tiers replay per query (each miss costs
# a full DAG evaluation); _ModelCache retention matches this bound
_REPLAY_DEPTH = 6


class _ModelCache:
    """Incremental-solving stand-in: recently found models, tried first.

    Engine queries overwhelmingly *extend* a previous query by one conjunct,
    so a model of the prefix usually still satisfies the extension.  Exact
    results are also memoized per interned conjunct-set.
    """

    def __init__(self, max_models: int = _REPLAY_DEPTH, max_results: int = 4096):
        self.models: List[Assignment] = []
        self.results: Dict[frozenset, Tuple[str, Optional[Assignment]]] = {}
        self.max_models = max_models
        self.max_results = max_results

    def remember(self, key: frozenset, status: str, asg: Optional[Assignment]):
        with _cache_lock:
            if len(self.results) >= self.max_results:
                self.results = {}
            self.results[key] = (status, asg)
            if asg is not None:
                models = [m for m in self.models if m is not asg]
                models.append(asg)
                self.models = models[-self.max_models:]


_model_cache = _ModelCache()


def clear_model_cache() -> None:
    with _cache_lock:
        _model_cache.models = []
        _model_cache.results = {}
        _split_cache.clear()


def solve_conjunction(
    conjuncts: Sequence[Term],
    config: Optional[ProbeConfig] = None,
    extra_seeds: Optional[Sequence[Assignment]] = None,
    use_cache: bool = True,
    replay: bool = True,
    device: DeviceLike = None,
) -> Tuple[str, Optional[Assignment]]:
    """Core entry: find a model of And(conjuncts) or report unsat/unknown.

    ``use_cache=False`` skips both memo tiers.  ``device``: None is the CUDA
    card (raises without one); pass ``"cpu"`` for the plain PyTorch path.
    """
    return _solve_conjunction_impl(
        conjuncts, config or ProbeConfig(), extra_seeds, use_cache, replay,
        resolve(device),
    )


def _solve_conjunction_impl(
    conjuncts: Sequence[Term],
    config: ProbeConfig,
    extra_seeds: Optional[Sequence[Assignment]],
    use_cache: bool,
    replay: bool,
    device,
) -> Tuple[str, Optional[Assignment]]:
    stats = SolverStatistics()
    stats.inc("query_count")
    t0 = time.perf_counter()

    # tiers 0 + memo + 0.5 (shared with check_satisfiable_batch)
    resolved, conjuncts, cache_key = _fast_path(conjuncts, use_cache, replay)
    if resolved is not None:
        return resolved

    gen: Optional[CandidateGenerator] = None
    # tier 0.55 (sat-biased queries only): a few directed candidates before
    # any exact-UNSAT machinery — pruning sweeps are almost always SAT, and
    # the seeder's repair passes hit in 1-3 candidates
    if config.sat_biased:
        gen = CandidateGenerator(conjuncts, config)
        for asg in gen.generate(8, deadline=t0 + config.timeout_ms / 2000.0):
            vals = evaluate(conjuncts, asg)
            if all(vals[c] for c in conjuncts):
                stats.inc("probe_hits")
                if use_cache:
                    _model_cache.remember(cache_key, SAT, asg)
                stats.inc("solver_time", time.perf_counter() - t0)
                return SAT, asg

    # tier 0.6: interval-bound refutation — exact UNSAT for range-impossible
    # demands, at one linear DAG walk
    from mythril_tpu_torch.smt.intervals import refute as _interval_refute

    if _interval_refute(conjuncts):
        if use_cache:
            _model_cache.remember(cache_key, UNSAT, None)
        stats.inc("solver_time", time.perf_counter() - t0)
        return UNSAT, None

    # tier 0.75: independence split — disjoint-variable buckets solve
    # separately and merge their models
    buckets = independence_split(conjuncts)
    if len(buckets) > 1:
        whole_deadline = t0 + config.timeout_ms / 1000.0
        merged = Assignment()
        for bucket in buckets:
            # buckets share ONE query budget
            remaining_ms = max(1, int((whole_deadline - time.perf_counter()) * 1000))
            sub_config = ProbeConfig(
                max_rounds=config.max_rounds,
                candidates_per_round=config.candidates_per_round,
                timeout_ms=remaining_ms,
                rng_seed=config.rng_seed,
                prune_critical=config.prune_critical,
                sat_biased=config.sat_biased,
            )
            status, asg = _solve_conjunction_impl(
                bucket, sub_config, extra_seeds, use_cache, replay, device
            )
            if status == UNSAT:
                if use_cache:
                    _model_cache.remember(cache_key, UNSAT, None)
                return UNSAT, None
            if status != SAT or asg is None:
                return UNKNOWN, None
            # only the bucket's own free variables may contribute: a bucket
            # model may be a recycled full model from an earlier query
            bucket_vars = set(terms.free_vars(bucket))
            merged.scalars.update(
                {k: v for k, v in asg.scalars.items() if k in bucket_vars}
            )
            merged.arrays.update(
                {k: v for k, v in asg.arrays.items() if k in bucket_vars}
            )
        # a merged model must satisfy the WHOLE conjunction before it is
        # returned or memoized
        vals = evaluate(conjuncts, merged)
        if all(vals[c] for c in conjuncts):
            stats.inc("probe_hits")
            if use_cache:
                _model_cache.remember(cache_key, SAT, merged)
            return SAT, merged
        log.warning("independence-split merge produced an invalid model; "
                    "falling back to the joint probe")

    if gen is None:
        gen = CandidateGenerator(conjuncts, config)
    scalar_vars = gen.scalar_vars
    seeder = gen.seeder
    rng = gen.rng
    deadline = t0 + config.timeout_ms / 1000.0

    def check_asg(asg: Assignment) -> bool:
        vals = evaluate(conjuncts, asg)
        return all(vals[c] for c in conjuncts)

    candidates: List[Assignment] = []
    if extra_seeds:
        candidates.extend(extra_seeds)
    total = config.max_rounds * config.candidates_per_round

    # batched evaluation only when the deadline still has room
    compiled = (
        _try_compile_device(conjuncts)
        if _device_backend_requested() and time.perf_counter() < deadline
        else None
    )
    if compiled is not None:
        # the batched dispatch needs the whole pool upfront
        candidates.extend(gen.generate(total, deadline))

    best_asg, best_score = None, -1
    if compiled is not None:
        # every candidate in one dispatch, then host validation of the
        # winner; a kernel error raises (no host fallback)
        import numpy as _np

        truth = _evaluate_candidates_device(compiled, candidates, device)  # [B, C]
        scores = truth.sum(axis=1)
        for b in _np.argsort(-scores, kind="stable"):
            if scores[b] < len(conjuncts):
                break
            if check_asg(candidates[b]):
                stats.inc("probe_hits")
                stats.inc("solver_time", time.perf_counter() - t0)
                _model_cache.remember(cache_key, SAT, candidates[b])
                return SAT, candidates[b]
            if time.perf_counter() > deadline:
                break
        if len(candidates):
            b = int(_np.argmax(scores))
            best_score, best_asg = int(scores[b]), candidates[b]
    else:
        # host path: STREAM candidates — on well-hinted queries the first
        # directed build already satisfies
        def streamed():
            yield from candidates
            remaining = total - max(0, len(candidates) - len(extra_seeds or ()))
            for _ in range(max(0, remaining)):
                if time.perf_counter() > deadline:
                    return
                yield gen.generate(1)[0]

        for asg in streamed():
            try:
                vals = evaluate(conjuncts, asg)
            except NotImplementedError:
                continue
            score = sum(1 for c in conjuncts if vals[c])
            if score == len(conjuncts):
                stats.inc("probe_hits")
                stats.inc("solver_time", time.perf_counter() - t0)
                _model_cache.remember(cache_key, SAT, asg)
                return SAT, asg
            if score > best_score:
                best_score, best_asg = score, asg
            if time.perf_counter() > deadline:
                break

    # local repair: mutate the best candidate on vars feeding failed conjuncts
    if best_asg is not None and scalar_vars:
        for _ in range(64):
            if time.perf_counter() > deadline:
                break
            asg = Assignment(
                dict(best_asg.scalars),
                {k: ArrayValue(v.backing, v.default) for k, v in best_asg.arrays.items()},
            )
            v = rng.choice(scalar_vars)
            if v.sort is terms.BOOL:
                asg.scalars[v] = not asg.scalars.get(v, False)
            else:
                mode = rng.random()
                cur = asg.scalars.get(v, 0)
                if mode < 0.3:
                    asg.scalars[v] = mask(cur + rng.choice([1, -1, 2, -2, 32, -32]), v.width)
                elif mode < 0.6:
                    asg.scalars[v] = cur ^ (1 << rng.randint(0, v.width - 1))
                elif mode < 0.8 and seeder.const_pool:
                    asg.scalars[v] = mask(rng.choice(seeder.const_pool), v.width)
                else:
                    asg.scalars[v] = rng.getrandbits(v.width)
            vals = evaluate(conjuncts, asg)
            score = sum(1 for c in conjuncts if vals[c])
            if score == len(conjuncts):
                stats.inc("probe_hits")
                stats.inc("solver_time", time.perf_counter() - t0)
                _model_cache.remember(cache_key, SAT, asg)
                return SAT, asg
            if score >= best_score:
                best_score, best_asg = score, asg

    stats.inc("solver_time", time.perf_counter() - t0)
    return UNKNOWN, None


# ---------------------------------------------------------------------------
# Solver / Optimize facades
# ---------------------------------------------------------------------------


class Solver:
    """Incremental-style facade over ``solve_conjunction``.

    ``device``: None is the CUDA card (a check raises without one); pass
    ``"cpu"`` for the plain PyTorch path."""

    def __init__(self, config: Optional[ProbeConfig] = None, device: DeviceLike = None):
        # the default budget is the global flags', as mythril_tpu/support/model.py builds it
        self.config = config or ProbeConfig(
            max_rounds=global_args.probe_rounds,
            candidates_per_round=global_args.probe_candidates,
            timeout_ms=global_args.solver_timeout,
        )
        self.device = device
        self.constraints: List = []
        self._model: Optional[Model] = None

    def set_timeout(self, timeout_ms: int) -> None:
        self.config.timeout_ms = timeout_ms

    def add(self, *constraints) -> None:
        for c in constraints:
            if isinstance(c, (list, tuple)):
                self.constraints.extend(c)
            else:
                self.constraints.append(c)

    append = add

    def _raw_conjuncts(self) -> List[Term]:
        return [c.raw if hasattr(c, "raw") else c for c in self.constraints]

    def check(self, *extra) -> str:
        conj = self._raw_conjuncts() + [
            c.raw if hasattr(c, "raw") else c for c in extra
        ]
        status, asg = solve_conjunction(conj, self.config, device=self.device)
        self._model = Model(asg) if asg is not None else None
        return status

    def model(self) -> Model:
        if self._model is None:
            raise UnsatError("no model available (last check was not sat)")
        return self._model

    def reset(self) -> None:
        self.constraints = []
        self._model = None


class Optimize(Solver):
    """Objective optimization by bound search over the probe stack.

    Each objective is refined lexicographically: from any model, assert
    ``obj <= mid`` (or ``>=``) by binary search tightened by each new
    model's value; an UNSAT bound proves the optimum, which is pinned before
    the next objective.  Without an exact tier in this slice, a bound query
    that comes back UNKNOWN keeps the best model found so far — never worse
    than a plain check.
    """

    MAX_BOUND_STEPS = 48

    def __init__(self, config: Optional[ProbeConfig] = None, device: DeviceLike = None):
        super().__init__(config, device)
        self._minimize: List = []
        self._maximize: List = []
        # True after check() iff EVERY objective was refined to a PROVEN optimum
        self.proven_optimal = True

    def minimize(self, expr) -> None:
        self._minimize.append(expr.raw if hasattr(expr, "raw") else expr)

    def maximize(self, expr) -> None:
        self._maximize.append(expr.raw if hasattr(expr, "raw") else expr)

    def _refine(self, conj, obj, asg, deadline: float, want_min: bool):
        """Tighten one objective to its proven optimum (or best effort)."""
        width = obj.width
        top = (1 << width) - 1

        def cfg_step() -> ProbeConfig:
            # clamp each step to the remaining overall budget
            remaining_ms = max(1, int((deadline - time.perf_counter()) * 1000))
            return ProbeConfig(
                max_rounds=self.config.max_rounds,
                candidates_per_round=self.config.candidates_per_round,
                timeout_ms=min(max(1, self.config.timeout_ms // 4), remaining_ms),
                rng_seed=self.config.rng_seed,
            )

        def value(a) -> int:
            return evaluate([obj], a)[obj]

        def ask_op(op: str, v: int):
            c = terms.const(v, width)
            bt = {"le": terms.ule, "ge": terms.uge}.get(op, terms.eq)(obj, c)
            return solve_conjunction(conj + [bt], cfg_step(), device=self.device)

        best = value(asg)
        # fast path: the global optimum in one query
        target = 0 if want_min else top
        if best != target and time.perf_counter() < deadline:
            status, a2 = ask_op("eq", target)
            if status == SAT and a2 is not None:
                return a2, True
        steps = 0
        max_steps = self.MAX_BOUND_STEPS
        if want_min:
            lo, hi = 0, best
        else:
            # exponential-up first: doubling from the current model reaches
            # the optimum's magnitude in log2(opt) SAT steps
            lo, hi = best, top
            while lo < hi and steps < max_steps and time.perf_counter() < deadline:
                steps += 1
                probe_to = min(2 * best + 1, top)
                status, a2 = ask_op("ge", probe_to)
                if status == SAT and a2 is not None:
                    asg, best = a2, value(a2)
                    lo = best
                    if best >= top:
                        return asg, True
                elif status == UNSAT:
                    hi = probe_to - 1
                    break
                else:
                    return asg, False
        proven = best == target
        while lo < hi and steps < max_steps and time.perf_counter() < deadline:
            steps += 1
            if want_min:
                mid = lo + (hi - 1 - lo) // 2  # strictly below current best
                status, a2 = ask_op("le", mid)
            else:
                mid = hi - (hi - lo - 1) // 2  # strictly above current best
                status, a2 = ask_op("ge", mid)
            if status == SAT and a2 is not None:
                asg, best = a2, value(a2)
                if want_min:
                    hi = best
                else:
                    lo = best
            elif status == UNSAT:
                if want_min:
                    lo = mid + 1
                else:
                    hi = mid - 1
                proven = lo >= hi
            else:  # UNKNOWN: keep the best model found so far
                return asg, False
        return asg, proven or lo >= hi

    def check(self, *extra) -> str:
        conj = self._raw_conjuncts() + [
            c.raw if hasattr(c, "raw") else c for c in extra
        ]
        # ONE timeout budget covers the initial solve AND all refinement
        deadline = time.perf_counter() + self.config.timeout_ms / 1000.0
        objectives = [(m, True) for m in self._minimize] + [
            (m, False) for m in self._maximize
        ]
        status, asg = solve_conjunction(conj, self.config, device=self.device)
        if status != SAT or asg is None:
            self._model = None
            return status
        self.proven_optimal = True
        # lexicographic: each objective's achievement is pinned before the
        # next — exactly (==) when proven optimal, else as a bound
        for obj, want_min in objectives:
            asg, proven = self._refine(conj, obj, asg, deadline, want_min)
            self.proven_optimal = self.proven_optimal and proven
            achieved = terms.const(evaluate([obj], asg)[obj], obj.width)
            if proven:
                conj = conj + [terms.eq(obj, achieved)]
            elif want_min:
                conj = conj + [terms.ule(obj, achieved)]
            else:
                conj = conj + [terms.uge(obj, achieved)]
        self._model = Model(asg)
        return SAT
