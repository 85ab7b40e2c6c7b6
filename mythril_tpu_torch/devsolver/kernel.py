"""Batched DPLL search over a packed CNF plane: the plain PyTorch version.

The port's counterpart of ``mythril_tpu/devsolver/kernel.py``.  One step of
the search (``step``) is a function over integer tensors with a query axis
``[Q, ...]``: a unit-propagation sweep over every clause, contradiction
detection, then a single decision or a chronological backtrack per query.
``run_plain`` loops it; it is the plain version of the CUDA kernel
(``csrc/dpll.cu``) and, on the same plane, bit for bit the JAX package's
host twin ``run_host`` (``take_along_axis`` is ``torch.gather``, the
scatter-or an integer ``index_put_(accumulate=True)`` read as ``> 0``).

CNF plane layout (built by ``blaster.py``):

* every clause has at most 3 literals; a literal is ``2*var`` (positive)
  or ``2*var + 1`` (negated);
* variable 0 is the constant-FALSE anchor and variable 1 the constant-TRUE
  anchor: literal 0 pads unused literal slots, clause ``[2]`` pads unused
  clause slots;
* decision variables are the free input bits of the blasted query in tape
  order, so the decision stack is always a prefix of ``dec``.

Status codes per query: 0 running, 1 SAT, 2 UNSAT, 3 UNKNOWN (iteration
budget exhausted, or decisions exhausted).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Plane", "pack_plane", "init_state", "step", "run_plain", "run_torch",
           "RUNNING", "SAT_Q", "UNSAT_Q", "UNKNOWN_Q"]

RUNNING, SAT_Q, UNSAT_Q, UNKNOWN_Q = 0, 1, 2, 3

# (query, clause, variable) padding buckets; decision depth is fixed by
# the admission bit budget (devsolver_bit_budget <= MAX_DECISIONS)
Q_BUCKETS = (4, 16)
C_BUCKETS = (512, 4096)
V_BUCKETS = (512, 4096)
MAX_DECISIONS = 64


class Plane:
    """One padded CNF batch ready for the search kernel."""

    __slots__ = ("lits", "dec", "n_q", "n_vars")

    def __init__(self, lits: np.ndarray, dec: np.ndarray, n_q: int,
                 n_vars: int):
        self.lits = lits      # int32 [Q, C, 3]
        self.dec = dec        # int32 [Q, D], padded with var 1
        self.n_q = n_q        # real query count (rows beyond are padding)
        self.n_vars = n_vars  # padded variable count (anchors included)


def _bucket(v: int, buckets) -> int:
    for b in buckets:
        if v <= b:
            return b
    return buckets[-1]


def pack_plane(queries: Sequence[Tuple[List[List[int]], List[int]]],
               n_vars: int) -> Plane:
    """Pad per-query (clauses, decision_vars) into one plane.

    ``n_vars`` is the maximum variable count across the batch (anchor
    variables 0/1 included).  Clause/variable counts are padded to the
    shared buckets, as in the JAX package.
    """
    n_q = len(queries)
    if n_q > Q_BUCKETS[-1]:
        raise ValueError(
            "pack_plane: %d queries exceed the largest query bucket %d — "
            "chunk the batch" % (n_q, Q_BUCKETS[-1]))
    qb = _bucket(n_q, Q_BUCKETS)
    cb = _bucket(max((len(c) for c, _d in queries), default=1), C_BUCKETS)
    vb = _bucket(n_vars, V_BUCKETS)
    lits = np.zeros((qb, cb, 3), np.int32)
    lits[:, :, 0] = 2  # var-1-positive pad: every clause satisfied
    dec = np.ones((qb, MAX_DECISIONS), np.int32)  # var 1: skipped slots
    for qi, (clauses, dvars) in enumerate(queries):
        for ci, cl in enumerate(clauses):
            lits[qi, ci, : len(cl)] = cl
            lits[qi, ci, len(cl):] = 0  # var-0-positive: inert false
        for di, v in enumerate(dvars[:MAX_DECISIONS]):
            dec[qi, di] = v
    return Plane(lits, dec, n_q, vb)


def init_state(qb: int, n_vars: int, device):
    """(assign, level, dval, dflip, depth, status) initial tensors."""
    assign = torch.zeros((qb, n_vars), dtype=torch.int8, device=device)
    # anchors: var 0 is constant false (2), var 1 constant true (1), both
    # at level 0 so no backtrack ever unassigns them
    assign[:, 0], assign[:, 1] = 2, 1
    level = torch.zeros((qb, n_vars), dtype=torch.int16, device=device)
    dval = torch.zeros((qb, MAX_DECISIONS), dtype=torch.int8, device=device)
    dflip = torch.zeros_like(dval)
    depth = torch.zeros(qb, dtype=torch.int32, device=device)
    status = torch.zeros(qb, dtype=torch.int8, device=device)
    return assign, level, dval, dflip, depth, status


def _scatter_or(shape, qi, vi, mask):
    """out[qi, vi] |= mask, order-independent: an integer accumulate read
    back as ``> 0``."""
    out = torch.zeros(shape, dtype=torch.int32, device=mask.device)
    out.index_put_((qi.reshape(-1).long(), vi.reshape(-1).long()),
                   mask.reshape(-1).to(torch.int32), accumulate=True)
    return out > 0


def _i8(v: int, like):
    return torch.full_like(like, v, dtype=torch.int8)


def step(lits, dec, assign, level, dval, dflip, depth, status):
    """One step: propagate OR decide OR backtrack, per query (the JAX
    package's ``kernel.step`` on torch tensors)."""
    qb, cb, _k = lits.shape
    vb = assign.shape[1]
    d = dec.shape[1]
    dev = lits.device
    running = status == RUNNING
    ar_d = torch.arange(d, dtype=torch.int32, device=dev)[None, :]
    ar_v = torch.arange(vb, dtype=torch.int32, device=dev)[None, :]

    # --- clause sweep ------------------------------------------------
    v_idx = (lits >> 1).reshape(qb, cb * 3).long()
    neg = lits & 1
    a = torch.gather(assign, 1, v_idx).reshape(qb, cb, 3)
    # literal truth: 0 unassigned, 1 true, 2 false
    cv = torch.where(neg == 1, torch.where(a == 0, torch.zeros_like(a), 3 - a), a)
    sat_c = (cv == 1).any(dim=2)
    n_un = (cv == 0).sum(dim=2)
    conflict_c = (~sat_c) & (n_un == 0)
    conflict_q = running & conflict_c.any(dim=1)

    # --- unit implications -------------------------------------------
    is_unit = (~sat_c) & (n_un == 1)
    unit_lit = torch.where(cv == 0, lits, torch.zeros_like(lits)).sum(dim=2)
    # a non-unit clause's sum may leave the variable range: its index is
    # clamped to 0 (its mask is False), as in the JAX package
    uv = torch.where(is_unit, unit_lit >> 1, torch.zeros_like(unit_lit))
    qi = torch.arange(qb, device=dev)[:, None].expand(qb, cb)
    imp_t = _scatter_or((qb, vb), qi, uv, is_unit & ((unit_lit & 1) == 0))
    imp_f = _scatter_or((qb, vb), qi, uv, is_unit & ((unit_lit & 1) == 1))
    # a variable implied both ways in one sweep is a conflict
    conflict_q = conflict_q | (running & (imp_t & imp_f).any(dim=1))

    apply_q = (running & ~conflict_q)[:, None]
    newly = apply_q & (assign == 0) & (imp_t ^ imp_f)
    assign = torch.where(newly & imp_t, _i8(1, assign),
                         torch.where(newly & imp_f, _i8(2, assign), assign))
    level = torch.where(newly, depth[:, None].to(torch.int16), level)
    progressed = newly.any(dim=1)

    # --- fixpoint: SAT check or decide -------------------------------
    at_fix = running & ~conflict_q & ~progressed
    all_sat = sat_c.all(dim=1)
    status = torch.where(at_fix & all_sat, _i8(SAT_Q, status), status)

    need_dec = at_fix & ~all_sat
    exhausted = depth >= d
    status = torch.where(need_dec & exhausted, _i8(UNKNOWN_Q, status), status)
    nd = need_dec & ~exhausted
    d_clamp = depth.clamp(0, d - 1)
    dv = torch.gather(dec, 1, d_clamp[:, None].long())[:, 0]
    dv_assigned = torch.gather(assign, 1, dv[:, None].long())[:, 0] != 0
    slot = ar_d == d_clamp[:, None]
    var_hot = ar_v == dv[:, None]
    # skipped slot (variable already forced by propagation): mark it
    # tried-both so backtracking never flips a non-decision
    skip = nd & dv_assigned
    fresh = nd & ~dv_assigned
    dflip = torch.where(skip[:, None] & slot, _i8(1, dflip), dflip)
    # phase: try FALSE first (value 2)
    dval = torch.where(fresh[:, None] & slot, _i8(2, dval), dval)
    assign = torch.where(fresh[:, None] & var_hot, _i8(2, assign), assign)
    level = torch.where(fresh[:, None] & var_hot, (depth[:, None] + 1).to(torch.int16), level)
    depth = torch.where(nd, depth + 1, depth)

    # --- backtrack ---------------------------------------------------
    cand = (ar_d < depth[:, None]) & (dflip == 0)
    has = cand.any(dim=1)
    status = torch.where(conflict_q & ~has, _i8(UNSAT_Q, status), status)
    bt = conflict_q & has
    # the highest candidate slot (d - 1 where there is none, as argmax
    # over a reversed all-false row gives)
    j = torch.where(cand, ar_d, torch.full_like(cand, -1, dtype=torch.int32)).max(dim=1).values
    j = torch.where(has, j, torch.full_like(j, d - 1))
    keep = level <= j[:, None].to(torch.int16)
    assign = torch.where(bt[:, None] & ~keep, _i8(0, assign), assign)
    level = torch.where(bt[:, None] & ~keep, torch.zeros_like(level), level)
    j_hot = ar_d == j[:, None]
    dval = torch.where(bt[:, None] & j_hot, (3 - dval).to(torch.int8), dval)
    nv = torch.where(j_hot, dval, _i8(0, dval)).sum(dim=1).to(torch.int8)
    jv = torch.gather(dec, 1, j.clamp(0, d - 1)[:, None].long())[:, 0]
    jv_hot = ar_v == jv[:, None]
    assign = torch.where(bt[:, None] & jv_hot, nv[:, None].expand(qb, vb), assign)
    level = torch.where(bt[:, None] & jv_hot, (j[:, None] + 1).to(torch.int16), level)
    dflip = torch.where(bt[:, None] & j_hot, _i8(1, dflip),
                        torch.where(bt[:, None] & (ar_d > j[:, None]), _i8(0, dflip), dflip))
    depth = torch.where(bt, j + 1, depth)

    return assign, level, dval, dflip, depth, status


def run_plain(lits: torch.Tensor, dec: torch.Tensor, n_vars: int, max_iters: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of the DPLL kernel on the plane's tensors, on their
    device -> (status int8 [Q], assign int8 [Q, V], steps int32 [Q]).
    Queries still RUNNING when the budget lapses are UNKNOWN, as in the JAX
    package's ``run_host``; ``steps`` counts the steps each query ran."""
    state = init_state(lits.shape[0], n_vars, lits.device)
    steps = torch.zeros(lits.shape[0], dtype=torch.int32, device=lits.device)
    it = 0
    while it < max_iters and bool((state[5] == RUNNING).any()):
        steps += (state[5] == RUNNING).to(torch.int32)
        state = step(lits, dec, *state)
        it += 1
    assign, status = state[0], state[5]
    status = torch.where(status == RUNNING, _i8(UNKNOWN_Q, status), status)
    return status, assign, steps


def run_torch(plane: Plane, max_iters: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``run_plain`` on ``plane`` moved to ``device`` -> (status [Q], assign
    [Q, V]); the counterpart of the JAX package's ``run_host``."""
    lits = torch.from_numpy(np.ascontiguousarray(plane.lits, np.int32)).to(device)
    dec = torch.from_numpy(np.ascontiguousarray(plane.dec, np.int32)).to(device)
    status, assign, _steps = run_plain(lits, dec, plane.n_vars, max_iters)
    return status, assign
