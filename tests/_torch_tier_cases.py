"""Seeded inputs for the prefilter's known-bits pass and the devsolver's
DPLL search, shared by the CPU parity tests and ``chip_smoke.py``.

``random_kb_fields`` makes a synthetic packed tape with numpy: every op code
(and one outside the table, which is top), missing children, constants,
extracts at every offset, and narrowing overrides on random nodes.
``kb_pack`` wraps the fields in either package's ``PackedBatch``.

``random_cnf_plane`` makes a plane in the blaster's shape: up to 64 free
input bits (the decision variables, in order), Tseitin AND, OR and XOR
gates over earlier variables (clauses of at most 3 literals), then random
constraint clauses over the gates' outputs; the constraint count steers a
query towards SAT or UNSAT, and a small iteration budget cuts it.
``dpll_edge_cases`` builds small planes by hand (``edge_plane``, any
variable count) for the search's edge cases: the empty plane, opposite
units, a variable implied both ways, decisions exhausted, a forced slot
and a backtrack across it, duplicated and tautological literals, the
anchors' literals inside clauses, budgets of 0 and 1 steps, and variable
counts that are no multiple of 32.
Nothing here imports JAX (the packing helpers are the port's).
"""

from __future__ import annotations

import numpy as np

from mythril_tpu_torch.absdomain.tape import LIMBS, _limbs_of, width_mask
from mythril_tpu_torch.native.bitblast import OP_ASHR, OP_CONCAT, OP_EXTRACT, OP_ITE, OP_SEXT

N_OPS = 31  # op codes 0..30; code 31 is outside the table (top)
# the seeded DPLL planes of chip_smoke.py and scripts/torch_dpll_probe.py:
# (seed, queries, clause bucket, variable bucket, max_iters)
DPLL_SEEDED = ((21, 16, 4096, 4096, 2048), (22, 16, 4096, 4096, 2048),
               (23, 16, 4096, 4096, 50), (24, 16, 512, 512, 2048))
WIDTHS = (1, 8, 32, 64, 160, 256, 512)


def random_kb_fields(seed: int, n_nodes: int, n_rows: int) -> dict:
    """The fields of a packed batch of ``n_nodes`` nodes and ``n_rows``
    rows: op, w, a0, a1, a2, x0, x1 [N] int32, wm and c_limbs [N, 16]
    uint32, overrides {node: (olo, ohi, okm [R, 16], okv [R, 16])}."""
    rng = np.random.default_rng(seed)
    f = {k: np.zeros(n_nodes, np.int32) for k in ("op", "w", "a0", "a1", "a2", "x0", "x1")}
    wm = np.zeros((n_nodes, LIMBS), np.uint32)
    cl = np.zeros((n_nodes, LIMBS), np.uint32)
    for i in range(n_nodes):
        # the first nodes are leaves: constants and variables
        op = int(rng.integers(0, 2)) if i < 8 else int(rng.integers(0, N_OPS + 1))
        w = int(rng.choice(WIDTHS))

        def pick(p_missing=0.05):
            return -1 if i == 0 or rng.random() < p_missing else int(rng.integers(0, i))

        a0, a1, a2 = pick(), pick(), pick()
        if op in (OP_SEXT, OP_ASHR, OP_EXTRACT, OP_CONCAT, OP_ITE) and i > 0:
            a0 = int(rng.integers(0, i))  # these read their first child's bits
        x1 = 0
        if op == OP_EXTRACT:
            wa = int(f["w"][a0])
            x1 = int(rng.integers(0, wa))
            w = int(rng.integers(1, wa - x1 + 1))
        elif op == OP_CONCAT and a1 >= 0:
            w = min(512, int(f["w"][a0]) + int(f["w"][a1]))
        f["op"][i], f["w"][i], f["a0"][i], f["a1"][i], f["a2"][i] = op, w, a0, a1, a2
        f["x0"][i], f["x1"][i] = x1 + w - 1, x1
        wm[i] = width_mask(w)
        if op == 0:
            v = int(rng.integers(0, 1 << 62)) * (1 << int(rng.integers(0, 3 * w // 4 + 1)))
            cl[i] = _limbs_of(v % (1 << w) if rng.random() < 0.7 else int(rng.integers(0, 16)))
    overrides = {}
    for node in rng.choice(n_nodes, size=max(1, n_nodes // 32), replace=False):
        node = int(node)
        okm = rng.integers(0, 1 << 32, size=(n_rows, LIMBS), dtype=np.uint64).astype(np.uint32)
        okm &= wm[node]
        okm[rng.random(n_rows) < 0.7] = 0
        okv = rng.integers(0, 1 << 32, size=(n_rows, LIMBS), dtype=np.uint64).astype(np.uint32)
        overrides[node] = (np.zeros(n_rows), np.full(n_rows, np.inf), okm, okv & okm)
    return {**f, "wm": wm, "c_limbs": cl, "overrides": overrides, "n_rows": n_rows}


def kb_pack(fields: dict, tape_module):
    """``fields`` as ``tape_module.PackedBatch`` (the JAX package's
    ``absdomain.tape`` or the port's)."""
    p = tape_module.PackedBatch(fields["n_rows"])
    p.n_nodes = len(fields["op"])
    for k in ("op", "w", "a0", "a1", "a2", "x0", "x1", "wm", "c_limbs"):
        setattr(p, k, fields[k].copy())
    p.overrides = {k: tuple(a.copy() for a in v) for k, v in fields["overrides"].items()}
    return p


def _gate(rng, kind: int, out: int, a: int, b: int) -> list:
    """Tseitin clauses of out = a AND/OR/XOR b (literals 2v, 2v + 1)."""
    A, B, O = 2 * a, 2 * b, 2 * out
    na, nb, no = A + 1, B + 1, O + 1
    if kind == 0:  # and
        return [[na, nb, O], [A, no], [B, no]]
    if kind == 1:  # or
        return [[A, B, no], [na, O], [nb, O]]
    return [[na, nb, no], [A, B, no], [A, nb, O], [na, B, O]]  # xor


def random_cnf_query(rng, n_in: int, n_gates: int, n_cons: int):
    """(clauses, decision variables) of one query; n_in <= 64."""
    clauses = []
    n = 2 + n_in
    for _ in range(n_gates):
        a, b = (int(x) for x in rng.integers(2, n, size=2))
        clauses += _gate(rng, int(rng.integers(0, 3)), n, a, b)
        n += 1
    outs = list(range(max(2, n - n_gates), n)) or list(range(2, n))
    for _ in range(n_cons):
        k = 1 if rng.random() < 0.1 else int(rng.integers(2, 4))
        vs = rng.choice(outs + list(range(2, 2 + n_in)), size=k)
        clauses.append([2 * int(v) + int(rng.integers(0, 2)) for v in vs])
    return clauses, list(range(2, 2 + n_in)), n


def random_cnf_plane(seed: int, n_q: int, clause_bucket: int, n_vars_bucket: int,
                     kernel_module):
    """A plane of ``n_q`` seeded queries packed by ``kernel_module.pack_plane``
    (either package's ``devsolver.kernel``) into the clause and variable
    buckets given; the queries' sizes and constraint counts vary."""
    rng = np.random.default_rng(seed)
    queries, n_vars = [], 2
    for _ in range(n_q):
        n_in = int(rng.integers(4, 65))
        room = clause_bucket - 8
        # past the small clause bucket, every query needs more than 512 clauses
        lo = n_in // 2 if clause_bucket <= 512 else 180
        hi = max(lo, min(n_vars_bucket - 2 - n_in, room // 4))
        n_gates = min(int(rng.integers(lo, hi + 1)), (room - 4) // 4, n_vars_bucket - 2 - n_in)
        left = room - 4 * n_gates
        n_cons = int(rng.integers(1, max(2, min(left, n_in))))
        clauses, dec, n = random_cnf_query(rng, n_in, n_gates, n_cons)
        queries.append((clauses[:clause_bucket], dec))
        n_vars = max(n_vars, n)
    plane = kernel_module.pack_plane(queries, max(n_vars, n_vars_bucket))
    assert plane.lits.shape[1] == clause_bucket and plane.n_vars == n_vars_bucket, (
        plane.lits.shape, plane.n_vars)
    return plane


def _L(v: int) -> int:
    return 2 * v


def _N(v: int) -> int:
    return 2 * v + 1


def edge_plane(queries, n_clauses: int, n_vars: int):
    """(lits [Q, n_clauses, 3], dec [Q, 64]) int32 of ``queries`` (clauses,
    decision variables), padded as ``pack_plane`` pads: literal 0 in an
    unused literal slot, clause [2, 0, 0] in an unused clause slot, variable
    1 in an unused decision slot; no buckets, so any ``n_vars``."""
    lits = np.zeros((len(queries), n_clauses, 3), np.int32)
    lits[:, :, 0] = 2
    dec = np.ones((len(queries), 64), np.int32)
    for qi, (clauses, dvars) in enumerate(queries):
        assert len(clauses) <= n_clauses and len(dvars) <= 64
        for ci, cl in enumerate(clauses):
            lits[qi, ci] = 0
            lits[qi, ci, :len(cl)] = cl
            assert max(cl) < 2 * n_vars
        dec[qi, :len(dvars)] = dvars
    return lits, dec


def _raw_queries(seed: int, n_q: int, n_vars: int):
    """Seeded gate queries that use every variable below ``n_vars``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_q):
        n_in = int(rng.integers(4, min(64, n_vars - 3) + 1))
        clauses, dvars, n = random_cnf_query(rng, n_in, n_vars - 2 - n_in,
                                             int(rng.integers(1, n_in + 1)))
        assert n == n_vars
        out.append((clauses, dvars))
    return out


def dpll_edge_cases() -> list:
    """Hand-built DPLL planes, each a dict: ``label``, ``lits``, ``dec``,
    ``n_vars``, ``iters`` and the expected ``status`` and ``steps`` per query
    (1 SAT, 2 UNSAT, 3 UNKNOWN), or None where a seeded plane's are only
    held to the plain version."""
    x, y, z, w, u = 2, 3, 4, 5, 6
    forced = [([[_L(x), _L(y)], [_L(z), _L(w)], [_L(z), _N(w)], [_N(z), _L(u)],
                [_N(z), _N(u)]], [x, y, z])]
    cases = [
        # every recorded plane: no clause left, one step, SAT
        ("empty plane", [([], [])] * 4, 512, 512, 2048, [1] * 4, [1] * 4),
        ("opposite unit clauses", [([[_L(x)], [_N(x)]], [x])], 512, 512, 2048, [2], [1]),
        # x false makes y a unit both ways; the flip to x true satisfies both
        ("implied both ways", [([[_L(x), _L(y)], [_L(x), _N(y)]], [x])], 512, 512, 2048,
         [1], [3]),
        # 64 free decisions, a clause over three undecided variables open
        ("64 decisions exhausted", [([[_L(66), _L(67), _L(68)]], list(range(2, 66)))],
         512, 512, 2048, [3], [65]),
        # x false forces y, so slot 1 is skipped; z fails both ways, and the
        # backtrack crosses slot 1 to x, then flips y, then gives up
        ("forced slot and a backtrack across it", forced, 512, 512, 2048, [2], [13]),
        ("duplicated literal and tautology",
         [([[_L(x), _L(x), 0], [_L(x), _N(x), 0]], [x]),
          ([[_L(y), _L(y), 0], [_N(y), _N(y), 0]], [y])], 512, 512, 2048, [1, 2], [3, 3]),
        # literals 1 and 2 after the first slot (always true), 0 and 3 inside
        # real clauses (always false): x, then y, then z by propagation
        ("anchor literals inside clauses",
         [([[_L(x), 2, _L(y)], [_L(x), _L(y), 1], [0, _L(x), 3], [_N(x), 3, _L(y)],
            [_N(y), _L(z), 0]], [w])], 512, 512, 2048, [1], [4]),
        ("max_iters 0", forced, 512, 512, 0, [3], [0]),
        ("max_iters 1", forced, 512, 512, 1, [3], [1]),
        ("n_vars 33", _raw_queries(31, 3, 33), 96, 33, 2048, None, None),
        ("n_vars 100", _raw_queries(32, 3, 100), 300, 100, 2048, None, None),
    ]
    out = []
    for label, queries, c, v, iters, status, steps in cases:
        lits, dec = edge_plane(queries, c, v)
        out.append({"label": label, "lits": lits, "dec": dec, "n_vars": v, "iters": iters,
                    "status": status, "steps": steps})
    return out
