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
Nothing here imports JAX (the packing helpers are the port's).
"""

from __future__ import annotations

import numpy as np

from mythril_tpu_torch.absdomain.tape import LIMBS, _limbs_of, width_mask
from mythril_tpu_torch.native.bitblast import OP_ASHR, OP_CONCAT, OP_EXTRACT, OP_ITE, OP_SEXT

N_OPS = 31  # op codes 0..30; code 31 is outside the table (top)
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
