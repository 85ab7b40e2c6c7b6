"""The port's slot plan (``ops/tape_vm.py`` ``TapePlan``) on the CPU.

The CUDA tape kernel keeps the values that later steps read in a slot file
in shared memory; the host assigns the slots, the roots' order and the
spills across keccak steps.  Here:

* every read the plan routes to a slot finds there the row the tape names,
  on random tapes over all 20 op codes (``hypothesis``), keccak steps and
  forward references included;
* ``run_through_plan``, a plain PyTorch interpreter that reads and writes
  values only where the plan says (a slot file poisoned at every segment's
  start, the spill, the leaves), gives the same truth and the same step
  values as ``run_tape_reference`` on every family of
  ``tests/_torch_tape_cases.py`` at both profiles, on the slot cases, on
  random tapes and on the recorded fixture's widest tape.
"""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from mythril_tpu_torch.ops import bitvec as bv
from mythril_tpu_torch.ops import keccak_torch
from mythril_tpu_torch.ops import tape_vm as ptape
from mythril_tpu_torch.smt import concrete_eval as pce
from mythril_tpu_torch.smt import terms
from tests import _torch_tape_cases as cases

L = ptape.L
POISON = 0x5A5A


def _apply(o, x, y, z, slot, tables):
    """One step of the plain interpreter (``run_tape_reference``'s dispatch)."""
    t_idx, t_val, t_ok, t_def = tables
    B = x.shape[0]

    def to_word(flag):
        out = torch.zeros((B, L), dtype=torch.int64)
        out[:, 0] = flag.to(torch.int64)
        return out

    if o == ptape.OP_SELECT:
        hit = (t_idx[:, slot] == x[:, None, :]).all(-1) & t_ok[:, slot]
        chosen = (t_val[:, slot] * hit[..., None]).sum(dim=1)
        return torch.where(hit.any(-1)[:, None], chosen, t_def[:, slot])
    if o == ptape.OP_ITE:
        return bv.mux((x != 0).any(-1), y, z)
    if o == ptape.OP_EQ:
        return to_word(bv.eq(x, y))
    if o == ptape.OP_ULT:
        return to_word(bv.ult(x, y))
    if o in (ptape.OP_AND, ptape.OP_OR, ptape.OP_XOR):
        return {ptape.OP_AND: x & y, ptape.OP_OR: x | y, ptape.OP_XOR: x ^ y}[o]
    fn = {ptape.OP_ADD: bv.add, ptape.OP_SUB: bv.sub, ptape.OP_MUL: bv.mul,
          ptape.OP_UDIV: bv.udiv, ptape.OP_UREM: bv.urem, ptape.OP_SDIV: bv.sdiv,
          ptape.OP_SREM: bv.srem, ptape.OP_EXP: bv.bvexp, ptape.OP_SHL: bv.shl,
          ptape.OP_LSHR: bv.lshr, ptape.OP_ASHR: bv.ashr}[o]
    return fn(x, y, 256)


def _span(a, span):
    """a[offset: offset + count] for a plan list's (offset, count)."""
    return a[span[0]: span[0] + span[1]]


def _mask_limbs(rec_row):
    """The width mask of a plan record as [L] 16-bit limbs."""
    words = rec_row[8:].astype(np.int64) & 0xFFFFFFFF
    return torch.tensor([(int(w) >> (16 * j)) & 0xFFFF for w in words for j in (0, 1)])


def _select_from_slots(slots, base, a, x, tables, K):
    """SELECT against the table in slots base .. base + K: the first valid
    row whose index equals x, its value from the table, else the default."""
    _idx, t_val, _ok, t_def = tables
    valid = slots[base + K, :, 0]
    out = t_def[:, a].clone()
    for k in reversed(range(K)):
        hit = ((valid >> k) & 1).bool() & (slots[base + k] == x).all(-1)
        out[hit] = t_val[hit, a, k]
    return out


def run_through_plan(args, plan, *, V, R):
    """The tape run as the kernel runs it, through the plan alone.

    -> (truth [B, R] bool, {step: value [B, L]})."""
    leaf_vals, tab_idx, tab_val, tab_valid, tab_default = args[:5]
    B, K = leaf_vals.shape[0], tab_idx.shape[2]
    leaves = leaf_vals.long()
    tables = (tab_idx.long(), tab_val.long(), tab_valid.bool(), tab_default.long())
    rec, order = plan.rec, plan.root_order
    truth = torch.full((B, R), 2, dtype=torch.int64)  # 2: never written
    values, spill, digest = {}, None, None

    for j, seg in enumerate(plan.segments):
        slots = torch.full((max(plan.S, 1), B, L), POISON, dtype=torch.int64)
        for slot, row in _span(plan.leaves, seg.leaves):
            slots[slot] = leaves[:, row]
        for base, a in _span(plan.tables, seg.tables):
            slots[base: base + K] = tables[0][:, a].permute(1, 0, 2)
            valid = (tables[2][:, a].long() << torch.arange(K)).sum(-1)
            slots[base + K] = 0
            slots[base + K, :, 0] = valid
        if plan.zero_slot >= 0:
            slots[plan.zero_slot] = 0
        for i, s in enumerate(_span(plan.live, seg.live_in)):
            slots[s] = spill[i]

        def finish(t, v):
            dst, lo, hi = (int(c) for c in rec[t, 5:8])
            if dst >= 0:
                slots[dst] = v
            values[t] = v
            for j in range(lo, hi):
                truth[:, order[j]] = (v != 0).any(-1).long()

        if j == 0:
            for r, src in plan.pre:
                ok = (slots[src] != 0).any(-1) if src >= 0 else torch.full((B,), src == ptape.PRE_ONE)
                truth[:, r] = ok.long()
        if seg.squeeze >= 0:
            finish(seg.squeeze, digest & _mask_limbs(rec[seg.squeeze]))
        for t in range(seg.t_begin, seg.t_end):
            o, x, y, z, aux = (int(c) for c in rec[t, :5])
            if o == ptape.OP_SELECT:
                res = _select_from_slots(slots, z, aux, slots[x], tables, K)
            else:
                res = _apply(o, slots[x], slots[y], slots[z], aux, tables)
            finish(t, res & _mask_limbs(rec[t]))
        if seg.absorb >= 0:
            o, x, y = (int(c) for c in rec[seg.absorb, :3])
            if o == ptape.OP_KECCAK64:
                digest = keccak_torch.keccak256(torch.cat([slots[x], slots[y]], -1), 512)
            else:
                digest = keccak_torch.keccak256(slots[x], 256)
            spill = torch.stack([slots[s] for s in _span(plan.live, seg.live_out)] or
                                [torch.zeros((B, L), dtype=torch.int64)])
    assert (truth != 2).all(), "a root was never decided"
    return truth.bool(), values


def check_routes(tape, plan, *, V, K, n):
    """Every read the plan routes to a slot finds the row the tape names;
    every root is decided once, by its row's step or before any step."""
    op = tape["op"]
    spilled = []
    for j, seg in enumerate(plan.segments):
        held = dict(zip(_span(plan.live, seg.live_in).tolist(), spilled))
        held.update({int(slot): ("leaf", int(row)) for slot, row in _span(plan.leaves, seg.leaves)})
        for base, a in _span(plan.tables, seg.tables).tolist():
            held.update({base + k: ("table", a, k) for k in range(K)})
            held[base + K] = ("valid", a)
        assert all(slot >= plan.leaf_base for slot, _ in _span(plan.leaves, seg.leaves))
        if plan.zero_slot >= 0:
            held[plan.zero_slot] = "zero"
        assert all(0 <= s < plan.S for s in held)

        def read(t):
            used = ptape._OPERANDS.get(int(op[t]), (0, 1))
            for j, name in enumerate(("a0", "a1", "a2")):
                c, row = int(plan.rec[t, 1 + j]), int(tape[name][t])
                want = ("leaf", row) if row < V else "zero" if row >= V + t else row
                assert 0 <= c < plan.S, (t, name)
                if int(op[t]) == ptape.OP_SELECT and j == 2:
                    a = int(tape["aux"][t])
                    assert held.get(c + K) == ("valid", a) and held.get(c) == ("table", a, 0)
                elif j in used:
                    assert held.get(c) == want, f"step {t} {name}: slot {c} holds {held.get(c)}, not {want}"

        def write(t):
            if plan.rec[t, 5] >= 0:
                held[int(plan.rec[t, 5])] = V + t

        if j == 0:
            for r, src in plan.pre.tolist():
                row = int(tape["root_rows"][r])
                if not tape["root_valid"][r]:
                    assert src == ptape.PRE_ONE
                elif row < V:
                    assert held[src] == ("leaf", row)
                else:
                    assert src == ptape.PRE_ZERO and row >= V + n
        if seg.squeeze >= 0:
            write(seg.squeeze)
        for t in range(seg.t_begin, seg.t_end):
            read(t)
            write(t)
        if seg.absorb >= 0:
            read(seg.absorb)
        spilled = [held[s] for s in _span(plan.live, seg.live_out).tolist()]
    decided = sorted(plan.root_order.tolist())
    assert decided == list(range(len(tape["root_rows"]))), "each root decided exactly once"
    assert plan.root_order[: len(plan.pre)].tolist() == plan.pre[:, 0].tolist()
    for t in range(n):
        for j in range(plan.rec[t, 6], plan.rec[t, 7]):
            assert tape["root_rows"][plan.root_order[j]] == V + t


# -- random tapes -----------------------------------------------------------

V_R, A_R, K_R, R_R = 6, 2, 3, 5
WIDTHS = (1, 8, 64, 160, 256)


@st.composite
def random_tapes(draw, max_steps=40):
    n = draw(st.integers(1, max_steps))
    T = n + draw(st.integers(0, 3))
    op = np.zeros(T, np.int32)
    a = np.zeros((3, T), np.int32)
    aux = np.zeros(T, np.int32)
    wmask = np.zeros((T, L), np.uint32)
    for t in range(n):
        op[t] = draw(st.sampled_from(range(20)))
        for j in range(3):
            # mostly earlier rows; now and then a forward reference (reads zero)
            hi = V_R + t - 1 if draw(st.integers(0, 9)) else V_R + T - 1
            a[j, t] = draw(st.integers(0, hi))
        aux[t] = draw(st.integers(0, A_R - 1))
        wmask[t] = bv.from_ints_np(terms.mask(-1, draw(st.sampled_from(WIDTHS))), 256)
    root_rows = np.array([draw(st.integers(0, V_R + T - 1)) for _ in range(R_R)], np.int32)
    root_valid = np.array([draw(st.booleans()) for _ in range(R_R)], bool)
    tape = {"op": op, "a0": a[0], "a1": a[1], "a2": a[2], "aux": aux, "wmask": wmask,
            "root_rows": root_rows, "root_valid": root_valid}
    return tape, n, T


def _random_args(tape, T, seed, B=3):
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 300, (B, V_R, L)) * (rng.random((B, V_R, 1)) < 0.3) * (np.arange(L) == 0)
    leaf = np.where(rng.random((B, V_R, 1)) < 0.4, small, rng.integers(0, 1 << 16, (B, V_R, L)))
    # distinct keys per table, as the packer makes them: a row's key is its
    # index, or its index plus K_R
    keys = np.arange(K_R) + K_R * rng.integers(0, 2, (B, A_R, K_R))
    tab_idx = keys[..., None] * (np.arange(L) == 0)
    tab_val = rng.integers(0, 1 << 16, (B, A_R, K_R, L))
    tab_valid = rng.random((B, A_R, K_R)) < 0.7
    tab_default = rng.integers(0, 1 << 16, (B, A_R, L))
    host = (leaf, tab_idx, tab_val, tab_valid, tab_default, tape["op"], tape["a0"], tape["a1"],
            tape["a2"], tape["aux"], tape["wmask"], tape["root_rows"], tape["root_valid"])
    return tuple(torch.from_numpy(np.asarray(x).astype(np.int64)) for x in host)


@settings(max_examples=200, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(random_tapes(max_steps=120))
def test_plan_routes_every_read_random(drawn):
    tape, n, T = drawn
    plan = ptape.TapePlan(tape, n, V_R, T, A_R, K_R, R_R)
    check_routes(tape, plan, V=V_R, K=K_R, n=n)
    assert plan.S <= n + V_R + A_R * (K_R + 1) + 1


@settings(max_examples=12, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(random_tapes(max_steps=20), st.integers(0, 2**16))
def test_plan_interpreter_matches_reference_random(drawn, seed):
    tape, n, T = drawn
    args = _random_args(tape, T, seed)
    plan = ptape.TapePlan(tape, n, V_R, T, A_R, K_R, R_R)
    want, regs = ptape.run_tape_reference(*args, T=T, V=V_R, A=A_R, K=K_R, R=R_R, n_steps=n,
                                          return_regs=True)
    got, values = run_through_plan(args, plan, V=V_R, R=R_R)
    assert torch.equal(got, want)
    for t in range(n):
        assert torch.equal(values[t], regs[V_R + t]), f"step {t}"


# -- the tape cases and the fixture -------------------------------------------


def _check_case(conj, bv_vars, arrays, seed, n_cand=24):
    compiled = ptape.compile_tape(conj)
    asgs = cases.random_assignments(terms, pce, bv_vars, arrays, seed, n_cand)
    args, (T, V, A, K, R) = compiled.pack_args(asgs, "cpu")
    n = compiled.n_steps
    plan = compiled.plan
    check_routes(compiled.tensors, plan, V=V, K=K, n=n)
    want, regs = ptape.run_tape_reference(*args, T=T, V=V, A=A, K=K, R=R, n_steps=n,
                                          return_regs=True)
    got, values = run_through_plan(args, plan, V=V, R=R)
    assert torch.equal(got, want)
    for t in range(n):
        assert torch.equal(values[t], regs[V + t]), f"step {t}"
    return compiled


@pytest.mark.parametrize("large", [False, True], ids=["small", "large"])
@pytest.mark.parametrize("family", list(cases.FAMILIES))
def test_slot_interpreter_matches_reference(family, large):
    conj, bv_vars, arrays = cases.build(terms, family, large)
    compiled = _check_case(conj, bv_vars, arrays, seed=31)
    assert compiled.tensors["profile"] == ("large" if large else "small")


def test_wide_live_set_needs_more_than_200_slots():
    conj, bv_vars, arrays = cases.build(terms, "wide_live")
    compiled = _check_case(conj, bv_vars, arrays, seed=5, n_cand=8)
    assert compiled.plan.leaf_base > 200  # slots of step values alone
    T, V, A, K, R = compiled.tensors["shape"]
    assert compiled.plan.S <= compiled.n_steps + V + A * (K + 1) + 1


def test_values_spill_across_both_keccak_steps():
    conj, bv_vars, arrays = cases.build(terms, "keccak_live")
    plan = _check_case(conj, bv_vars, arrays, seed=6).plan
    assert len(plan.segments) == 3
    spilled = [set(_span(plan.live, seg.live_out).tolist()) for seg in plan.segments[:2]]
    assert spilled[0] and spilled[0] & spilled[1], "a slot live across both keccak steps"


def test_leaf_roots_and_early_roots():
    conj, bv_vars, arrays = cases.build(terms, "leaf_roots")
    compiled = _check_case(conj, bv_vars, arrays, seed=8)
    plan, tape = compiled.plan, compiled.tensors
    V = tape["shape"][1]
    assert 0 in plan.pre[:, 0] and 1 in plan.pre[:, 0]  # the boolean variable and the constant true
    assert all(tape["root_rows"][r] < V for r in (0, 1))
    early = [t for t in range(compiled.n_steps) if plan.rec[t, 6] < plan.rec[t, 7]]
    assert early[0] < 4 and plan.leaf_base <= 2  # roots need no slot, the chain one or two


def test_fixture_widest_tape():
    from mythril_tpu_torch.smt.serialize import from_jax_dump
    from tests.test_torch_fixture import load_fixture

    data, roots = load_fixture(from_jax_dump)
    widest = None
    for contract in data["contracts"]:
        for q in contract["queries"]:
            for cs in ([q["conj"]] if q["kind"] == "solve" else q["sets"]):
                try:
                    compiled = ptape.compile_tape([roots[i] for i in cs])
                except ptape.TapeUnsupported:
                    continue
                if widest is None or compiled.plan.S > widest.plan.S:
                    widest = compiled
    assert widest.plan.leaf_base >= 30
    _check_case(widest.conjuncts, widest.bv_vars + widest.bool_vars, widest.array_vars,
                seed=12, n_cand=6)


def test_plan_is_built_once_per_compiled_tape():
    conj, _bv, _arr = cases.build(terms, "keccak64", False)
    compiled = ptape.compile_tape(conj)
    assert compiled.plan is compiled.plan
    assert compiled.plan.device_arrays("cpu") is compiled.plan.device_arrays("cpu")


def test_plan_refuses_out_of_range_rows():
    conj, _bv, _arr = cases.build(terms, "add", False)
    compiled = ptape.compile_tape(conj)
    tape = {k: v.copy() if isinstance(v, np.ndarray) else v for k, v in compiled.tensors.items()}
    T, V, A, K, R = tape["shape"]
    tape["root_rows"][0] = V + T
    with pytest.raises(ValueError, match="out of range"):
        ptape.TapePlan(tape, compiled.n_steps, V, T, A, K, R)
