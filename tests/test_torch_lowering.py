"""Parity: the port's per-conjunction lowering (mythril_tpu_torch/ops/lowering.py)
against the JAX package's (mythril_tpu/ops/lowering.py), exactly.

Conjunctions are built from JAX terms and carried to the port with
``serialize.from_jax_dump`` (``_torch_parity.to_port``); candidates come from
a seeded generator and are carried the same way.  JAX's
``compile_conjunction(...).evaluate_batch`` and the port's
``evaluate_batch(..., "cpu")`` (the plain version) must give equal ``[B, C]``
bool matrices, tolerance 0:

* the six cases of ``tests/ops/test_lowering.py``;
* every op family of ``tests/_torch_lowering_cases.py`` at every width of
  ``WIDTHS`` (division at seven of them), with division by zero, shift
  amounts at and past the width and a keccak preimage longer than one rate
  block, against JAX's ``run`` unjitted (``CompiledConjunction.raw_fn``);
* ``pack_assignments``' fields, field by field;
* refusals at compile time: ``apply`` and array equality;
* recorded traffic: every lowering dispatch the JAX package makes on the
  probe fixture (``tests/testdata/torch_lowering_cases.npz`` with its term
  dump ``torch_lowering_cases.json``), whose stored truth matrices the
  port's plain version must reproduce.  Regenerate both with

      JAX_PLATFORMS=cpu python tests/test_torch_lowering.py --write

  which replays ``tests/testdata/torch_probe_queries.json`` through the JAX
  solver under ``_torch_parity.jax_same_tiers`` with a runtime wrapper on
  ``mythril_tpu.ops.lowering.compile_cached`` (no JAX file is edited).

The kernel itself is held against the plain version by
``tests/test_torch_csrc_host.py`` (its g++ build), ``tests/test_torch_cuda.py``
and ``chip_smoke.py`` (on the card).
"""

from __future__ import annotations

import json
import random
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:  # run as a script (--write)
    sys.path.insert(0, str(REPO))
from tests._torch_parity import _one_torch_thread  # noqa: E402,F401  (autouse fixture)
MAX_CANDIDATES = 256  # candidates stored per recorded dispatch


def _port_case(conj, leaves, asgs):
    from tests._torch_parity import to_port, to_port_assignment

    ported = to_port(list(conj) + list(leaves))
    term_map = dict(zip(leaves, ported[len(conj):]))
    return ported[: len(conj)], [to_port_assignment(a, term_map) for a in asgs]


def _both(conj, leaves, asgs, eager=False):
    """JAX's and the port's truth matrices of one case, and the port's
    conjuncts and candidates.  ``eager``: JAX's ``run`` unjitted
    (``raw_fn``), op by op."""
    from mythril_tpu.ops import lowering as jlow
    from mythril_tpu_torch.ops import lowering as plow

    jc = jlow.compile_conjunction(conj)
    if eager:
        want = np.asarray(jc.raw_fn(*jlow.pack_assignments(jc, asgs)))
    else:
        want = np.asarray(jc.evaluate_batch(asgs))
    pconj, pasgs = _port_case(conj, leaves, asgs)
    got = plow.compile_conjunction(pconj).evaluate_batch(pasgs, "cpu")
    assert got.dtype == np.bool_ and got.shape == (len(asgs), len(conj))
    return want, got, pconj, pasgs


def _check(conj, leaves, asgs, eager=False):
    from mythril_tpu_torch.smt.concrete_eval import evaluate

    want, got, pconj, pasgs = _both(conj, leaves, asgs, eager)
    np.testing.assert_array_equal(got, want)
    for b, asg in enumerate(pasgs):
        vals = evaluate(pconj, asg)
        assert list(got[b]) == [bool(vals[c]) for c in pconj], f"candidate {b}"


# ---------------------------------------------------------------------------
# the six cases of tests/ops/test_lowering.py
# ---------------------------------------------------------------------------


def _random_assignments(bv_vars, array_vars, rng, n):
    from mythril_tpu.smt import terms
    from mythril_tpu.smt.concrete_eval import ArrayValue, Assignment

    out = []
    for _ in range(n):
        asg = Assignment()
        for v in bv_vars:
            choice = rng.random()
            if choice < 0.25:
                asg.scalars[v] = rng.randint(0, 5)
            elif choice < 0.5:
                asg.scalars[v] = terms.mask(-rng.randint(1, 5), v.width)
            else:
                asg.scalars[v] = rng.getrandbits(v.width)
        for av in array_vars:
            backing = {rng.getrandbits(av.sort[1]) % 64: rng.getrandbits(av.sort[2])
                       for _ in range(rng.randint(0, 4))}
            asg.arrays[av] = ArrayValue(backing, default=rng.getrandbits(8))
        out.append(asg)
    return out


def test_arithmetic_and_compare_ops():
    from mythril_tpu.smt import terms

    rng = random.Random(7)
    x, y, z = terms.var("lx", 256), terms.var("ly", 256), terms.var("lz", 64)
    conjuncts = [
        terms.eq(terms.add(x, y), terms.const(100, 256)),
        terms.ult(terms.mul(x, terms.const(3, 256)), y),
        terms.eq(terms.udiv(x, y), terms.const(2, 256)),
        terms.eq(terms.sdiv(x, y), terms.const(2, 256)),
        terms.eq(terms.urem(x, terms.const(7, 256)), terms.const(3, 256)),
        terms.eq(terms.srem(x, y), terms.sub(x, y)),
        terms.slt(x, y),
        terms.sle(terms.neg(x), y),
        terms.ule(x, terms.bnot(y)),
        terms.eq(terms.band(x, y), terms.bor(x, y)),
        terms.eq(terms.bxor(x, y), terms.const(0xFF, 256)),
        terms.eq(terms.zext(z, 192), x),
        terms.eq(terms.sext(z, 192), y),
        terms.eq(terms.bvexp(x, terms.const(3, 256)), y),
    ]
    _check(conjuncts, [x, y, z], _random_assignments([x, y, z], [], rng, 33))


def test_shift_concat_extract_ops():
    from mythril_tpu.smt import terms
    from mythril_tpu.smt.concrete_eval import Assignment

    rng = random.Random(11)
    x, s, lo = terms.var("lx", 256), terms.var("ls", 256), terms.var("llo", 128)
    conjuncts = [
        terms.eq(terms.shl(x, s), terms.lshr(x, s)),
        terms.eq(terms.ashr(x, s), terms.const(0, 256)),
        terms.eq(terms.extract(31, 0, x), terms.const(0xAB, 32)),
        terms.eq(terms.concat2(terms.extract(255, 128, x), lo), x),
        terms.eq(terms.shl(x, terms.const(300, 256)), terms.const(0, 256)),
    ]
    asgs = _random_assignments([x, s, lo], [], rng, 17)
    for amt in (0, 1, 15, 16, 255, 256, 257, 1 << 200):
        a = Assignment()
        a.scalars[x] = rng.getrandbits(256)
        a.scalars[s] = amt
        a.scalars[lo] = rng.getrandbits(128)
        asgs.append(a)
    _check(conjuncts, [x, s, lo], asgs)


def test_bool_ops_and_ite():
    from mythril_tpu.smt import terms

    rng = random.Random(13)
    x, y = terms.var("lx", 256), terms.var("ly", 256)
    p, q = terms.bool_var("lp"), terms.bool_var("lq")
    conjuncts = [
        terms.land(p, terms.lnot(q)),
        terms.lor(terms.eq(x, y), p),
        terms.lxor(p, q),
        terms.eq(terms.ite(p, x, y), terms.ite(q, terms.const(1, 256), terms.const(2, 256))),
        terms.iff(p, terms.ult(x, y)),
    ]
    asgs = _random_assignments([x, y], [], rng, 16)
    for i, a in enumerate(asgs):
        a.scalars[p] = bool(i & 1)
        a.scalars[q] = bool(i & 2)
    _check(conjuncts, [x, y, p, q], asgs)


def test_array_select_store_chains():
    from mythril_tpu.smt import terms

    rng = random.Random(17)
    arr = terms.array_var("lstorage", 256, 256)
    i, v = terms.var("li", 256), terms.var("lv", 256)
    stored = terms.store(arr, terms.const(5, 256), v)
    stored2 = terms.store(stored, i, terms.const(77, 256))
    conjuncts = [
        terms.eq(terms.select(stored2, terms.const(5, 256)), v),
        terms.eq(terms.select(stored2, i), terms.const(77, 256)),
        terms.eq(terms.select(arr, i), terms.const(0, 256)),
        terms.eq(terms.select(terms.const_array(256, 256, terms.const(9, 256)), i),
                 terms.const(9, 256)),
    ]
    asgs = _random_assignments([i, v], [arr], rng, 25)
    for a in asgs[::3]:  # force some collisions i == 5
        a.scalars[i] = 5
    _check(conjuncts, [i, v, arr], asgs)


def test_keccak_lowering():
    from mythril_tpu.smt import terms

    rng = random.Random(19)
    x = terms.var("lx", 256)
    conjuncts = [terms.eq(terms.extract(15, 0, terms.keccak(x)), terms.const(0x1234, 16))]
    _check(conjuncts, [x], _random_assignments([x], [], rng, 6))


def test_apply_raises_unsupported():
    from mythril_tpu.ops import lowering as jlow
    from mythril_tpu.smt import terms
    from mythril_tpu_torch.ops import lowering as plow

    x = terms.var("lx", 256)
    conj = [terms.eq(terms.apply_func("power", 256, x), x)]
    with pytest.raises(jlow.LoweringUnsupported):
        jlow.compile_conjunction(conj)
    pconj, _ = _port_case(conj, [], [])
    with pytest.raises(plow.LoweringUnsupported, match="uninterpreted"):
        plow.compile_conjunction(pconj)


def test_array_equality_refused_at_compile_time():
    # the JAX lowering compiles it and fails on its first evaluation (the
    # trace); the port refuses it when it compiles
    from mythril_tpu.ops import lowering as jlow
    from mythril_tpu.smt import terms
    from mythril_tpu.smt.concrete_eval import Assignment
    from mythril_tpu_torch.ops import lowering as plow

    a, b = terms.array_var("lea", 256, 256), terms.array_var("leb", 256, 256)
    x = terms.var("lex", 256)
    conj = [terms.eq(terms.store(a, x, x), b), terms.ult(x, terms.const(9, 256))]
    with pytest.raises(Exception):
        jlow.compile_conjunction(conj).evaluate_batch([Assignment()])
    pconj, _ = _port_case(conj, [], [])
    with pytest.raises(plow.LoweringUnsupported, match="array equality"):
        plow.compile_conjunction(pconj)


def test_compile_cache_returns_same_object():
    from mythril_tpu_torch.ops import lowering as plow
    from mythril_tpu_torch.smt import terms

    x = terms.var("lcx", 256)
    c = [terms.ult(x, terms.const(10, 256))]
    assert plow.compile_cached(c) is plow.compile_cached(c)


# ---------------------------------------------------------------------------
# every op family at every width
# ---------------------------------------------------------------------------


def _family(family, width, n=24, seed=None, keys=6):
    from mythril_tpu.smt import concrete_eval as jce
    from mythril_tpu.smt import terms as jterms

    from tests import _torch_lowering_cases as cases

    conj, bv_vars, arrays = cases.build(jterms, family, width)
    asgs = cases.random_assignments(jterms, jce, bv_vars, arrays,
                                    width if seed is None else seed, n, keys)
    return conj, list(bv_vars) + list(arrays), asgs


# every family at every width of _torch_lowering_cases.WIDTHS, division at
# seven of them (JAX's division loops cost seconds to trace each)
SWEEP = [(f, w) for f in ("arith", "div", "shift", "slice", "bool", "array", "keccak")
         for w in (1, 7, 8, 16, 17, 160, 255, 256, 257, 264, 512, 520)
         if f != "div" or w not in (255, 256, 264, 512, 520)]


@pytest.mark.parametrize("family,width", SWEEP)
def test_family_at_width_matches_jax(family, width):
    # JAX's run unjitted: XLA's compile of the jitted function takes about a
    # minute a case at 512 bits; the function and its values are the same
    _check(*_family(family, width), eager=True)


@pytest.mark.parametrize("keys", [8, 16, 64])
def test_table_sizes_match_jax(keys):
    # tables of 8, 16 and 64 rows (the union of the batch's keys)
    from mythril_tpu_torch.ops import lowering as plow

    conj, leaves, asgs = _family("array", 256, n=63, seed=keys, keys=keys)
    _check(conj, leaves, asgs)
    pconj, pasgs = _port_case(conj, leaves, asgs)
    tabs = plow.pack_assignments(plow.compile_conjunction(pconj), pasgs)[2]
    assert tabs[0][0].shape[1] == min(keys, 64)


def test_pack_assignments_fields_match_jax():
    from mythril_tpu.ops import lowering as jlow
    from mythril_tpu_torch.ops import lowering as plow

    conj, leaves, asgs = _family("bool", 17, n=19)
    conj2, leaves2, asgs2 = _family("array", 257, n=19, seed=3)
    for c, lv, a in ((conj, leaves, asgs), (conj2, leaves2, asgs2)):
        jc = jlow.compile_conjunction(c)
        want = jlow.pack_assignments(jc, a)
        pconj, pasgs = _port_case(c, lv, a)
        got = plow.pack_assignments(plow.compile_conjunction(pconj), pasgs, "cpu")
        assert len(got[0]) == len(want[0]) and len(got[2]) == len(want[2])
        for j, p in zip(want[0], got[0]):
            np.testing.assert_array_equal(p.numpy(), np.asarray(j).astype(np.int64))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]).astype(np.int64))
        for jt, pt in zip(want[2], got[2]):
            for j, p in zip(jt, pt):
                assert p.dtype.is_floating_point is False and str(p.dtype) == "torch.int32"
                np.testing.assert_array_equal(p.numpy(), np.asarray(j).astype(np.int64))


def test_node_table_segments_and_pool():
    # the port-only node table: records ordered by dependency level, keccak
    # records like any other; every operand a record reads is an input, a
    # constant or a record of a lower level, and the level count is the
    # longest chain; constants are pool refs, one per value
    from mythril_tpu_torch.ops import lowering as plow
    from mythril_tpu_torch.smt import terms as T

    from tests import _torch_lowering_cases as cases

    unary = {plow.LOP_NOT, plow.LOP_NEG, plow.LOP_EXTRACT, plow.LOP_ZEXT, plow.LOP_SEXT,
             plow.LOP_LOOKUP, plow.LOP_KECCAK}
    for family, width in (("keccak", 256), ("div", 17), ("slice", 264), ("array", 8)):
        conj, _, _ = cases.build(T, family, width)
        prog = plow.compile_conjunction(conj).program
        level_of = {}
        chain = {}
        for n, rec in enumerate(prog.rec):
            lv = int(prog.rec_level[n])
            assert prog.levels[lv - 1] <= n < prog.levels[lv]
            reads = [int(rec[plow.R_A])]  # the operands the kernel reads, by op
            if rec[plow.R_OP] not in unary:
                reads.append(int(rec[plow.R_B]))
            if rec[plow.R_OP] == plow.LOP_ITE:
                reads.append(int(rec[plow.R_C]))
            for r in reads:
                assert r < 0 or r < prog.n_input_rows or level_of[r] < lv, (family, n, r)
            assert lv == 1 + max((level_of.get(r, 0) for r in reads), default=0)
            level_of[int(rec[plow.R_OUT])] = lv
            chain[int(rec[plow.R_OUT])] = 1 + max((chain.get(r, 0) for r in reads), default=0)
        assert prog.n_levels == max(chain.values()) == len(prog.levels) - 1
        assert prog.levels[0] == 0 and prog.levels[-1] == len(prog.rec)
        # division and exponentiation: scratch rows of their own, past the result
        for rec in prog.rec:
            L = -(-int(rec[plow.R_W]) // 16)
            if int(rec[plow.R_OP]) in plow._SCRATCH:
                assert rec[plow.R_SCR] == rec[plow.R_OUT] + L
        consts = [prog.ref_of[t.tid] for t in T.topo_order(conj) if t.op == "const"]
        assert all(r < 0 for r in consts) and len(set(consts)) == len(consts)
    # keccak of x, of the 512-bit and of the 1104-bit preimage, then keccak
    # of two digests one level above its operands
    conj, _, _ = cases.build(T, "keccak", 256)
    prog = plow.compile_conjunction(conj).program
    kl = sorted(int(prog.rec_level[n]) for n in range(len(prog.rec))
                if prog.rec[n, plow.R_OP] == plow.LOP_KECCAK)
    assert len(kl) == 4 and kl[-1] > kl[-2]
    assert any(t.op == "const" for t in T.topo_order(conj))


def test_cuda_tensors_need_the_card():
    # the wrapper checks its inputs before any build; CPU tensors take the
    # plain version, and a CUDA device without a card raises
    import torch

    from mythril_tpu_torch.device import NoCudaDevice
    from mythril_tpu_torch.ops import lowering as plow

    conj, leaves, asgs = _family("arith", 8, n=3)
    pconj, pasgs = _port_case(conj, leaves, asgs)
    pc = plow.compile_conjunction(pconj)
    scalars, bools, tabs = plow.pack_assignments(pc, pasgs)
    with pytest.raises(ValueError, match="expected int32"):
        plow.run_lowering(pc, scalars, bools.to(torch.int64), tabs)
    if not torch.cuda.is_available():
        with pytest.raises(NoCudaDevice):
            pc.evaluate_batch(pasgs, None)


# ---------------------------------------------------------------------------
# recorded traffic
# ---------------------------------------------------------------------------


def test_recorded_dispatches_match_jax():
    from mythril_tpu_torch.ops import lowering as plow

    from tests._torch_lowering_cases import load_recorded, recorded_inputs

    meta, arrays, conjs = load_recorded()
    assert meta["dispatches"], "the fixture holds no dispatch"
    for n, (d, conj) in enumerate(zip(meta["dispatches"], conjs)):
        if d.get("jax_error"):
            with pytest.raises(plow.LoweringUnsupported):
                plow.compile_conjunction(conj)
            continue
        pc = plow.compile_conjunction(conj)
        assert [v.aux for v in pc.bv_vars] == d["bv_names"], n
        assert [v.aux for v in pc.bool_vars] == d["bool_names"], n
        assert len(pc.array_vars) == d["n_arr"], n
        truth = plow.run_lowering(pc, *recorded_inputs(arrays, n, d))
        np.testing.assert_array_equal(truth.numpy(), arrays[f"{n}_truth"], err_msg=str(n))


# ---------------------------------------------------------------------------
# writing the fixture
# ---------------------------------------------------------------------------


def record_contract(name: str) -> tuple:
    """The JAX package's lowering dispatches on one contract of the probe
    fixture -> (metadata, arrays), the dispatches numbered from 0."""
    import mythril_tpu.ops.lowering as jlow
    import mythril_tpu.smt.solver as S
    from mythril_tpu.smt.serialize import dump_terms, load_terms

    from tests._torch_parity import jax_same_tiers
    from tests.test_torch_fixture import FIXTURE as QUERIES
    from tests.test_torch_fixture import replay

    data = json.loads(QUERIES.read_text())
    roots = load_terms(data["terms"])
    contract = next(c for c in data["contracts"] if c["name"] == name)
    dispatches, arrays, all_roots, index = [], {}, [], {}

    def index_of(t):
        if t.tid not in index:
            index[t.tid] = len(all_roots)
            all_roots.append(t)
        return index[t.tid]

    orig = jlow.compile_cached

    def compile_cached(conjuncts):
        compiled = orig(conjuncts)
        if "evaluate_batch" in vars(compiled):  # a cache hit, already wrapped
            return compiled
        evaluate = compiled.evaluate_batch

        def recorded(assignments):
            n = len(dispatches)
            d = {"contract": name, "conj": [index_of(c) for c in conjuncts],
                 "B": len(assignments), "bv_names": [v.aux for v in compiled.bv_vars],
                 "bool_names": [v.aux for v in compiled.bool_vars],
                 "n_bv": len(compiled.bv_vars), "n_arr": len(compiled.array_vars)}
            dispatches.append(d)
            kept = assignments[:MAX_CANDIDATES]
            scalars, bools, tabs = jlow.pack_assignments(compiled, kept)
            for i, x in enumerate(scalars):
                arrays[f"{n}_s{i}"] = np.asarray(x).astype(np.uint16)
            arrays[f"{n}_bools"] = np.asarray(bools).astype(np.uint8)
            for i, tab in enumerate(tabs):
                for f, x in zip(("idx", "val", "valid", "default"), tab):
                    arrays[f"{n}_t{i}_{f}"] = np.asarray(x).astype(
                        np.uint8 if f == "valid" else np.uint16)
            try:
                out = evaluate(assignments)
            except Exception as e:
                d["jax_error"] = f"{type(e).__name__}: {e}"[:200]
                raise
            arrays[f"{n}_truth"] = np.asarray(out)[: len(kept)]
            print(f"{name}: dispatch {n}, {len(conjuncts)} conjuncts, B={len(assignments)}",
                  flush=True)
            return out

        compiled.evaluate_batch = recorded
        return compiled

    jlow.compile_cached = compile_cached
    try:
        with jax_same_tiers():
            replay(contract["queries"], roots, S)
    finally:
        jlow.compile_cached = orig
    return {"terms": dump_terms(all_roots), "dispatches": dispatches}, arrays


def write_fixture() -> dict:
    """Record every contract in a process of its own (two at a time), then
    merge: one term dump, the dispatches numbered in contract order."""
    import subprocess
    import tempfile

    from mythril_tpu.smt.serialize import dump_terms, load_terms

    from tests._torch_lowering_cases import FIXTURE, FIXTURE_TERMS
    from tests.test_torch_fixture import CONTRACTS

    with tempfile.TemporaryDirectory() as tmp:
        procs, pending = [], list(CONTRACTS)
        while pending or procs:
            while pending and len(procs) < 2:
                name = pending.pop(0)
                procs.append(subprocess.Popen(
                    [sys.executable, __file__, "--write-one", name, tmp], cwd=str(REPO)))
            procs[0].wait()
            if procs[0].returncode != 0:
                raise RuntimeError(f"recording failed: {procs[0].args}")
            procs.pop(0)
        roots, dispatches, arrays = [], [], {}
        for name in CONTRACTS:
            meta = json.loads((Path(tmp) / f"{name}.json").read_text())
            part = np.load(Path(tmp) / f"{name}.npz")
            for i, d in enumerate(meta["dispatches"]):
                n = len(dispatches)
                for key in part.files:
                    head, field = key.split("_", 1)
                    if head == str(i):
                        arrays[f"{n}_{field}"] = part[key]
                d["conj"] = [len(roots) + j for j in d["conj"]]
                dispatches.append(d)
            roots += load_terms(meta["terms"])
    meta = {"terms": dump_terms(roots), "dispatches": dispatches,
            "max_candidates": MAX_CANDIDATES}
    FIXTURE_TERMS.write_text(json.dumps(meta, separators=(",", ":")))
    np.savez_compressed(FIXTURE, **arrays)
    return meta


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    if sys.argv[1:2] == ["--write-one"]:
        name, out = sys.argv[2], Path(sys.argv[3])
        meta, arrays = record_contract(name)
        (out / f"{name}.json").write_text(json.dumps(meta))
        np.savez(out / f"{name}.npz", **arrays)
        sys.exit(0)
    if "--write" not in sys.argv:
        sys.exit("usage: JAX_PLATFORMS=cpu python tests/test_torch_lowering.py --write")
    from tests._torch_lowering_cases import FIXTURE, FIXTURE_TERMS

    written = write_fixture()
    print(f"{len(written['dispatches'])} dispatches; {FIXTURE}: {FIXTURE.stat().st_size} bytes, "
          f"{FIXTURE_TERMS}: {FIXTURE_TERMS.stat().st_size} bytes")
