"""Parity: the port's tape VM (mythril_tpu_torch/ops/tape_vm.py) against the
JAX package's (mythril_tpu/ops/tape_vm.py), bit for bit.

Each conjunction is built once from JAX terms and carried to the port with
``serialize.from_jax_dump``; the candidates come from a seeded numpy
generator (tests/_torch_tape_cases.py) and are carried the same way.  Then:

* every ``TapeProgram.finalize`` field is ``np.array_equal`` on both sides;
* the packed interpreter inputs are equal;
* ``run_tape_reference`` on the CPU gives exactly JAX ``_run_tape``'s truth
  table on the same inputs (padding rows and roots included), and both agree
  with the host oracle ``concrete_eval`` on the real rows.

One conjunction per op family, so all 20 op codes run, at both profiles.
"""

import numpy as np
import pytest
import torch

from mythril_tpu.ops import tape_vm as jtape
from mythril_tpu.smt import concrete_eval as jce
from mythril_tpu.smt import terms as jterms
from mythril_tpu_torch.ops import tape_vm as ptape
from mythril_tpu_torch.smt import concrete_eval as pce
from tests._torch_parity import _one_torch_thread  # noqa: E402,F401  (autouse fixture)
from tests import _torch_tape_cases as cases
from tests._torch_parity import to_port, to_port_assignment

FINALIZE_FIELDS = ("op", "a0", "a1", "a2", "aux", "wmask", "root_rows", "root_valid", "leaf_consts")


def _case(family, large, n=40, seed=7):
    conj, bv_vars, arrays = cases.build(jterms, family, large)
    asgs = cases.random_assignments(jterms, jce, bv_vars, arrays, seed, n)
    leaves = list(bv_vars) + list(arrays)
    ported = to_port(list(conj) + leaves)
    pconj, pleaves = ported[: len(conj)], ported[len(conj):]
    term_map = dict(zip(leaves, pleaves))
    pasgs = [to_port_assignment(a, term_map) for a in asgs]
    return conj, asgs, pconj, pasgs


@pytest.mark.parametrize("large", [False, True], ids=["small", "large"])
@pytest.mark.parametrize("family", list(cases.FAMILIES))
def test_finalize_fields_match(family, large):
    conj, _asgs, pconj, _pasgs = _case(family, large, n=1)
    want = jtape.compile_tape(conj).tensors
    got = ptape.compile_tape(pconj).tensors
    assert got["profile"] == want["profile"] == ("large" if large else "small")
    assert got["shape"] == want["shape"]
    assert got["n_consts"] == want["n_consts"]
    for name in FINALIZE_FIELDS:
        assert np.array_equal(got[name], want[name]), name
    n = len(ptape.compile_tape(pconj).program.ops)
    assert cases.FAMILY_OP[family] in set(got["op"][:n].tolist())


def _truth_both(conj, asgs, pconj, pasgs):
    jc = jtape.compile_tape(conj)
    pc = ptape.compile_tape(pconj)
    jargs, shape = jc.pack_args(asgs)
    host, pshape = pc.pack_host(pasgs)
    assert pshape == shape
    for j, p in zip(jargs, host):
        assert np.array_equal(np.asarray(j), p)
    T, V, A, K, R = shape
    want = np.asarray(jtape._run_tape(*jargs, T=T, V=V, A=A, K=K, R=R))
    targs = tuple(torch.from_numpy(np.asarray(j).astype(np.int64)) for j in jargs)
    got = ptape.run_tape_reference(*targs, T=T, V=V, A=A, K=K, R=R, n_steps=pc.n_steps)
    return want, got.numpy(), pc


@pytest.mark.parametrize("large", [False, True], ids=["small", "large"])
@pytest.mark.parametrize("family", list(cases.FAMILIES))
def test_truth_matches_jax_run_tape(family, large):
    conj, asgs, pconj, pasgs = _case(family, large)
    want, got, pc = _truth_both(conj, asgs, pconj, pasgs)
    np.testing.assert_array_equal(got, want)
    evaluated = pc.evaluate_batch(pasgs, "cpu")
    assert evaluated.shape == (len(pasgs), len(pconj))
    for b, asg in enumerate(pasgs):
        vals = pce.evaluate(pconj, asg)
        assert list(evaluated[b]) == [bool(vals[c]) for c in pconj], f"candidate {b}"


def test_bucket_256_and_padding_rows():
    # 70 candidates -> bucket 256 on both sides; rows 70.. are padding
    conj, asgs, pconj, pasgs = _case("select", False, n=70, seed=11)
    want, got, pc = _truth_both(conj, asgs, pconj, pasgs)
    assert got.shape[0] == 256
    np.testing.assert_array_equal(got, want)
    assert pc.evaluate_batch(pasgs, "cpu").shape == (70, len(pconj))


def test_full_tape_padding_steps_are_inert():
    _conj, _asgs, pconj, pasgs = _case("keccak64", False, n=8)
    pc = ptape.compile_tape(pconj)
    args, (T, V, A, K, R) = pc.pack_args(pasgs, "cpu")
    short = ptape.run_tape_reference(*args, T=T, V=V, A=A, K=K, R=R, n_steps=pc.n_steps)
    full = ptape.run_tape_reference(*args, T=T, V=V, A=A, K=K, R=R)
    assert torch.equal(short, full)
    assert torch.equal(ptape.run_tape(*args, T=T, V=V, A=A, K=K, R=R), full)


def _lowered_like_jax(conj, leaves, asgs):
    """Both tapes refuse ``conj`` (JAX terms); the port's lowering gives the
    JAX lowering's truth on the CPU.  -> (port conjuncts, port candidates,
    port compiled lowering, truth)"""
    from mythril_tpu.ops import lowering as jlow
    from mythril_tpu_torch.ops import lowering as plow

    with pytest.raises(jtape.TapeUnsupported, match="keccak input width"):
        jtape.compile_tape(conj)
    ported = to_port(list(conj) + list(leaves))
    pconj, term_map = ported[: len(conj)], dict(zip(leaves, ported[len(conj):]))
    with pytest.raises(ptape.TapeUnsupported, match="keccak input width"):
        ptape.compile_tape(pconj)
    pasgs = [to_port_assignment(a, term_map) for a in asgs]
    pc = plow.compile_conjunction(pconj)
    got = pc.evaluate_batch(pasgs, "cpu")
    np.testing.assert_array_equal(got, jlow.compile_conjunction(conj).evaluate_batch(asgs))
    return pconj, pasgs, pc, got


@pytest.mark.parametrize("shape", ["slot", "bytes"])
def test_byte_built_keccak_preimage(shape):
    # keccak over a 512-bit concat chain of bytes, as the engine builds
    # mapping slots: both tapes refuse it and both lowerings take it.  Truth
    # must equal the JAX lowering's, the port's oracle, and JAX _run_tape's
    # on the same preimage written as two words.
    x, y = jterms.var(f"pbk_{shape}_x", 256), jterms.var(f"pbk_{shape}_y", 256)
    if shape == "slot":
        parts = [x] + [jterms.const(b, 8) for b in (0,) * 31 + (3,)]
        words = jterms.concat2(x, jterms.const(3, 256))
    else:
        parts = [jterms.extract(255 - 8 * i, 248 - 8 * i, x) for i in range(32)] + [
            jterms.extract(255 - 8 * i, 248 - 8 * i, y) for i in range(32)]
        words = jterms.concat2(x, y)
    chain = parts[0]
    for p in parts[1:]:
        chain = jterms.concat2(chain, p)
    assert chain.op == "concat" and chain.args[0].width != 256
    mk = lambda pre: [jterms.ult(jterms.keccak(pre), jterms.const(1 << 255, 256)),  # noqa: E731
                      jterms.ult(jterms.const(0, 256), y)]
    conj, words_conj = mk(chain), mk(words)
    asgs = cases.random_assignments(jterms, jce, [x, y], [], 3, 40)
    pconj, pasgs, _pc, got = _lowered_like_jax(conj, [x, y], asgs)
    want = jtape.compile_tape(words_conj).evaluate_batch(asgs)
    np.testing.assert_array_equal(got, want)
    for b, asg in enumerate(pasgs):
        vals = pce.evaluate(pconj, asg)
        assert list(got[b]) == [bool(vals[c]) for c in pconj]


def _word_row_chain(T, shape):
    """A 512-bit keccak preimage as a concat chain whose parts are not the
    two 256-bit words (the tapes refuse it; the lowerings take it)."""

    def v(name, w):
        return T.var(f"pwr_{shape}_{name}", w)

    def byte_parts(x):
        return [T.extract(255 - 8 * i, 248 - 8 * i, x) for i in range(32)]

    if shape == "edges":  # parts end exactly at bits 8, 256 and 504
        parts = [v("a", 8), v("b", 248), v("c", 248), v("d", 8)]
    elif shape == "const_in_high_word":  # a constant and a shifted variable
        hi = [v("x", 128), T.const(0xABC, 128)]
        return T.concat2(hi[0], T.concat2(hi[1], T.concat2(v("y", 128), v("z", 128))))
    elif shape == "high_word_constant":
        parts = [T.const(b, 8) for b in range(1, 33)] + byte_parts(v("x", 256))
    elif shape == "high_word_zero":
        parts = [T.const(0, 8)] * 32 + byte_parts(v("x", 256))
    elif shape == "low_word_constant":
        parts = byte_parts(v("x", 256)) + [T.const(b, 8) for b in range(7, 39)]
    elif shape == "spans_both_words":  # bits 248..264 in one part
        parts = [v("a", 248), v("b", 16), v("c", 248)]
    else:
        raise ValueError(shape)
    return T.concat(*parts)


def _word_row_case(shape):
    # the preimage and the digest the port's lowering computes equal the
    # oracle's values of the chain and of the keccak term, candidate by
    # candidate, and its truth equals the JAX lowering's
    from mythril_tpu_torch.ops import bitvec as pbv
    from mythril_tpu_torch.ops import lowering as plow

    chain = _word_row_chain(jterms, shape)
    assert chain.op == "concat" and chain.width == 512
    assert not all(a.width == 256 for a in chain.args)  # not the two-word form
    conj = [jterms.ult(jterms.keccak(chain), jterms.const(1 << 255, 256))]
    leaves = sorted(jterms.free_vars([chain]), key=lambda t: t.tid)
    asgs = cases.random_assignments(jterms, jce, leaves, [], 5, 24)
    pconj, pasgs, pc, got = _lowered_like_jax(conj, leaves, asgs)
    k = pconj[0].args[0]
    pchain = k.args[0]
    values = {}
    plow.run_lowering_reference(pc, *plow.pack_assignments(pc, pasgs), values=values)
    pre = pbv.to_ints(values[pchain.tid], 512)
    digest = pbv.to_ints(values[k.tid], 256)
    for b, asg in enumerate(pasgs):
        vals = pce.evaluate([pchain, k, *pconj], asg)
        assert pre[b] == vals[pchain], b
        assert digest[b] == vals[k], b
        assert bool(got[b, 0]) == bool(vals[pconj[0]]), b


@pytest.mark.parametrize("shape", ["edges", "const_in_high_word", "high_word_constant",
                                   "high_word_zero", "low_word_constant"])
def test_word_row_assembles_both_words(shape):
    # once the port's tape assembled these preimages word by word; now it
    # refuses them as the JAX tape does, and the lowering evaluates them
    _word_row_case(shape)


def test_word_row_refuses_a_part_across_the_word_boundary():
    # a part across bit 256: the tapes refuse it, the lowering evaluates it
    _word_row_case("spans_both_words")


def test_apply_raises_unsupported():
    from mythril_tpu_torch.smt import terms

    x = terms.var("ptux", 256)
    f = terms.apply_func("f", 256, x)
    with pytest.raises(ptape.TapeUnsupported):
        ptape.compile_tape([terms.eq(f, terms.const(1, 256))])


def test_cache_returns_same_object():
    from mythril_tpu_torch.smt import terms

    x = terms.var("ptcx", 256)
    conj = [terms.ult(x, terms.const(99, 256))]
    assert ptape.compile_tape(conj) is ptape.compile_tape(conj)


def test_cuda_wrapper_refuses_cpu_checks():
    # the kernel's argument checks run before any build: a CPU tensor or a
    # wrong dtype is refused, never silently run on the plain path
    _conj, _asgs, pconj, pasgs = _case("add", False, n=4)
    pc = ptape.compile_tape(pconj)
    args, (T, V, A, K, R) = pc.pack_args(pasgs, "cpu")
    names = ("leaf_vals", "tab_idx", "tab_val", "tab_valid", "tab_default", "op",
             "a0", "a1", "a2", "aux", "wmask", "root_rows", "root_valid")
    with pytest.raises(ValueError, match="must be on"):
        ptape._check_cuda_args(dict(zip(names, args)), args[0].shape[0], T, V, A, K, R)
