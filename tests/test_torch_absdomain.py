"""The port's prefilter (``mythril_tpu_torch/absdomain``) on the CPU, against
the JAX package's, bit for bit (tolerance 0: integer parity).

Term rows come from the JAX package's differential fuzz generators
(``tests/absdomain/test_fuzz_differential.py``), seeded, and cross to the
port through ``_torch_parity.to_port``; synthetic tapes with every op code,
missing children and overrides come from ``tests/_torch_tier_cases.py``.
Held equal: the ``PackedBatch`` fields array by array, the plain known-bits
pass ``eval_kb_torch`` against ``domains.eval_kb_host``, and
``prefilter_batch``'s verdicts.  A kernel wrapper that raises a
``DeviceError``, or a plain ``RuntimeError`` such as a kernel fault raises
when its outputs are read, propagates through ``prefilter_batch`` and
``solve_conjunction`` instead of becoming a fallthrough verdict.
"""

import random

import numpy as np
import pytest

from mythril_tpu import absdomain as J
from mythril_tpu.absdomain import domains as jd
from mythril_tpu.absdomain import tape as jtape
from mythril_tpu.smt import terms as jt
from mythril_tpu_torch import absdomain as P
from mythril_tpu_torch.absdomain import domains as pd
from mythril_tpu_torch.absdomain import tape as ptape
from tests._torch_parity import _one_torch_thread  # noqa: E402,F401  (autouse fixture)
from tests import _torch_tier_cases as cases
from tests._torch_parity import to_port
from tests.absdomain import test_fuzz_differential as fuzz


def _rows(seed: int, n_rows: int = 3):
    """Seeded JAX rows over one fuzz pool: true rows, then one with a pair of
    exclusive demands, and the same rows on the port's terms."""
    rng = random.Random(0x7AB0 + seed)
    by_width, asg = fuzz._gen_pool(rng, f"tp{seed}")
    rows = [fuzz._true_conjuncts(rng, by_width, asg, rng.randrange(1, 5))
            for _ in range(n_rows)]
    x = rng.choice(by_width[256])
    rows.append(rows[0] + [jt.ult(x, jt.const(5, 256)), jt.ult(jt.const(10, 256), x)])
    flat = [c for r in rows for c in r]
    ported, out, i = to_port(flat), [], 0
    for r in rows:
        out.append(ported[i:i + len(r)])
        i += len(r)
    return rows, out


def _packs(seed: int):
    rows, prows = _rows(seed)
    return jtape.pack(rows), ptape.pack(prows)


def _u32(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("seed", range(6))
def test_pack_fields_equal(seed):
    jp, pp = _packs(seed)
    assert (jp.n_nodes, jp.n_rows) == (pp.n_nodes, pp.n_rows)
    for name in ("op", "w", "a0", "a1", "a2", "x0", "x1", "wm", "c_limbs", "c_lo", "c_hi",
                 "row_refuted"):
        a, b = getattr(jp, name), getattr(pp, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert jp.row_roots == pp.row_roots
    assert sorted(jp.overrides) == sorted(pp.overrides)
    for node, ov in jp.overrides.items():
        for a, b in zip(ov, pp.overrides[node]):
            assert np.array_equal(a, b), node
    assert jp.ov_exact == pp.ov_exact


@pytest.mark.parametrize("seed", range(6))
def test_plain_known_bits_matches_host_twin_on_fuzz_rows(seed):
    jp, pp = _packs(seed)
    km, kv, ref = jd.eval_kb_host(jp)
    pkm, pkv, pref = pd.eval_kb_torch(pp, "cpu")
    assert np.array_equal(km, _u32(pkm)) and np.array_equal(kv, _u32(pkv))
    assert np.array_equal(ref, pref.numpy())


@pytest.mark.parametrize("seed,n_nodes,n_rows", [
    (1, 64, 1), (2, 200, 3), (3, 300, 2), (4, 512, 16), (5, 96, 64)])
def test_plain_known_bits_matches_host_twin_on_synthetic_tapes(seed, n_nodes, n_rows):
    fields = cases.random_kb_fields(seed, n_nodes, n_rows)
    km, kv, ref = jd.eval_kb_host(cases.kb_pack(fields, jtape))
    pkm, pkv, pref = pd.eval_kb_torch(cases.kb_pack(fields, ptape), "cpu")
    assert np.array_equal(km, _u32(pkm)) and np.array_equal(kv, _u32(pkv))
    assert np.array_equal(ref, pref.numpy())
    if n_nodes == 512:  # every op code, and rows both refuted and not
        assert set(fields["op"]) >= set(range(32)) and ref.any() and not ref.all()


def test_missing_children_read_zeros():
    """A node whose child index is -1 reads km = kv = 0 (the host twin's
    dummy), not node 0."""
    fields = cases.random_kb_fields(7, 40, 2)
    fields["op"][20], fields["a0"][20], fields["a1"][20] = 8, -1, 3  # add(missing, n3)
    fields["op"][0], fields["c_limbs"][0] = 0, ptape._limbs_of((1 << 64) - 1)
    km, kv, _ = jd.eval_kb_host(cases.kb_pack(fields, jtape))
    pkm, pkv, _ = pd.eval_kb_torch(cases.kb_pack(fields, ptape), "cpu")
    assert np.array_equal(km[20], _u32(pkm)[20]) and np.array_equal(kv[20], _u32(pkv)[20])


@pytest.mark.parametrize("seed", range(4))
def test_prefilter_batch_verdicts_match(seed):
    rows, prows = _rows(seed)
    J.reset_state()
    P.reset_state()
    want = J.prefilter_batch(rows)
    got = P.prefilter_batch(prows, "cpu")
    assert got == want and want[-1] is True and not any(want[:-1])
    assert (P.evaluated, P.killed) >= (len(rows), 1)
    # memo hits are free and uncounted
    before = P.evaluated
    assert P.prefilter_batch(prows, "cpu") == want and P.evaluated == before


def _launch_error():
    from mythril_tpu_torch.ops._build import KernelLaunchError

    return KernelLaunchError("known_bits: CUDA error 700 at launch")


def _read_error():
    # a fault inside the kernel surfaces when its outputs are read back
    return RuntimeError("CUDA error: an illegal memory access was encountered")


@pytest.mark.parametrize("make_error", [_launch_error, _read_error])
def test_device_error_propagates(monkeypatch, make_error):
    from mythril_tpu_torch.absdomain import device
    from mythril_tpu_torch.smt import solver

    error = make_error()

    def fail(*a, **kw):
        raise error

    monkeypatch.setattr(device, "known_bits", fail)
    _rows_j, prows = _rows(11)
    P.reset_state()
    P.reset_counters()
    with pytest.raises(type(error)) as got:
        P.prefilter_batch(prows, "cpu")
    assert got.value is error and P.fallthrough == 0
    solver.clear_model_cache()
    with pytest.raises(type(error)) as got:
        solver.solve_conjunction(prows[-1], device="cpu")
    assert got.value is error
    assert P._memo_get(frozenset(t.tid for t in prows[-1])) is None
