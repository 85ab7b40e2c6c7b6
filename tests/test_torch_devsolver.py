"""The port's devsolver (``mythril_tpu_torch/devsolver``) on the CPU, against
the JAX package's, bit for bit (tolerance 0: integer parity).

Rows come from the JAX package's differential fuzz generators
(``tests/devsolver/test_fuzz_differential.py``), seeded, and cross to the
port through ``_torch_parity.to_port``; CNF planes come from
``tests/_torch_tier_cases.py``.  Held equal: ``blaster.blast``'s output, the
plain search ``kernel.run_torch`` against the JAX host twin ``run_host``
(status and assignment, SAT, UNSAT and UNKNOWN, both clause and variable
buckets, up to 16 queries, and the hand-built edge planes of
``dpll_edge_cases``), ``decide_batch``'s verdicts and models, and the
statuses of ``solve_conjunction`` and ``check_satisfiable_batch`` with both
new tiers on in both packages.  The decision tests run both packages at a
search budget of ``ITERS`` steps (the default is 2048: one budget-cut query
then costs the plain search seconds on the CPU) and the solver tests with a
wall-clock budget no CPU run reaches, so no verdict depends on the host's
speed.  A kernel wrapper that raises a ``DeviceError``, or a plain
``RuntimeError`` such as a kernel fault raises when its outputs are read,
propagates through ``decide_batch`` and ``solve_conjunction``.
"""

import random

import numpy as np
import pytest
import torch

from mythril_tpu import devsolver as J
from mythril_tpu.devsolver import blaster as jblaster
from mythril_tpu.devsolver import kernel as jkernel
from mythril_tpu.native.bitblast import Unsupported as JUnsupported
from mythril_tpu.smt import solver as JS
from mythril_tpu_torch import devsolver as P
from mythril_tpu_torch.devsolver import blaster as pblaster
from mythril_tpu_torch.devsolver import kernel as pkernel
from mythril_tpu_torch.native.bitblast import Unsupported as PUnsupported
from mythril_tpu_torch.smt import solver as PS
from mythril_tpu_torch.support.support_args import args as P_ARGS
from tests import _torch_tier_cases as cases
from tests._torch_parity import jax_solver_tiers, port_device_backend, to_port
from tests.devsolver import test_fuzz_differential as fuzz


def _rows(seed: int, n: int = 6):
    """Seeded JAX rows (true rows and unoriented ones, where UNSAT arises)
    and the same rows on the port's terms."""
    rng = random.Random(0xD5 + seed)
    by_width, asg = fuzz._gen_pool(rng, f"tds{seed}")
    rows = [fuzz._true_conjuncts(rng, by_width, asg, rng.randrange(1, 4)) if i % 2 else
            fuzz._random_conjuncts(rng, by_width, rng.randrange(1, 5)) for i in range(n)]
    flat = [c for r in rows for c in r]
    ported, out, i = to_port(flat), [], 0
    for r in rows:
        out.append(ported[i:i + len(r)])
        i += len(r)
    return rows, out


def _blast(mod, unsupported, row):
    try:
        b = mod.blast(row, bit_budget=64)
    except unsupported as e:
        return ("unsupported", str(e))
    return (b.clauses, b.dec_vars, b.n_vars, b.verdict, b.projected, b.truncated,
            b.abstracted, b.var_bits)


@pytest.mark.parametrize("seed", range(4))
def test_blast_output_equal(seed):
    rows, prows = _rows(seed)
    for row, prow in zip(rows, prows):
        assert _blast(pblaster, PUnsupported, prow) == _blast(jblaster, JUnsupported, row)


PLANES = [  # (seed, queries, clause bucket, variable bucket, max_iters)
    (1, 4, 512, 512, 2048),
    (2, 16, 512, 512, 2048),
    (3, 4, 512, 512, 20),
    (6, 16, 512, 512, 60),
    (4, 4, 4096, 4096, 40),
]


@pytest.mark.parametrize("seed,q,c,v,iters", PLANES)
def test_run_torch_matches_host_twin(seed, q, c, v, iters):
    plane = cases.random_cnf_plane(seed, q, c, v, jkernel)
    status, assign = jkernel.run_host(plane, iters)
    got_status, got_assign = pkernel.run_torch(
        cases.random_cnf_plane(seed, q, c, v, pkernel), iters, "cpu")
    assert got_status.dtype == torch.int8 and got_assign.dtype == torch.int8
    assert np.array_equal(got_status.numpy(), status)
    assert np.array_equal(got_assign.numpy(), assign)


def test_planes_cover_every_outcome():
    seen = set()
    for seed, q, c, v, iters in PLANES[:4]:
        p = cases.random_cnf_plane(seed, q, c, v, pkernel)
        status, _assign, steps = pkernel.run_plain(
            torch.from_numpy(p.lits), torch.from_numpy(p.dec), p.n_vars, iters)
        seen |= set(status.tolist())
        assert int(steps.max()) <= iters
    assert seen == {pkernel.SAT_Q, pkernel.UNSAT_Q, pkernel.UNKNOWN_Q}


EDGE = cases.dpll_edge_cases()


@pytest.mark.parametrize("case", EDGE, ids=[c["label"] for c in EDGE])
def test_edge_planes_match_host_twin(case):
    """The hand-built planes (``dpll_edge_cases``: the empty plane, opposite
    units, a variable implied both ways, decisions exhausted, a forced slot
    backtracked across, duplicated and tautological literals, anchor
    literals inside clauses, budgets of 0 and 1, 33 and 100 variables)
    through the port's ``device.dpll`` on CPU tensors against the JAX host
    twin ``run_host``: status and assignment; status and steps as the case
    states them."""
    from mythril_tpu_torch.devsolver import device

    lits, dec, v, iters = case["lits"], case["dec"], case["n_vars"], case["iters"]
    want_status, want_assign = jkernel.run_host(jkernel.Plane(lits, dec, lits.shape[0], v), iters)
    status, assign, steps = device.dpll(torch.from_numpy(lits), torch.from_numpy(dec), v, iters)
    assert np.array_equal(status.numpy(), want_status)
    assert np.array_equal(assign.numpy(), want_assign)
    if case["status"] is not None:
        assert status.tolist() == case["status"] and steps.tolist() == case["steps"]


ITERS = 256
NO_DEADLINE_MS = 600_000


@pytest.fixture(autouse=True)
def _budget():
    saved = dict(J._config), P_ARGS.devsolver_iters
    J.configure(iters=ITERS)
    P.configure(iters=ITERS)
    yield
    J._config.update(saved[0])
    P_ARGS.devsolver_iters = saved[1]


def _model(asg):
    return None if asg is None else sorted((t.aux, int(v)) for t, v in asg.scalars.items())


@pytest.mark.parametrize("seed", range(4))
def test_decide_batch_verdicts_and_models_match(seed):
    rows, prows = _rows(seed, 8)
    J.reset_state()
    P.reset_state()
    P.reset_counters()
    want = J.decide_batch(rows)
    got = P.decide_batch(prows, "cpu")
    assert [(s, _model(a)) for s, a in got] == [(s, _model(a)) for s, a in want]
    assert P.admitted == len({frozenset(t.tid for t in r) for r in prows})
    assert P.decided_sat + P.decided_unsat + P.unknown == P.admitted


def test_decide_batch_decides_both_ways():
    outcomes = set()
    for seed in range(4):
        _rows_j, prows = _rows(seed, 8)
        P.reset_state()
        outcomes |= {s for s, _a in P.decide_batch(prows, "cpu")}
    assert {"sat", "unsat"} <= outcomes


@pytest.fixture
def tiers_on():
    with port_device_backend(cdcl=True, tiers=True):
        P.reset_state()
        P.reset_counters()
        yield


@pytest.mark.parametrize("seed", range(3))
def test_solver_statuses_match_with_both_tiers(seed, tiers_on):
    from mythril_tpu import absdomain as JA
    from mythril_tpu_torch import absdomain as PA

    rows, prows = _rows(seed, 8)
    JA.reset_state()
    J.reset_state()
    PA.reset_state()
    with jax_solver_tiers():
        want_single = [JS.solve_conjunction(r, JS.ProbeConfig(timeout_ms=NO_DEADLINE_MS))[0]
                       for r in rows]
    PS.clear_model_cache()
    got_single = [PS.solve_conjunction(r, PS.ProbeConfig(timeout_ms=NO_DEADLINE_MS),
                                       device="cpu")[0] for r in prows]
    assert got_single == want_single
    JA.reset_state()
    J.reset_state()
    PA.reset_state()
    P.reset_state()
    want_st, got_st = [], []
    def config(mod):
        return mod.ProbeConfig(max_rounds=2, candidates_per_round=24, timeout_ms=NO_DEADLINE_MS,
                               prune_critical=True, sat_biased=True)

    with jax_solver_tiers():
        want = JS.check_satisfiable_batch(rows, config(JS), statuses_out=want_st)
    PS.clear_model_cache()
    got = PS.check_satisfiable_batch(prows, config(PS), statuses_out=got_st, device="cpu")
    assert (got, got_st) == (want, want_st)
    assert P.admitted > 0 and PA.evaluated > 0


def _launch_error():
    from mythril_tpu_torch.ops._build import KernelLaunchError

    return KernelLaunchError("dpll: CUDA error 700 at launch")


def _read_error():
    # a fault inside the kernel surfaces when its outputs are read back
    return RuntimeError("CUDA error: an illegal memory access was encountered")


@pytest.mark.parametrize("make_error", [_launch_error, _read_error])
def test_device_error_propagates(monkeypatch, tiers_on, make_error):
    from mythril_tpu_torch.devsolver import device

    error = make_error()

    def fail(*a, **kw):
        raise error

    monkeypatch.setattr(device, "dpll", fail)
    _rows_j, prows = _rows(1, 8)
    row = next(r for r in prows if not isinstance(_blast(pblaster, PUnsupported, r)[0], str)
               and pblaster.blast(r).verdict is None)
    with pytest.raises(type(error)) as got:
        P.decide_batch([row], "cpu")
    assert got.value is error
    assert P._memo_get(frozenset(t.tid for t in row)) is None
    with pytest.raises(type(error)) as got:
        PS.solve_conjunction(row, device="cpu")
    assert got.value is error
