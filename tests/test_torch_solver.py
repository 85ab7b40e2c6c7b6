"""The port's probe solver on the CPU, against the JAX package's.

The cases of tests/smt/test_batch_check.py and tests/smt/test_device_probe.py,
built once from JAX terms and carried across with ``from_jax_dump``.  The
JAX solver runs the port's tiers only (``_torch_parity.jax_same_tiers``);
the port runs its tape on the CPU (``device="cpu"``).  Verdicts must agree
and every port model must satisfy the port's ``concrete_eval``.
"""

import pytest

from mythril_tpu.smt import solver as J
from mythril_tpu.smt import terms as jt
from mythril_tpu_torch.smt import solver as P
from mythril_tpu_torch.smt.concrete_eval import evaluate
from tests._torch_parity import _one_torch_thread  # noqa: E402,F401  (autouse fixture)
from tests._torch_parity import jax_same_tiers, port_device_backend, to_port


@pytest.fixture(autouse=True)
def _port_device():
    with port_device_backend():
        P.SolverStatistics().reset()
        yield


def _sibling_sets():
    x = jt.var("pbx", 256)
    y = jt.var("pby", 256)
    prefix = [jt.eq(jt.add(x, y), jt.const(500, 256)), jt.ult(x, jt.const(100, 256))]
    cond = jt.ult(y, jt.const(450, 256))
    return [prefix + [cond], prefix + [jt.lnot(cond)]]


def _wide_fork():
    """Four siblings, one contradictory: >= 3 pending sets take the merged dispatch."""
    x = jt.var("pwx", 256)
    prefix = [jt.ult(x, jt.const(1000, 256))]
    arms = [jt.eq(jt.urem(x, jt.const(7, 256)), jt.const(k, 256)) for k in (1, 2, 3)]
    arms.append(jt.ult(jt.const(5000, 256), x))
    return [prefix + [a] for a in arms]


def _selector():
    calldata = jt.array_var("pcalldata", 256, 8)
    word = jt.concat(*[jt.select(calldata, jt.const(i, 256)) for i in range(4)])
    caller = jt.var("pcaller", 256)
    return [
        jt.eq(word, jt.const(0x41C0E1B5, 32)),
        jt.lor(jt.eq(caller, jt.const(0xDEADBEEF, 256)), jt.eq(caller, jt.const(0xAFFE, 256))),
    ]


def _sum_bound():
    x, y = jt.var("psx", 256), jt.var("psy", 256)
    return [
        jt.eq(jt.add(x, y), jt.const(1000, 256)),
        jt.ult(x, jt.const(10, 256)),
        jt.ugt(y, jt.const(100, 256)),
    ]


def _range_impossible():
    x = jt.var("prx", 256)
    return [jt.ult(x, jt.const(5, 256)), jt.ugt(x, jt.const(10, 256))]


def _keccak_slot():
    k = jt.var("pkey", 256)
    slot = jt.keccak(jt.concat2(k, jt.const(3, 256)))
    return [jt.ult(k, jt.const(1 << 160, 256)), jt.ult(jt.const(0, 256), slot)]


def _port_sets(sets):
    flat = [c for s in sets for c in s]
    ported = to_port(flat)
    out, i = [], 0
    for s in sets:
        out.append(ported[i: i + len(s)])
        i += len(s)
    return out


BATCHES = {"sibling_fork": _sibling_sets, "wide_fork": _wide_fork}


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_batch_matches_jax(name):
    sets = BATCHES[name]()
    with jax_same_tiers():
        want = J.check_satisfiable_batch(sets)
    P.clear_model_cache()
    got = P.check_satisfiable_batch(_port_sets(sets), device="cpu")
    assert got == want


def test_wide_fork_takes_one_merged_dispatch():
    sets = _port_sets(_wide_fork())
    statuses = []
    assert P.check_satisfiable_batch(sets, statuses_out=statuses, device="cpu") == [True, True, True, False]
    assert statuses[:3] == ["sat"] * 3 and statuses[3] in ("unsat", "unknown")
    assert P.SolverStatistics().device_dispatches >= 1


def test_structural_contradiction_pruned():
    from mythril_tpu_torch.smt import terms

    x = terms.var("pbcx", 256)
    sets = [[terms.ult(x, terms.const(5, 256))], [terms.false()], [terms.true()]]
    assert P.check_satisfiable_batch(sets, device="cpu") == [True, False, True]


def test_batch_matches_individual_checks():
    sets = _port_sets(_sibling_sets())
    batch = P.check_satisfiable_batch(sets, device="cpu")
    P.clear_model_cache()
    assert batch == [P.solve_conjunction(s, device="cpu")[0] == P.SAT for s in sets]


SOLVES = {
    "sum_bound": _sum_bound, "selector": _selector,
    "range_impossible": _range_impossible, "keccak_slot": _keccak_slot,
}


@pytest.mark.parametrize("name", sorted(SOLVES))
def test_solve_matches_jax(name):
    conj = SOLVES[name]()
    with jax_same_tiers():
        want, _ = J.solve_conjunction(conj)
    P.clear_model_cache()
    pconj = to_port(conj)
    got, asg = P.solve_conjunction(pconj, device="cpu")
    assert got == want
    if got == P.SAT:
        vals = evaluate(pconj, asg)
        assert all(vals[c] for c in pconj)


def test_uf_goes_to_host_and_is_counted():
    from mythril_tpu_torch.smt import terms

    x = terms.var("pux", 256)
    f = terms.apply_func("oracle", 256, x)
    conj = [terms.eq(f, terms.const(0, 256)), terms.ult(x, terms.const(5, 256))]
    status, asg = P.solve_conjunction(conj, P.ProbeConfig(sat_biased=False), device="cpu")
    assert status == P.SAT
    assert P.SolverStatistics().tape_unsupported >= 1
    # neither does the lowering take an uninterpreted function
    assert P.SolverStatistics().lowering_unsupported >= 1


def _byte_built_slot():
    """A mapping-slot hash over a preimage built byte by byte: the tapes
    refuse it, the lowerings take it."""
    k = jt.var("pbbk", 256)
    parts = [jt.extract(255 - 8 * i, 248 - 8 * i, k) for i in range(32)]
    pre = jt.concat(*parts, *[jt.const(b, 8) for b in (0,) * 31 + (3,)])
    return [jt.ult(k, jt.const(1 << 160, 256)), jt.ult(jt.const(1 << 255, 256), jt.keccak(pre))]


def test_tape_unsupported_goes_to_the_lowering(monkeypatch):
    from mythril_tpu_torch.ops import lowering

    calls = []
    plain = lowering.run_lowering_reference
    monkeypatch.setattr(lowering, "run_lowering_reference",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    conj = _byte_built_slot()
    with jax_same_tiers():
        want, _ = J.solve_conjunction(conj)
    P.clear_model_cache()
    pconj = to_port(conj)
    got, asg = P.solve_conjunction(pconj, device="cpu")
    assert got == want == P.SAT
    assert all(evaluate(pconj, asg)[c] for c in pconj)
    stats = P.SolverStatistics()
    assert (stats.tape_unsupported, stats.lowering_unsupported) == (1, 0)
    assert stats.device_dispatches == 1 and calls == [1]


def test_merged_dispatch_takes_the_tape_alone():
    # as the JAX package's _batch_probe_device: a merged set the tape
    # refuses goes to the per-set stack, each set to the lowering
    base = _byte_built_slot()
    sets = [base + [jt.ult(jt.var("pbbk", 256), jt.const(b, 256))] for b in (1 << 100, 1 << 120, 1 << 140)]
    with jax_same_tiers():
        want = J.check_satisfiable_batch(sets)
    P.clear_model_cache()
    got = P.check_satisfiable_batch(_port_sets(sets), device="cpu")
    assert got == want
    stats = P.SolverStatistics()
    assert stats.lowering_unsupported == 0 and stats.device_dispatches >= 1


class _CardFault(RuntimeError):
    pass


@pytest.mark.parametrize("where", ["launch", "readback"])
@pytest.mark.parametrize("entry", ["solve_conjunction", "check_satisfiable_batch"])
def test_lowering_errors_propagate(monkeypatch, where, entry):
    # a kernel that fails at launch, or a fault read back with its output,
    # leaves the solver: no host answer stands in for the card
    from mythril_tpu_torch.ops import _build, lowering

    if where == "launch":
        def failing(compiled, *inputs, **kw):
            raise _build.KernelLaunchError("lowering: CUDA error 700 at launch")
        expected = _build.KernelLaunchError
    else:
        class Unreadable:
            def cpu(self):
                raise _CardFault("CUDA error: an illegal memory access was encountered")

        def failing(compiled, *inputs, **kw):
            return Unreadable()
        expected = _CardFault
    monkeypatch.setattr(lowering, "run_lowering", failing)
    pconj = to_port(_byte_built_slot())
    with pytest.raises(expected):
        if entry == "solve_conjunction":
            P.solve_conjunction(pconj, device="cpu")
        else:
            P.check_satisfiable_batch([pconj], device="cpu")


def test_host_backend_never_dispatches():
    from mythril_tpu_torch.support.support_args import args

    args.probe_backend = "host"
    status, _ = P.solve_conjunction(to_port(_sum_bound()), device="cpu")
    assert status == P.SAT
    assert P.SolverStatistics().device_dispatches == 0


def test_unknown_backend_is_refused():
    from mythril_tpu_torch.support.support_args import args

    args.probe_backend = "jax"  # the JAX package's name; the port's is "device"
    with pytest.raises(ValueError, match="probe_backend"):
        P.solve_conjunction(to_port(_sum_bound()), P.ProbeConfig(sat_biased=False), device="cpu")


def test_solver_api_check_and_model():
    from mythril_tpu_torch.smt import ULT, Solver, symbol_factory

    x = symbol_factory.BitVecSym("papi_x", 256)
    y = symbol_factory.BitVecSym("papi_y", 256)
    s = Solver(device="cpu")
    s.add(x + y == symbol_factory.BitVecVal(1000, 256), ULT(x, symbol_factory.BitVecVal(10, 256)))
    assert s.check() == P.SAT
    m = s.model()
    xv, yv = m.eval(x.raw), m.eval(y.raw)
    assert xv < 10 and (xv + yv) % (1 << 256) == 1000
    assert P.SolverStatistics().device_dispatches + P.SolverStatistics().probe_hits >= 1


def test_solver_api_unsat_has_no_model():
    from mythril_tpu_torch.exceptions import UnsatError
    from mythril_tpu_torch.smt import UGT, ULT, Solver, symbol_factory

    x = symbol_factory.BitVecSym("papi_u", 256)
    s = Solver(device="cpu")
    s.add(ULT(x, symbol_factory.BitVecVal(5, 256)), UGT(x, symbol_factory.BitVecVal(10, 256)))
    assert s.check() == P.UNSAT
    with pytest.raises(UnsatError):
        s.model()


def test_optimize_minimizes():
    from mythril_tpu_torch.smt import UGT, Optimize, symbol_factory

    x = symbol_factory.BitVecSym("popt_x", 64)
    o = Optimize(device="cpu")
    o.add(UGT(x, symbol_factory.BitVecVal(41, 64)))
    o.minimize(x)
    assert o.check() == P.SAT
    assert o.model().eval(x.raw) == 42
