"""The port's native CDCL tier (``mythril_tpu_torch/native/``) against the JAX
package's (``mythril_tpu/native/``), exactly.

Conjunctions are built on the JAX side from numpy-seeded constants, in the
term shapes of ``tests/native/test_bitblast.py`` and ``test_cegar.py``, and
carried to the port with ``to_port``.  Each package serializes and solves
them with its own copy of the C++ library.  Tolerance 0: ``serialize``'s
tape equal field by field (records, constants, roots, the fresh variables
and the select, keccak and UF sites the congruence clauses come from) in the
eager and the lazy select modes; ``solve`` the same status and, on SAT, the
same model; ``OptimizeSession`` the same answers to the same bound queries;
``Optimize`` and the CDCL tiers of ``solve_conjunction`` the same optima
and verdicts; the native keccak the same digests.
"""

import numpy as np
import pytest

from mythril_tpu.native import bitblast as JB
from mythril_tpu.native import keccak as JK
from mythril_tpu.ops.keccak import keccak256_int as jax_keccak256_int
from mythril_tpu.smt import terms as T
from mythril_tpu_torch.native import bitblast as PB
from mythril_tpu_torch.native import keccak as PK
from mythril_tpu_torch.ops import keccak as port_keccak
from tests._torch_parity import _one_torch_thread  # noqa: E402,F401  (autouse fixture)
from tests._torch_parity import port_device_backend, to_port, to_port_assignment

TIMEOUT = 20.0


def c(v, w=256):
    return T.const(int(v), w)


def _rng(name: str) -> np.random.RandomState:
    return np.random.RandomState(sum(map(ord, name)))


def _linear(r):
    x, y = T.var("nb_x", 32), T.var("nb_y", 32)
    k = int(r.randint(60, 200))
    return [T.eq(T.add(x, y), c(k, 32)), T.ult(x, c(10, 32)), T.ult(c(k // 2, 32), y)]


def _interval_conflict(r):
    x = T.var("nb_i", 32)
    lo = int(r.randint(2, 100))
    return [T.ult(x, c(lo, 32)), T.ult(c(lo + int(r.randint(1, 50)), 32), x)]


def _parity(r):
    x = T.var("nb_p", 32)
    return [T.eq(T.mul(x, c(2 * int(r.randint(1, 1000)), 32)), c(2 * int(r.randint(0, 99)) + 1, 32))]


def _division(r):
    x = T.var("nb_d", 16)
    d = int(r.randint(3, 20))
    return [T.eq(T.udiv(x, c(d, 16)), c(5, 16)), T.eq(T.urem(x, c(d, 16)), c(d - 1, 16)),
            T.lnot(T.eq(T.udiv(x, c(0, 16)), c(1, 16)))]


def _signed(r):
    x = T.var("nb_s", 8)
    return [T.slt(x, c(0, 8)), T.sle(c(int(r.randint(0x80, 0xFF)), 8), x),
            T.eq(T.sdiv(x, c(0xFF, 8)), T.srem(x, c(3, 8)))]


def _shifts(r):
    x, s = T.var("nb_sx", 16), T.var("nb_ss", 16)
    return [T.ule(c(int(r.randint(1, 15)), 16), s),
            T.eq(T.bor(T.shl(x, s), T.lshr(x, s)), c(int(r.randint(1, 1 << 16)), 16)),
            T.lnot(T.eq(T.ashr(x, c(3, 16)), c(0, 16)))]


def _bits(r):
    x = T.var("nb_bx", 64)
    lo = T.extract(15, 0, x)
    wide = T.zext(T.concat(lo, T.extract(63, 48, x)), 32)
    return [T.eq(T.sext(T.extract(7, 0, x), 56), c(int(r.randint(0, 1 << 63)) | (1 << 63), 64)),
            T.ult(c(int(r.randint(1, 1 << 20)), 64), wide), T.lnot(T.eq(T.bnot(x), T.neg(x)))]


def _array_conflict(r):
    a = T.array_var("nb_storage", 256, 256)
    i = c(int(r.randint(0, 1000)))
    return [T.eq(T.select(a, i), c(7)), T.eq(T.select(a, i), c(8))]


def _store_chain(r):
    a = T.array_var("nb_store", 256, 256)
    k, v = int(r.randint(0, 100)), int(r.randint(1, 1 << 30))
    stored = T.store(T.store(a, c(k), c(v)), c(k + 1), c(v + 1))
    return [T.eq(T.select(stored, c(k)), c(v)), T.eq(T.select(stored, c(k + 2)), c(9)),
            T.eq(T.select(a, c(k + 2)), c(9))]


def _symbolic_index(r):
    a = T.array_var("nb_ack", 256, 256)
    i, j = T.var("nb_ai", 256), T.var("nb_aj", 256)
    base = int(r.randint(0, 64))
    return [T.eq(T.select(a, i), c(1)), T.eq(T.select(a, c(base)), c(2)),
            T.eq(T.select(a, T.add(j, c(1))), c(3)), T.ult(j, c(base + 4))]


def _memory_word(r):
    """A calldata-style word read: 32 byte selects at base + k (provably
    distinct pairs skip congruence) pinned to a value, beside a byte read
    further on."""
    a = T.array_var("nb_mem", 256, 8)
    p = T.var("nb_mp", 256)
    word = T.concat(*[T.select(a, T.add(p, c(k))) for k in range(32)])
    return [T.eq(word, c(int(r.randint(1, 1 << 30)))),
            T.eq(T.select(a, T.add(p, c(40))), c(int(r.randint(1, 255)), 8)),
            T.ult(p, c(1 << 20))]


def _congruence_refined(r):
    a = T.array_var("nb_cg", 256, 8)
    i, j = T.var("nb_ci", 256), T.var("nb_cj", 256)
    return [T.eq(i, T.add(j, c(int(r.randint(0, 2))))),
            T.lnot(T.eq(T.select(a, i), T.select(a, j))), T.ult(j, c(100))]


def _keccak_congruence(r):
    x, y = T.var("nb_kx", 256), T.var("nb_ky", 256)
    return [T.eq(x, y), T.lnot(T.eq(T.keccak(x), T.keccak(y)))]


def _keccak_real_hash(r):
    x = T.var("nb_kh", 256)
    v = int(r.randint(0, 1 << 30))
    return [T.eq(x, c(v)), T.eq(T.keccak(x), c(jax_keccak256_int(v, 32)))]


def _keccak_wrong_value(r):
    x = T.var("nb_kw", 256)
    v = int(r.randint(0, 1 << 30))
    return [T.eq(x, c(v)), T.eq(T.keccak(x), c(jax_keccak256_int(v + 1, 32)))]


def _keccak_distinct(r):
    x, y = T.var("nb_kdx", 256), T.var("nb_kdy", 256)
    v = int(r.randint(0, 1 << 30))
    return [T.eq(x, c(v)), T.eq(y, c(v + 1)), T.eq(T.keccak(x), T.keccak(y))]


def _keccak_chain(r):
    x = T.var("nb_kc", 256)
    v = int(r.randint(0, 1 << 30))
    return [T.eq(x, c(v)), T.eq(T.keccak(T.keccak(x)), c(jax_keccak256_int(jax_keccak256_int(v, 32), 32)))]


def _keccak_slot(r):
    """A mapping slot keccak(key . slot) read from storage."""
    s = T.array_var("nb_ks", 256, 256)
    key = T.var("nb_kk", 256)
    slot = T.keccak(T.concat(key, c(int(r.randint(0, 8)))))
    return [T.ult(c(int(r.randint(1, 1 << 20))), T.select(s, slot)), T.ult(key, c(1 << 160))]


def _uf(r):
    x, y = T.var("nb_ux", 64), T.var("nb_uy", 64)
    fx, fy = T.apply_func("nb_f", 64, x), T.apply_func("nb_f", 64, y)
    return [T.eq(x, y), T.eq(fx, c(int(r.randint(0, 100)), 64)), T.eq(fy, c(int(r.randint(100, 200)), 64))]


def _exp(r):
    e, b = T.var("nb_e", 256), T.var("nb_b", 64)
    k = int(r.randint(2, 40))
    return [T.eq(T.bvexp(c(2), e), c(1 << k)), T.eq(T.bvexp(b, c(3, 64)), c(27, 64)),
            T.eq(T.bvexp(c(4), T.add(e, c(200))), c(0))]


def _balance_flow(r):
    bal, amt = T.var("nb_bal", 256), T.var("nb_amt", 256)
    return [T.ule(amt, bal), T.eq(T.sub(bal, amt), c(int(r.randint(1, 1 << 40)))),
            T.ne(amt, c(0)), T.lnot(T.eq(T.mul(amt, c(3)), T.add(bal, c(1))))]


def _overflow_mul(r):
    """SWC-101's wide-multiply shape: cnt * value overflows 256 bits."""
    cnt, val = T.var("nb_cnt", 256), T.var("nb_val", 256)
    prod = T.mul(T.zext(cnt, 256), T.zext(val, 256))
    return [T.ult(c((1 << 256) - 1, 512), prod), T.ult(cnt, c(int(r.randint(2, 20)))),
            T.ult(c(0), cnt)]


def _random8(r):
    x, y = T.var("nb_rx", 8), T.var("nb_ry", 8)
    ops = [T.add, T.sub, T.mul, T.band, T.bor, T.bxor]
    out = []
    for _ in range(3):
        op = ops[int(r.randint(len(ops)))]
        rhs = y if r.randint(2) else c(int(r.randint(256)), 8)
        out.append(T.eq(op(x, rhs), c(int(r.randint(256)), 8)))
    out.append(T.ult(x, c(int(r.randint(2, 256)), 8)))
    return out


CASES = {f.__name__.lstrip("_"): f for f in (
    _linear, _interval_conflict, _parity, _division, _signed, _shifts, _bits, _array_conflict,
    _store_chain, _symbolic_index, _memory_word, _congruence_refined, _keccak_congruence,
    _keccak_real_hash, _keccak_wrong_value, _keccak_distinct, _keccak_chain, _keccak_slot,
    _uf, _exp, _balance_flow, _overflow_mul, _random8)}


def both(name: str):
    """(JAX conjuncts, the port's, {JAX term: port term} over every DAG node)."""
    jax = CASES[name](_rng(name))
    order = list(T.topo_order(jax))
    port = to_port(order)
    mapping = dict(zip(order, port))
    return jax, [mapping[t] for t in jax], mapping


def tape_fields(tape, term_of) -> dict:
    """``serialize``'s tape, with every term through ``term_of``."""
    return {
        "records": list(tape.records),
        "consts": bytes(tape.consts),
        "roots": list(tape.roots),
        "var_meta": [(m[0], *[term_of(x) for x in m[1:]]) for m in tape.var_meta],
        "selects": [[(i, v, term_of(t)) for i, v, t in sites] for sites in tape.selects.values()],
        "keccaks": [(i, v, term_of(t)) for i, v, t in tape.keccaks],
        "applies": [(k, [(list(a), v) for a, v in sites]) for k, sites in tape.applies.items()],
    }


def same_model(jax_asg, port_asg, mapping) -> None:
    want = to_port_assignment(jax_asg, mapping)
    assert port_asg.scalars == want.scalars
    assert port_asg.arrays.keys() == want.arrays.keys()
    for k, arr in want.arrays.items():
        got = port_asg.arrays[k]
        assert (got.backing, got.default) == (arr.backing, arr.default)
    assert port_asg.ufs == jax_asg.ufs


def test_both_libraries_build():
    assert JB.available() and PB.available()
    assert JK.available() and PK.available()


@pytest.mark.parametrize("lazy", [False, True], ids=["eager", "lazy"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_serialize_tape_matches_jax(name, lazy):
    jax, port, mapping = both(name)
    want = tape_fields(JB.serialize(jax, lazy_selects=lazy), lambda t: mapping[t])
    got = tape_fields(PB.serialize(port, lazy_selects=lazy), lambda t: t)
    assert got == want


def test_serialize_with_objectives_matches_jax():
    jax, port, mapping = both("overflow_mul")
    objs = [T.zext(T.var("nb_cnt", 256), 8), T.var("nb_val", 256)]
    objs_port = to_port(objs)
    mapping.update(zip(objs, objs_port))
    for t, p in zip(T.topo_order(objs), to_port(list(T.topo_order(objs)))):
        mapping.setdefault(t, p)
    want = tape_fields(JB.serialize(jax, extra=objs, lazy_selects=True), lambda t: mapping[t])
    got = tape_fields(PB.serialize(port, extra=objs_port, lazy_selects=True), lambda t: t)
    assert got == want


@pytest.mark.parametrize("name", sorted(CASES))
def test_solve_matches_jax(name):
    jax, port, mapping = both(name)
    want_status, want_asg = JB.solve(jax, TIMEOUT)
    got_status, got_asg = PB.solve(port, TIMEOUT)
    assert want_status != JB.UNKNOWN
    assert got_status == want_status
    if want_status == JB.SAT:
        same_model(want_asg, got_asg, mapping)


def _session_queries(mod, conj, obj, guarded):
    """A fixed script of bound and guard queries on one OptimizeSession."""
    out = []
    with mod.OptimizeSession(conj, objectives=[obj], guarded=guarded) as s:
        for bounds, enable in (([], ()), ([(0, "le", 3)], ()), ([(0, "le", 2)], ()),
                               ([(0, "ge", 200)], ()), ([(0, "eq", 7)], (0,)), ([], (1,)),
                               ([(0, "le", 5)], (0,)), ([], (0, 1))):
            status, asg = s.solve(bounds, TIMEOUT, enable=enable)
            out.append((status, None if asg is None else mod.evaluate([obj], asg)[obj]))
    return out


def test_optimize_session_matches_jax():
    """Bound queries after select-congruence and keccak refinement on the
    live session (``bb_extend``), with guarded terms."""
    a = T.array_var("nb_os", 256, 8)
    i, j, x = T.var("nb_oi", 256), T.var("nb_oj", 256), T.var("nb_ox", 256)
    obj = T.zext(T.select(a, i), 248)
    conj = [T.ule(c(3), obj), T.eq(i, j)]
    guarded = [T.lnot(T.eq(T.select(a, i), T.select(a, j))),
               T.land(T.eq(x, c(5)), T.eq(T.keccak(x), c(jax_keccak256_int(5, 32))))]
    order = list(T.topo_order(conj + [obj] + guarded))
    m = dict(zip(order, to_port(order)))
    want = _session_queries(JB, conj, obj, guarded)
    got = _session_queries(PB, [m[t] for t in conj], m[obj], [m[g] for g in guarded])
    assert got == want
    assert [s for s, _ in want] == ["sat", "sat", "unsat", "sat", "unsat", "sat", "unsat",
                                    "unsat"]


@pytest.fixture
def tiers():
    """Both solvers with native CDCL on and the host candidate stream."""
    from mythril_tpu.smt import solver as JS
    from mythril_tpu.support.support_args import args as jargs
    from mythril_tpu_torch.smt import solver as PS
    from mythril_tpu_torch.support.support_args import args as pargs
    from tests._torch_parity import jax_cdcl_tiers

    with jax_cdcl_tiers(), port_device_backend(cdcl=True):
        jargs.probe_backend, pargs.probe_backend = "host", "host"
        yield JS, PS, jargs, pargs


@pytest.mark.parametrize("name", ["linear", "division", "symbolic_index", "keccak_slot",
                                  "overflow_mul", "balance_flow"])
def test_optimize_matches_jax(tiers, name):
    JS, PS, _, _ = tiers
    jax, port, mapping = both(name)
    free = [v for v in T.free_vars(jax) if v.op == "var"]
    lo, hi = free[0], free[-1]
    jopt = JS.Optimize(JS.ProbeConfig(timeout_ms=20000))
    popt = PS.Optimize(PS.ProbeConfig(timeout_ms=20000), device="cpu")
    jopt.add(*jax)
    popt.add(*port)
    jopt.minimize(lo)
    popt.minimize(mapping[lo])
    jopt.maximize(hi)
    popt.maximize(mapping[hi])
    status = jopt.check()
    assert popt.check() == status
    assert popt.proven_optimal == jopt.proven_optimal
    if status == "sat":
        jm, pm = jopt.model(), popt.model()
        assert [pm.eval(mapping[v]) for v in (lo, hi)] == [jm.eval(v) for v in (lo, hi)]


@pytest.mark.parametrize("backend", ["host", "cdcl"])
@pytest.mark.parametrize("name", ["parity", "division", "shifts", "congruence_refined",
                                  "keccak_wrong_value", "keccak_distinct", "uf", "exp",
                                  "overflow_mul", "random8"])
def test_solve_conjunction_cdcl_tiers_match_jax(tiers, backend, name):
    """Tier 2 after the ``cheap_exact``-capped probe, and the forced exact
    mode: the same verdict, model and CDCL call count."""
    JS, PS, jargs, pargs = tiers
    jargs.probe_backend, pargs.probe_backend = backend, backend
    jax, port, mapping = both(name)
    JS.SolverStatistics().reset()
    PS.SolverStatistics().reset()
    want_status, want_asg = JS.solve_conjunction(jax, JS.ProbeConfig(timeout_ms=20000))
    got_status, got_asg = PS.solve_conjunction(port, PS.ProbeConfig(timeout_ms=20000),
                                               device="cpu")
    assert got_status == want_status
    assert PS.SolverStatistics().cdcl_calls == JS.SolverStatistics().cdcl_calls
    if want_status == "sat":
        same_model(want_asg, got_asg, mapping)


def test_native_keccak_matches_jax_and_python():
    r = np.random.RandomState(3)
    for n in (0, 1, 31, 32, 64, 135, 136, 137, 300):
        data = r.randint(0, 256, n).astype(np.uint8).tobytes()
        assert PK.keccak256(data) == JK.keccak256(data) == port_keccak.keccak256_py(data)
        assert port_keccak.keccak256(data) == port_keccak.keccak256_py(data)
    batch = [r.randint(0, 256, 64).astype(np.uint8).tobytes() for _ in range(17)]
    assert PK.keccak256_batch(batch) == JK.keccak256_batch(batch)
    for v in r.randint(0, 1 << 62, 8):
        assert port_keccak.keccak256_int(int(v), 32) == jax_keccak256_int(int(v), 32)
