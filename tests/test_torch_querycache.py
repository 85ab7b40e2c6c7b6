"""The query cache (``mythril_tpu_torch/querycache``) against the JAX package's.

Exact, on seeded constraint sets built with the JAX package's SMT API and
carried to the port with ``_torch_parity.to_port``:

* ``canon``: the per-conjunct and whole-query fingerprints (shape, named
  digest, query hash, variable order) are equal, and renaming the variables
  leaves the query hash alone;
* ``QueryCache``: the same sequence of ``lookup`` and ``record`` calls (SAT
  with a model, UNSAT with its core, UNKNOWN under budgets; renamed twins,
  supersets, larger and smaller budgets) gives the same verdicts, the same
  models and the same ``querycache.*`` counters after every call;
* ``DiskStore``: the port writes the same files as the JAX package for the
  same records, and a port cache reads a directory the JAX package wrote.
"""

from __future__ import annotations

import importlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from tests._torch_parity import _one_torch_thread  # noqa: E402,F401  (autouse fixture)
from tests._torch_parity import (  # noqa: E402
    querycache_counters,
    reset_host_tier_counters,
    to_port,
    to_port_assignment,
)

PACKAGES = ("mythril_tpu", "mythril_tpu_torch")
N_QUERIES = 48
BUDGETS = (500, 2000, 10000)


def _atoms(rng, names):
    from mythril_tpu.smt import ULE, ULT, UGT, symbol_factory as sf

    xs = [sf.BitVecSym(n, 256) for n in names]

    def val(k):
        return sf.BitVecVal(int(k), 256)

    def atom():
        a, b, k = xs[rng.integers(len(xs))], xs[rng.integers(len(xs))], rng.integers(0, 64)
        kind = int(rng.integers(6))
        if kind == 0:
            return ULT(a, val(k))
        if kind == 1:
            return UGT(a, val(k))
        if kind == 2:
            return (a + b) == val(k)
        if kind == 3:
            return (a & val(0xFF)) != val(k)
        if kind == 4:
            return ULE(a, b)
        return a == val(k)

    return atom


def jax_queries(seed: int = 2026, n: int = N_QUERIES, prefix: str = "qc_x") -> list:
    """``n`` conjunct lists (JAX terms) of 1..4 atoms over four 256-bit
    variables named ``prefix0..3``; the same seed and another prefix give
    the same queries renamed."""
    rng = np.random.default_rng(seed)
    atom = _atoms(rng, [f"{prefix}{i}" for i in range(4)])
    return [[atom().raw for _ in range(int(rng.integers(1, 5)))] for _ in range(n)]


def _port_twins(queries):
    """The queries as port terms, and the JAX -> port term map."""
    from mythril_tpu.smt import terms as jt
    from mythril_tpu_torch.smt import terms as pt

    flat = [t for q in queries for t in q]
    ported = to_port(flat)
    it = iter(ported)
    out = [[next(it) for _ in q] for q in queries]
    by_name = {v.aux: v for v in pt.free_vars(ported)}
    return out, {v: by_name[v.aux] for v in jt.free_vars(flat)}


def model_names(result):
    """A lookup result with its model as sorted (name, value) pairs."""
    if result is None:
        return None
    status, asg = result
    if asg is None:
        return (status, None)
    return (status, sorted((t.aux, int(v)) for t, v in asg.scalars.items()))


def _reset_counters():
    for base in PACKAGES:
        reset_host_tier_counters(base)


def _fresh(base: str, cache_dir=None):
    cache = importlib.import_module(f"{base}.querycache.cache")
    qc = cache.QueryCache()
    if cache_dir is not None:
        qc.configure(cache_dir=str(cache_dir))
    return qc


def test_fingerprints_equal():
    from mythril_tpu.querycache import canon as jc
    from mythril_tpu_torch.querycache import canon as pc

    queries = jax_queries()
    twins, _ = _port_twins(queries)
    for q, p in zip(queries, twins):
        for a, b in zip(q, p):
            js, jocc, jn = jc.conjunct_fingerprint(a)
            ps, pocc, pn = pc.conjunct_fingerprint(b)
            assert (ps, pn, [v.aux for v in pocc]) == (js, jn, [v.aux for v in jocc])
        jf, pf = jc.fingerprint(q), pc.fingerprint(p)
        assert pf.qhash == jf.qhash and pf.conj_hashes == jf.conj_hashes
        assert [v.aux for v in pf.var_order] == [v.aux for v in jf.var_order]
    # renaming every variable keeps each query's hash, not its named digests
    renamed, _ = _port_twins(jax_queries(prefix="qc_y"))
    for p, r in zip(twins, renamed):
        assert pc.fingerprint(r).qhash == pc.fingerprint(p).qhash
        assert pc.fingerprint(r).conj_hashes != pc.fingerprint(p).conj_hashes


def _script(seed: int = 7):
    """The call sequence both caches run: per query, a lookup, then a
    record of its verdict (SAT with the first of eight seeded assignments
    that satisfies it, UNSAT when the interval refuter proves it, else
    UNKNOWN under a budget), then lookups of its renamed twin under each
    budget and of it with one more conjunct.  Entries: ("lookup", query
    index, "orig"/"renamed"/"super", budget, probe_models) or ("record",
    query index, status, assignment index, budget)."""
    from mythril_tpu.smt.concrete_eval import Assignment, evaluate
    from mythril_tpu.smt.intervals import refute
    from mythril_tpu.smt import terms as jt

    rng = np.random.default_rng(seed)
    queries = jax_queries()
    steps, assignments = [], []
    for i, q in enumerate(queries):
        budget = BUDGETS[i % len(BUDGETS)]
        steps.append(("lookup", i, "orig", budget, bool(i % 2)))
        found = None
        for _ in range(8):
            asg = Assignment({v: int(rng.integers(0, 80)) for v in jt.free_vars(q)})
            vals = evaluate(q, asg)
            if all(vals[c] for c in q):
                found = asg
                break
        if found is not None:
            assignments.append(found)
            steps.append(("record", i, "sat", len(assignments) - 1, None))
        elif refute(q):
            steps.append(("record", i, "unsat", None, None))
        else:
            steps.append(("record", i, "unknown", None, budget))
        for b in BUDGETS:
            steps.append(("lookup", i, "renamed", b, True))
        steps.append(("lookup", i, "super", budget, True))
    return queries, steps, assignments


def run_script(base: str, qc, queries, steps, assignments, counters: list) -> list:
    """Run ``steps`` on ``qc`` (a ``QueryCache`` of ``base``); append the
    counters after each call to ``counters``; -> each lookup's result."""
    renamed = jax_queries(prefix="qc_y")
    extra = jax_queries(seed=99, n=len(queries))
    if base == "mythril_tpu_torch":
        own, jmap = _port_twins(queries)
        renamed, _ = _port_twins(renamed)
        extra, _ = _port_twins(extra)
        assignments = [to_port_assignment(a, jmap) for a in assignments]
    else:
        own = queries
    variants = {"orig": own, "renamed": renamed,
                "super": [o + e[:1] for o, e in zip(own, extra)]}
    out = []
    for step in steps:
        if step[0] == "lookup":
            _, i, which, budget, probe = step
            out.append(model_names(qc.lookup(variants[which][i], budget_ms=budget,
                                             probe_models=probe)))
        else:
            _, i, status, a, budget = step
            qc.record(own[i], status, None if a is None else assignments[a], budget_ms=budget)
        counters.append(querycache_counters(base))
    return out


def test_lookup_and_record_sequences_equal():
    queries, steps, assignments = _script()
    results, counters = {}, {}
    for base in PACKAGES:
        _reset_counters()
        counters[base] = []
        results[base] = run_script(base, _fresh(base), queries, steps, assignments,
                                   counters[base])
    assert results["mythril_tpu_torch"] == results["mythril_tpu"]
    assert counters["mythril_tpu_torch"] == counters["mythril_tpu"]
    # every tier served something, and an UNKNOWN was retried under a larger budget
    last = counters["mythril_tpu"][-1]
    for k in ("exact_hits", "model_hits", "core_hits", "unknown_hits", "unknown_retries",
              "misses", "stores"):
        assert last[k] > 0, (k, last)


def _tree(root: Path) -> dict:
    return {str(p.relative_to(root)): json.loads(p.read_text())
            for p in sorted(root.rglob("*.json"))}


def test_disk_store_round_trip(tmp_path):
    """The port writes the JAX package's files, and reads what it wrote."""
    queries, steps, assignments = _script()
    records = [s for s in steps if s[0] == "record"]
    for base in PACKAGES:
        _reset_counters()
        run_script(base, _fresh(base, tmp_path / base), queries, records, assignments, [])
    assert _tree(tmp_path / "mythril_tpu_torch") == _tree(tmp_path / "mythril_tpu")
    assert any(k.startswith("cores/") for k in _tree(tmp_path / "mythril_tpu"))
    # a fresh port cache over the JAX package's directory answers from disk
    # as a fresh JAX cache does
    lookups = [s for s in steps if s[0] == "lookup"]
    results, counters = {}, {}
    for base in PACKAGES:
        _reset_counters()
        counters[base] = []
        results[base] = run_script(base, _fresh(base, tmp_path / "mythril_tpu"), queries,
                                   lookups, assignments, counters[base])
    assert results["mythril_tpu_torch"] == results["mythril_tpu"]
    assert counters["mythril_tpu_torch"] == counters["mythril_tpu"]
    assert counters["mythril_tpu_torch"][-1]["disk_reads"] > 0


@pytest.mark.parametrize("enabled", [True, False])
def test_singleton_configure_and_reset(enabled, tmp_path):
    """``configure``/``reset_query_cache``/``clear_query_cache_memos`` act
    on the port's singleton as on the JAX package's."""
    queries = jax_queries(n=4)
    state = {}
    for base in PACKAGES:
        qcm = importlib.import_module(f"{base}.querycache")
        own = queries if base == "mythril_tpu" else _port_twins(queries)[0]
        saved = qcm.get_query_cache().enabled
        _reset_counters()
        try:
            qcm.configure(enabled=enabled, cache_dir=str(tmp_path / base))
            qcm.reset_query_cache()
            qc = qcm.get_query_cache()
            qc.record(own[0], "unsat")
            hit = qc.lookup(own[0])
            qcm.clear_query_cache_memos()
            qcm.reset_query_cache()  # in-process layers go, the disk store stays
            again = qc.lookup(own[0])
            state[base] = (model_names(hit), model_names(again), querycache_counters(base),
                           qc.stats()["disk"])
        finally:
            qcm.configure(enabled=saved, cache_dir=None)
            qcm.reset_query_cache()
    assert state["mythril_tpu_torch"] == state["mythril_tpu"]
