"""Real probe traffic, replayed through the JAX solver and the PyTorch port.

``tests/testdata/torch_probe_queries.json`` holds the queries that the JAX
host engine (no frontier) puts to its solver while it analyzes three
assembled contracts from ``bench_contracts.py`` and
``tests/testdata/inputs/kill_simple.bin-runtime``, and the verdict the JAX
solver gives each one when it runs exactly the tiers the port carries
(``_torch_parity.jax_same_tiers``).  Regenerate it with

    JAX_PLATFORMS=cpu python tests/test_torch_fixture.py --write

While the engine runs, two runtime wrappers record the queries as term
dumps (the JAX package is not edited): the module attribute
``mythril_tpu.smt.solver.check_satisfiable_batch`` records each batch group
(its callers import it at call time), and ``_solve_conjunction_impl``
records each single query (``core/state/constraints.py`` binds
``solve_conjunction`` at import, so only the impl sees those calls).
Queries a recorded call makes itself (a batch's per-set residue, the
independence split's buckets) are nested and not recorded again.

Under pytest this file re-derives the JAX verdicts of the first queries of
each contract and checks them against the stored ones, and replays the
whole fixture through the port on the CPU under the keep/prune rule:
every keep/prune bool of a batch equals JAX's, every query JAX decided SAT
is SAT in the port with a model the port's ``concrete_eval`` validates,
every query JAX decided UNSAT is not SAT in the port, and no port model
fails validation.  ``chip_smoke.py`` replays the same fixture on the card.
"""

from __future__ import annotations

import json
import sys
import threading
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:  # run as a script (--write)
    sys.path.insert(0, str(REPO))
from tests._torch_parity import _one_torch_thread  # noqa: E402,F401  (autouse fixture)
FIXTURE = REPO / "tests" / "testdata" / "torch_probe_queries.json"

CONTRACTS = ("bectoken_like", "etherstore_like", "rubixi_like", "kill_simple")
REDERIVE_FIRST = 6


def _contract_code(name: str) -> bytes:
    if name == "kill_simple":
        path = REPO / "tests" / "testdata" / "inputs" / "kill_simple.bin-runtime"
        return bytes.fromhex(path.read_text().strip())
    sys.path.insert(0, str(REPO))
    import bench_contracts

    return getattr(bench_contracts, name)()


def _config_dict(config):
    if config is None:
        return None
    return {k: getattr(config, k) for k in (
        "max_rounds", "candidates_per_round", "timeout_ms", "rng_seed",
        "prune_critical", "sat_biased",
    )}


def _record(code: bytes):
    """Run the JAX host engine on one contract; return the top-level solver
    queries it made, in order, as (kind, payload) tuples of JAX terms."""
    import mythril_tpu.smt.solver as S
    from mythril_tpu.analysis.security import fire_lasers, reset_callback_modules
    from mythril_tpu.analysis.symbolic import SymExecWrapper

    records = []
    nested = [0]
    local = threading.local()
    orig_batch, orig_impl = S.check_satisfiable_batch, S._solve_conjunction_impl

    def depth():
        return getattr(local, "depth", 0)

    def batch(constraint_sets, config=None, statuses_out=None):
        if depth() == 0:
            records.append(("batch", [list(cs) for cs in constraint_sets], _config_dict(config)))
        else:
            nested[0] += 1
        local.depth = depth() + 1
        try:
            return orig_batch(constraint_sets, config, statuses_out)
        finally:
            local.depth -= 1

    def impl(conjuncts, config=None, extra_seeds=None, use_cache=True, replay=True):
        if depth() == 0 and not extra_seeds:
            records.append(("solve", list(conjuncts), _config_dict(config), use_cache, replay))
        else:
            nested[0] += 1
        local.depth = depth() + 1
        try:
            return orig_impl(conjuncts, config, extra_seeds, use_cache, replay)
        finally:
            local.depth -= 1

    S.check_satisfiable_batch, S._solve_conjunction_impl = batch, impl
    try:
        reset_callback_modules()
        sym = SymExecWrapper(
            code, address=0x0901D12E, strategy="dfs", transaction_count=2,
            execution_timeout=60,
        )
        fire_lasers(sym)
    finally:
        S.check_satisfiable_batch, S._solve_conjunction_impl = orig_batch, orig_impl
    return records, nested[0]


def _encode(records, index_of):
    out = []
    for rec in records:
        if rec[0] == "batch":
            out.append({
                "kind": "batch", "config": rec[2],
                "sets": [[index_of(t) for t in cs] for cs in rec[1]],
            })
        else:
            out.append({
                "kind": "solve", "config": rec[2], "use_cache": rec[3],
                "replay": rec[4], "conj": [index_of(t) for t in rec[1]],
            })
    return out


def replay(queries, roots, solver, device=None, stop=None):
    """Replay one contract's queries in order from cleared caches.

    ``solver`` is ``mythril_tpu.smt.solver`` or the port's
    ``mythril_tpu_torch.smt.solver``; ``device`` goes to the port's entry
    points.  Returns one result per query: a list of keep bools for a
    batch, (status, assignment) for a solve."""
    kw = {} if device is None else {"device": device}
    solver.clear_model_cache()
    results = []
    for q in queries[:stop]:
        cfg = q["config"]
        config = solver.ProbeConfig(**cfg) if cfg is not None else None
        if q["kind"] == "batch":
            sets = [[roots[i] for i in cs] for cs in q["sets"]]
            results.append(solver.check_satisfiable_batch(sets, config, **kw))
        else:
            conj = [roots[i] for i in q["conj"]]
            results.append(solver.solve_conjunction(
                conj, config, use_cache=q["use_cache"], replay=q["replay"], **kw
            ))
    return results


def verdicts_of(queries, results):
    """The fixture's stored form of ``replay``'s results."""
    return [
        r if q["kind"] == "batch" else r[0]
        for q, r in zip(queries, results)
    ]


def disagreements(queries, jax_verdicts, results, evaluate):
    """Keep/prune rule violations of port ``results`` against JAX verdicts."""
    bad = []
    for n, (q, want, got) in enumerate(zip(queries, jax_verdicts, results)):
        if q["kind"] == "batch":
            if list(got) != list(want):
                bad.append((n, "batch", want, got))
            continue
        status, asg = got
        if status == "sat":
            conj = q["_terms"]
            vals = evaluate(conj, asg)
            if not all(vals[c] for c in conj):
                bad.append((n, "invalid model", want, status))
                continue
        if want == "sat" and status != "sat":
            bad.append((n, "lost sat", want, status))
        if want == "unsat" and status == "sat":
            bad.append((n, "sat on unsat", want, status))
    return bad


def load_fixture(loader):
    """(data, roots) with ``loader`` = a ``load_terms``/``from_jax_dump``."""
    data = json.loads(FIXTURE.read_text())
    roots = loader(data["terms"])
    for contract in data["contracts"]:
        for q in contract["queries"]:
            if q["kind"] == "solve":
                q["_terms"] = [roots[i] for i in q["conj"]]
    return data, roots


def write_fixture() -> dict:
    import mythril_tpu.smt.solver as S
    from mythril_tpu.smt.serialize import dump_terms, load_terms

    from tests._torch_parity import jax_same_tiers

    recorded = []
    all_roots, index = [], {}

    def index_of(t):
        if t.tid not in index:
            index[t.tid] = len(all_roots)
            all_roots.append(t)
        return index[t.tid]

    for name in CONTRACTS:
        records, nested = _record(_contract_code(name))
        recorded.append({
            "name": name, "recorded": len(records), "nested_not_recorded": nested,
            "queries": _encode(records, index_of),
        })
        print(f"{name}: {len(records)} top-level queries, {nested} nested", flush=True)
    data = {"terms": dump_terms(all_roots), "contracts": recorded}
    roots = load_terms(data["terms"])
    with jax_same_tiers():
        for contract in recorded:
            results = replay(contract["queries"], roots, S)
            contract["jax_verdicts"] = verdicts_of(contract["queries"], results)
    FIXTURE.write_text(json.dumps(data, separators=(",", ":")))
    return data


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


def test_fixture_rederive_jax_verdicts_prefix():
    """The stored verdicts are what the JAX solver says today (prefix of
    each contract's sequence, from cleared caches)."""
    import mythril_tpu.smt.solver as S
    from mythril_tpu.smt.serialize import load_terms

    from tests._torch_parity import jax_same_tiers

    data, roots = load_fixture(load_terms)
    with jax_same_tiers():
        for contract in data["contracts"]:
            queries = contract["queries"]
            got = verdicts_of(queries, replay(queries, roots, S, stop=REDERIVE_FIRST))
            assert got == contract["jax_verdicts"][:REDERIVE_FIRST], contract["name"]


@pytest.mark.parametrize("contract", CONTRACTS)
def test_fixture_port_replay_cpu(contract):
    """The whole fixture through the port on the CPU: 0 disagreements."""
    from mythril_tpu_torch.smt import solver as P
    from mythril_tpu_torch.smt.concrete_eval import evaluate
    from mythril_tpu_torch.smt.serialize import from_jax_dump

    from tests._torch_parity import port_device_backend

    data, roots = load_fixture(from_jax_dump)
    entry = next(c for c in data["contracts"] if c["name"] == contract)
    queries = entry["queries"]
    assert queries, "fixture holds no queries for this contract"
    with port_device_backend():
        results = replay(queries, roots, P, device="cpu")
    assert disagreements(queries, entry["jax_verdicts"], results, evaluate) == []


if __name__ == "__main__":
    if "--write" not in sys.argv:
        sys.exit("usage: JAX_PLATFORMS=cpu python tests/test_torch_fixture.py --write")
    sys.path.insert(0, str(REPO))
    import os

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    written = write_fixture()
    print(json.dumps({c["name"]: len(c["queries"]) for c in written["contracts"]}))
    print(f"{FIXTURE}: {FIXTURE.stat().st_size} bytes")
