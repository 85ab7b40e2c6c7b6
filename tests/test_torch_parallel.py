"""The port's device mesh (``mythril_tpu_torch/parallel``) against the JAX
package's (``mythril_tpu/parallel``), exactly: every output is an integer
or a bool, so the tolerance is 0.

The JAX side runs on the 8 virtual CPU devices ``tests/conftest.py`` forces;
the port on a mesh of 8 logical shards of the CPU
(``parallel.mesh.logical_shards``), its counterpart.  The cases are those of
``tests/parallel/test_mesh.py`` and ``test_corpus.py``, each also held
against the JAX result on the same inputs, plus numpy-seeded frontiers, the
solver's sharded-probe gate and two gloo processes whose corpus shards come
from ``torch.distributed``.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tests._torch_parity import _one_torch_thread  # noqa: F401  (autouse fixture)

REPO = Path(__file__).resolve().parent.parent


def _packages():
    import mythril_tpu.parallel as jpar
    import mythril_tpu.smt.concrete_eval as jce
    import mythril_tpu.smt.terms as jterms
    import mythril_tpu_torch.parallel as ppar
    import mythril_tpu_torch.smt.concrete_eval as pce
    import mythril_tpu_torch.smt.terms as pterms
    from mythril_tpu.ops import lowering as jlow
    from mythril_tpu_torch.ops import lowering as plow

    return {"jax": (jterms, jce, jlow, jpar), "port": (pterms, pce, plow, ppar)}


def _problem(T):
    x = T.var("x", 256)
    y = T.var("y", 256)
    return x, y, [T.eq(T.add(x, y), T.const(100, 256)), T.ult(x, T.const(60, 256))]


def _assignments(T, ce, pairs):
    x, y, _ = _problem(T)
    out = []
    for a, b in pairs:
        asg = ce.Assignment()
        asg.scalars[x] = a
        asg.scalars[y] = b
        out.append(asg)
    return out


@pytest.fixture
def port_mesh():
    """The port's 8-shard logical mesh of the CPU, inside ``logical_shards(8)``."""
    from mythril_tpu_torch.parallel.mesh import logical_shards, make_frontier_mesh, mesh_devices

    with logical_shards(8):
        yield make_frontier_mesh(mesh_devices("cpu"))


def test_factor_2d():
    from mythril_tpu.parallel.mesh import _factor_2d as jax_factor
    from mythril_tpu_torch.parallel.mesh import _factor_2d

    assert _factor_2d(8) == (2, 4)
    assert _factor_2d(4) == (2, 2)
    assert _factor_2d(1) == (1, 1)
    assert _factor_2d(6) == (2, 3)
    assert [_factor_2d(n) for n in range(1, 33)] == [jax_factor(n) for n in range(1, 33)]


def test_mesh_shape_uses_all_devices(port_mesh):
    from mythril_tpu.parallel import make_frontier_mesh as jax_mesh
    from mythril_tpu_torch.device import NoCudaDevice
    from mythril_tpu_torch.parallel import make_frontier_mesh
    from mythril_tpu_torch.parallel.mesh import logical_shards, mesh_devices

    want = jax_mesh()
    assert port_mesh.size == jax.device_count() == 8
    assert port_mesh.axis_names == want.axis_names == ("path", "cand")
    assert port_mesh.devices.shape == want.devices.shape
    assert dict(port_mesh.shape) == dict(want.shape)
    assert all(d == torch.device("cpu") for d in port_mesh.devices.flat)
    with logical_shards(3):
        assert make_frontier_mesh(mesh_devices("cpu"), path_size=3).shape == {"path": 3, "cand": 1}
    with pytest.raises(ValueError, match="does not divide"):
        make_frontier_mesh(["cpu"] * 8, path_size=3)
    if not torch.cuda.is_available():
        # the default mesh is the card's: none here
        with pytest.raises(NoCudaDevice):
            make_frontier_mesh()


def test_sharded_eval_matches_host(port_mesh):
    pk = _packages()
    # 10 candidates: not divisible by 8 devices, exercises padding
    pairs = [(i, 100 - i) for i in range(5)] + [(70, 30), (1, 2), (3, 4), (59, 41), (0, 0)]
    T, ce, low, par = pk["jax"]
    jc = low.compile_conjunction(_problem(T)[2])
    want = np.asarray(par.evaluate_batch_sharded(jc, _assignments(T, ce, pairs)))
    T, ce, low, par = pk["port"]
    compiled = low.compile_conjunction(_problem(T)[2])
    asgs = _assignments(T, ce, pairs)
    truth_host = compiled.evaluate_batch(asgs, "cpu")
    truth_mesh = par.evaluate_batch_sharded(compiled, asgs, port_mesh)
    assert truth_mesh.shape == truth_host.shape == want.shape == (10, 2)
    np.testing.assert_array_equal(truth_mesh, truth_host)
    np.testing.assert_array_equal(truth_mesh, want)
    # (59, 41) is the only fully-sat row among the tail
    assert truth_mesh[8].all()
    assert not truth_mesh[5].all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sharded_eval_seeded_batches(port_mesh, seed):
    """numpy-seeded candidate batches of every size from 1 to 40 (every
    padding the 8 shards can need): the mesh, the host and the JAX mesh
    agree."""
    pk = _packages()
    rng = np.random.default_rng(seed)
    sizes = rng.choice(np.arange(1, 41), 6, replace=False)
    for B in sizes:
        pairs = [(int(a), int(b)) for a, b in rng.integers(0, 120, size=(B, 2))]
        T, ce, low, par = pk["jax"]
        want = np.asarray(par.evaluate_batch_sharded(
            low.compile_conjunction(_problem(T)[2]), _assignments(T, ce, pairs)))
        T, ce, low, par = pk["port"]
        compiled = low.compile_conjunction(_problem(T)[2])
        asgs = _assignments(T, ce, pairs)
        got = par.evaluate_batch_sharded(compiled, asgs, port_mesh)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, compiled.evaluate_batch(asgs, "cpu"))


def _steps(frontier_pairs, mesh):
    """The JAX step on its mesh, the port's on ``mesh`` and unsharded, each
    as numpy arrays (scores, best_score, best_idx, n_sat)."""
    pk = _packages()
    out = {}
    T, ce, low, par = pk["jax"]
    jc = low.compile_conjunction(_problem(T)[2])
    args, valid = par.pack_frontier(jc, [_assignments(T, ce, p) for p in frontier_pairs])
    fits = valid.shape[0] % 2 == 0 and valid.shape[1] % 4 == 0  # the (2, 4) mesh
    sharded = par.shard_probe_args(args, par.make_frontier_mesh(), batch_dims=2) if fits else args
    out["jax"] = [np.asarray(v) for v in par.frontier_step(jc)(*sharded, valid)]
    T, ce, low, par = pk["port"]
    compiled = low.compile_conjunction(_problem(T)[2])
    args, pvalid = par.pack_frontier(compiled, [_assignments(T, ce, p) for p in frontier_pairs])
    np.testing.assert_array_equal(pvalid, valid)
    step = par.frontier_step(compiled)
    out["port"] = [v.numpy() for v in step(*args, pvalid)]
    if fits:
        out["mesh"] = [v.numpy() for v in step(*par.shard_probe_args(args, mesh, batch_dims=2),
                                               pvalid)]
    return out


def _same(out):
    for name, got in out.items():
        for a, b in zip(got, out["jax"]):
            assert a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_frontier_step_reductions(port_mesh):
    p_axis, c_axis = port_mesh.devices.shape
    paths, cands = 2 * p_axis, 4 * c_axis
    out = _steps([[(i + j, 100 - i - j) for j in range(cands)] for i in range(paths)], port_mesh)
    assert set(out) == {"jax", "port", "mesh"}
    _same(out)
    scores, best, best_idx, n_sat = out["mesh"]
    assert scores.shape == (paths, cands)
    assert best.shape == (paths,)
    # every candidate sums to 100 and all x values are < 60 here
    assert int(n_sat) == paths * cands
    assert int(best.min()) == 2


def test_frontier_step_ragged_padding_cannot_double_count(port_mesh):
    """A ragged frontier padded by row-repeat must not inflate n_sat."""
    # path 0: one fully-sat candidate (gets padded by repetition to len 4)
    # path 1: four candidates, two sat
    out = _steps([[(10, 90)], [(10, 90), (70, 30), (20, 80), (0, 1)]], port_mesh)
    _same(out)
    scores, best, best_idx, n_sat = out["port"]
    # without the mask the repeated (10, 90) rows would make n_sat 6
    assert int(n_sat) == 3
    assert int(best_idx[0]) == 0
    # masked rows surface as -1, never winning a max
    assert scores[0, 1:].max() == -1


@pytest.mark.parametrize("seed", [0, 1])
def test_frontier_step_seeded_ragged_frontier(port_mesh, seed):
    """numpy-seeded ragged frontiers of 4 paths x up to 8 candidates (the
    ties of best_idx included: the first maximum, as ``jnp.argmax``): the
    JAX mesh, the port's mesh and its unsharded step agree."""
    rng = np.random.default_rng(seed)
    frontier = []
    for p in range(4):
        n = int(rng.integers(1, 9)) if p else 8  # the longest path sets B = 8
        frontier.append([(int(a), int(b)) for a, b in rng.integers(0, 110, size=(n, 2))])
    out = _steps(frontier, port_mesh)
    assert set(out) == {"jax", "port", "mesh"}
    _same(out)


def test_shard_probe_args_blocks_follow_the_mesh(port_mesh):
    """Each block holds its (path, cand) rows, or its slice of the flat
    batch, in the mesh's device order."""
    from mythril_tpu_torch.parallel import shard_probe_args

    leaf = torch.arange(4 * 8 * 3, dtype=torch.int32).reshape(4, 8, 3)
    _, bools, _ = shard_probe_args(((), leaf, ()), port_mesh, batch_dims=2)
    assert bools.shape == (4, 8) and len(bools.blocks) == 8
    for k, block in enumerate(bools.blocks):
        i, j = divmod(k, 4)
        assert torch.equal(block, leaf[2 * i:2 * i + 2, 2 * j:2 * j + 2])
    flat = torch.arange(16 * 2, dtype=torch.int32).reshape(16, 2)
    _, bools, _ = shard_probe_args(((), flat, ()), port_mesh, batch_dims=1)
    assert [b[:, 0].tolist() for b in bools.blocks] == [[4 * k, 4 * k + 2] for k in range(8)]
    with pytest.raises(ValueError, match="does not split"):
        shard_probe_args(((), flat[:15], ()), port_mesh, batch_dims=1)


def test_solver_gate_shards_lowering_batches(monkeypatch):
    """``_evaluate_candidates_device`` takes the JAX gate: a lowering of at
    least 16 candidates on a device whose mesh spans more than one device
    goes to ``evaluate_batch_sharded``; fewer candidates, one device or a
    tape take the single launch, with the same truth."""
    import mythril_tpu_torch.parallel as par
    from mythril_tpu_torch.ops import lowering, tape_vm
    from mythril_tpu_torch.parallel.mesh import logical_shards, mesh_devices
    from mythril_tpu_torch.smt import concrete_eval, solver, terms

    # outside the logical shards a mesh on the CPU spans the CPU alone
    assert mesh_devices("cpu") == [torch.device("cpu")]
    calls = []
    real = par.evaluate_batch_sharded

    def spy(compiled, candidates, mesh=None):
        calls.append((len(candidates), mesh.size))
        return real(compiled, candidates, mesh)

    monkeypatch.setattr(par, "evaluate_batch_sharded", spy)
    x, y, conj = _problem(terms)
    compiled = lowering.compile_conjunction(conj)
    tape = tape_vm.compile_tape(conj)
    asgs = _assignments(terms, concrete_eval, [(i, 100 - i) for i in range(16)])
    host = compiled.evaluate_batch(asgs, "cpu")
    with logical_shards(4):
        got = solver._evaluate_candidates_device(compiled, asgs, "cpu")
        assert calls == [(16, 4)]
        solver._evaluate_candidates_device(compiled, asgs[:15], "cpu")
        solver._evaluate_candidates_device(tape, asgs, "cpu")
        assert calls == [(16, 4)]
    np.testing.assert_array_equal(got, host)
    solver._evaluate_candidates_device(compiled, asgs, "cpu")
    assert calls == [(16, 4)]


def test_solver_gate_keeps_one_launch_with_no_mesh(monkeypatch):
    """``--no-mesh`` (``args.frontier_mesh`` off) keeps the probe on the
    analysis device: on a 2-shard mesh a lowering of 16 candidates takes
    the single launch, with the truth of the sharded call."""
    import mythril_tpu_torch.parallel as par
    from mythril_tpu_torch.ops import lowering
    from mythril_tpu_torch.parallel.mesh import logical_shards
    from mythril_tpu_torch.smt import concrete_eval, solver, terms
    from mythril_tpu_torch.support.support_args import args

    x, y, conj = _problem(terms)
    compiled = lowering.compile_conjunction(conj)
    asgs = _assignments(terms, concrete_eval, [(i, 100 - i) for i in range(16)])
    calls = {"sharded": 0, "single": 0}
    real_sharded, real_single = par.evaluate_batch_sharded, type(compiled).evaluate_batch

    def sharded(*a, **k):
        calls["sharded"] += 1
        return real_sharded(*a, **k)

    def single(*a, **k):
        calls["single"] += 1
        return real_single(*a, **k)

    monkeypatch.setattr(par, "evaluate_batch_sharded", sharded)
    monkeypatch.setattr(type(compiled), "evaluate_batch", single)
    with logical_shards(2):
        monkeypatch.setattr(args, "frontier_mesh", False)
        got = solver._evaluate_candidates_device(compiled, asgs, "cpu")
        assert calls == {"sharded": 0, "single": 1}
        monkeypatch.setattr(args, "frontier_mesh", True)
        want = solver._evaluate_candidates_device(compiled, asgs, "cpu")
        assert calls == {"sharded": 1, "single": 1}
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the corpus shards (tests/parallel/test_corpus.py)
# ---------------------------------------------------------------------------


def test_round_robin_partition_is_exact():
    from mythril_tpu.parallel import shard_corpus as jax_shard_corpus
    from mythril_tpu_torch.parallel import shard_corpus

    items = [f"c{i}" for i in range(10)]
    shards = [shard_corpus(items, index=i, count=3) for i in range(3)]
    assert shards == [jax_shard_corpus(items, index=i, count=3) for i in range(3)]
    # disjoint and complete
    flat = [x for s in shards for x in s]
    assert sorted(flat) == sorted(items)
    assert len(set(flat)) == len(items)
    # round-robin spreads the head evenly
    assert shards[0][0] == "c0" and shards[1][0] == "c1" and shards[2][0] == "c2"


def test_single_shard_returns_all():
    from mythril_tpu_torch.parallel import shard_corpus

    assert shard_corpus([1, 2, 3], index=0, count=1) == [1, 2, 3]
    assert shard_corpus([1, 2, 3]) == [1, 2, 3]  # no process group, no variables


def test_identity_env_override(monkeypatch):
    from mythril_tpu.parallel import shard_identity as jax_identity
    from mythril_tpu_torch.parallel import shard_identity

    monkeypatch.setenv("MYTHRIL_TPU_SHARD", "2")
    monkeypatch.setenv("MYTHRIL_TPU_NUM_SHARDS", "5")
    assert shard_identity() == jax_identity() == (2, 5)
    monkeypatch.delenv("MYTHRIL_TPU_NUM_SHARDS")
    with pytest.raises(ValueError, match="BOTH"):
        shard_identity()


def test_run_corpus_isolates_failures():
    from mythril_tpu.parallel import run_corpus as jax_run_corpus
    from mythril_tpu_torch.parallel import run_corpus

    def analyze(path):
        if path == "bad":
            raise RuntimeError("boom")
        return f"ok:{path}"

    results = dict(run_corpus(["a", "bad", "b"], analyze, index=0, count=1))
    assert results["a"] == "ok:a"
    assert results["b"] == "ok:b"
    assert isinstance(results["bad"], RuntimeError)
    want = dict(jax_run_corpus(["a", "bad", "b"], analyze, index=0, count=1))
    assert {k: v for k, v in results.items() if k != "bad"} == {
        k: v for k, v in want.items() if k != "bad"}


def test_run_corpus_stops_on_a_device_fault():
    """A device fault from ``analyze_one`` reaches the caller (the next
    contracts would run on a broken context); a plain ``RuntimeError``
    costs only its contract."""
    from mythril_tpu_torch.parallel import run_corpus

    seen = []

    def analyze(path):
        seen.append(path)
        if path == "host":
            raise RuntimeError("host code")
        if path == "card":
            raise torch.OutOfMemoryError("CUDA out of memory")
        return path

    with pytest.raises(torch.OutOfMemoryError):
        run_corpus(["a", "host", "card", "b"], analyze, index=0, count=1)
    assert seen == ["a", "host", "card"]


_GLOO_CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch.distributed as dist
from mythril_tpu_torch.parallel import run_corpus, shard_identity

rank = int(sys.argv[3])
dist.init_process_group("gloo", init_method="file://" + sys.argv[2], rank=rank, world_size=2)
try:
    corpus = [f"c{i}" for i in range(7)]
    out = {"identity": list(shard_identity()),
           "results": run_corpus(corpus, lambda path: path.upper())}
    dist.barrier()
finally:
    dist.destroy_process_group()
print(json.dumps(out))
"""


def test_shard_identity_from_two_gloo_processes(tmp_path):
    """Two processes in one gloo process group (a ``FileStore``): each
    reads its rank and the world size as its shard identity, and the two
    shards' union is the corpus, each contract once."""
    store = tmp_path / "store"
    env = {k: v for k, v in __import__("os").environ.items()
           if k not in ("MYTHRIL_TPU_SHARD", "MYTHRIL_TPU_NUM_SHARDS")}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, "-c", _GLOO_CHILD, str(REPO), str(store), str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env, cwd=str(tmp_path))
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=120)
            assert p.returncode == 0, stderr[-2000:]
            outs.append(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [o["identity"] for o in outs] == [[0, 2], [1, 2]]
    assert [[path for path, _ in o["results"]] for o in outs] == [
        ["c0", "c2", "c4", "c6"], ["c1", "c3", "c5"]]
    union = sorted(path for o in outs for path, _ in o["results"])
    assert union == [f"c{i}" for i in range(7)]
    assert all(res == path.upper() for o in outs for path, res in o["results"])
