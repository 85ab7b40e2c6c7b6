"""The port's CUDA kernels on a card, against their plain versions.

Marked ``cuda``: each test needs an NVIDIA card with ``nvcc`` (sm_90a) and
skips without one.  On the card machine, from the repository root
(``--noconftest``: tests/conftest.py configures JAX, which the port's
machine need not have):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

``chip_smoke.py`` runs the same comparisons at the main path's shapes, and
the whole analysis on every recorded engine run, without and with native
CDCL.
"""

import json

import numpy as np
import pytest
import torch

from mythril_tpu_torch.ops import keccak_cuda, keccak_torch, lowering, tape_vm
from mythril_tpu_torch.smt import concrete_eval, terms
from tests import _torch_lowering_cases as lcases
from tests import _torch_tape_cases as cases
from tests import _torch_tier_cases as tier_cases

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("variant", ["thread", "warp"])
@pytest.mark.parametrize("batch", [1, 3, 130, 4096])
def test_keccak_kernel_matches_reference(card, batch, variant):
    rng = np.random.default_rng(batch)
    state = torch.from_numpy(rng.integers(0, 1 << 16, (batch, 25, 4), dtype=np.int32)).to(card)
    before = keccak_cuda.launches, keccak_cuda.variant_launches[variant]
    got = keccak_cuda.keccak_f1600(state, variant)
    assert (keccak_cuda.launches, keccak_cuda.variant_launches[variant]) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(got, keccak_torch.keccak_f1600_reference(state))


def test_keccak_wrapper_refuses_bad_input(card):
    with pytest.raises(ValueError):
        keccak_cuda.keccak_f1600(torch.zeros((2, 25, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        keccak_cuda.keccak_f1600(torch.zeros((2, 25, 4), dtype=torch.int64, device=card))


def _tape_on_card(card, family, large, n_cand=70):
    conj, bv_vars, arrays = cases.build(terms, family, large)
    asgs = cases.random_assignments(terms, concrete_eval, bv_vars, arrays, 17, n_cand)
    compiled = tape_vm.compile_tape(conj)
    args, (T, V, A, K, R) = compiled.pack_args(asgs, card)
    n = compiled.n_steps
    regs = torch.empty((V + T, 16, args[0].shape[0]), dtype=torch.int32, device=card)
    before = tape_vm.launches
    got = tape_vm.run_tape(*args, T=T, V=V, A=A, K=K, R=R, n_steps=n, plan=compiled.plan,
                           regs=regs)
    assert tape_vm.launches > before
    want, want_regs = tape_vm.run_tape_reference(*args, T=T, V=V, A=A, K=K, R=R, n_steps=n,
                                                 return_regs=True)
    assert torch.equal(got, want)
    assert torch.equal(regs[: V + n].permute(0, 2, 1).long(), want_regs[: V + n])
    # the main path's call: no register file, the plan built from the tape
    assert torch.equal(tape_vm.run_tape(*args, T=T, V=V, A=A, K=K, R=R, n_steps=n), want)
    return compiled


@pytest.mark.parametrize("large", [False, True], ids=["small", "large"])
@pytest.mark.parametrize("family", list(cases.FAMILIES))
def test_tape_kernel_matches_reference(card, family, large):
    _tape_on_card(card, family, large)


@pytest.mark.parametrize("case", list(cases.SLOT_CASES))
def test_tape_kernel_slot_cases(card, case):
    # wide_live needs more than 200 slots: 16 candidates per block
    compiled = _tape_on_card(card, case, False, n_cand=100)
    assert case != "wide_live" or compiled.plan.S > 200


def test_fixture_contract_on_card(card):
    from mythril_tpu_torch.smt import solver as P
    from mythril_tpu_torch.smt.concrete_eval import evaluate
    from mythril_tpu_torch.smt.serialize import from_jax_dump
    from tests._torch_parity import port_device_backend
    from tests.test_torch_fixture import disagreements, load_fixture, replay

    data, roots = load_fixture(from_jax_dump)
    entry = next(c for c in data["contracts"] if c["name"] == "bectoken_like")
    with port_device_backend():
        before = tape_vm.launches
        results = replay(entry["queries"], roots, P)  # device=None: the card
        assert tape_vm.launches > before
    assert disagreements(entry["queries"], entry["jax_verdicts"], results, evaluate) == []


# ---------------------------------------------------------------------------
# the frontier segment kernel
# ---------------------------------------------------------------------------


def _frontier_case_outputs(case, device):
    from mythril_tpu_torch.frontier import interop
    from mythril_tpu_torch.frontier import step as fstep
    from tests import _torch_frontier_cases as fcases

    segment = fstep.cached_segment(fcases.CAPS, *fcases.BUCKET, device=device)
    inputs = interop.inputs_from_numpy(case["state"], case["arena"], case["arena_len"],
                                       case["visited"], case["code"], case["cfg"], device)
    return interop.outputs_to_numpy(segment(*inputs))


def test_frontier_kernel_matches_plain_on_every_case(card):
    from mythril_tpu_torch.frontier import step as fstep
    from tests import _torch_frontier_cases as fcases

    named = [(f"family {f} {c}", fcases.family_case(f, c)) for f in sorted(fcases.FAMILY_OPS)
             for c in (True, False)]
    named += sorted(fcases.special_cases().items())
    named += [(f"random {s}", fcases.random_case(s)) for s in range(16)]
    named.append(("odd shapes", fcases.odd_shapes_case()))
    before = fstep.launches
    for name, case in named:
        try:
            fcases.assert_same(_frontier_case_outputs(case, "cuda"),
                               _frontier_case_outputs(case, "cpu"))
        except AssertionError as e:
            raise AssertionError(f"{name}: {e}") from None
    assert fstep.launches == before + len(named)


@pytest.mark.parametrize("B", [1, 127, 129, 1024, 1025, 4096])
def test_frontier_kernel_at_every_launch_width(card, B):
    """One block, one cluster and a cooperative grid, against the plain
    version on the card."""
    from mythril_tpu_torch.frontier import interop
    from mythril_tpu_torch.frontier import step as fstep
    from tests import _torch_frontier_cases as fcases

    case = fcases.width_case(B, 1)
    inputs = interop.inputs_from_numpy(case["state"], case["arena"], case["arena_len"],
                                       case["visited"], case["code"], case["cfg"], "cuda")
    fcases.assert_same(interop.outputs_to_numpy(fstep.segment_cuda(*inputs, case["caps"])),
                       interop.outputs_to_numpy(fstep.segment_torch(*inputs, case["caps"])))


@pytest.mark.parametrize("B", [127, 129, 1025])
def test_frontier_kernel_resets_unaligned_event_buffers(card, B):
    """Children's event buffers off a 16-byte boundary (EVT = 5) in each
    launch shape, against the plain version on the card."""
    from mythril_tpu_torch.frontier import interop
    from mythril_tpu_torch.frontier import step as fstep
    from tests import _torch_frontier_cases as fcases

    case = fcases.width_case(B, 1, evt=fcases.ODD_EVT)
    inputs = interop.inputs_from_numpy(case["state"], case["arena"], case["arena_len"],
                                       case["visited"], case["code"], case["cfg"], "cuda")
    fcases.assert_same(interop.outputs_to_numpy(fstep.segment_cuda(*inputs, case["caps"])),
                       interop.outputs_to_numpy(fstep.segment_torch(*inputs, case["caps"])))


def test_frontier_kernel_replays_the_wide_dispatch(card):
    from tests.test_torch_frontier_fixture import iter_dispatches, mismatches, replay

    for name, i, d in iter_dispatches(keep=lambda name, i, data: name == "wide_contract_10"):
        assert mismatches(replay(d, "cuda"), d["digests"]) == []


def test_frontier_wrapper_refuses_cpu_tensors(card):
    from mythril_tpu_torch.frontier import interop
    from mythril_tpu_torch.frontier import step as fstep
    from tests import _torch_frontier_cases as fcases

    case = fcases.random_case(0)
    inputs = interop.inputs_from_numpy(case["state"], case["arena"], case["arena_len"],
                                       case["visited"], case["code"], case["cfg"], "cpu")
    with pytest.raises(ValueError):
        fstep.segment_cuda(*inputs, fcases.CAPS)


def test_engine_runs_kill_simple_through_the_frontier_on_card(card):
    """The whole analysis on the card (no device argument), frontier forced:
    the recorded JAX run's issues and dispatch digests, one kernel launch
    per dispatch, no replay error."""
    from mythril_tpu_torch.frontier import step
    from tests.test_torch_engine_fixture import check_run, load_runs, run_port

    run = next(r for r in load_runs() if r["name"] == "kill_simple" and r["frontier"])
    before = step.launches
    got = run_port(run, None)
    assert check_run(run, got) == []
    assert step.launches - before == len(got["dispatches"]) > 0


@pytest.mark.parametrize("frontier", [True, False], ids=["frontier", "host-engine"])
def test_cdcl_engine_runs_rubixi_on_card(card, frontier):
    """The whole analysis on the card with the port's native CDCL on: the
    JAX package's recorded CDCL run (issues, dispatch digests) and its
    default-tier issue keys."""
    from mythril_tpu_torch.native import bitblast
    from tests.test_torch_engine_cdcl import default_keys_match, load_runs, run_port
    from tests.test_torch_engine_fixture import check_run

    assert bitblast.available()
    run = next(r for r in load_runs() if r["name"] == "rubixi_like" and r["frontier"] == frontier)
    got = run_port(run, None)
    assert check_run(run, got) == []
    assert default_keys_match(run, got["summary"])


def test_cli_frontier_width_limit_on_card(card, tmp_path, monkeypatch, capsys):
    """The command line refuses a ``--frontier-width`` one block over what
    the card holds resident before anything launches, and runs the widest
    width it allows (a cooperative grid of every resident block)."""
    from mythril_tpu_torch.frontier import step
    from tests.test_torch_cli import KILL_SIMPLE, run_port

    monkeypatch.setenv("MYTHRIL_DIR", str(tmp_path))
    limit = step.max_paths(card)
    assert limit % step.BLOCK == 0 and limit > 8 * step.BLOCK
    argv = ["analyze", "-f", str(KILL_SIMPLE), "--bin-runtime", "-t", "1", "-m",
            "AccidentallyKillable", "-o", "json", "--frontier", "--frontier-force"]
    step.launches = 0
    rc, _ = run_port(argv + ["--frontier-width", str(limit + step.BLOCK)], device=None)
    assert rc == 2 and step.launches == 0
    assert f"at most {limit} paths" in capsys.readouterr().err
    rc, out = run_port(argv + ["--frontier-width", str(limit)], device=None)
    assert rc == 0 and step.launches > 0
    assert [i["swc-id"] for i in json.loads(out)["issues"]] == ["106"]


@pytest.mark.parametrize("seed,n_nodes,n_rows,smem", [
    (1, 64, 1, True), (4, 512, 16, True), (15, 1000, 2, True), (16, 1002, 2, False),
    (13, 4096, 16, False), (9, 4096, 64, False)])
def test_known_bits_kernel_matches_plain(card, seed, n_nodes, n_rows, smem):
    """csrc/known_bits.cu against eval_kb_plain, both on the card, on
    synthetic tapes (every op code, missing children, overrides), on both
    routes: the row's values in shared memory up to about 1000 nodes, in
    the output planes past that."""
    from mythril_tpu_torch.absdomain import device, domains, tape
    from tests import _torch_tier_cases as tier_cases

    pack = tier_cases.kb_pack(tier_cases.random_kb_fields(seed, n_nodes, n_rows), tape)
    inputs = domains.kb_inputs(pack, card)
    plan = device.pack_plan(pack)
    assert device.in_smem(n_nodes, plan.n_levels) == smem
    before = device.launches
    got = device.known_bits(*inputs, n_rows, plan=plan)
    assert device.launches == before + 1
    for g, w in zip(got, domains.eval_kb_plain(*inputs, n_rows)):
        assert g.is_cuda and torch.equal(g, w)


@pytest.mark.parametrize("seed,q,c,v,iters", [
    (1, 4, 512, 512, 2048), (2, 16, 512, 512, 2048), (3, 4, 512, 512, 20),
    (5, 16, 4096, 4096, 2048)])
def test_dpll_kernel_matches_plain(card, seed, q, c, v, iters):
    """csrc/dpll.cu against run_plain, both on the card: status, assignment
    and steps."""
    from mythril_tpu_torch.devsolver import device, kernel
    from tests import _torch_tier_cases as tier_cases

    plane = tier_cases.random_cnf_plane(seed, q, c, v, kernel)
    lits, dec = torch.from_numpy(plane.lits).to(card), torch.from_numpy(plane.dec).to(card)
    before = device.launches
    got = device.dpll(lits, dec, plane.n_vars, iters)
    assert device.launches == before + 1
    for g, w in zip(got, kernel.run_plain(lits, dec, plane.n_vars, iters)):
        assert g.is_cuda and torch.equal(g, w)


DPLL_EDGE = tier_cases.dpll_edge_cases()


@pytest.mark.parametrize("case", DPLL_EDGE, ids=[c["label"] for c in DPLL_EDGE])
def test_dpll_kernel_edge_planes(card, case):
    """csrc/dpll.cu against run_plain on the hand-built edge planes
    (``dpll_edge_cases``), both on the card: status, assignment and steps,
    and the status and steps the case states."""
    from mythril_tpu_torch.devsolver import device, kernel

    lits = torch.from_numpy(case["lits"]).to(card)
    dec = torch.from_numpy(case["dec"]).to(card)
    v, iters = case["n_vars"], case["iters"]
    before = device.launches
    got = device.dpll(lits, dec, v, iters)
    assert device.launches == before + 1
    for g, w in zip(got, kernel.run_plain(lits, dec, v, iters)):
        assert g.is_cuda and torch.equal(g, w)
    if case["status"] is not None:
        assert got[0].tolist() == case["status"] and got[2].tolist() == case["steps"]


def test_dpll_run_device_matches_plain(card):
    """``run_device`` (one upload, one download) against the plain search on
    the CPU, twice on one plane (the pinned buffers reused), and the
    wrapper's refusal of a variable count past the kernel's."""
    from mythril_tpu_torch.devsolver import device, kernel

    plane = tier_cases.random_cnf_plane(24, 16, 512, 512, kernel)
    want = kernel.run_torch(plane, 2048, "cpu")
    for _ in range(2):
        status, assign = device.run_device(plane, 2048, card)
        assert np.array_equal(status, want[0].numpy()) and np.array_equal(assign, want[1].numpy())
    lits = torch.zeros((1, 4, 3), dtype=torch.int32, device=card)
    dec = torch.ones((1, 64), dtype=torch.int32, device=card)
    with pytest.raises(ValueError):
        device.dpll(lits, dec, device.MAX_VARS + 1, 10)


def test_engine_runs_rubixi_under_the_tiers_on_card(card):
    """The whole analysis on the card with the prefilter and the devsolver
    on: the JAX package's recorded run (issues, tier counters), both
    kernels launched."""
    from mythril_tpu_torch.absdomain import device as kb_device
    from mythril_tpu_torch.devsolver import device as dpll_device
    from tests.test_torch_engine_tiers import check_run, load_runs, run_port

    run = next(r for r in load_runs() if r["name"] == "rubixi_like" and not r["frontier"])
    before = kb_device.launches, dpll_device.launches
    got = run_port(run, None)
    assert check_run(run, got) == []
    assert kb_device.launches - before[0] == run["kb_passes"] > 0
    assert dpll_device.launches - before[1] == run["dpll_planes"] > 0


def _lowering_on_card(card, conj, inputs):
    """The lowering's wrapper on the card against its plain version on the
    card: truth and every node's value; one launch per call."""
    compiled = lowering.compile_conjunction(conj) if isinstance(conj, list) else conj
    B = inputs[1].shape[0]
    arena = torch.empty((compiled.program.rows, B), dtype=torch.int32, device=card)
    before = lowering.launches
    got = lowering.run_lowering(compiled, *inputs, arena=arena)
    assert lowering.launches == before + 1
    values = {}
    want = lowering.run_lowering_reference(compiled, *inputs, values=values)
    assert lcases.node_differences(compiled, arena, values) == []
    assert torch.equal(got, want)
    assert torch.equal(lowering.run_lowering(compiled, *inputs), want)  # the pooled arena
    return got


@pytest.mark.parametrize("width", lcases.WIDTHS)
@pytest.mark.parametrize("family", list(lcases.FAMILIES))
def test_lowering_kernel_matches_plain(card, family, width):
    conj, bv_vars, arrays = lcases.build(terms, family, width)
    asgs = lcases.random_assignments(terms, concrete_eval, bv_vars, arrays, width, 70)
    compiled = lowering.compile_conjunction(conj)
    got = _lowering_on_card(card, compiled, lowering.pack_assignments(compiled, asgs, card))
    assert np.array_equal(got.cpu().numpy(), compiled.evaluate_batch(asgs, "cpu"))


@pytest.mark.parametrize("K", [8, 16, 64])
@pytest.mark.parametrize("B", [1, 63, 192, 4096])
def test_lowering_kernel_tables(card, B, K):
    conj, bv_vars, arrays = lcases.build(terms, "array", 256)
    asgs = lcases.random_assignments(terms, concrete_eval, bv_vars, arrays, K + B, B, K)
    compiled = lowering.compile_conjunction(conj)
    _lowering_on_card(card, compiled, lowering.pack_assignments(compiled, asgs, card))


@pytest.mark.parametrize("B", [5, 192])
def test_lowering_kernel_global_route(card, B):
    """A program whose values outgrow a block's shared memory keeps them in
    the global arena, in the same single launch."""
    conj, bv_vars, arrays = lcases.wide(terms)
    asgs = lcases.random_assignments(terms, concrete_eval, bv_vars, arrays, B, B)
    compiled = lowering.compile_conjunction(conj)
    inputs = lowering.pack_assignments(compiled, asgs, card)
    routes = []
    lowering.run_kernel(compiled, *inputs, launch=lambda largs: routes.append(largs.in_smem))
    assert routes == [0]
    got = _lowering_on_card(card, compiled, inputs)
    assert np.array_equal(got.cpu().numpy(), compiled.evaluate_batch(asgs, "cpu"))


@pytest.mark.parametrize("B", [1, 63, 4096])
def test_lowering_kernel_long_keccak(card, B):
    """Keccak of a preimage of three rate blocks, and of a digest of it,
    inside the kernel."""
    conj, bv_vars, arrays = lcases.long_keccak(terms)
    asgs = lcases.random_assignments(terms, concrete_eval, bv_vars, arrays, B, B)
    compiled = lowering.compile_conjunction(conj)
    got = _lowering_on_card(card, compiled, lowering.pack_assignments(compiled, asgs, card))
    assert np.array_equal(got.cpu().numpy(), compiled.evaluate_batch(asgs, "cpu"))


def test_lowering_kernel_on_recorded_dispatches(card):
    from tests._torch_lowering_cases import load_recorded, recorded_inputs

    meta, arrays, conjs = load_recorded()
    for n, (d, conj) in enumerate(zip(meta["dispatches"], conjs)):
        if not d.get("jax_error"):
            got = _lowering_on_card(card, conj, recorded_inputs(arrays, n, d, card))
            assert np.array_equal(got.cpu().numpy(), arrays[f"{n}_truth"]), n


def test_lowering_wrapper_refuses_mixed_devices(card):
    conj, bv_vars, arrays = lcases.build(terms, "bool", 8)
    asgs = lcases.random_assignments(terms, concrete_eval, bv_vars, arrays, 1, 5)
    compiled = lowering.compile_conjunction(conj)
    scalars, bools, tabs = lowering.pack_assignments(compiled, asgs, card)
    with pytest.raises(ValueError, match="expected int32"):
        lowering.run_lowering(compiled, scalars, bools.cpu(), tabs)
