"""The port's CUDA kernels on a card, against their plain versions.

Marked ``cuda``: each test needs an NVIDIA card with ``nvcc`` (sm_90a) and
skips without one.  On the card machine, from the repository root
(``--noconftest``: tests/conftest.py configures JAX, which the port's
machine need not have):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

``chip_smoke.py`` runs the same comparisons at the main path's shapes, and
the whole analysis on every recorded engine run, without and with native
CDCL, under the solver tiers and under the default host tiers.
"""

import json

import numpy as np
import pytest
import torch

from mythril_tpu_torch.ops import keccak_cuda, keccak_torch, lowering, tape_vm
from mythril_tpu_torch.smt import concrete_eval, terms
from tests._torch_parity import _one_torch_thread  # noqa: E402,F401  (autouse fixture)
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


def test_engine_runs_the_dead_code_contract_under_the_defaults_on_card(card):
    """The whole analysis on the card with the static pass and the query
    cache on: the JAX package's recorded frontier run of the dead-code
    contract (issues, dispatch digests, every counter), one segment launch
    per dispatch."""
    from mythril_tpu_torch.frontier import step
    from tests.test_torch_engine_defaults import check_run, load_runs, run_port

    run = next(r for r in load_runs() if r["name"] == "dead_code" and r["frontier"])
    before = step.launches
    got = run_port(run, None)
    assert check_run(run, got) == []
    assert step.launches - before == len(run["dispatches"]) > 0


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


# ---------------------------------------------------------------------------
# the pipelined frontier
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,index", [("etherstore_like", 0), ("wide_contract_10", 0)])
def test_chained_dispatch_has_no_host_sync_and_matches_plain(card, name, index):
    """A recorded dispatch on the card, then one segment chained on its
    device outputs under ``set_sync_debug_mode("error")`` (the host reads no
    device value); the merged input and the chained outputs equal the merge
    and the plain segment on the CPU, and the delta pull equals the full
    pull."""
    from mythril_tpu_torch.frontier import step
    from tests.test_torch_pipeline import chained_dispatch, recorded_dispatch

    d = recorded_dispatch(name, index)
    chained_dispatch(d, card)  # builds the kernels and the pinned pools outside the check
    before = step.launches
    got = chained_dispatch(d, card, sync_debug=True)
    assert step.launches - before == 2
    assert got["corrected"] > 0
    assert got["in"] == got["plain_in"] and got["out"] == got["plain_out"]
    assert got["delta_equal"] and 0 < got["delta_bytes"] < got["full_bytes"]


def test_pipelined_analysis_on_card_equals_its_record(card):
    """The pipelined engine on the card (two feasibility workers, four
    replay workers, the segment stream and the copy stream): the JAX
    pipeline's recorded issues and counters, and the same issues with
    ``--no-pipeline``."""
    from mythril_tpu_torch.frontier import step
    from tests.test_torch_pipeline import check_run, run_of, run_port, summary_differences

    run = run_of("etherstore_like/64")
    before = step.launches
    got = run_port(run, None)
    assert check_run(run, got) == []
    assert step.launches - before == got["frontier"]["segments"]
    sync = run_port(run, None, pipeline=False)
    assert summary_differences(sync["summary"], got["summary"]) == []


@pytest.mark.cuda
@pytest.mark.parametrize("lbl", ("rubixi_like/256/no-pipeline", "rubixi_like/256"))
def test_adaptive_analysis_on_card_equals_its_record(card, lbl):
    """The engine on the card with the adaptive controller on: the JAX
    recording's issues, and on ``--no-pipeline`` its exploration ledger
    (the segment kernel's three coverage planes, the termination classes);
    with ``--no-adaptive`` the same issues and no plan."""
    from tests.test_torch_adaptive import check_run, run_of, run_port

    run = run_of(lbl)
    assert check_run(run, run_port(run, None)) == []
    assert check_run(run, run_port(run, None, adaptive=False), adaptive=False) == []


@pytest.mark.cuda
def test_cooperative_batch_on_card_equals_its_record(card):
    """``exploit_mix`` through the port's ``analyze_cooperative`` on the
    card: the JAX package's issue sets with the controller on and off, and
    the scheduler steering with it on."""
    from tests.test_torch_adaptive import CPU_BATCH, batch_of, cooperative

    for adaptive in (True, False):
        got = cooperative("mythril_tpu_torch", CPU_BATCH, adaptive, device=None)
        assert got["issues"] == batch_of(CPU_BATCH, adaptive)["issues"]
        assert (got["adaptive"]["resteered_slots"] > 0) == adaptive


# ---------------------------------------------------------------------------
# the span tracer and the device plane
# ---------------------------------------------------------------------------


def test_traced_segments_record_device_time_without_host_syncs(card, tmp_path, monkeypatch):
    """The synchronous frontier on the card (kill_simple through the CLI,
    ``--no-pipeline --harvest-workers 0``), untraced and then traced with
    ``--trace-out`` and ``--metrics-out``, each under
    ``torch.cuda.set_sync_debug_mode("warn")``: the traced run makes exactly
    the untraced run's synchronizing calls (the device plane reads its CUDA
    events at the pulls, never waits), and every segment launch has its
    ``frontier.segment`` span and its CUDA-event time in
    ``frontier.segment_device_s``; then one chained dispatch, traced, under
    ``set_sync_debug_mode("error")`` publishes its segment's device time."""
    import warnings

    from mythril_tpu_torch.frontier import step
    from mythril_tpu_torch.observability import deviceplane, get_registry, get_tracer
    from tests.test_torch_cli import run_port
    from tests.test_torch_observability import KILL_SIMPLE, event_counts
    from tests.test_torch_pipeline import chained_dispatch, recorded_dispatch

    monkeypatch.setenv("MYTHRIL_DIR", str(tmp_path / "mythril"))
    argv = ["analyze", "-c", KILL_SIMPLE, "--bin-runtime", "-t", "2", "-o", "json",
            "--frontier", "--frontier-force", "--probe-backend", "device",
            "--no-pipeline", "--harvest-workers", "0"]
    run_port(argv, device=None)  # builds the kernels outside the counts

    def synced(extra):
        before = step.launches
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                rc, out = run_port(argv + extra, device=None)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        # the sync reports alone: the first set_sync_debug_mode of a process
        # also warns, once, that the mode "does not yet detect all
        # synchronizing operations"
        syncs = sum("called a synchronizing CUDA operation" in str(w.message)
                    for w in caught)
        return rc, out, syncs, step.launches - before

    rc0, out0, syncs0, launches0 = synced([])
    seg = get_registry()._metrics["frontier.segment_device_s"]
    count0 = seg.count
    trace, metrics = tmp_path / "trace.json", tmp_path / "metrics.json"
    rc1, out1, syncs1, launches1 = synced(["--trace-out", str(trace),
                                           "--metrics-out", str(metrics)])
    assert rc0 == rc1 == 0 and out0 == out1
    assert syncs1 == syncs0 > 0 and launches1 == launches0 > 0
    assert event_counts(json.loads(trace.read_text()))["frontier.segment|X"] == launches1
    snap = json.loads(metrics.read_text())["metrics"]["frontier.segment_device_s"]
    assert snap["count"] == launches1 and snap["min"] > 0
    # the analysis's sweep zeroes the histogram: this run's stamps alone
    assert seg.count == launches1 and count0 == launches0

    get_tracer().reset()
    get_tracer().enabled = True
    try:
        d = recorded_dispatch("etherstore_like", 0)
        chained_dispatch(d, card)  # pinned pools outside the check
        deviceplane.settle()
        n0 = get_registry()._metrics["frontier.segment_device_s"].count
        got = chained_dispatch(d, card, sync_debug=True)
        deviceplane.settle()
    finally:
        get_tracer().enabled = False
    assert got["out"] == got["plain_out"]
    # the chained segment (the first dispatch is the helper's own call)
    assert get_registry()._metrics["frontier.segment_device_s"].count - n0 == 1
    assert any(s["name"] == "frontier.chain_merge" for s in get_tracer().spans())
    get_tracer().reset()


@pytest.mark.parametrize("pipeline", [False, True], ids=["sync", "pipelined"])
def test_microbench_times_the_card_not_the_host_queueing(card, monkeypatch, pipeline):
    """The segment microbench on the card with a host that queues each
    dispatch 50 ms late: ``segment_compute_s`` is the card's time of one
    dispatch, below the host's delay, because the sleep kernel ahead of the
    timed dispatches is lengthened until it outlasts their queueing."""
    import time

    from mythril_tpu_torch.analysis.security import fire_lasers, reset_callback_modules
    from mythril_tpu_torch.analysis.symbolic import SymExecWrapper
    from mythril_tpu_torch.frontier.engine import FrontierEngine
    from mythril_tpu_torch.frontier.stats import FrontierStatistics
    from mythril_tpu_torch.support.support_args import args
    from tests._torch_parity import _reset
    from tests.test_torch_observability import _wide_contract

    delay = 0.05
    run_microbench = FrontierEngine._run_microbench

    def late_host(segment, micro_args, n_exec, st, reps=4):
        def late(*a):
            time.sleep(delay)
            return segment(*a)

        run_microbench(late, micro_args, n_exec, st, reps)

    monkeypatch.setattr(FrontierEngine, "_run_microbench", staticmethod(late_host))
    _reset("mythril_tpu_torch")
    saved = (args.frontier, args.frontier_force, args.frontier_width,
             args.frontier_microbench, args.pipeline)
    args.frontier, args.frontier_force, args.frontier_width = True, True, 64
    args.frontier_microbench, args.pipeline = True, pipeline
    reset_callback_modules()
    FrontierStatistics().reset()
    try:
        sym = SymExecWrapper(_wide_contract(6), address=0x0901D12E, strategy="bfs",
                             transaction_count=1, execution_timeout=120,
                             modules=["AccidentallyKillable"], device=None)
        fire_lasers(sym, white_list=["AccidentallyKillable"])
        mb = FrontierStatistics().microbench
        assert mb, "microbench never recorded"
        assert mb["dispatch_plus_link_s"] >= delay
        assert 0 < mb["segment_compute_s"] < delay
    finally:
        (args.frontier, args.frontier_force, args.frontier_width,
         args.frontier_microbench, args.pipeline) = saved
        FrontierStatistics().reset()


def test_a_resumed_analysis_on_the_card_equals_its_records(card, tmp_path, monkeypatch):
    """The JAX package's checkpoint of ``etherstore_like`` after transaction
    1 (``tests/testdata/torch_checkpoint_runs.json``, its host engine)
    resumed on the card on ``chip_smoke.py`` phase 8k's command line (the
    pipelined frontier forced at 256 paths, the device probe): the JAX CLI's
    issue keys for that command line uninterrupted (the frontier words the
    timestamp issue's head by the block value, the host engine by its
    comparison), the segment and the solver's kernels launched (which of
    them depends on the tier that decides each query: from this file the
    prefilter and CDCL leave the tape VM nothing)."""
    from mythril_tpu_torch.absdomain import device as kb_device
    from mythril_tpu_torch.devsolver import device as dpll_device
    from mythril_tpu_torch.frontier import step
    from tests.test_torch_checkpoint import issue_keys, load_runs
    from tests.test_torch_cli import load_runs as cli_runs
    from tests.test_torch_cli import port_argv, run_port

    monkeypatch.setenv("MYTHRIL_DIR", str(tmp_path / "mythril"))
    record = cli_runs()["etherstore_like/frontier-256/pipeline"]
    path = tmp_path / "ckpt.json"
    path.write_text(load_runs()["etherstore_like/t1-checkpoint"]["file"])
    def solver_launches():
        return (tape_vm.launches + lowering.launches + kb_device.launches
                + dpll_device.launches)

    seg0, solver0 = step.launches, solver_launches()
    rc, out = run_port(port_argv(record) + ["--resume-from", str(path)], device=None)
    assert rc == 0
    assert issue_keys(out) == issue_keys(record["stdout"])
    assert step.launches > seg0 and solver_launches() > solver0


def test_an_inline_service_on_the_card_answers_with_the_solo_digests(card, tmp_path,
                                                                     monkeypatch):
    """``chip_smoke.py`` phase 8l in small: an inline service on the card at
    its defaults (the frontier, the interactive probe, the ``auto`` backend)
    answers ``etherstore_like`` and ``kill_simple`` (``-t 2``, two tenants)
    with the issue digests of their solo ``analyze`` runs on the card, which
    are the JAX service record's (``tests/testdata/torch_service_runs.json``),
    and its batch launches the segment kernel."""
    import dataclasses
    from pathlib import Path

    import bench_contracts
    from mythril_tpu_torch.frontier import step
    from mythril_tpu_torch.querycache import configure
    from mythril_tpu_torch.service import (
        AnalysisOptions,
        AnalysisService,
        ServiceConfig,
        canonical_codehash,
        issue_digest,
    )
    from mythril_tpu_torch.support.support_args import args
    from tests.test_torch_cli import _last_json_line, run_port

    monkeypatch.setenv("MYTHRIL_DIR", str(tmp_path / "mythril"))
    repo = Path(__file__).resolve().parent.parent
    record = json.loads((repo / "tests" / "testdata" / "torch_service_runs.json").read_text())
    recorded = {r["contract"]: r["digests"] for r in record["runs"]}
    codes = {"etherstore_like": bench_contracts.etherstore_like().hex(),
             "kill_simple": (repo / "tests" / "testdata" / "inputs"
                             / "kill_simple.bin-runtime").read_text().strip()}
    solo = {}
    for name, code in codes.items():
        rc, out = run_port(["analyze", "-c", code, "--bin-runtime", "-t", "2",
                            "--execution-timeout", "60", "-o", "json"], device=None,
                           calibrated=True)
        assert rc == 0
        solo[name] = sorted([i["swc-id"], i["address"], canonical_codehash(code), i["title"],
                             i["function"]] for i in _last_json_line(out)["issues"])
    saved = dataclasses.replace(args)
    service = AnalysisService(ServiceConfig(
        default_options=AnalysisOptions(transaction_count=2, execution_timeout=60),
        batch_window_s=0.3, warmup=False)).start()
    try:
        seg0 = step.launches
        subs = [service.submit(codes[name], name=name, tenant=tenant)
                for name, tenant in (("etherstore_like", "t1"), ("kill_simple", "t2"))]
        answers = {name: list(stream.events(timeout=600))[-1]
                   for name, (_r, stream, _d) in zip(codes, subs)}
        launched = step.launches - seg0
    finally:
        assert service.stop(drain=True, timeout=120)
        for f in dataclasses.fields(args):
            setattr(args, f.name, getattr(saved, f.name))
        configure(enabled=args.query_cache, cache_dir=args.query_cache_dir)
    for name, (kind, payload) in answers.items():
        assert kind == "done", payload
        assert sorted(list(issue_digest(i)) for i in payload["issues"]) == solo[name] \
            == recorded[name]
    assert launched > 0


def test_mesh_probe_and_pod_run_on_logical_shards_of_the_card(card):
    """The sharded probe on 4 logical shards of the card: one lowering
    launch per shard, the truth of the single launch; the pod contract
    pipelined on that mesh: the recorded issue keys, 4 mesh devices and
    runner shards, a chained dispatch."""
    from mythril_tpu_torch.parallel import evaluate_batch_sharded, make_frontier_mesh
    from mythril_tpu_torch.parallel.mesh import logical_shards
    from tests.test_torch_pod import RECORD, _analyze

    x, y = terms.var("mesh_x", 256), terms.var("mesh_y", 256)
    compiled = lowering.compile_conjunction(
        [terms.eq(terms.add(x, y), terms.const(100, 256)), terms.ult(x, terms.const(60, 256))])
    asgs = []
    for a in range(21):
        asg = concrete_eval.Assignment()
        asg.scalars[x], asg.scalars[y] = 3 * a, 100 - 3 * a
        asgs.append(asg)
    with logical_shards(4):
        mesh = make_frontier_mesh()
        before = lowering.launches
        got = evaluate_batch_sharded(compiled, asgs, mesh)
        assert lowering.launches == before + 4
        np.testing.assert_array_equal(got, compiled.evaluate_batch(asgs))
        assert got[:, 0].all() and got[:, 1].sum() == 20
        run = _analyze("mythril_tpu_torch", 64, mesh=True, device=None)
    want = json.loads(RECORD.read_text())["runs"]["storage_gate/64"]["mesh"]
    assert run["summary"] == want["summary"]
    assert run["mesh_devices"] == run["mesh_shards"] == 4 and run["segments_pipelined"] > 0


# ---------------------------------------------------------------------------
# the frontier segment partitioned over slot blocks
# ---------------------------------------------------------------------------


def _partition_inputs(case, device):
    from mythril_tpu_torch.frontier import interop

    return interop.inputs_from_numpy(case["state"], case["arena"], case["arena_len"],
                                     case["visited"], case["code"], case["cfg"], device)


def _blocks(state, devices):
    """The whole batch's tensors cut into one block per entry of
    ``devices``, block k on ``devices[k]``."""
    from mythril_tpu_torch.frontier import step
    from mythril_tpu_torch.frontier.state import FrontierState

    bs = state.pc.shape[0] // len(devices)
    return step.ShardedState([FrontierState(*[f[k * bs:(k + 1) * bs].to(d, copy=True)
                                              for f in state]) for k, d in enumerate(devices)])


@pytest.mark.parametrize("n", [2, 4, 8])
def test_partition_kernel_matches_plain_on_logical_shards(card, n):
    """Every partition case on n logical shards of the card: one launch of
    the shard kernel, bit-identical to the unsharded launch and to the plain
    partitioned version on the CPU."""
    from mythril_tpu_torch.frontier import interop, step
    from tests import _torch_frontier_cases as fcases

    for name, case in sorted(fcases.partition_cases().items()):
        inputs = _partition_inputs(case, card)
        before = step.partitioned_launches
        got = interop.outputs_to_numpy(step.segment_partitioned(
            _blocks(inputs[0], [card] * n), *inputs[1:], fcases.CAPS))
        assert step.partitioned_launches == before + 1, name
        single = interop.outputs_to_numpy(step.segment_cuda(*inputs, fcases.CAPS))
        cpu = _partition_inputs(case, "cpu")
        plain = interop.outputs_to_numpy(step.segment_partitioned_torch(
            _blocks(cpu[0], ["cpu"] * n), *cpu[1:], fcases.CAPS))
        for want in (single, plain):
            fcases.assert_same(got, want)


def test_partition_kernel_blocks_of_several_kernel_blocks(card):
    """Two and four shards whose blocks span several blocks of 128 lanes
    (the last partly past the shard), forks filling every shard."""
    from mythril_tpu_torch.frontier import interop, step
    from tests import _torch_frontier_cases as fcases

    for B, n in ((258, 2), (1032, 4), (4104, 8)):
        case = fcases.width_case(B, 2)
        inputs = _partition_inputs(case, card)
        got = interop.outputs_to_numpy(step.segment_partitioned(
            _blocks(inputs[0], [card] * n), *inputs[1:], case["caps"]))
        fcases.assert_same(got, interop.outputs_to_numpy(step.segment_cuda(*inputs, case["caps"])))


def test_partition_kernel_over_every_card(card):
    """One launch per card, each over its own block, meeting at the
    leader's barrier: bit-identical to the plain version."""
    from mythril_tpu_torch.frontier import interop, step
    from tests import _torch_frontier_cases as fcases

    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs several cards")
    n = max(k for k in (2, 4, 8) if k <= cards)
    devices = [torch.device("cuda", k) for k in range(n)]
    for name, case in sorted(fcases.partition_cases().items()):
        inputs = _partition_inputs(case, devices[0])
        before = step.partitioned_launches
        got = interop.outputs_to_numpy(step.segment_partitioned(
            _blocks(inputs[0], devices), *inputs[1:], fcases.CAPS))
        assert step.partitioned_launches == before + n, name
        cpu = _partition_inputs(case, "cpu")
        fcases.assert_same(got, interop.outputs_to_numpy(step.segment_partitioned_torch(
            _blocks(cpu[0], ["cpu"] * n), *cpu[1:], fcases.CAPS)))


def test_partition_width_beyond_one_card_runs_on_the_mesh(card):
    """A --frontier-width one card refuses passes the width check with the
    mesh of every card, and is refused with --no-mesh."""
    import types

    from mythril_tpu_torch.frontier import step
    from mythril_tpu_torch.interfaces import cli

    if torch.cuda.device_count() < 2:
        pytest.skip("needs several cards")
    wide = 2 * step.max_paths(card)
    cli.check_frontier_width(types.SimpleNamespace(
        frontier=True, device=None, frontier_mesh=True, frontier_width=wide))
    with pytest.raises(cli.Refused, match="at most"):
        cli.check_frontier_width(types.SimpleNamespace(
            frontier=True, device=None, frontier_mesh=False, frontier_width=wide))


_PARTITION_TRAP = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from mythril_tpu_torch.device import DeviceError
from mythril_tpu_torch.frontier import interop, step
from mythril_tpu_torch.frontier.state import FrontierState
from tests import _torch_frontier_cases as fcases

step.BARRIER_TIMEOUT_S = float(sys.argv[2])
case = fcases.partition_cases()["child_in_another_block"]
inputs = interop.inputs_from_numpy(case["state"], case["arena"], case["arena_len"],
                                   case["visited"], case["code"], case["cfg"], "cuda")
bs = fcases.CAPS.B // 2
blocks = step.ShardedState([FrontierState(*[f[k * bs:(k + 1) * bs].clone() for f in inputs[0]])
                            for k in range(2)])
# shard 0 launched alone, as one of two launches: shard 1 never reaches the barrier
out = step.segment_partitioned(blocks, *inputs[1:], fcases.CAPS, launch=[0])
try:
    step.pull_harvest(out[0], out[2], out[3], out[4])
    print(json.dumps({"raised": None}))
except DeviceError as e:
    print(json.dumps({"raised": type(e).__name__, "message": str(e)[:400]}))
"""


def test_partition_barrier_traps_when_a_shard_is_missing(card):
    """A partitioned segment whose other shard never arrives: the launched
    shard waits at the barrier for ``BARRIER_TIMEOUT_S``, traps, and the
    pull raises a ``DeviceError`` naming the failure, instead of hanging
    (a subprocess: the trap ends the process's CUDA context)."""
    import subprocess
    import sys
    import time
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", _PARTITION_TRAP, str(repo), "2.0"],
                         capture_output=True, text=True, timeout=300, cwd=str(repo))
    wall = time.perf_counter() - t0
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    assert lines, out.stderr[-3000:]
    got = json.loads(lines[-1])
    assert got["raised"] == "DeviceError", got
    assert "partitioned segment failed" in got["message"]
    assert wall < 240
