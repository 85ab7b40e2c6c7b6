"""The CUDA sources' arithmetic, built for the host and held against the plain
PyTorch versions, bit for bit.

``csrc/keccak.cuh``, ``csrc/bitvec.cuh``, ``csrc/tape_vm.cuh``,
``csrc/known_bits.cuh``, ``csrc/dpll.cuh`` and ``csrc/lowering.cuh`` are
``__host__ __device__``; ``csrc/host_check.cpp`` wraps the body one CUDA
thread runs (one state, one candidate) in a host loop, with the tape's slot
file as a host array poisoned at every segment's start, and runs the
warp-per-state keccak body with its 25 lanes as coroutines of one host
thread, phase by phase.  A host C++ compiler builds
it into a shared library in the test's temporary directory, and
``tape_vm.run_segments`` drives it exactly as ``run_tape`` drives the
kernels: the tape's slot plan, segments split at keccak steps, the spill and
the permutation between them.  The lowering's warp code runs with the 32
lanes as a loop and each warp primitive between two phases a host function
over the 32 entries; ``lowering.run_kernel`` drives it exactly as the
wrapper drives the kernel, and every node's value in its arena must equal
the plain version's.  The known-bits pass runs the same way with 16 lanes a
node (``tests/test_torch_known_bits_host.py`` holds its level plan, its
cross-limb steps and both of its routes).  The DPLL search runs the
kernel's own per-thread program with every thread of the block a coroutine
run up to its next barrier, the last thread first, over poisoned state, so
that a missing barrier shows; on seeded planes and the hand-built edge
planes, at the kernel's block sizes and at odd ones.
The launch code in the ``.cu`` files runs only on a card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from mythril_tpu_torch.absdomain import device as kb_device
from mythril_tpu_torch.absdomain import domains as kb_domains
from mythril_tpu_torch.absdomain import tape as kb_tape
from mythril_tpu_torch.devsolver import device as dpll_device
from mythril_tpu_torch.devsolver import kernel as dpll_kernel
from mythril_tpu_torch.ops import _build, keccak_torch
from mythril_tpu_torch.ops import lowering as plow
from mythril_tpu_torch.ops import tape_vm as ptape
from mythril_tpu_torch.smt import concrete_eval as pce
from mythril_tpu_torch.smt import terms
from tests import _torch_lowering_cases as lcases
from tests import _torch_tape_cases as cases
from tests import _torch_tier_cases as tier_cases


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    out = tmp_path_factory.mktemp("csrc") / "libmk_host.so"
    subprocess.run(
        [cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-I", str(_build.CSRC),
         str(_build.CSRC / "host_check.cpp"), "-o", str(out)],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(out))
    for fn in (lib.mk_keccak_f1600_host, lib.mk_keccak_f1600_warp_host):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong]
    lib.mk_tape_vm_segment_host.argtypes = [ctypes.POINTER(_build.TapeArgs)]
    lib.mk_tape_vm_segment_host.restype = ctypes.c_int
    lib.mk_known_bits_host.argtypes = [ctypes.POINTER(kb_device.KbArgs)]
    lib.mk_known_bits_host.restype = ctypes.c_int
    lib.mk_kb_steps_host.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32,
                                     ctypes.c_int32, ctypes.c_void_p]
    lib.mk_kb_steps_host.restype = None
    lib.mk_dpll_host.argtypes = [ctypes.POINTER(dpll_device.DpllArgs), ctypes.c_int]
    lib.mk_dpll_host.restype = ctypes.c_int
    lib.mk_lowering_host.argtypes = [ctypes.POINTER(plow.LowerArgs)]
    lib.mk_lowering_host.restype = ctypes.c_int
    return lib


def _host_permute(lib, variant="thread"):
    fn = {"thread": lib.mk_keccak_f1600_host, "warp": lib.mk_keccak_f1600_warp_host}[variant]

    def permute(state):
        state = state.contiguous()
        out = torch.empty_like(state)
        fn(state.data_ptr(), out.data_ptr(), state.shape[0])
        return out
    return permute


@pytest.mark.parametrize("variant", ["thread", "warp"])
@pytest.mark.parametrize("batch", [1, 3, 130])
def test_host_keccak_matches_reference(host_lib, batch, variant):
    rng = np.random.default_rng(batch)
    state = torch.from_numpy(rng.integers(0, 1 << 16, size=(batch, 25, 4), dtype=np.int32))
    got = _host_permute(host_lib, variant)(state)
    assert torch.equal(got, keccak_torch.keccak_f1600_reference(state))


def _run_host(lib, compiled, asgs):
    """Truth of the host-built kernel body and of the plain version; every
    register the tape wrote must be equal too."""
    args, (T, V, A, K, R) = compiled.pack_args(asgs, "cpu")
    n = compiled.n_steps
    ref, ref_regs = ptape.run_tape_reference(*args, T=T, V=V, A=A, K=K, R=R, n_steps=n,
                                             return_regs=True)

    def segment(targs):
        assert lib.mk_tape_vm_segment_host(ctypes.byref(targs)) == 0

    regs = torch.empty((V + T, 16, args[0].shape[0]), dtype=torch.int32)
    got = ptape.run_segments(
        *args, T=T, V=V, A=A, K=K, R=R, plan=compiled.plan, segment=segment,
        permute=_host_permute(lib), regs=regs,
    )
    assert torch.equal(regs[: V + n].permute(0, 2, 1).long(), ref_regs[: V + n])
    # and without the debug copy, as the main path runs
    assert torch.equal(ptape.run_segments(
        *args, T=T, V=V, A=A, K=K, R=R, plan=compiled.plan, segment=segment,
        permute=_host_permute(lib)), got)
    return ref, got


@pytest.mark.parametrize("n_cand", [48, 200], ids=["bucket64", "bucket256"])
@pytest.mark.parametrize("large", [False, True], ids=["small", "large"])
@pytest.mark.parametrize("family", list(cases.FAMILIES))
def test_host_tape_matches_reference(host_lib, family, large, n_cand):
    conj, bv_vars, arrays = cases.build(terms, family, large)
    asgs = cases.random_assignments(terms, pce, bv_vars, arrays, 5, n_cand)
    compiled = ptape.compile_tape(conj)
    ref, got = _run_host(host_lib, compiled, asgs)
    assert torch.equal(got, ref)
    for b, asg in enumerate(asgs[:48]):
        vals = pce.evaluate(conj, asg)
        assert got[b, : len(conj)].tolist() == [bool(vals[c]) for c in conj]


@pytest.mark.parametrize("case", list(cases.SLOT_CASES))
def test_host_tape_slot_cases(host_lib, case):
    # more than 200 slots; values spilled across both keccak steps; roots on
    # leaves and roots final at the first steps
    conj, bv_vars, arrays = cases.build(terms, case)
    asgs = cases.random_assignments(terms, pce, bv_vars, arrays, 13, 40)
    compiled = ptape.compile_tape(conj)
    ref, got = _run_host(host_lib, compiled, asgs)
    assert torch.equal(got, ref)
    for b, asg in enumerate(asgs):
        vals = pce.evaluate(conj, asg)
        assert got[b, : len(conj)].tolist() == [bool(vals[c]) for c in conj]
    plan = compiled.plan
    assert {"wide_live": plan.leaf_base > 64, "keccak_live": plan.n_spill > 0,
            "leaf_roots": len(plan.pre) > len(conj) - 4}[case]


def test_host_tape_bucket_256(host_lib):
    conj, bv_vars, arrays = cases.build(terms, "keccak64", False)
    asgs = cases.random_assignments(terms, pce, bv_vars, arrays, 9, 200)
    ref, got = _run_host(host_lib, ptape.compile_tape(conj), asgs)
    assert got.shape[0] == 256
    assert torch.equal(got, ref)


def _random_tape(seed, n=28, V=6, A=2, K=3, R=5):
    """A tape over all 20 op codes, with forward references (which read as
    zero) and roots on leaves, invalid roots and rows past the last step;
    the packed inputs as int32/uint8 CPU tensors."""
    from mythril_tpu_torch.ops import bitvec as pbv

    rng = np.random.default_rng(seed)
    T = n + 2
    tape = {k: np.zeros(T, np.int32) for k in ("op", "a0", "a1", "a2", "aux")}
    tape["wmask"] = np.zeros((T, 16), np.uint32)
    for t in range(n):
        tape["op"][t] = rng.integers(0, 20)
        for k in ("a0", "a1", "a2"):
            tape[k][t] = rng.integers(0, V + (T if rng.random() < 0.1 else t))
        tape["aux"][t] = rng.integers(0, A)
        tape["wmask"][t] = pbv.from_ints_np((1 << int(rng.choice([1, 8, 64, 256]))) - 1, 256)
    tape["root_rows"] = rng.integers(0, V + T, R).astype(np.int32)
    tape["root_valid"] = rng.random(R) < 0.8
    B = 5
    leaf = np.where(rng.random((B, V, 1)) < 0.4, rng.integers(0, 8, (B, V, 16)) * (np.arange(16) == 0),
                    rng.integers(0, 1 << 16, (B, V, 16)))
    keys = np.arange(K) + K * rng.integers(0, 2, (B, A, K))
    host = (leaf, keys[..., None] * (np.arange(16) == 0), rng.integers(0, 1 << 16, (B, A, K, 16)),
            rng.random((B, A, K)) < 0.7, rng.integers(0, 1 << 16, (B, A, 16)),
            *(tape[k] for k in ("op", "a0", "a1", "a2", "aux", "wmask", "root_rows", "root_valid")))
    args = tuple(torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint8 if x.dtype == bool else np.int32))
                 for x in host)
    return tape, args, (n, T, V, A, K, R)


@pytest.mark.parametrize("seed", range(8))
def test_host_tape_random(host_lib, seed):
    # forward references read the zero slot, SELECTs the table slots
    tape, args, (n, T, V, A, K, R) = _random_tape(seed)
    plan = ptape.TapePlan(tape, n, V, T, A, K, R)
    want, want_regs = ptape.run_tape_reference(*args, T=T, V=V, A=A, K=K, R=R, n_steps=n,
                                               return_regs=True)

    def segment(targs):
        assert host_lib.mk_tape_vm_segment_host(ctypes.byref(targs)) == 0

    regs = torch.empty((V + T, 16, args[0].shape[0]), dtype=torch.int32)
    got = ptape.run_segments(*args, T=T, V=V, A=A, K=K, R=R, plan=plan, segment=segment,
                             permute=_host_permute(host_lib), regs=regs)
    assert torch.equal(got, want)
    assert torch.equal(regs[: V + n].permute(0, 2, 1).long(), want_regs[: V + n])


def test_out_of_range_tape_rows_are_refused():
    conj, bv_vars, arrays = cases.build(terms, "add", False)
    compiled = ptape.compile_tape(conj)
    tape = {k: v.copy() if isinstance(v, np.ndarray) else v for k, v in compiled.tensors.items()}
    T, V, A, K, R = tape["shape"]
    tape["a1"][0] = V + T
    with pytest.raises(ValueError, match="out of range"):
        ptape._check_tape(tape, compiled.n_steps, V, T, A, R)


def _host_known_bits(lib, nodes, wm, cl, okm, okv, n_rows, smem=None):
    """known_bits.cuh's pass built for the host, driven as the wrapper
    drives the kernel (the level plan from the nodes, the route by size
    unless ``smem`` forces one); the output planes start poisoned."""
    n = nodes.shape[0]
    km = torch.full((n, n_rows, 16), -1, dtype=torch.int32)
    kv = torch.full_like(km, -1)
    refuted = torch.ones(n_rows, dtype=torch.bool)
    zero = torch.zeros(16, dtype=torch.int32)  # held: args keeps only its address
    plan = kb_device.level_plan(nodes[:, 2:5].numpy())
    plan_t = torch.from_numpy(plan.packed())
    args = kb_device.kb_args(nodes, wm, cl, okm, okv, zero, plan_t, plan.n_levels, km, kv,
                             refuted, smem)
    assert lib.mk_known_bits_host(ctypes.byref(args)) == 0
    return km, kv, refuted


@pytest.mark.parametrize("seed,n_nodes,n_rows", [(1, 64, 1), (4, 512, 16), (5, 96, 64)])
def test_host_known_bits_matches_plain(host_lib, seed, n_nodes, n_rows):
    """known_bits.cuh's pass by levels against eval_kb_plain on synthetic
    tapes (every op code, missing children, overrides)."""
    pack = tier_cases.kb_pack(tier_cases.random_kb_fields(seed, n_nodes, n_rows), kb_tape)
    inputs = kb_domains.kb_inputs(pack, "cpu")
    got = _host_known_bits(host_lib, *inputs, n_rows)
    want = kb_domains.eval_kb_plain(*inputs, n_rows)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_host_known_bits_matches_plain_on_recorded_packs(host_lib):
    from tests import test_torch_engine_tiers as tiers

    for rec in tiers.load_kernels()["kb"][::4]:
        inputs = kb_domains.kb_inputs(tiers.kb_pack(rec), "cpu")
        got = _host_known_bits(host_lib, *inputs, int(rec["n_rows"]))
        want = kb_domains.eval_kb_plain(*inputs, int(rec["n_rows"]))
        assert all(torch.equal(g, w) for g, w in zip(got, want)), rec["run"]


def _host_dpll(lib, lits, dec, n_vars, iters, threads):
    """dpll.cuh's run_query for a block of ``threads`` threads (fibers, the
    last thread first up to each barrier) against run_plain: status,
    assignment and steps."""
    lits, dec = torch.from_numpy(lits), torch.from_numpy(dec)
    status = torch.full((lits.shape[0],), 9, dtype=torch.int8)
    assign = torch.full((lits.shape[0], n_vars), 9, dtype=torch.int8)
    steps = torch.full((lits.shape[0],), -1, dtype=torch.int32)
    args = dpll_device.dpll_args(lits, dec, status, assign, steps, n_vars, iters, threads)
    assert lib.mk_dpll_host(ctypes.byref(args), threads) == 0
    want = dpll_kernel.run_plain(lits, dec, n_vars, iters)
    for g, w in zip((status, assign, steps), want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("seed,q,c,v,iters,threads", [
    (1, 4, 512, 512, 2048, 256), (1, 4, 512, 512, 2048, 7), (2, 16, 512, 512, 2048, 7),
    (3, 4, 512, 512, 20, 256), (4, 4, 4096, 4096, 40, 256), (4, 4, 4096, 4096, 40, 1024),
    (5, 4, 4096, 4096, 40, 97)])
def test_host_dpll_matches_plain(host_lib, seed, q, c, v, iters, threads):
    """dpll.cuh's search on seeded planes, at the kernel's block sizes (256
    for the small clause bucket, 1024 for the large one) and odd ones."""
    plane = tier_cases.random_cnf_plane(seed, q, c, v, dpll_kernel)
    _host_dpll(host_lib, plane.lits, plane.dec, plane.n_vars, iters, threads)


DPLL_EDGE = tier_cases.dpll_edge_cases()


@pytest.mark.parametrize("threads", ["kernel", 37])
@pytest.mark.parametrize("case", DPLL_EDGE, ids=[c["label"] for c in DPLL_EDGE])
def test_host_dpll_edge_planes(host_lib, case, threads):
    """dpll.cuh's search on the hand-built edge planes (``dpll_edge_cases``)
    at the kernel's block size and at an odd one."""
    lits = case["lits"]
    if threads == "kernel":
        threads = dpll_device.block_threads(lits.shape[1])
    _host_dpll(host_lib, lits, case["dec"], case["n_vars"], case["iters"], threads)


def _host_lowering(lib):
    def launch(largs):
        assert lib.mk_lowering_host(ctypes.byref(largs)) == 0
    return launch


@pytest.mark.parametrize("width", lcases.WIDTHS)
@pytest.mark.parametrize("family", list(lcases.FAMILIES))
def test_host_lowering_matches_plain(host_lib, family, width):
    conj, bv_vars, arrays = lcases.build(terms, family, width)
    asgs = lcases.random_assignments(terms, pce, bv_vars, arrays, 100 + width, 20)
    pc = plow.compile_conjunction(conj)
    inputs = plow.pack_assignments(pc, asgs)
    got, want, bad = lcases.kernel_and_plain(pc, inputs, _host_lowering(host_lib))
    assert bad == []
    assert torch.equal(got, want)


@pytest.mark.parametrize("keys,n", [(8, 1), (16, 63), (64, 192)])
def test_host_lowering_tables(host_lib, keys, n):
    conj, bv_vars, arrays = lcases.build(terms, "array", 256)
    asgs = lcases.random_assignments(terms, pce, bv_vars, arrays, keys, n, keys)
    pc = plow.compile_conjunction(conj)
    inputs = plow.pack_assignments(pc, asgs)
    got, want, bad = lcases.kernel_and_plain(pc, inputs, _host_lowering(host_lib))
    assert bad == [] and torch.equal(got, want)


@pytest.mark.parametrize("case", ["wide", "long_keccak"])
def test_host_lowering_routes(host_lib, case):
    """Both routes of the kernel: a program past the shared-memory budget
    keeps its values in the global arena; keccak of three rate blocks."""
    conj, bv_vars, arrays = getattr(lcases, case)(terms)
    asgs = lcases.random_assignments(terms, pce, bv_vars, arrays, 5, 12)
    pc = plow.compile_conjunction(conj)
    inputs = plow.pack_assignments(pc, asgs)
    seen = []

    def launch(largs):
        seen.append(largs.in_smem)
        _host_lowering(host_lib)(largs)

    got, want, bad = lcases.kernel_and_plain(pc, inputs, launch)
    assert bad == [] and torch.equal(got, want)
    assert seen == [int(case == "long_keccak")]
    for b, asg in enumerate(asgs):
        vals = pce.evaluate(conj, asg)
        assert got[b].tolist() == [bool(vals[c]) for c in conj]


def test_host_lowering_matches_plain_on_recorded_dispatches(host_lib):
    from tests._torch_lowering_cases import load_recorded, recorded_inputs

    meta, arrays, conjs = load_recorded()
    for n, (d, conj) in enumerate(zip(meta["dispatches"], conjs)):
        if d.get("jax_error"):
            continue
        pc = plow.compile_conjunction(conj)
        got, want, bad = lcases.kernel_and_plain(pc, recorded_inputs(arrays, n, d),
                                                _host_lowering(host_lib))
        assert bad == [], n
        assert torch.equal(got, want), n
        assert np.array_equal(got.numpy(), arrays[f"{n}_truth"]), n
