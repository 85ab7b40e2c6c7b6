"""The CUDA sources' arithmetic, built for the host and held against the plain
PyTorch versions, bit for bit.

``csrc/keccak.cuh``, ``csrc/bitvec.cuh`` and ``csrc/tape_vm.cuh`` are
``__host__ __device__``; ``csrc/host_check.cpp`` wraps the body one CUDA
thread runs (one state, one candidate) in a host loop, with the tape's slot
file as a host array poisoned at every segment's start, and runs the
warp-per-state keccak body on 25 host threads.  A host C++ compiler builds
it into a shared library in the test's temporary directory, and
``tape_vm.run_segments`` drives it exactly as ``run_tape`` drives the
kernels: the tape's slot plan, segments split at keccak steps, the spill and
the permutation between them.
The launch code in the ``.cu`` files runs only on a card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from mythril_tpu_torch.ops import _build, keccak_torch
from mythril_tpu_torch.ops import tape_vm as ptape
from mythril_tpu_torch.smt import concrete_eval as pce
from mythril_tpu_torch.smt import terms
from tests import _torch_tape_cases as cases


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
