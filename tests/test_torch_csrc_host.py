"""The CUDA sources' arithmetic, built for the host and held against the plain
PyTorch versions, bit for bit.

``csrc/keccak.cuh``, ``csrc/bitvec.cuh`` and ``csrc/tape_vm.cuh`` are
``__host__ __device__``; ``csrc/host_check.cpp`` wraps the body one CUDA
thread runs (one state, one candidate) in a host loop.  A host C++ compiler
builds it into a shared library in the test's temporary directory, and
``tape_vm.run_segments`` drives it exactly as ``run_tape`` drives the
kernels: segments split at keccak steps, the permutation between them.
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
        [cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", str(_build.CSRC),
         str(_build.CSRC / "host_check.cpp"), "-o", str(out)],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(out))
    lib.mk_keccak_f1600_host.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong]
    lib.mk_tape_vm_segment_host.argtypes = [ctypes.POINTER(_build.TapeArgs)]
    lib.mk_tape_vm_segment_host.restype = ctypes.c_int
    return lib


def _host_permute(lib):
    def permute(state):
        state = state.contiguous()
        out = torch.empty_like(state)
        lib.mk_keccak_f1600_host(state.data_ptr(), out.data_ptr(), state.shape[0])
        return out
    return permute


@pytest.mark.parametrize("batch", [1, 3, 130])
def test_host_keccak_matches_reference(host_lib, batch):
    rng = np.random.default_rng(batch)
    state = torch.from_numpy(rng.integers(0, 1 << 16, size=(batch, 25, 4), dtype=np.int32))
    got = _host_permute(host_lib)(state)
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
        *args, T=T, V=V, A=A, K=K, R=R, n_steps=n,
        host_tape=compiled.tensors, segment=segment, permute=_host_permute(lib), regs=regs,
    )
    assert torch.equal(regs[: V + n].permute(0, 2, 1).long(), ref_regs[: V + n])
    return ref, got.bool()


@pytest.mark.parametrize("large", [False, True], ids=["small", "large"])
@pytest.mark.parametrize("family", list(cases.FAMILIES))
def test_host_tape_matches_reference(host_lib, family, large):
    conj, bv_vars, arrays = cases.build(terms, family, large)
    asgs = cases.random_assignments(terms, pce, bv_vars, arrays, 5, 48)
    compiled = ptape.compile_tape(conj)
    ref, got = _run_host(host_lib, compiled, asgs)
    assert torch.equal(got, ref)
    for b, asg in enumerate(asgs):
        vals = pce.evaluate(conj, asg)
        assert got[b, : len(conj)].tolist() == [bool(vals[c]) for c in conj]


def test_host_tape_bucket_256(host_lib):
    conj, bv_vars, arrays = cases.build(terms, "keccak64", False)
    asgs = cases.random_assignments(terms, pce, bv_vars, arrays, 9, 200)
    ref, got = _run_host(host_lib, ptape.compile_tape(conj), asgs)
    assert got.shape[0] == 256
    assert torch.equal(got, ref)


def test_out_of_range_tape_rows_are_refused():
    conj, bv_vars, arrays = cases.build(terms, "add", False)
    compiled = ptape.compile_tape(conj)
    tape = {k: v.copy() if isinstance(v, np.ndarray) else v for k, v in compiled.tensors.items()}
    T, V, A, K, R = tape["shape"]
    tape["a1"][0] = V + T
    with pytest.raises(ValueError, match="out of range"):
        ptape._check_tape(tape, compiled.n_steps, V, T, A, R)
