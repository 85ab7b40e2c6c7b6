"""The frontier segment kernel's body, built for the host, against the plain
version, bit for bit.

``csrc/frontier_segment.cuh`` is ``__host__ __device__``, the loop
(``run_segment``) included; ``csrc/host_check.cpp``'s
``mk_frontier_segment_host`` runs that loop with an executor that owns
every lane: each barrier is the phase finished for every path, the warp
counts go to the same parity buffers, the grant list is staged in tiles,
and the child copies run as (child, segment) items over the warps.  A host C++ compiler builds it into a shared library in the test's
temporary directory, and ``step.kernel_args`` packs the same arguments the
CUDA wrapper packs, over CPU tensors.  Every case of
``tests/_torch_frontier_cases.py`` (the 33 families on concrete and
symbolic operands, the caps and parity hazards, the fork phases' cases,
random batches, and one batch at each launch width) must give the plain
segment's outputs exactly, and the recorded dispatches of the
small runs (``tests/testdata/torch_frontier_dispatches.npz``) the JAX
digests.  The launch itself runs only on a card
(``chip_smoke.py``, ``tests/test_torch_cuda.py``).
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess

import numpy as np
import pytest

from mythril_tpu_torch.frontier import interop
from mythril_tpu_torch.frontier import ops as PO
from mythril_tpu_torch.frontier import step as PS
from mythril_tpu_torch.ops import _build
from tests._torch_parity import _one_torch_thread  # noqa: E402,F401  (autouse fixture)
from tests import _torch_frontier_cases as cases
from tests._torch_frontier_cases import assert_same


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    out = tmp_path_factory.mktemp("csrc") / "libmk_frontier_host.so"
    subprocess.run(
        [cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-I", str(_build.CSRC),
         str(_build.CSRC / "host_check.cpp"), "-o", str(out)],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(out))
    lib.mk_frontier_segment_host.argtypes = [ctypes.POINTER(PS.FrontierArgs)]
    lib.mk_frontier_segment_host.restype = ctypes.c_int
    return lib


def run_host(lib, case):
    inputs = interop.inputs_from_numpy(case["state"], case["arena"], case["arena_len"],
                                       case["visited"], case["code"], case["cfg"], "cpu")
    args, (state, arena, visited, out), _keep = PS.kernel_args(*inputs, case.get("caps", cases.CAPS))
    assert lib.mk_frontier_segment_host(ctypes.byref(args)) == 0
    return interop.outputs_to_numpy((state, arena, out[0], out[1], out[2], visited))


def run_plain(case):
    inputs = interop.inputs_from_numpy(case["state"], case["arena"], case["arena_len"],
                                       case["visited"], case["code"], case["cfg"], "cpu")
    return interop.outputs_to_numpy(PS.segment_torch(*inputs, case.get("caps", cases.CAPS)))


def all_cases():
    out = [(f"family_{f}_{'c' if c else 's'}", cases.family_case(f, c))
           for f in sorted(cases.FAMILY_OPS) for c in (True, False)]
    out += [(f"binops_{c}_{i}", x) for c in (True, False) for i, x in enumerate(cases.binop_case(c))]
    out += sorted(cases.special_cases().items())
    out.append(("odd_shapes", cases.odd_shapes_case()))
    return out


def test_kernel_body_on_every_case(host_lib):
    for name, case in all_cases():
        got, want = run_host(host_lib, case), run_plain(case)
        try:
            assert_same(got, want)
        except AssertionError as e:
            raise AssertionError(f"case {name}: {e}") from None


@pytest.mark.parametrize("seed", range(40))
def test_kernel_body_random_batches(host_lib, seed):
    case = cases.random_case(seed)
    assert_same(run_host(host_lib, case), run_plain(case))


@pytest.mark.parametrize("B", cases.WIDTHS)
def test_kernel_body_at_every_launch_width(host_lib, B):
    """One block, one cluster and a grid, and their edges: warp words,
    block tallies, the grant list's tiles and the child copies across
    blocks."""
    case = cases.width_case(B, 0)
    got, want = run_host(host_lib, case), run_plain(case)
    assert_same(got, want)
    if B > 1:  # the fork rounds filled every slot, and a child's junk events were reset
        assert (want[0]["seed"] >= 0).all() and (want[0]["halt"] == PO.H_PENDING_FORK).any()


@pytest.mark.parametrize("B", cases.ODD_EVT_WIDTHS)
def test_kernel_body_resets_unaligned_event_buffers(host_lib, B):
    """A child's event buffer that starts and ends off a 16-byte boundary:
    the reset's leading words, 16-byte stores and trailing words."""
    case = cases.width_case(B, 0, evt=cases.ODD_EVT)
    got, want = run_host(host_lib, case), run_plain(case)
    assert_same(got, want)
    assert (want[0]["seed"] >= 0).all()


def test_kernel_body_leaves_inputs_alone(host_lib):
    case = cases.random_case(7)
    before = [np.array(x) for x in case["state"]]
    run_host(host_lib, case)
    for a, b in zip(before, case["state"]):
        np.testing.assert_array_equal(a, b)


def test_kernel_body_replays_recorded_dispatches(host_lib):
    """The host build on real dispatches (the small runs), against the JAX
    digests stored in the fixture."""
    from tests.test_torch_frontier_fixture import iter_dispatches, mismatches

    n = 0
    keep = lambda name, i, data: name in ("etherstore_like", "rubixi_like", "bectoken_like")  # noqa: E731
    for name, i, d in iter_dispatches(keep=keep):
        inputs = interop.inputs_from_numpy(d["state"], d["arena"], d["arena_len"], d["visited"],
                                           d["code"], d["cfg"], "cpu")
        args, (state, arena, visited, out), _keep = PS.kernel_args(*inputs, d["caps"])
        assert host_lib.mk_frontier_segment_host(ctypes.byref(args)) == 0
        got = interop.output_digests((state, arena, out[0], out[1], out[2], visited))
        assert mismatches(got, d["digests"]) == [], f"{name} dispatch {i}"
        n += 1
    assert n == 11
