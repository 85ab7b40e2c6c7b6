"""The port's CUDA kernels on a card, against their plain versions.

Marked ``cuda``: each test needs an NVIDIA card with ``nvcc`` (sm_90a) and
skips without one.  On the card machine, from the repository root
(``--noconftest``: tests/conftest.py configures JAX, which the port's
machine need not have):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

``chip_smoke.py`` runs the same comparisons at the main path's shapes.
"""

import numpy as np
import pytest
import torch

from mythril_tpu_torch.ops import keccak_cuda, keccak_torch, tape_vm
from mythril_tpu_torch.smt import concrete_eval, terms
from tests import _torch_tape_cases as cases

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
