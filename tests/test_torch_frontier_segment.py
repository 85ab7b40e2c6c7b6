"""The port's plain frontier segment against the JAX segment, bit for bit.

The same numpy inputs (``tests/_torch_frontier_cases.py``, one caps and one
code bucket, so the JAX segment compiles once) go through
``mythril_tpu.frontier.step.cached_segment`` and through the port's
``segment_torch`` on the CPU; every output array must be equal (tolerance
0): every state field, every arena column over the whole arena, the
coverage planes, ``arena_len``, ``n_exec`` and ``max_live``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from mythril_tpu_torch.frontier import interop
from mythril_tpu_torch.frontier import ops as PO
from mythril_tpu_torch.frontier import step as PS
from tests._torch_parity import _one_torch_thread  # noqa: E402,F401  (autouse fixture)
from tests import _torch_frontier_cases as cases
from tests._torch_frontier_cases import assert_same


def run_jax(case):
    import jax.numpy as jnp

    from mythril_tpu.frontier import state as JST
    from mythril_tpu.frontier import step as JS

    caps = JST.Caps(**dataclasses.asdict(cases.CAPS))
    segment = JS.cached_segment(caps, *cases.BUCKET)
    out = segment(
        JST.FrontierState(*[jnp.asarray(x) for x in case["state"]]),
        JS.ArenaDev(*[jnp.asarray(x) for x in case["arena"]]),
        case["arena_len"], jnp.asarray(case["visited"]),
        JS.CodeDev(*[jnp.asarray(x) for x in case["code"]]),
        JS.CfgScalars(*[np.int32(v) for v in case["cfg"]]),
    )
    return interop.outputs_to_numpy(out)


def run_port(case, device="cpu"):
    segment = PS.cached_segment(cases.CAPS, *cases.BUCKET, device=device)
    out = segment(*interop.inputs_from_numpy(case["state"], case["arena"], case["arena_len"],
                                        case["visited"], case["code"], case["cfg"], device))
    return interop.outputs_to_numpy(out)


def fams_run(case):
    """Families the batch's running paths dispatch at their first step."""
    st, code = case["state"], case["code"]
    out = set()
    for b in range(len(st.pc)):
        if st.halt[b] != PO.H_RUNNING or st.seed[b] < 0:
            continue
        cid = min(max(int(st.code_id[b]), 0), code[0].shape[0] - 1)
        rel = int(st.pc[b]) - int(code[10][cid])
        out.add(PO.F_PAGEFAULT if not 0 <= rel < code[0].shape[1] else int(code[0][cid, rel]))
    return out


@pytest.mark.parametrize("concrete", [True, False], ids=["concrete", "symbolic"])
@pytest.mark.parametrize("fam", sorted(cases.FAMILY_OPS))
def test_family(fam, concrete):
    case = cases.family_case(fam, concrete)
    assert fams_run(case) == {fam}
    assert_same(run_port(case), run_jax(case))


@pytest.mark.parametrize("concrete", [True, False], ids=["concrete", "symbolic"])
def test_binops_and_comparisons(concrete):
    for case in cases.binop_case(concrete):
        assert_same(run_port(case), run_jax(case))


SPECIAL = cases.special_cases()


@pytest.mark.parametrize("name", sorted(SPECIAL))
def test_special(name):
    case = SPECIAL[name]
    got, want = run_port(case), run_jax(case)
    assert_same(got, want)
    halts = set(want[0]["halt"].tolist())
    expect = {
        "underflow": PO.H_INVALID, "stack_cap": PO.H_PARK, "event_full": PO.H_PENDING_FORK,
        "depth_and_loop": PO.H_DEPTH, "static_write": PO.H_INVALID, "paging": PO.H_PAGE_FAULT,
        "full_batch": PO.H_PENDING_FORK, "sel_mode_0": PO.H_PENDING_FORK,
        "fork_alternate": PO.H_PENDING_FORK, "fork_no_room": PO.H_PENDING_FORK,
        "fork_no_slot": PO.H_PENDING_FORK,
    }.get(name)
    assert expect is None or expect in halts, (name, halts)
    if name == "depth_and_loop":
        assert PO.H_LOOP in halts
    if name == "arena_full":
        assert want[2] + 6 * cases.CAPS.R >= cases.CAPS.ARENA  # stopped by room
    if name == "beam_key_max":  # granted the second free slot (rank 1: slot 0 sorts first)
        assert want[0]["seed"][3] >= 0 and want[0]["seed"][2] < 0
    if name == "mstore_gate":
        # the concrete words with the Panic selector on top: slots 0, 1, 4, 5
        assert (want[0]["ev_len"] > 0).tolist() == [True, True, False, False, True, True, False, False]


@pytest.mark.parametrize("seed", range(24))
def test_random_batches(seed):
    case = cases.random_case(seed)
    assert_same(run_port(case), run_jax(case))


def test_family_pagefault_is_covered():
    assert PO.F_PAGEFAULT in fams_run(SPECIAL["paging"])


def test_odd_shapes():
    """Arena past caps.ARENA, coverage planes narrower than the code axes
    (one more JAX compile)."""
    case = cases.odd_shapes_case()
    got, want = run_port(case), run_jax(case)
    assert_same(got, want)
    # dead slots wrote their zero rows at row caps.ARENA
    assert want[1]["op"][cases.CAPS.ARENA] == 0 and want[1]["a"][cases.CAPS.ARENA] == 0
