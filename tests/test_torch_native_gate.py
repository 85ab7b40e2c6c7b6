"""The transaction-end issue gate (``analysis/potential_issues._gate_issues``)
of the port against the JAX package's, both with native CDCL on.

A contract parks four integer issues on one path: two overflows that the
path condition rules out (``z + 5`` and ``z * 3`` under ``z < 10``) and two
that it allows (``x + 1``, and ``y * 2``, the wide-multiply encoding).  The
same analysis runs in both packages (host engine, one transaction, the host
candidate stream on both sides so that no tape is compiled); every gate the
engine builds is recorded with its vector.  Tolerance 0: the same gate
vectors, issues and CDCL call counts, and every session the gate opened is
closed when the sweep ends.
"""

import pytest

from tests._torch_parity import _one_torch_thread  # noqa: E402,F401  (autouse fixture)
from tests._torch_parity import jax_engine_config_cdcl, run_analysis

CODE = bytes.fromhex(
    "604435" "80" "600a11" "15" "602b57"  # z = calldata[0x44]; if !(z < 10) goto end
    "80" "600501" "600255"                # sstore(2, z + 5): cannot overflow
    "600435" "600101" "600055"            # sstore(0, x + 1)
    "602435" "600202" "600155"            # sstore(1, y * 2)
    "600302" "600355" "00"                # sstore(3, z * 3): cannot overflow
    "5b00"                                # end
)
MODULES = ["IntegerArithmetics"]


def _gated(base: str):
    """Run the analysis with ``<base>``'s gate wrapped: -> (run, gates),
    each gate its vector and whether its session was closed by the end."""
    import importlib

    pi = importlib.import_module(f"{base}.analysis.potential_issues")
    args = importlib.import_module(f"{base}.support.support_args").args
    orig, gates, sessions = pi._gate_issues, [], []

    def gate_issues(global_state, issues):
        gate, session, enable_map = orig(global_state, issues)
        gates.append(list(gate))
        if session is not None:
            sessions.append(session)
        return gate, session, enable_map

    saved = args.probe_backend
    pi._gate_issues, args.probe_backend = gate_issues, "host"
    try:
        run = run_analysis(base, CODE, tx_count=1, modules=MODULES, cdcl=True)
    finally:
        pi._gate_issues, args.probe_backend = orig, saved
    return run, gates, [s._handle is None for s in sessions]


@pytest.fixture(scope="module")
def runs():
    port = _gated("mythril_tpu_torch")
    with jax_engine_config_cdcl():
        ref = _gated("mythril_tpu")
    return port, ref


def test_gate_vectors_match_jax(runs):
    (port, port_gates, _), (ref, ref_gates, _) = runs
    assert port_gates == ref_gates
    assert [False, True, True, False] in ref_gates


def test_gated_issues_and_cdcl_calls_match_jax(runs):
    (port, _, _), (ref, _, _) = runs
    assert port["summary"] == ref["summary"]
    assert sorted(r[1] for r in ref["summary"]) == [23, 32]  # x + 1 and y * 2
    assert port["cdcl"]["cdcl_calls"] == ref["cdcl"]["cdcl_calls"] > 0


def test_gate_sessions_are_closed(runs):
    (_, _, port_closed), (_, _, ref_closed) = runs
    assert port_closed and all(port_closed) and port_closed == ref_closed
