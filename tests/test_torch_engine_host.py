"""The port's host LASER engine against the JAX package's, whole analyses.

``SymExecWrapper`` + ``fire_lasers`` of each package on the contracts of
``tests/frontier/test_frontier_engine.py`` and ``kill_simple.bin-runtime``
with ``args.frontier`` off (the default ``analyze`` path): the port on the
CPU (``device="cpu"``: the solver's tape VM and keccak run their plain
PyTorch versions), the JAX package under ``jax_engine_config`` (the port's
solver tiers and engine configuration).  Every cache is cleared before each
run.  Tolerance 0: the same issue keys ``(swc_id, address, function,
severity, title)``, the same number of transaction steps per issue and the
same selector on the last step.
"""

import pytest

from tests._torch_parity import _one_torch_thread  # noqa: E402,F401  (autouse fixture)
from tests._torch_parity import engine_contracts, jax_engine_config, run_analysis

CONTRACTS = engine_contracts()


@pytest.mark.parametrize("name", sorted(CONTRACTS))
def test_host_engine_issues_match_jax(name):
    code, tx, modules = CONTRACTS[name]
    port = run_analysis("mythril_tpu_torch", bytes.fromhex(code), tx_count=tx, modules=modules)
    with jax_engine_config():
        ref = run_analysis("mythril_tpu", bytes.fromhex(code), tx_count=tx, modules=modules)
    assert port["summary"] == ref["summary"]
    if name not in ("clean", "parked_call"):
        assert port["summary"], f"{name}: no issue found"
