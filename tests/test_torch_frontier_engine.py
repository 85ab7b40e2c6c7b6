"""The port's synchronous device frontier against the JAX package's.

``SymExecWrapper`` + ``fire_lasers`` with ``args.frontier`` on, the port on
the CPU (``device="cpu"``: the plain segment, tape VM and keccak), the JAX
package under ``jax_engine_config`` (the port's solver tiers; no pipeline,
mesh, static pass or adaptive controller; serial harvest).  Every cache is
cleared before each run.  Tolerance 0 throughout:

* forced (``frontier_force``): the same issues (keys, transaction steps and
  last selector), the same sequence of segment dispatches — each one's
  input digests (``interop.input_digests``: pushed state, arena rows, the
  coverage planes, code tables, cfg) and output digests — and the same
  ``FrontierStatistics`` segment, path-step and park counts; no replay or
  commit error;
* unforced: the same issue keys;
* the walker: every row it decodes (term and annotations) and binds, in
  order, on the event streams of real runs;
* an error in the segment propagates out of ``SymExecWrapper``.
"""

import sys
from pathlib import Path

import pytest

from tests._torch_parity import _one_torch_thread  # noqa: E402,F401  (autouse fixture)
from tests._torch_parity import (
    engine_contracts,
    issue_key,
    jax_engine_config,
    run_analysis,
    to_port,
)

CONTRACTS = engine_contracts()


def _both(code, tx, modules, **kw):
    port = run_analysis("mythril_tpu_torch", code, tx_count=tx, modules=modules, **kw)
    with jax_engine_config():
        ref = run_analysis("mythril_tpu", code, tx_count=tx, modules=modules, **kw)
    return port, ref


def _mismatched(port_dispatches, ref_dispatches):
    out = []
    for i, (a, b) in enumerate(zip(port_dispatches, ref_dispatches)):
        for side in ("in", "out"):
            bad = sorted(k for k in b[side] if a[side].get(k) != b[side][k])
            if bad:
                out.append((i, side, bad[:4]))
    return out


@pytest.mark.parametrize("name", sorted(CONTRACTS))
def test_forced_frontier_matches_jax(name):
    code, tx, modules = CONTRACTS[name]
    port, ref = _both(bytes.fromhex(code), tx, modules, frontier=True, force=True)
    assert port["summary"] == ref["summary"]
    assert len(port["dispatches"]) == len(ref["dispatches"]) > 0
    assert _mismatched(port["dispatches"], ref["dispatches"]) == []
    for key in ("segments", "device_instructions", "device_paths", "parks_by_reason",
                "parks_by_opcode"):
        assert port["frontier"][key] == ref["frontier"][key], key
    assert port["frontier"]["replay_errors"] == port["frontier"]["commit_errors"] == 0


def test_unforced_frontier_issue_keys_match_jax():
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import bench

    port, ref = _both(bench._wide_contract(4), 1, None, frontier=True, force=False)
    assert sorted(map(issue_key, port["issues"])) == sorted(map(issue_key, ref["issues"]))
    assert port["issues"]


def _log_walker(walker_cls, log):
    """Wrap ``decode_wrapped`` and ``bind`` of a Walker class to append
    (kind, row, seed, wrapper) to ``log``; -> the restore function."""
    decode, bind = walker_cls.decode_wrapped, walker_cls.bind

    def logged_decode(self, row, seed_idx=0):
        w = decode(self, row, seed_idx)
        log.append(("decode", int(row), seed_idx, w))
        return w

    def logged_bind(self, row, wrapper, seed_idx=0):
        log.append(("bind", row, seed_idx, wrapper))
        return bind(self, row, wrapper, seed_idx)

    walker_cls.decode_wrapped, walker_cls.bind = logged_decode, logged_bind

    def restore():
        walker_cls.decode_wrapped, walker_cls.bind = decode, bind

    return restore


@pytest.mark.parametrize("name", ["tx_origin", "timestamp", "killbilly_2tx"])
def test_walker_decode_and_bind_match_jax(name):
    from mythril_tpu.frontier.walker import Walker as JaxWalker

    from mythril_tpu_torch.frontier.walker import Walker

    code, tx, modules = CONTRACTS[name]
    port_log, ref_log = [], []
    restore = _log_walker(Walker, port_log)
    try:
        run_analysis("mythril_tpu_torch", bytes.fromhex(code), tx_count=tx, modules=modules,
                     frontier=True, force=True, record=False)
    finally:
        restore()
    restore = _log_walker(JaxWalker, ref_log)
    try:
        with jax_engine_config():
            run_analysis("mythril_tpu", bytes.fromhex(code), tx_count=tx, modules=modules,
                         frontier=True, force=True, record=False)
    finally:
        restore()
    assert [e[:3] for e in port_log] == [e[:3] for e in ref_log]
    assert any(e[0] == "decode" for e in port_log)
    ref_terms = to_port([e[3].raw for e in ref_log])
    for (kind, row, _seed, w), (_k, _r, _s, rw), t in zip(port_log, ref_log, ref_terms):
        assert w.raw is t, f"{kind} row {row}: the terms differ"
        names = sorted(type(a).__name__ for a in w.annotations)
        assert names == sorted(type(a).__name__ for a in rw.annotations), f"{kind} row {row}"
    if name == "tx_origin":
        assert any(a for e in port_log for a in e[3].annotations), "no taint reached a decode"


def test_segment_error_propagates(monkeypatch):
    """A failing segment raises out of SymExecWrapper; the host engine does
    not take over."""
    from mythril_tpu_torch.frontier import engine

    def cached_segment(*a, **kw):
        def segment(*args):
            raise RuntimeError("injected segment failure")

        return segment

    monkeypatch.setattr(engine, "cached_segment", cached_segment)
    code, tx, modules = CONTRACTS["selfdestruct"]
    with pytest.raises(RuntimeError, match="injected segment failure"):
        run_analysis("mythril_tpu_torch", bytes.fromhex(code), tx_count=tx, modules=modules,
                     frontier=True, force=True, record=False)


def test_kernel_error_inside_a_replay_propagates(monkeypatch):
    """A tape VM launch that fails while the walker replays a path (issue
    confirmation runs inside the replay) raises out of SymExecWrapper; it
    is not counted as one path's replay error."""
    from mythril_tpu_torch.ops import _build
    from mythril_tpu_torch.smt import solver

    calls = []

    def failing(compiled, candidates, device):
        calls.append(len(candidates))
        raise _build.KernelLaunchError("tape_vm: CUDA error 700 at launch")

    monkeypatch.setattr(solver, "_evaluate_candidates_device", failing)
    code, tx, modules = CONTRACTS["selfdestruct"]
    with pytest.raises(_build.KernelLaunchError):
        run_analysis("mythril_tpu_torch", bytes.fromhex(code), tx_count=tx, modules=modules,
                     frontier=True, force=True, record=False)
    assert calls
