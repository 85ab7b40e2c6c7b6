"""The static pass (``mythril_tpu_torch/staticpass``) against the JAX package's.

Exact, tolerance 0, with the interprocedural layer on and off:

* every ``StaticSummary`` field (blocks, edges, reachability, resolved jump
  targets, reachable opcodes, taint reachability, escalated bits, JUMPI
  edge liveness, unreachable spans, underflow blocks, the recovered
  function map, the interesting points; all but the wall time) on the
  recorded contracts (``CONTRACTS``: the engine fixture's six, KillBilly
  with its creation code, and ``_torch_parity.dead_code_contract``), on
  every bytecode literal of the JAX package's own tests under
  ``tests/staticpass/``, and on 200 seeded random byte strings, which are
  full of dead code and bad jumps;
* the ``staticpass.*`` counters those summaries leave, the interprocedural
  fallbacks among them;
* the detector gate's kept and skipped modules, its self-disables by
  reason, ``report_dict`` and ``staticpass_meta``;
* the detection modules' static declarations, and the frontier engine's
  ``_hook_info`` with each contract's summary;
* ``CodeTables`` (``event``, ``loop_id``, ``n_loops``, ``static_target``)
  on the dead-code contract, whose pruned events the counters show.
"""

from __future__ import annotations

import ast
import collections
import contextlib
import dataclasses
import importlib
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from tests._torch_parity import _one_torch_thread  # noqa: E402,F401  (autouse fixture)
from tests._torch_parity import (  # noqa: E402
    dead_code_contract,
    reset_host_tier_counters,
    staticpass_counters,
)
from tests.test_torch_cli import without_walls  # noqa: E402

PACKAGES = ("mythril_tpu", "mythril_tpu_torch")
N_RANDOM = 200
# opcodes the structured half of the random inputs is drawn from: jumps,
# jump destinations, pushes of small targets, and the hooked and taint ops
_STRUCTURED = bytes.fromhex("5b565760015b5b80905033ff5554f13a3242435a3401fd00fe")


def _contract_codes() -> dict:
    """name -> (runtime bytes, creation bytes or None)."""
    import bench

    from tests.test_torch_engine_fixture import code_of

    out = {name: (code_of(name), None) for name in (
        "bectoken_like", "etherstore_like", "rubixi_like", "wide_contract_10",
        "largecode_contract_2400", "kill_simple")}
    out["killbilly"] = (bytes.fromhex(bench.KILLBILLY), bytes.fromhex(bench.KILLBILLY_CREATION))
    out["dead_code"] = (bytes.fromhex(dead_code_contract()), None)
    return out


CONTRACTS = _contract_codes()


def _hex_literals(node) -> list:
    """The even-length hex strings a test module spells out, implicit and
    ``+`` concatenations of literals included."""
    def value(n):
        if isinstance(n, ast.Constant) and isinstance(n.value, str):
            return n.value
        if isinstance(n, ast.BinOp) and isinstance(n.op, ast.Add):
            a, b = value(n.left), value(n.right)
            return a + b if a is not None and b is not None else None
        return None

    out = []
    for n in ast.walk(node):
        v = value(n)
        if v and len(v) >= 2 and len(v) % 2 == 0 and all(c in "0123456789abcdef" for c in v):
            out.append(v)
    return out


def jax_test_inputs() -> list:
    """Every bytecode literal of the JAX package's static-pass tests, once."""
    seen = []
    for path in sorted((REPO / "tests" / "staticpass").glob("test_*.py")):
        for v in _hex_literals(ast.parse(path.read_text())):
            if v not in seen:
                seen.append(v)
    return [bytes.fromhex(v) for v in seen]


def random_inputs(seed: int = 2026, n: int = N_RANDOM) -> list:
    """``n`` byte strings of 1..400 bytes: half uniform, half drawn from
    ``_STRUCTURED`` with small PUSH1 immediates."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        size = int(rng.integers(1, 401))
        if i % 2:
            out.append(rng.integers(0, 256, size, dtype=np.uint8).tobytes())
        else:
            out.append(rng.choice(np.frombuffer(_STRUCTURED, np.uint8), size).tobytes())
    return out


def plain(x):
    """A summary (or any part of one) as plain comparable values: the
    dataclasses as dicts (``wall_s`` left out), arrays as dtype and list,
    sets sorted."""
    if dataclasses.is_dataclass(x):
        return {f.name: plain(getattr(x, f.name)) for f in dataclasses.fields(x)
                if f.name != "wall_s"}
    if isinstance(x, np.ndarray):
        return (str(x.dtype), x.tolist())
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, (set, frozenset)):
        return sorted(plain(v) for v in x)
    if isinstance(x, dict):
        return sorted((plain(k), plain(v)) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    return x


@contextlib.contextmanager
def interproc(on: bool):
    """Both packages' ``staticpass`` on and ``staticpass_interproc`` as asked."""
    flags = [importlib.import_module(f"{b}.support.support_args").args for b in PACKAGES]
    saved = [(a.staticpass, a.staticpass_interproc) for a in flags]
    for a in flags:
        a.staticpass, a.staticpass_interproc = True, on
    try:
        yield
    finally:
        for a, (sp, ip) in zip(flags, saved):
            a.staticpass, a.staticpass_interproc = sp, ip


def _reset_both() -> None:
    for base in PACKAGES:
        sp = importlib.import_module(f"{base}.staticpass")
        sp.clear_cache()
        sp.reset_views()
        sp.get_callgraph().reset()
        reset_host_tier_counters(base)


def summary_of(base: str, code: bytes, is_creation: bool = False):
    """``summarize`` of ``base`` on ``code``, or the exception's type name."""
    disassembler = importlib.import_module(f"{base}.frontend.disassembler")
    summary = importlib.import_module(f"{base}.staticpass.summary")
    try:
        ins = disassembler.Disassembly(code).instruction_list
        return plain(summary.summarize(ins, code_size=len(code), is_creation=is_creation))
    except Exception as e:
        return ("raised", type(e).__name__)


def _inputs(group: str) -> list:
    if group == "contracts":
        return [(c, False) for c, _ in CONTRACTS.values()] + [
            (cr, True) for _, cr in CONTRACTS.values() if cr is not None]
    if group == "jax_tests":
        return [(c, False) for c in jax_test_inputs()] + [(c, True) for c in jax_test_inputs()]
    return [(c, False) for c in random_inputs()]


@pytest.mark.parametrize("on", [True, False], ids=["interproc", "base"])
@pytest.mark.parametrize("group", ["contracts", "jax_tests", "random"])
def test_summaries_equal(group, on):
    inputs = _inputs(group)
    assert len(inputs) >= {"contracts": 9, "jax_tests": 20, "random": N_RANDOM}[group]
    _reset_both()
    with interproc(on):
        for i, (code, creation) in enumerate(inputs):
            want = summary_of("mythril_tpu", code, creation)
            assert summary_of("mythril_tpu_torch", code, creation) == want, (group, i, code.hex())
    # the interprocedural fallbacks and function-recovery failures agree too
    assert staticpass_counters("mythril_tpu_torch") == staticpass_counters("mythril_tpu")


def test_inputs_exercise_the_pass():
    """The inputs reach what the pass prunes: dead spans, underflows,
    escalated taint bits, recovered dispatchers, interprocedural refinement
    and interesting points."""
    from mythril_tpu_torch.staticpass.summary import summarize
    from mythril_tpu_torch.frontend.disassembler import Disassembly

    _reset_both()
    seen = collections.Counter()
    with interproc(True):
        for code in random_inputs() + jax_test_inputs() + [c for c, _ in CONTRACTS.values()]:
            s = summarize(Disassembly(code).instruction_list, code_size=len(code))
            seen["dead"] += bool(s.unreachable_spans)
            seen["underflow"] += bool(s.underflow_blocks)
            seen["escalated"] += bool(s.escalated_bits)
            seen["dispatch"] += bool(s.function_map and s.function_map.dispatch_recovered)
            seen["refined"] += s.interproc_ok
            seen["points"] += bool(s.interesting_points)
    assert all(seen[k] > 0 for k in ("dead", "underflow", "escalated", "dispatch", "refined",
                                     "points")), seen


def _contract(base: str, name: str):
    """The contract as the analysis gets it: raw runtime bytes, or an
    ``EVMContract`` with its creation code."""
    runtime, creation = CONTRACTS[name]
    if creation is None:
        return runtime
    evm = importlib.import_module(f"{base}.frontend.evmcontract")
    return evm.EVMContract(code=runtime.hex(), creation_code=creation.hex(), name="KillBilly")


def _callback_modules(base: str):
    loader = importlib.import_module(f"{base}.analysis.module.loader")
    module_base = importlib.import_module(f"{base}.analysis.module.base")
    return loader.ModuleLoader().get_detection_modules(module_base.EntryPoint.CALLBACK)


def _gate(base: str, name: str, **kw):
    sp = importlib.import_module(f"{base}.staticpass")
    view = sp.gate_view_for_contract(_contract(base, name), **kw)
    kept, skipped = sp.filter_modules(_callback_modules(base), view)
    return {"kept": sorted(type(m).__name__ for m in kept),
            "skipped": sorted(type(m).__name__ for m in skipped),
            "view": None if view is None else view.skipped_modules}


@pytest.mark.parametrize("on", [True, False], ids=["interproc", "base"])
def test_gate_decisions_equal(on):
    class Dyn:
        active = True

    _reset_both()
    with interproc(on):
        got = {}
        for base in PACKAGES:
            got[base] = [_gate(base, name) for name in CONTRACTS]
            # the self-disables: an active dynamic loader, a creation-only input
            got[base].append(_gate(base, "kill_simple", dynloader=Dyn()))
            evm = importlib.import_module(f"{base}.frontend.evmcontract")
            creation_only = evm.EVMContract(creation_code=CONTRACTS["killbilly"][1].hex())
            sp = importlib.import_module(f"{base}.staticpass")
            got[base].append(sp.gate_view_for_contract(creation_only) is None)
            # the report's CFG nodes are numbered from a process-wide
            # counter: from 0 in both packages, as in a fresh process
            importlib.import_module(f"{base}.core.cfg").gbl_next_uid[0] = 0
            got[base].append(without_walls(sp.report_dict()))
            got[base].append(sp.staticpass_meta())
    assert got["mythril_tpu_torch"] == got["mythril_tpu"]
    assert staticpass_counters("mythril_tpu_torch") == staticpass_counters("mythril_tpu")
    disabled = staticpass_counters("mythril_tpu_torch")["gate_disabled"]
    assert disabled == {"creation_only": 1, "dynloader_active": 1}
    if on:
        skipped = {name: g["skipped"] for name, g in zip(CONTRACTS, got["mythril_tpu"])}
        assert len(skipped["bectoken_like"]) == 9 and len(skipped["kill_simple"]) == 11


def test_module_declarations_equal():
    """The gate and the hook elision read these from the module objects."""
    attrs = ("static_required_ops", "static_taint_sources", "static_taint_sinks",
             "taint_source_hooks", "concrete_nop_hooks", "value_gated_hooks",
             "pre_hooks", "post_hooks", "entry_point")

    def decl(base):
        return {type(m).__name__: {a: plain(getattr(m, a, None)) for a in attrs
                                   if a != "entry_point"} | {"entry": m.entry_point.name}
                for m in importlib.import_module(f"{base}.analysis.module.loader")
                .ModuleLoader().get_detection_modules()}

    jax, port = decl("mythril_tpu"), decl("mythril_tpu_torch")
    assert port == jax and len(port) == 14
    assert sum(bool(d["static_taint_sources"]) for d in port.values()) > 0


class _Laser:
    """What ``_hook_info`` reads of a laser: its pre and post hooks."""

    def __init__(self, base: str, modules):
        util = importlib.import_module(f"{base}.analysis.module.util")
        self._pre_hooks = collections.defaultdict(list)
        self._post_hooks = collections.defaultdict(list)
        for op, funcs in util.get_detection_module_hooks(modules, "pre").items():
            self._pre_hooks[op].extend(funcs)
        for op, funcs in util.get_detection_module_hooks(modules, "post").items():
            self._post_hooks[op].extend(funcs)


def hook_info(base: str, name: str, gated: bool):
    """``FrontierEngine._hook_info`` of ``base`` for the contract's runtime
    code, with every callback module hooked (``gated``: those the gate
    keeps) and the code's summary."""
    sp = importlib.import_module(f"{base}.staticpass")
    disassembler = importlib.import_module(f"{base}.frontend.disassembler")
    engine = importlib.import_module(f"{base}.frontier.engine")
    modules = _callback_modules(base)
    if gated:
        modules, _ = sp.filter_modules(modules, sp.gate_view_for_contract(_contract(base, name)))
    summary = sp.summary_for_code(disassembler.Disassembly(CONTRACTS[name][0]))
    laser = _Laser(base, modules)
    return [sorted(s) for s in engine.FrontierEngine._hook_info(laser, summary)] + [
        sorted(s) for s in engine.FrontierEngine._hook_info(laser)]


@pytest.mark.parametrize("on", [True, False], ids=["interproc", "base"])
def test_hook_info_equal(on):
    _reset_both()
    with interproc(on):
        for name in CONTRACTS:
            for gated in (False, True):
                want = hook_info("mythril_tpu", name, gated)
                assert hook_info("mythril_tpu_torch", name, gated) == want, (name, gated)
    assert staticpass_counters("mythril_tpu_torch") == staticpass_counters("mythril_tpu")
    # the elision fired: some opcode left a hooked set because of a summary
    assert staticpass_counters("mythril_tpu_torch").get("hooks_elided_device", 0) > 0


def code_tables(base: str, code: bytes):
    """``CodeTables`` of ``base`` for ``code`` with the hooked sets of
    ``_hook_info`` (every callback module the gate keeps) and the summary."""
    sp = importlib.import_module(f"{base}.staticpass")
    disassembler = importlib.import_module(f"{base}.frontend.disassembler")
    engine = importlib.import_module(f"{base}.frontier.engine")
    code_mod = importlib.import_module(f"{base}.frontier.code")
    arena = importlib.import_module(f"{base}.frontier.arena")
    dis = disassembler.Disassembly(code)
    modules, _ = sp.filter_modules(_callback_modules(base), sp.gate_view_for_contract(code))
    summary = sp.summary_for_code(dis)
    hooked, conc_nop, val_gate = engine.FrontierEngine._hook_info(_Laser(base, modules), summary)
    return code_mod.CodeTables(dis.instruction_list, arena.HostArena(1 << 14),
                               hooked_opcodes=hooked, code_size=len(code),
                               conc_nop_opcodes=conc_nop, value_gate_opcodes=val_gate,
                               static_summary=summary)


@pytest.mark.parametrize("on", [True, False], ids=["interproc", "base"])
def test_code_tables_prune_the_dead_span(on):
    code = CONTRACTS["dead_code"][0]
    _reset_both()
    with interproc(on):
        jt, pt = code_tables("mythril_tpu", code), code_tables("mythril_tpu_torch", code)
    for f in ("event", "loop_id", "static_target"):
        np.testing.assert_array_equal(getattr(pt, f), getattr(jt, f), err_msg=f)
    assert pt.n_loops == jt.n_loops
    counts = staticpass_counters("mythril_tpu_torch")
    assert counts == staticpass_counters("mythril_tpu")
    # the span's SSTORE, JUMPI, SELFDESTRUCT and STOP lose their events, and
    # its JUMPDEST its loop slot
    assert counts["events_pruned"] == 4 and counts["jumpi_events_pruned"] == 1
    names = pt.opcode_names
    always = ("SSTORE", "JUMPI", "SELFDESTRUCT", "STOP")
    dead = [i for i in range(len(names) - 1) if not pt.event[i] and names[i] in always]
    assert [names[i] for i in dead] == list(always)
    jumpdests = [i for i, n in enumerate(names) if n == "JUMPDEST"]
    assert pt.loop_id[jumpdests[-1]] == -1 and pt.loop_id[jumpdests[0]] >= 0


@pytest.mark.parametrize("name", list(CONTRACTS))
def test_event_plane_changes_only_on_dead_rows(name):
    """On the recorded contracts the static pass changes no event row that
    can run: the tables with the gate's modules and the summary against
    every module's hooks and no summary differ only on unreachable rows
    (the dead-code contract's four), so the segment ships the same events
    with the pass on and off."""
    from mythril_tpu_torch.frontend.disassembler import Disassembly
    from mythril_tpu_torch.frontier.arena import HostArena
    from mythril_tpu_torch.frontier.code import CodeTables
    from mythril_tpu_torch.frontier.engine import FrontierEngine

    code = CONTRACTS[name][0]
    _reset_both()
    with interproc(True):
        on = code_tables("mythril_tpu_torch", code)
        summary = importlib.import_module("mythril_tpu_torch.staticpass").summary_for_code(
            Disassembly(code))
    hooked = FrontierEngine._hook_info(_Laser("mythril_tpu_torch",
                                              _callback_modules("mythril_tpu_torch")))[0]
    off = CodeTables(Disassembly(code).instruction_list, HostArena(1 << 14),
                     hooked_opcodes=hooked, code_size=len(code))
    differ = np.flatnonzero(on.event != off.event)
    assert not summary.instr_reachable[differ].any()
    assert len(differ) == (4 if name == "dead_code" else 0)
