"""The frontier's host modules and transfers in the port, against the JAX package.

* ``CodeTables`` and the bucket helpers (``frontier/code.py``) on the
  recorded contracts' code (``tests/test_torch_frontier_fixture.py`` RUNS),
  disassembled by the JAX package's disassembler, with and without a
  static summary, paged and not: every table, every bucket, and the rows
  the tables interned into the arena.
* ``HostArena`` (``frontier/arena.py``): the same appends give the same
  rows; decoding gives the same terms (JAX terms carried across with
  ``serialize.from_jax_dump``); pulls from the device.
* The synchronous transfers (``frontier/step.py``): ``push_state``,
  ``pull_harvest`` (with the events bucket each side picks),
  ``pull_arena_rows`` and ``push_arena_rows``, on the same arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from mythril_tpu_torch.frontier import code as PC
from mythril_tpu_torch.frontier import state as PST
from mythril_tpu_torch.frontier import step as PS
from mythril_tpu_torch.frontier.arena import HostArena as PArena
from mythril_tpu_torch.support.support_args import args as pargs
from tests._torch_parity import _one_torch_thread  # noqa: E402,F401  (autouse fixture)
from tests import _torch_frontier_cases as cases
from tests.test_torch_frontier_fixture import RUNS, _code

HOOKED = ("ADD", "SUB", "MUL", "SSTORE", "CALL", "JUMP", "MSTORE", "CALLER", "ORIGIN")
CONC_NOP = ("ADD", "SUB", "MUL", "JUMP")


def _instructions(name):
    from mythril_tpu.frontend.disassembler import disassemble

    return disassemble(_code(name))


def _summary(instructions, code_size):
    from mythril_tpu.staticpass.summary import summarize

    return summarize(instructions, code_size=code_size)


TABLE_FIELDS = ("fam", "aux", "arity", "gmin", "gmax", "event", "concskip", "valgate", "addr",
                "jumpmap", "loop_id", "static_target")


@pytest.mark.parametrize("static", [False, True], ids=["plain", "static_summary"])
@pytest.mark.parametrize("name", [r[0] for r in RUNS])
def test_code_tables_match(name, static):
    from mythril_tpu.frontier import code as JC
    from mythril_tpu.frontier.arena import HostArena as JArena

    ins = _instructions(name)
    size = len(_code(name))
    summary = _summary(ins, size) if static else None
    jarena, parena = JArena(1 << 14), PArena(1 << 14)
    kw = dict(hooked_opcodes=HOOKED, code_size=size, conc_nop_opcodes=CONC_NOP,
              value_gate_opcodes=("MSTORE",), static_summary=summary)
    jt, pt = JC.CodeTables(ins, jarena, **kw), PC.CodeTables(ins, parena, **kw)
    for f in TABLE_FIELDS:
        np.testing.assert_array_equal(getattr(pt, f), getattr(jt, f), err_msg=f)
    assert (pt.n, pt.n_loops, pt.opcode_names) == (jt.n, jt.n_loops, jt.opcode_names)
    assert jarena.length == parena.length
    for j, p in zip(jarena.device_arrays(), parena.device_arrays()):
        np.testing.assert_array_equal(p, j)
    assert pt.size_bucket() == jt.size_bucket()
    assert pt.full_instr_cap() == jt.full_instr_cap() and pt.is_paged() == jt.is_paged()
    bucket = pt.size_bucket()
    for base in (0, 64, max(0, pt.n - 100)):
        for j, p in zip(jt.padded_device_tables(bucket, window_base=base),
                        pt.padded_device_tables(bucket, window_base=base)):
            np.testing.assert_array_equal(p, j)


def test_buckets_and_stacked_tables_match():
    from mythril_tpu.frontier import code as JC
    from mythril_tpu.frontier.arena import HostArena as JArena

    lists = [_instructions(r[0]) for r in RUNS]
    jarena, parena = JArena(1 << 14), PArena(1 << 14)
    jts = [JC.CodeTables(i, jarena) for i in lists]
    pts = [PC.CodeTables(i, parena) for i in lists]
    for fn in ("multi_size_bucket", "bucket_classes", "visited_instr_cap"):
        assert getattr(PC, fn)(pts) == getattr(JC, fn)(jts), fn
    assert PC.bucket_hint(lists) == JC.bucket_hint(lists)
    assert PC.bucket_hint_classes(lists) == JC.bucket_hint_classes(lists)
    bucket = PC.multi_size_bucket(pts)
    assert PC.pad_waste_pct(pts, bucket) == JC.pad_waste_pct(jts, bucket)
    bases = [0, 0, 3, 0, 2048]
    for j, p in zip(JC.stacked_device_tables(jts, bucket, page_bases=bases),
                    PC.stacked_device_tables(pts, bucket, page_bases=bases)):
        np.testing.assert_array_equal(p, j)


@pytest.mark.parametrize("paging,budget", [(True, 2048), (True, 512), (False, 2048), (True, 0)])
def test_page_budget_matches(paging, budget):
    from mythril_tpu.frontier import code as JC
    from mythril_tpu.frontier.arena import HostArena as JArena
    from mythril_tpu.support.support_args import args as jargs

    ins = _instructions("largecode_contract_2400")
    saved = [(a, a.code_paging, a.code_page_budget) for a in (jargs, pargs)]
    try:
        for a in (jargs, pargs):
            a.code_paging, a.code_page_budget = paging, budget
        assert PC.page_budget() == JC.page_budget()
        jt, pt = JC.CodeTables(ins, JArena(1 << 14)), PC.CodeTables(ins, PArena(1 << 14))
        assert pt.size_bucket() == jt.size_bucket() and pt.is_paged() == jt.is_paged()
        assert PC._hint_size_bucket(ins) == JC._hint_size_bucket(ins)
    finally:
        for a, p, b in saved:
            a.code_paging, a.code_page_budget = p, b


# ---------------------------------------------------------------------------
# HostArena
# ---------------------------------------------------------------------------


def _fill(arena, T):
    """The same appends through either package's HostArena and terms."""
    rows = [arena.const_row(v) for v in (0, 1, 2, (1 << 256) - 1, 1 << 255, 77)]
    rows.append(arena.const_row(5, 8))
    x, y = T.var("x", 256), T.var("y", 256)
    rows += [arena.var_row(x), arena.var_row(y), arena.var_row(x)]
    rows.append(arena.fresh_var_row(T.const(9, 256), no_fold=True))
    rows.append(arena.tainted_row(y, 4))
    terms = [T.add(x, y), T.bnot(T.mul(x, T.const(3, 256))), T.ult(x, y),
             T.ite(T.ult(x, y), x, y), T.concat2(x, y), T.extract(7, 0, x), T.keccak(x),
             T.lshr(x, T.const(4, 256)), T.eq(T.sub(x, y), T.const(0, 256))]
    rows += [arena.encode(t) for t in terms]
    return rows


def test_host_arena_rows_and_decode_match():
    from mythril_tpu.frontier.arena import HostArena as JArena
    from mythril_tpu.smt import serialize as JSer
    from mythril_tpu.smt import terms as JT

    from mythril_tpu_torch.smt import serialize as PSer
    from mythril_tpu_torch.smt import terms as PT

    jarena, parena = JArena(256), PArena(256)
    jrows, prows = _fill(jarena, JT), _fill(parena, PT)
    assert jrows == prows and jarena.length == parena.length
    for j, p in zip(jarena.device_arrays(), parena.device_arrays()):
        np.testing.assert_array_equal(p, j)
    np.testing.assert_array_equal(parena.taint, jarena.taint)
    # device-shaped rows the segment writes, then decode every row
    for arena in (jarena, parena):
        arena._append(30, a=3, width=256)  # A_NOT
        arena._append(48, a=7)  # A_EQZ
        arena._append(60, a=prows[-3], b=1, c=0, width=256)  # A_ITEW
        arena._append(3, a=7, width=256)  # A_VARF
        arena._append(74, a=2, b=7)  # A_BYTE
        arena._append(73, a=2, b=7)  # A_SIGNEXT
    decoded_j = [jarena.decode(r) for r in range(jarena.length)]
    decoded_p = [parena.decode(r) for r in range(parena.length)]
    carried = PSer.from_jax_dump(JSer.dump_terms(decoded_j))
    assert carried == decoded_p
    assert [parena.const_value(r) for r in range(6)] == [jarena.const_value(r) for r in range(6)]


def test_host_arena_generations_and_freeze():
    a, b = PArena(16), PArena(16)
    assert a.generation != b.generation and a.op is not b.op
    a.freeze()
    with pytest.raises(RuntimeError):
        a.const_row(3)
    a.thaw()
    assert a.const_row(3) == 0


def test_pull_from_device_matches():
    import jax.numpy as jnp

    from mythril_tpu.frontier import step as JS
    from mythril_tpu.frontier.arena import HostArena as JArena

    rng = np.random.default_rng(5)
    T = PS.ARENA_CHUNK + 900
    cols = _random_arena(rng, T)
    jdev = JS.ArenaDev(*[jnp.asarray(c) for c in cols])
    pdev = PS.ArenaDev(*_torch_arena(cols))
    jarena, parena = JArena(T), PArena(T)
    for arena in (jarena, parena):
        arena.const_row(1)
    jarena.pull_from_device(jdev, T - 5)
    parena.pull_from_device(pdev, T - 5)
    assert parena.length == jarena.length == T - 5
    for j, p in zip(jarena.device_arrays(), parena.device_arrays()):
        np.testing.assert_array_equal(p, j)


# ---------------------------------------------------------------------------
# transfers
# ---------------------------------------------------------------------------


def _random_arena(rng, T):
    return [rng.integers(-5, 1 << 20, T).astype(np.int32) for _ in range(5)] + [
        rng.integers(0, 1 << 16, (T, 16)).astype(np.uint32), rng.random(T) < 0.5]


def _torch_arena(cols):
    from mythril_tpu_torch.frontier import interop

    return interop.arena_to_torch(cols, "cpu")


@pytest.mark.parametrize("lo,hi", [(0, 5), (3, PS.ARENA_CHUNK + 7), (PS.ARENA_CHUNK - 2, PS.ARENA_CHUNK + 899),
                                   (100, 100), (0, PS.ARENA_CHUNK + 900)])
def test_pull_arena_rows_matches(lo, hi):
    import jax.numpy as jnp

    from mythril_tpu.frontier import step as JS

    cols = _random_arena(np.random.default_rng(lo + hi), PS.ARENA_CHUNK + 900)
    want = JS.pull_arena_rows(JS.ArenaDev(*[jnp.asarray(c) for c in cols]), lo, hi) if hi > lo else None
    got = PS.pull_arena_rows(PS.ArenaDev(*_torch_arena(cols)), lo, hi) if hi > lo else None
    if want is None:
        assert got is None or all(len(c) == 0 for c in got)
        return
    for j, p in zip(want, got):
        assert p.dtype == np.asarray(j).dtype
        np.testing.assert_array_equal(p, j)


@pytest.mark.parametrize("lo,hi", [(0, 10), (250, 530), (990, 1000), (0, 1000)])
def test_push_arena_rows_matches(lo, hi):
    import jax.numpy as jnp

    from mythril_tpu.frontier import step as JS

    T = 1000
    rng = np.random.default_rng(hi)
    dev_cols = _random_arena(rng, T)
    host = PArena(T)
    for v in range(min(hi + 3, T)):
        host.const_row(int(rng.integers(0, 1 << 62)) + v)
    want = JS.push_arena_rows(JS.ArenaDev(*[jnp.asarray(c) for c in dev_cols]), host, lo, hi)
    got = PS.push_arena_rows(PS.ArenaDev(*_torch_arena(dev_cols)), host, lo, hi)
    for name, j, p in zip(PS.ArenaDev._fields, want, got):
        p = p.numpy()
        np.testing.assert_array_equal(p.view(np.uint32) if name == "val" else p, np.asarray(j),
                                      err_msg=name)


def test_push_state_matches():
    import jax

    from mythril_tpu.frontier import step as JS

    st = cases.random_case(3)["state"]
    want = JS.push_state(st)
    got = PS.push_state(st, device="cpu")
    for name in PST.FrontierState._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert isinstance(getattr(want, "pc"), jax.Array)


@pytest.mark.parametrize("max_ev", [0, 1, 8, 9, 32, 33, 128, 129, 200])
def test_pull_harvest_matches_with_events_bucket(max_ev, monkeypatch):
    import jax.numpy as jnp

    from mythril_tpu.frontier import state as JST
    from mythril_tpu.frontier import step as JS

    caps = dataclasses.replace(cases.CAPS, B=4, EVT=200)
    rng = np.random.default_rng(max_ev)
    st = PST.empty_state(caps, 8)
    fields = {n: rng.integers(-3, 1000, np.asarray(getattr(st, n)).shape).astype(np.int32)
              for n in PST.FrontierState._fields}
    fields["ev_len"] = np.array([0, max_ev, max_ev // 2, 0], np.int32)
    caps_seen = {"jax": [], "port": []}
    j_pack, p_pack = JS._pack_events, PS._pack_events
    monkeypatch.setattr(JS, "_pack_events", lambda s, cap: caps_seen["jax"].append(cap) or j_pack(s, cap))
    monkeypatch.setattr(PS, "_pack_events", lambda s, cap: caps_seen["port"].append(cap) or p_pack(s, cap))
    want = JS.pull_harvest(JST.FrontierState(**{n: jnp.asarray(x) for n, x in fields.items()}),
                           7, 11, 3)
    got = PS.pull_harvest(PST.FrontierState(**{n: torch.from_numpy(x) for n, x in fields.items()}),
                          torch.tensor(7, dtype=torch.int32), 11, torch.tensor(3, dtype=torch.int32))
    assert got[1:] == tuple(want[1:]) == (7, 11, 3)
    for name in PST.FrontierState._fields:
        np.testing.assert_array_equal(getattr(got[0], name), getattr(want[0], name), err_msg=name)
    assert caps_seen["port"] == caps_seen["jax"]
    assert caps_seen["port"] == ([] if max_ev == 0 else [PS.events_cap(max_ev, 200)])


def test_round_trip_through_the_plain_segment():
    """push_state -> segment -> pull_harvest -> HostArena.pull_from_device,
    on the CPU, against the segment's own outputs."""
    case = cases.family_case(cases.O.F_JUMPI, False)
    dev_state = PS.push_state(case["state"], device="cpu")
    from mythril_tpu_torch.frontier import interop

    _s, arena, alen, visited, code, cfg = interop.inputs_from_numpy(
        case["state"], case["arena"], case["arena_len"], case["visited"], case["code"],
        case["cfg"], "cpu")
    segment = PS.cached_segment(cases.CAPS, *cases.BUCKET, device="cpu")
    out = segment(dev_state, arena, alen, visited, code, cfg)
    host, new_len, n_exec, max_live = PS.pull_harvest(out[0], out[2], out[3], out[4])
    assert (new_len, n_exec, max_live) == (int(out[2]), int(out[3]), int(out[4]))
    assert n_exec > 0 and (host.ev_len > 0).any()
    for name in PST.FrontierState._fields:
        np.testing.assert_array_equal(getattr(host, name), getattr(out[0], name).numpy())
    mirror = PArena(cases.CAPS.ARENA)
    mirror.length = case["arena_len"]
    mirror.pull_from_device(out[1], new_len)
    assert mirror.length == new_len > case["arena_len"]
    lo = case["arena_len"]
    for name, col in zip(PS.ArenaDev._fields, mirror.device_arrays()):
        want = getattr(out[1], name)[lo:new_len].numpy()
        np.testing.assert_array_equal(col[lo:new_len], want.view(np.uint32) if name == "val" else want)
