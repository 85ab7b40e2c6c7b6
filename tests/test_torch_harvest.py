"""The harvest executor (``mythril_tpu_torch/frontier/harvest.py``) against
the JAX package's (``mythril_tpu/frontier/harvest.py``).

The JAX ``tests/frontier/test_harvest.py`` cases on both packages: the
vectorized ingestion against the serial slot-order rescan it replaced, its
resumption from ``ev_seen``, the replay pool's laser affinity and slot
order, the serial escape hatch (``workers=0`` replays on the calling
thread), and the term intern table under threads.  Then whole analyses of
the port on the CPU with 0, 1 and 4 replay workers: the same issues and the
same park marks (``parks_by_opcode``, ``parks_by_reason``, ``device_paths``,
``semantic_parks``), on the JAX tests' fork-heavy contract (reconvergent
branches ending in an unguarded SELFDESTRUCT: 128 paths, and 16 paths at
width 8, which spill) and storage-gated two-transaction contract; and a ``DeviceError`` met by a replay worker reaching the calling
thread.
"""

from __future__ import annotations

import contextlib
import importlib
import threading

import numpy as np
import pytest
from tests._torch_parity import _one_torch_thread  # noqa: E402,F401  (autouse fixture)

BASES = ("mythril_tpu", "mythril_tpu_torch")


def _mod(base: str, name: str):
    return importlib.import_module(f"{base}.frontier.{name}")


# ---------------------------------------------------------------------------
# vectorized ingestion against the serial reference
# ---------------------------------------------------------------------------


def _serial_ingest(O, PathRecord, st, records, ev_seen):
    """The serial slot-order scan, repeated until no new record appears."""
    B = st.events.shape[0]
    changed = True
    while changed:
        changed = False
        for slot in range(B):
            rec = records[slot]
            if rec is None:
                continue
            n_ev = int(st.ev_len[slot])
            for k in range(int(ev_seen[slot]), n_ev):
                ev = st.events[slot, k].copy()
                ev_idx = len(rec.events)
                rec.events.append(ev)
                if int(ev[O.EV_KIND]) == O.E_FORK and int(ev[O.EV_EXTRA]) >= 0:
                    child_slot = int(ev[O.EV_EXTRA])
                    child = PathRecord(seed_idx=rec.seed_idx, parent=rec, fork_event_idx=ev_idx)
                    rec.children_by_event[ev_idx] = child
                    records[child_slot] = child
                    ev_seen[child_slot] = 0
                    changed = True
            ev_seen[slot] = n_ev


def _event(O, kind, pc, extra=-1):
    ev = np.full(O.EV_W, -1, np.int64)
    ev[O.EV_KIND], ev[O.EV_PC], ev[O.EV_EXTRA] = kind, pc, extra
    return ev


def _fixture_state(base: str, caps):
    """Slot 0 forks into slot 2, which forks (same segment) into slot 5;
    an unrelated path in slot 1 with a dead single-branch fork row."""
    O, state, records_mod = _mod(base, "ops"), _mod(base, "state"), _mod(base, "records")
    st = state.empty_state(caps, 4)
    records = {i: None for i in range(caps.B)}
    records[0] = records_mod.PathRecord(seed_idx=0)
    records[1] = records_mod.PathRecord(seed_idx=1)
    for s in (0, 1, 2, 5):
        st.seed[s] = 0 if s != 1 else 1
        st.halt[s] = O.H_RUNNING
    rows = {0: [(O.E_HOOK, 3), (O.E_FORK, 7, 2), (O.E_HOOK, 9)],
            1: [(O.E_HOOK, 4), (O.E_FORK, 6, -1)],
            2: [(O.E_HOOK, 8), (O.E_FORK, 11, 5)],
            5: [(O.E_HOOK, 12)]}
    for slot, evs in rows.items():
        for k, ev in enumerate(evs):
            st.events[slot, k] = _event(O, *ev)
        st.ev_len[slot] = len(evs)
    return st, records


def _seeded_state(base: str, caps, rng):
    """Random paths, hook rows and granted forks into free slots, chains
    included, from ``rng``."""
    O, state, records_mod = _mod(base, "ops"), _mod(base, "state"), _mod(base, "records")
    st = state.empty_state(caps, 4)
    records = {i: None for i in range(caps.B)}
    free = list(range(caps.B))
    roots = [free.pop(int(rng.integers(len(free)))) for _ in range(3)]
    todo = list(roots)
    for r in roots:
        records[r] = records_mod.PathRecord(seed_idx=int(rng.integers(3)))
    while todo:
        slot = todo.pop(0)
        st.seed[slot], st.halt[slot] = 0, O.H_RUNNING
        n = int(rng.integers(0, caps.EVT))
        for k in range(n):
            if free and rng.random() < 0.3:
                child = free.pop(int(rng.integers(len(free))))
                st.events[slot, k] = _event(O, O.E_FORK, int(rng.integers(50)), child)
                todo.append(child)
            else:
                st.events[slot, k] = _event(O, O.E_HOOK, int(rng.integers(50)))
        st.ev_len[slot] = n
    return st, records


def _record_shape(records):
    out = {}
    for slot, rec in records.items():
        if rec is None:
            continue
        out[slot] = {
            "seed": rec.seed_idx, "fork_event_idx": rec.fork_event_idx,
            "parent": next((s for s, r in records.items() if r is rec.parent), None),
            "events": [tuple(int(x) for x in ev) for ev in rec.events],
            "children": sorted(rec.children_by_event.keys()),
        }
    return out


@pytest.mark.parametrize("seed", [None, 0, 1, 2, 3])
def test_ingestion_equals_serial_reference_and_jax(seed):
    shapes = []
    for base in BASES:
        caps = _mod(base, "state").Caps(B=8 if seed is None else 24, EVT=8)
        build = ((lambda: _fixture_state(base, caps)) if seed is None else
                 (lambda: _seeded_state(base, caps, np.random.default_rng(seed))))
        (st_a, rec_a), (st_b, rec_b) = build(), build()
        seen_a, seen_b = np.zeros(caps.B, np.int64), np.zeros(caps.B, np.int64)
        _mod(base, "harvest").ingest_events(st_a, rec_a, seen_a)
        _serial_ingest(_mod(base, "ops"), _mod(base, "records").PathRecord, st_b, rec_b, seen_b)
        assert _record_shape(rec_a) == _record_shape(rec_b)
        assert np.array_equal(seen_a, seen_b)
        shapes.append((_record_shape(rec_a), seen_a.tolist()))
    assert shapes[0] == shapes[1]
    if seed is None:
        assert rec_a[5].parent is rec_a[2] and rec_a[2].parent is rec_a[0]
        assert rec_a[2].fork_event_idx == 1 and rec_a[0].children_by_event[1] is rec_a[2]


@pytest.mark.parametrize("base", BASES)
def test_ingestion_resumes_from_ev_seen(base):
    O, state, records_mod = _mod(base, "ops"), _mod(base, "state"), _mod(base, "records")
    caps = state.Caps(B=4)
    st = state.empty_state(caps, 4)
    records = {i: None for i in range(caps.B)}
    records[0] = records_mod.PathRecord(seed_idx=0)
    st.seed[0] = 0
    for k in range(3):
        st.events[0, k] = _event(O, O.E_HOOK, k + 1)
    ev_seen = np.zeros(caps.B, np.int64)
    st.ev_len[0] = 2
    _mod(base, "harvest").ingest_events(st, records, ev_seen)
    assert len(records[0].events) == 2 and ev_seen[0] == 2
    st.ev_len[0] = 3
    _mod(base, "harvest").ingest_events(st, records, ev_seen)
    assert [int(e[O.EV_PC]) for e in records[0].events] == [1, 2, 3] and ev_seen[0] == 3


# ---------------------------------------------------------------------------
# seed affinity: one worker per laser, slot order within it
# ---------------------------------------------------------------------------


class _Laser:
    def __init__(self):
        self.work_list = []
        self.total_states = 0


class _AffinityWalker:
    """Records which thread replays each record (a record's slot rides in
    ``slot_of``: the real record class has ``__slots__``)."""

    def __init__(self, seed_laser, slot_of, fail_on=None):
        self.lasers = [seed_laser[i] for i in range(len(seed_laser))]
        self.by_laser = {id(laser): [] for laser in set(seed_laser.values())}
        self.slot_of = slot_of
        self.fail_on = fail_on
        self.lock = threading.Lock()
        self.committed = []

    def laser_for(self, rec):
        return self.lasers[rec.seed_idx]

    def replay(self, rec):
        if self.fail_on is not None and self.slot_of[id(rec)] == self.fail_on:
            raise self.fail_on_error
        with self.lock:
            self.by_laser[id(self.laser_for(rec))].append(
                (threading.get_ident(), self.slot_of[id(rec)]))

    def commit(self, rec):
        self.committed.append(self.slot_of[id(rec)])


class _FakeEngine:
    def __init__(self, caps):
        self.caps = caps

    def _prune_running(self, st, records, walker, ev_seen, pipe=None):
        pass

    def _prefetch_mutation_checks(self, st, records, walker):
        pass


def _finished(base: str, n_slots: int, n_seeds: int, lasers, halt=None):
    O, state, records_mod = _mod(base, "ops"), _mod(base, "state"), _mod(base, "records")
    caps = state.Caps(B=16)
    st = state.empty_state(caps, 4)
    records, slot_of = {i: None for i in range(caps.B)}, {}
    for slot in range(n_slots):
        rec = records_mod.PathRecord(seed_idx=slot % n_seeds)
        records[slot], slot_of[id(rec)] = rec, slot
        st.seed[slot] = slot % n_seeds
        st.halt[slot] = O.H_STOP if halt is None else halt
    walker = _AffinityWalker({i: lasers[i % len(lasers)] for i in range(n_seeds)}, slot_of)
    return caps, st, records, walker


@pytest.mark.parametrize("base", BASES)
def test_replay_shards_have_laser_affinity_and_slot_order(base):
    harvest = _mod(base, "harvest")
    lasers = [_Laser(), _Laser(), _Laser()]
    caps, st, records, walker = _finished(base, 12, 6, lasers)
    try:
        harvest.HarvestExecutor(_FakeEngine(caps), workers=4).harvest(
            st, records, walker, np.zeros(caps.B, np.int64))
    finally:
        harvest.shutdown_replay_pool()
    for laser in lasers:
        replays = walker.by_laser[id(laser)]
        assert replays and len({t for t, _ in replays}) == 1
        assert [s for _, s in replays] == sorted(s for _, s in replays)
    assert walker.committed == sorted(walker.committed) and len(walker.committed) == 12
    assert all(records[s] is None for s in range(12))


@pytest.mark.parametrize("base", BASES)
def test_serial_escape_hatch_uses_no_pool(base):
    O = _mod(base, "ops")
    lasers = [_Laser()]
    caps, st, records, walker = _finished(base, 1, 1, lasers, halt=O.H_RETURN)
    _mod(base, "harvest").HarvestExecutor(_FakeEngine(caps), workers=0).harvest(
        st, records, walker, np.zeros(caps.B, np.int64))
    (replay,) = walker.by_laser[id(lasers[0])]
    assert replay[0] == threading.get_ident()


@pytest.mark.parametrize("workers", [0, 1, 4])
def test_replay_device_error_reaches_the_calling_thread(workers):
    """A ``DeviceError`` met by a replay (a worker's or the calling
    thread's) is raised by the harvest, once every other shard has
    finished."""
    from mythril_tpu_torch.device import DeviceError
    from mythril_tpu_torch.frontier import harvest

    lasers = [_Laser(), _Laser()]
    caps, st, records, walker = _finished("mythril_tpu_torch", 8, 4, lasers)
    walker.fail_on, walker.fail_on_error = 2, DeviceError("injected: the kernel did not build")
    try:
        with pytest.raises(DeviceError, match="injected"):
            harvest.HarvestExecutor(_FakeEngine(caps), workers=workers).harvest(
                st, records, walker, np.zeros(caps.B, np.int64))
    finally:
        harvest.shutdown_replay_pool()
    # with workers, the other laser's shard replayed whole; inline, the
    # replay stopped at the failing record (slot order)
    assert len(walker.by_laser[id(lasers[1])]) == (4 if workers else 1)


@pytest.mark.parametrize("base", BASES)
def test_intern_table_is_race_free_under_threads(base):
    terms = importlib.import_module(f"{base}.smt.terms")
    results = [[] for _ in range(8)]

    def mint(out):
        for i in range(200):
            x = terms.var("race_x%d" % (i % 10), 256)
            out.append(terms.add(x, terms.const(i % 7, 256)))

    threads = [threading.Thread(target=mint, args=(out,)) for out in results]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for other in results[1:]:
        for a, b in zip(results[0], other):
            assert a is b


# ---------------------------------------------------------------------------
# whole analyses: 0, 1 and 4 replay workers
# ---------------------------------------------------------------------------


def _fork_heavy(branches: int) -> bytes:
    """``branches`` reconvergent symbolic branches (2**branches concurrent
    paths) ending in an unguarded SELFDESTRUCT (tests/frontier/test_harvest.py
    has 8 at width 64)."""
    out = b""
    for k in range(branches):
        dest = len(out) + 10
        out += bytes([0x60, k, 0x35, 0x60, 0x01, 0x16,
                      0x61, (dest >> 8) & 0xFF, dest & 0xFF, 0x57, 0x5B])
    return out + bytes([0x33, 0xFF])


@contextlib.contextmanager
def _harvest_workers(n: int):
    from mythril_tpu_torch.support.support_args import args

    saved = args.harvest_workers
    args.harvest_workers = n
    try:
        yield
    finally:
        args.harvest_workers = saved


def _marked(code: bytes, tx: int, workers: int, width: int) -> tuple:
    from tests._torch_parity import run_analysis

    # no execution timeout within reach: a run the clock cuts parks its
    # paths by the wall, which differs from run to run
    with _harvest_workers(workers):
        got = run_analysis("mythril_tpu_torch", code, tx_count=tx, frontier=True, force=True,
                           width=width, modules=["AccidentallyKillable"], device="cpu",
                           timeout=3600, record=False, cdcl=True, tiers=True, defaults=True,
                           pipeline=True)
    f = got["frontier"]
    marks = {k: f[k] for k in ("parks_by_opcode", "parks_by_reason", "device_paths",
                               "replay_errors", "commit_errors")}
    from mythril_tpu_torch.frontier.stats import FrontierStatistics

    marks["semantic_parks"] = FrontierStatistics().semantic_parks
    return got["summary"], marks


# (name, transactions, width, the park reasons the serial run must show):
# 128 paths replayed at once (the JAX test's shape, one power smaller); 16
# paths at width 8, which spill batch-full and narrow-bail; the storage gate
HARVEST_RUNS = {
    "fork_heavy": (1, 112, ()),
    "spilling": (1, 8, ("batch-full", "narrow-bail")),
    "storage_gate": (2, 64, ()),
}


@pytest.mark.parametrize("name", list(HARVEST_RUNS))
def test_harvest_workers_give_equal_issues_and_park_marks(name):
    from mythril_tpu_torch.frontier.harvest import shutdown_replay_pool
    from tests.test_torch_pipeline import STORAGE_GATE

    tx, width, parks = HARVEST_RUNS[name]
    code = {"fork_heavy": lambda: _fork_heavy(7), "spilling": lambda: _fork_heavy(4),
            "storage_gate": lambda: bytes.fromhex(STORAGE_GATE)}[name]()
    try:
        serial = _marked(code, tx, 0, width)
        assert any(row[0] == "106" for row in serial[0])
        assert serial[1]["device_paths"] > 0
        assert all(serial[1]["parks_by_reason"].get(r, 0) > 0 for r in parks)
        assert "timeout" not in serial[1]["parks_by_reason"]
        for workers in (1, 4):
            assert _marked(code, tx, workers, width) == serial, f"workers={workers}"
    finally:
        shutdown_replay_pool()
