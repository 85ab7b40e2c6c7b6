"""Process-wide frontier telemetry: where device execution stops and why.

The frontier is a fast path that degrades to the host engine by *parking*
paths (engine.py); which opcodes force the parks is exactly the data that
prioritizes widening device coverage, and how much of a run stayed
device-resident is the number that explains the measured speedup.  Counters
land in the report meta next to the solver statistics (reference parity:
engine telemetry via ExecutionInfo, mythril/analysis/report.py:319-320).

Since the observability subsystem landed this class is a thin facade:
every attribute is a property backed by a named metric in
``mythril_tpu_torch.observability.metrics`` (prefix ``frontier.``), so the
``stats.segments += 1`` call sites and the ``as_dict()`` report shape
are unchanged while the same numbers flow into ``--metrics-out`` /
``meta.observability`` snapshots.

The port's copy of ``mythril_tpu/frontier/stats.py`` adds two counters that
the JAX package only logs: ``replay_errors`` (a path whose event replay
raised; the path is dropped, as in the JAX package) and ``commit_errors``
(a path whose commit raised).  A parity run requires both to stay 0.
``as_dict()`` is the JAX package's dict, byte for byte, with the two
appended after the JAX keys.  ``count(name, n)`` is the thread-safe
``name += n`` (one registry increment) that the harvest's replay workers
and the feasibility pool use.
"""

from __future__ import annotations

from mythril_tpu_torch.observability.metrics import get_registry
from mythril_tpu_torch.support.support_utils import Singleton

_PREFIX = "frontier."


def _counter_prop(attr: str, doc: str = ""):
    name = _PREFIX + attr

    def fget(self):
        return get_registry().counter(name).value

    def fset(self, v):
        get_registry().counter(name).set(v)

    return property(fget, fset, doc=doc)


class FrontierStatistics(metaclass=Singleton):
    """Facade over the ``frontier.*`` metrics in the global registry."""

    device_instructions = _counter_prop(
        "device_instructions", "instructions executed on device")
    device_paths = _counter_prop(
        "device_paths", "paths that ran (fully or partly) on device")
    segments = _counter_prop("segments", "device segment dispatches")
    segment_s = _counter_prop(
        "segment_s", "wall time in segment dispatch + state pull")
    harvest_s = _counter_prop("harvest_s", "wall time in host-side harvest")
    mesh_devices = _counter_prop(
        "mesh_devices", ">0: segments ran path-sharded over a mesh")
    mid_injections = _counter_prop(
        "mid_injections", "mid-frame states re-entered on device")
    mid_encode_failures = _counter_prop(
        "mid_encode_failures", "mid-frame seeds bounced at encoding")
    semantic_parks = _counter_prop(
        "semantic_parks", "paths pinned host-side until stepped past")
    page_faults = _counter_prop(
        "page_faults", "paths that jumped off their code's resident window")
    page_repacks = _counter_prop(
        "page_repacks", "sync-point window moves folded into fresh tables")
    replay_errors = _counter_prop(
        "replay_errors", "paths whose event replay raised (dropped)")
    commit_errors = _counter_prop(
        "commit_errors", "paths whose commit raised")

    def __init__(self) -> None:
        self._materialize()

    @property
    def parks_by_opcode(self):
        """opcode name -> paths parked on it"""
        return get_registry().labeled_counter(_PREFIX + "parks_by_opcode")

    @property
    def parks_by_reason(self):
        """timeout/arena/narrow/batch-full"""
        return get_registry().labeled_counter(_PREFIX + "parks_by_reason")

    @property
    def microbench(self) -> dict:
        # device-only efficiency numbers (engine._run_microbench): one
        # segment's compute time (CUDA events on the card), beside the
        # dispatch-plus-readback wall
        return get_registry().gauge(_PREFIX + "microbench", default={}).value

    @microbench.setter
    def microbench(self, v: dict) -> None:
        get_registry().gauge(_PREFIX + "microbench", default={}).set(v)

    def count(self, attr: str, n=1) -> None:
        """Thread-safe ``attr += n`` (one registry increment)."""
        get_registry().counter(_PREFIX + attr,
                               initial=0.0 if attr.endswith("_s") else 0).inc(n)

    def _materialize(self) -> None:
        """Force-create the backing metrics so snapshots always carry the
        full frontier block even before the first increment."""
        reg = get_registry()
        for attr in (
            "device_instructions", "device_paths", "segments",
            "mesh_devices", "mid_injections", "mid_encode_failures",
            "semantic_parks", "page_faults", "page_repacks",
            "replay_errors", "commit_errors",
        ):
            reg.counter(_PREFIX + attr)
        # float-typed wall-time accumulators (report emits 0.0, not 0)
        reg.counter(_PREFIX + "segment_s", initial=0.0)
        reg.counter(_PREFIX + "harvest_s", initial=0.0)
        # the harvest_wall_s aggregate split per phase (harvest.py), plus
        # the background floored-bucket compile — force-created so every
        # snapshot carries the full attribution block
        for phase in ("ingest", "solver", "replay", "commit"):
            reg.histogram(_PREFIX + "harvest.%s_s" % phase)
        reg.histogram(_PREFIX + "bucket_compile_s")
        reg.labeled_counter(_PREFIX + "parks_by_opcode")
        reg.labeled_counter(_PREFIX + "parks_by_reason")
        reg.gauge(_PREFIX + "microbench", default={})

    def reset(self) -> None:
        """Zero the frontier-scoped metrics.

        Note this deliberately does NOT touch the persistent-scope
        verdict metrics (``frontier.slow_code_verdicts`` etc.) that
        mirror engine.py's process-lifetime slow-segment bookkeeping.
        """
        get_registry().reset(prefix=_PREFIX)

    def record_park(self, opcode: str) -> None:
        self.parks_by_opcode[opcode] += 1
        self.parks_by_reason["opcode"] += 1

    def record_bulk_park(self, reason: str, n: int = 1) -> None:
        if n:
            self.parks_by_reason[reason] += n

    def as_dict(self) -> dict:
        return {
            "device_instructions": self.device_instructions,
            "device_paths": self.device_paths,
            "segments": self.segments,
            "mesh_devices": self.mesh_devices,
            "segment_s": round(self.segment_s, 3),
            "harvest_s": round(self.harvest_s, 3),
            "mid_injections": self.mid_injections,
            "mid_encode_failures": self.mid_encode_failures,
            "semantic_parks": self.semantic_parks,
            # page_{faults,repacks} intentionally absent: as_dict is the
            # seed-compatible facade shape (pinned byte-for-byte by
            # tests/observability/test_facades.py); paging telemetry lives
            # in the registry snapshot / meta.frontier instead
            "parks_by_opcode": dict(self.parks_by_opcode.most_common()),
            "parks_by_reason": dict(self.parks_by_reason.most_common()),
            **({"microbench": self.microbench} if self.microbench else {}),
            "replay_errors": self.replay_errors,
            "commit_errors": self.commit_errors,
        }
