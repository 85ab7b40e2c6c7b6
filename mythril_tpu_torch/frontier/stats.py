"""Process-wide frontier telemetry: where device execution stops and why.

The frontier is a fast path that degrades to the host engine by *parking*
paths (engine.py); which opcodes force the parks is exactly the data that
prioritizes widening device coverage, and how much of a run stayed
device-resident is the number that explains the measured speedup.  Counters
land in the report meta next to the solver statistics (reference parity:
engine telemetry via ExecutionInfo, mythril/analysis/report.py:319-320).

The port keeps the counters as plain attributes (it has no metrics
registry), with the JAX package's names, and adds two that the JAX package
only logs: ``replay_errors`` (a path whose event replay raised; the path is
dropped, as in the JAX package) and ``commit_errors`` (a path whose commit
raised).  A parity run requires both to stay 0.  ``count`` and the park
records hold a lock, as the JAX registry's counters do, since the harvest's
replay workers and the pipeline's feasibility pool run on threads of their
own.
"""

from __future__ import annotations

import threading
from collections import Counter

from mythril_tpu_torch.support.support_utils import Singleton

_COUNTERS = (
    "device_instructions", "device_paths", "segments", "mid_injections",
    "mid_encode_failures", "semantic_parks", "page_faults", "page_repacks",
    "replay_errors", "commit_errors",
)
# wall seconds: segment dispatch + state pull, and host-side harvest
_SECONDS = ("segment_s", "harvest_s")


class FrontierStatistics(metaclass=Singleton):
    """The frontier's counters (one instance per process)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            for name in _COUNTERS:
                setattr(self, name, 0)
            for name in _SECONDS:
                setattr(self, name, 0.0)
            self.parks_by_opcode: Counter = Counter()
            self.parks_by_reason: Counter = Counter()

    def count(self, name: str, n=1) -> None:
        """``name += n`` under the lock."""
        with self._lock:
            setattr(self, name, getattr(self, name) + n)

    def record_park(self, opcode: str) -> None:
        with self._lock:
            self.parks_by_opcode[opcode] += 1
            self.parks_by_reason["opcode"] += 1

    def record_bulk_park(self, reason: str, n: int = 1) -> None:
        if n:
            with self._lock:
                self.parks_by_reason[reason] += n

    def as_dict(self) -> dict:
        return {
            **{name: getattr(self, name) for name in _COUNTERS},
            **{name: round(getattr(self, name), 3) for name in _SECONDS},
            "parks_by_opcode": dict(self.parks_by_opcode.most_common()),
            "parks_by_reason": dict(self.parks_by_reason.most_common()),
        }
