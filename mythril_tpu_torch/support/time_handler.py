"""Wall-clock deadline shared by engine and solver.

Reference parity: mythril/laser/ethereum/time_handler.py:5-18 — the remaining
execution time clamps per-query solver timeouts (mythril/support/model.py:27-30).
"""

from __future__ import annotations

import time
from typing import Optional

from mythril_tpu_torch.support.support_utils import Singleton


class TimeHandler(metaclass=Singleton):
    def __init__(self):
        self._start_time: Optional[float] = None
        self._execution_time: Optional[float] = None

    def start_execution(self, execution_time_seconds: float) -> None:
        self._start_time = time.time()
        self._execution_time = execution_time_seconds

    def time_remaining(self) -> float:
        """Seconds left; very large if never started."""
        if self._start_time is None:
            return 10**9
        return self._execution_time - (time.time() - self._start_time)


time_handler = TimeHandler()
