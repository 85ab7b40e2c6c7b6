"""Instruction profiler: wall-time per opcode via universal instruction hooks.

Reference parity: mythril/laser/plugin/plugins/instruction_profiler.py:52-115.
"""

from __future__ import annotations

import logging
import time
from collections import defaultdict
from typing import Optional, Tuple

from mythril_tpu_torch.plugins.interface import LaserPlugin, PluginBuilder

log = logging.getLogger(__name__)


class InstructionProfiler(LaserPlugin):
    def __init__(self):
        # the engine executes one instruction at a time, so a single current
        # sample suffices; post states are copies, so ids cannot pair pre/post
        self._current: Optional[Tuple[str, float]] = None
        self._sums = defaultdict(lambda: [0.0, float("inf"), 0.0, 0])

    def initialize(self, symbolic_vm) -> None:
        def pre_hook(global_state):
            op = global_state.get_current_instruction()["opcode"]
            self._current = (op, time.perf_counter())

        def post_hook(global_state):
            # a pre with no post (exception path) is simply overwritten by
            # the next pre — no leak, no mispairing
            if self._current is None:
                return
            op, t0 = self._current
            self._current = None
            dt = time.perf_counter() - t0
            rec = self._sums[op]
            rec[0] += dt
            rec[1] = min(rec[1], dt)
            rec[2] = max(rec[2], dt)
            rec[3] += 1

        def stop_hook():
            report = self.to_string()
            if report:
                log.info("Instruction profile:\n%s", report)

        symbolic_vm.register_instr_hooks("pre", None, pre_hook)
        symbolic_vm.register_instr_hooks("post", None, post_hook)
        symbolic_vm.register_laser_hooks("stop_sym_exec", stop_hook)

    def to_string(self) -> str:
        lines = []
        total = 0.0
        for op, (s, mn, mx, n) in sorted(
            self._sums.items(), key=lambda kv: -kv[1][0]
        ):
            # a pre-hook with no matching post (exception path at the very
            # end of a run) leaves n == 0: report the op without an average
            # rather than dividing by zero
            avg = s / n if n else 0.0
            lines.append(
                f"[{op:14}] {s:.6f}s total, n={n}, avg={avg:.6f}, min={mn:.6f}, max={mx:.6f}"
            )
            total += s
        lines.append(f"Total: {total:.6f}s")
        return "\n".join(lines)


class InstructionProfilerBuilder(PluginBuilder):
    name = "instruction-profiler"

    def __call__(self, *args, **kwargs) -> LaserPlugin:
        return InstructionProfiler()
