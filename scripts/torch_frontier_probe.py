#!/usr/bin/env python3
"""Per-step cost of the frontier segment kernel, fixed and per path.

    python3 scripts/torch_frontier_probe.py        # on a CUDA card, from the repository root

A synthetic code of straight-line PUSH1/POP pairs (no events, no forks, no
folds) runs for ``caps.K`` steps (384 up to B=1024, fewer above) at batch
widths B in {64, 256, 1024, 4096, 16384} with one live path and with every
path live; the arena is sized so that no run stops for room.  The kernel's
launch alone is timed with CUDA events (best of 5, after a warm-up) and
divided by the steps: with one live path the time is the loop's fixed
cost per step (the grid barriers, the flag scan, one path's dependent
chain); with all live it adds the per-path work.  Every run is checked:
each live path executed every step, and at B=64 the outputs equal the
plain version's.  Prints one JSON line per run and the card's name and
power limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from collections import namedtuple
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
STEPS = {64: 384, 256: 384, 1024: 384, 4096: 96, 16384: 24}  # B -> caps.K


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_frontier_probe: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from mythril_tpu_torch.frontier import interop
    from mythril_tpu_torch.frontier import ops as O
    from mythril_tpu_torch.frontier import step as fstep
    from mythril_tpu_torch.frontier.arena import HostArena
    from mythril_tpu_torch.frontier.code import CodeTables, stacked_device_tables
    from mythril_tpu_torch.frontier.state import Caps, empty_state
    from mythril_tpu_torch.ops import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    Ins = namedtuple("Ins", "opcode address arg_int")
    lib = _build.load()
    for B, K in STEPS.items():
        program = [Ins("PUSH1" if i % 2 == 0 else "POP", 2 * i, 0) for i in range(2 * K)]
        program.append(Ins("STOP", 4 * K, None))
        caps = Caps(B=B, K=K, ARENA=4 * B * K + 1024)  # room for every step
        arena = HostArena(caps.ARENA)
        row_zero, row_one = arena.const_row(0), arena.const_row(1)
        tables = CodeTables(program, arena)
        bucket = (1,) + tables.size_bucket()
        code = stacked_device_tables([tables], bucket)
        for live in (1, B):
            st = empty_state(caps, bucket[3])
            st.seed[:live], st.halt[:live] = 0, O.H_RUNNING
            inputs = interop.inputs_from_numpy(
                st, arena.device_arrays(), arena.length, np.zeros((3, 1, bucket[1]), bool), code,
                [1024, 0, row_zero, row_one, 0, K], "cuda")
            out = fstep.segment_cuda(*inputs, caps)
            ok = int(out[3]) == live * K and bool((out[0].pc[:live] == K).all())
            if B == 64:
                want = interop.outputs_to_numpy(fstep.segment_torch(*inputs, caps))
                got = interop.outputs_to_numpy(out)
                ok = ok and all(np.array_equal(got[0][n], want[0][n]) for n in want[0]) and \
                    all(np.array_equal(got[1][n], want[1][n]) for n in want[1]) and \
                    got[2:5] == want[2:5]
            best, stream = None, torch.cuda.current_stream().cuda_stream
            for _ in range(6):
                args, _outs, _keep = fstep.kernel_args(*inputs, caps)
                torch.cuda._sleep(1_000_000)
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                _build.check(lib.mk_frontier_segment(ctypes.byref(args), stream), "frontier_segment")
                end.record()
                torch.cuda.synchronize()
                ms = start.elapsed_time(end)
                best = ms if best is None or ms < best else best
            print(json.dumps({"B": B, "live": live, "steps": K, "kernel_ms": best,
                              "us_per_step": best * 1e3 / K, "blocks": (B + 127) // 128,
                              "checked": ok, "card": card}), flush=True)
            if not ok:
                print("torch_frontier_probe: the kernel's result is wrong", file=sys.stderr)
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
