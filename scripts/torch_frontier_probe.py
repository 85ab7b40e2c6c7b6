#!/usr/bin/env python3
"""Per-step cost of the frontier segment kernel, split into its parts.

    python3 scripts/torch_frontier_probe.py                 # on a CUDA card, from the repository root
    python3 scripts/torch_frontier_probe.py --tree OLD      # the same runs on another checkout's kernel

``--tree OLD`` imports ``mythril_tpu_torch`` (and builds its kernels) from
the checkout at OLD, for instance an earlier commit unpacked with ``git
archive`` into a directory that ``.gitignore`` lists; runs alternating
between two trees in one call compare two kernels on one card.
``--parts`` picks what runs (default all):

* ``barriers``: ``scripts/barrier_probe.cu`` (built here into a library of
  its own) alone at the segment's launch shapes: ``__syncthreads()``,
  ``cluster.sync()`` of 1-8 blocks (also with the flag read through
  distributed shared memory) and ``grid.sync()`` of 1, 2, 8 and 128 blocks
  (also with the flag read through L2); microseconds per barrier.  Not
  with ``--tree``.
* ``probe``: a code of straight-line PUSH1/POP pairs (no events, forks or
  folds) runs ``caps.K`` steps (384 up to B=1024, fewer above) at B in
  {64, 256, 1024, 4096, 16384} with one live path and with every path live;
  the arena is sized so that no run stops for room.  With one live path the
  time per step is the loop's fixed cost plus one path's dependent chain;
  with all live it adds the per-path work.  Each run is checked: every live
  path ran every step, and at B=64 the outputs equal the plain version's.
* ``forks``: a code of rounds ``PUSH1 0; CALLDATALOAD; PUSH1 d; JUMPI;
  JUMPDEST`` (``tests/_torch_frontier_cases.py``'s ``_fork_rounds``: a
  symbolic JUMPI to the next instruction) from one live path at
  B in {64, 256, 1024, 4096}: every live path forks in every round until the
  slots are full, then every fork pends.  The cost of one fork step is the
  difference of two runs whose step limits end just after and just before
  it: the first round's (one fork) and the last granted round's (B/2
  forks).  Checked against the plain version at B=64 and 256.
* ``dispatches``: recorded dispatches of
  ``tests/testdata/torch_frontier_dispatches.npz`` (the wide one, bectoken
  #2, etherstore #0, largecode #2), each checked against its JAX digests.

Kernel launches alone are timed with CUDA events (the stream held busy
before the start event); a run's time is the best of 5 after a warm-up.
Prints the card's name and power limit, then one JSON line per
measurement; ``--out FILE`` also appends the lines to FILE.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
STEPS = {64: 384, 256: 384, 1024: 384, 4096: 96, 16384: 24}  # B -> caps.K
FORK_WIDTHS = (64, 256, 1024, 4096)
DISPATCHES = (("wide_contract_10", 0), ("bectoken_like", 2), ("etherstore_like", 0),
              ("largecode_contract_2400", 2))
SLEEP_CYCLES = 1_000_000
REPS = 5


class Probe:
    def __init__(self, torch, out_path, label):
        self.torch, self.out_path, self.label = torch, out_path, label
        from mythril_tpu_torch.ops import _build

        self.build = _build
        self.lib = _build.load()

    def emit(self, row: dict) -> None:
        line = json.dumps({"kernel": self.label, **row})
        print(line, flush=True)
        if self.out_path:
            with open(self.out_path, "a") as f:
                f.write(line + "\n")

    def time_ms(self, launch) -> float:
        """Best of REPS of one launch, after a warm-up."""
        cuda = self.torch.cuda
        launch()
        cuda.synchronize()
        best = None
        for _ in range(REPS):
            cuda._sleep(SLEEP_CYCLES)
            start, end = cuda.Event(enable_timing=True), cuda.Event(enable_timing=True)
            start.record()
            launch()
            end.record()
            cuda.synchronize()
            ms = start.elapsed_time(end)
            best = ms if best is None or ms < best else best
        return best

    def segment_ms(self, inputs, caps) -> float:
        from mythril_tpu_torch.frontier import step as fstep

        stream = self.torch.cuda.current_stream().cuda_stream
        # fresh copies of the inputs before each timed launch, outside the events
        cuda, best = self.torch.cuda, None
        for i in range(REPS + 1):
            args, _outs, keep = fstep.kernel_args(*inputs, caps)
            cuda.synchronize()
            cuda._sleep(SLEEP_CYCLES)
            start, end = cuda.Event(enable_timing=True), cuda.Event(enable_timing=True)
            start.record()
            self.build.check(self.lib.mk_frontier_segment(ctypes.byref(args), stream),
                             "frontier_segment")
            end.record()
            cuda.synchronize()
            if i:
                ms = start.elapsed_time(end)
                best = ms if best is None or ms < best else best
            del args, keep
        return best

    # -- barriers ------------------------------------------------------------

    def barriers(self) -> None:
        torch = self.torch
        fn = ctypes.CDLL(str(self.build.build([ROOT / "scripts" / "barrier_probe.cu"],
                                              "barrier_probe"))).mk_barrier_probe
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        sink = torch.zeros(1, dtype=torch.int32, device="cuda")
        blk = torch.zeros(256, dtype=torch.int32, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        iters = 4000
        shapes = [("syncthreads", 0, 1)]
        shapes += [("cluster.sync", 2, n) for n in range(1, 9)]
        shapes += [("cluster.sync+dsmem flags", 3, n) for n in (1, 2, 4, 8)]
        shapes += [("grid.sync", 1, n) for n in (1, 2, 8, 128)]
        shapes += [("grid.sync+L2 flags", 4, n) for n in (1, 2, 8, 128)]
        for name, mode, blocks in shapes:
            run = lambda: self.build.check(  # noqa: E731
                fn(mode, blocks, iters, sink.data_ptr(), blk.data_ptr(), stream), name)
            ms = self.time_ms(run)
            self.emit({"part": "barriers", "barrier": name, "blocks": blocks,
                       "us_per_barrier": ms * 1e3 / iters})

    # -- synthetic programs ----------------------------------------------------

    def inputs(self, prog, caps, live: int, k_limit: int):
        import numpy as np

        from mythril_tpu_torch.frontier import interop
        from mythril_tpu_torch.frontier import ops as O
        from mythril_tpu_torch.frontier.arena import HostArena
        from mythril_tpu_torch.frontier.code import CodeTables, stacked_device_tables
        from mythril_tpu_torch.frontier.state import empty_state

        arena = HostArena(caps.ARENA)
        row_zero, row_one = arena.const_row(0), arena.const_row(1)
        tables = CodeTables(prog, arena)
        bucket = (1,) + tables.size_bucket()
        code = stacked_device_tables([tables], bucket)
        st = empty_state(caps, bucket[3])
        st.seed[:live], st.halt[:live] = 0, O.H_RUNNING
        return interop.inputs_from_numpy(
            st, arena.device_arrays(), arena.length, np.zeros((3, 1, bucket[1]), bool), code,
            [1024, 0, row_zero, row_one, 0, k_limit], "cuda")

    def same_as_plain(self, inputs, caps) -> bool:
        import numpy as np

        from mythril_tpu_torch.frontier import interop
        from mythril_tpu_torch.frontier import step as fstep

        got = interop.outputs_to_numpy(fstep.segment_cuda(*inputs, caps))
        want = interop.outputs_to_numpy(fstep.segment_torch(*inputs, caps))
        return all(np.array_equal(got[0][n], want[0][n]) for n in want[0]) and \
            all(np.array_equal(got[1][n], want[1][n]) for n in want[1]) and \
            got[2:5] == want[2:5] and np.array_equal(got[5], want[5])

    def probe(self) -> bool:
        from mythril_tpu_torch.frontier import step as fstep
        from mythril_tpu_torch.frontier.state import Caps
        from tests._torch_frontier_cases import _program

        for B, K in STEPS.items():
            prog = _program(["PUSH1", "POP"] * K + ["STOP"], arg=0)
            caps = Caps(B=B, K=K, ARENA=4 * B * K + 1024)  # room for every step
            for live in (1, B):
                inputs = self.inputs(prog, caps, live, K)
                out = fstep.segment_cuda(*inputs, caps)
                ok = int(out[3]) == live * K and bool((out[0].pc[:live] == K).all())
                if B == 64:
                    ok = ok and self.same_as_plain(inputs, caps)
                ms = self.segment_ms(inputs, caps)
                self.emit({"part": "probe", "B": B, "live": live, "steps": K, "kernel_ms": ms,
                           "us_per_step": ms * 1e3 / K, "checked": ok})
                if not ok:
                    return False
        return True

    def forks(self) -> bool:
        from mythril_tpu_torch.frontier import step as fstep
        from mythril_tpu_torch.frontier.state import Caps
        from tests._torch_frontier_cases import _fork_rounds

        for B in FORK_WIDTHS:
            m = B.bit_length() - 1  # granted rounds: 1, 2, ..., B/2 forks
            prog = _fork_rounds(m + 2)
            caps = Caps(B=B, K=384, ARENA=4 * B * 5 * (m + 2) + 1024)
            steps_all = 5 * m + 4  # the (m+1)th JUMPI pends every path
            full = self.inputs(prog, caps, 1, caps.K)
            out = fstep.segment_cuda(*full, caps)
            forks = int((out[0].seed >= 0).sum()) - 1
            ok = forks == B - 1 and int(out[4]) == B
            if B <= 256:
                ok = ok and self.same_as_plain(full, caps)
            row = {"part": "forks", "B": B, "steps": steps_all, "forks": forks,
                   "kernel_ms": self.segment_ms(full, caps), "checked": ok}
            row["us_per_step"] = row["kernel_ms"] * 1e3 / steps_all
            # one fork step: the step limit just after it minus just before it
            for name, r in (("first", 0), ("last", m - 1)):
                after = self.segment_ms(self.inputs(prog, caps, 1, 5 * r + 4), caps)
                before = self.segment_ms(self.inputs(prog, caps, 1, 5 * r + 3), caps)
                row[f"{name}_fork_step_us"] = (after - before) * 1e3
                row[f"{name}_forks"] = 1 << r
            self.emit(row)
            if not ok:
                return False
        return True

    def dispatches(self) -> bool:
        from mythril_tpu_torch.frontier import interop
        from mythril_tpu_torch.frontier import step as fstep
        from tests.test_torch_frontier_fixture import iter_dispatches, mismatches

        ok = True
        for name, i, d in iter_dispatches(keep=lambda n, i, data: (n, i) in DISPATCHES):
            inputs = interop.inputs_from_numpy(d["state"], d["arena"], d["arena_len"],
                                               d["visited"], d["code"], d["cfg"], "cuda")
            out = fstep.segment_cuda(*inputs, d["caps"])
            miss = mismatches(interop.output_digests(out), d["digests"])
            ms = self.segment_ms(inputs, d["caps"])
            self.emit({"part": "dispatches", "dispatch": f"{name}#{i}", "B": d["caps"].B,
                       "n_exec": int(out[3]), "kernel_ms": ms, "mismatches": len(miss)})
            ok = ok and not miss
        return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", help="import mythril_tpu_torch from this checkout")
    ap.add_argument("--parts", default="barriers,probe,forks,dispatches")
    ap.add_argument("--label", help="the kernel's name in the output (default: the tree)")
    ap.add_argument("--out", help="also append the JSON lines to this file")
    a = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_frontier_probe: no CUDA device is visible", file=sys.stderr)
        return 2
    tree = Path(a.tree).resolve() if a.tree else ROOT
    if not (tree / "mythril_tpu_torch").is_dir():
        print(f"torch_frontier_probe: no mythril_tpu_torch in {tree}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import tests  # noqa: F401  the programs and the fixture's reader: this checkout's

    sys.path.insert(0, str(tree))  # the kernel's package: the tree's
    parts = a.parts.split(",")
    if a.tree and "barriers" in parts:
        parts.remove("barriers")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    p = Probe(torch, a.out, a.label or (tree.name if a.tree else "this"))
    p.emit({"part": "card", "card": card, "tree": str(tree)})
    ok = True
    for part in parts:
        ok = getattr(p, part)() is not False and ok
    if not ok:
        print("torch_frontier_probe: a kernel's result is wrong", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
