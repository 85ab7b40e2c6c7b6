#!/usr/bin/env python3
"""Per-step cost of the DPLL kernel (the devsolver's search) on the card.

    python3 scripts/torch_dpll_probe.py               # on a CUDA card, from the repository root
    python3 scripts/torch_dpll_probe.py --tree OLD    # the same planes on another checkout's kernel

``--tree OLD`` imports ``mythril_tpu_torch`` (and builds its kernels) from
the checkout at OLD, for instance an earlier commit unpacked with ``git
archive`` into a directory that ``.gitignore`` lists; runs alternating
between two trees in one call (old, new, new, old) compare two kernels on
one card.

Planes:

* ``recorded empty``: the first DPLL plane of
  ``tests/testdata/torch_tier_kernels.npz`` ([4, 512, 3] at V = 4096, as
  every recorded plane: no clause left after the blaster, one step a row);
* ``seeded``: the four planes of ``tests/_torch_tier_cases.py``
  ``DPLL_SEEDED`` (``chip_smoke.py`` phase 2c and 9);
* ``propagation chain``: one query whose unit clause sets x2 and whose
  4093 clauses (not x_i or x_i+1) set one variable a step, [1, 4096, 3] at
  V = 4096;
* ``backtrack heavy``: one query, 20 decision variables, the last of which
  fails both ways (its two pairs of clauses imply a variable both ways), so
  the search walks the decision tree until its budget of 2048 steps runs
  out; 2000 open clauses over undecided variables keep the sweep wide.

Per plane: queries, clause slots, the real clauses (those that can be false:
no literal 1 or 2) of the longest query, the longest query's steps;
``kernel_us``, the device time of the launch alone (CUDA events, the stream
held busy before the start event; best of 5 after a warm-up) and
``us_per_step`` (over the longest query's steps); on a tree whose wrapper
takes a block size, ``kernel_us_by_threads`` at 256 and 1024 threads;
``wrapper_us``, the whole ``dpll`` call on card tensors (mean of 20, CUDA
events); ``run_device_us``, the devsolver's whole call (``run_device``: the
plane uploaded from numpy, the launch, the results downloaded; host clock,
mean of 20); the bound (``chip_smoke.bound``: the plane read and the
outputs written once, the steps times the real clauses and the bitset
words).  The result is checked against the plain version on the card
first.  Prints the card's name and power limit, then one JSON line per
plane; ``--out FILE`` also appends the lines to FILE.

``--parts`` (comma-separated, default ``planes``) adds: ``phases``, the
cycles a step of the sweep, the vote, the commit and the closing barrier
(``scripts/dpll_phase_probe.cu``: the tree's ``csrc/dpll.cuh`` search
with a clock read at each barrier, built into a library of its own);
``transfers``, ``run_device``'s copies from pinned and pageable
memory on the recorded plane; ``sass``, the kernels' SASS into
``chiprun_out/dpll_sass_<label>.txt`` and their instruction counts.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
REPS = 5
THREADS = (256, 1024)


def chain_plane(n_vars: int = 4096):
    """(lits, dec): x2 by a unit clause, then x_i -> x_i+1 up to the last
    variable, no decision."""
    from tests._torch_tier_cases import edge_plane

    clauses = [[4]] + [[2 * v + 1, 2 * (v + 1)] for v in range(2, n_vars - 1)]
    return edge_plane([(clauses, [])], 4096, n_vars)


def backtrack_plane(n_vars: int = 4096, seed: int = 7):
    """(lits, dec): 19 free decisions, then z, which fails both ways; 2000
    open clauses of three undecided variables."""
    from tests._torch_tier_cases import edge_plane

    rng = np.random.default_rng(seed)
    z, w, u = 21, 22, 23
    clauses = [[2 * z, 2 * w], [2 * z, 2 * w + 1], [2 * z + 1, 2 * u], [2 * z + 1, 2 * u + 1]]
    clauses += [[2 * int(v) for v in rng.choice(np.arange(100, n_vars), 3, replace=False)]
                for _ in range(2000)]
    return edge_plane([(clauses, list(range(2, 22)))], 4096, n_vars)


def real_clauses(lits: np.ndarray) -> np.ndarray:
    """Per query, the clauses that can be false (no literal 1 or 2)."""
    return (~((lits == 1) | (lits == 2)).any(axis=2)).sum(axis=1)


class Probe:
    def __init__(self, torch, out_path, label, smoke):
        from mythril_tpu_torch.devsolver import device
        from mythril_tpu_torch.ops import _build

        self.torch, self.out_path, self.label, self.smoke = torch, out_path, label, smoke
        self.device, self.build, self.lib = device, _build, _build.load()
        self.sized = hasattr(device, "block_threads")  # this tree's wrapper picks a block size

    def emit(self, row: dict) -> None:
        line = json.dumps({"kernel": self.label, **row})
        print(line, flush=True)
        if self.out_path:
            with open(self.out_path, "a") as f:
                f.write(line + "\n")

    def kernel_ms(self, lits, dec, n_vars: int, iters: int, threads=None) -> float:
        """Best of REPS of the launch alone."""
        torch, cuda, dev = self.torch, self.torch.cuda, self.device
        q = lits.shape[0]
        status = torch.empty(q, dtype=torch.int8, device="cuda")
        assign = torch.empty((q, n_vars), dtype=torch.int8, device="cuda")
        steps = torch.empty(q, dtype=torch.int32, device="cuda")
        extra = () if threads is None else (threads,)
        args = dev.dpll_args(lits, dec, status, assign, steps, n_vars, iters, *extra)
        stream = cuda.current_stream().cuda_stream
        best = None
        for i in range(REPS + 1):
            cuda._sleep(self.smoke.SLEEP_CYCLES)
            start, end = cuda.Event(enable_timing=True), cuda.Event(enable_timing=True)
            start.record()
            self.build.check(self.lib.mk_dpll(ctypes.byref(args), stream), "dpll")
            end.record()
            cuda.synchronize()
            if i:
                ms = start.elapsed_time(end)
                best = ms if best is None or ms < best else best
        return best

    def wrapper_ms(self, lits, dec, n_vars: int, iters: int, reps: int = 20) -> float:
        cuda = self.torch.cuda
        self.device.dpll(lits, dec, n_vars, iters)
        cuda.synchronize()
        start, end = cuda.Event(enable_timing=True), cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            self.device.dpll(lits, dec, n_vars, iters)
        end.record()
        cuda.synchronize()
        return start.elapsed_time(end) / reps

    def run_device_ms(self, plane, iters: int, reps: int = 20) -> float:
        cuda = self.torch.cuda
        self.device.run_device(plane, iters, "cuda")
        cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            self.device.run_device(plane, iters, "cuda")
        cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    def time(self, part: str, name: str, lits_np, dec_np, n_vars: int, iters: int) -> bool:
        """Check one plane against the plain version, time it, emit its row."""
        from mythril_tpu_torch.devsolver import kernel

        torch = self.torch
        lits, dec = torch.from_numpy(lits_np).cuda(), torch.from_numpy(dec_np).cuda()
        got = self.device.dpll(lits, dec, n_vars, iters)
        want = kernel.run_plain(lits, dec, n_vars, iters)
        equal = all(bool(torch.equal(g, w)) for g, w in zip(got, want))
        steps = got[2].cpu().numpy()
        longest = int(steps.argmax())
        real = real_clauses(lits_np)
        k_ms = self.kernel_ms(lits, dec, n_vars, iters)
        q, c = lits_np.shape[:2]
        n_bytes = (lits_np.size + dec_np.size) * 4 + q * n_vars + 5 * q
        words = (n_vars + 31) // 32
        b_ms, b_by = self.smoke.bound(n_bytes, 0, int((steps * (
            real * self.smoke.DPLL_CLAUSE_OPS + words * self.smoke.DPLL_WORD_OPS)).sum()))
        row = {"part": part, "case": name, "queries": q, "clause_slots": c, "n_vars": n_vars,
               "iters": iters, "real_clauses": int(real[longest]), "steps": int(steps[longest]),
               "status": got[0].cpu().tolist(), "equal": equal, "kernel_us": k_ms * 1e3,
               "us_per_step": k_ms * 1e3 / max(1, int(steps[longest])),
               "wrapper_us": self.wrapper_ms(lits, dec, n_vars, iters) * 1e3,
               "run_device_us": self.run_device_ms(kernel.Plane(lits_np, dec_np, q, n_vars),
                                                   iters) * 1e3,
               "bound_us": b_ms * 1e3, "bound_by": b_by,
               "bound_counts": "the real clauses of each query, over its own steps"}
        if self.sized:
            row["threads"] = self.device.block_threads(c)
            row["kernel_us_by_threads"] = {
                t: self.kernel_ms(lits, dec, n_vars, iters, t) * 1e3 for t in THREADS}
        self.emit(row)
        return equal

    def phases(self, name: str, lits_np, dec_np, n_vars: int, iters: int) -> None:
        """Cycles a step of each part (``scripts/dpll_phase_probe.cu``):
        thread 0's and the largest over the longest query's threads."""
        torch = self.torch
        lib = ctypes.CDLL(str(self.build.build([ROOT / "scripts" / "dpll_phase_probe.cu"],
                                               "dpll_phase_probe")))
        lits, dec = torch.from_numpy(lits_np).cuda(), torch.from_numpy(dec_np).cuda()
        q, c = lits_np.shape[:2]
        threads = self.device.block_threads(c)
        status = torch.empty(q, dtype=torch.int8, device="cuda")
        assign = torch.empty((q, n_vars), dtype=torch.int8, device="cuda")
        steps = torch.empty(q, dtype=torch.int32, device="cuda")
        out = torch.zeros((q, threads, 6), dtype=torch.int64, device="cuda")
        args = self.device.dpll_args(lits, dec, status, assign, steps, n_vars, iters)
        stream = torch.cuda.current_stream().cuda_stream
        self.build.check(lib.mk_dpll_timed(ctypes.byref(args), ctypes.c_void_p(out.data_ptr()),
                                           ctypes.c_void_p(stream)), "dpll_timed")
        torch.cuda.synchronize()
        n = steps.cpu().numpy()
        longest = int(n.argmax())
        cycles = out[longest].cpu().numpy()
        parts = cycles[:, :4] / max(1, int(n[longest]))
        names = ("sweep", "vote", "commit", "barrier")
        self.emit({"part": "phases", "case": name, "threads": threads, "steps": int(n[longest]),
                   "cycles_per_step_thread0": dict(zip(names, parts[0].tolist())),
                   "cycles_per_step_max": dict(zip(names, parts.max(axis=0).tolist())),
                   "staging_cycles": int(cycles[0, 4]), "run_cycles": int(cycles[0, 5])})

    def transfers(self, lits_np, dec_np, n_vars: int, reps: int = 20) -> None:
        """The parts of ``run_device`` on one plane, host clock with a
        synchronise, mean of ``reps``: one upload from pinned and from
        pageable memory, the outputs' allocation, one download to pinned and
        to pageable memory."""
        torch = self.torch
        q = lits_np.shape[0]
        flat = np.concatenate([lits_np.reshape(-1), dec_np.reshape(-1)])
        pinned = torch.empty(flat.size, dtype=torch.int32, pin_memory=True)
        size = q * n_vars + 8 * q
        buf = torch.empty(size, dtype=torch.int8, device="cuda")
        back = torch.empty(size, dtype=torch.int8, pin_memory=True)

        def host_us(fn) -> float:
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e6 / reps

        def up_pinned():
            pinned.numpy()[:] = flat
            pinned.to("cuda", non_blocking=True)
            torch.cuda.current_stream().synchronize()

        def down_pinned():
            back.copy_(buf, non_blocking=True)
            torch.cuda.current_stream().synchronize()

        self.emit({"part": "transfers", "queries": q, "bytes_up": int(flat.size * 4),
                   "bytes_down": int(buf.numel()),
                   "up_pinned_us": host_us(up_pinned),
                   "up_pageable_us": host_us(lambda: torch.from_numpy(np.concatenate(
                       [lits_np.reshape(-1), dec_np.reshape(-1)])).to("cuda")),
                   "outputs_us": host_us(lambda: torch.empty(size, dtype=torch.int8,
                                                             device="cuda")),
                   "down_pinned_us": host_us(down_pinned),
                   "down_pageable_us": host_us(lambda: buf.cpu())})

    def planes(self):
        """(part, name, lits, dec, n_vars, iters) of every plane."""
        from mythril_tpu_torch.devsolver import kernel
        from tests import _torch_tier_cases as tier_cases
        from tests import test_torch_engine_tiers as T

        rec = T.load_kernels()["dpll"][0]
        plane = T.dpll_plane(rec)
        yield ("recorded", f"empty ({rec['run']})", plane.lits, plane.dec, plane.n_vars,
               int(rec["max_iters"]))
        for seed, q, c, v, iters in tier_cases.DPLL_SEEDED:
            plane = tier_cases.random_cnf_plane(seed, q, c, v, kernel)
            yield ("seeded", f"seed {seed} [{q},{c},3] V={v} iters={iters}", plane.lits,
                   plane.dec, plane.n_vars, iters)
        yield ("synthetic", "propagation chain", *chain_plane(), 4096, 4096)
        yield ("synthetic", "backtrack heavy", *backtrack_plane(), 4096, 2048)

    def sass(self) -> None:
        """The DPLL kernels' SASS (``cuobjdump -sass`` of the built library)
        into chiprun_out/dpll_sass_<label>.txt; each kernel's instruction
        count by opcode."""
        import collections
        import re

        tool = Path(self.build.nvcc()).parent / "cuobjdump"
        out = subprocess.run([str(tool), "-sass", str(self.build.library_path())],
                             capture_output=True, text=True, timeout=120).stdout
        keep, counts, name = [], {}, None
        for line in out.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                name = m.group(1) if "dpll_kernel" in m.group(1) else None
            if name:
                keep.append(line)
                m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
                if m:
                    counts.setdefault(name, collections.Counter())[m.group(1).split(".")[0]] += 1
        (ROOT / "chiprun_out").mkdir(exist_ok=True)
        (ROOT / "chiprun_out" / f"dpll_sass_{self.label}.txt").write_text("\n".join(keep))
        for name, c in counts.items():
            self.emit({"part": "sass", "function": name, "instructions": sum(c.values()),
                       "by_opcode": dict(c.most_common())})

    def run(self, parts) -> bool:
        ok = True
        if "sass" in parts:
            self.sass()
        for part, name, lits, dec, n_vars, iters in self.planes():
            if "planes" in parts:
                ok = self.time(part, name, lits, dec, n_vars, iters) and ok
            if "phases" in parts:
                self.phases(name, lits, dec, n_vars, iters)
            if "transfers" in parts and part == "recorded":
                self.transfers(lits, dec, n_vars)
        return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", help="import mythril_tpu_torch from this checkout")
    ap.add_argument("--label", help="the kernel's name in the output (default: the tree)")
    ap.add_argument("--out", help="also append the JSON lines to this file")
    ap.add_argument("--parts", default="planes",
                    help="comma-separated: planes (the default), phases (cycles a step by "
                         "part, this checkout's kernel only), transfers (run_device's copies), "
                         "sass (the kernels' SASS into chiprun_out/)")
    a = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_dpll_probe: no CUDA device is visible", file=sys.stderr)
        return 2
    tree = Path(a.tree).resolve() if a.tree else ROOT
    if not (tree / "mythril_tpu_torch").is_dir():
        print(f"torch_dpll_probe: no mythril_tpu_torch in {tree}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke  # noqa: E402  the bound and the timing constants: this checkout's
    import tests  # noqa: F401  the planes' readers: this checkout's

    sys.path.insert(0, str(tree))  # the kernel's package: the tree's
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    p = Probe(torch, a.out, a.label or (tree.name if a.tree else "this"), chip_smoke)
    p.emit({"part": "card", "card": card, "tree": str(tree)})
    if not p.run(set(a.parts.split(","))):
        print("torch_dpll_probe: a kernel's result differs from its plain version",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
