#!/usr/bin/env python3
"""Per-level cost of the known-bits kernel, one op family at a time.

    python3 scripts/torch_known_bits_probe.py               # on a CUDA card, from the repository root
    python3 scripts/torch_known_bits_probe.py --tree OLD    # the same tapes on another checkout's kernel

``--tree OLD`` imports ``mythril_tpu_torch`` (and builds its kernels) from
the checkout at OLD, for instance an earlier commit unpacked with ``git
archive`` into a directory that ``.gitignore`` lists; runs alternating
between two trees in one call (old, new, new, old) compare two kernels on
one card.

Cases, each a packed tape as ``domains.kb_inputs`` takes it:

* chains of one op family at R = 1 row, every node reading the one before
  it, so that the chain's length is its depth: ``concat512`` (64 byte
  variables joined into 512 bits, 63 CONCATs, as the recorded traffic
  builds keccak preimages), ``ite256`` (64 ITEs on distinct conditions),
  ``ult_ite256`` (64 rounds of ``v = ite(v < y, v, z)``), ``add512`` (64
  additions) and ``lshr256`` (64 right shifts by a constant); the leaves
  are variables and constants, some narrowed by an override;
* the recorded packs of ``tests/testdata/torch_tier_kernels.npz`` (the
  engine's prefilter passes under the default tiers) with the median and
  the largest node count;
* seeded tapes (``tests/_torch_tier_cases.py``) of 4096 nodes at R = 16
  and R = 64 rows.

Per case: nodes, rows, levels (the dependency levels, also for a tree
whose kernel walks the nodes in order) and the widest level;
``kernel_us``, the device time of the launch alone (CUDA events, the
stream held busy before the start event; best of 5 after a warm-up),
``us_per_level`` and ``us_per_node``;
``wrapper_us``, the whole ``known_bits`` call (mean of 20; this tree's
wrapper is given the pack's level plan, as ``run_kb`` gives it); for the
recorded packs ``run_kb_us``, the prefilter's whole pass (``run_kb``:
inputs packed and uploaded, the plan, the launch, the three downloads;
host clock, mean of 20).  The result is checked against the plain version
on the card first.  Prints the card's name and power limit, then one JSON
line per case; ``--out FILE`` also appends the lines to FILE.
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
CHAIN = 64
SLEEP_CYCLES = 1_000_000
REPS = 5

# op codes (native/bitblast.py)
CONST, VAR, ITE, ADD, LSHR, CONCAT, ULT = 0, 1, 7, 8, 21, 23, 27


class Tape:
    """A packed tape's fields under construction (``random_kb_fields``'
    layout), node by node."""

    def __init__(self, width_mask, limbs_of):
        self.rows, self.width_mask, self.limbs_of = [], width_mask, limbs_of
        self.consts, self.overrides = {}, {}

    def node(self, op, w, a0=-1, a1=-1, a2=-1, x1=0, value=None):
        self.rows.append((op, w, a0, a1, a2, x1 + w - 1, x1))
        if value is not None:
            self.consts[len(self.rows) - 1] = value
        return len(self.rows) - 1

    def narrow(self, node, known, value):
        """An override on ``node`` that pins the bits of ``known``."""
        km, kv = self.limbs_of(known)[None, :], self.limbs_of(value & known)[None, :]
        self.overrides[node] = (np.zeros(1), np.full(1, np.inf), km, kv)

    def fields(self, n_rows: int = 1) -> dict:
        cols = np.asarray(self.rows, np.int32)
        names = ("op", "w", "a0", "a1", "a2", "x0", "x1")
        f = {k: cols[:, j].copy() for j, k in enumerate(names)}
        f["wm"] = np.stack([self.width_mask(int(w)) for w in f["w"]])
        f["c_limbs"] = np.zeros_like(f["wm"])
        for node, v in self.consts.items():
            f["c_limbs"][node] = self.limbs_of(v)
        return {**f, "overrides": self.overrides, "n_rows": n_rows}


def chains(width_mask, limbs_of) -> dict:
    """{name: fields} of the single-family chains."""
    out = {}
    t = Tape(width_mask, limbs_of)
    v = [t.node(VAR, 8) for _ in range(64)]
    t.narrow(v[0], 0x0F, 0x05)
    acc = v[0]
    for i in range(1, 64):
        acc = t.node(CONCAT, 8 * (i + 1), acc, v[i])
    out["concat512"] = t.fields()

    t = Tape(width_mask, limbs_of)
    v, z = t.node(VAR, 256), t.node(CONST, 256, value=12345)
    conds = [t.node(VAR, 1) for _ in range(CHAIN)]
    t.narrow(conds[0], 1, 1)
    for c in conds:
        v = t.node(ITE, 256, c, v, z)
    out["ite256"] = t.fields()

    t = Tape(width_mask, limbs_of)
    v, y, z = t.node(CONST, 256, value=7), t.node(VAR, 256), t.node(CONST, 256, value=9)
    t.narrow(y, (1 << 256) - 1, 1 << 200)
    for _ in range(CHAIN):
        v = t.node(ITE, 256, t.node(ULT, 1, v, y), v, z)
    out["ult_ite256"] = t.fields()

    t = Tape(width_mask, limbs_of)
    v, y = t.node(VAR, 512), t.node(CONST, 512, value=(1 << 511) - 1)
    t.narrow(v, (1 << 512) - 1, 3)
    for _ in range(CHAIN):
        v = t.node(ADD, 512, v, y)
    out["add512"] = t.fields()

    t = Tape(width_mask, limbs_of)
    v, s = t.node(VAR, 256), t.node(CONST, 256, value=3)
    t.narrow(v, (1 << 128) - 1, 0xDEADBEEF)
    for _ in range(CHAIN):
        v = t.node(LSHR, 256, v, s)
    out["lshr256"] = t.fields()
    return out


def level_offsets(pack) -> np.ndarray:
    """Each dependency level's first position in the nodes ordered by level
    (a node one level above its deepest child before it), whatever kernel
    the tree has."""
    n, lv = pack.n_nodes, []
    for i in range(n):
        kids = [int(c) for c in (pack.a0[i], pack.a1[i], pack.a2[i]) if 0 <= c < i]
        lv.append(1 + max((lv[c] for c in kids), default=-1))
    return np.concatenate([[0], np.cumsum(np.bincount(lv))])


class Probe:
    def __init__(self, torch, out_path, label):
        from mythril_tpu_torch.absdomain import device
        from mythril_tpu_torch.ops import _build

        self.torch, self.out_path, self.label = torch, out_path, label
        self.device, self.build, self.lib = device, _build, _build.load()
        self.levels = hasattr(device, "level_plan")  # this tree's kernel walks by level

    def emit(self, row: dict) -> None:
        line = json.dumps({"kernel": self.label, **row})
        print(line, flush=True)
        if self.out_path:
            with open(self.out_path, "a") as f:
                f.write(line + "\n")

    def kernel_ms(self, inputs, r: int, plan) -> float:
        """Best of REPS of the launch alone."""
        torch, cuda, dev = self.torch, self.torch.cuda, self.device
        n = inputs[0].shape[0]
        km = torch.empty((n, r, 16), dtype=torch.int32, device="cuda")
        kv, refuted = torch.empty_like(km), torch.zeros(r, dtype=torch.bool, device="cuda")
        zero = torch.zeros(16, dtype=torch.int32, device="cuda")
        if self.levels:
            plan_t = torch.from_numpy(plan.packed()).cuda()
            args = dev.kb_args(*inputs, zero, plan_t, plan.n_levels, km, kv, refuted)
        else:
            args = dev.kb_args(*inputs, zero, km, kv, refuted)
        stream = cuda.current_stream().cuda_stream
        best = None
        for i in range(REPS + 1):
            cuda._sleep(SLEEP_CYCLES)
            start, end = cuda.Event(enable_timing=True), cuda.Event(enable_timing=True)
            start.record()
            self.build.check(self.lib.mk_known_bits(ctypes.byref(args), stream), "known_bits")
            end.record()
            cuda.synchronize()
            if i:
                ms = start.elapsed_time(end)
                best = ms if best is None or ms < best else best
        return best

    def wrapper_ms(self, inputs, r: int, plan, reps: int = 20) -> float:
        cuda = self.torch.cuda
        call = (lambda: self.device.known_bits(*inputs, r, plan=plan)) if self.levels else (
            lambda: self.device.known_bits(*inputs, r))
        call()
        cuda.synchronize()
        start, end = cuda.Event(enable_timing=True), cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            call()
        end.record()
        cuda.synchronize()
        return start.elapsed_time(end) / reps

    def run_kb_ms(self, pack, reps: int = 20) -> float:
        cuda = self.torch.cuda
        self.device.run_kb(pack, "cuda")
        cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            self.device.run_kb(pack, "cuda")
        cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    def time(self, part: str, name: str, pack, end_to_end: bool = False) -> bool:
        """Check one pack against the plain version, time it, emit its row."""
        from mythril_tpu_torch.absdomain import domains

        torch, r = self.torch, pack.n_rows
        inputs = domains.kb_inputs(pack, "cuda")
        plan = self.device.pack_plan(pack) if self.levels else None
        levels = level_offsets(pack)
        got = (self.device.known_bits(*inputs, r, plan=plan) if self.levels
               else self.device.known_bits(*inputs, r))
        equal = all(bool(torch.equal(g, w))
                    for g, w in zip(got, domains.eval_kb_plain(*inputs, r)))
        n = pack.n_nodes
        k_ms = self.kernel_ms(inputs, r, plan)
        row = {"part": part, "case": name, "nodes": n, "rows": r, "levels": len(levels) - 1,
               "widest_level": int(np.diff(levels).max()), "equal": equal,
               "kernel_us": k_ms * 1e3, "us_per_level": k_ms * 1e3 / (len(levels) - 1),
               "us_per_node": k_ms * 1e3 / n,
               "wrapper_us": self.wrapper_ms(inputs, r, plan) * 1e3}
        if self.levels:
            assert np.array_equal(plan.levels, levels)
            row["route"] = "shared" if self.device.in_smem(n, plan.n_levels) else "global"
        if end_to_end:
            row["run_kb_us"] = self.run_kb_ms(pack) * 1e3
        self.emit(row)
        return equal

    def run(self) -> bool:
        from mythril_tpu_torch.absdomain import tape
        from mythril_tpu_torch.absdomain.tape import _limbs_of, width_mask
        from tests import _torch_tier_cases as tier_cases
        from tests import test_torch_engine_tiers as T

        ok = True
        for name, fields in chains(width_mask, _limbs_of).items():
            ok = self.time("family", name, tier_cases.kb_pack(fields, tape)) and ok
        recs = sorted(T.load_kernels()["kb"], key=lambda rec: len(rec["op"]))
        for label, rec in (("median", recs[len(recs) // 2]), ("largest", recs[-1])):
            ok = self.time("recorded", f"{label} ({rec['run']})", T.kb_pack(rec),
                           end_to_end=True) and ok
        for seed, r in ((13, 16), (14, 64)):
            pack = tier_cases.kb_pack(tier_cases.random_kb_fields(seed, 4096, r), tape)
            ok = self.time("seeded", f"N=4096 R={r}", pack) and ok
        return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", help="import mythril_tpu_torch from this checkout")
    ap.add_argument("--label", help="the kernel's name in the output (default: the tree)")
    ap.add_argument("--out", help="also append the JSON lines to this file")
    a = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_known_bits_probe: no CUDA device is visible", file=sys.stderr)
        return 2
    tree = Path(a.tree).resolve() if a.tree else ROOT
    if not (tree / "mythril_tpu_torch").is_dir():
        print(f"torch_known_bits_probe: no mythril_tpu_torch in {tree}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import tests  # noqa: F401  the recorded packs' reader: this checkout's

    sys.path.insert(0, str(tree))  # the kernel's package: the tree's
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    p = Probe(torch, a.out, a.label or (tree.name if a.tree else "this"))
    p.emit({"part": "card", "card": card, "tree": str(tree)})
    if not p.run():
        print("torch_known_bits_probe: a kernel's result differs from its plain version",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
