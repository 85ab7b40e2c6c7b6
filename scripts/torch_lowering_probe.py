#!/usr/bin/env python3
"""Per-record cost of the lowering kernel, one op family at a time.

    python3 scripts/torch_lowering_probe.py               # on a CUDA card, from the repository root
    python3 scripts/torch_lowering_probe.py --tree OLD    # the same programs on another checkout's kernel

``--tree OLD`` imports ``mythril_tpu_torch`` (and builds its kernels) from
the checkout at OLD, for instance an earlier commit unpacked with ``git
archive`` into a directory that ``.gitignore`` lists; runs alternating
between two trees in one call compare two kernels on one card.

Each program is a chain of one op family at B = 48 candidates (the main
path's median batch), every record reading the one before it, so the
chain's length is also its depth:

* ``concat512``: a 512-bit word built from 64 byte variables, 63 CONCATs,
  as the recorded traffic builds its keccak preimages;
* ``lookup_k8`` and ``lookup_k40``: 64 selects of a base array, each at the
  index the one before returned (256-bit keys and values; 8 and 40 table
  rows, the recorded table sizes);
* ``ult_ite256``: 64 rounds of ``v = ite(v < y, v, z)`` at 256 bits;
* ``add8``, ``add256``, ``mul256``: 64 additions or multiplications;
* ``keccak512``: one keccak of a 512-bit preimage (one rate block).

Then the recorded dispatches of ``tests/testdata/torch_lowering_cases.npz``
(the probe main path's lowering calls) at the median and the largest
record count, with their own candidates, and the op mix of each one's
longest chain of dependent records (``chain``).

Per program: the records, the levels, ``kernel_us``, the device time of
the call's lowering launches alone (CUDA events, the stream held busy
before the start event; best of 5 after a warm-up), ``us_per_record``, and
``wrapper_us``, the whole ``run_lowering`` call (mean of 20).  The result
is checked against the plain version first.  Prints the card's name and
power limit, then one JSON line per program; ``--out FILE`` also appends
the lines to FILE.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
B = 48
CHAIN = 64
SLEEP_CYCLES = 1_000_000
REPS = 5


def programs(T):
    """{name: conjuncts} of the single-family chains."""
    out = {}
    bytes_ = [T.var(f"lp_b{i}", 8) for i in range(64)]
    word = T.concat(*bytes_)
    out["concat512"] = [T.eq(word, T.var("lp_w512", 512))]
    for K in (8, 40):
        arr = T.array_var(f"lp_mem{K}", 256, 256)
        v = T.var(f"lp_i{K}", 256)
        for _ in range(CHAIN):
            v = T.select(arr, v)
        out[f"lookup_k{K}"] = [T.eq(v, T.var(f"lp_o{K}", 256))]
    v, y, z = (T.var(f"lp_{n}256", 256) for n in "vyz")
    for _ in range(CHAIN):
        v = T.ite(T.ult(v, y), v, z)
    out["ult_ite256"] = [T.eq(v, T.var("lp_r256", 256))]
    for name, w, op in (("add8", 8, T.add), ("add256", 256, T.add), ("mul256", 256, T.mul)):
        v, y = T.var(f"lp_{name}_v", w), T.var(f"lp_{name}_y", w)
        for _ in range(CHAIN):
            v = op(v, y)
        out[name] = [T.eq(v, T.var(f"lp_{name}_r", w))]
    out["keccak512"] = [T.ult(T.keccak(T.var("lp_pre512", 512)), T.var("lp_k", 256))]
    return out


def longest_chain(prog) -> dict:
    """{op name: records} on the longest chain of dependent records of a
    node table (its records are in topological order)."""
    from mythril_tpu_torch.ops import lowering as low

    names = {getattr(low, n): n[4:] for n in dir(low) if n.startswith("LOP_")}
    unary = {low.LOP_NOT, low.LOP_NEG, low.LOP_EXTRACT, low.LOP_ZEXT, low.LOP_SEXT,
             low.LOP_LOOKUP, low.LOP_KECCAK}
    depth, back = {}, {}
    for r in prog.rec:
        reads = [int(r[low.R_A])]
        if r[low.R_OP] not in unary:
            reads.append(int(r[low.R_B]))
        if r[low.R_OP] == low.LOP_ITE:
            reads.append(int(r[low.R_C]))
        prev = max((x for x in reads if x in depth), key=depth.get, default=None)
        out = int(r[low.R_OUT])
        depth[out] = 1 + (depth[prev] if prev is not None else 0)
        back[out] = (prev, names[int(r[low.R_OP])])
    at, mix = max(depth, key=depth.get), {}
    while at is not None:
        at, name = back[at]
        mix[name] = mix.get(name, 0) + 1
    return mix


def assignments(T, ce, conj, keys: int):
    """B candidates, each array with every key 1..keys backed and values
    that are keys again, so a lookup chain keeps hitting."""
    import numpy as np

    rng = np.random.default_rng(7)
    out = []
    vars_ = [t for t in T.topo_order(conj) if t.op in ("var", "array_var")]
    for _ in range(B):
        asg = ce.Assignment()
        for v in vars_:
            if v.op == "array_var":
                backing = {k: int(rng.integers(1, keys + 1)) for k in range(1, keys + 1)}
                asg.arrays[v] = ce.ArrayValue(backing, default=0)
            elif rng.random() < 0.5 and v.width >= 8:
                asg.scalars[v] = int(rng.integers(1, keys + 1))
            else:
                asg.scalars[v] = T.mask(int.from_bytes(rng.bytes(80), "little"), v.width)
        out.append(asg)
    return out


class Probe:
    def __init__(self, torch, out_path, label):
        from mythril_tpu_torch.ops import _build

        self.torch, self.out_path, self.label = torch, out_path, label
        self.build, self.lib = _build, _build.load()

    def emit(self, row: dict) -> None:
        line = json.dumps({"kernel": self.label, **row})
        print(line, flush=True)
        if self.out_path:
            with open(self.out_path, "a") as f:
                f.write(line + "\n")

    def kernel_ms(self, compiled, inputs) -> float:
        """Best of REPS of the call's lowering launches alone."""
        from mythril_tpu_torch.ops import lowering

        cuda = self.torch.cuda
        pairs = []

        def launch(largs):
            stream = cuda.current_stream().cuda_stream
            cuda._sleep(SLEEP_CYCLES)
            start, end = cuda.Event(enable_timing=True), cuda.Event(enable_timing=True)
            start.record()
            self.build.check(self.lib.mk_lowering(ctypes.byref(largs), stream), "lowering")
            end.record()
            pairs.append((start, end))

        best = None
        for i in range(REPS + 1):
            pairs.clear()
            if hasattr(lowering, "run_segments"):  # one launch per level of keccak nesting
                from mythril_tpu_torch.ops import keccak_cuda

                shape = (compiled.program.rows, inputs[1].shape[0])
                arena = self.torch.empty(shape, dtype=self.torch.int32, device="cuda")
                lowering.run_segments(compiled, *inputs, launch=launch,
                                      permute=keccak_cuda.keccak_f1600, arena=arena)
            else:  # one launch per call
                lowering.run_kernel(compiled, *inputs, launch=launch)
            cuda.synchronize()
            ms = sum(a.elapsed_time(b) for a, b in pairs)
            if i:
                best = ms if best is None or ms < best else best
        return best

    def wrapper_ms(self, compiled, inputs, reps: int = 20) -> float:
        from mythril_tpu_torch.ops import lowering

        cuda = self.torch.cuda
        lowering.run_lowering(compiled, *inputs)
        cuda.synchronize()
        start, end = cuda.Event(enable_timing=True), cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            lowering.run_lowering(compiled, *inputs)
        end.record()
        cuda.synchronize()
        return start.elapsed_time(end) / reps

    def time(self, part: str, name: str, compiled, inputs, **extra) -> bool:
        """Check one call against the plain version, time it, emit its row."""
        from mythril_tpu_torch.ops import lowering

        got = lowering.run_lowering(compiled, *inputs)
        equal = bool(self.torch.equal(got, lowering.run_lowering_reference(compiled, *inputs)))
        prog = compiled.program
        n = len(prog.rec)
        k_ms = self.kernel_ms(compiled, inputs)
        self.emit({"part": part, "family": name, "B": int(inputs[1].shape[0]), "records": n,
                   "levels": getattr(prog, "n_levels", None), "rows": prog.rows,
                   "equal": equal, "kernel_us": k_ms * 1e3, "us_per_record": k_ms * 1e3 / n,
                   "wrapper_us": self.wrapper_ms(compiled, inputs) * 1e3, **extra})
        return equal

    def run(self) -> bool:
        from mythril_tpu_torch.ops import lowering
        from mythril_tpu_torch.smt import concrete_eval, terms
        from tests._torch_lowering_cases import load_recorded, recorded_inputs

        ok = True
        for name, conj in programs(terms).items():
            keys = 40 if name == "lookup_k40" else 8
            compiled = lowering.compile_conjunction(conj)
            asgs = assignments(terms, concrete_eval, conj, keys)
            inputs = lowering.pack_assignments(compiled, asgs, "cuda")
            ok = self.time("family", name, compiled, inputs) and ok
        meta, arrays, conjs = load_recorded()
        calls = sorted((len(lowering.compile_conjunction(c).program.rec), n)
                       for n, (d, c) in enumerate(zip(meta["dispatches"], conjs))
                       if not d.get("jax_error"))
        for label, (_, n) in (("median", calls[len(calls) // 2]), ("largest", calls[-1])):
            d = meta["dispatches"][n]
            compiled = lowering.compile_conjunction(conjs[n])
            ok = self.time("recorded", f"{label} #{n}", compiled,
                           recorded_inputs(arrays, n, d, "cuda"),
                           chain=longest_chain(compiled.program)) and ok
        return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", help="import mythril_tpu_torch from this checkout")
    ap.add_argument("--label", help="the kernel's name in the output (default: the tree)")
    ap.add_argument("--out", help="also append the JSON lines to this file")
    a = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_lowering_probe: no CUDA device is visible", file=sys.stderr)
        return 2
    tree = Path(a.tree).resolve() if a.tree else ROOT
    if not (tree / "mythril_tpu_torch").is_dir():
        print(f"torch_lowering_probe: no mythril_tpu_torch in {tree}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import tests  # noqa: F401  the recorded dispatches' reader: this checkout's

    sys.path.insert(0, str(tree))  # the kernel's package: the tree's
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    p = Probe(torch, a.out, a.label or (tree.name if a.tree else "this"))
    p.emit({"part": "card", "card": card, "tree": str(tree)})
    if not p.run():
        print("torch_lowering_probe: a kernel's result differs from its plain version",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
