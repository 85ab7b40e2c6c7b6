#!/usr/bin/env python3
"""Per-step cost of the port's tape_vm kernel on synthetic tapes, on one
NVIDIA card.

    python3 scripts/torch_tape_probe.py        # from the repository root

Each tape is ``STEPS`` steps of one op, or a cycle of several, on 256-bit
words, with operands from the two previous steps (slots) or a leaf, and
SELECTs against tables of K=24 rows (the large profile's); it runs
at B=64 and B=8192 (large profile), and the device time of its launch alone
(CUDA events, as ``chip_smoke.py`` times it) is printed per launch and per
step, beside a one-step tape (the launch's own cost).  Also printed: the
kernel's SASS size and its local-memory and branch instructions
(``cuobjdump -sass``).  Parity with the plain version is checked on every
tape at B=64.  Imports nothing of JAX.
"""

from __future__ import annotations

import collections
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

STEPS = 256
V, A, K, R = 8, 1, 24, 1

TAPES = {
    "one_step": ["ADD"],
    "add_slot": ["ADD"] * STEPS,
    "add_leaf": ["ADD_LEAF"] * STEPS,
    "xor_slot": ["XOR"] * STEPS,
    "mul_slot": ["MUL"] * STEPS,
    "shl_slot": ["SHL"] * STEPS,
    "ite_slot": ["ITE"] * STEPS,
    "select": ["SELECT"] * STEPS,
    "mix_cheap": ["ADD", "XOR", "OR", "AND", "SUB", "EQ", "ULT", "ITE"] * (STEPS // 8),
    "mix_all": ["ADD", "XOR", "MUL", "SHL", "EQ", "ITE", "ULT", "OR", "SUB", "LSHR", "AND",
                "ASHR", "UDIV", "UREM", "SDIV", "SREM"] * (STEPS // 16),
}


def build_tape(names, T):
    from mythril_tpu_torch.ops import bitvec as bv
    from mythril_tpu_torch.ops import tape_vm

    n = len(names)
    tape = {k: np.zeros(T, np.int32) for k in ("op", "a0", "a1", "a2", "aux")}
    tape["wmask"] = np.tile(bv.from_ints_np((1 << 256) - 1, 256), (T, 1)).astype(np.uint32)
    for t, name in enumerate(names):
        prev = V + t - 1 if t >= 1 else 0
        prev2 = V + t - 2 if t >= 2 else 1
        leaf = name.endswith("_LEAF")
        tape["op"][t] = getattr(tape_vm, "OP_" + name.replace("_LEAF", ""))
        tape["a0"][t] = prev
        tape["a1"][t] = 2 if leaf or name in ("SHL", "LSHR", "ASHR") else prev2
        tape["a2"][t] = prev2
    tape["root_rows"] = np.array([V + n - 1], np.int32)
    tape["root_valid"] = np.ones(R, bool)
    return tape, n


def args_for(tape, B, dev, seed):
    import torch

    rng = np.random.default_rng(seed)
    leaf = rng.integers(0, 1 << 16, (B, V, 16))
    leaf[:, 2] = 0
    leaf[:, 2, 0] = 5  # a small shift amount / addend
    # array tables of K small keys, two thirds valid, values small keys too,
    # so that a chain of SELECTs keeps hitting
    idx = np.zeros((B, A, K, 16), np.int64)
    idx[..., 0] = np.arange(K)
    val = np.zeros((B, A, K, 16), np.int64)
    val[..., 0] = rng.integers(0, K, (B, A, K))
    host = (leaf, idx, val, rng.random((B, A, K)) < 0.67, np.zeros((B, A, 16)),
            tape["op"], tape["a0"], tape["a1"], tape["a2"], tape["aux"], tape["wmask"],
            tape["root_rows"], tape["root_valid"])
    return tuple(torch.from_numpy(np.ascontiguousarray(
        x, dtype=np.uint8 if i in (3, 12) else np.int32)).to(dev) for i, x in enumerate(host))


def sass_report():
    from mythril_tpu_torch.ops import _build

    tool = Path(_build.nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(_build.library_path())],
                         capture_output=True, text=True, timeout=120).stdout
    ops, inside = collections.Counter(), False
    for line in out.splitlines():
        if "Function :" in line:
            inside = "tape_vm_kernelILi32" in line  # the 32-candidate block's instance
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if m and inside:
            ops[m.group(1)] += 1
    total = sum(ops.values())
    print(f"tape_vm_kernel SASS: {total} instructions ({total * 16} bytes); "
          f"LDL {ops['LDL']}, STL {ops['STL']}, BRA {ops['BRA']}, BRX {ops['BRX']}, "
          f"CALL {ops['CALL']}, IMAD {ops['IMAD']}, LOP3 {ops['LOP3']}")


def main() -> int:
    import torch

    import chip_smoke
    from mythril_tpu_torch.ops import _build, keccak_cuda, tape_vm

    if not torch.cuda.is_available():
        print("torch_tape_probe: no CUDA device is visible", file=sys.stderr)
        return 2
    print(chip_smoke.card_line())
    _build.build()
    lib = _build.load()
    sass_report()
    T = tape_vm._PROFILES[-1][1]
    import ctypes

    for B in (64, 8192):
        for name, ops in TAPES.items():
            tape, n = build_tape(ops, T)
            plan = tape_vm.TapePlan(tape, n, V, T, A, K, R)
            a = args_for(tape, B, "cuda", B)
            if B == 64:
                got = tape_vm.run_tape(*a, T=T, V=V, A=A, K=K, R=R, n_steps=n, plan=plan)
                want = tape_vm.run_tape_reference(*a, T=T, V=V, A=A, K=K, R=R, n_steps=n)
                if not torch.equal(got, want):
                    print(f"torch_tape_probe: {name} differs from the plain version", file=sys.stderr)
                    return 1
            timer = chip_smoke.LaunchTimer(torch)

            def segment(targs):
                stream = torch.cuda.current_stream().cuda_stream
                timer(lambda: _build.check(lib.mk_tape_vm_segment(ctypes.byref(targs), stream),
                                           "tape_vm"))

            reps = 20
            for _ in range(reps):
                tape_vm.run_segments(*a, T=T, V=V, A=A, K=K, R=R, plan=plan, segment=segment,
                                     permute=keccak_cuda.keccak_f1600)
            ms = timer.total_ms() / reps
            print(f"B={B:5d} {name:10s} steps={n:3d} slots={plan.S}: {ms:.5f} ms per launch, "
                  f"{ms * 1e3 / n:.4f} us per step")
    return 0


if __name__ == "__main__":
    sys.exit(main())
