#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's solver probe on one NVIDIA card, end to end.

    python3 chip_smoke.py          # from the repository root; one CUDA card, nvcc

Phases, in order; any failure exits nonzero and prints no result:

1. the card (``nvidia-smi`` name and power limit) and torch's CUDA version;
2. the kernel build from ``mythril_tpu_torch/csrc`` (``ops/_build.py``), timed,
   with ptxas's register and spill report, and the LOP3 and SHF instructions
   per keccak round in the SASS (``cuobjdump -sass``);
3. keccak: both layouts of the ``keccak_f1600`` kernel (thread and warp per
   state) against ``keccak_f1600_reference``, both on the card, at N in
   {1, 3, 64, 130, 4096, 65536} random states, bit-equal; then ``keccak256``
   of known vectors against the host ``keccak256_py``;
4. tape: ``run_tape`` (the ``tape_vm`` kernel) against ``run_tape_reference``,
   both on the card, bit-equal in truth and in every register: one tape per
   op family (all 20) at both profiles and both batch buckets, one batch of
   8192 on the large profile, and the slot cases of
   ``tests/_torch_tape_cases.py`` (more than 200 slots, values spilled across
   both keccak steps, roots on leaves and roots final early) at both buckets;
5. the main path: the recorded probe traffic of
   ``tests/testdata/torch_probe_queries.json`` (JAX term dumps, loaded with
   ``from_jax_dump``) replayed through ``check_satisfiable_batch`` and
   ``solve_conjunction`` on the card with ``probe_backend="device"``; the
   kernels' launch counts are zeroed just before and read just after, and the
   keep/prune rule against the stored JAX verdicts must show 0 disagreements;
   then every kernel call the main path made is replayed and timed with
   CUDA events: the kernel's launches alone (``ms``), the whole wrapper call
   (``wrapper_ms``) and its plain version, beside the call's bound; keccak in
   both layouts at every N of phase 3, for the layout crossover; the main
   path replayed once more under ``torch.profiler`` for the card's idle share;
6. one ``{"kernels": [...]}`` line, and as the last line
   ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import collections
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / "tests" / "testdata" / "torch_probe_queries.json"

# H100 SXM peaks at its 1.98 GHz boost clock (NVIDIA data sheet: 132 SMs,
# 3.35 TB/s of HBM3).  Integer instructions, the type both kernels run on:
# - ALU_OPS_PER_S: LOP3 (any three-input logic) and shifts, funnel shifts
#   included, issue only on the integer ALU pipe, 16 lanes per scheduler:
#   64 results per SM per clock (CUDA C++ Programming Guide, arithmetic
#   instruction throughput, compute capability 9.0);
# - ISSUE_OPS_PER_S: adds, multiplies and compares may also go to the FMA
#   pipe as IMAD forms, so for them only the issue rate binds: one warp
#   instruction per scheduler per clock, 4 x 32 per SM per clock.
MEM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 132 * 64 * 1.98e9
ISSUE_OPS_PER_S = 132 * 128 * 1.98e9

# 32-bit integer instructions (all LOP3 or funnel shifts) per keccak-f[1600]
# of one state, per round: theta 80 (column parity C[x], five lanes, 2 LOP3
# per half: 20; rot(C[x+1], 1): 10 shifts; a ^= C[x-1] ^ rot(C[x+1], 1) as
# one LOP3 per half: 50), rho+pi 48 (two funnel shifts per rotated lane, 24
# lanes), chi 50 (one LOP3 per half), iota 2 -> 180; 24 rounds.  Packing the
# 16-bit limbs into lanes and back is layout, not counted.
KECCAK_OPS = 24 * 180

# 32-bit integer instructions one candidate spends on one tape step of each
# op code (csrc/bitvec.cuh on four 64-bit words), before the 8 of the width
# mask.  Division and exponentiation depend on the data: per dividend bit
# (UDIV..SREM) or per exponent multiply (EXP), counted from this run's values.
# A keccak step's permutation counts at the ALU rate, the rest at the issue
# rate (see tape_work).
STEP_OPS = {
    "ADD": 16, "SUB": 16, "MUL": 80, "AND": 8, "OR": 8, "XOR": 8,
    "SHL": 24, "LSHR": 24, "ASHR": 32, "EQ": 8, "ULT": 8, "ITE": 10,
    "KECCAK32": 60, "KECCAK64": 100,
}

# Cycles of torch.cuda._sleep queued before a timed launch (about 0.5 ms),
# so the start event fires after the host has enqueued the launch.
SLEEP_CYCLES = 1_000_000
KECCAK_NS = (1, 3, 64, 130, 4096, 65536)
DIV_BIT_OPS = 40
EXP_MUL_OPS = 80
SELECT_ROW_OPS = 10


class SmokeFailure(Exception):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def phase(name: str) -> float:
    print(f"== {name}", flush=True)
    return time.perf_counter()


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` back-to-back runs, by CUDA
    events: the wrapper's host work included."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class LaunchTimer:
    """Device time of single kernel launches: a CUDA event pair right around
    each launch, with the stream held busy (``torch.cuda._sleep``) before the
    start event so that the host's enqueue of the launch stays outside the
    pair."""

    def __init__(self, torch):
        self.torch, self.pairs = torch, []

    def __call__(self, launch) -> None:
        cuda = self.torch.cuda
        cuda._sleep(SLEEP_CYCLES)
        start, end = cuda.Event(enable_timing=True), cuda.Event(enable_timing=True)
        start.record()
        launch()
        end.record()
        self.pairs.append((start, end))

    def total_ms(self) -> float:
        self.torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.pairs)


def bound(n_bytes: float, alu_ops: float, other_ops: float = 0.0):
    """Least time (ms) and what bounds it: bytes at the memory rate, or the
    integer work (``alu_ops`` only at the ALU rate, all of it at the issue
    rate)."""
    t_bytes = n_bytes / MEM_BYTES_PER_S * 1e3
    t_ops = max(alu_ops / ALU_OPS_PER_S, (alu_ops + other_ops) / ISSUE_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0 and out.stdout.strip(), f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


KERNEL_NAMES = {  # kernel function (in the mangled name) -> report key
    "keccak_f1600_warp_kernel": "keccak_f1600/warp", "keccak_f1600_kernel": "keccak_f1600/thread",
    "tape_vm_kernel": "tape_vm",
}


def _kernel_key(mangled: str):
    return next((v for k, v in KERNEL_NAMES.items() if k in mangled), None)


def build_kernels():
    """Build; -> {kernel key: {"regs_per_thread", "static_smem_bytes"}} from ptxas."""
    import re

    from mythril_tpu_torch.ops import _build

    t0 = phase("build")
    path = _build.build()
    _build.load()
    print(f"built {path.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s")
    attrs, key = {}, None
    for line in _build.build_log().splitlines():
        if any(k in line for k in ("==", "Function properties", "registers", "spill")):
            print("  " + line.strip())
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            key = _kernel_key(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and key:
            smem = re.search(r"(\d+) bytes smem", line)
            attrs[key] = {"regs_per_thread": int(m.group(1)),
                          "static_smem_bytes": int(smem.group(1)) if smem else 0}
    check(set(attrs) == set(KERNEL_NAMES.values()), f"ptxas report incomplete: {sorted(attrs)}")
    return attrs


def sass_per_round():
    """LOP3, SHF and SHFL instructions per keccak round (over 24) in each
    layout's SASS, by ``cuobjdump -sass`` of the built library."""
    import re

    from mythril_tpu_torch.ops import _build

    tool = Path(_build.nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(_build.library_path())],
                         capture_output=True, text=True, timeout=120)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr[-500:]}")
    counts, key = {}, None
    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            key = _kernel_key(m.group(1))
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if m and key and key.startswith("keccak"):
            ops = counts.setdefault(key, collections.Counter())
            ops[m.group(1)] += 1
            ops["all"] += 1
    per_round = {k.split("/")[1]: {op: round(c[op] / 24, 2) for op in ("LOP3", "SHF", "SHFL", "all")}
                 for k, c in counts.items()}
    check(set(per_round) == {"thread", "warp"}, "keccak kernels missing from the SASS")
    for name, c in per_round.items():
        print(f"  keccak {name} per round: {c['LOP3']} LOP3 + {c['SHF']} SHF "
              f"(+ {c['SHFL']} SHFL; {c['all']} instructions in all, load and store included)")
    return per_round


def keccak_parity(torch):
    from mythril_tpu_torch.ops import bitvec, keccak_cuda, keccak_torch
    from mythril_tpu_torch.ops.keccak import keccak256_py

    phase("keccak parity")
    g = torch.Generator(device="cuda").manual_seed(1600)
    for n in KECCAK_NS:
        st = torch.randint(0, 1 << 16, (n, 25, 4), dtype=torch.int32, device="cuda", generator=g)
        want = keccak_torch.keccak_f1600_reference(st)
        for variant in keccak_cuda.VARIANTS:
            got = keccak_cuda.keccak_f1600(st, variant)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            print(f"  N={n} {variant}: max_abs_err {err}")
            check(err == 0, f"keccak kernel ({variant}) differs from its plain version at N={n}")
    for msg in (b"", bytes(32), bytes(range(64))):
        width = 8 * len(msg)
        data = bitvec.from_ints([int.from_bytes(msg, "big")], width, "cuda")
        word = bitvec.to_ints(keccak_torch.keccak256(data, width), 256)[0]
        want = int.from_bytes(keccak256_py(msg), "big")
        print(f"  keccak256({len(msg)} bytes) = {word:064x}")
        check(word == want, f"keccak256 of {len(msg)} bytes differs from the host keccak")


def tape_both(torch, args, kw):
    """Run the kernel and the plain version on the card; the truth tables and
    every register the tape wrote must be equal.  -> (kernel truth, equal)"""
    from mythril_tpu_torch.ops import tape_vm

    V, T, n = kw["V"], kw["T"], kw["n_steps"]
    regs = torch.empty((V + T, 16, args[0].shape[0]), dtype=torch.int32, device="cuda")
    got = tape_vm.run_tape(*args, regs=regs, **kw)
    plain_path = tape_vm.run_tape(*args, **kw)  # as the main path calls it: no regs
    want, want_regs = tape_vm.run_tape_reference(
        *args, T=T, V=V, A=kw["A"], K=kw["K"], R=kw["R"], n_steps=n, return_regs=True)
    torch.cuda.synchronize()
    equal = torch.equal(got, want) and torch.equal(plain_path, want) and torch.equal(
        regs[: V + n].permute(0, 2, 1).long(), want_regs[: V + n])
    return got, equal


def tape_parity(torch):
    from mythril_tpu_torch.ops import tape_vm
    from mythril_tpu_torch.smt import concrete_eval, terms
    from tests import _torch_tape_cases as cases

    phase("tape parity")
    runs = 0
    jobs = [(f, large, n) for f in cases.FAMILIES for large in (False, True) for n in (40, 200)]
    jobs.append(("keccak64", True, 8192))
    jobs += [(c, False, n) for c in cases.SLOT_CASES for n in (40, 200)]
    for seed, (family, large, n) in enumerate(jobs):
        conj, bv_vars, arrays = cases.build(terms, family, large)
        asgs = cases.random_assignments(terms, concrete_eval, bv_vars, arrays, seed, n)
        compiled = tape_vm.compile_tape(conj)
        args, (T, V, A, K, R) = compiled.pack_args(asgs, "cuda")
        got, regs_equal = tape_both(torch, args, dict(
            T=T, V=V, A=A, K=K, R=R, n_steps=compiled.n_steps, plan=compiled.plan))
        check(regs_equal,
              f"tape kernel differs from its plain version: {family} "
              f"{compiled.tensors['profile']} B={args[0].shape[0]} slots={compiled.plan.S}")
        if n == 40:  # and the host oracle on the real rows
            for b, asg in enumerate(asgs):
                vals = concrete_eval.evaluate(conj, asg)
                check(got[b, : len(conj)].tolist() == [bool(vals[c]) for c in conj],
                      f"tape kernel differs from concrete_eval: {family} candidate {b}")
        if family in cases.SLOT_CASES and n == 40:
            print(f"  {family}: {compiled.n_steps} steps, {compiled.plan.S} slots, "
                  f"{compiled.plan.n_spill} spilled at most, {len(compiled.plan.segments)} segments")
        runs += 1
    check(tape_vm.compile_tape(cases.build(terms, "wide_live")[0]).plan.S > 200,
          "wide_live no longer needs more than 200 slots")
    print(f"  {runs} tapes bit-equal (20 op families x 2 profiles x 2 buckets + 8192 wide "
          f"+ {len(cases.SLOT_CASES)} slot cases x 2 buckets)")


def main_path(torch):
    from mythril_tpu_torch.ops import keccak_cuda, tape_vm
    from mythril_tpu_torch.smt import solver as P
    from mythril_tpu_torch.smt.concrete_eval import evaluate
    from mythril_tpu_torch.smt.serialize import from_jax_dump
    from mythril_tpu_torch.support.support_args import args
    from tests.test_torch_fixture import disagreements, load_fixture, replay

    t0 = phase("main path: recorded probe traffic through the solver on the card")
    data, roots = load_fixture(from_jax_dump)

    # keep each kernel call's inputs for the timing below
    tape_calls, keccak_calls = [], []
    run_tape_cuda, keccak_kernel = tape_vm._run_tape_cuda, keccak_cuda.keccak_f1600

    def record_tape(*a, **kw):
        tape_calls.append((a, {k: v for k, v in kw.items() if k != "regs"}))
        return run_tape_cuda(*a, **kw)

    def record_keccak(state):
        keccak_calls.append(state.clone())
        return keccak_kernel(state)

    tape_vm._run_tape_cuda, keccak_cuda.keccak_f1600 = record_tape, record_keccak
    args.probe_backend = "device"
    P.SolverStatistics().reset()
    keccak_cuda.launches = tape_vm.launches = 0
    keccak_cuda.variant_launches = dict.fromkeys(keccak_cuda.VARIANTS, 0)
    try:
        verdicts, bad = collections.Counter(), []
        for contract in data["contracts"]:
            results = replay(contract["queries"], roots, P)  # device=None: the card
            bad += disagreements(contract["queries"], contract["jax_verdicts"], results, evaluate)
            for q, r in zip(contract["queries"], results):
                if q["kind"] == "batch":
                    verdicts.update("keep" if k else "prune" for k in r)
                else:
                    verdicts[r[0]] += 1
        torch.cuda.synchronize()
    finally:
        tape_vm._run_tape_cuda, keccak_cuda.keccak_f1600 = run_tape_cuda, keccak_kernel
    launches = {"tape_vm": tape_vm.launches, "keccak_f1600": keccak_cuda.launches}
    stats = P.SolverStatistics().as_dict()
    n_queries = sum(len(c["queries"]) for c in data["contracts"])
    print(f"  {n_queries} queries in {time.perf_counter() - t0:.1f} s; verdicts {dict(verdicts)}")
    print(f"  disagreements with the JAX verdicts: {len(bad)} {bad[:5]}")
    print(f"  launches {launches} (keccak layouts {keccak_cuda.variant_launches}); "
          f"tape_unsupported {stats['tape_unsupported']}; "
          f"device_dispatches {stats['device_dispatches']}")
    check(not bad, f"{len(bad)} keep/prune disagreements with the JAX verdicts")
    for name, n in launches.items():
        check(n > 0, f"the main path launched {name} no time")
    return launches, tape_calls, keccak_calls


def idle_share(torch):
    """The main path replayed once more under ``torch.profiler``: the
    device time of every CUDA kernel and copy over the host wall time ->
    the card's idle share, or None with the reason when the profiler shows
    no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mythril_tpu_torch.smt import solver as P
    from mythril_tpu_torch.smt.serialize import from_jax_dump
    from tests.test_torch_fixture import load_fixture, replay

    phase("idle share: the main path under torch.profiler")
    data, roots = load_fixture(from_jax_dump)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for contract in data["contracts"]:
                replay(contract["queries"], roots, P)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    except Exception as e:  # a measurement only: the path itself ran above
        print(f"  not measured: {type(e).__name__}: {e}")
        return None
    if not device:
        print("  not measured: the profiler recorded no device time")
        return None
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:6]
    print(f"  wall {wall_ms:.1f} ms (profiled), device busy {busy_ms:.4f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.6f}; by kernel: "
          + ", ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.4f} ms x{e.count}" for e in top))
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms}


# ---------------------------------------------------------------------------
# timing at the main path's shapes
# ---------------------------------------------------------------------------


def _word_ints(regs_np, row: int):
    limbs = regs_np[row].astype("<u2")  # [16, B]
    return [int.from_bytes(limbs[:, b].tobytes(), "little") for b in range(limbs.shape[1])]


def tape_work(tape, n_steps: int, K: int, regs_np):
    """32-bit integer instructions the tape's steps need over every candidate
    of the batch -> (keccak permutations' LOP3 and shifts, the rest), with
    division and exponentiation counted from the values this run computed
    (``regs_np``: the kernel's register file)."""
    from mythril_tpu_torch.ops import tape_vm

    names = {getattr(tape_vm, n): n[3:] for n in dir(tape_vm) if n.startswith("OP_")}
    B = regs_np.shape[2]
    alu = other = 0.0
    for t in range(n_steps):
        name = names[int(tape["op"][t])]
        other += 8 * B
        if name in STEP_OPS:
            other += STEP_OPS[name] * B
            if name.startswith("KECCAK"):
                alu += KECCAK_OPS * B
        elif name == "SELECT":
            other += SELECT_ROW_OPS * K * B
        elif name in ("UDIV", "UREM", "SDIV", "SREM"):
            for v in _word_ints(regs_np, int(tape["a0"][t])):
                if name in ("SDIV", "SREM") and v >> 255:
                    v = (1 << 256) - v
                other += DIV_BIT_OPS * v.bit_length() + (40 if name[0] == "S" else 8)
        elif name == "EXP":
            for e in _word_ints(regs_np, int(tape["a1"][t])):
                other += EXP_MUL_OPS * (bin(e).count("1") + max(e.bit_length() - 1, 0))
    return alu, other


def time_tape(torch, calls, reps: int = 20):
    """Per main-path call: ``ms``, the device time of the call's tape_vm
    segment launches alone (the keccak launches between segments excluded);
    ``wrapper_ms``, the whole ``run_tape`` call as the main path makes it;
    ``plain_ms``, the plain version; the bound of the call's work; the
    slots, candidates per block and dynamic shared memory of its launches."""
    import ctypes

    from mythril_tpu_torch.ops import _build, keccak_cuda, tape_vm

    lib = _build.load()
    rows = []
    for a, kw in calls:
        T, V, A, K, R, n, plan = (kw[k] for k in ("T", "V", "A", "K", "R", "n_steps", "plan"))
        B = a[0].shape[0]
        regs = torch.empty((V + T, 16, B), dtype=torch.int32, device="cuda")
        got = tape_vm.run_tape(*a, regs=regs, **kw)
        want, want_regs = tape_vm.run_tape_reference(*a, T=T, V=V, A=A, K=K, R=R, n_steps=n,
                                                     return_regs=True)
        err = max(int((got.long() - want.long()).abs().max()),
                  int((tape_vm.run_tape(*a, **kw).long() - want.long()).abs().max()),
                  int((regs[: V + n].permute(0, 2, 1).long() - want_regs[: V + n]).abs().max()))
        timer, shape = LaunchTimer(torch), {}

        def segment(targs):
            if "block" not in shape:
                block, smem = ctypes.c_int(), ctypes.c_longlong()
                lib.mk_tape_vm_shape(ctypes.byref(targs), ctypes.byref(block), ctypes.byref(smem))
                shape["block"], shape["smem_bytes"] = block.value, smem.value
            stream = torch.cuda.current_stream().cuda_stream
            timer(lambda: _build.check(lib.mk_tape_vm_segment(ctypes.byref(targs), stream),
                                       "tape_vm"))

        for _ in range(reps):
            tape_vm.run_segments(*a, T=T, V=V, A=A, K=K, R=R, plan=plan, segment=segment,
                                 permute=keccak_cuda.keccak_f1600)
        ms = timer.total_ms() / reps
        wrapper = cuda_ms(lambda: tape_vm.run_tape(*a, **kw), reps)
        plain = cuda_ms(lambda: tape_vm.run_tape_reference(*a, T=T, V=V, A=A, K=K, R=R,
                                                           n_steps=n), 2)
        tape = {k: x.cpu().numpy() for k, x in zip(("op", "a0", "a1"), a[5:8])}
        # inputs read once (the array tables only when a SELECT step reads
        # them), the truth table written once
        tables = a[1:5] if tape_vm.OP_SELECT in tape["op"][:n] else ()
        n_bytes = sum(x.numel() * x.element_size() for x in (a[0], *tables, *a[5:])) + B * R
        b_ms, b_by = bound(n_bytes, *tape_work(tape, n, K, regs.cpu().numpy()))
        profile = next(p[0] for p in tape_vm._PROFILES if p[1] == T)
        rows.append({"ms": ms, "wrapper_ms": wrapper, "plain_ms": plain, "bound_ms": b_ms,
                     "bound_by": b_by, "err": err, "slots": plan.S, **shape,
                     "shape": f"B={B} T={T} steps={n} profile={profile}"})
    return rows


def time_keccak(torch, states, reps: int = 50):
    """Per call: ``ms``, the device time of the launch alone, and
    ``wrapper_ms``, the whole ``keccak_f1600`` call, in the layout the
    wrapper picks for this N, and both in each layout (``variants``);
    ``plain_ms``; the bound."""
    from mythril_tpu_torch.ops import _build, keccak_cuda, keccak_torch

    lib = _build.load()
    rows = []
    for st in states:
        n = st.shape[0]
        want = keccak_torch.keccak_f1600_reference(st)
        stream = torch.cuda.current_stream().cuda_stream
        per = {}
        for variant, entry_name in keccak_cuda.VARIANTS.items():
            entry = getattr(lib, entry_name)
            got = keccak_cuda.keccak_f1600(st, variant)
            out, timer = torch.empty_like(st), LaunchTimer(torch)
            for _ in range(reps):
                timer(lambda: _build.check(entry(st.data_ptr(), out.data_ptr(), n, stream),
                                           "keccak_f1600"))
            per[variant] = {
                "ms": timer.total_ms() / reps,
                "wrapper_ms": cuda_ms(lambda: keccak_cuda.keccak_f1600(st, variant), reps),
                "err": int((got.long() - want.long()).abs().max()),
            }
        path = keccak_cuda.pick_variant(n)
        plain = cuda_ms(lambda: keccak_torch.keccak_f1600_reference(st), 5)
        b_ms, b_by = bound(800 * n, KECCAK_OPS * n)
        rows.append({"ms": per[path]["ms"], "wrapper_ms": per[path]["wrapper_ms"],
                     "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                     "err": max(v["err"] for v in per.values()), "shape": f"N={n}",
                     "variant": path,
                     "variants": {v: {k: r[k] for k in ("ms", "wrapper_ms")} for v, r in per.items()}})
    return rows


def keccak_crossover(torch):
    """Both layouts at every N of the parity phase and around the wrapper's
    switch, launches alone."""
    from mythril_tpu_torch.ops import keccak_cuda

    g = torch.Generator(device="cuda").manual_seed(1601)
    ns = sorted(set(KECCAK_NS) | {512, 1024, 2048, 8192, 16384, 32768})
    rows = time_keccak(torch, [torch.randint(0, 1 << 16, (n, 25, 4), dtype=torch.int32,
                                             device="cuda", generator=g) for n in ns], reps=20)
    for r in rows:
        check(r["err"] == 0, f"keccak differs from its plain version at {r['shape']}")
        v = r["variants"]
        print(f"  {r['shape']}: thread {v['thread']['ms']:.5f} ms, warp {v['warp']['ms']:.5f} ms; "
              f"bound {r['bound_ms']:.6f} ms; wrapper takes {keccak_cuda.pick_variant(int(r['shape'][2:]))}")
    return [{"shape": r["shape"], "bound_ms": r["bound_ms"],
             **{v: r["variants"][v]["ms"] for v in keccak_cuda.VARIANTS}} for r in rows]


def at_scale(torch):
    """Wide calls beyond the main path's shapes: keccak at 65536 states, the
    tape at B=8192 on the large profile (keccak64), and at B=4096 with more
    than 200 slots (wide_live, 16 candidates per block)."""
    from mythril_tpu_torch.ops import tape_vm
    from mythril_tpu_torch.smt import concrete_eval, terms
    from tests import _torch_tape_cases as cases

    g = torch.Generator(device="cuda").manual_seed(65536)
    st = torch.randint(0, 1 << 16, (65536, 25, 4), dtype=torch.int32, device="cuda", generator=g)
    tapes = []
    for family, large, n in (("keccak64", True, 8192), ("wide_live", False, 4096)):
        conj, bv_vars, arrays = cases.build(terms, family, large)
        compiled = tape_vm.compile_tape(conj)
        asgs = cases.random_assignments(terms, concrete_eval, bv_vars, arrays, n, n)
        args, (T, V, A, K, R) = compiled.pack_args(asgs, "cuda")
        tapes.append((args, dict(T=T, V=V, A=A, K=K, R=R, n_steps=compiled.n_steps,
                                 plan=compiled.plan)))
    rows = time_tape(torch, tapes, reps=10)
    out = {"keccak_f1600": [time_keccak(torch, [st])[0]], "tape_vm": rows}
    for name, rs in out.items():
        for r in rs:
            check(r["err"] == 0, f"{name} at scale differs from its plain version")
            print(f"  {name} {r['shape']}: kernel {r['ms']:.5f} ms (wrapper {r['wrapper_ms']:.4f} ms, "
                  f"plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.6f} ms by {r['bound_by']})"
                  + (f"; {r['slots']} slots, {r['block']} per block, {r['smem_bytes']} B smem"
                     if "slots" in r else f"; layouts {r['variants']}"))
    return out


def summarize(name, rows, launches, card, **fixed):
    """The median call (by kernel time) stands for the kernel; totals beside."""
    mid = sorted(rows, key=lambda r: r["ms"])[len(rows) // 2]
    entry = {
        "name": name, **fixed, "launches": launches,
        "max_abs_err": max(r["err"] for r in rows),
        "ms": mid["ms"], "plain_ms": mid["plain_ms"], "bound_ms": mid["bound_ms"],
        "bound_by": mid["bound_by"], "library_ms": None, "parity_ok": True,
        "shape": mid["shape"], "calls": len(rows),
        "wrapper_ms": mid["wrapper_ms"],
        "total_ms": sum(r["ms"] for r in rows),
        "total_wrapper_ms": sum(r["wrapper_ms"] for r in rows),
        "total_plain_ms": sum(r["plain_ms"] for r in rows),
        "total_bound_ms": sum(r["bound_ms"] for r in rows),
        "shapes": dict(collections.Counter(r["shape"].split(" steps")[0] for r in rows)),
        "card": card,
        # the median call's launch shape (tape) or layouts (keccak)
        **{k: mid[k] for k in ("slots", "block", "smem_bytes", "variant", "variants") if k in mid},
    }
    check(entry["max_abs_err"] == 0, f"{name}: kernel differs from its plain version")
    print(f"  {name}: median call {mid['shape']}: kernel {mid['ms']:.5f} ms (wrapper "
          f"{mid['wrapper_ms']:.4f} ms, plain {mid['plain_ms']:.3f} ms, bound "
          f"{mid['bound_ms']:.6f} ms by {mid['bound_by']}); {len(rows)} calls: kernel "
          f"{entry['total_ms']:.4f} ms, wrapper {entry['total_wrapper_ms']:.4f} ms, plain "
          f"{entry['total_plain_ms']:.1f} ms, bound {entry['total_bound_ms']:.6f} ms in all")
    return entry


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    if not (ROOT / "mythril_tpu_torch").is_dir() or not FIXTURE.is_file():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    t_start = time.perf_counter()
    try:
        phase("card")
        card = card_line()
        print(card)
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
        attrs = build_kernels()
        sass = sass_per_round()
        keccak_parity(torch)
        tape_parity(torch)
        launches, tape_calls, keccak_calls = main_path(torch)
        phase("kernel times at the main path's shapes (CUDA events)")
        keccak = summarize("keccak_f1600", time_keccak(torch, keccak_calls),
                           launches["keccak_f1600"], card, route="cuda",
                           source="mythril_tpu_torch/csrc/keccak_f1600.cu",
                           replaces="mythril_tpu/ops/keccak_pallas.py:149")
        for variant, timing in keccak["variants"].items():
            timing.update(attrs[f"keccak_f1600/{variant}"], sass_per_round=sass[variant])
        keccak.update(regs_per_thread=attrs[f"keccak_f1600/{keccak['variant']}"]["regs_per_thread"],
                      smem_bytes=attrs[f"keccak_f1600/{keccak['variant']}"]["static_smem_bytes"])
        tape = summarize("tape_vm", time_tape(torch, tape_calls), launches["tape_vm"], card,
                         route="cuda", source="mythril_tpu_torch/csrc/tape_vm.cu",
                         replaces="mythril_tpu/ops/tape_vm.py:360")
        tape["regs_per_thread"] = attrs["tape_vm"]["regs_per_thread"]
        tape["smem_bytes"] += attrs["tape_vm"]["static_smem_bytes"]
        kernels = [keccak, tape]
        phase("keccak layouts by N (CUDA events, launches alone)")
        keccak["by_n"] = keccak_crossover(torch)
        phase("kernel times at scale (CUDA events)")
        for entry, rows in zip(kernels, at_scale(torch).values()):
            entry["at_scale"] = [{k: r[k] for k in ("shape", "ms", "wrapper_ms", "plain_ms",
                                                    "bound_ms", "bound_by", "slots", "block",
                                                    "smem_bytes", "variants") if k in r}
                                 for r in rows]
        idle = idle_share(torch)
        if idle is not None:
            tape["main_path_idle_share"] = idle
        from mythril_tpu_torch.smt import ULT, Solver, symbol_factory

        x = symbol_factory.BitVecSym("smoke_x", 256)
        s = Solver()  # default device: the card
        s.add(x + 5 == symbol_factory.BitVecVal(12, 256), ULT(x, symbol_factory.BitVecVal(100, 256)))
        check(s.check() == "sat" and s.model().eval(x.raw) == 7, "Solver API on the card")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
