#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card, end to end: the solver's
probe (the tape VM and the per-conjunction lowering), the device frontier
segment and the whole analysis around them,
without and with the native CDCL tier, and under the solver's default
prefilter and devsolver tiers.

    python3 chip_smoke.py          # from the repository root; one CUDA card, nvcc

Phases, in order; any failure exits nonzero and prints no result:

1. the card (``nvidia-smi`` name and power limit) and torch's CUDA version;
2. the kernel build from ``mythril_tpu_torch/csrc`` (``ops/_build.py``, one
   nvcc per source, all at once), timed, with ptxas's register, stack
   frame and spill report, the LOP3 and SHF instructions per keccak round
   and each frontier kernel's local loads and stores (LDL, STL) in the SASS
   (``cuobjdump -sass``); then the native CDCL library (``native/build.py``,
   g++), which must build and load;
2b. known bits: the ``known_bits`` kernel (the prefilter's device pass)
   against its plain version ``eval_kb_plain``, both on the card, bit for
   bit, on every known-bits pack of ``tests/testdata/torch_tier_kernels.npz``
   (what the JAX package's runs of ``torch_engine_runs_tiers.json`` fed its
   host twin), whose outputs must also hash to the recorded digests, and on
   seeded synthetic tapes at N = 512 and 4096 nodes and R = 16 and 64 rows
   and at N = 1000 and 1002, R = 2, the two sides of the kernel's
   shared-memory cut; every recorded pack and N = 512 and 1000 must take
   the shared-memory route, N = 1002 and 4096 the global one;
2c. DPLL: the ``dpll`` kernel (the devsolver's search) against ``run_plain``,
   both on the card, status, assignment and steps bit for bit, on every
   recorded plane (digests as for 2b), on seeded 3-CNF planes at [16,
   4096, 3] with V = 4096 and at [16, 512, 3], with SAT, UNSAT and
   budget-cut (UNKNOWN) queries, and on the hand-built edge planes of
   ``tests/_torch_tier_cases.py`` ``dpll_edge_cases`` (also against the
   status and steps each states);
3. keccak: both layouts of the ``keccak_f1600`` kernel (thread and warp per
   state) against ``keccak_f1600_reference``, both on the card, at N in
   {1, 3, 64, 130, 4096, 65536} random states, bit-equal; then ``keccak256``
   of known vectors against the host ``keccak256_py``;
4. tape: ``run_tape`` (the ``tape_vm`` kernel) against ``run_tape_reference``,
   both on the card, bit-equal in truth and in every register: one tape per
   op family (all 20) at both profiles and both batch buckets, one batch of
   8192 on the large profile, and the slot cases of
   ``tests/_torch_tape_cases.py`` at both buckets;
4b. lowering: ``run_lowering`` (the ``lowering`` kernel, one launch a call,
   keccak nodes inside) against ``run_lowering_reference``, both on the
   card, bit-equal in truth and in every node's value: every op family of
   ``tests/_torch_lowering_cases.py`` at every width of its ``WIDTHS`` (B =
   63, and against ``concrete_eval``), three families at 256 and 520 bits
   at B = 1, 192 and 4096, tables of K = 8, 16 and 64 rows at every B, a
   program past the shared-memory budget (the global-arena route) and a
   keccak of three rate blocks, and every recorded dispatch of
   ``tests/testdata/torch_lowering_cases.npz`` (the JAX package's lowering
   dispatches on the probe fixture), against its stored JAX truth too;
5. frontier parity: the ``frontier_segment`` kernel against ``segment_torch``,
   both on the card, bit-equal in every output array, on every case of
   ``tests/_torch_frontier_cases.py`` (the 33 families on concrete and
   symbolic operands, each binary and comparison fold, the caps and parity
   hazards, the fork phases' cases, all five grant modes under slot
   scarcity, random batches) and on a forking batch at each width of
   ``FRONTIER_WIDTHS``, which covers every launch shape (one block, one
   cluster, a cooperative grid), and in each shape on children's event
   buffers that start off a 16-byte boundary; per width the shape, ptxas's
   registers, stack frame and spills and the LDL/STL count of its kernel;
6. the probe main path: the recorded probe traffic of
   ``tests/testdata/torch_probe_queries.json`` replayed through
   ``check_satisfiable_batch`` and ``solve_conjunction`` on the card with
   ``probe_backend="device"`` and the port's native CDCL off, as the JAX
   package ran when the traffic was recorded; every launch count zeroed just before and read
   just after; 0 keep/prune disagreements with the stored JAX verdicts;
   ``tape_vm`` and ``lowering`` launched (the conjunctions the tape refuses
   go to the lowering, as in the JAX package; no tape of this traffic has a
   keccak step, so ``keccak_f1600`` runs on the engine's paths), every
   solver device dispatch a tape or a lowering evaluation, one ``lowering``
   launch per lowering call and no ``keccak_f1600`` launch from one; the
   counts ``tape_unsupported``, ``lowering_unsupported`` and
   ``device_dispatches``;
7. the frontier main path: every dispatch of
   ``tests/testdata/torch_frontier_dispatches.npz`` (the JAX engine's real
   segments at widths 1024 and 256) through ``push_state`` -> ``segment`` (the
   kernel, through ``cached_segment`` with no device: the card) ->
   ``pull_harvest`` -> ``HostArena.pull_from_device``, counts zeroed before
   and read after; 0 mismatches against the stored JAX digests; then the
   kernel against ``segment_torch`` on the card, on every dispatch but the
   largecode run's tail;
8. the engine: the port's analysis (``SymExecWrapper`` + ``fire_lasers``,
   no device argument: the card, native CDCL off) on every run of
   ``tests/testdata/torch_engine_runs.json``, recorded from the JAX package:
   ``bench_contracts``' ``etherstore_like`` and ``rubixi_like`` at width
   256 with 2 transactions and ``bectoken_like`` with 1, ``bench``'s wide
   (1024) and largecode (256) contracts with 1, ``kill_simple`` with 2, each with
   the frontier forced and the smaller ones with the host engine too; counts
   zeroed before each run and read after; each run's issue keys, step
   counts and fixed selectors equal the recorded ones, every frontier
   dispatch's input and output digests too, one segment launch per
   dispatch, no replay or commit error, one tape or lowering evaluation on
   the card per solver device dispatch (the lowering's launches printed),
   ``keccak_f1600`` launched (the tapes' keccak steps, whose states phase 9
   times);
   per run the wall seconds and their split
   (segment kernel by CUDA events, the segment call, ``push_state``,
   ``pull_harvest``, the arena pull, the walker's replay and commit, the
   solver, the rest of the host) and path-steps per second; then the
   ``bectoken_like`` frontier run once more under ``torch.profiler`` for
   the card's idle share;
8b. the engine under native CDCL: the same on every run of
   ``tests/testdata/torch_engine_runs_cdcl.json``, recorded from the JAX
   package with CDCL on, the port's CDCL on; besides, the issue keys of
   ``bectoken_like``, ``etherstore_like`` and ``rubixi_like`` equal the JAX
   package's default-tier keys; per run also the CDCL calls, solves,
   seconds and timeouts.  A run whose JAX recording has CDCL answers cut by
   their wall-clock budget (``timeouts``) cannot be held exactly: a
   difference there is reported, not failed, and its keys must still equal
   the default-tier keys.  Then ``etherstore_like`` (frontier) under
   ``torch.profiler``;
8d. the engine under the solver's default tiers: the same on every run of
   ``tests/testdata/torch_engine_runs_tiers.json``, recorded from the JAX
   package with native CDCL, the known-bits prefilter and the devsolver on,
   the port's three on; also the two tiers' counters; the ``known_bits``
   and ``dpll`` launches equal the JAX package's host-twin calls, and are
   above 0 on the bench contracts; each run's wall beside the same run's
   wall under CDCL alone (8b); then ``rubixi_like`` (frontier) under
   ``torch.profiler``;
8c. the command line: ``interfaces.cli.main`` in process, with no
   ``--device`` (the card), on the recorded command lines of
   ``tests/testdata/torch_cli_runs.json`` for ``etherstore_like``,
   ``rubixi_like`` and ``kill_simple`` (2 transactions, forced frontier of
   256 paths, native CDCL on, the prefilter and devsolver off as the JAX CLI
   ran) and ``etherstore_like`` again with both tiers on in both; each jsonv2 report equal to the JAX CLI's
   (``tests/test_torch_cli.py`` ``differences``), counts zeroed before each
   run and read after, one segment launch per frontier segment, one tape
   or lowering evaluation on the card per solver device dispatch; per run
   the CLI's
   wall beside ``SymExecWrapper`` + ``fire_lasers`` alone on the same
   contract and parameters, in turns (CLI, wrapper, wrapper, CLI), and
   beside the engine phase's run of the contract.  Then ``python -m mythril_tpu_torch analyze ... --frontier``
   on ``kill_simple`` in a process of its own, which must exit 0 with the
   ``kill()`` exploit, and a ``--frontier-width`` one block over the card's
   limit, which must be refused before any launch (phase 8d runs before 8c,
   for the CDCL-only walls it prints);
9. times with CUDA events: each kernel's launches alone (``ms``), the whole
   wrapper call (``wrapper_ms``) and its plain version, beside the call's
   bound, at the main paths' shapes; keccak in both layouts at every N of
   phase 3; the frontier segment per dispatch with path-steps per second and
   the ``push_state`` and ``pull_harvest`` times; ``known_bits`` and
   ``dpll`` on the recorded packs and planes of 8d's main path and on the
   seeded ones, ``known_bits`` also through the prefilter's whole pass
   ``run_kb`` (the uploads, the level plan, the launch, the downloads) with
   its parts, ``dpll`` also per step and through the devsolver's whole call
   ``run_device`` (one upload, the launch, one download), its bound counting
   the clauses that are not padding; the lowering on up to 16 of the probe main path's calls and
   on two of them tiled to B = 4096; the probe main path once more under
   ``torch.profiler`` for the card's idle share;
10. one ``{"kernels": [...]}`` line (with each kernel's launches on every
   main path), and as the last line
   ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import collections
import contextlib
import json
import logging
import statistics
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
# keccak_f1600 calls of the engine phase kept for timing
KECCAK_KEPT = 64
DIV_BIT_OPS = 40
EXP_MUL_OPS = 80
SELECT_ROW_OPS = 10
# 32-bit integer operations of the known-bits walk per node and row: the
# transfer functions' 16-limb loops (about 6 logic ops a limb for the
# common ops, more for shifts and adds), the override's meet and the
# stores: an estimate from csrc/known_bits.cuh, at the ALU rate
KB_NODE_OPS = 200
# operations of the DPLL search per clause and step (three literal reads,
# their truth, the counts) and per bitset word and step (both-ways test,
# application, clearing), at the issue rate; counted over each query's
# own steps (the kernel's steps output) and its real clauses (those that
# can be false: the padding and the clauses holding literal 1 or 2 need no
# work)
DPLL_CLAUSE_OPS = 20
DPLL_WORD_OPS = 8
# 32-bit integer operations of one lowering record for one candidate, per
# limb of its result (csrc/lowering.cuh: each limb's operand loads, the op,
# the mask and the store); multiplication per limb product, division per
# dividend bit and limb, exponentiation per multiply (counted from this
# run's values), a lookup per table row and index limb.  At the issue rate;
# a keccak record's permutations (KECCAK_OPS per rate block) at the ALU rate.
LOWER_LIMB_OPS = {"ADD": 6, "SUB": 7, "NEG": 5, "AND": 5, "OR": 5, "XOR": 5, "NOT": 4,
                  "SHL": 10, "LSHR": 12, "ASHR": 14, "CONCAT": 12, "EXTRACT": 10,
                  "ZEXT": 4, "SEXT": 6, "ITE": 3, "EQ": 3, "ULT": 5, "ULE": 5, "SLT": 5,
                  "SLE": 5, "LOOKUP": 3, "MUL": 4, "UDIV": 4, "UREM": 4, "SDIV": 10,
                  "SREM": 10, "EXP": 6, "KECCAK": 0}
LOWER_PRODUCT_OPS = 4
LOWER_DIV_BIT_LIMB_OPS = 12
LOWER_ROW_LIMB_OPS = 3
# the lowering's seeded shapes: candidates per program and rows per table
LOWER_BS = (1, 63, 192, 4096)
LOWER_KS = (8, 16, 64)
# (seed, nodes, rows, the row's values in shared memory): both sides of the
# known-bits kernel's shared-memory cut (about 1000 nodes) and the tape's
# largest size
KB_SEEDED = ((11, 512, 16, True), (12, 512, 64, True), (15, 1000, 2, True),
             (16, 1002, 2, False), (13, 4096, 16, False), (14, 4096, 64, False))


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
    "tape_vm_kernel": "tape_vm", "frontier_segment_block": "frontier_segment/block",
    "frontier_segment_cluster": "frontier_segment/cluster",
    "frontier_segment_grid": "frontier_segment/grid",
    "known_bits_kernelILb1E": "known_bits/shared", "known_bits_kernelILb0E": "known_bits/global",
    "dpll_kernelILi256E": "dpll/256", "dpll_kernelILi1024E": "dpll/1024",
    "lowering_kernel": "lowering",
}


def _kernel_key(mangled: str):
    return next((v for k, v in KERNEL_NAMES.items() if k in mangled), None)


def build_kernels():
    """Build; -> {kernel key: {"regs_per_thread", "static_smem_bytes",
    "stack_frame_bytes", "spill_bytes"}} from ptxas."""
    import re

    from mythril_tpu_torch.ops import _build

    t0 = phase("build")
    path = _build.build()
    _build.load()
    print(f"built {path.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s")
    attrs, key, frame = {}, None, {}
    for line in _build.build_log().splitlines():
        if any(k in line for k in ("==", "Function properties", "registers", "spill")):
            print("  " + line.strip())
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            key = _kernel_key(m.group(1))
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and key:
            frame = {"stack_frame_bytes": int(m.group(1)),
                     "spill_bytes": int(m.group(2)) + int(m.group(3))}
        m = re.search(r"Used (\d+) registers", line)
        if m and key:
            smem = re.search(r"(\d+) bytes smem", line)
            attrs[key] = {"regs_per_thread": int(m.group(1)),
                          "static_smem_bytes": int(smem.group(1)) if smem else 0, **frame}
    check(set(attrs) == set(KERNEL_NAMES.values()), f"ptxas report incomplete: {sorted(attrs)}")
    return attrs


def sass_per_round():
    """LOP3, SHF and SHFL instructions per keccak round (over 24) in each
    layout's SASS, by ``cuobjdump -sass`` of the built library; and the
    local-memory loads and stores (LDL, STL) of each frontier kernel."""
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
        if m and key and (key.startswith("keccak") or key.startswith("frontier")):
            ops = counts.setdefault(key, collections.Counter())
            ops[m.group(1)] += 1
            ops["all"] += 1
    per_round = {k.split("/")[1]: {op: round(c[op] / 24, 2) for op in ("LOP3", "SHF", "SHFL", "all")}
                 for k, c in counts.items() if k.startswith("keccak")}
    local = {k: {"LDL": c["LDL"], "STL": c["STL"], "sass_instructions": c["all"]}
             for k, c in counts.items() if k.startswith("frontier")}
    check(len(local) == 3, f"frontier kernels missing from the SASS: {sorted(local)}")
    for k, c in sorted(local.items()):
        print(f"  {k}: {c['LDL']} LDL + {c['STL']} STL of {c['sass_instructions']} instructions")
    check(set(per_round) == {"thread", "warp"}, "keccak kernels missing from the SASS")
    for name, c in per_round.items():
        print(f"  keccak {name} per round: {c['LOP3']} LOP3 + {c['SHF']} SHF "
              f"(+ {c['SHFL']} SHFL; {c['all']} instructions in all, load and store included)")
    return per_round, local


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


def lowering_both(torch, compiled, inputs):
    """The lowering's wrapper (the kernel) and its plain version on the same
    packed inputs on the card -> (kernel truth, equal: the truth tables and
    every node's value)."""
    from mythril_tpu_torch.ops import lowering
    from tests._torch_lowering_cases import node_differences

    arena = torch.empty((compiled.program.rows, inputs[1].shape[0]), dtype=torch.int32,
                        device="cuda")
    got = lowering.run_lowering(compiled, *inputs, arena=arena)
    pooled = lowering.run_lowering(compiled, *inputs)  # as the main path calls it
    values: dict = {}
    want = lowering.run_lowering_reference(compiled, *inputs, values=values)
    torch.cuda.synchronize()
    bad = node_differences(compiled, arena, values)
    return got, torch.equal(got, want) and torch.equal(pooled, want) and not bad


def lowering_parity(torch):
    """Every op family of tests/_torch_lowering_cases.py at every width
    (B=63), the array and keccak families and the arithmetic at 256 and 520
    bits at every B of LOWER_BS, tables of every K of LOWER_KS at every B,
    and every recorded dispatch of tests/testdata/torch_lowering_cases.npz
    (against its stored JAX truth too)."""
    from mythril_tpu_torch.ops import lowering
    from mythril_tpu_torch.smt import concrete_eval, terms
    from tests import _torch_lowering_cases as lcases
    from tests._torch_lowering_cases import load_recorded, recorded_inputs

    t0 = phase("lowering: the kernel against its plain version on the card")
    jobs = [(f, w, 63, 6) for f in lcases.FAMILIES for w in lcases.WIDTHS]
    jobs += [(f, w, B, 6) for f in ("arith", "array", "keccak") for w in (256, 520)
             for B in LOWER_BS if B != 63]
    jobs += [("array", 256, B, K) for K in LOWER_KS for B in LOWER_BS]
    jobs += [("wide", 512, B, 6) for B in (5, 192)]
    jobs += [("long_keccak", 2200, B, 6) for B in (63, 4096)]
    routes = collections.Counter()
    for seed, (family, width, B, K) in enumerate(jobs):
        conj, bv_vars, arrays = (getattr(lcases, family)(terms) if family in ("wide", "long_keccak")
                                 else lcases.build(terms, family, width))
        asgs = lcases.random_assignments(terms, concrete_eval, bv_vars, arrays, seed, B, K)
        compiled = lowering.compile_conjunction(conj)
        inputs = lowering.pack_assignments(compiled, asgs, "cuda")
        lowering.run_kernel(compiled, *inputs,  # the route only: no launch
                            launch=lambda a: routes.update([("global", "shared")[a.in_smem]]))
        got, equal = lowering_both(torch, compiled, inputs)
        check(equal, f"lowering kernel differs from its plain version: {family} w={width} "
                     f"B={B} K={K}")
        if B <= 63:  # and the host oracle
            for b, asg in enumerate(asgs):
                vals = concrete_eval.evaluate(conj, asg)
                check(got[b].tolist() == [bool(vals[c]) for c in conj],
                      f"lowering kernel differs from concrete_eval: {family} w={width} cand {b}")
    meta, arrays, conjs = load_recorded()
    recorded = 0
    for n, (d, conj) in enumerate(zip(meta["dispatches"], conjs)):
        if d.get("jax_error"):
            continue
        compiled = lowering.compile_conjunction(conj)
        got, equal = lowering_both(torch, compiled, recorded_inputs(arrays, n, d, "cuda"))
        check(equal and bool((got.cpu().numpy() == arrays[f"{n}_truth"]).all()),
              f"lowering kernel differs on recorded dispatch {n}")
        recorded += 1
    check(routes["global"] == 2, f"the wide program did not take the global route: {routes}")
    print(f"  {len(jobs)} seeded programs ({len(lcases.FAMILIES)} families x "
          f"{len(lcases.WIDTHS)} widths, B in {LOWER_BS}, K in {LOWER_KS}, the wide program and "
          f"the long keccak; routes {dict(routes)}) and {recorded} "
          f"recorded dispatches equal, every node's value, in "
          f"{time.perf_counter() - t0:.1f} s")


def main_path(torch):
    from mythril_tpu_torch.ops import keccak_cuda, lowering, tape_vm
    from mythril_tpu_torch.smt import solver as P
    from mythril_tpu_torch.smt.concrete_eval import evaluate
    from mythril_tpu_torch.smt.serialize import from_jax_dump
    from mythril_tpu_torch.support.support_args import args
    from tests._torch_parity import port_no_cdcl, port_no_tiers
    from tests.test_torch_fixture import disagreements, load_fixture, replay

    t0 = phase("main path: recorded probe traffic through the solver on the card")
    data, roots = load_fixture(from_jax_dump)

    # keep each kernel call's inputs for the timing below
    tape_calls, lowering_calls = [], []
    run_tape_cuda, run_lowering_cuda = tape_vm._run_tape_cuda, lowering._run_lowering_cuda

    def record_tape(*a, **kw):
        tape_calls.append((a, {k: v for k, v in kw.items() if k != "regs"}))
        return run_tape_cuda(*a, **kw)

    lowering_keccak = 0

    def record_lowering(compiled, *inputs, **kw):
        nonlocal lowering_keccak
        lowering_calls.append((compiled, inputs))
        before = keccak_cuda.launches
        truth = run_lowering_cuda(compiled, *inputs, **kw)
        lowering_keccak += keccak_cuda.launches - before
        return truth

    tape_vm._run_tape_cuda, lowering._run_lowering_cuda = record_tape, record_lowering
    args.probe_backend = "device"
    P.SolverStatistics().reset()
    zero_launches()
    try:
        verdicts, bad = collections.Counter(), []
        for contract in data["contracts"]:
            # recorded under the tiers without native CDCL, prefilter, devsolver
            with port_no_cdcl(), port_no_tiers():
                results = replay(contract["queries"], roots, P)  # device=None: the card
            bad += disagreements(contract["queries"], contract["jax_verdicts"], results, evaluate)
            for q, r in zip(contract["queries"], results):
                if q["kind"] == "batch":
                    verdicts.update("keep" if k else "prune" for k in r)
                else:
                    verdicts[r[0]] += 1
        torch.cuda.synchronize()
    finally:
        tape_vm._run_tape_cuda, lowering._run_lowering_cuda = run_tape_cuda, run_lowering_cuda
    wall = time.perf_counter() - t0
    launches = read_launches()
    stats = P.SolverStatistics().as_dict()
    n_queries = sum(len(c["queries"]) for c in data["contracts"])
    print(f"  {n_queries} queries in {wall:.1f} s; verdicts {dict(verdicts)}")
    print(f"  disagreements with the JAX verdicts: {len(bad)} {bad[:5]}")
    print(f"  launches {launches} (keccak layouts {keccak_cuda.variant_launches}); "
          f"tape_unsupported {stats['tape_unsupported']}; "
          f"lowering_unsupported {stats['lowering_unsupported']}; "
          f"device_dispatches {stats['device_dispatches']} ({len(tape_calls)} tape, "
          f"{len(lowering_calls)} lowering)")
    check(not bad, f"{len(bad)} keep/prune disagreements with the JAX verdicts")
    # keccak_f1600 runs here only for a tape's keccak steps, and this
    # traffic's tapes have none: the engine phases hold it (and time it)
    for name in ("tape_vm", "lowering"):
        check(launches[name] > 0, f"the main path launched {name} no time")
    check(len(tape_calls) + len(lowering_calls) == stats["device_dispatches"],
          "device dispatches that neither the tape nor the lowering evaluated")
    check(launches["lowering"] == len(lowering_calls),
          f"{launches['lowering']} lowering launches for {len(lowering_calls)} calls")
    check(lowering_keccak == 0, f"the lowering launched keccak_f1600 {lowering_keccak} times")
    summary = {k: stats[k] for k in ("tape_unsupported", "lowering_unsupported",
                                     "device_dispatches")}
    summary.update(wall_s=wall, tape_calls=len(tape_calls), lowering_calls=len(lowering_calls))
    return launches, tape_calls, lowering_calls, summary


def zero_launches() -> None:
    from mythril_tpu_torch.absdomain import device as kb_device
    from mythril_tpu_torch.devsolver import device as dpll_device
    from mythril_tpu_torch.frontier import step as fstep
    from mythril_tpu_torch.ops import keccak_cuda, lowering, tape_vm

    keccak_cuda.launches = tape_vm.launches = fstep.launches = lowering.launches = 0
    kb_device.launches = dpll_device.launches = 0
    keccak_cuda.variant_launches = dict.fromkeys(keccak_cuda.VARIANTS, 0)


def read_launches() -> dict:
    from mythril_tpu_torch.absdomain import device as kb_device
    from mythril_tpu_torch.devsolver import device as dpll_device
    from mythril_tpu_torch.frontier import step as fstep
    from mythril_tpu_torch.ops import keccak_cuda, lowering, tape_vm

    return {"tape_vm": tape_vm.launches, "keccak_f1600": keccak_cuda.launches,
            "frontier_segment": fstep.launches, "known_bits": kb_device.launches,
            "dpll": dpll_device.launches, "lowering": lowering.launches}


def idle_share(torch):
    """The main path replayed once more under ``torch.profiler``: the
    device time of every CUDA kernel and copy over the host wall time ->
    the card's idle share, or None with the reason when the profiler shows
    no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mythril_tpu_torch.smt import solver as P
    from mythril_tpu_torch.smt.serialize import from_jax_dump
    from tests._torch_parity import port_no_cdcl, port_no_tiers
    from tests.test_torch_fixture import load_fixture, replay

    phase("idle share: the main path under torch.profiler")
    data, roots = load_fixture(from_jax_dump)
    try:
        with port_no_cdcl(), port_no_tiers(), profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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


def _ref_ints(prog, arena_np, ref: int, L: int):
    """Python ints of a lowering value (arena rows or a pool constant), one
    per candidate."""
    if ref < 0:
        at = -1 - ref
        return [sum(int(prog.pool[at + i]) << (16 * i) for i in range(L))] * arena_np.shape[1]
    limbs = arena_np[ref: ref + L]
    return [sum(int(limbs[i, b]) << (16 * i) for i in range(L)) for b in range(limbs.shape[1])]


def lowering_work(compiled, inputs, arena_np):
    """32-bit integer operations the lowering kernel's records need over
    every candidate -> (at the ALU rate: the keccak permutations, at the
    issue rate: the rest, LOWER_LIMB_OPS), with division and exponentiation
    counted from this run's values (``arena_np``: the kernel's arena)."""
    from mythril_tpu_torch.ops import lowering as low

    prog = compiled.program
    names = {getattr(low, n): n[4:] for n in dir(low) if n.startswith("LOP_")}
    B = arena_np.shape[1]
    K = {i: tab[0].shape[1] for i, tab in enumerate(inputs[2])}
    ops, alu = 2.0 * B * len(compiled.conjuncts), 0.0
    for r in prog.rec:
        name, w, wa = names[int(r[low.R_OP])], int(r[low.R_W]), int(r[low.R_WA])
        L, La = -(-w // 16), -(-wa // 16)
        ops += LOWER_LIMB_OPS[name] * max(L, La) * B
        if name == "MUL":
            ops += LOWER_PRODUCT_OPS * L * (L + 1) // 2 * B
        elif name == "KECCAK":
            alu += KECCAK_OPS * (wa // 8 // 136 + 1) * B
        elif name == "LOOKUP":
            ops += LOWER_ROW_LIMB_OPS * K[int(r[low.R_AUX0])] * (La + 1) * B
        elif name in ("UDIV", "UREM", "SDIV", "SREM"):
            for v in _ref_ints(prog, arena_np, int(r[low.R_A]), L):
                if name[0] == "S" and v >> (w - 1):
                    v = (1 << w) - v
                ops += LOWER_DIV_BIT_LIMB_OPS * v.bit_length() * L
        elif name == "EXP":
            for e in _ref_ints(prog, arena_np, int(r[low.R_B]), L):
                muls = bin(e).count("1") + max(e.bit_length() - 1, 0)
                ops += muls * (LOWER_PRODUCT_OPS * L * (L + 1) // 2 + 4 * L)
    return alu, ops


def time_lowering(torch, calls, reps: int = 10):
    """Per call (compiled conjunction, packed inputs on the card): ``ms``, the
    device time of the call's one launch alone, keccak nodes inside;
    ``wrapper_ms``, the whole ``run_lowering`` call as the main path makes
    it (the input table's upload and the launch); ``plain_ms``, the plain
    version; the bound: every input byte (the packed candidates, the node
    table and its pool) read once and the truth table written once, against
    the records' integer work (``lowering_work``)."""
    import ctypes

    from mythril_tpu_torch.ops import _build, lowering

    lib = _build.load()
    rows = []
    for compiled, inputs in calls:
        prog = compiled.program
        B = inputs[1].shape[0]
        arena = torch.empty((prog.rows, B), dtype=torch.int32, device="cuda")
        got = lowering.run_lowering(compiled, *inputs, arena=arena)
        want = lowering.run_lowering_reference(compiled, *inputs)
        err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
        timer, routes = LaunchTimer(torch), []

        def launch(largs):
            stream = torch.cuda.current_stream().cuda_stream
            routes.append(largs.in_smem)
            timer(lambda: _build.check(lib.mk_lowering(ctypes.byref(largs), stream), "lowering"))

        for _ in range(reps):
            lowering.run_kernel(compiled, *inputs, launch=launch)  # as the main path: no arena
        ms = timer.total_ms() / reps
        wrapper = cuda_ms(lambda: lowering.run_lowering(compiled, *inputs), reps)
        plain = cuda_ms(lambda: lowering.run_lowering_reference(compiled, *inputs), 1)
        flat = [*inputs[0], inputs[1], *(x for tab in inputs[2] for x in tab)]
        n_bytes = (sum(x.numel() * x.element_size() for x in flat) + prog.rec.nbytes
                   + prog.pool.nbytes + B * len(compiled.conjuncts))
        b_ms, b_by = bound(n_bytes, *lowering_work(compiled, inputs, arena.cpu().numpy()))
        rows.append({"ms": ms, "wrapper_ms": wrapper, "plain_ms": plain, "bound_ms": b_ms,
                     "bound_by": b_by, "err": err, "launches_per_call": 1,
                     "shape": f"B={B} records={len(prog.rec)} levels={prog.n_levels} "
                              f"rows={prog.rows} route={('global', 'shared')[routes[0]]}"})
    return rows


def lowering_timed_calls(torch, calls, limit: int = 16):
    """At most ``limit`` of the main path's lowering calls, evenly spread
    over their sizes (records x candidates), and the largest and the median
    again with their candidates tiled to B=4096."""
    order = sorted(calls, key=lambda c: len(c[0].program.rec) * c[1][1].shape[0])
    step = max(1, len(order) // limit)
    picked = order[::step][:limit]

    def tiled(call, B=4096):
        compiled, (scalars, bools, tabs) = call
        reps = -(-B // bools.shape[0])
        cut = lambda x: x.repeat(reps, *([1] * (x.dim() - 1)))[:B].contiguous()  # noqa: E731
        return compiled, (tuple(cut(x) for x in scalars), cut(bools),
                          tuple(tuple(cut(x) for x in tab) for tab in tabs))

    return picked, [tiled(order[len(order) // 2]), tiled(order[-1])]


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


# ---------------------------------------------------------------------------
# the frontier segment
# ---------------------------------------------------------------------------

LARGECODE = "largecode_contract_2400"
LARGECODE_COMPARED = 8  # of its 352 dispatches: the first 8 and the paged one
# 32-bit integer instructions a live path's step costs the kernel (decode
# and pops about 60, a 256-bit fold up to 100, the handler and the tail
# about 120, rows and event about 120): an estimate from the source, the
# operations side of the bound, at the issue rate.
FRONTIER_STEP_OPS = 400


def frontier_bytes(caps, n_loops: int, n_exec: int, forks: int) -> int:
    """Bytes one segment must move for this run's work: per live path-step
    its scalars read (15) and written (12), 8 stack words, one code-table
    row (7 int32 and 3 bool columns), the popped rows' 7 const flags and two
    values, R new rows and one event; per granted fork the parent's state
    row read and the child's written, the child's event buffer reset and the
    E_FORK event."""
    step = 4 * (15 + 12) + 4 * 8 + (7 * 4 + 3) + 7 + 2 * 64 + caps.R * (5 * 4 + 64 + 1) + 13 * 4
    row = 4 * (15 + caps.STK + 2 * caps.MEM + 2 * caps.STO + 16 + caps.CON + n_loops)
    return n_exec * step + forks * (2 * row + 4 * caps.EVT * 13 + 13 * 4)


def frontier_err(got, want) -> int:
    """Largest |difference| over every output array of two segments'
    ``outputs_to_numpy`` (a shape mismatch counts as 2^31)."""
    import numpy as np

    err = max(abs(a - b) for a, b in zip(got[2:5], want[2:5]))
    for g, w in zip([*got[0].values(), *got[1].values(), got[5]],
                    [*want[0].values(), *want[1].values(), want[5]]):
        if g.shape != w.shape:
            return 1 << 31
        if g.size:
            err = max(err, int(np.abs(g.astype(np.int64) - w.astype(np.int64)).max()))
    return err


# every launch shape of the segment kernel and its edges: one block (B <=
# 128), one cluster (B <= 1024), a cooperative grid
FRONTIER_WIDTHS = (1, 127, 129, 256, 1024, 1025, 4096)


def frontier_parity(torch, attrs, local):
    """The kernel against segment_torch, both on the card, bit-equal: every
    case of tests/_torch_frontier_cases.py at B=8, then width_case at each
    of FRONTIER_WIDTHS (two seeds at the grid's widths) and, with event
    buffers off a 16-byte boundary, at each of ODD_EVT_WIDTHS.  -> {B: the
    launch shape, with ptxas's registers, stack frame and spills and the
    SASS's LDL/STL count of its kernel}"""
    from mythril_tpu_torch.frontier import interop
    from mythril_tpu_torch.frontier import step as fstep
    from mythril_tpu_torch.ops import _build
    from tests import _torch_frontier_cases as fc

    phase("frontier parity: the segment kernel against its plain version on the card")
    named = [(f"family {f} {'concrete' if c else 'symbolic'}", fc.family_case(f, c))
             for f in sorted(fc.FAMILY_OPS) for c in (True, False)]
    named += [(f"binops {c} {i}", x) for c in (True, False) for i, x in enumerate(fc.binop_case(c))]
    named += sorted(fc.special_cases().items())
    named += [(f"random {s}", fc.random_case(s)) for s in range(12)]
    named.append(("odd shapes", fc.odd_shapes_case()))
    n_small = len(named)
    named += [(f"width {B} seed {s}", fc.width_case(B, s)) for B in FRONTIER_WIDTHS
              for s in range(2 if B > 1024 else 1)]
    # children's event buffers off a 16-byte boundary, in each launch shape
    named += [(f"width {B} EVT {fc.ODD_EVT}", fc.width_case(B, 0, evt=fc.ODD_EVT))
              for B in fc.ODD_EVT_WIDTHS]
    lib, n_exec, shapes = _build.load(), 0, {}
    for name, case in named:
        caps = case.get("caps", fc.CAPS)
        inputs = interop.inputs_from_numpy(case["state"], case["arena"], case["arena_len"],
                                           case["visited"], case["code"], case["cfg"], "cuda")
        got = interop.outputs_to_numpy(fstep.cached_segment(caps, *fc.BUCKET, device="cuda")(*inputs))
        want = interop.outputs_to_numpy(fstep.segment_torch(*inputs, caps))
        err = frontier_err(got, want)
        check(err == 0, f"frontier_segment differs from its plain version on {name} (max |err| {err})")
        n_exec += want[3]
        args, _outs, _keep = fstep.kernel_args(*inputs, caps)
        shape = fstep.launch_shape(lib, args)
        kind = "block" if shape["blocks"] == 1 else ("cluster" if shape["cluster"] else "grid")
        key = f"frontier_segment/{kind}"
        shapes.setdefault(f"B={caps.B}", {"kernel": kind, **shape, **attrs[key], **local[key],
                                          "cases": 0})["cases"] += 1
    print(f"  {len(named)} cases bit-equal ({n_small} at B=8: {len(fc.FAMILY_OPS)} families x "
          f"concrete/symbolic, binary folds, {len(fc.special_cases()) + 1} hazard cases, 12 random "
          f"batches; {len(named) - n_small} at the widths {FRONTIER_WIDTHS}, and at "
          f"{fc.ODD_EVT_WIDTHS} with EVT={fc.ODD_EVT}); {n_exec} path-steps")
    for width, info in shapes.items():
        print(f"  {width}: {info}")
    check({v["kernel"] for v in shapes.values()} == {"block", "cluster", "grid"},
          "a launch shape of the segment kernel was not held against the plain version")
    return shapes


def frontier_main_path(torch):
    """Every recorded dispatch through the engine's device interface on the
    card.  -> (launches, dispatches kept for the comparison and the times,
    transfer times)"""
    from mythril_tpu_torch.frontier import interop
    from mythril_tpu_torch.frontier import step as fstep
    from mythril_tpu_torch.frontier.arena import HostArena
    from tests.test_torch_frontier_fixture import iter_dispatches, mismatches

    t0 = phase("frontier main path: recorded dispatches through push_state -> segment -> "
               "pull_harvest -> HostArena.pull_from_device on the card")
    kept, bad, per_run = [], [], collections.defaultdict(lambda: collections.Counter())
    push_ms, pull_ms, arena_ms = [], [], []
    zero_launches()
    for name, i, d in iter_dispatches():
        caps = d["caps"]
        host = HostArena(caps.ARENA)
        for col, src in zip(host.device_arrays(), d["arena"]):
            col[:] = src
        host.length = d["arena_len"]
        dev_arena = interop.arena_to_torch(d["arena"], "cuda")
        visited = interop.visited_to_torch(d["visited"], "cuda")
        code = interop.code_to_torch(d["code"], "cuda")
        segment = fstep.cached_segment(caps, *d["bucket"])  # no device: the card
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        st_dev = fstep.push_state(d["state"])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out = segment(st_dev, dev_arena, d["arena_len"], visited, code, fstep.CfgScalars(*d["cfg"]))
        st_host, new_len, n_exec, max_live = fstep.pull_harvest(out[0], out[2], out[3], out[4])
        t3 = time.perf_counter()
        host.pull_from_device(out[1], new_len)
        t4 = time.perf_counter()
        push_ms.append((t2 - t1) * 1e3)
        pull_ms.append((t3 - t2) * 1e3)
        arena_ms.append((t4 - t3) * 1e3)
        miss = mismatches(interop.output_digests((st_host, host, new_len, n_exec, max_live, out[5])),
                          d["digests"])
        if miss:
            bad.append((name, i, miss[:4]))
        r = per_run[name]
        r["dispatches"] += 1
        r["path_steps"] += n_exec
        r["max_live"] = max(r["max_live"], max_live)
        r["live_in"] = max(r["live_in"], int(((d["state"].halt == 0) & (d["state"].seed >= 0)).sum()))
        r["rows_in"] += d["arena_len"]
        r["rows_out"] += new_len
        r["width"] = caps.B
        if name != LARGECODE or i < LARGECODE_COMPARED or int(d["code"][10].max()) > 0:
            kept.append((name, i, d))
    launches = read_launches()
    n = sum(r["dispatches"] for r in per_run.values())
    print(f"  {n} dispatches in {time.perf_counter() - t0:.1f} s; mismatches with the JAX digests: "
          f"{len(bad)} {bad[:3]}")
    for name, r in per_run.items():
        print(f"  {name}: {dict(r)}")
    print(f"  launches {launches}; push_state {statistics.median(push_ms):.3f} ms median "
          f"({sum(push_ms):.1f} in all), segment + pull_harvest {statistics.median(pull_ms):.3f} ms "
          f"median, arena pull {statistics.median(arena_ms):.3f} ms median (host clock)")
    check(not bad, f"{len(bad)} frontier dispatches differ from the JAX digests")
    check(launches["frontier_segment"] == n, "the frontier main path did not launch the kernel "
          "once per dispatch")
    transfers = {"dispatches": n, "per_run": {k: dict(v) for k, v in per_run.items()},
                 "push_state_ms_median": statistics.median(push_ms),
                 "segment_and_pull_harvest_ms_median": statistics.median(pull_ms),
                 "arena_pull_ms_median": statistics.median(arena_ms),
                 "push_state_ms_total": sum(push_ms), "arena_pull_ms_total": sum(arena_ms)}
    return launches, kept, transfers


def time_frontier(torch, kept, reps: int = 5):
    """Per kept dispatch: the kernel against the plain version on the card
    (bit-equal), ``ms`` (the kernel's launch alone, fresh copies of the
    inputs made outside the event pair), ``wrapper_ms`` (the whole
    ``segment_cuda`` call: copies of the inputs, scratch, launch),
    ``plain_ms`` (one ``segment_torch`` call), ``pull_ms`` (``pull_harvest``),
    the bound and path-steps per second."""
    import ctypes

    from mythril_tpu_torch.frontier import interop
    from mythril_tpu_torch.frontier import step as fstep
    from mythril_tpu_torch.ops import _build

    lib = _build.load()
    rows = []
    for name, i, d in kept:
        caps = d["caps"]
        inputs = interop.inputs_from_numpy(d["state"], d["arena"], d["arena_len"], d["visited"],
                                           d["code"], d["cfg"], "cuda")
        out = fstep.segment_cuda(*inputs, caps)
        got = interop.outputs_to_numpy(out)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        plain = fstep.segment_torch(*inputs, caps)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        err = frontier_err(got, interop.outputs_to_numpy(plain))
        timer, stream = LaunchTimer(torch), torch.cuda.current_stream().cuda_stream
        for _ in range(reps):
            args, _outs, _keep = fstep.kernel_args(*inputs, caps)
            timer(lambda: _build.check(lib.mk_frontier_segment(ctypes.byref(args), stream),
                                       "frontier_segment"))
        ms = timer.total_ms() / reps
        wrapper = cuda_ms(lambda: fstep.segment_cuda(*inputs, caps), reps)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fstep.pull_harvest(out[0], out[2], out[3], out[4])
        pull = (time.perf_counter() - t0) * 1e3
        n_exec = got[3]
        forks = int(((d["state"].seed < 0) & (got[0]["seed"] >= 0)).sum())
        b_ms, b_by = bound(frontier_bytes(caps, d["state"].loops.shape[1], n_exec, forks), 0,
                           FRONTIER_STEP_OPS * n_exec)
        rows.append({"ms": ms, "wrapper_ms": wrapper, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "err": err, "pull_harvest_ms": pull, "forks": forks,
                     "n_exec": n_exec, "path_steps_per_s": n_exec / (ms / 1e3),
                     "shape": f"{name}#{i} B={caps.B} n_exec={n_exec}"})
        print(f"  {rows[-1]['shape']}: kernel {ms:.4f} ms ({rows[-1]['path_steps_per_s']:.3g} "
              f"path-steps/s), wrapper {wrapper:.4f} ms, plain {plain_ms:.1f} ms, bound "
              f"{b_ms:.6f} ms by {b_by}, pull_harvest {pull:.3f} ms, {forks} forks")
    return rows


class EngineSplit:
    """Where one analysis' wall time goes: wrappers installed around the
    frontier engine's device interface and the walker for the duration of
    a run.  ``kernel_ms``: CUDA events around each launch of the segment
    kernel; ``segment_s``: the whole segment call (input copies, scratch,
    launch) up to the kernel's completion; ``push_s``, ``pull_s``,
    ``arena_s``: ``push_state``, ``pull_harvest`` and
    ``HostArena.pull_from_device``; ``replay_s``: the walker's replay and
    commit, which includes the issue confirmations solved inside the replay;
    ``solver_s``: ``SolverStatistics.solver_time`` plus the time of the
    issue confirmations' ``Optimize.check`` calls (their CDCL sessions) and
    of the transaction-end CDCL gate (``potential_issues._gate_issues``)
    that it does not already count, and ``solver_in_replay_s`` the part of
    it inside the replay;
    ``tape_calls`` and ``lowering_calls``: tape VM and lowering evaluations
    on the card.  Host clocks except ``kernel_ms``."""

    def __init__(self, torch):
        self.torch = torch
        self.t = collections.Counter()
        self.events, self.tape_calls, self.lowering_calls = [], 0, 0
        self.in_replay = False

    def __enter__(self):
        from mythril_tpu_torch.analysis import potential_issues as PI
        from mythril_tpu_torch.frontier import engine as E
        from mythril_tpu_torch.frontier.arena import HostArena
        from mythril_tpu_torch.frontier.walker import Walker
        from mythril_tpu_torch.ops import _build, lowering, tape_vm
        from mythril_tpu_torch.smt.solver import Optimize, SolverStatistics

        torch, t = self.torch, self.t
        lib = _build.load()
        self._saved = [(PI, "_gate_issues", PI._gate_issues), (Optimize, "check", Optimize.check),
                       (E, "push_state", E.push_state), (E, "pull_harvest", E.pull_harvest),
                       (E, "cached_segment", E.cached_segment),
                       (HostArena, "pull_from_device", HostArena.pull_from_device),
                       (Walker, "replay", Walker.replay), (Walker, "commit", Walker.commit),
                       (tape_vm, "_run_tape_cuda", tape_vm._run_tape_cuda),
                       (lowering, "_run_lowering_cuda", lowering._run_lowering_cuda),
                       (lib, "mk_frontier_segment", lib.mk_frontier_segment)]
        saved = {(id(o), n): f for o, n, f in self._saved}

        def timed(obj, name, key, sync=False):
            fn = saved[(id(obj), name)]

            def wrapper(*a, **kw):
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                if sync:
                    torch.cuda.synchronize()
                t[key] += time.perf_counter() - t0
                return out

            return wrapper

        def cached_segment(*a, **kw):
            segment = saved[(id(E), "cached_segment")](*a, **kw)

            def timed_segment(*args):
                t0 = time.perf_counter()
                out = segment(*args)
                torch.cuda.synchronize()
                t["segment_s"] += time.perf_counter() - t0
                return out

            return timed_segment

        def launch(*a):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            rc = saved[(id(lib), "mk_frontier_segment")](*a)
            end.record()
            self.events.append((start, end))
            return rc

        def replay(walker, rec):
            stats = SolverStatistics()
            s0, t0, self.in_replay = stats.solver_time, time.perf_counter(), True
            try:
                return saved[(id(Walker), "replay")](walker, rec)
            finally:
                self.in_replay = False
                t["replay_s"] += time.perf_counter() - t0
                t["solver_in_replay_s"] += stats.solver_time - s0

        def outside_solver_time(obj, name):
            # the call's time less the solver_time it already adds
            fn = saved[(id(obj), name)]

            def wrapper(*a, **kw):
                stats = SolverStatistics()
                s0, t0 = stats.solver_time, time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    extra = time.perf_counter() - t0 - (stats.solver_time - s0)
                    t["confirm_extra_s"] += extra
                    if self.in_replay:
                        t["solver_in_replay_s"] += extra

            return wrapper

        def tape(*a, **kw):
            self.tape_calls += 1
            return saved[(id(tape_vm), "_run_tape_cuda")](*a, **kw)

        def lower(*a, **kw):
            self.lowering_calls += 1
            return saved[(id(lowering), "_run_lowering_cuda")](*a, **kw)

        PI._gate_issues = outside_solver_time(PI, "_gate_issues")
        Optimize.check = outside_solver_time(Optimize, "check")
        E.push_state = timed(E, "push_state", "push_s", sync=True)
        E.pull_harvest = timed(E, "pull_harvest", "pull_s")
        E.cached_segment = cached_segment
        HostArena.pull_from_device = timed(HostArena, "pull_from_device", "arena_s")
        Walker.replay = replay
        Walker.commit = timed(Walker, "commit", "replay_s")
        tape_vm._run_tape_cuda = tape
        lowering._run_lowering_cuda = lower
        lib.mk_frontier_segment = launch
        return self

    def __exit__(self, *exc):
        for obj, name, fn in self._saved:
            setattr(obj, name, fn)
        return False

    def kernel_ms(self) -> float:
        self.torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events)


@contextlib.contextmanager
def keeping_keccak(states: list):
    """The states of the first KECCAK_KEPT ``keccak_f1600`` calls made inside
    the block go to ``states`` (for timing the kernel at their shapes)."""
    from mythril_tpu_torch.ops import keccak_cuda

    permute = keccak_cuda.keccak_f1600

    def record(state):
        if len(states) < KECCAK_KEPT:
            states.append(state.clone())
        return permute(state)

    keccak_cuda.keccak_f1600 = record
    try:
        yield
    finally:
        keccak_cuda.keccak_f1600 = permute


def engine_runs(torch, cdcl: bool = False, tiers: bool = False, cdcl_walls=None):
    """The port's analysis (``SymExecWrapper`` + ``fire_lasers``, no device
    argument: the card) on every run of ``tests/testdata/torch_engine_runs.json``
    with the port's native CDCL off, of ``torch_engine_runs_cdcl.json``
    with it on (``cdcl``), or of ``torch_engine_runs_tiers.json`` with CDCL,
    the prefilter and the devsolver on (``tiers``), each held against the
    JAX package's recorded run:
    issue keys, step counts, fixed selectors; for the frontier every
    dispatch's input and output digests, one segment launch per dispatch, no
    replay or commit error; the tape VM evaluated on the card once per
    solver device dispatch; under CDCL the bench contracts' keys equal to
    the JAX package's default-tier keys; under the tiers their counters, and
    one ``known_bits`` and ``dpll`` launch per host-twin call of the JAX
    package, more than none on the bench contracts.  Counts zeroed before
    each run and read after.  ``cdcl_walls``: {run label: wall under CDCL
    alone}, printed beside the tiers' walls.  -> (summed launches, per-run
    rows)"""
    from mythril_tpu_torch.smt.solver import SolverStatistics
    from tests import test_torch_engine_cdcl, test_torch_engine_fixture, test_torch_engine_tiers

    fixture = (test_torch_engine_tiers if tiers else
               test_torch_engine_cdcl if cdcl else test_torch_engine_fixture)
    check_run = (test_torch_engine_tiers.check_run if tiers else
                 test_torch_engine_fixture.check_run)
    cdcl = cdcl or tiers
    if tiers:
        phase("engine under the default solver tiers: the port's analysis on the card "
              "against the recorded JAX runs with CDCL, prefilter and devsolver on")
    elif cdcl:
        phase("engine under native CDCL: the port's analysis on the card against the "
              "recorded JAX runs with CDCL on")
    else:
        phase("engine: the port's analysis on the card against the recorded JAX runs")
    total, rows = collections.Counter(), []
    for run in fixture.load_runs():
        label = f"{run['name']} ({'frontier' if run['frontier'] else 'host engine'})"
        zero_launches()
        with EngineSplit(torch) as split:
            got = fixture.run_port(run, None)  # no device: the card
            torch.cuda.synchronize()
        launches = read_launches()
        total.update(launches)
        bad = check_run(run, got)
        stats = SolverStatistics().as_dict()
        wall, f = got["seconds"], got["frontier"]
        t = split.t
        solver_s = stats["solver_time"] + t["confirm_extra_s"]
        solver_out = solver_s - t["solver_in_replay_s"]
        row = {
            "run": label, "wall_s": wall, "jax_cpu_s": run["jax_cpu_seconds"],
            "issues": len(got["summary"]), "dispatches": len(got["dispatches"]),
            "path_steps": f["device_instructions"], "launches": launches,
            "tape_calls": split.tape_calls, "lowering_calls": split.lowering_calls,
            "device_dispatches": stats["device_dispatches"],
            "kernel_ms": split.kernel_ms(), "segment_s": t["segment_s"], "push_s": t["push_s"],
            "pull_s": t["pull_s"], "arena_s": t["arena_s"], "replay_s": t["replay_s"],
            "solver_s": solver_s, "solver_in_replay_s": t["solver_in_replay_s"],
            "cdcl": got["cdcl"], "held_exactly": not bad, "parks": f["parks_by_reason"],
        }
        if tiers:
            row.update(tiers=got["tiers"], cdcl_only_wall_s=(cdcl_walls or {}).get(label))
        row["rest_s"] = wall - (t["segment_s"] + t["push_s"] + t["pull_s"] + t["arena_s"]
                                + t["replay_s"] + solver_out)
        if f["device_instructions"]:
            row["path_steps_per_s"] = f["device_instructions"] / wall
            row["path_steps_per_kernel_s"] = f["device_instructions"] / max(row["kernel_ms"] / 1e3, 1e-9)
        rows.append(row)
        print(f"  {label}: {wall:.2f} s (JAX on the CPU {run['jax_cpu_seconds']:.1f} s); "
              f"{row['issues']} issues; {row['dispatches']} dispatches, "
              f"{row['path_steps']} path-steps; launches {launches}; tape calls "
              f"{split.tape_calls} and lowering calls {split.lowering_calls} (lowering launches "
              f"{launches['lowering']}) for {stats['device_dispatches']} solver device "
              f"dispatches")
        print(f"    split: kernel {row['kernel_ms']:.3f} ms, segment call {t['segment_s']:.4f} s, "
              f"push_state {t['push_s']:.4f} s, pull_harvest {t['pull_s']:.4f} s, arena pull "
              f"{t['arena_s']:.4f} s, walker replay + commit {t['replay_s']:.3f} s (solver inside "
              f"{t['solver_in_replay_s']:.3f} s), solver {solver_s:.3f} s (outside "
              f"the replay {solver_out:.3f} s), rest of the host {row['rest_s']:.3f} s"
              + (f"; {row['path_steps_per_s']:.4g} path-steps/s of wall, "
                 f"{row['path_steps_per_kernel_s']:.4g} of kernel" if f["device_instructions"] else ""))
        if cdcl:
            print(f"    native CDCL: cdcl_calls {got['cdcl']['cdcl_calls']} (JAX "
                  f"{run['cdcl']['cdcl_calls']}), {got['cdcl']['calls']} solves in "
                  f"{got['cdcl']['seconds']:.3f} s, {got['cdcl']['timeouts']} timeouts (JAX "
                  f"{run['cdcl']['timeouts']})")
        if tiers:
            print(f"    tiers {got['tiers']}; known_bits launches {launches['known_bits']} "
                  f"(JAX host-twin calls {run['kb_passes']}), dpll launches "
                  f"{launches['dpll']} (JAX {run['dpll_planes']}); wall {wall:.3f} s beside "
                  f"{row['cdcl_only_wall_s']} s under CDCL alone")
        else:
            print(f"    JAX default tiers {run['default_tiers_keys']}; port "
                  f"{[r[:5] for r in got['summary']]}")
        # a run whose JAX recording had CDCL answers cut by their wall-clock
        # budget cannot be held exactly: this host may answer them
        timeouts = run["cdcl"]["timeouts"] if cdcl else 0
        if timeouts and bad:
            print(f"    not held exactly ({timeouts} CDCL timeouts in the JAX recording): {bad[:3]}")
        else:
            check(not bad, f"{label}: differs from the recorded JAX run: {bad[:3]}")
        if cdcl and not tiers and run["name"] in test_torch_engine_cdcl.BENCH:
            check(test_torch_engine_cdcl.default_keys_match(run, got["summary"]),
                  f"{label}: the issue keys differ from the JAX package's default tiers")
        if tiers:
            check((launches["known_bits"], launches["dpll"]) == (run["kb_passes"],
                                                                  run["dpll_planes"]),
                  f"{label}: launches {launches} for the JAX package's {run['kb_passes']} "
                  f"known-bits passes and {run['dpll_planes']} DPLL planes")
            if run["name"] in test_torch_engine_tiers.BENCH:
                check(launches["known_bits"] > 0 and launches["dpll"] > 0,
                      f"{label}: the tiers launched no kernel")
        if run["frontier"]:
            check(launches["frontier_segment"] == len(got["dispatches"]),
                  f"{label}: {launches['frontier_segment']} segment launches for "
                  f"{len(got['dispatches'])} dispatches")
        check(split.tape_calls + split.lowering_calls == stats["device_dispatches"],
              f"{label}: {split.tape_calls} tape and {split.lowering_calls} lowering "
              f"evaluations on the card for {stats['device_dispatches']} solver device "
              "dispatches")
        check(launches["tape_vm"] >= split.tape_calls, f"{label}: tape calls without a launch")
        check(launches["lowering"] >= split.lowering_calls,
              f"{label}: lowering calls without a launch")
    return dict(total), rows


def engine_idle_share(torch, name: str = "bectoken_like", cdcl: bool = False,
                      tiers: bool = False):
    """One frontier run of an engine phase again under ``torch.profiler``:
    the card's busy time over the run's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tests import test_torch_engine_cdcl, test_torch_engine_fixture, test_torch_engine_tiers

    fixture = (test_torch_engine_tiers if tiers else
               test_torch_engine_cdcl if cdcl else test_torch_engine_fixture)
    under = " under the default solver tiers" if tiers else " under native CDCL" if cdcl else ""
    phase(f"engine idle share{under}: {name} (frontier) under torch.profiler")
    run = next(r for r in fixture.load_runs() if r["name"] == name and r["frontier"])
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            got = fixture.run_port(run, None, record=False)
            torch.cuda.synchronize()
        device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    except Exception as e:  # a measurement only: the run itself was checked above
        print(f"  not measured: {type(e).__name__}: {e}")
        return None
    if not device:
        print("  not measured: the profiler recorded no device time")
        return None
    wall_ms = got["seconds"] * 1e3
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:6]
    print(f"  wall {wall_ms:.1f} ms (profiled), device busy {busy_ms:.3f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.6f}; by kernel: "
          + ", ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}" for e in top))
    return {"run": name, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms}


def wrapper_seconds(torch, argv) -> float:
    """``SymExecWrapper`` + ``fire_lasers`` alone on a command line's contract
    with its parameters (the CLI's address, strategy, transactions and
    frontier), on the card, caches cleared first as for the CLI: the same
    analysis without the CLI and the facade."""
    from mythril_tpu_torch.analysis.security import fire_lasers
    from mythril_tpu_torch.analysis.symbolic import SymExecWrapper
    from mythril_tpu_torch.core import cfg
    from mythril_tpu_torch.frontend.evmcontract import EVMContract
    from mythril_tpu_torch.interfaces import cli
    from mythril_tpu_torch.support.support_args import args
    from tests._torch_parity import _reset

    p = cli.create_parser().parse_args(argv)
    saved = (args.frontier, args.frontier_force, args.frontier_width, args.prefilter,
             args.devsolver)
    (args.frontier, args.frontier_force, args.frontier_width, args.prefilter,
     args.devsolver) = (p.frontier, p.frontier_force, p.frontier_width, p.prefilter, p.devsolver)
    _reset("mythril_tpu_torch")
    cfg.gbl_next_uid[0] = 0
    try:
        t0 = time.perf_counter()
        sym = SymExecWrapper(EVMContract(code=p.code.replace("0x", ""), name="MAIN"),
                             "0x" + "0" * 38 + "06", strategy=p.strategy,
                             transaction_count=p.transaction_count)
        fire_lasers(sym)
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    finally:
        (args.frontier, args.frontier_force, args.frontier_width, args.prefilter,
         args.devsolver) = saved


def cli_runs(torch, card: str, engine_rows: list, tier_rows: list):
    """Phase 8c (see the module docstring); ``engine_rows`` and ``tier_rows``
    are phase 8b's and 8d's -> (summed launches, per-run rows)."""
    import os
    import tempfile

    from mythril_tpu_torch.frontier import step as fstep
    from mythril_tpu_torch.frontier.stats import FrontierStatistics
    from mythril_tpu_torch.smt.solver import SolverStatistics
    from tests import test_torch_cli as T

    phase("command line: the port's CLI on the card against the recorded JAX CLI")
    os.environ["MYTHRIL_DIR"] = tempfile.mkdtemp(prefix="mythril-")
    walls = {r["run"]: r["wall_s"] for r in engine_rows}
    tier_walls = {r["run"]: r["wall_s"] for r in tier_rows}
    runs = T.load_runs()
    total, rows = collections.Counter(), []
    for name in T.BENCH:
        run = runs[name]
        argv = T.port_argv(run)
        zero_launches()
        with EngineSplit(torch) as split:
            t0 = time.perf_counter()
            rc, out = T.run_port(argv, device=None)  # no --device: the card
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = read_launches()
        total.update(launches)
        stats, segments = SolverStatistics(), FrontierStatistics().segments
        evals, dispatches = split.tape_calls + split.lowering_calls, stats.device_dispatches
        check(rc == 0, f"{name}: the CLI exited {rc}")
        diffs = T.differences("jsonv2", run["stdout"], out)
        check(not diffs, f"{name}: the port's report differs from the JAX CLI's: {diffs[:3]}")
        check(launches["frontier_segment"] == segments > 0,
              f"{name}: {launches['frontier_segment']} segment launches for {segments} segments")
        check(evals == dispatches,
              f"{name}: {evals} tape and lowering evaluations on the card for "
              f"{dispatches} solver device dispatches")
        check(launches["tape_vm"] >= split.tape_calls, f"{name}: tape calls without a launch")
        check(launches["lowering"] >= split.lowering_calls,
              f"{name}: lowering calls without a launch")
        tiers_on = "--no-prefilter" not in argv
        check((launches["known_bits"] > 0 and launches["dpll"] > 0) == tiers_on,
              f"{name}: launches {launches} with the prefilter and devsolver "
              f"{'on' if tiers_on else 'off'}")
        if tiers_on:
            diffs = T.tier_counter_differences(run)
            check(not diffs, f"{name}: the tier counters differ from the JAX report's: {diffs}")
        # the same analysis with and without the CLI and facade, in turns
        w1 = wrapper_seconds(torch, argv)
        w2 = wrapper_seconds(torch, argv)
        t0 = time.perf_counter()
        T.run_port(argv, device=None)
        torch.cuda.synchronize()
        cli2 = time.perf_counter() - t0
        engine = (tier_walls if tiers_on else walls).get(f"{name.split('/')[0]} (frontier)")
        row = {"run": name, "cli_wall_s": [wall, cli2], "wrapper_wall_s": [w1, w2],
               "overhead_s": (wall + cli2 - w1 - w2) / 2, "engine_phase_wall_s": engine,
               "jax_cli_cpu_s": run["jax_cpu_seconds"], "launches": launches,
               "segments": segments, "tape_calls": split.tape_calls,
               "lowering_calls": split.lowering_calls, "device_dispatches": dispatches,
               "kernel_ms": split.kernel_ms(), "card": card}
        rows.append(row)
        print(f"  {name}: CLI {wall:.3f} s (checked) and {cli2:.3f} s, SymExecWrapper + "
              f"fire_lasers alone {w1:.3f} and {w2:.3f} s (in turns: CLI, wrapper, wrapper, "
              f"CLI), overhead {row['overhead_s']:+.4f} s; engine phase's run of the contract "
              + (f"{engine:.3f} s" if engine is not None else "none") + f" ({card}); JAX CLI "
              f"on the CPU {run['jax_cpu_seconds']:.1f} s; launches {launches}, {segments} "
              f"segments, tape calls {split.tape_calls} and lowering calls "
              f"{split.lowering_calls} for {dispatches} solver device dispatches, "
              f"kernel {row['kernel_ms']:.3f} ms")

    argv = ["analyze", "-f", "tests/testdata/inputs/kill_simple.bin-runtime", "--bin-runtime",
            "-t", "1", "-m", "AccidentallyKillable", "-o", "jsonv2", "--frontier"]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "mythril_tpu_torch", *argv], cwd=str(ROOT),
                          capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    print(f"  python -m mythril_tpu_torch {' '.join(argv)}: exit {proc.returncode} in {wall:.2f} s "
          f"(the process, its imports and the kernel library's load included)")
    check(proc.returncode == 0, f"python -m mythril_tpu_torch failed: {proc.stderr[-2000:]}")
    issues = T._last_json_line(proc.stdout)[0]["issues"]
    steps = issues[0]["extra"]["testCases"][0]["steps"] if issues else []
    check(len(issues) == 1 and steps[-1]["input"].startswith("0x41c0e1b5"),
          f"python -m mythril_tpu_torch: no kill() exploit in {proc.stdout[-1000:]}")
    rows.append({"run": "python -m mythril_tpu_torch (kill_simple, 1 tx, --frontier)",
                 "cli_wall_s": wall, "card": card})

    limit = fstep.max_paths(torch.device("cuda"))
    zero_launches()
    rc, _ = T.run_port(argv[:-3] + ["-o", "json", "--frontier", "--frontier-force",
                                    "--frontier-width", str(limit + fstep.BLOCK)], device=None)
    launches = read_launches()
    print(f"  --frontier-width {limit + fstep.BLOCK} (the card holds {limit} paths, "
          f"{limit // fstep.BLOCK} blocks): exit {rc}, launches {launches}")
    check(rc == 2 and not any(launches.values()),
          "a frontier width over the card's limit was not refused before any launch")
    return dict(total), rows


def known_bits_parity(torch):
    """Phase 2b -> the recorded packs' calls (the main path's shapes) and the
    seeded ones, for the timing, each as (inputs, rows, label, pack, level
    plan)."""
    import numpy as np

    from mythril_tpu_torch.absdomain import device, domains, tape
    from tests import _torch_tier_cases as tier_cases
    from tests import test_torch_engine_tiers as T

    t0 = phase("known bits: the kernel against its plain version on the card")
    recorded, seeded, bad, routes = [], [], [], collections.Counter()

    def both(pack, label, into):
        inputs, plan = domains.kb_inputs(pack, "cuda"), device.pack_plan(pack)
        got = device.known_bits(*inputs, pack.n_rows, plan=plan)
        if not all(torch.equal(g, w) for g, w in zip(
                got, domains.eval_kb_plain(*inputs, pack.n_rows))):
            bad.append(label)
        smem = device.in_smem(pack.n_nodes, plan.n_levels)
        routes["shared" if smem else "global"] += 1
        into.append((inputs, pack.n_rows, label, pack, plan))
        return got, smem

    for rec in T.load_kernels()["kb"]:
        pack = T.kb_pack(rec)
        got, smem = both(pack, f"N={pack.n_nodes} R={pack.n_rows}", recorded)
        digest = T.kb_digest(got[0].cpu().numpy().view(np.uint32),
                             got[1].cpu().numpy().view(np.uint32), got[2].cpu().numpy())
        if digest != rec["digest"] or not smem:
            bad.append(f"{rec['run']} digest or route")
    for seed, n, r, smem in KB_SEEDED:
        pack = tier_cases.kb_pack(tier_cases.random_kb_fields(seed, n, r), tape)
        _, took = both(pack, f"N={n} R={r} (seeded)", seeded)
        if took != smem:
            bad.append(f"seeded N={n} R={r} route")
    print(f"  {len(recorded)} recorded packs (N <= {max(x[0][0].shape[0] for x in recorded)}, "
          f"R <= {max(x[1] for x in recorded)}, levels <= "
          f"{max(x[4].n_levels for x in recorded)}) and {len(seeded)} seeded in "
          f"{time.perf_counter() - t0:.1f} s; routes {dict(routes)}; mismatches {bad[:5]}")
    check(not bad, f"known_bits differs from its plain version or the recording: {bad[:5]}")
    return recorded, seeded


def dpll_parity(torch):
    """Phase 2c -> the recorded planes (the main path's shapes) and the
    seeded ones, each as (lits, dec, n_vars, max_iters, label)."""
    from mythril_tpu_torch.devsolver import device, kernel
    from tests import _torch_tier_cases as tier_cases
    from tests import test_torch_engine_tiers as T

    t0 = phase("DPLL: the kernel against its plain version on the card")
    recorded, seeded, bad, outcomes = [], [], [], collections.Counter()

    def both(plane, iters, label, into):
        lits = torch.from_numpy(plane.lits).cuda()
        dec = torch.from_numpy(plane.dec).cuda()
        got = device.dpll(lits, dec, plane.n_vars, iters)
        if not all(torch.equal(g, w) for g, w in zip(
                got, kernel.run_plain(lits, dec, plane.n_vars, iters))):
            bad.append(label)
        into.append((lits, dec, plane.n_vars, iters, label))
        return got

    for rec in T.load_kernels()["dpll"]:
        plane = T.dpll_plane(rec)
        q, c, _ = plane.lits.shape
        status, assign, _steps = both(plane, int(rec["max_iters"]),
                                      f"[{q},{c},3] V={plane.n_vars}", recorded)
        if T.dpll_digest(status.cpu().numpy(), assign.cpu().numpy()) != rec["digest"]:
            bad.append(f"{rec['run']} digest")
    for seed, q, c, v, iters in tier_cases.DPLL_SEEDED:
        plane = tier_cases.random_cnf_plane(seed, q, c, v, kernel)
        status, _assign, steps = both(plane, iters, f"[{q},{c},3] V={v} iters={iters} (seeded)",
                                      seeded)
        outcomes.update(status.tolist())
    edge = []
    for case in tier_cases.dpll_edge_cases():
        plane = kernel.Plane(case["lits"], case["dec"], case["lits"].shape[0], case["n_vars"])
        status, _assign, steps = both(plane, case["iters"], case["label"], edge)
        if case["status"] is not None and (status.tolist(), steps.tolist()) != (
                case["status"], case["steps"]):
            bad.append(f"{case['label']}: status {status.tolist()} steps {steps.tolist()}")
        outcomes.update(status.tolist())
    print(f"  {len(recorded)} recorded planes, {len(seeded)} seeded and {len(edge)} edge planes "
          f"in {time.perf_counter() - t0:.1f} s; seeded and edge outcomes {dict(outcomes)} (1 "
          f"SAT, 2 UNSAT, 3 UNKNOWN); mismatches {bad[:5]}")
    check(not bad, f"dpll differs from its plain version or the recording: {bad[:5]}")
    check(set(outcomes) == {kernel.SAT_Q, kernel.UNSAT_Q, kernel.UNKNOWN_Q},
          f"the seeded planes miss an outcome: {dict(outcomes)}")
    return recorded, seeded


def time_known_bits(torch, calls, reps: int = 10):
    """Per call: the launch alone (``ms``), the ``known_bits`` wrapper given
    the level plan (``wrapper_ms``), the prefilter's whole pass ``run_kb``
    (``run_kb_ms``, host clock: the inputs packed and uploaded, the plan
    built and uploaded, the launch, the three downloads) and its parts
    (``inputs_ms``: ``kb_inputs``; ``plan_ms``: ``pack_plan``;
    ``download_ms``: km, kv and refuted to the host), the plain version, and
    the bound: the function's inputs read and km, kv and refuted written
    once (not the level plan, the kernel's own schedule), ``KB_NODE_OPS``
    per node and row."""
    import ctypes

    from mythril_tpu_torch.absdomain import device, domains
    from mythril_tpu_torch.ops import _build

    def host_ms(fn, n: int) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    lib = _build.load()
    rows = []
    for inputs, r, label, pack, plan in calls:
        n = inputs[0].shape[0]
        km = torch.empty((n, r, 16), dtype=torch.int32, device="cuda")
        kv, refuted = torch.empty_like(km), torch.zeros(r, dtype=torch.bool, device="cuda")
        zero = torch.zeros(16, dtype=torch.int32, device="cuda")
        plan_t = torch.from_numpy(plan.packed()).cuda()
        args = device.kb_args(*inputs, zero, plan_t, plan.n_levels, km, kv, refuted)
        stream = torch.cuda.current_stream().cuda_stream
        timer = LaunchTimer(torch)
        for _ in range(reps):
            timer(lambda: _build.check(lib.mk_known_bits(ctypes.byref(args), stream),
                                       "known_bits"))
        ms = timer.total_ms() / reps
        want = domains.eval_kb_plain(*inputs, r)
        err = 0 if all(torch.equal(g, w) for g, w in zip((km, kv, refuted), want)) else 1
        wrapper = cuda_ms(lambda: device.known_bits(*inputs, r, plan=plan), reps)
        device.run_kb(pack, "cuda")
        run_kb = host_ms(lambda: device.run_kb(pack, "cuda"), reps)
        parts = {"inputs_ms": host_ms(lambda: domains.kb_inputs(pack, "cuda"), reps),
                 "plan_ms": host_ms(lambda: device.pack_plan(pack), reps),
                 "download_ms": host_ms(lambda: (km.cpu(), kv.cpu(), refuted.cpu()), reps)}
        plain = cuda_ms(lambda: domains.eval_kb_plain(*inputs, r), 1)
        n_bytes = sum(x.numel() * 4 for x in inputs) + 2 * km.numel() * 4 + r
        b_ms, b_by = bound(n_bytes, n * r * KB_NODE_OPS)
        rows.append({"ms": ms, "wrapper_ms": wrapper, "run_kb_ms": run_kb, **parts,
                     "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by, "err": err,
                     "shape": f"{label} {plan.n_levels} levels",
                     "values": "shared" if device.in_smem(n, plan.n_levels) else "global"})
    return rows


def time_dpll(torch, calls, reps: int = 5):
    """Per call: the launch alone, microseconds a step (over the longest
    query's steps: the blocks run side by side), the ``dpll`` wrapper, the
    devsolver's whole call ``run_device`` (host clock: the plane uploaded
    from numpy, the launch, the results downloaded), the plain version, and
    the bound: the plane read and status, assignment and steps written once;
    ``DPLL_CLAUSE_OPS`` per real clause (one that can be false: not the
    padding, no literal 1 or 2) and ``DPLL_WORD_OPS`` per bitset word for
    each step each query took (the kernel's steps)."""
    import ctypes

    from mythril_tpu_torch.devsolver import device, kernel
    from mythril_tpu_torch.ops import _build

    lib = _build.load()
    rows = []
    for lits, dec, n_vars, iters, label in calls:
        q, c = lits.shape[0], lits.shape[1]
        status = torch.empty(q, dtype=torch.int8, device="cuda")
        assign = torch.empty((q, n_vars), dtype=torch.int8, device="cuda")
        steps = torch.empty(q, dtype=torch.int32, device="cuda")
        args = device.dpll_args(lits, dec, status, assign, steps, n_vars, iters)
        stream = torch.cuda.current_stream().cuda_stream
        timer = LaunchTimer(torch)
        for _ in range(reps):
            timer(lambda: _build.check(lib.mk_dpll(ctypes.byref(args), stream), "dpll"))
        ms = timer.total_ms() / reps
        want = kernel.run_plain(lits, dec, n_vars, iters)
        err = 0 if all(torch.equal(g, w) for g, w in zip((status, assign, steps), want)) else 1
        wrapper = cuda_ms(lambda: device.dpll(lits, dec, n_vars, iters), reps)
        plane = kernel.Plane(lits.cpu().numpy(), dec.cpu().numpy(), q, n_vars)
        device.run_device(plane, iters, "cuda")
        t0 = time.perf_counter()
        for _ in range(reps):
            device.run_device(plane, iters, "cuda")
        run_device = (time.perf_counter() - t0) * 1e3 / reps
        plain = cuda_ms(lambda: kernel.run_plain(lits, dec, n_vars, iters), 1)
        real = (~((lits == 1) | (lits == 2)).any(dim=2)).sum(dim=1)
        n_steps, longest = int(steps.sum()), int(steps.max())
        n_bytes = (lits.numel() + dec.numel()) * 4 + q + q * n_vars + 4 * q
        b_ms, b_by = bound(n_bytes, 0, int((steps.long() * (
            real * DPLL_CLAUSE_OPS + (n_vars + 31) // 32 * DPLL_WORD_OPS)).sum()))
        rows.append({"ms": ms, "us_per_step": ms * 1e3 / max(1, longest), "wrapper_ms": wrapper,
                     "run_device_ms": run_device, "plain_ms": plain, "bound_ms": b_ms,
                     "bound_by": b_by, "bound_counts": "real clauses (not padding, no literal "
                     "1 or 2) over each query's own steps", "err": err, "steps": n_steps,
                     "real_clauses": int(real.sum()), "block": device.block_threads(c),
                     "smem_bytes": int(lib.mk_dpll_smem_bytes(c, n_vars)),
                     "shape": f"{label} steps={n_steps}"})
    return rows


def native_library():
    """Build the port's native CDCL library (g++) and load it; the CDCL
    phase fails without it rather than run without the exact tier."""
    from mythril_tpu_torch.native import bitblast, build

    t0 = phase("native CDCL library (g++)")
    path = build.library_path()
    check(bitblast.available(), f"the native CDCL library did not build or load ({path})")
    print(f"  {path} in {time.perf_counter() - t0:.1f} s")


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
    # every analysis of the engine phase loads the same plugins into the
    # loader's registry again; its notice says so once per plugin and run
    logging.getLogger("mythril_tpu_torch.plugins.loader").setLevel(logging.ERROR)
    t_start = time.perf_counter()
    try:
        phase("card")
        card = card_line()
        print(card)
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
        attrs = build_kernels()
        native_library()
        kb_recorded, kb_seeded = known_bits_parity(torch)
        dpll_recorded, dpll_seeded = dpll_parity(torch)
        sass, local = sass_per_round()
        keccak_parity(torch)
        tape_parity(torch)
        lowering_parity(torch)
        f_shapes = frontier_parity(torch, attrs, local)
        launches, tape_calls, lowering_calls, probe = main_path(torch)
        f_launches, f_kept, transfers = frontier_main_path(torch)
        keccak_calls = []
        with keeping_keccak(keccak_calls):  # the tapes' keccak steps
            e_launches, e_rows = engine_runs(torch)
        for name in ("tape_vm", "keccak_f1600", "frontier_segment"):
            check(e_launches[name] > 0, f"the engine's runs launched {name} no time")
        e_idle = engine_idle_share(torch)
        c_launches, c_rows = engine_runs(torch, cdcl=True)
        for name in ("tape_vm", "keccak_f1600", "frontier_segment"):
            check(c_launches[name] > 0, f"the engine's CDCL runs launched {name} no time")
        # etherstore, not bectoken: bectoken's CDCL run repeated takes two minutes
        c_idle = engine_idle_share(torch, "etherstore_like", cdcl=True)
        t_launches, t_rows = engine_runs(torch, tiers=True,
                                         cdcl_walls={r["run"]: r["wall_s"] for r in c_rows})
        for name in ("tape_vm", "frontier_segment", "known_bits", "dpll"):
            check(t_launches[name] > 0, f"the engine's tier runs launched {name} no time")
        t_idle = engine_idle_share(torch, "rubixi_like", tiers=True)
        cli_launches, cli_rows = cli_runs(torch, card, c_rows, t_rows)
        for name in ("tape_vm", "keccak_f1600", "frontier_segment", "known_bits", "dpll"):
            check(cli_launches[name] > 0, f"the command line's runs launched {name} no time")
        phase("kernel times at the main path's shapes (CUDA events)")
        keccak = summarize("keccak_f1600", time_keccak(torch, keccak_calls),
                           e_launches["keccak_f1600"], card, route="cuda",
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
        phase("frontier segment times per dispatch (CUDA events)")
        f_rows = time_frontier(torch, f_kept)
        frontier = summarize("frontier_segment", f_rows, f_launches["frontier_segment"], card,
                             route="cuda", source="mythril_tpu_torch/csrc/frontier_segment.cu",
                             replaces="mythril_tpu/frontier/step.py:141")
        frontier.update(shapes=f_shapes, main_path=transfers, path_steps_per_s_timed=sum(r["n_exec"] for r in f_rows)
                        / (sum(r["ms"] for r in f_rows) / 1e3),
                        per_dispatch=[{k: r[k] for k in ("shape", "ms", "wrapper_ms", "plain_ms",
                                                         "bound_ms", "bound_by", "pull_harvest_ms",
                                                         "path_steps_per_s", "forks")}
                                      for r in f_rows])
        phase("lowering times at the main path's shapes (CUDA events)")
        timed, tiled = lowering_timed_calls(torch, lowering_calls)
        lower = summarize("lowering", time_lowering(torch, timed), launches["lowering"], card,
                          route="cuda", source="mythril_tpu_torch/csrc/lowering.cu",
                          replaces="mythril_tpu/ops/lowering.py:99-161")
        lower.update(attrs["lowering"], main_path=probe, calls_on_main_path=len(lowering_calls))
        phase("known_bits and dpll times at the main path's shapes (CUDA events)")
        kb_rows = time_known_bits(torch, kb_recorded)
        known_bits = summarize("known_bits", kb_rows,
                               t_launches["known_bits"], card, route="cuda",
                               source="mythril_tpu_torch/csrc/known_bits.cu",
                               replaces="mythril_tpu/absdomain/device.py:50")
        known_bits.update(attrs["known_bits/shared"], ptxas_by_values={
            k.split("/")[1]: attrs[k] for k in ("known_bits/shared", "known_bits/global")})
        kb_mid = sorted(kb_rows, key=lambda r: r["ms"])[len(kb_rows) // 2]  # summarize's
        known_bits.update({k: kb_mid[k] for k in (
            "run_kb_ms", "inputs_ms", "plan_ms", "download_ms", "values")},
            total_run_kb_ms=sum(r["run_kb_ms"] for r in kb_rows),
            per_call=[{k: r[k] for k in ("shape", "ms", "wrapper_ms", "run_kb_ms")}
                      for r in kb_rows])
        print(f"  known_bits median call: run_kb {kb_mid['run_kb_ms']:.4f} ms (kb_inputs "
              f"{kb_mid['inputs_ms']:.4f}, plan {kb_mid['plan_ms']:.4f}, downloads "
              f"{kb_mid['download_ms']:.4f} ms); {len(kb_rows)} calls: run_kb "
              f"{known_bits['total_run_kb_ms']:.3f} ms in all")
        from mythril_tpu_torch.ops import _build

        dpll_rows = time_dpll(torch, dpll_recorded)
        dpll = summarize("dpll", dpll_rows, t_launches["dpll"], card,
                         route="cuda", source="mythril_tpu_torch/csrc/dpll.cu",
                         replaces="mythril_tpu/devsolver/device.py:44")
        dpll_mid = sorted(dpll_rows, key=lambda r: r["ms"])[len(dpll_rows) // 2]  # summarize's
        dpll.update(attrs[f"dpll/{dpll_mid['block']}"], ptxas_by_block={
            k.split("/")[1]: attrs[k] for k in ("dpll/256", "dpll/1024")},
            **{k: dpll_mid[k] for k in ("us_per_step", "run_device_ms", "bound_counts")},
            total_run_device_ms=sum(r["run_device_ms"] for r in dpll_rows),
            smem_bytes_at_c_v={n: int(_build.load().mk_dpll_smem_bytes(n, n)) for n in (512, 4096)})
        print(f"  dpll median call: {dpll_mid['us_per_step']:.3f} us a step, run_device "
              f"{dpll_mid['run_device_ms']:.4f} ms; {len(dpll_rows)} calls: run_device "
              f"{dpll['total_run_device_ms']:.3f} ms in all; ptxas by block "
              f"{dpll['ptxas_by_block']}; shared memory at C = V = 512 and 4096: "
              f"{dpll['smem_bytes_at_c_v']} B")
        kernels = [keccak, tape, frontier, known_bits, dpll, lower]
        for entry in kernels:
            entry["launches_by_path"] = {
                "probe": launches[entry["name"]], "frontier": f_launches[entry["name"]],
                "engine": e_launches[entry["name"]], "engine_cdcl": c_launches[entry["name"]],
                "engine_tiers": t_launches[entry["name"]], "cli": cli_launches[entry["name"]]}
        frontier["engine"] = {"runs": e_rows, "idle_share": e_idle}
        frontier["engine_cdcl"] = {"runs": c_rows, "idle_share": c_idle}
        frontier["cli"] = {"runs": cli_rows}
        known_bits["engine_tiers"] = {"runs": t_rows, "idle_share": t_idle}
        phase("keccak layouts by N (CUDA events, launches alone)")
        keccak["by_n"] = keccak_crossover(torch)
        phase("kernel times at scale (CUDA events)")
        scaled = at_scale(torch)
        scaled.update(known_bits=time_known_bits(torch, kb_seeded, reps=5),
                      dpll=time_dpll(torch, dpll_seeded, reps=2),
                      lowering=time_lowering(torch, tiled, reps=5))
        for entry in kernels:
            rows = scaled.get(entry["name"], ())
            for r in rows if entry["name"] in ("known_bits", "dpll", "lowering") else ():
                print(f"  {entry['name']} {r['shape']}: kernel {r['ms']:.5f} ms, wrapper "
                      f"{r['wrapper_ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, bound "
                      f"{r['bound_ms']:.6f} ms by {r['bound_by']}"
                      + (f", run_kb {r['run_kb_ms']:.4f} ms, values in {r['values']} memory"
                         if "run_kb_ms" in r else "")
                      + (f", {r['us_per_step']:.4f} us a step, run_device "
                         f"{r['run_device_ms']:.4f} ms, {r['real_clauses']} real clauses"
                         if "us_per_step" in r else ""))
                check(r.get("err", 0) == 0, f"{entry['name']} {r['shape']}: kernel differs")
            if rows:
                entry["at_scale"] = [{k: r[k] for k in (
                    "shape", "ms", "wrapper_ms", "plain_ms", "bound_ms", "bound_by", "slots",
                    "block", "smem_bytes", "variants", "run_kb_ms", "values", "us_per_step",
                    "run_device_ms", "real_clauses") if k in r}
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
