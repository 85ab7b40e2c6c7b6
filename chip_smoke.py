#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card, end to end: the solver's
probe (the tape VM and the per-conjunction lowering), the device frontier
segment and the whole analysis around them,
without and with the native CDCL tier, under the solver's default
prefilter and devsolver tiers, under the default host tiers (the static
pass and the query cache), pipelined (chained segments on a stream of
their own, delta pulls, the feasibility pool and the replay workers), and
with the adaptive controller (the exploration ledger, the seed scheduler,
the park pool, the coverage target) on single analyses and on cooperative
multi-contract batches, under the default ``auto`` probe backend with its
link calibration, in concolic execution, traced, with the health
surfaces (checkpoint and resume, the heartbeat, the flight recorder, the
kernel build cache, the metrics history), and as the analysis service
(inline and pooled, over TCP, with a killed worker and a device fault),
and on a device mesh of logical shards of the card (phase 8m).
Every phase but 8h, 8i and 8l holds the port's probe backend at ``device``
where the JAX runs it replays forced ``jax`` (``tests/_torch_parity.py``
``run_analysis``, ``test_torch_cli.port_argv``) and its link calibration
as a CPU recording had it (``port_uncalibrated``: nothing measured, the
break-evens at their defaults).  Every phase before 8e holds the port with the static pass, its
interprocedural layer and the query cache off
(``tests/_torch_parity.port_no_host_tiers``, ``test_torch_cli.port_argv``),
every phase but 8f, 8g, 8l and 8c's ``python -m`` run with the synchronous
frontier loop and a serial harvest (``port_no_pipeline``, ``--no-pipeline
--harvest-workers 0``), and every phase but 8g, 8l and 8c's ``python -m``
without the adaptive controller (``port_no_adaptive``, ``--no-adaptive``),
as the JAX package ran when those runs were recorded.

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
   package with CDCL on, the port's CDCL on, but ``bectoken_like``
   (``CDCL_RUNS_LEFT_OUT``: 112 s of host CDCL, left out so that the script
   with phase 8e stays within the earlier slices' time; phase 8 still runs
   it with CDCL off); besides, the issue keys of ``etherstore_like`` and
   ``rubixi_like`` equal the JAX package's default-tier keys; per run also
   the CDCL calls, solves, seconds and timeouts.  A run whose JAX recording has CDCL answers cut by
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
8e. the engine under the default host tiers: every run of
   ``tests/testdata/torch_engine_runs_defaults.json`` (``etherstore_like``
   and ``rubixi_like`` at width 256, ``kill_simple``, KillBilly and the
   dead-code contract at 64, 2 transactions, each on the forced frontier
   and the host engine), recorded from the JAX package with the static
   pass, its interprocedural layer and the query cache on besides CDCL and
   the two solver tiers, the port's five on: the issues, every dispatch's
   digests and the frontier's, tier, ``staticpass.*`` and ``querycache.*``
   counters equal to the recording; per run the launches of every kernel,
   the events the segment shipped, the query cache's hits by tier and the
   wall, beside the same run once more with the static pass and the query
   cache off (its issues must be the same) and beside phase 8d's run of
   the contract where 8d has one; then ``python -m mythril_tpu_torch
   static -o json`` on ``kill_simple`` and on KillBilly's creation code,
   each equal to the JAX CLI's recorded report but for its wall times;
8f. the pipelined frontier: every run of
   ``tests/testdata/torch_engine_runs_pipeline.json`` (``etherstore_like``
   at widths 256 and 64 and ``rubixi_like`` at 256 with 2 transactions,
   ``kill_simple`` and the storage-gated contract at 64, ``bench``'s wide
   (1024) and largecode (256) contracts), recorded from the JAX package's
   default engine on one device (the pipeline, two feasibility workers, four
   replay workers, CDCL, the solver and host tiers; no mesh, no adaptive
   controller), run on the card pipelined and with ``--no-pipeline`` (once
   each, in that order; the four-turn timing of ``etherstore_like`` and
   ``rubixi_like`` at 256 went to keep the script inside its limit with
   phase 8l), in the same process: the issues equal to the recording's
   and to the other runs',
   ``segments_pipelined >
   0`` on every run of two or more segments and, where no path was rolled
   back, the recording's segments and dispatch-sequence counters
   (``test_torch_pipeline.check_run``), one segment launch per segment; per
   run the walls, ``segments_pipelined``,
   ``overlap_segments``, ``bubble_s``, ``overlap_s``, the delta pulls and
   their bytes beside the bytes full pulls of the same mirrors would have
   copied, the carried and corrected slots and the pool's submitted, dedup
   and rollback counts; ``etherstore_like`` at 256 in both modes under
   ``torch.profiler`` for the card's idle share; then one segment chained
   on a recorded dispatch (``etherstore_like`` and the wide contract) under
   ``torch.cuda.set_sync_debug_mode("error")``, its merged input and outputs
   equal to the plain merge and ``segment_torch`` on the CPU, its delta
   pull equal to its full pull; then the recorded ``analyze --frontier``
   command line with the pipeline on against the JAX CLI's report;
8g. the adaptive controller: every run of
   ``tests/testdata/torch_engine_runs_adaptive.json`` (``kill_simple`` and
   the storage-gated contract at 64, ``etherstore_like`` and
   ``rubixi_like`` at 256, each pipelined and with ``--no-pipeline``),
   recorded from the JAX package's default engine with the controller on,
   run on the card adaptive, then ``--no-adaptive``: the issues equal to
   the recording's in both runs, on
   ``--no-pipeline`` the exploration ledger's bitmaps, coverage and
   termination classes equal to the recording's (the segment kernel's three
   coverage planes end to end), ``partition_ok``, one segment launch per
   segment, no plan with ``--no-adaptive``; per run the two walls, the
   segments, the ``adaptive.*`` counters, the park pool's size and the
   ``dpll`` and ``known_bits`` launches beside the recording's tier
   counters; then the three cooperative batches of ``bench.py``
   ``adaptive_compare`` through the port's ``analyze_cooperative``, the
   controller on and off (``loop_tail`` also under ``coverage_target``
   90): the issue sets equal to the JAX recording's and to each other,
   resteered slots above 0 in all, none and no plan with the controller
   off, ``loop_tail``'s target latching a stop with the JAX recording's
   segments (as many as without a target, in the recording too); each
   run's wall and segments, and ``loop_tail``'s walls with and without the
   target in turns beside the JAX bench's test (fewer segments or less
   wall), which is printed and not held; then the recorded
   ``--coverage-target 90 --coverage-out`` command line on ``loop_tail``,
   its report and ledger file equal to the JAX CLI's;
8c. the command line: ``interfaces.cli.main`` in process, with no
   ``--device`` (the card), on the recorded command lines of
   ``tests/testdata/torch_cli_runs.json`` for ``etherstore_like``,
   ``rubixi_like`` and ``kill_simple`` (2 transactions, forced frontier of
   256 paths, native CDCL on, the prefilter and devsolver off as the JAX CLI
   ran) and ``etherstore_like`` again with both tiers on in both; each jsonv2 report equal to the JAX CLI's
   (``tests/test_torch_cli.py`` ``differences``), counts zeroed before each
   run and read after, and ``etherstore_like`` once more with the static
   pass and the query cache on too (both packages' defaults but the JAX
   package's pipeline, mesh, adaptive controller and harvest workers, which
   the port does not have), one segment launch per frontier segment, one tape
   or lowering evaluation on the card per solver device dispatch; per run
   the CLI's
   wall beside ``SymExecWrapper`` + ``fire_lasers`` alone on the same
   contract and parameters (once each, the CLI first), and beside the
   engine phase's run of the contract.  Then ``python -m mythril_tpu_torch analyze ... --frontier``
   on ``kill_simple`` in a process of its own, which must exit 0 with the
   ``kill()`` exploit, and a ``--frontier-width`` one block over the card's
   limit, which must be refused before any launch (phases 8d, 8e and 8f
   run before 8c, for the walls it prints);
8h. the ``auto`` probe backend: the port's link calibration reset (as the
   JAX package's calibration tests reset it) and taken on the card, the
   measured round trip printed beside five more measurements, the applied
   constants equal to the JAX package's formula recomputed here for the
   measured round trip; then the default command line (no
   ``--probe-backend``: ``auto``), calibrated, through ``cli.main`` on the
   card on ``kill_simple``, ``etherstore_like`` and ``rubixi_like`` (2
   transactions, the host engine), in turns with ``--probe-backend device``
   (auto, device, device, auto): the issue keys (SWC, title, severity,
   location, description head) equal to the JAX CLI's default-tier
   recording (``.../host/auto`` in ``torch_cli_runs.json``; on its CPU the
   JAX package's ``auto`` probes on the host), the report's ``calibration``
   block equal to the measurement, per run the walls, the launches of every
   kernel, ``device_dispatches`` and, under ``auto``, the largest DAG size x
   candidates the gate saw against the threshold;
8i. concolic execution: every case of
   ``tests/testdata/torch_concolic_runs.json`` (the JAX package's concrete
   replays and branch flips on ``bench_contracts``' ``bectoken_like``
   transfer and batchTransfer, ``etherstore_like`` deposit then withdraw
   and ``rubixi_like``) through the port on the card under ``device``: the
   concrete trace and every output equal to the recording (a case whose
   recording has CDCL answers cut by their budget, ``timeouts``, is named
   and held as under ``auto``), no segment launch, the tape VM launched;
   ``etherstore_like`` again through ``cli.main(["concolic", ...])``; every
   case again under ``auto``, calibrated: the same requested flips succeed
   and each output, replayed by the port's ``concrete_execution``, leaves
   the recorded trace at a requested JUMPI; ``etherstore_like`` with the
   frontier forced: the same output and no segment launch; per case the
   wall beside the JAX package's CPU seconds and the launches; then a real
   ``torch.OutOfMemoryError`` from the card (an allocation no card holds)
   raised inside a harvest replay, with 0 and 4 replay workers, which must
   reach the harvest's caller; over 8h and 8i, at least one query under
   ``auto`` crosses the calibrated threshold and launches a probe kernel
   (``tape_vm`` or ``lowering``);
8j. the traced path: ``python -m mythril_tpu_torch analyze``'s entry point
   (``cli.main``) on ``etherstore_like`` (2 transactions, the forced
   frontier at 256 paths, the pipelined default loop, ``--probe-backend
   device``; the command line ``etherstore_like/frontier-256/pipeline`` of
   ``torch_cli_runs.json``) with ``--trace-out`` and ``--metrics-out``, in
   turns with the same command line untraced (untraced, traced, traced,
   untraced; 8k times the two modes again beside the heartbeat): every run's issue keys equal to the JAX CLI's
   recording; in the first traced run's trace every flow ``s`` has its
   ``f``, the ``frontier.segment`` spans count the segment launches, the
   ``smt.device_probe`` spans count the solver's per-conjunction device
   dispatches (the merged batch dispatch has no span in the JAX package
   either), ``meta.device.segment_device_s.count`` counts the segment
   launches; one traced run under ``torch.profiler`` shows the
   ``frontier.segment`` and ``smt.device_probe`` ranges; one run with
   ``args.frontier_microbench`` gives ``0 < segment_compute_s <=
   dispatch_plus_link_s`` (on ``kill_simple/frontier/pipeline``, 64
   paths); the walls of both modes with their spread, the
   traced run's seconds by span name; the phase in under 60 s;
8k. the health surfaces through ``cli.main`` on 8j's command line:
   ``-t 1 --checkpoint-file F``, then ``-t 2 --resume-from F`` and ``-t 2``
   uninterrupted, whose issue keys must equal each other and the JAX CLI's
   recording, the resumed run launching the segment and the tape VM; the
   run untraced, traced (``--trace-out``) and with ``--heartbeat-out`` at
   0.05 s in turns (untraced, traced, heartbeat, heartbeat, traced,
   untraced), the walls and their spread, at least two heartbeat samples
   with the JAX runner's queue-depth keys while the runner ran; the
   synchronising calls by thread under ``set_sync_debug_mode("warn")``: none
   from the heartbeat's thread on the pipelined run, and on
   ``kill_simple/frontier/pipeline`` with ``--no-pipeline`` as many with the
   sampler at 0.01 s as with it off; ``--flight-recorder`` with SIGUSR1 sent
   at the second harvest: one bundle holding the device plane's block
   (``backend`` ``cuda``) and the heartbeat's tail, and in the same run
   ``--history-dir``, read back by ``history query`` and ``drift
   --history``; ``python -m
   mythril_tpu_torch analyze --compile-cache-dir D`` in a process of its own
   with ``D`` a fresh directory holding a copy of the built library:
   ``compilecache.hits`` 1, ``misses`` 0, no build (phase 2 prints the
   script's own first build, the miss);
8l. the analysis service on the card: ``etherstore_like``, ``rubixi_like``
   and ``kill_simple`` (``-t 2``) solo through ``cli.main`` ``analyze``;
   then ``AnalysisService`` in this process at its defaults (inline worker,
   the frontier, the interactive probe, warm-up, every default tier, the
   calibrated ``auto`` backend) answering the recorded submissions of
   ``tests/testdata/torch_service_runs.json`` (the three contracts from two
   tenants, ``etherstore_like`` first as interactive, then again as a
   duplicate, which must be deduplicated): each request's issue digests
   equal to the solo run's and the JAX service record's, the launches of
   every kernel across the batch (segment, known bits and DPLL above 0) and
   ``stats()["phases"]`` p50 and p95; then ``python -m mythril_tpu_torch
   serve --workers 2 --batch-width 1 --cache-root D`` in a process of its
   own, ``D/kernels`` holding a copy of the built library: ``health`` of the
   fresh service exits 0, the same submissions over TCP from four threads
   give the same digests, two worker pids, the fleet rollup's
   ``frontier.segment_device_s`` count above 0, each worker's
   ``compilecache.hits`` 1 with no miss and no file built; ``top --once``
   exits 0 and ``health`` exits 1 exactly when an objective breaches; a
   SIGKILL of the worker busy on a longer request (``-t 3``) errors that
   request alone with "died mid-batch", ``service.worker_restarts`` reaches
   1 and the next request is answered; SIGTERM drains ``serve`` to exit 0;
   last, a real ``torch.OutOfMemoryError`` from the card (phase 8i's
   allocation) at the frontier of an inline batch errors both of its
   requests naming it, stops the service (``fault``, submissions refused)
   and no further batch runs;
8m. the device mesh (``parallel/``) on a mesh of 4 logical shards of the
   card (``parallel.mesh.logical_shards``): first the pod contract of
   ``tests/test_torch_pod.py`` at the defaults, which on one card builds no
   mesh (``mesh_devices`` 0); then ``evaluate_batch_sharded`` of 37 seeded
   candidates on two conjunctions (one with a keccak node) equal to the
   single launch and to ``run_lowering_reference`` with one ``lowering``
   launch per shard; ``frontier_step`` on the (2, 2) mesh over a ragged
   seeded frontier equal to the plain reductions, one launch per block; the
   segment example (``frontier_example``, the port's own
   ``__graft_entry__._frontier_example``) through the partitioned segment
   (``frontier_segment_partitioned``: one launch holding the 4 logical
   shards' blocks; over several cards one launch per card) bit-identical to
   the unsharded launch, ``segment_torch`` and ``segment_partitioned_torch``,
   the two launches timed in turns; the pod contract pipelined
   on the mesh at widths 64 and 62 (every segment partitioned, none
   unsharded): the issue keys of
   ``tests/testdata/torch_pod_runs.json``, ``mesh_devices`` and
   ``pipeline.mesh_shards`` 4, four per-shard pull keys, padded slots at
   62 alone, ``segments_pipelined`` above 0; over several cards also a
   batch of twice one card's widest launch, which one card refuses, run
   partitioned and equal to ``segment_torch``, and the command line's width
   check taking it with the mesh and refusing it with ``--no-mesh``; then the mesh and
   ``--no-mesh``, each run timed (one pair on logical shards, in turns
   mesh, off, off, mesh over several cards), on the pod contract and
   ``bench.py``'s wide contract of 7 branches at 64: the recorded keys of
   each mode, and on the mesh the wide contract's rebalance
   (``rebalance_syncs`` and ``rebalanced_slots`` above 0);
   the same over every card when ``torch.cuda.device_count() > 1``, else a
   line saying they were not run; each part's time;
9. times with CUDA events: each kernel's launches alone (``ms``), the whole
   wrapper call (``wrapper_ms``) and its plain version, beside the call's
   bound, at the main paths' shapes; keccak in both layouts at every N of
   phase 3; the frontier segment per dispatch with path-steps per second and
   the ``push_state`` and ``pull_harvest`` times; the partitioned segment
   on 4 logical shards on two of those dispatches (the median, the most
   path-steps), in turns with the single launch, against both;
   ``known_bits`` and
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
import io
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


# phase 8b's recorded runs left out so that the script, with phase 8e, stays
# within the time of the earlier slices' runs: bectoken_like under CDCL
# alone took 112 s of the card's wall (the CDCL solves, on the host)
CDCL_RUNS_LEFT_OUT = ("bectoken_like",)


class SmokeFailure(Exception):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


_STARTED = time.perf_counter()


def phase(name: str) -> float:
    """Print a phase's heading with the script's seconds so far."""
    now = time.perf_counter()
    print(f"== {name} (at {now - _STARTED:.1f} s)", flush=True)
    return now


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


def cuda_once(fn):
    """``fn()``'s result and its milliseconds by CUDA events, one call: the
    plain versions' reference call is also their timing (a second and third
    call of a plain version at scale cost the script minutes)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


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
    hits, misses = _build.cache_counters()
    print(f"built {path} in {time.perf_counter() - t0:.1f} s; the kernel build cache "
          f"(compilecache): {misses.value} miss, {hits.value} hit (a checkout with no "
          "library: the first build is the miss, the load a hit)")
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
    from tests._torch_parity import port_no_cdcl, port_no_host_tiers, port_no_tiers
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
            with port_no_cdcl(), port_no_tiers(), port_no_host_tiers():
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
    fstep.partitioned_launches = 0
    lowering.launches_by_device.clear()
    kb_device.launches = dpll_device.launches = 0
    keccak_cuda.variant_launches = dict.fromkeys(keccak_cuda.VARIANTS, 0)


def read_launches() -> dict:
    from mythril_tpu_torch.absdomain import device as kb_device
    from mythril_tpu_torch.devsolver import device as dpll_device
    from mythril_tpu_torch.frontier import step as fstep
    from mythril_tpu_torch.ops import keccak_cuda, lowering, tape_vm

    return {"tape_vm": tape_vm.launches, "keccak_f1600": keccak_cuda.launches,
            "frontier_segment": fstep.launches,
            "frontier_segment_partitioned": fstep.partitioned_launches,
            "known_bits": kb_device.launches, "dpll": dpll_device.launches,
            "lowering": lowering.launches}


def idle_share(torch):
    """The main path replayed once more under ``torch.profiler``: the
    device time of every CUDA kernel and copy over the host wall time ->
    the card's idle share, or None with the reason when the profiler shows
    no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mythril_tpu_torch.smt import solver as P
    from mythril_tpu_torch.smt.serialize import from_jax_dump
    from tests._torch_parity import port_no_cdcl, port_no_host_tiers, port_no_tiers
    from tests.test_torch_fixture import load_fixture, replay

    phase("idle share: the main path under torch.profiler")
    data, roots = load_fixture(from_jax_dump)
    try:
        with port_no_cdcl(), port_no_tiers(), port_no_host_tiers(), profile(
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
        want, plain = cuda_once(lambda: lowering.run_lowering_reference(compiled, *inputs))
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
LARGECODE_COMPARED = 2  # of its 352 dispatches: the first 2 and the paged one
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


def time_partitioned(torch, kept, single_rows, devices, reps: int = 5, pick=None):
    """The partitioned segment with one block per entry of ``devices`` (the
    card repeated: logical shards, one launch holding every block; several
    cards: one launch per card) on kept dispatches: by default two, the
    median one of ``single_rows`` (``time_frontier``'s) and the one with the
    most path-steps; ``pick`` names others by their row's shape.  Per
    dispatch: bit-equality with the single launch and with
    ``segment_partitioned_torch`` (one call, its time ``plain_ms``), and
    each form timed in turns (single, partitioned, partitioned, single;
    ``ms`` the partitioned mean): on logical shards each launch alone by
    CUDA events, over cards the whole call up to every card's completion by
    the host clock.  The bound is the single launch's, the same function's
    bytes."""
    import ctypes

    from mythril_tpu_torch.frontier import interop
    from mythril_tpu_torch.frontier import step as fstep
    from mythril_tpu_torch.frontier.state import FrontierState
    from mythril_tpu_torch.ops import _build

    lib = _build.load()
    n = len(devices)
    cards = len(set(devices)) > 1
    by_shape = {r["shape"]: r for r in single_rows}
    if pick is None:
        order = sorted(single_rows, key=lambda r: r["ms"])
        pick = [order[len(order) // 2]["shape"],
                max(single_rows, key=lambda r: r["n_exec"])["shape"]]
    pick = list(dict.fromkeys(pick))

    def whole(fn):
        """ms of fn() by the host clock, every card synchronised around it."""
        for d in devices:
            torch.cuda.synchronize(d)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        for d in devices:
            torch.cuda.synchronize(d)
        return (time.perf_counter() - t0) * 1e3 / reps

    rows = []
    for name, i, d in kept:
        caps = d["caps"]
        shape = next((s for s in pick if s.startswith(f"{name}#{i} ")), None)
        if shape is None or caps.B % n:
            continue
        pick.remove(shape)
        inputs = interop.inputs_from_numpy(d["state"], d["arena"], d["arena_len"], d["visited"],
                                           d["code"], d["cfg"], devices[0])
        bs = caps.B // n
        blocks = fstep.ShardedState([FrontierState(*[f[k * bs:(k + 1) * bs].to(dev, copy=True)
                                                     for f in inputs[0]])
                                     for k, dev in enumerate(devices)])
        got = interop.outputs_to_numpy(fstep.segment_partitioned(blocks, *inputs[1:], caps))
        single = interop.outputs_to_numpy(fstep.segment_cuda(*inputs, caps))
        plain, plain_ms = cuda_once(lambda: interop.outputs_to_numpy(
            fstep.segment_partitioned_torch(blocks, *inputs[1:], caps)))
        err = max(frontier_err(got, single), frontier_err(got, plain))
        stream = torch.cuda.current_stream(devices[0]).cuda_stream
        turns = {"single": [], "partitioned": []}
        for which in ("single", "partitioned", "partitioned", "single"):
            if cards:
                turns[which].append(whole(
                    (lambda: fstep.segment_cuda(*inputs, caps)) if which == "single"
                    else (lambda: fstep.segment_partitioned(blocks, *inputs[1:], caps))))
                continue
            timer = LaunchTimer(torch)
            for _ in range(reps):
                if which == "single":
                    args, _outs, _keep = fstep.kernel_args(*inputs, caps)
                    timer(lambda: _build.check(lib.mk_frontier_segment(ctypes.byref(args), stream),
                                               "frontier_segment"))
                else:
                    launches, _outs, _keep = fstep.shard_args(blocks, *inputs[1:], caps)
                    args = launches[0][1]
                    timer(lambda: _build.check(
                        lib.mk_frontier_segment_shards(ctypes.byref(args), stream),
                        "frontier_segment_shards"))
            turns[which].append(timer.total_ms() / reps)
        ms = statistics.mean(turns["partitioned"])
        wrapper = (ms if cards else
                   cuda_ms(lambda: fstep.segment_partitioned(blocks, *inputs[1:], caps), reps))
        s = by_shape[shape]
        where = f"{n} cards" if cards else f"{n} shards of {bs}"
        rows.append({"ms": ms, "wrapper_ms": wrapper, "plain_ms": plain_ms,
                     "bound_ms": s["bound_ms"], "bound_by": s["bound_by"], "err": err,
                     "n_exec": got[3], "turns_ms": turns,
                     "timed_by": "host clock, whole call" if cards else "CUDA events, launch",
                     "shape": f"{name}#{i} B={caps.B} as {where}"})
        print(f"  {rows[-1]['shape']}: partitioned {ms:.4f} ms ({rows[-1]['timed_by']}; in "
              f"turns: single {turns['single'][0]:.4f}, partitioned {turns['partitioned'][0]:.4f}, "
              f"{turns['partitioned'][1]:.4f}, single {turns['single'][1]:.4f}), wrapper "
              f"{wrapper:.4f} ms, plain {plain_ms:.1f} ms once, bound {s['bound_ms']:.6f} ms by "
              f"{s['bound_by']}; equal to the single launch and the plain version: {err == 0}")
    check(rows, "no kept dispatch was timed partitioned")
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
    on the card; ``shipped_events``: the events the segment kernel wrote
    for the host, summed over every harvest (``ev_len`` of each path).
    Host clocks except ``kernel_ms``."""

    def __init__(self, torch):
        self.torch = torch
        self.t = collections.Counter()
        self.events, self.tape_calls, self.lowering_calls = [], 0, 0
        self.shipped_events = 0
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

        def pull_harvest(*a, **kw):
            t0 = time.perf_counter()
            out = saved[(id(E), "pull_harvest")](*a, **kw)
            t["pull_s"] += time.perf_counter() - t0
            self.shipped_events += int(out[0].ev_len.sum())
            return out

        PI._gate_issues = outside_solver_time(PI, "_gate_issues")
        Optimize.check = outside_solver_time(Optimize, "check")
        E.push_state = timed(E, "push_state", "push_s", sync=True)
        E.pull_harvest = pull_harvest
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
        if cdcl and not tiers and run["name"] in CDCL_RUNS_LEFT_OUT:
            continue
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


def defaults_runs(torch, card: str, tier_rows: list):
    """Phase 8e (see the module docstring); ``tier_rows`` are phase 8d's ->
    (summed launches of the checked runs, per-run rows)."""
    from mythril_tpu_torch.querycache.cache import ENTRY_HITS
    from mythril_tpu_torch.smt.solver import SolverStatistics
    from tests import test_torch_cli as T
    from tests import test_torch_engine_defaults as D
    from tests._torch_parity import run_analysis

    phase("engine under the default host tiers: the port's analysis on the card against "
          "the recorded JAX runs with the static pass and the query cache on, beside the "
          "same run with them off")
    tier_walls = {r["run"]: r["wall_s"] for r in tier_rows}
    total, rows = collections.Counter(), []

    def measured(run, defaults: bool):
        zero_launches()
        with EngineSplit(torch) as split:
            if defaults:
                got = D.run_port(run, None)  # no device: the card
            else:
                got = run_analysis("mythril_tpu_torch", bytes.fromhex(run["code"]),
                                   tx_count=run["transactions"], strategy=run["strategy"],
                                   frontier=run["frontier"], force=run["frontier"],
                                   width=run["width"], timeout=3600, device=None, cdcl=True,
                                   tiers=True)
            torch.cuda.synchronize()
        stats = SolverStatistics().as_dict()
        return got, read_launches(), split, stats

    for run in D.load_runs():
        label = f"{run['name']} ({'frontier' if run['frontier'] else 'host engine'})"
        got, launches, split, stats = measured(run, True)
        entry_hits = dict(ENTRY_HITS)
        total.update(launches)
        bad = D.check_run(run, got)
        off, off_launches, off_split, _ = measured(run, False)
        check(off["summary"] == got["summary"],
              f"{label}: the issues differ with the static pass and the query cache off")
        row = {"run": label, "wall_s": got["seconds"], "launches": launches,
               "shipped_events": split.shipped_events, "kernel_ms": split.kernel_ms(),
               "tape_calls": split.tape_calls, "lowering_calls": split.lowering_calls,
               "device_dispatches": stats["device_dispatches"],
               "staticpass": got["staticpass"], "querycache": got["querycache"],
               "querycache_hits_by_entry": entry_hits,
               "tiers": got["tiers"], "held_exactly": not bad,
               "off": {"wall_s": off["seconds"], "launches": off_launches,
                       "shipped_events": off_split.shipped_events,
                       "kernel_ms": off_split.kernel_ms()},
               "tiers_phase_wall_s": tier_walls.get(label), "card": card}
        rows.append(row)
        qc = got["querycache"]
        print(f"  {label}: {got['seconds']:.3f} s on, {off['seconds']:.3f} s off (8d's run "
              + (f"{row['tiers_phase_wall_s']:.3f} s" if row["tiers_phase_wall_s"] is not None
                 else "none") + f", {card}); {len(got['summary'])} issues; segment launches "
              f"{launches['frontier_segment']} on / {off_launches['frontier_segment']} off, "
              f"events shipped {split.shipped_events} / {off_split.shipped_events}; launches on "
              f"{launches}, off {off_launches}")
        print(f"    staticpass {got['staticpass']}; querycache hits exact {qc['exact_hits']}, "
              f"model {qc['model_hits']}, core {qc['core_hits']}, unknown "
              f"{qc['unknown_hits']} of {qc['lookups']} lookups, by entry point {entry_hits}; "
              f"tiers {got['tiers']}")
        check(not bad, f"{label}: differs from the recorded JAX run: {bad[:3]}")
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

    runs = T.load_runs()
    for name in ("static/kill_simple/json", "static/killbilly-creation/json"):
        argv = runs[name]["argv"]
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "mythril_tpu_torch", *argv], cwd=str(ROOT),
                              capture_output=True, text=True, timeout=300)
        wall = time.perf_counter() - t0
        check(proc.returncode == 0, f"python -m mythril_tpu_torch {name}: {proc.stderr[-2000:]}")
        diffs = T.differences("static", runs[name]["stdout"], proc.stdout)
        print(f"  python -m mythril_tpu_torch {' '.join(argv[:2])} ... {' '.join(argv[-2:])} "
              f"({name}): exit 0 in {wall:.2f} s, differences from the JAX CLI {diffs}")
        check(not diffs, f"{name}: the static report differs from the JAX CLI's: {diffs[:3]}")
        rows.append({"run": f"python -m mythril_tpu_torch {name}", "cli_wall_s": wall,
                     "card": card})
    return dict(total), rows


def engine_idle_share(torch, name: str = "bectoken_like", cdcl: bool = False,
                      tiers: bool = False):
    """One frontier run of an engine phase again under ``torch.profiler``:
    the card's busy time over the run's wall time."""
    from tests import test_torch_engine_cdcl, test_torch_engine_fixture, test_torch_engine_tiers

    fixture = (test_torch_engine_tiers if tiers else
               test_torch_engine_cdcl if cdcl else test_torch_engine_fixture)
    under = " under the default solver tiers" if tiers else " under native CDCL" if cdcl else ""
    phase(f"engine idle share{under}: {name} (frontier) under torch.profiler")
    run = next(r for r in fixture.load_runs() if r["name"] == name and r["frontier"])
    idle = profiled_idle_share(torch, lambda: fixture.run_port(run, None, record=False))
    return None if idle is None else {"run": name, **idle}


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
    from tests._torch_parity import _reset, port_uncalibrated

    from mythril_tpu_torch.querycache import configure

    p = cli.create_parser().parse_args(argv)
    fields = ("frontier", "frontier_force", "frontier_width", "prefilter", "devsolver",
              "staticpass", "staticpass_interproc", "query_cache", "pipeline", "solver_workers",
              "harvest_workers", "probe_backend")
    saved = tuple(getattr(args, f) for f in fields)
    (args.frontier, args.frontier_force, args.frontier_width, args.prefilter, args.devsolver,
     args.staticpass, args.staticpass_interproc, args.query_cache, args.pipeline,
     args.solver_workers, args.harvest_workers, args.probe_backend) = (
        p.frontier, p.frontier_force, p.frontier_width, p.prefilter, p.devsolver,
        not p.no_staticpass, not p.no_staticpass_interproc, not p.no_query_cache, p.pipeline,
        p.solver_workers, p.harvest_workers, p.probe_backend)
    configure(enabled=args.query_cache)
    _reset("mythril_tpu_torch")
    cfg.gbl_next_uid[0] = 0
    try:
        t0 = time.perf_counter()
        with port_uncalibrated():  # as the CLI's run (test_torch_cli.run_port)
            sym = SymExecWrapper(EVMContract(code=p.code.replace("0x", ""), name="MAIN"),
                                 "0x" + "0" * 38 + "06", strategy=p.strategy,
                                 transaction_count=p.transaction_count)
            fire_lasers(sym)
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    finally:
        for f, v in zip(fields, saved):
            setattr(args, f, v)
        configure(enabled=args.query_cache)


# phase 8f's run under torch.profiler in both modes
PIPELINE_PROFILED = "etherstore_like/256"
# the recorded dispatches phase 8f chains a segment on
PIPELINE_CHAINED = (("etherstore_like", 0), ("wide_contract_10", 0))


@contextlib.contextmanager
def counting_pulls(into: collections.Counter):
    """Count every ``step.pull_harvest`` of the runs inside: ``delta`` and
    ``full`` pulls, the bytes each delta pull copied (``delta_bytes``, from
    ``pipeline.COUNTERS``) and the bytes a full pull of the same mirror
    would have copied (``full_bytes_for_delta``)."""
    from mythril_tpu_torch.frontier import pipeline
    from mythril_tpu_torch.frontier import step as fstep
    from tests.test_torch_pipeline import full_pull_bytes

    orig = fstep.pull_harvest

    def counted(*a, prev=None, **kw):
        before = pipeline.COUNTERS["delta_pull_bytes"]
        out = orig(*a, prev=prev, **kw)
        if prev is None:
            into["full"] += 1
        else:
            into["delta"] += 1
            into["delta_bytes"] += pipeline.COUNTERS["delta_pull_bytes"] - before
            into["full_bytes_for_delta"] += full_pull_bytes(out[0])
        return out

    fstep.pull_harvest = counted
    try:
        yield into
    finally:
        fstep.pull_harvest = orig


def profiled_idle_share(torch, fn, indent: str = "  ") -> Optional[dict]:
    """``fn()`` (an analysis: -> its result with "seconds") under
    ``torch.profiler``: prints and returns the card's busy time over the
    wall, with the kernels that took the most, or None with the reason
    printed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            got = fn()
            torch.cuda.synchronize()
        device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    except Exception as e:  # a measurement only: the runs themselves were checked
        print(f"{indent}not measured: {type(e).__name__}: {e}")
        return None
    if not device:
        print(f"{indent}not measured: the profiler recorded no device time")
        return None
    wall_ms = got["seconds"] * 1e3
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:6]
    print(f"{indent}wall {wall_ms:.1f} ms (profiled), device busy {busy_ms:.3f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.6f}; by kernel: "
          + ", ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}" for e in top))
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms}


def pipeline_runs(torch, card: str):
    """Phase 8f (see the module docstring) -> (summed launches of the
    pipelined runs, per-run rows)."""
    import os
    import tempfile

    from mythril_tpu_torch.frontier import pipeline
    from mythril_tpu_torch.frontier.harvest import shutdown_replay_pool
    from tests import test_torch_cli as T
    from tests import test_torch_pipeline as P

    phase("pipelined frontier: the port's pipelined analysis on the card against the recorded "
          "JAX pipeline, beside the same run with --no-pipeline")
    t_phase = time.perf_counter()
    total, rows = collections.Counter(), []
    for run in P.load_runs():
        label = P.label(run["name"], run["width"])
        zero_launches()
        pulls = collections.Counter()
        with counting_pulls(pulls):
            got = P.run_port(run, None)  # no device: the card
            torch.cuda.synchronize()
        launches = read_launches()
        total.update(launches)
        zero_launches()
        off = P.run_port(run, None, pipeline=False)
        torch.cuda.synchronize()
        off_launches = read_launches()
        pc, f = got["pipeline"], got["frontier"]
        bad = P.check_run(run, got)
        row = {"run": label, "wall_s": got["seconds"], "no_pipeline_wall_s": off["seconds"],
               "issues": len(got["summary"]), "segments": f["segments"],
               "no_pipeline_segments": off["frontier"]["segments"],
               "segment_launches": launches["frontier_segment"],
               "no_pipeline_segment_launches": off_launches["frontier_segment"],
               "launches": launches, "pipeline": pc, "pulls": dict(pulls),
               "jax_pipeline": run["pipeline"], "held_exactly": not bad, "card": card}
        rows.append(row)
        print(f"  {label}: pipelined {got['seconds']:.3f} s, then --no-pipeline "
              f"{off['seconds']:.3f} s ({card}); "
              f"{len(got['summary'])} issues (recorded {len(run['summary'])}, "
              f"--no-pipeline {len(off['summary'])}); segments {f['segments']} (launches "
              f"{launches['frontier_segment']}), --no-pipeline {off['frontier']['segments']}")
        print(f"    segments_pipelined {pc['segments_pipelined']}, overlap_segments "
              f"{pc['overlap_segments']}, bubble_s {pc['bubble_s']:.4f}, overlap_s "
              f"{pc['overlap_s']:.4f}; delta pulls {pc['delta_pulls']} of {pc['delta_pull_bytes']}"
              f" bytes against {pulls['full_bytes_for_delta']} bytes as full pulls, full pulls "
              f"{pulls['full']}; carried {pc['carried_slots']}, corrected {pc['corrected_slots']}"
              f"; pool submitted {pc['pool_submitted']}, dedup {pc['pool_inflight_dedup']}, "
              f"prefilter kills {pc['pool_prefilter_kills']}, rollbacks "
              f"{pc['pool_unsat_rollbacks']} UNSAT / {pc['orphan_rollbacks']} orphan; launches "
              f"{launches}")
        check(not bad, f"{label}: differs from the recorded JAX pipeline: {bad[:3]}")
        check(not P.summary_differences(off["summary"], got["summary"]),
              f"{label}: the issues differ (--no-pipeline)")
        check(launches["frontier_segment"] == f["segments"] > 0,
              f"{label}: {launches['frontier_segment']} segment launches for {f['segments']} "
              "segments")
        check(pulls["delta"] == pc["delta_pulls"] and pulls["delta_bytes"] == pc["delta_pull_bytes"],
              f"{label}: delta pulls {dict(pulls)} against the counters {pc}")
        if label == PIPELINE_PROFILED:
            for mode, on in (("pipelined", True), ("--no-pipeline", False)):
                print(f"    {mode} under torch.profiler:")
                row[f"idle_{'pipelined' if on else 'no_pipeline'}"] = profiled_idle_share(
                    torch, lambda: P.run_port(run, None, pipeline=on), indent="      ")
    shutdown_replay_pool()
    # one segment chained on a recorded dispatch: no host read on the way
    # (sync debug mode "error"), the merged input and the outputs equal to
    # the plain merge and segment, the delta pull equal to the full pull
    for name, index in PIPELINE_CHAINED:
        d = P.recorded_dispatch(name, index)
        P.chained_dispatch(d, "cuda")  # the pinned pools and the library outside the check
        zero_launches()
        got = P.chained_dispatch(d, "cuda", sync_debug=True)
        launches = read_launches()
        print(f"  {name} dispatch {index} and one chained segment ({got['corrected']} slots "
              f"corrected) under set_sync_debug_mode(\"error\"): merged input "
              f"{'equal' if got['in'] == got['plain_in'] else 'DIFFERENT'}, outputs "
              f"{'equal' if got['out'] == got['plain_out'] else 'DIFFERENT'} to the plain "
              f"version; delta pull {'equal' if got['delta_equal'] else 'DIFFERENT'} to the full "
              f"pull, {got['delta_bytes']} bytes against {got['full_bytes']}")
        check(launches["frontier_segment"] == 2, f"{name}: launches {launches}")
        check(got["in"] == got["plain_in"], f"{name}: the chained input differs from the plain merge")
        check(got["out"] == got["plain_out"], f"{name}: the chained segment differs from the plain one")
        check(got["delta_equal"], f"{name}: the delta pull differs from the full pull")
        rows.append({"run": f"chained {name}/{index}", **{k: got[k] for k in (
            "corrected", "delta_bytes", "full_bytes")}, "card": card})
    # one command line with the pipeline on, against the JAX CLI's record
    os.environ["MYTHRIL_DIR"] = tempfile.mkdtemp(prefix="mythril-")
    name = "etherstore_like/frontier-256/pipeline"
    record = T.load_runs()[name]
    pipeline.reset_counters()
    zero_launches()
    t0 = time.perf_counter()
    rc, out = T.run_port(T.port_argv(record), device=None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    diffs = T.differences("jsonv2", record["stdout"], out)
    print(f"  CLI {name}: exit {rc} in {wall:.3f} s, differences from the JAX CLI {diffs}; "
          f"segments_pipelined {pipeline.COUNTERS['segments_pipelined']}; launches {launches}")
    check(rc == 0 and not diffs, f"{name}: the report differs from the JAX CLI's: {diffs[:3]}")
    check(pipeline.COUNTERS["segments_pipelined"] > 0, f"{name}: no chained segment")
    rows.append({"run": f"CLI {name}", "cli_wall_s": wall, "launches": launches, "card": card})
    print(f"  phase 8f took {time.perf_counter() - t_phase:.1f} s")
    return dict(total), rows


def adaptive_runs(torch, card: str):
    """Phase 8g (see the module docstring) -> (summed launches of the runs
    with the controller on, per-run rows)."""
    import os
    import tempfile

    from mythril_tpu_torch.frontier import pipeline
    from mythril_tpu_torch.frontier.harvest import shutdown_replay_pool
    from tests import test_torch_adaptive as A
    from tests import test_torch_cli as T
    from tests.test_torch_pipeline import summary_differences

    phase("adaptive controller: the port's analysis with the controller on and off on the card "
          "against the recorded JAX runs, the cooperative batches, the coverage-target CLI")
    t_phase = time.perf_counter()
    total, rows = collections.Counter(), []
    for run in A.load_fixture()["runs"]:
        label = A.label(run["name"], run["width"], run["pipelined"])
        turns = []
        for adaptive in (True, False):
            zero_launches()
            got = A.run_port(run, None, adaptive=adaptive)  # no device: the card
            torch.cuda.synchronize()
            turns.append((adaptive, got, read_launches()))
        got, launches = turns[0][1], turns[0][2]
        total.update(launches)
        walls = [g["seconds"] for _a, g, _l in turns]
        ex, f = got["exploration"], got["frontier"]
        row = {"run": label, "walls_s": walls, "modes": ["adaptive", "no-adaptive"],
               "issues": len(got["summary"]), "segments": [g["frontier"]["segments"]
                                                           for _a, g, _l in turns],
               "adaptive": [g["adaptive"] for _a, g, _l in turns],
               "adaptive_parked": [g["pipeline"]["adaptive_parked"] for _a, g, _l in turns],
               "launches": launches, "terminated": ex["terminated"],
               "coverage_pct": ex["coverage_pct"], "jax_adaptive": run["adaptive"],
               "jax_tiers": run["tiers"], "card": card}
        rows.append(row)
        print(f"  {label}: adaptive {walls[0]:.3f} s, then --no-adaptive {walls[1]:.3f} s "
              f"({card}); {row['issues']} issues "
              f"(recorded {len(run['summary'])}); segments {row['segments']} (recorded "
              f"{run['frontier_stats']['segments']}); park pool {row['adaptive_parked']}")
        print(f"    adaptive {got['adaptive']} (recorded {run['adaptive']}); terminated "
              f"{ex['terminated']}, coverage {ex['coverage_pct']} %; known_bits launches "
              f"{launches['known_bits']}, dpll launches {launches['dpll']} (the recording's "
              f"tiers {run['tiers']}); launches {launches}")
        for i, (adaptive, g, lc) in enumerate(turns):
            bad = A.check_run(run, g, adaptive=adaptive)
            check(not bad, f"{label} turn {i} ({'adaptive' if adaptive else '--no-adaptive'}): "
                  f"differs from the recorded JAX run: {bad[:3]}")
            check(not summary_differences(got["summary"], g["summary"]),
                  f"{label} turn {i}: the issues differ from the first turn's")
            check(lc["frontier_segment"] == g["frontier"]["segments"] > 0,
                  f"{label} turn {i}: {lc['frontier_segment']} segment launches for "
                  f"{g['frontier']['segments']} segments")
    shutdown_replay_pool()
    # the cooperative batches: the controller steers multi-code seed queues
    resteered = 0
    for batch in A.BATCHES:
        got = {}
        for adaptive, target in A.cooperative_modes(batch):
            zero_launches()
            got[adaptive, target] = g = A.cooperative("mythril_tpu_torch", batch, adaptive,
                                                      target, device=None)
            torch.cuda.synchronize()
            g["launches"] = read_launches()
            want = A.batch_of(batch, adaptive, target)
            mode = A.batch_label(batch, adaptive, target)
            print(f"  {mode}: {g['seconds']:.3f} s ({card}), {len(g['issues'])} issues "
                  f"(recorded {len(want['issues'])}), segments {g['segments']} (recorded "
                  f"{want['segments']}), segment launches {g['launches']['frontier_segment']}; "
                  f"adaptive {g['adaptive']} (recorded {want['adaptive']}); stop {g['stop']}")
            check(g["issues"] == want["issues"], f"{mode}: the issue set differs from the JAX "
                  f"package's: {g['issues']} != {want['issues']}")
            check(g["launches"]["frontier_segment"] == g["segments"] > 0,
                  f"{mode}: {g['launches']['frontier_segment']} segment launches for "
                  f"{g['segments']} segments")
            rows.append({"run": mode, "wall_s": g["seconds"], "segments": g["segments"],
                         "adaptive": g["adaptive"], "stop": g["stop"], "card": card})
        on, off = got[True, None], got[False, None]
        check(on["issues"] == off["issues"], f"{batch}: steering changed the issue set")
        check(off["adaptive"]["plans"] == off["adaptive"]["resteered_slots"] == 0,
              f"{batch}: --no-adaptive planned or steered: {off['adaptive']}")
        resteered += on["adaptive"]["resteered_slots"]
        target = A.BATCHES[batch][2]
        if target:
            # the stop latches, with as many segments as the JAX package
            # dispatches (its recording): the device planes reach the ledger
            # when a drain ends, so the stop saves no segment there either.
            # The walls, in turns (without, with, with, without), are printed
            # beside the JAX bench's own test (fewer segments or less wall),
            # which is not held: see PERF.md
            tg, want = got[True, target], A.batch_of(batch, True, target)
            check(tg["stop"] is not None and tg["stop"]["reason"] == "target"
                  and tg["segments"] == want["segments"],
                  f"{batch}: coverage target {target} latched {tg['stop']} with "
                  f"{tg['segments']} segments against the JAX package's {want['segments']}")
            tg2 = A.cooperative("mythril_tpu_torch", batch, True, target, device=None)
            off2 = A.cooperative("mythril_tpu_torch", batch, False, None, device=None)
            for g, mode in ((tg2, "target, again"), (off2, "--no-adaptive, again")):
                check(g["issues"] == off["issues"], f"{batch} ({mode}): the issue set differs")
            on_walls, off_walls = [tg["seconds"], tg2["seconds"]], [off["seconds"], off2["seconds"]]
            on_mean, off_mean = sum(on_walls) / 2, sum(off_walls) / 2
            print(f"  {batch}: coverage target {target}: stop {tg['stop']}, {tg['segments']} "
                  f"segments against {off['segments']} without; walls in turns without "
                  f"{off_walls[0]:.3f}, with {on_walls[0]:.3f} and {on_walls[1]:.3f}, without "
                  f"{off_walls[1]:.3f} s, means {on_mean:.4f} against {off_mean:.4f} s ({card});"
                  f" fewer segments {tg['segments'] < off['segments']}, less mean wall "
                  f"{on_mean < off_mean}")
            rows.append({"run": f"{batch}/target-{target:g} in turns", "target_walls_s": on_walls,
                         "no_adaptive_walls_s": off_walls, "segments": tg["segments"],
                         "no_adaptive_segments": off["segments"], "card": card})
    check(resteered > 0, "the controller resteered no dispatch slot in any cooperative batch")
    # the coverage-target command line against the JAX CLI's report and
    # --coverage-out file
    os.environ["MYTHRIL_DIR"] = tempfile.mkdtemp(prefix="mythril-")
    name = "loop_tail/frontier/coverage-target"
    record = T.load_runs()[name]
    pipeline.reset_counters()
    zero_launches()
    t0 = time.perf_counter()
    rc, ledger, out = T.run_port(T.port_argv(record), device=None, with_stdout=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    diffs = T.compare(record, rc, ledger, out)
    print(f"  CLI {name}: exit {rc} in {wall:.3f} s, differences from the JAX CLI's report and "
          f"--coverage-out file {diffs}; launches {launches}")
    check(rc == 0 and not diffs, f"{name}: differs from the JAX CLI's: {diffs[:3]}")
    rows.append({"run": f"CLI {name}", "cli_wall_s": wall, "launches": launches, "card": card})
    print(f"  phase 8g took {time.perf_counter() - t_phase:.1f} s")
    return dict(total), rows


def cli_runs(torch, card: str, engine_rows: list, tier_rows: list, default_rows: list):
    """Phase 8c (see the module docstring); ``engine_rows``, ``tier_rows``
    and ``default_rows`` are phase 8b's, 8d's and 8e's -> (summed launches,
    per-run rows)."""
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
    default_walls = {r["run"]: r.get("wall_s") for r in default_rows}
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
        # the same analysis without the CLI and the facade
        w1 = wrapper_seconds(torch, argv)
        host_tiers_on = "--no-staticpass" not in argv
        engine = (default_walls if host_tiers_on else tier_walls if tiers_on else walls).get(
            f"{name.split('/')[0]} (frontier)")
        row = {"run": name, "cli_wall_s": wall, "wrapper_wall_s": w1,
               "overhead_s": wall - w1, "engine_phase_wall_s": engine,
               "jax_cli_cpu_s": run["jax_cpu_seconds"], "launches": launches,
               "segments": segments, "tape_calls": split.tape_calls,
               "lowering_calls": split.lowering_calls, "device_dispatches": dispatches,
               "kernel_ms": split.kernel_ms(), "card": card}
        rows.append(row)
        print(f"  {name}: CLI {wall:.3f} s (checked), then SymExecWrapper + fire_lasers alone "
              f"{w1:.3f} s, overhead {row['overhead_s']:+.4f} s; engine phase's run of the contract "
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


def jsonv2_issue_keys(stdout: str) -> list:
    """A jsonv2 report's issues without their models: SWC, title,
    severity, location and description head, sorted."""
    from tests import test_torch_cli as T

    return sorted((i["swcID"], i["swcTitle"], i["severity"], i["locations"][0]["sourceMap"],
                   i["description"]["head"]) for i in T._last_json_line(stdout)[0]["issues"])


def auto_runs(torch, card: str):
    """Phase 8h (see the module docstring) -> (summed launches of the
    ``auto`` runs' first turns, rows)."""
    import os
    import tempfile

    from mythril_tpu_torch.frontier import engine as fengine
    from mythril_tpu_torch.smt.solver import SolverStatistics
    from mythril_tpu_torch.support import calibration
    from mythril_tpu_torch.support.support_args import args
    from tests import test_torch_cli as T
    from tests._torch_parity import port_calibration

    phase("auto probe backend: the link calibration on the card, then the default command line "
          "(no --probe-backend) calibrated, against the JAX CLI's default-tier recording")
    t_phase = time.perf_counter()
    total, rows = collections.Counter(), []
    with port_calibration(done=False):
        applied = calibration.calibrate(torch.device("cuda"))
        rtt = calibration._state["rtt_ms"]
        check(rtt is not None, "the calibration measured no round trip on the card")
        # the JAX package's formula (mythril_tpu/support/calibration.py:76-108)
        scale = rtt / 100.0
        want = {"dispatch_rtt_ms": round(rtt, 2),
                "device_probe_threshold": int(min(5_000_000, max(20_000, 600_000 * scale))),
                "min_static_jumpis": int(min(16, max(2, round(8 * scale)))),
                "min_seed_width": int(min(64, max(8, round(24 * scale))))}
        constants = (args.device_probe_threshold, fengine._MIN_STATIC_JUMPIS,
                     fengine._MIN_SEED_WIDTH)
        again = sorted(calibration.measure_dispatch_rtt_ms(torch.device("cuda"))
                       for _ in range(5))
        print(f"  dispatch round trip {rtt:.5f} ms (median of 3 after a warm-up; five more "
              f"measurements {', '.join(f'{r:.5f}' for r in again)} ms) ({card}); applied "
              f"{applied}; device_probe_threshold {constants[0]}, min_static_jumpis "
              f"{constants[1]}, min_seed_width {constants[2]}")
        check(applied == want, f"the calibration applied {applied}, the JAX formula gives {want}")
        check(constants == (want["device_probe_threshold"], want["min_static_jumpis"],
                            want["min_seed_width"]),
              f"the rescaled constants {constants} differ from {want}")
        check(calibration.calibrate(torch.device("cuda")) == applied,
              "a second decision measured again")
        rows.append({"run": "calibration", "rtt_ms": rtt, "rtt_again_ms": again,
                     "applied": applied, "card": card})
        os.environ["MYTHRIL_DIR"] = tempfile.mkdtemp(prefix="mythril-")
        runs = T.load_runs()
        for name in T.AUTO:
            run = runs[name]
            argv = T.port_argv(run)
            check("--probe-backend" not in argv, f"{name}: the port's argv names a backend")
            want_keys = jsonv2_issue_keys(run["stdout"])
            turns = []
            # in turns (auto, device, device, auto), so that neither mode's
            # walls favour the one run second
            for mode in ("auto", "device", "device", "auto"):
                zero_launches()
                t0 = time.perf_counter()
                with gate_products() as products:
                    rc, out = T.run_port(argv + (["--probe-backend", "device"] if mode == "device"
                                                 else []), device=None, calibrated=True)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = read_launches()
                check(rc == 0, f"{name} ({mode}): the CLI exited {rc}")
                keys = jsonv2_issue_keys(out)
                check(keys == want_keys, f"{name} ({mode}): the issue keys differ from the JAX "
                      f"CLI's default-tier recording: {keys} != {want_keys}")
                block = T._last_json_line(out)[0]["meta"]["mythril_execution_info"].get(
                    "calibration")
                check(block == calibration.telemetry() and block["device_probe_threshold"]
                      == want["device_probe_threshold"],
                      f"{name} ({mode}): the report's calibration block {block}")
                turns.append((mode, wall, launches, SolverStatistics().device_dispatches,
                              products))
            total.update(turns[0][2])
            for mode, wall, launches, dispatches, products in turns:
                top = max(products, default=0)
                print(f"  {name} --probe-backend {mode}: {wall:.3f} s ({card}), device_dispatches "
                      f"{dispatches}, launches {launches}; the auto gate saw {len(products)} "
                      f"queries, the largest DAG size x candidates {top} (threshold "
                      f"{want['device_probe_threshold']})" if mode == "auto" else
                      f"  {name} --probe-backend {mode}: {wall:.3f} s ({card}), device_dispatches "
                      f"{dispatches}, launches {launches}")
            rows.append({"run": name, "modes": [t[0] for t in turns],
                         "walls_s": [t[1] for t in turns], "launches": [t[2] for t in turns],
                         "device_dispatches": [t[3] for t in turns],
                         "gate_queries": len(turns[0][4]),
                         "gate_max_product": max(turns[0][4], default=0),
                         "jax_cli_cpu_s": run["jax_cpu_seconds"], "card": card})
    print(f"  phase 8h took {time.perf_counter() - t_phase:.1f} s")
    return dict(total), rows


@contextlib.contextmanager
def gate_products():
    """The DAG size x candidates of every query the solver's ``auto`` gate
    decides inside the block (a list, filled as the gate runs)."""
    from mythril_tpu_torch.smt import solver as P
    from mythril_tpu_torch.smt import terms

    real, products = P._device_worthwhile, []

    def recording(conjuncts, n_candidates, device):
        if P.global_args.probe_backend == "auto":
            products.append(len(terms.topo_order(list(conjuncts))) * max(1, n_candidates))
        return real(conjuncts, n_candidates, device)

    P._device_worthwhile = recording
    try:
        yield products
    finally:
        P._device_worthwhile = real


def concolic_runs(torch, card: str):
    """Phase 8i (see the module docstring) -> (summed launches of the
    recorded cases under ``device``, and under ``auto``, rows)."""
    import io
    import os
    import tempfile

    from mythril_tpu_torch.interfaces import cli
    from mythril_tpu_torch.support import calibration
    from mythril_tpu_torch.support.support_args import args
    from tests import test_torch_concolic as C
    from tests._torch_parity import port_calibration, port_probe_backend

    phase("concolic execution on the card: every recorded case under device and auto, the "
          "CLI, the frontier forced, a device fault in a harvest replay")
    t_phase = time.perf_counter()
    runs = C.load_runs()
    total, rows = collections.Counter(), []
    for name, run in runs.items():
        zero_launches()
        got = C.run_port(run, None, "device")  # no device: the card
        torch.cuda.synchronize()
        launches = read_launches()
        total.update(launches)
        cut = run["cdcl"]["timeouts"]
        print(f"  {name} (device): {got['seconds']:.3f} s ({card}), the JAX package on the CPU "
              f"{run['jax_cpu_seconds']:.1f} s; {len(run['branches'])} branches, hits "
              f"{got['hits']} (recorded {run['hits']}); CDCL {got['cdcl']} (recorded "
              f"{run['cdcl']}); launches {launches}")
        check(got["trace"] == run["trace"], f"{name}: the concrete trace differs")
        check(launches["frontier_segment"] == 0, f"{name}: a concolic run launched a segment")
        bad = C.output_differences(run, got)
        if cut:
            # the recording has CDCL answers cut by their wall-clock budget:
            # held as under auto
            print(f"    the recording has {cut} CDCL answers cut by their budget: held "
                  f"semantically, exact differences {bad[:1]}")
            bad = ([] if got["hits"] == run["hits"] else [f"hits {got['hits']}"]) + [
                d for o in got["outputs"] for d in C.flip_check(run, o, None)]
        check(not bad, f"{name}: differs from the JAX recording: {bad[:2]}")
        rows.append({"run": f"{name} (device)", "wall_s": got["seconds"],
                     "jax_cpu_s": run["jax_cpu_seconds"], "launches": launches,
                     "hits": got["hits"], "cdcl": got["cdcl"], "card": card})
    check(total["tape_vm"] > 0, "the concolic runs launched tape_vm no time")
    # the command line, under device as recorded (``concolic`` has no
    # --probe-backend, as in the JAX CLI)
    name = "etherstore_like"
    run = runs[name]
    path = os.path.join(tempfile.mkdtemp(prefix="concolic-"), "input.json")
    with open(path, "w") as f:
        json.dump(run["data"], f)
    out = io.StringIO()
    zero_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), port_probe_backend("device"):
        rc = cli.main(["concolic", path, "--branches", ",".join(map(str, run["branches"]))])
    wall = time.perf_counter() - t0
    launches = read_launches()
    print(f"  CLI concolic {name}: exit {rc} in {wall:.3f} s ({card}), launches {launches}")
    check(rc == 0 and json.loads(out.getvalue()) == run["outputs"],
          f"CLI concolic {name}: the output differs from the JAX recording")
    rows.append({"run": f"CLI concolic {name}", "wall_s": wall, "launches": launches,
                 "card": card})
    # auto, calibrated: the models may differ; the same flips must succeed
    # and each input must leave the recorded trace at a requested JUMPI
    auto_total = collections.Counter()
    with port_calibration(done=False):
        calibration.calibrate(torch.device("cuda"))
        for name, run in runs.items():
            zero_launches()
            with gate_products() as products:
                got = C.run_port(run, None, "auto")
            torch.cuda.synchronize()
            launches = read_launches()
            auto_total.update(launches)
            print(f"  {name} (auto): {got['seconds']:.3f} s ({card}), hits {got['hits']}, CDCL "
                  f"{got['cdcl']}, launches {launches}; the auto gate saw {len(products)} "
                  f"queries, the largest DAG size x candidates {max(products, default=0)}")
            check(got["hits"] == run["hits"], f"{name} (auto): hits {got['hits']} != "
                  f"{run['hits']}")
            for output in got["outputs"]:
                bad = C.flip_check(run, output, None)
                check(not bad, f"{name} (auto): {bad}")
            rows.append({"run": f"{name} (auto)", "wall_s": got["seconds"],
                         "launches": launches, "card": card})
    # the frontier forced: no concolic laser reaches it
    name = "etherstore_like"
    saved = (args.frontier, args.frontier_force)
    args.frontier = args.frontier_force = True
    try:
        zero_launches()
        got = C.run_port(runs[name], None, "device")
        torch.cuda.synchronize()
        launches = read_launches()
    finally:
        args.frontier, args.frontier_force = saved
    print(f"  {name} with the frontier forced: hits {got['hits']}, launches {launches}")
    check(launches["frontier_segment"] == 0 and not C.output_differences(runs[name], got),
          f"{name} with the frontier forced: {launches['frontier_segment']} segment launches, "
          f"{C.output_differences(runs[name], got)[:1]}")
    device_fault(torch)
    print(f"  phase 8i took {time.perf_counter() - t_phase:.1f} s")
    return dict(total), dict(auto_total), rows


# phase 8j's recorded command line: the pipelined frontier (the port's
# default loop) at 256 paths with the device probe, on etherstore_like
TRACED_RUN = "etherstore_like/frontier-256/pipeline"
MICROBENCH_RUN = "kill_simple/frontier/pipeline"


def traced_runs(torch, card: str):
    """Phase 8j (see the module docstring) -> (the traced run's launches,
    the phase's row)."""
    import os
    import statistics as stats
    import tempfile

    from mythril_tpu_torch.frontier.stats import FrontierStatistics
    from mythril_tpu_torch.observability import get_tracer
    from mythril_tpu_torch.smt import solver
    from mythril_tpu_torch.support.support_args import args
    from tests import test_torch_cli as T
    from tests import test_torch_observability as O

    t_phase = phase("traced: the pipelined analysis through the CLI with --trace-out and "
                    "--metrics-out on the card, against the untraced run and the JAX record")
    run = T.load_runs()[TRACED_RUN]
    argv = T.port_argv(run)
    tmp = tempfile.mkdtemp(prefix="traced-")
    trace_path, metrics_path = os.path.join(tmp, "trace.json"), os.path.join(tmp, "metrics.json")
    traced_argv = argv + ["--trace-out", trace_path, "--metrics-out", metrics_path]
    want = jsonv2_issue_keys(run["stdout"])
    probes = collections.Counter()
    evaluate = solver._evaluate_candidates_device

    def counting(compiled, candidates, device):
        # the per-conjunction dispatch is the one the JAX package spans as
        # smt.device_probe; the merged batch dispatch has no span there
        probes[sys._getframe(1).f_code.co_name] += 1
        return evaluate(compiled, candidates, device)

    def one(traced: bool, profile: bool = False):
        zero_launches()
        probes.clear()
        prof = (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                   torch.profiler.ProfilerActivity.CUDA])
                if profile else contextlib.nullcontext())
        t0 = time.perf_counter()
        with prof:
            rc, out = T.run_port(traced_argv if traced else argv, device=None)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(rc == 0, f"{TRACED_RUN} ({'traced' if traced else 'untraced'}): exit {rc}")
        check(jsonv2_issue_keys(out) == want,
              f"{TRACED_RUN} ({'traced' if traced else 'untraced'}): the issue keys differ from "
              "the JAX recording")
        return wall, out, read_launches(), dict(probes), prof

    solver._evaluate_candidates_device = counting
    try:
        walls = {"untraced": [], "traced": []}
        for turn in ("untraced", "traced", "traced", "untraced"):
            wall, out, launches, by_caller, _ = one(turn == "traced")
            walls[turn].append(wall)
            if turn == "traced" and len(walls["traced"]) == 1:
                traced_out, traced_launches, traced_probes = out, launches, by_caller
                with open(trace_path) as f:
                    trace = json.load(f)
                with open(metrics_path) as f:
                    metrics = json.load(f)
        _, _, _, _, prof = one(True, profile=True)
        # the microbench, once, on the first productive segment of the
        # short pipelined command line (kill_simple, 64 paths)
        saved = args.frontier_microbench
        args.frontier_microbench = True
        try:
            rc, _ = T.run_port(T.port_argv(T.load_runs()[MICROBENCH_RUN]), device=None)
            check(rc == 0, f"{MICROBENCH_RUN} with the microbench: exit {rc}")
            micro = dict(FrontierStatistics().microbench)
        finally:
            args.frontier_microbench = saved
    finally:
        solver._evaluate_candidates_device = evaluate
    check(not get_tracer().enabled, "the CLI left the tracer on")
    events = O.event_counts(trace)
    spans = {k[:-2]: v for k, v in events.items() if k.endswith("|X")}
    segments = traced_launches["frontier_segment"]
    per_conjunction = traced_probes.get("_solve_conjunction_impl", 0)
    report = T._last_json_line(traced_out)[0]
    seg_meta = report["meta"]["device"].get("segment_device_s", {})
    dispatches = metrics["metrics"]["solver.device_dispatches"]
    print(f"  {card}; traced run: {sum(events.values())} events, spans by name {spans}; "
          f"launches {traced_launches}; solver device_dispatches {dispatches} "
          f"({traced_probes})")
    check(O.unmatched_flows(trace) == [], f"flows without both ends: {O.unmatched_flows(trace)[:5]}")
    check(spans.get("frontier.segment", 0) == segments > 0,
          f"{spans.get('frontier.segment', 0)} frontier.segment spans for {segments} segment "
          "launches")
    check(spans.get("smt.device_probe", 0) == per_conjunction,
          f"{spans.get('smt.device_probe', 0)} smt.device_probe spans for {per_conjunction} "
          "per-conjunction device dispatches")
    check(sum(traced_probes.values()) == dispatches,
          f"device_dispatches {dispatches} against {traced_probes}")
    check(seg_meta.get("count") == segments,
          f"meta.device.segment_device_s.count {seg_meta.get('count')} for {segments} launches")
    pull = metrics["metrics"].get("frontier.pull_device_s", {})
    print(f"  meta.device: {report['meta']['device']}; pulls {pull.get('count')}, "
          f"{pull.get('sum')} s")
    check(micro and 0 < micro["segment_compute_s"] <= micro["dispatch_plus_link_s"],
          f"microbench {micro}")
    print(f"  microbench: {micro}")
    ranges = {e.key: e for e in prof.key_averages()}
    for name in ("frontier.segment", "smt.device_probe"):
        check(name in ranges or (name == "smt.device_probe" and per_conjunction == 0),
              f"torch.profiler shows no {name} range")
    print("  torch.profiler ranges: " + ", ".join(
        f"{n} x{ranges[n].count}" for n in ("frontier.segment", "smt.device_probe")
        if n in ranges))
    # the traced run's wall split by span name (seconds, host clock)
    split = collections.defaultdict(float)
    for e in trace["traceEvents"]:
        if e["ph"] == "X":
            split[e["name"]] += e["dur"] / 1e6
    split = dict(sorted(split.items(), key=lambda kv: -kv[1]))
    print("  span seconds (traced run): " + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
    for turn, ws in walls.items():
        print(f"  {turn}: walls {[round(w, 4) for w in ws]} s, median "
              f"{stats.median(ws):.4f} s, spread {min(ws):.4f}-{max(ws):.4f} s ({card})")
    seconds = time.perf_counter() - t_phase
    print(f"  phase 8j took {seconds:.1f} s")
    check(seconds < 60, f"phase 8j took {seconds:.1f} s (its budget is 60 s)")
    row = {"run": TRACED_RUN, "walls": walls, "span_seconds": split, "spans": spans,
           "device_meta": report["meta"]["device"], "microbench": micro, "card": card,
           "seconds": seconds}
    return traced_launches, row


# phase 8k: the queue-depth keys the JAX runner's heartbeat samples
# (mythril_tpu/frontier/pipeline.py _heartbeat_sample; the CPU tests hold
# this set against it)
HEARTBEAT_KEYS = frozenset({
    "pipeline.pool_queue_depth", "pipeline.ledger_pending_corrections",
    "pipeline.reinject_queue_depth", "pipeline.seed_queue_depth",
    "frontier.arena_occupancy", "frontier.live_paths",
    "pipeline.free_slots_by_shard", "pipeline.live_slots_by_shard",
})


@contextlib.contextmanager
def syncs_by_thread(torch, into: collections.Counter):
    """Count the card's synchronising calls by the Python thread that made
    them (``torch.cuda.set_sync_debug_mode("warn")``; torch raises each as a
    warning on the calling thread)."""
    import threading
    import warnings

    def show(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" in str(message):
            into[threading.current_thread().name.split("_")[0]] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield into
        finally:
            torch.cuda.set_sync_debug_mode("default")


def health_runs(torch, card: str):
    """Phase 8k (see the module docstring) -> (the resumed run's launches,
    the phase's row)."""
    import glob
    import os
    import shutil
    import signal
    import statistics as stats
    import tempfile

    from mythril_tpu_torch.frontier import engine as fengine
    from mythril_tpu_torch.interfaces import cli
    from mythril_tpu_torch.observability.heartbeat import HeartbeatSampler
    from mythril_tpu_torch.ops import _build
    from tests import test_torch_cli as T

    t_phase = phase("health: checkpoint and resume, the heartbeat, the flight recorder, the "
                    "kernel build cache and the metrics history through the CLI on the card")
    run = T.load_runs()[TRACED_RUN]
    argv = T.port_argv(run)
    want = jsonv2_issue_keys(run["stdout"])
    tmp = tempfile.mkdtemp(prefix="health-")

    def one(extra, tx: int = 2, base=argv):
        zero_launches()
        cmd = list(base)
        cmd[base.index("-t") + 1] = str(tx)
        t0 = time.perf_counter()
        rc, out = T.run_port(cmd + extra, device=None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(rc == 0, f"{TRACED_RUN} -t {tx} {' '.join(extra)}: exit {rc}")
        return wall, out, read_launches()

    def printed(args) -> str:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(args)
        check(rc == 0, f"{' '.join(args)}: exit {rc}")
        return out.getvalue()

    # checkpoint after the first transaction, resumed for the second
    ckpt = os.path.join(tmp, "ckpt.json")
    one(["--checkpoint-file", ckpt], tx=1)
    with open(ckpt) as f:
        saved = json.load(f)
    check(saved["completed_transactions"] == 1 and saved["open_states"],
          f"the checkpoint holds {saved['completed_transactions']} transactions, "
          f"{len(saved['open_states'])} open states")
    wall_r, out_r, resumed = one(["--resume-from", ckpt])
    wall_u, out_u, whole = one([])
    keys_r, keys_u = jsonv2_issue_keys(out_r), jsonv2_issue_keys(out_u)
    print(f"  checkpoint after transaction 1: {len(saved['open_states'])} open states, "
          f"{os.path.getsize(ckpt)} bytes; resumed -t 2: {len(keys_r)} issues in {wall_r:.3f} s, "
          f"launches {resumed}; uninterrupted -t 2: {len(keys_u)} issues in {wall_u:.3f} s, "
          f"launches {whole}")
    check(keys_r == keys_u == want,
          "the resumed run's issue keys differ from the uninterrupted run's or the JAX record's")
    check(resumed["frontier_segment"] > 0 and resumed["tape_vm"] > 0,
          f"the resumed run launched the segment {resumed['frontier_segment']} and the tape VM "
          f"{resumed['tape_vm']} times")

    # the heartbeat: walls in turns with the traced and the untraced runs
    hb_path, trace_path = os.path.join(tmp, "hb.jsonl"), os.path.join(tmp, "trace.json")
    modes = {"untraced": [], "traced": ["--trace-out", trace_path],
             "heartbeat": ["--heartbeat-out", hb_path, "--heartbeat-interval", "0.05"]}
    walls = {m: [] for m in modes}
    for mode in ("untraced", "traced", "heartbeat", "heartbeat", "traced", "untraced"):
        wall, out, _ = one(modes[mode])
        check(jsonv2_issue_keys(out) == want, f"{TRACED_RUN} ({mode}): the issue keys differ "
              "from the JAX recording")
        walls[mode].append(wall)
    with open(hb_path) as f:
        samples = [json.loads(line) for line in f]
    during = [s for s in samples if "pipeline.pool_queue_depth" in s]
    print(f"  heartbeat at 0.05 s: {len(samples)} samples, {len(during)} while the runner ran; "
          f"the last one during the run: {during[-1] if during else None}")
    check(len(during) >= 2 and all(HEARTBEAT_KEYS <= set(s) for s in during),
          f"{len(during)} heartbeat samples with the runner's keys")
    for mode, ws in walls.items():
        print(f"  {mode}: walls {[round(w, 4) for w in ws]} s, median {stats.median(ws):.4f} s, "
              f"spread {min(ws):.4f}-{max(ws):.4f} s ({card})")
    # synchronising calls: the sampler's thread makes none on the pipelined
    # run; the synchronous loop (its count does not hang on when the pool's
    # verdicts land) makes as many with the sampler on as with it off
    by_thread = collections.Counter()
    with syncs_by_thread(torch, by_thread):
        one(modes["heartbeat"])
    small = T.port_argv(T.load_runs()[MICROBENCH_RUN]) + ["--no-pipeline"]
    on, off = collections.Counter(), collections.Counter()
    with syncs_by_thread(torch, on):
        one(["--heartbeat-out", hb_path, "--heartbeat-interval", "0.01"], base=small)
    start = HeartbeatSampler.start
    HeartbeatSampler.start = lambda self, *a, **k: None  # the sampler off
    try:
        with syncs_by_thread(torch, off):
            one([], base=small)
    finally:
        HeartbeatSampler.start = start
    print(f"  synchronising calls by thread, pipelined with the heartbeat at 0.05 s: "
          f"{dict(by_thread)}; {MICROBENCH_RUN} --no-pipeline with the heartbeat at 0.01 s "
          f"{sum(on.values())} ({dict(on)}), off {sum(off.values())}")
    check(by_thread["mythril-heartbeat"] == 0 and sum(by_thread.values()) > 0,
          f"the heartbeat thread made {by_thread['mythril-heartbeat']} synchronising calls")
    check(sum(on.values()) == sum(off.values()) > 0,
          f"{sum(on.values())} synchronising calls with the heartbeat, {sum(off.values())} without")

    # the flight recorder, SIGUSR1 at the second harvest, and the metrics
    # history in the same run
    flight, hist, harvests = os.path.join(tmp, "flight"), os.path.join(tmp, "history"), [0]
    harvest = fengine.FrontierEngine._harvest

    def signalling(self, *a, **k):
        harvests[0] += 1
        if harvests[0] == 2:
            os.kill(os.getpid(), signal.SIGUSR1)
        return harvest(self, *a, **k)

    fengine.FrontierEngine._harvest = signalling
    try:
        one(["--flight-recorder", flight, "--history-dir", hist] + modes["heartbeat"])
    finally:
        fengine.FrontierEngine._harvest = harvest
    bundles = sorted(glob.glob(os.path.join(flight, "flight-sigusr1-*.json")))
    check(len(bundles) == 1, f"{len(bundles)} SIGUSR1 bundles after {harvests[0]} harvests")
    with open(bundles[0]) as f:
        bundle = json.load(f)
    print(f"  SIGUSR1 bundle: {os.path.getsize(bundles[0])} bytes, device {bundle.get('device')}, "
          f"{len(bundle.get('heartbeat_tail', []))} heartbeat samples, "
          f"{len(bundle.get('spans_tail', []))} spans, {len(bundle.get('threads', {}))} threads")
    check(bundle.get("device", {}).get("backend") == "cuda" and bundle.get("heartbeat_tail"),
          "the bundle lacks the device plane's block or the heartbeat tail")

    # the kernel build cache: a fresh directory holding a copy of the built
    # library, in a process of its own
    seeded = os.path.join(tmp, "kernels")
    os.makedirs(seeded)
    shutil.copy2(_build.library_path(), seeded)
    listing = sorted(os.listdir(seeded))
    metrics_path = os.path.join(tmp, "cache-metrics.json")
    cmd = T.port_argv(T.load_runs()[MICROBENCH_RUN]) + [
        "--compile-cache-dir", seeded, "--metrics-out", metrics_path]
    env = dict(os.environ, MYTHRIL_DIR=os.path.join(tmp, "mythril"),
               PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "mythril_tpu_torch", *cmd], capture_output=True,
                          text=True, timeout=300, env=env, cwd=tmp)
    wall_c = time.perf_counter() - t0
    check(proc.returncode == 0, f"--compile-cache-dir: exit {proc.returncode}: "
          f"{proc.stderr[-1500:]}")
    with open(metrics_path) as f:
        m = json.load(f)["metrics"]
    cache = {k: m.get(k) for k in ("compilecache.hits", "compilecache.misses",
                                   "device.cache_hits", "device.cache_misses")}
    print(f"  --compile-cache-dir with the library copied in: {cache}, "
          f"the directory {listing} -> {sorted(os.listdir(seeded))}, {wall_c:.1f} s")
    check(cache["compilecache.hits"] == 1 and cache["compilecache.misses"] == 0
          and not cache["device.cache_misses"]
          and sorted(f for f in os.listdir(seeded) if not f.endswith(".lock")) == listing,
          "the seeded build cache was not a hit without a build")

    # the metrics history, read back by history and drift
    rows = printed(["history", "query", "--dir", hist]).splitlines()
    drift = json.loads(printed(["drift", "--history", hist, "--window", "1", "-o", "json"]))
    print(f"  --history-dir: {len(rows)} records read back by history query; drift --history "
          f"mode {drift.get('mode')}, {len(drift.get('ranked', []))} ranked")
    check(len(rows) >= 2 and drift.get("mode") == "history",
          f"history query read {len(rows)} records, drift mode {drift.get('mode')}")
    seconds = time.perf_counter() - t_phase
    print(f"  phase 8k took {seconds:.1f} s")
    row = {"run": TRACED_RUN, "walls": walls, "resumed_launches": resumed,
           "uninterrupted_launches": whole, "heartbeat_samples": len(during),
           "syncs": {"pipelined_by_thread": dict(by_thread), "on": sum(on.values()),
                     "off": sum(off.values())},
           "build_cache": cache, "card": card, "seconds": seconds}
    return resumed, row


# phase 8l: the recorded service submissions (tests/test_torch_service.py
# SUBMISSIONS: contract, tenant, tier) and their JAX service record
SERVICE_FIXTURE = ROOT / "tests" / "testdata" / "torch_service_runs.json"
SERVICE_SUBMISSIONS = (
    ("etherstore_like", "t1", "interactive"),
    ("rubixi_like", "t2", "batch"),
    ("kill_simple", "t1", "batch"),
    ("etherstore_like", "t2", "batch"),
)
CLEAN_HEX = "60006000f3"  # PUSH1 0; PUSH1 0; RETURN


def service_contract(name: str) -> str:
    if name == "kill_simple":
        return (ROOT / "tests" / "testdata" / "inputs" / "kill_simple.bin-runtime").read_text().strip()
    from tests import _torch_contracts

    return getattr(_torch_contracts, name)().hex()


@contextlib.contextmanager
def engine_flags():
    """The engine's flags, the query cache and the kernel build cache's
    directory as they were, after a service in this process armed them."""
    import dataclasses

    from mythril_tpu_torch.ops import _build
    from mythril_tpu_torch.querycache import configure
    from mythril_tpu_torch.support.support_args import args

    saved = dataclasses.replace(args)
    try:
        yield
    finally:
        for f in dataclasses.fields(args):
            setattr(args, f.name, getattr(saved, f.name))
        configure(enabled=args.query_cache, cache_dir=args.query_cache_dir)
        _build.set_cache_dir(args.compile_cache_dir)


def fleet_series(text: str, name: str) -> dict:
    """A fleet metric's samples in the ``metrics`` verb's exposition: label
    string ("" for the rollup) -> value."""
    out = {}
    for line in text.splitlines():
        if line.startswith(name + "{") or line.startswith(name + " "):
            key, value = line.rsplit(" ", 1)
            out[key[len(name):].strip("{}")] = float(value)
    return out


def service_runs(torch, card: str):
    """Phase 8l (see the module docstring) -> (the inline batch's launches,
    the phase's row)."""
    import os
    import shutil
    import signal
    import socket
    import tempfile
    import threading

    from mythril_tpu_torch.frontier import engine as fengine
    from mythril_tpu_torch.interfaces import cli
    from mythril_tpu_torch.observability import get_registry
    from mythril_tpu_torch.ops import _build
    from mythril_tpu_torch.service import (
        AnalysisOptions,
        AnalysisService,
        ServiceConfig,
        canonical_codehash,
        issue_digest,
    )
    from mythril_tpu_torch.service.client import ServiceClient
    from mythril_tpu_torch.service.server import wait_for_server
    from tests import test_torch_cli as T

    t_phase = phase("the analysis service on the card: inline and pooled, submit over TCP, top, "
                    "health, a killed worker, SIGTERM, a device fault")
    with open(SERVICE_FIXTURE) as f:
        recorded = {r["contract"]: r["digests"] for r in json.load(f)["runs"]}
    opts = AnalysisOptions(transaction_count=2, execution_timeout=60)
    names = list(dict.fromkeys(n for n, _t, _r in SERVICE_SUBMISSIONS))

    # solo: the command line's analyze of each contract on the card
    solo, solo_walls = {}, {}
    for name in names:
        code = service_contract(name)
        t0 = time.perf_counter()
        rc, out = T.run_port(["analyze", "-c", code, "--bin-runtime", "-t", "2",
                              "--execution-timeout", "60", "-o", "json"],
                             device=None, calibrated=True)
        solo_walls[name] = time.perf_counter() - t0
        check(rc == 0, f"solo analyze of {name}: exit {rc}")
        codehash = canonical_codehash(code)
        solo[name] = sorted([i["swc-id"], i["address"], codehash, i["title"], i["function"]]
                            for i in T._last_json_line(out)["issues"])
        check(solo[name] == recorded[name],
              f"solo analyze of {name}: digests differ from the JAX service record")
    print(f"  solo analyze on the card: {[(n, len(solo[n]), round(solo_walls[n], 3)) for n in names]}"
          " (issues, wall s)")

    # inline: the service in this process, at its defaults on the card
    with engine_flags():
        service = AnalysisService(ServiceConfig(default_options=opts, max_batch_width=8,
                                                batch_window_s=0.3)).start()
        try:
            check(service.wait_warm(timeout=300), "the inline service did not warm up")
            zero_launches()
            t0 = time.perf_counter()
            subs = [service.submit(service_contract(n), name=n, tier=tier, tenant=tenant)
                    for n, tenant, tier in SERVICE_SUBMISSIONS]
            answers = [list(stream.events(timeout=600)) for _r, stream, _d in subs]
            torch.cuda.synchronize()
            wall_inline = time.perf_counter() - t0
            inline = read_launches()
            stats = service.stats()
        finally:
            check(service.stop(drain=True, timeout=120), "the inline service did not drain")
    for (name, tenant, _tier), events in zip(SERVICE_SUBMISSIONS, answers):
        kind, payload = events[-1]
        got = sorted(list(issue_digest(i)) for i in payload["issues"]) if kind == "done" else None
        check(got == solo[name] == recorded[name],
              f"inline {name} ({tenant}): {events[-1][0]}, digests differ from the solo run or "
              "the JAX record")
    deduped = [d for _r, _s, d in subs]
    phases = {p: {k: s.get(k) for k in ("count", "p50", "p95")}
              for p, s in stats["phases"].items()}
    print(f"  inline: {len(subs)} requests in {wall_inline:.3f} s, {stats['service.batches']} "
          f"batches, deduped {deduped}; launches {inline}")
    print(f"  inline phases (s, bucketed percentiles): {phases} ({card})")
    check(deduped == [False, False, False, True], f"dedup flags {deduped}")
    for name in ("frontier_segment", "known_bits", "dpll"):
        check(inline[name] > 0, f"the inline service's batch launched {name} no time")

    # pooled: serve --workers 2 in a process of its own, over TCP, with the
    # built library in its cache root
    tmp = tempfile.mkdtemp(prefix="service-")
    kernels = os.path.join(tmp, "cache", "kernels")
    os.makedirs(kernels)
    shutil.copy2(_build.library_path(), kernels)
    listing = sorted(os.listdir(kernels))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, MYTHRIL_DIR=os.path.join(tmp, "mythril"),
               PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "mythril_tpu_torch", "serve", "--workers", "2",
         "--batch-width", "1", "--cache-root", os.path.join(tmp, "cache"), "--port", str(port)],
        cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    pooled_row = {}
    try:
        check(wait_for_server("127.0.0.1", port, timeout=240), "serve --workers 2 did not listen")
        client = ServiceClient("127.0.0.1", port, timeout=600)

        def cli_json(argv):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = cli.main(argv + ["--port", str(port)])
            return rc, out.getvalue()

        rc, out = cli_json(["health", "-o", "json"])
        print(f"  health of the fresh service: exit {rc}, ok {json.loads(out).get('ok')}")
        check(rc == 0, f"health of the fresh service: exit {rc}")
        results = {}

        def submit(i, name, tenant, tier, **kw):
            events = list(ServiceClient("127.0.0.1", port, timeout=600).submit_stream(
                service_contract(name), name=name, tier=tier, tenant=tenant, **kw))
            results[i] = events

        t1 = time.perf_counter()
        threads = [threading.Thread(target=submit, args=(i, *s)) for i, s in
                   enumerate(SERVICE_SUBMISSIONS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall_pooled = time.perf_counter() - t1
        for i, (name, tenant, _tier) in enumerate(SERVICE_SUBMISSIONS):
            events = results.get(i, [])
            check(events and events[-1]["event"] == "done",
                  f"pooled {name} ({tenant}): {events[-1] if events else 'no answer'}")
            got = sorted(list(issue_digest(x)) for x in events[-1]["issues"])
            check(got == solo[name] == recorded[name],
                  f"pooled {name} ({tenant}): digests differ from the solo run or the JAX record")
        dedups = [results[i][0].get("deduped") for i in range(len(SERVICE_SUBMISSIONS))]
        check(dedups.count(True) == 1 and not any(dedups[1:3]),
              f"pooled dedup flags {dedups}: one of the two etherstore_like submissions")
        pstats = client.stats()
        pids = sorted({w["pid"] for w in pstats["workers"]})
        metrics = client.metrics()
        seg = fleet_series(metrics, "fleet_frontier_segment_device_s_count")
        hits = fleet_series(metrics, "fleet_compilecache_hits")
        misses = fleet_series(metrics, "fleet_compilecache_misses")
        print(f"  pooled: {len(results)} requests in {wall_pooled:.3f} s (serve up "
              f"{t1 - t0:.1f} s after its start), workers {pids}, dedup {dedups}; fleet "
              f"segment dispatches {seg}, compilecache hits {hits}, misses {misses}")
        check(pstats["scope"] == "fleet" and len(pids) == 2, f"worker pids {pids}")
        check(seg.get("", 0) > 0, "no worker's segment dispatch reached the fleet rollup")
        check(hits.get('worker="0"') == 1 and hits.get('worker="1"') == 1
              and not any(misses.values()),
              f"compilecache hits {hits}, misses {misses}: each worker should load the seeded "
              "library once")
        check(sorted(f for f in os.listdir(kernels) if not f.endswith(".lock")) == listing,
              "a worker built into the seeded cache")
        rc, out = cli_json(["top", "--once"])
        print(f"  top --once: exit {rc}, {len(out.splitlines())} lines")
        check(rc == 0, f"top --once: exit {rc}")
        # health gates on the SLO verdict: exit 1 exactly when an objective breaches
        rc, out = cli_json(["health", "-o", "json"])
        health = json.loads(out)
        print(f"  health after the requests: exit {rc}, ok {health.get('ok')}, breaching "
              f"{health.get('breaching')}")
        check(rc == (1 if health.get("enabled") and not health.get("ok") else 0),
              f"health: exit {rc} against its verdict {health.get('ok')}")
        # a busy worker killed: its request errors, the pool respawns it
        th = threading.Thread(target=submit, args=("long", "etherstore_like", "t1", "batch"),
                              kwargs={"transaction_count": 3})
        th.start()
        victim, deadline = None, time.time() + 120
        while victim is None and time.time() < deadline:
            busy = [w for w in client.stats()["workers"] if w.get("job") is not None]
            victim = busy[0]["pid"] if busy else None
            time.sleep(0.02)
        check(victim is not None, "no worker went busy on the long request")
        os.kill(victim, signal.SIGKILL)
        th.join(timeout=300)
        last = results.get("long", [{}])[-1]
        print(f"  SIGKILL of busy worker pid {victim}: {last}")
        check(last.get("event") == "error" and "died mid-batch" in last.get("error", ""),
              f"the killed worker's request: {last}")
        deadline = time.time() + 120
        while time.time() < deadline and not client.stats().get("service.worker_restarts"):
            time.sleep(0.1)
        restarts = client.stats().get("service.worker_restarts")
        submit("after", "kill_simple", "t2", "batch", transaction_count=1)
        after = results["after"][-1]
        print(f"  worker_restarts {restarts}; the next request: {after.get('event')}, "
              f"{len(after.get('issues', []))} issues")
        check(restarts and restarts >= 1 and after.get("event") == "done"
              and [i["swc_id"] for i in after["issues"]] == ["106"],
              "no respawn, or the next request failed")
        pooled_row = {"wall_s": wall_pooled, "startup_s": t1 - t0, "pids": pids,
                      "segment_dispatches": seg.get(""), "compilecache_hits": hits,
                      "restarts": restarts}
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
        try:
            rc_serve = proc.wait(timeout=180)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc_serve = None
        err = proc.stderr.read()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"  SIGTERM: serve exit {rc_serve}")
    check(rc_serve == 0, f"serve --workers 2 exit {rc_serve} after SIGTERM: {err[-1500:]}")

    # a device fault: the card's OutOfMemoryError inside an inline batch
    drain = fengine.drain_lasers

    def oom_drain(*a, **kw):
        torch.empty(1 << 50, dtype=torch.uint8, device="cuda")  # a petabyte
        return drain(*a, **kw)

    batches = get_registry().counter("service.batches", persistent=True)
    with engine_flags():
        fengine.drain_lasers = oom_drain
        try:
            service = AnalysisService(ServiceConfig(
                default_options=AnalysisOptions(transaction_count=1, execution_timeout=30),
                max_batch_width=4, batch_window_s=0.3, probe=False, warmup=False)).start()
            before = batches.snapshot() or 0
            subs = [service.submit(service_contract("kill_simple"), name="kill"),
                    service.submit(CLEAN_HEX, name="clean")]
            answers = [list(stream.events(timeout=300))[-1] for _r, stream, _d in subs]
            fault = service.fault
            try:
                service.submit(service_contract("kill_simple"), name="late")
                refused = False
            except RuntimeError:
                refused = True
            check(service.stop(drain=True, timeout=60), "the faulted service did not stop")
            ran = batches.snapshot() - before
        finally:
            fengine.drain_lasers = drain
    print(f"  the card's OutOfMemoryError in an inline batch: {[a[0] for a in answers]}, "
          f"{answers[0][1][:90]}; service fault {type(fault).__name__}, new submission "
          f"{'refused' if refused else 'accepted'}, {ran} batch")
    check(all(k == "error" and "OutOfMemoryError" in str(p) for k, p in answers),
          f"the batch's requests: {answers}")
    check(isinstance(fault, torch.OutOfMemoryError) and refused and ran == 1,
          "the device fault did not stop the inline service")
    seconds = time.perf_counter() - t_phase
    print(f"  phase 8l took {seconds:.1f} s")
    row = {"solo_walls": solo_walls, "inline_wall_s": wall_inline, "inline_launches": inline,
           "inline_phases": phases, "pooled": pooled_row, "card": card, "seconds": seconds}
    return inline, row

MESH_SHARDS = 4
POD_FIXTURE = ROOT / "tests" / "testdata" / "torch_pod_runs.json"
# the pod run's widths on the mesh: the recording's 64, and 62, which 4
# shards do not divide (2 padded slots a frontier run)
MESH_WIDTHS = (64, 62)


def frontier_example(n_paths: int, device, arena_rows: Optional[int] = None):
    """The port's own ``__graft_entry__._frontier_example``: ``n_paths``
    slots, the first half each at a symbolic JUMPI over a minimal program
    (each forks a child into the free half); an arena of ``arena_rows``
    (default ``Caps.ARENA``).  -> (segment, (state on the host, arena,
    arena_len, visited, code, cfg) with the tensors on ``device``)."""
    import numpy as np
    import torch

    from mythril_tpu_torch.frontier import interop
    from mythril_tpu_torch.frontier import ops as O
    from mythril_tpu_torch.frontier.arena import HostArena
    from mythril_tpu_torch.frontier.code import CodeTables, stacked_device_tables
    from mythril_tpu_torch.frontier.state import Caps, empty_state
    from mythril_tpu_torch.frontier.step import CfgScalars, cached_segment
    from mythril_tpu_torch.smt import terms as T

    Ins = collections.namedtuple("Ins", "opcode address arg_int")
    program = [Ins("JUMPI", 0, None), Ins("PUSH1", 1, 1), Ins("PUSH1", 3, 2), Ins("ADD", 5, None),
               Ins("POP", 6, None), Ins("STOP", 7, None), Ins("JUMPDEST", 8, None),
               Ins("STOP", 9, None)]
    caps = Caps(B=n_paths, ARENA=arena_rows or Caps.ARENA)
    arena = HostArena(caps.ARENA)
    row_zero, row_one = arena.const_row(0, 256), arena.const_row(1, 256)
    dest_row = arena.const_row(8, 256)
    conds = [arena.var_row(T.var(f"mesh_c{i}", 256)) for i in range(n_paths // 2)]
    tables = CodeTables(program, arena)
    icap, acap, lcap = tables.size_bucket()
    segment = cached_segment(caps, 1, icap, acap, lcap, device=device)
    code = interop.code_to_torch(stacked_device_tables([tables], (1, icap, acap, lcap)), device)
    st = empty_state(caps, lcap)
    for slot in range(n_paths // 2):
        st.seed[slot], st.halt[slot] = 0, O.H_RUNNING
        st.stack[slot, 0], st.stack[slot, 1], st.stack_len[slot] = conds[slot], dest_row, 2
    dev_arena = interop.arena_to_torch(arena.device_arrays(), device)
    visited = torch.zeros((3, 1, icap), dtype=torch.bool, device=device)
    cfg = CfgScalars(max_depth=128, loop_bound=0, row_zero=int(row_zero), row_one=int(row_one),
                     sel_mode=0)
    return segment, (st, dev_arena, arena.length, visited, code, cfg)


def _mesh_problem(n: int, seed: int):
    """Two conjunctions (a sum and a bound; a keccak of a 64-byte preimage
    under a bound) and ``n`` numpy-seeded candidates, every other one with
    x + y = 100."""
    import numpy as np

    from mythril_tpu_torch.smt import terms as T
    from mythril_tpu_torch.smt.concrete_eval import Assignment

    x, y = T.var("mesh_x", 256), T.var("mesh_y", 256)
    pre = T.concat(*[T.extract(255 - 8 * i, 248 - 8 * i, x) for i in range(32)],
                   *[T.extract(255 - 8 * i, 248 - 8 * i, y) for i in range(32)])
    conjs = ([T.eq(T.add(x, y), T.const(100, 256)), T.ult(x, T.const(60, 256))],
             [T.ult(T.keccak(pre), T.const(1 << 255, 256)), T.ult(y, T.const(90, 256))])
    rng = np.random.default_rng(seed)
    asgs = []
    for i, (a, b) in enumerate(rng.integers(0, 100, size=(n, 2))):
        asg = Assignment()
        # every other candidate on the sum's line, so some rows satisfy it
        asg.scalars[x], asg.scalars[y] = int(a), int(100 - a if i % 2 else b)
        asgs.append(asg)
    return conjs, asgs


def mesh_checks(torch, shards: Optional[int], card: str) -> dict:
    """Phase 8m's checks on the mesh ``make_frontier_mesh()`` gives inside
    ``logical_shards(shards)`` (None: every visible card).  -> the row."""
    import numpy as np

    from mythril_tpu_torch.frontier import interop
    from mythril_tpu_torch.frontier.step import segment_torch
    from mythril_tpu_torch.ops import lowering
    from mythril_tpu_torch.parallel import (
        evaluate_batch_sharded,
        frontier_step,
        make_frontier_mesh,
        pack_frontier,
        shard_frontier_inputs,
        shard_probe_args,
    )
    from mythril_tpu_torch.parallel.mesh import logical_shards
    from tests.test_torch_pod import WIDE, _analyze

    def scope():
        return logical_shards(shards) if shards else contextlib.nullcontext()

    with scope():
        mesh = make_frontier_mesh()
        mesh_2d = make_frontier_mesh(path_size=2) if mesh.size % 2 == 0 else mesh
    n = mesh.size
    devices = [str(d) for d in mesh.devices.flat]
    label = f"{n} logical shards of {devices[0]}" if shards else f"{n} cards"
    row = {"mesh": label, "devices": devices, "card": card}
    # the sharded probe: 37 candidates (padded to a multiple of n) over the
    # mesh, one lowering launch per block on its device
    for ci, conj in enumerate(_mesh_problem(0, 0)[0]):
        asgs = _mesh_problem(37, 20 + ci)[1]
        compiled = lowering.compile_conjunction(conj)
        zero_launches()
        truth_mesh = evaluate_batch_sharded(compiled, asgs, mesh)
        per_device = dict(lowering.launches_by_device)
        want = collections.Counter(str(d) for d in mesh.devices.flat)
        check(lowering.launches == n and per_device == dict(want),
              f"8m {label}: the sharded eval launched the lowering {per_device}, not once per "
              f"shard {dict(want)}")
        truth_single = compiled.evaluate_batch(asgs)
        # the whole calls (packing, the blocks' copies, the gathers), warm
        mesh_ms = cuda_ms(lambda: evaluate_batch_sharded(compiled, asgs, mesh), 10)
        single_ms = cuda_ms(lambda: compiled.evaluate_batch(asgs), 10)
        packed = lowering.pack_assignments(compiled, asgs, torch.device(devices[0]))
        truth_plain, plain_ms = cuda_once(
            lambda: lowering.run_lowering_reference(compiled, *packed).cpu().numpy())
        check(np.array_equal(truth_mesh, truth_single) and np.array_equal(truth_mesh, truth_plain),
              f"8m {label}: the sharded truth differs from the single launch or the plain version")
        row[f"probe_{ci}"] = {"B": len(asgs), "C": len(conj), "launches": per_device,
                              "sharded_ms": mesh_ms, "single_ms": single_ms, "plain_ms": plain_ms,
                              "sat_rows": int(truth_mesh.all(axis=1).sum())}
        print(f"  {label}: evaluate_batch_sharded B=37 C={len(conj)}: lowering launches "
              f"{per_device}, {mesh_ms:.4f} ms a call (evaluate_batch, one launch, "
              f"{single_ms:.4f} ms; plain {plain_ms:.3f} ms once); truth equal, "
              f"{row[f'probe_{ci}']['sat_rows']} rows sat")
    # frontier_step over (path, cand): 4 paths x up to 8 candidates, ragged
    conj = _mesh_problem(1, 0)[0][0]
    compiled = lowering.compile_conjunction(conj)
    rng = np.random.default_rng(7)
    frontier = [_mesh_problem(int(k), 30 + p)[1] for p, k in
                enumerate([8, *rng.integers(1, 9, size=3)])]
    args, valid = pack_frontier(compiled, frontier)
    zero_launches()
    step = frontier_step(compiled)
    sharded_args = shard_probe_args(args, mesh_2d, batch_dims=2)
    got = [v.cpu().numpy() for v in step(*sharded_args, valid)]
    step_launches = lowering.launches
    step_ms = cuda_ms(lambda: step(*sharded_args, valid), 10)  # the blocks already placed
    flat = tuple(x.reshape((-1,) + tuple(x.shape[2:])).to(devices[0]) for x in args[0])
    truth = lowering.run_lowering_reference(
        compiled, flat, args[1].reshape(-1, args[1].shape[-1]).to(devices[0]),
        [tuple(x.reshape((-1,) + tuple(x.shape[2:])).to(devices[0]) for x in t) for t in args[2]]
    ).cpu().numpy().reshape(valid.shape + (len(conj),))
    scores = np.where(valid, truth.sum(-1), -1)
    plain = [scores, scores.max(-1), scores.argmax(-1), (scores == len(conj)).sum()]
    check(step_launches == mesh_2d.size and all(np.array_equal(a, b) for a, b in zip(got, plain)),
          f"8m {label}: frontier_step on {mesh_2d.shape} differs from the plain reductions or "
          f"launched the lowering {step_launches} times")
    row["frontier_step"] = {"mesh": mesh_2d.shape, "P_B": list(valid.shape), "ms": step_ms,
                            "launches": step_launches, "n_sat": int(got[3])}
    print(f"  {label}: frontier_step on {mesh_2d.shape}, P x B = {valid.shape}: "
          f"{step_launches} lowering launches, {step_ms:.4f} ms a call, n_sat {int(got[3])}, best "
          f"{got[1].tolist()} at {got[2].tolist()}: equal to the plain reductions")
    # the segment example: the partitioned dispatch (one launch holding
    # every logical shard, or one launch per card) against the unsharded
    # launch and both plain versions, bit for bit; the two launches timed in
    # turns (unsharded, partitioned, partitioned, unsharded)
    from mythril_tpu_torch.frontier.state import Caps
    from mythril_tpu_torch.frontier.step import segment_partitioned_torch

    per_dispatch = 1 if shards else n
    segment, (st, arena, arena_len, visited, code, cfg) = frontier_example(2 * n, devices[0])
    inputs = (interop.state_to_torch(st, devices[0]), arena, arena_len, visited, code, cfg)
    zero_launches()
    single = interop.outputs_to_numpy(segment(*inputs))
    mst, marena, mvis, mcode = shard_frontier_inputs(st, arena, visited, code, make_frontier_mesh(
        list(mesh.devices.flat), path_size=n))
    sharded = interop.outputs_to_numpy(segment(mst, marena, arena_len, mvis, mcode, cfg))
    seg_launches = read_launches()
    turns = {"unsharded": [], "partitioned": []}
    for which in ("unsharded", "partitioned", "partitioned", "unsharded"):
        turns[which].append(cuda_ms(
            (lambda: segment(*inputs)) if which == "unsharded"
            else (lambda: segment(mst, marena, arena_len, mvis, mcode, cfg)), 10))
    plain_out = interop.outputs_to_numpy(segment_torch(*inputs, Caps(B=2 * n)))
    plain_part = interop.outputs_to_numpy(segment_partitioned_torch(
        mst, marena, arena_len, mvis, mcode, cfg, Caps(B=2 * n)))
    same = all(frontier_err(sharded, out) == 0 for out in (single, plain_out, plain_part))
    check(same and seg_launches["frontier_segment"] == 1
          and seg_launches["frontier_segment_partitioned"] == per_dispatch and sharded[3] > 0,
          f"8m {label}: the partitioned segment differs from the unsharded launch or the plain "
          f"versions, or launched {seg_launches} (one unsharded, {per_dispatch} partitioned)")
    row["segment"] = {"B": 2 * n, "n_exec": sharded[3], "arena_len": sharded[2],
                      "launches": seg_launches, "turns_ms": turns}
    print(f"  {label}: the segment example at B = {2 * n}: the partitioned form "
          f"({per_dispatch} launch{'es' if per_dispatch > 1 else ''} a dispatch) bit-identical to "
          f"the unsharded launch, segment_torch and segment_partitioned_torch "
          f"({sharded[3]} steps); "
          f"ms a dispatch in turns: unsharded {turns['unsharded'][0]:.4f}, partitioned "
          f"{turns['partitioned'][0]:.4f}, {turns['partitioned'][1]:.4f}, unsharded "
          f"{turns['unsharded'][1]:.4f}")
    if not shards:
        row["wide"] = partitioned_beyond_one_card(torch, mesh, label)
    # the pod parity contract, pipelined on the mesh, and once with --no-mesh
    rec = json.loads(POD_FIXTURE.read_text())["runs"]["storage_gate/64"]
    pods = {}
    for width in MESH_WIDTHS:
        zero_launches()
        t0 = time.perf_counter()
        with scope():
            got = _analyze("mythril_tpu_torch", width, mesh=True, device=None)
        wall = time.perf_counter() - t0
        launched = read_launches()
        check(got["summary"] == rec["mesh"]["summary"], f"8m {label} pod run at {width}: issue "
              f"keys {got['summary']} differ from the recording's {rec['mesh']['summary']}")
        check(got["mesh_devices"] == got["mesh_shards"] == n
              and got["pull_shards"] == [f"shard{k}" for k in range(n)]
              and got["segments_pipelined"] > 0
              and (got["mesh_pad_slots"] > 0) == (width % n > 0)
              and launched["frontier_segment_partitioned"] > 0
              and launched["frontier_segment"] == 0,
              f"8m {label} pod run at {width}: mesh counters {got}, launches {launched}")
        pods[width] = {**{k: got[k] for k in ("mesh_devices", "mesh_shards", "mesh_pad_slots",
                                              "segments_pipelined")},
                       "wall_s": wall, "launches": launched}
        print(f"  {label}: pod run at width {width}: keys as recorded, mesh_devices "
              f"{got['mesh_devices']}, mesh_shards {got['mesh_shards']}, {len(got['pull_shards'])} "
              f"per-shard pull keys, mesh_pad_slots {got['mesh_pad_slots']}, segments_pipelined "
              f"{got['segments_pipelined']}, {wall:.3f} s, launches {launched}")
    # mesh against --no-mesh on the pod contract and on bench.py's wide
    # contract of 7 branches, both at 64; the wide one's spills are
    # re-injected at sync points (the rebalance).  Over several cards in
    # turns (mesh, --no-mesh, --no-mesh, mesh); on logical shards one pair,
    # which keeps the script's wall on one card.  Every run holds the
    # recording's keys for its mode
    order = (True, False) if shards else (True, False, False, True)
    for name in ("storage_gate", WIDE):
        want = json.loads(POD_FIXTURE.read_text())["runs"][f"{name}/64"]
        turns = {"mesh": [], "no_mesh": []}
        for on in order:
            mode = "mesh" if on else "no_mesh"
            zero_launches()
            t0 = time.perf_counter()
            with scope():
                got = _analyze("mythril_tpu_torch", 64, mesh=on, device=None, name=name)
            wall = time.perf_counter() - t0
            check(got["summary"] == want[mode]["summary"]
                  and got["mesh_devices"] == (n if on else 0)
                  and (not on or name != WIDE
                       or got["rebalance_syncs"] > 0 and got["rebalanced_slots"] > 0),
                  f"8m {label}: the {name} run at 64 ({mode}) {got} against the recording's "
                  f"keys {want[mode]['summary']}, or no rebalance")
            turns[mode].append({"wall_s": wall, "segments_pipelined": got["segments_pipelined"],
                                "rebalance_syncs": got["rebalance_syncs"],
                                "rebalanced_slots": got["rebalanced_slots"],
                                "launches": read_launches()})
        pods[f"{name}_turns"] = turns
        mesh_s = [t["wall_s"] for t in turns["mesh"]]
        off_s = [t["wall_s"] for t in turns["no_mesh"]]
        print(f"  {label}: {name} at 64: keys as recorded; mesh "
              f"{', '.join(f'{w:.4f}' for w in mesh_s)} s (rebalance_syncs "
              f"{turns['mesh'][0]['rebalance_syncs']}, "
              f"rebalanced_slots {turns['mesh'][0]['rebalanced_slots']}; the JAX package on "
              f"its {want['jax_devices']} devices: {want['mesh']['rebalance_syncs']}, "
              f"{want['mesh']['rebalanced_slots']}), --no-mesh "
              f"{', '.join(f'{w:.4f}' for w in off_s)} s; "
              f"mesh/--no-mesh {sum(mesh_s) / sum(off_s):.3f}")
    row["pod"] = pods
    return row


def partitioned_beyond_one_card(torch, mesh, label: str) -> dict:
    """Over several cards: a batch of twice one card's widest launch
    (``step.max_paths``), which one card refuses, runs partitioned, one
    launch per card, bit-identical to ``segment_torch``; the command line's
    width check takes it with the mesh and refuses it with ``--no-mesh``."""
    import types

    from mythril_tpu_torch.frontier import interop
    from mythril_tpu_torch.frontier.state import Caps
    from mythril_tpu_torch.frontier.step import max_paths, segment_cuda, segment_torch
    from mythril_tpu_torch.interfaces import cli
    from mythril_tpu_torch.ops import _build
    from mythril_tpu_torch.parallel import shard_frontier_inputs

    devices = list(mesh.devices.flat)
    one = max_paths(devices[0])
    wide = 2 * one
    limit = max_paths(devices[0], devices=devices)
    rows = 1 << 20
    segment, (st, arena, arena_len, visited, code, cfg) = frontier_example(wide, devices[0], rows)
    caps = Caps(B=wide, ARENA=rows)
    inputs = (interop.state_to_torch(st, devices[0]), arena, arena_len, visited, code, cfg)
    refused = None
    try:
        segment_cuda(*inputs, caps)
        torch.cuda.synchronize()
    except _build.KernelLaunchError as e:
        refused = str(e)
    mst, marena, mvis, mcode = shard_frontier_inputs(st, arena, visited, code, mesh)
    zero_launches()
    got, part_ms = cuda_once(lambda: interop.outputs_to_numpy(
        segment(mst, marena, arena_len, mvis, mcode, cfg)))
    launched = read_launches()["frontier_segment_partitioned"]
    want, plain_ms = cuda_once(lambda: interop.outputs_to_numpy(segment_torch(*inputs, caps)))
    width_ok = {}
    for on in (True, False):
        parsed = types.SimpleNamespace(frontier=True, device=None, frontier_mesh=on,
                                       frontier_width=wide)
        try:
            cli.check_frontier_width(parsed)
            width_ok[on] = True
        except cli.Refused:
            width_ok[on] = False
    check(refused is not None and launched == len(devices) and frontier_err(got, want) == 0
          and got[3] > 0 and limit >= wide and width_ok == {True: True, False: False},
          f"8m {label}: a batch of {wide} paths (one card's limit {one}): refused by one card "
          f"{refused is not None}, {launched} partitioned launches, equal to segment_torch "
          f"{frontier_err(got, want) == 0}, the mesh's limit {limit}, the width check {width_ok}")
    print(f"  {label}: B = {wide} paths (twice one card's {one}): one card refuses it, the "
          f"partitioned segment runs it in {launched} launches ({got[3]} steps, {part_ms:.3f} ms "
          f"with its input copies, once), bit-identical to segment_torch ({plain_ms:.1f} ms "
          f"once); the mesh's limit {limit}; --frontier-width {wide} passes the width check with "
          f"the mesh and is refused with --no-mesh")
    return {"B": wide, "one_card_limit": one, "mesh_limit": limit, "launches": launched,
            "n_exec": got[3], "partitioned_ms_once": part_ms, "plain_ms": plain_ms}


def mesh_runs(torch, card: str):
    """Phase 8m: the device mesh on a mesh of ``MESH_SHARDS`` logical shards
    of the card, then over every card when there are several; first, the
    pod contract at the defaults, where one card means no mesh.  -> (the
    launches of the logical mesh's pod run at 64, the row)."""
    from tests.test_torch_pod import _analyze

    t_phase = phase("the device mesh: the sharded probe, frontier_step, the segment and the pod "
                    f"run on {MESH_SHARDS} logical shards of the card")
    zero_launches()
    default = _analyze("mythril_tpu_torch", 64, mesh=True, device=None)
    check(default["mesh_devices"] == 0 if torch.cuda.device_count() == 1
          else default["mesh_devices"] == torch.cuda.device_count(),
          f"8m: the default pod run's mesh_devices {default['mesh_devices']} on "
          f"{torch.cuda.device_count()} cards")
    print(f"  the pod contract at the defaults on {torch.cuda.device_count()} card(s): "
          f"mesh_devices {default['mesh_devices']}")
    row = {"logical": mesh_checks(torch, MESH_SHARDS, card)}
    if torch.cuda.device_count() > 1:
        row["cards"] = mesh_checks(torch, None, card)
    else:
        print("  the checks over several cards were not run: torch.cuda.device_count() is 1")
    row["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 8m took {row['seconds']:.1f} s")
    return row["logical"]["pod"][64]["launches"], row


def device_fault(torch) -> None:
    """A real ``torch.OutOfMemoryError`` from the card, raised inside a
    harvest replay (an allocation the card cannot hold), must reach the
    harvest's caller, with replay workers and without."""
    import numpy as np

    from mythril_tpu_torch.frontier import harvest
    from tests.test_torch_harvest import _FakeEngine, _finished, _Laser

    for workers in (0, 4):
        caps, st, records, walker = _finished("mythril_tpu_torch", 8, 4, [_Laser(), _Laser()])

        class CardWalker(type(walker)):
            def replay(self, rec):
                if self.slot_of[id(rec)] == 2:
                    torch.empty(1 << 50, dtype=torch.uint8, device="cuda")  # a petabyte
                super().replay(rec)

        walker.__class__ = CardWalker
        raised = None
        try:
            harvest.HarvestExecutor(_FakeEngine(caps), workers=workers).harvest(
                st, records, walker, np.zeros(caps.B, np.int64))
        except torch.OutOfMemoryError as e:
            raised = e
        finally:
            harvest.shutdown_replay_pool()
        print(f"  a harvest replay's torch.OutOfMemoryError from the card, {workers} workers: "
              f"{'raised to the caller' if raised else 'not raised'} "
              f"({str(raised).splitlines()[0][:80] if raised else ''})")
        check(raised is not None, f"the card's OutOfMemoryError in a replay ({workers} workers) "
              "did not reach the harvest's caller")


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
        want, plain = cuda_once(lambda: domains.eval_kb_plain(*inputs, r))
        err = 0 if all(torch.equal(g, w) for g, w in zip((km, kv, refuted), want)) else 1
        wrapper = cuda_ms(lambda: device.known_bits(*inputs, r, plan=plan), reps)
        device.run_kb(pack, "cuda")
        run_kb = host_ms(lambda: device.run_kb(pack, "cuda"), reps)
        parts = {"inputs_ms": host_ms(lambda: domains.kb_inputs(pack, "cuda"), reps),
                 "plan_ms": host_ms(lambda: device.pack_plan(pack), reps),
                 "download_ms": host_ms(lambda: (km.cpu(), kv.cpu(), refuted.cpu()), reps)}
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
        want, plain = cuda_once(lambda: kernel.run_plain(lits, dec, n_vars, iters))
        err = 0 if all(torch.equal(g, w) for g, w in zip((status, assign, steps), want)) else 1
        wrapper = cuda_ms(lambda: device.dpll(lits, dec, n_vars, iters), reps)
        plane = kernel.Plane(lits.cpu().numpy(), dec.cpu().numpy(), q, n_vars)
        device.run_device(plane, iters, "cuda")
        t0 = time.perf_counter()
        for _ in range(reps):
            device.run_device(plane, iters, "cuda")
        run_device = (time.perf_counter() - t0) * 1e3 / reps
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
        d_launches, d_rows = defaults_runs(torch, card, t_rows)
        for name in ("tape_vm", "frontier_segment", "known_bits", "dpll"):
            check(d_launches[name] > 0, f"the engine's default-tier runs launched {name} no time")
        p_launches, p_rows = pipeline_runs(torch, card)
        for name in ("tape_vm", "frontier_segment", "known_bits", "dpll"):
            check(p_launches[name] > 0, f"the pipelined runs launched {name} no time")
        a_launches, a_rows = adaptive_runs(torch, card)
        for name in ("tape_vm", "frontier_segment", "known_bits", "dpll"):
            check(a_launches[name] > 0, f"the adaptive runs launched {name} no time")
        cli_launches, cli_rows = cli_runs(torch, card, c_rows, t_rows, d_rows)
        for name in ("tape_vm", "keccak_f1600", "frontier_segment", "known_bits", "dpll"):
            check(cli_launches[name] > 0, f"the command line's runs launched {name} no time")
        h_launches, h_rows = auto_runs(torch, card)
        i_launches, i_auto, i_rows = concolic_runs(torch, card)
        j_launches, j_row = traced_runs(torch, card)
        for name in ("tape_vm", "frontier_segment", "known_bits", "dpll"):
            check(j_launches[name] > 0, f"the traced run launched {name} no time")
        k_launches, k_row = health_runs(torch, card)
        l_launches, l_row = service_runs(torch, card)
        m_launches, m_row = mesh_runs(torch, card)
        for name in ("frontier_segment_partitioned",):
            check(m_launches[name] > 0, f"the mesh's pod run launched {name} no time")
        # the auto path: a query above the calibrated threshold reaches a
        # probe kernel on the card (on the recorded traffic the one that
        # crosses it, a batchTransfer flip, is refused by the tape and goes
        # to the lowering: PERF.md, PR 16)
        auto_probe = {k: h_launches.get(k, 0) + i_auto.get(k, 0) for k in ("tape_vm", "lowering")}
        print(f"  probe launches under auto (8h and 8i): {auto_probe}")
        check(sum(auto_probe.values()) > 0,
              "no query under auto (8h's command lines, 8i's concolic runs) crossed the "
              "calibrated threshold: no probe kernel was launched")
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
        phase(f"the partitioned segment on {MESH_SHARDS} logical shards, per dispatch, in turns "
              "with the single launch (CUDA events)")
        partitioned = summarize(
            "frontier_segment_partitioned",
            time_partitioned(torch, f_kept, f_rows, [torch.device("cuda", 0)] * MESH_SHARDS),
            m_launches["frontier_segment_partitioned"], card, route="cuda",
            source="mythril_tpu_torch/csrc/frontier_segment.cu",
            replaces="mythril_tpu/frontier/step.py:141 (sharded over the mesh's path axis, "
                     "mythril_tpu/parallel/mesh.py:88)")
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
        kernels = [keccak, tape, frontier, partitioned, known_bits, dpll, lower]
        by_path = {"probe": launches, "frontier": f_launches, "engine": e_launches,
                   "engine_cdcl": c_launches, "engine_tiers": t_launches,
                   "engine_defaults": d_launches, "engine_pipeline": p_launches,
                   "engine_adaptive": a_launches, "cli": cli_launches, "auto": h_launches,
                   "concolic": i_launches, "concolic_auto": i_auto, "traced": j_launches,
                   "resumed": k_launches, "service": l_launches, "mesh": m_launches}
        for entry in kernels:
            entry["launches_by_path"] = {path: counts.get(entry["name"], 0)
                                         for path, counts in by_path.items()}
        frontier["engine"] = {"runs": e_rows, "idle_share": e_idle}
        frontier["engine_cdcl"] = {"runs": c_rows, "idle_share": c_idle}
        frontier["cli"] = {"runs": cli_rows}
        known_bits["engine_tiers"] = {"runs": t_rows, "idle_share": t_idle}
        frontier["engine_defaults"] = {"runs": d_rows}
        frontier["engine_pipeline"] = {"runs": p_rows}
        frontier["engine_adaptive"] = {"runs": a_rows}
        tape["auto"] = {"runs": h_rows}
        tape["concolic"] = {"runs": i_rows}
        frontier["traced"] = j_row
        frontier["health"] = k_row
        frontier["service"] = l_row
        frontier["mesh"] = m_row
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
