"""The port's command line: ``python -m mythril_tpu_torch analyze ...``.

Reference parity: mythril/interfaces/cli.py:236-935, by way of the JAX
package's ``interfaces/cli.py``, whose option names, defaults and choices
the port keeps for every option it has.  Subcommands: analyze (a),
disassemble (d), concolic (c), static, safe-functions, list-detectors,
read-storage, function-to-hash, hash-to-address, serve, submit, top,
health, history, drift, version, help.

What differs from the JAX command line:

* ``--device {cuda,cpu}`` (default ``cuda``) picks the analysis' device,
  the port's counterpart of ``JAX_PLATFORMS``.  Without a card ``analyze``,
  ``concolic`` and ``serve`` fail with ``NoCudaDevice`` unless ``--device
  cpu`` is given; nothing moves to the CPU on its own.  ``serve`` passes
  it to every worker, inline or pooled (``ServiceConfig.device``).
* ``--probe-backend`` has the port's backends: ``auto`` (the default, as in
  the JAX package: the card for queries above the calibrated break-even,
  the host below it and on the CPU), ``device`` (the role of the JAX
  package's forced ``jax``), ``host`` and ``cdcl``.
* The known-bits prefilter, the devsolver, the static pass, the query
  cache, the pipelined frontier and the adaptive controller run by default,
  as in the JAX package; ``--no-prefilter``, ``--no-devsolver``,
  ``--no-staticpass``, ``--no-staticpass-interproc``, ``--no-query-cache``,
  ``--no-pipeline`` and ``--no-adaptive`` switch them off, ``--devsolver-bit-budget`` and ``--devsolver-iters`` set
  the devsolver's budgets, ``--solver-workers`` and ``--harvest-workers``
  the pipeline's feasibility pool and the harvest's replay pool (0: the
  serial harvest), ``--query-cache-dir`` adds the query cache's disk store
  and ``--staticpass-report`` writes the static pass's JSON after the run;
  ``--coverage-target`` stops exploring at a coverage bar and
  ``--coverage-out`` writes the exploration ledger after the run.
  ``--trace-out FILE`` enables the span tracer and writes a
  Chrome-trace/Perfetto JSON (and ``FILE.jsonl``) after the run,
  ``--metrics-out FILE`` the metrics-registry snapshot, ``--benchmark
  FILE`` the benchmark plugin's instructions-over-time series.
  ``--checkpoint-file FILE`` writes the open states after every
  transaction and ``--resume-from FILE`` continues from such a file;
  ``--compile-cache-dir DIR`` and ``--cache-root DIR`` relocate the kernel
  build cache (``DIR/kernels`` under the root, beside ``DIR/querycache``);
  ``--heartbeat-out``, ``--heartbeat-interval``, ``--flight-recorder``,
  ``--watchdog-deadline`` and ``--history-dir`` are the health surfaces,
  and ``history`` and ``drift`` read what they record.  ``--no-mesh`` runs
  the frontier and the probe on the analysis device alone where a mesh
  would span every visible card (``parallel/``).
* ``serve`` exits with code 1 when a device fault stopped the service (a
  fault never lets the inline worker take another batch), and, like
  ``top`` and ``health``, returns its code from ``main`` instead of
  leaving the process.
* With ``--frontier`` on the card, a ``--frontier-width`` wider than the
  card's resident cooperative grid is refused before the analysis starts.

``main(argv)`` takes the argument list, so tests and scripts drive it in
process; it restores the process-wide flags it wrote when it returns.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys
import time
import traceback
from typing import List, Optional, Sequence

from mythril_tpu_torch import __version__
from mythril_tpu_torch.device import DeviceError
from mythril_tpu_torch.exceptions import CriticalError, MythrilBaseException
from mythril_tpu_torch.support.support_args import PROBE_BACKENDS

log = logging.getLogger(__name__)

PROG = "myth-tpu-torch"
COMMAND_ALIASES = {"a": "analyze", "d": "disassemble", "c": "concolic"}
ANALYSIS_COMMANDS = ("analyze", "a", "safe-functions")

# What the JAX command line has and the port does not yet: subcommand or
# option -> the ROADMAP Queue A item that ports it (none left since the
# analysis service was ported).
NOT_YET_PORTED = {}
# the JAX switches that turn off a default-on tier the port does not have:
# dest -> (the tier, item) (none left since the device mesh was ported)
RUNS_WITHOUT = {}


class Refused(Exception):
    """A subcommand the port does not have yet, or a frontier width the
    card cannot hold; the CLI exits with code 2."""


def refusal(what: str, item: int) -> Refused:
    return Refused(f"{what} is not ported yet (ROADMAP Queue A item {item}); "
                   "the port refuses it rather than ignore it")


def exit_with_error(format_: str, message: str) -> int:
    if format_ in ("text", "markdown"):
        log.error(message)
    else:
        result = {"success": False, "error": str(message), "issues": []}
        print(json.dumps(result))
    return 1


# ---------------------------------------------------------------------------
# parser construction
# ---------------------------------------------------------------------------


def _add_verbosity(parser) -> None:
    parser.add_argument(
        "-v", type=int, default=2, metavar="LOG_LEVEL", help="log level (0-5)"
    )


def _add_device(parser) -> None:
    parser.add_argument(
        "--device",
        choices=("cuda", "cpu"),
        default="cuda",
        help="device of the analysis: the CUDA card (default; fails without "
        "one) or the CPU, which runs the kernels' plain PyTorch versions",
    )


def _add_rpc_options(parser) -> None:
    group = parser.add_argument_group("RPC options")
    group.add_argument("--rpc", help="custom RPC settings (host:port, ganache, infura-<net>)")
    group.add_argument("--rpctls", type=bool, default=False, help="RPC connection over TLS")
    group.add_argument("--infura-id", help="infura project id")


def _add_input_options(parser) -> None:
    parser.add_argument("solidity_files", nargs="*", help="solidity smart contract files")
    parser.add_argument("-c", "--code", metavar="BYTECODE", help="hex-encoded creation bytecode")
    parser.add_argument(
        "-f", "--codefile", metavar="BYTECODEFILE", help="file containing hex-encoded bytecode"
    )
    parser.add_argument("-a", "--address", metavar="ADDRESS", help="contract address on chain")
    parser.add_argument("--bin-runtime", action="store_true", help="input is runtime (deployed) code")
    parser.add_argument("--solc-json", help="solc standard-json settings file")
    parser.add_argument("--solv", metavar="SOLC_VERSION", help="solc version to use")


def _add_analysis_options(parser) -> None:
    group = parser.add_argument_group("analysis options")
    group.add_argument(
        "-m", "--modules", metavar="MODULES", help="comma-separated detection modules"
    )
    group.add_argument("--max-depth", type=int, default=128, help="max instruction depth")
    group.add_argument(
        "--strategy",
        choices=["dfs", "bfs", "naive-random", "weighted-random", "beam-search"],
        default="bfs",
        help="search strategy",
    )
    group.add_argument("--loop-bound", type=int, default=3, help="loop iteration bound")
    group.add_argument("--call-depth-limit", type=int, default=3, help="message-call depth limit")
    group.add_argument(
        "-t", "--transaction-count", type=int, default=2, help="maximum number of transactions"
    )
    group.add_argument(
        "--execution-timeout", type=int, default=86400, help="global timeout (seconds)"
    )
    group.add_argument("--create-timeout", type=int, default=10, help="creation tx timeout (seconds)")
    group.add_argument("--solver-timeout", type=int, default=10000, help="per-query timeout (ms)")
    group.add_argument("--solver-log", help="directory for solver query dumps")
    group.add_argument("--parallel-solving", action="store_true", help="batched parallel solving")
    group.add_argument(
        "--unconstrained-storage",
        action="store_true",
        help="treat all storage as unconstrained symbols",
    )
    group.add_argument("--sparse-pruning", action="store_true", help="skip reachability pruning")
    group.add_argument(
        "--disable-dependency-pruning", action="store_true", help="disable dependency pruner"
    )
    group.add_argument("--enable-iprof", action="store_true", help="instruction profiler")
    group.add_argument(
        "--benchmark",
        metavar="FILE",
        help="record instructions-over-time and write the series to FILE "
        "(JSON) and FILE.svg (chart) after the run",
    )
    group.add_argument(
        "--no-onchain-data", action="store_true", help="do not fetch on-chain data via RPC"
    )
    group.add_argument(
        "--enable-coverage-strategy", action="store_true", help="coverage-driven search"
    )
    group.add_argument(
        "--custom-modules-directory", default="", help="directory with additional detection modules"
    )
    group.add_argument(
        "--checkpoint-file",
        help="snapshot the open-state frontier to this file after every transaction",
    )
    group.add_argument(
        "--resume-from",
        help="resume an interrupted analysis from a frontier checkpoint file",
    )
    group.add_argument(
        "--probe-backend",
        choices=PROBE_BACKENDS,
        default="auto",
        help="constraint-probe backend: auto (the card for queries above the "
        "break-even calibrated to its measured round trip, the host below it "
        "and on the CPU), device (the tape VM on the analysis' device; the JAX "
        "package's forced jax), host (CPU big-int), cdcl (forced exact — "
        "recall differential testing)",
    )
    group.add_argument(
        "--frontier",
        action="store_true",
        help="run message-call transactions on the batched device-resident "
        "frontier interpreter (the frontier segment kernel; host engine "
        "handles the rest)",
    )
    group.add_argument(
        "--frontier-width",
        type=int,
        default=64,
        help="device frontier batch width (paths held on device); on the "
        "card at most what its cooperative grid holds resident",
    )
    group.add_argument(
        "--frontier-force",
        action="store_true",
        help="bypass the a-priori narrow-width gate and put even tiny "
        "seed sets on the device frontier (differential testing / CI "
        "smoke; normally the gate keeps small contracts on the faster "
        "host path)",
    )
    group.add_argument(
        "--query-cache-dir",
        metavar="DIR",
        help="persist solver verdicts in DIR and reuse them across runs "
        "(exact-hit, model-reuse and unsat-core-subsumption tiers); safe "
        "for concurrent writers via atomic write-then-rename",
    )
    group.add_argument(
        "--no-query-cache",
        action="store_true",
        help="disable the SMT query cache entirely (in-process LRU "
        "included)",
    )
    group.add_argument(
        "--no-code-paging",
        action="store_false",
        dest="code_paging",
        default=True,
        help="disable the large-code frontier (per-code bucket isolation "
        "and packed-code paging) and pad every code to one corpus-wide "
        "size bucket; the issue set is identical either way",
    )
    group.add_argument(
        "--code-page-budget",
        type=int,
        default=2048,
        metavar="N",
        help="instruction-axis residency budget for packed-code paging: "
        "codes beyond the grown bucket of N instructions keep only a "
        "window of that size device-resident, cold jumps fault to the "
        "host for a sync-point repack (0 keeps bucket isolation only)",
    )
    group.add_argument(
        "--no-pipeline",
        action="store_false",
        dest="pipeline",
        default=True,
        help="disable the pipelined frontier (chained device dispatch + "
        "background feasibility pool) and run the synchronous "
        "segment/harvest loop; the issue set is identical either way",
    )
    group.add_argument(
        "--no-prefilter",
        action="store_false",
        dest="prefilter",
        default=True,
        help="disable the abstract feasibility pre-filter (interval + "
        "known-bits pass ahead of the exact solver tiers, the known bits "
        "on the device); the issue set is identical either way",
    )
    group.add_argument(
        "--no-devsolver",
        action="store_false",
        dest="devsolver",
        default=True,
        help="disable the device SAT tier (batched bit-blast decision "
        "procedure between the pre-filter and the exact tiers); the issue "
        "set is identical either way",
    )
    group.add_argument(
        "--devsolver-bit-budget",
        type=int,
        default=64,
        metavar="BITS",
        help="maximum free decision bits (after known-bits/interval "
        "narrowing) for a query to enter the device SAT tier",
    )
    group.add_argument(
        "--devsolver-iters",
        type=int,
        default=2048,
        metavar="N",
        help="device SAT tier search-kernel iteration budget per query "
        "(budget lapse falls through as UNKNOWN)",
    )
    group.add_argument(
        "--no-mesh",
        action="store_false",
        dest="frontier_mesh",
        default=True,
        help="run the frontier and the probe on the analysis device alone, "
        "where the device mesh would path-shard the frontier's slot batch and "
        "spread the probe's lowering batches over every visible card; composes "
        "with --no-pipeline (all four combinations yield the same issue set)",
    )
    group.add_argument(
        "--no-adaptive",
        action="store_false",
        dest="adaptive",
        default=True,
        help="disable coverage-guided adaptive exploration (feedback "
        "controller steering dispatch slots and requeues at uncovered "
        "reachable edges); the issue set is identical either way",
    )
    group.add_argument(
        "--coverage-target",
        type=float,
        default=None,
        metavar="PCT",
        help="stop exploring once reachable coverage reaches PCT percent "
        "(or every explored code plateaus), instead of running the full "
        "time/tx budget; requires the adaptive controller",
    )
    group.add_argument(
        "--solver-workers",
        type=int,
        default=2,
        metavar="N",
        help="feasibility-pool worker threads for the pipelined frontier "
        "(solves are serialized by a shared lock — this moves solve "
        "latency off the harvest critical path, not parallel solving)",
    )
    group.add_argument(
        "--harvest-workers",
        type=int,
        default=4,
        metavar="N",
        help="harvest replay worker threads: terminal path replays shard "
        "by owning laser (no shared per-laser state across workers) and "
        "commit in slot order, so the issue set is identical to serial; "
        "0 runs the serial harvest",
    )
    group.add_argument(
        "--compile-cache-dir",
        metavar="DIR",
        help="build the CUDA kernel library into DIR and load it from there "
        "across processes (no nvcc run on a warm start); default "
        "mythril_tpu_torch/_build — set the MYTHRIL_TPU_COMPILATION_CACHE "
        "env var to 0/off to build in every process, or to a path to "
        "relocate",
    )
    group.add_argument(
        "--cache-root",
        metavar="DIR",
        help="pin BOTH persistent caches under one directory: SMT query "
        "cache in DIR/querycache, kernel build cache in DIR/kernels; "
        "explicit --query-cache-dir / --compile-cache-dir win over the "
        "derived paths",
    )
    group.add_argument(
        "--no-staticpass",
        action="store_true",
        help="disable the static bytecode pre-analysis pass (CFG + abstract-"
        "interpretation pruning of detector hooks and packed device events); "
        "the issue set is identical either way, this only removes the "
        "pruning",
    )
    group.add_argument(
        "--no-staticpass-interproc",
        action="store_true",
        help="keep only the base (intra-procedural) static passes: no "
        "value-set jump refinement, function recovery, reachable-edge "
        "oracle or cross-contract call graph; the issue set is identical "
        "either way",
    )
    group.add_argument(
        "--staticpass-report",
        metavar="FILE",
        help="write the static pre-analysis summary (per-contract CFG "
        "blocks/edges, unreachable spans, taint reachability, skipped "
        "modules) to FILE as JSON after the run",
    )
    group.add_argument(
        "--trace-out",
        metavar="FILE",
        help="enable span tracing and write a Chrome-trace/Perfetto JSON "
        "to FILE after the run (open in https://ui.perfetto.dev); "
        "FILE.jsonl additionally gets the flat span records",
    )
    group.add_argument(
        "--metrics-out",
        metavar="FILE",
        help="write the full metrics-registry snapshot (frontier/solver/"
        "profiler counters and per-stage histograms) to FILE as JSON",
    )
    group.add_argument(
        "--coverage-out",
        metavar="FILE",
        help="write the exploration ledger (per-contract instruction and "
        "JUMPI branch-edge coverage bitmaps, termination-class breakdown, "
        "solver hotspots by program point) to FILE as JSON after the run",
    )
    group.add_argument(
        "--heartbeat-out",
        metavar="FILE",
        help="sample pipeline queue depths (feasibility in-flight, ledger "
        "pending corrections, free slots, arena occupancy) at a fixed "
        "period into FILE as JSON lines — live progress for multi-minute "
        "runs (tail -f)",
    )
    group.add_argument(
        "--heartbeat-interval",
        type=float,
        default=0.5,
        metavar="SECONDS",
        help="heartbeat sampling period (default 0.5s)",
    )
    group.add_argument(
        "--flight-recorder",
        metavar="DIR",
        help="arm the flight recorder: on an unhandled exception, SIGUSR1, "
        "or a watchdog timeout, dump a bundle (recent spans, metrics "
        "snapshot, device plane, heartbeat tail, all-thread stacks) into "
        "DIR; implies span tracing",
    )
    group.add_argument(
        "--watchdog-deadline",
        type=float,
        metavar="SECONDS",
        help="with --flight-recorder: dump a hang bundle when no frontier "
        "segment completes within SECONDS while a run is active "
        "(default: watchdog off)",
    )
    group.add_argument(
        "--history-dir",
        metavar="DIR",
        help="record the metrics registry into a persistent delta-encoded "
        "history ring under DIR at the heartbeat cadence (readable with "
        "'history query')",
    )
    _add_device(group)


def _add_output_options(parser) -> None:
    parser.add_argument(
        "-o",
        "--outform",
        choices=["text", "markdown", "json", "jsonv2"],
        default="text",
        help="output format",
    )
    parser.add_argument("--graph", metavar="HTML_FILE", help="export call graph HTML")
    parser.add_argument(
        "--statespace-json", metavar="JSON_FILE", help="export statespace json"
    )
    parser.add_argument("--enable-physics", action="store_true", help="graph physics")
    parser.add_argument("--epic", action="store_true", help=argparse.SUPPRESS)


def create_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog=PROG,
        description="Security analysis of Ethereum smart contracts (PyTorch/CUDA port)",
    )
    parser.add_argument("--version", action="store_true", help="print version and exit")
    subparsers = parser.add_subparsers(dest="command")

    analyze = subparsers.add_parser("analyze", aliases=["a"], help="analyze a contract")
    _add_input_options(analyze)
    _add_analysis_options(analyze)
    _add_output_options(analyze)
    _add_rpc_options(analyze)
    _add_verbosity(analyze)

    disassemble = subparsers.add_parser(
        "disassemble", aliases=["d"], help="disassemble a contract"
    )
    _add_input_options(disassemble)
    _add_rpc_options(disassemble)
    _add_verbosity(disassemble)

    static = subparsers.add_parser(
        "static",
        help="static pre-analysis only (no symbolic execution): recovered "
        "function table, storage read/write summaries, reachable-edge "
        "oracle, ranked interesting points, cross-contract call graph",
    )
    _add_input_options(static)
    _add_rpc_options(static)
    static.add_argument(
        "-o", "--outform", choices=["text", "json"], default="text",
        help="output format",
    )
    static.add_argument(
        "--top", type=int, default=10, metavar="N",
        help="interesting points to print in text mode (default 10)",
    )
    static.add_argument(
        "--no-staticpass-interproc", action="store_true",
        help="base (intra-procedural) passes only: skip value-set jump "
        "refinement and function recovery",
    )
    _add_verbosity(static)

    safe = subparsers.add_parser(
        "safe-functions", help="check functions which are completely safe using symbolic execution"
    )
    _add_input_options(safe)
    _add_analysis_options(safe)
    _add_rpc_options(safe)
    _add_verbosity(safe)

    concolic = subparsers.add_parser(
        "concolic", aliases=["c"], help="concolic execution / branch flipping"
    )
    concolic.add_argument("input", help="json file with concrete transaction data")
    concolic.add_argument(
        "--branches", help="comma-separated branch addresses to flip", required=True
    )
    concolic.add_argument("--solver-timeout", type=int, default=100000)
    _add_device(concolic)
    _add_verbosity(concolic)

    listd = subparsers.add_parser("list-detectors", help="list available detection modules")
    _add_output_options(listd)

    reads = subparsers.add_parser("read-storage", help="read storage slots from a contract")
    reads.add_argument("address", help="contract address")
    reads.add_argument(
        "storage_slots", nargs="+", help="position [length] | mapping pos key... | pos len array"
    )
    _add_rpc_options(reads)

    f2h = subparsers.add_parser("function-to-hash", help="4-byte selector of a signature")
    f2h.add_argument("func_name", help="e.g. 'transfer(address,uint256)'")

    h2a = subparsers.add_parser("hash-to-address", help="look up signatures for a selector")
    h2a.add_argument("hash", help="e.g. 0xa9059cbb")

    _add_service_parsers(subparsers)

    history = subparsers.add_parser(
        "history", help="query the persistent metrics history ring "
        "written by the watchtower (post-hoc plotting/diagnosis)",
    )
    history.add_argument(
        "action", choices=["query", "segments"],
        help="query: emit (t, value) samples as JSON lines; "
        "segments: list on-disk ring segments",
    )
    history.add_argument(
        "--dir", dest="history_dir", metavar="DIR",
        help="history directory (exclusive with --cache-root)",
    )
    history.add_argument(
        "--cache-root", metavar="DIR",
        help="cache root; reads DIR/history",
    )
    history.add_argument(
        "--metric", action="append", metavar="NAME",
        help="metric name(s) to emit (repeatable; default: all)",
    )
    history.add_argument(
        "--since", type=float, default=None, metavar="SECONDS",
        help="only samples from the last SECONDS",
    )
    _add_verbosity(history)

    drift = subparsers.add_parser(
        "drift", help="rank perf movement between two bench artifacts "
        "(or two history-ring windows) and name the most-moved "
        "phase/counter",
    )
    drift.add_argument(
        "artifacts", nargs="*", metavar="BENCH.json",
        help="two bench artifacts: PRIOR CURRENT (any bench-readable "
        "format; omit when using --history)",
    )
    drift.add_argument(
        "--history", dest="drift_history", metavar="DIR",
        help="compare the last --window seconds of a metrics history "
        "ring against the window before it",
    )
    drift.add_argument(
        "--window", type=float, default=300.0, metavar="SECONDS",
        help="history window length in seconds (default: 300)",
    )
    drift.add_argument(
        "--limit", type=int, default=15, metavar="N",
        help="ranked findings to print (default: 15)",
    )
    drift.add_argument(
        "-o", "--outform", choices=["text", "json"], default="text",
        help="output format",
    )
    _add_verbosity(drift)

    subparsers.add_parser("version", help="print version")
    subparsers.add_parser("help", help="print help")
    return parser


def _add_service_parsers(subparsers) -> None:
    """``serve``, ``submit``, ``top`` and ``health``: the JAX command line's
    options, and ``--device`` on ``serve``."""
    serve = subparsers.add_parser(
        "serve",
        help="run the persistent analysis service (multi-tenant daemon: "
        "shared-batch admission, codehash dedup, streamed results)",
    )
    serve.add_argument("--host", default="127.0.0.1", help="bind address")
    serve.add_argument("--port", type=int, default=7344, help="TCP port")
    serve.add_argument(
        "--batch-width", type=int, default=8, metavar="N",
        help="max compatible requests admitted into one shared device batch",
    )
    serve.add_argument(
        "--batch-window", type=float, default=0.05, metavar="SECONDS",
        help="admission window held open for more arrivals (interactive "
        "requests cut it short)",
    )
    serve.add_argument(
        "--no-probe", action="store_false", dest="probe", default=True,
        help="disable the host-first hybrid probe for interactive-tier "
        "requests (default on: first evidence never waits on a cold "
        "kernel build)",
    )
    serve.add_argument(
        "--no-frontier", action="store_false", dest="frontier", default=True,
        help="run service batches on host engines only (no device frontier)",
    )
    serve.add_argument(
        "--no-warmup", action="store_false", dest="warmup", default=True,
        help="skip the startup warmup analysis",
    )
    serve.add_argument(
        "--cache-root", metavar="DIR",
        help="pin the SMT query cache (DIR/querycache), the kernel build "
        "cache (DIR/kernels) and cross-process completed-result LRU "
        "(DIR/results) under one directory",
    )
    serve.add_argument(
        "--workers", type=int, default=1, metavar="N",
        help="analysis worker processes behind the admission plane "
        "(default 1: classic in-process worker thread; N>1 spawns N "
        "isolated engine processes sharing the --cache-root caches)",
    )
    serve.add_argument(
        "--tenant-quota", type=int, default=0, metavar="N",
        help="max pending flights one tenant may hold (0 = unlimited); "
        "excess submissions are rejected immediately, not queued",
    )
    serve.add_argument(
        "--shed-depth", type=int, default=0, metavar="N",
        help="pending-queue depth at which batch-tier submissions are "
        "shed (0 = never; interactive submissions always queue)",
    )
    serve.add_argument(
        "--age-priority", type=float, default=30.0, metavar="SECONDS",
        help="batch flights waiting this long are promoted to "
        "interactive-class priority so a continuous interactive stream "
        "cannot starve batch work (default 30s; <=0 disables aging)",
    )
    serve.add_argument(
        "-t", "--transaction-count", type=int, default=2,
        help="default transaction count for submissions",
    )
    serve.add_argument(
        "-m", "--modules", metavar="MODULES",
        help="comma-separated default detection modules",
    )
    serve.add_argument(
        "--strategy", default="bfs",
        choices=["dfs", "bfs", "naive-random", "weighted-random",
                 "beam-search"],
        help="default search strategy",
    )
    serve.add_argument(
        "--execution-timeout", type=int, default=60,
        help="default per-request execution timeout (seconds)",
    )
    serve.add_argument(
        "--coverage-target", type=float, default=None, metavar="PCT",
        help="default coverage-target contract for submissions: stop "
        "exploring a request once reachable-edge coverage reaches PCT "
        "percent (or every explored code plateaus); the done event "
        "carries coverage_target_met",
    )
    serve.add_argument(
        "--heartbeat-out", metavar="FILE",
        help="sample service queue depths into FILE as JSON lines",
    )
    serve.add_argument(
        "--heartbeat-interval", type=float, default=0.5, metavar="SECONDS",
        help="heartbeat sampling period (default 0.5s)",
    )
    serve.add_argument(
        "--request-log", metavar="FILE",
        help="append one JSON line per terminal request event (ids, "
        "tenant, phase decomposition, issue digests)",
    )
    serve.add_argument(
        "--trace-out", metavar="FILE",
        help="enable tracing for the daemon's lifetime and write a "
        "Chrome-trace JSON on exit (request span trees flow-joined to "
        "frontier segments; with --workers N the trace carries one "
        "process track per worker, request flows crossing the seam)",
    )
    serve.add_argument(
        "--flight-recorder", metavar="DIR",
        help="arm the flight recorder for the daemon: an unhandled "
        "exception, SIGUSR1 or the watchdog dumps a bundle into DIR, "
        "and with --workers N every live worker contributes a linked "
        "bundle (stacks + metrics + heartbeat tail) alongside it",
    )
    serve.add_argument(
        "--slo", metavar="FILE", dest="slo_file",
        help="declarative SLO objectives (YAML/JSON) for the watchtower; "
        "default: built-in objectives (TTFE/phase p95 budgets, "
        "error/shed rates, worker liveness, coverage and prefilter "
        "floors)",
    )
    serve.add_argument(
        "--no-watchtower", action="store_false", dest="watchtower",
        default=True,
        help="disable the watchtower (SLO evaluation, breach "
        "auto-capture and the persistent metrics history under "
        "<cache-root>/history)",
    )
    serve.add_argument(
        "--watchtower-interval", type=float, default=5.0, metavar="SECONDS",
        help="watchtower snapshot/evaluation cadence (default 5s)",
    )
    serve.add_argument(
        "--request-log-max-mb", type=float, default=64.0, metavar="MIB",
        help="rotate --request-log at this size (FILE -> FILE.1 ...; "
        "0 disables rotation)",
    )
    _add_device(serve)
    _add_verbosity(serve)

    submit = subparsers.add_parser(
        "submit", help="submit a contract to a running analysis service"
    )
    submit.add_argument("--host", default="127.0.0.1", help="service host")
    submit.add_argument("--port", type=int, default=7344, help="service port")
    submit.add_argument(
        "-c", "--code", metavar="BYTECODE",
        help="hex-encoded runtime bytecode",
    )
    submit.add_argument(
        "-f", "--codefile", metavar="BYTECODEFILE",
        help="file containing hex-encoded runtime bytecode",
    )
    submit.add_argument("--name", help="request label")
    submit.add_argument(
        "--tenant", metavar="LABEL",
        help="tenant label for per-tenant accounting in the daemon",
    )
    submit.add_argument(
        "--tier", choices=["batch", "interactive"], default="batch",
        help="interactive jumps the admission queue and gets the "
        "host-first probe (TTFE budget)",
    )
    submit.add_argument(
        "-t", "--transaction-count", type=int, default=None,
        help="override the service's default transaction count",
    )
    submit.add_argument(
        "-m", "--modules", metavar="MODULES",
        help="comma-separated detection modules",
    )
    submit.add_argument(
        "--execution-timeout", type=int, default=None,
        help="override the service's default execution timeout (seconds)",
    )
    submit.add_argument(
        "--coverage-target", type=float, default=None, metavar="PCT",
        help="per-request coverage-target contract: terminate once "
        "reachable-edge coverage reaches PCT percent (or exploration "
        "plateaus); the done event carries coverage_target_met",
    )
    submit.add_argument(
        "-o", "--outform", choices=["text", "json"], default="text",
        help="output format",
    )
    _add_verbosity(submit)

    top = subparsers.add_parser(
        "top", help="live view of a running analysis service (in-flight "
        "requests, phase latency percentiles, tenant totals)",
    )
    top.add_argument("--host", default="127.0.0.1", help="service host")
    top.add_argument("--port", type=int, default=7344, help="service port")
    top.add_argument(
        "--interval", type=float, default=2.0, metavar="SECONDS",
        help="refresh period (default 2s)",
    )
    top.add_argument(
        "--once", action="store_true",
        help="render one snapshot and exit (no screen clearing)",
    )
    _add_verbosity(top)

    health = subparsers.add_parser(
        "health", help="watchtower SLO state of a running analysis "
        "service (per-objective burn-rate verdicts, breach captures)",
    )
    health.add_argument("--host", default="127.0.0.1", help="service host")
    health.add_argument("--port", type=int, default=7344, help="service port")
    health.add_argument(
        "-o", "--outform", choices=["text", "json"], default="text",
        help="output format",
    )
    _add_verbosity(health)


# ---------------------------------------------------------------------------
# what the port refuses
# ---------------------------------------------------------------------------


def _command_of(argv: Sequence[str]) -> Optional[str]:
    """The subcommand: the first argument that is not an option (the top
    parser's only options are -h and --version, which take no value)."""
    return next((a for a in argv if not a.startswith("-")), None)


def screen(argv: Sequence[str]) -> List[str]:
    """``argv``; raises ``Refused`` for an unported subcommand."""
    command = _command_of(argv)
    if command in NOT_YET_PORTED:
        raise refusal(f"the subcommand {command!r}", NOT_YET_PORTED[command])
    return list(argv)


def check_frontier_width(parsed) -> None:
    """On the card, refuse a ``--frontier-width`` wider than the segment
    kernel can launch, before anything runs; the CPU has no such limit.
    With the mesh on (no ``--no-mesh``) and several cards visible, the limit
    is the mesh's: the partitioned segment's, the sum of the cards'."""
    if not parsed.frontier or parsed.device == "cpu":
        return
    from mythril_tpu_torch.device import resolve
    from mythril_tpu_torch.frontier.step import max_paths
    from mythril_tpu_torch.parallel.mesh import mesh_devices

    device = resolve(parsed.device)
    cards = mesh_devices(device) if getattr(parsed, "frontier_mesh", True) else [device]
    if len(set(cards)) > 1:
        limit = max_paths(device, devices=cards)
        where = (f"these {len(set(cards))} cards run at most {limit} paths in one partitioned "
                 "frontier segment (the sum of their resident cooperative grids)")
    else:
        limit = max_paths(device)
        where = (f"this card runs at most {limit} paths in one frontier segment (its resident "
                 "cooperative grid)")
    if parsed.frontier_width > limit:
        raise Refused(f"--frontier-width {parsed.frontier_width}: {where}; use a smaller width")


# ---------------------------------------------------------------------------
# command execution
# ---------------------------------------------------------------------------


def _set_logging(level: int) -> None:
    levels = {
        0: logging.NOTSET,
        1: logging.CRITICAL,
        2: logging.ERROR,
        3: logging.WARNING,
        4: logging.INFO,
        5: logging.DEBUG,
    }
    logging.basicConfig(level=levels.get(level, logging.ERROR))


def _load_code(parsed, disassembler) -> Optional[str]:
    """Load input contracts into the disassembler; returns target address."""
    address = None
    try:
        if parsed.code:
            address, _ = disassembler.load_from_bytecode(parsed.code, parsed.bin_runtime)
        elif parsed.codefile:
            with open(parsed.codefile) as f:
                code = f.read().strip()
            address, _ = disassembler.load_from_bytecode(code, parsed.bin_runtime)
        elif parsed.address:
            address, _ = disassembler.load_from_address(parsed.address)
        elif parsed.solidity_files:
            address, _ = disassembler.load_from_solidity(parsed.solidity_files)
        else:
            raise CriticalError(
                "no input bytecode or Solidity file specified; see --help"
            )
    except ValueError as e:
        raise CriticalError(f"invalid bytecode input: {e}") from e
    except FileNotFoundError as e:
        raise CriticalError(str(e)) from e
    return address


def _disassembler(parsed):
    from mythril_tpu_torch.facade.mythril_config import MythrilConfig
    from mythril_tpu_torch.facade.mythril_disassembler import MythrilDisassembler

    config = MythrilConfig()
    if getattr(parsed, "infura_id", None):
        config.infura_id = parsed.infura_id
    if parsed.rpc and not getattr(parsed, "no_onchain_data", False):
        config.set_api_rpc(parsed.rpc, parsed.rpctls)
    return MythrilDisassembler(
        eth=config.eth,
        solc_version=getattr(parsed, "solv", None),
        solc_settings_json=getattr(parsed, "solc_json", None),
    )


def _build_analyzer(parsed):
    from mythril_tpu_torch.facade.mythril_analyzer import AnalyzerArgs, MythrilAnalyzer

    check_frontier_width(parsed)
    disassembler = _disassembler(parsed)
    address = _load_code(parsed, disassembler)
    modules = parsed.modules.split(",") if parsed.modules else None
    cmd_args = AnalyzerArgs(
        strategy=parsed.strategy,
        max_depth=parsed.max_depth,
        execution_timeout=parsed.execution_timeout,
        create_timeout=parsed.create_timeout,
        loop_bound=parsed.loop_bound,
        call_depth_limit=parsed.call_depth_limit,
        transaction_count=parsed.transaction_count,
        modules=modules,
        disable_dependency_pruning=parsed.disable_dependency_pruning,
        solver_timeout=parsed.solver_timeout,
        unconstrained_storage=parsed.unconstrained_storage,
        sparse_pruning=parsed.sparse_pruning,
        solver_log=parsed.solver_log,
        enable_iprof=parsed.enable_iprof,
        benchmark_path=parsed.benchmark,
        enable_coverage_strategy=parsed.enable_coverage_strategy,
        custom_modules_directory=parsed.custom_modules_directory,
        checkpoint_file=parsed.checkpoint_file,
        resume_from=parsed.resume_from,
        probe_backend=parsed.probe_backend,
        frontier=parsed.frontier,
        frontier_width=parsed.frontier_width,
        frontier_force=parsed.frontier_force,
        frontier_mesh=parsed.frontier_mesh,
        query_cache=not parsed.no_query_cache,
        query_cache_dir=parsed.query_cache_dir,
        staticpass=not parsed.no_staticpass,
        staticpass_interproc=not parsed.no_staticpass_interproc,
        code_paging=parsed.code_paging,
        code_page_budget=parsed.code_page_budget,
        prefilter=parsed.prefilter,
        devsolver=parsed.devsolver,
        devsolver_bit_budget=parsed.devsolver_bit_budget,
        devsolver_iters=parsed.devsolver_iters,
        pipeline=parsed.pipeline,
        solver_workers=parsed.solver_workers,
        harvest_workers=parsed.harvest_workers,
        adaptive=parsed.adaptive,
        coverage_target=parsed.coverage_target,
        compile_cache_dir=parsed.compile_cache_dir,
        cache_root=parsed.cache_root,
        heartbeat_out=parsed.heartbeat_out,
        heartbeat_interval=parsed.heartbeat_interval,
        flight_recorder=parsed.flight_recorder,
        watchdog_deadline=parsed.watchdog_deadline,
        history_dir=parsed.history_dir,
    )
    return MythrilAnalyzer(
        disassembler, cmd_args, strategy=parsed.strategy, address=address,
        device=parsed.device,
    )


def _print_static_report(report: dict, top: int = 10) -> None:
    """Human rendering of the ``myth static`` report dict."""
    for entry in report.get("contracts", []):
        print(f"contract {entry['name']}")
        for code in entry.get("codes", []):
            kind = "creation" if code.get("is_creation") else "runtime"
            r = code.get("reachability", {})
            d = code.get("dispatch", {})
            print(
                f"  [{kind}] {code['instructions']} instrs, "
                f"{code['blocks']} blocks, edges "
                f"{r.get('edges_reachable', 0)}/{r.get('edges_total', 0)} "
                f"reachable ({r.get('reachable_edge_pct', 100.0):.1f}%), "
                f"interproc={'on' if code.get('interproc') else 'off'}"
            )
            if d.get("recovered"):
                print(
                    f"    dispatch recovered, "
                    f"fallback entry @ {d.get('fallback_addr')}"
                )
            for fn in code.get("functions", []):
                flags = [
                    label for key, label in (
                        ("caller_guarded", "caller-guarded"),
                        ("selfdestruct", "selfdestruct"),
                        ("delegatecall", "delegatecall"),
                        ("writes_after_call", "writes-after-call"),
                    ) if fn.get(key)
                ]
                reads = ("?" if fn.get("reads_unknown")
                         else str(len(fn.get("storage_reads", []))))
                writes = ("?" if fn.get("writes_unknown")
                          else str(len(fn.get("storage_writes", []))))
                print(
                    f"    fn {fn['name']:<12} entry={fn['entry_addr']:<6} "
                    f"blocks={fn['n_blocks']:<4} sloads={reads:<3} "
                    f"sstores={writes:<3} calls={len(fn.get('calls', []))}"
                    + (f"  [{', '.join(flags)}]" if flags else "")
                )
    points = [
        p
        for entry in report.get("contracts", [])
        for code in entry.get("codes", [])
        for p in code.get("interesting_points", [])
    ]
    points.sort(key=lambda p: -p.get("score", 0))
    if points:
        print(
            f"interesting points (top {min(top, len(points))} "
            f"of {len(points)}):"
        )
        for p in points[:top]:
            print(
                f"  [{p.get('score', 0):>3}] {p.get('kind')} "
                f"@ {p.get('addr')} in {p.get('function')}"
            )
    cg = report.get("callgraph", {})
    print(
        f"callgraph: {len(cg.get('nodes', []))} nodes, "
        f"{len(cg.get('edges', []))} edges "
        f"({cg.get('resolved_edges', 0)} resolved)"
    )


def _execute_static(parsed) -> None:
    """``static``: the interprocedural pre-pass alone, no symbolic
    execution — recovered functions, reachable-edge oracle, ranked
    interesting points, cross-contract call graph."""
    from mythril_tpu_torch.staticpass import report_dict, summarize_contract
    from mythril_tpu_torch.support.support_args import args as global_args

    global_args.staticpass = True
    global_args.staticpass_interproc = not parsed.no_staticpass_interproc
    disassembler = _disassembler(parsed)
    _load_code(parsed, disassembler)
    for contract in disassembler.contracts or []:
        summarize_contract(contract)
    report = report_dict()
    if parsed.outform == "json":
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        _print_static_report(report, top=parsed.top)


def _arm_observability(parsed) -> None:
    """Before the analyzer is built: ``--trace-out`` and
    ``--flight-recorder`` switch the tracer on, emptied (one trace per
    command line when ``main`` runs several in one process);
    ``--heartbeat-out`` starts the heartbeat, ``--flight-recorder`` arms
    the recorder (with ``--watchdog-deadline``'s watchdog) and
    ``--history-dir`` starts a recording-only watchtower at the heartbeat
    cadence."""
    from mythril_tpu_torch import observability as obs

    if parsed.trace_out or parsed.flight_recorder:
        obs.get_tracer().reset()
        obs.get_tracer().enabled = True
    if parsed.heartbeat_out:
        obs.get_heartbeat().start(
            period_s=parsed.heartbeat_interval, out_path=parsed.heartbeat_out)
    if parsed.flight_recorder:
        obs.arm_flight_recorder(
            parsed.flight_recorder, watchdog_deadline_s=parsed.watchdog_deadline)
    if parsed.history_dir:
        # a recording-only watchtower (no objectives): snapshots the
        # registry into the history ring at the heartbeat cadence
        wt = obs.Watchtower(parsed.history_dir, objectives=[],
                            interval_s=parsed.heartbeat_interval)
        wt.start()
        obs.set_watchtower(wt)


def _disarm_observability(parsed) -> None:
    """What ``_arm_observability`` started, stopped whatever way the command
    ended: ``main`` runs several command lines in one process, and the JAX
    CLI's process ends with its one."""
    from mythril_tpu_torch import observability as obs

    if getattr(parsed, "heartbeat_out", None):
        obs.get_heartbeat().stop()
    if getattr(parsed, "flight_recorder", None):
        obs.disarm_flight_recorder()
    if getattr(parsed, "history_dir", None) and obs.get_watchtower() is not None:
        obs.get_watchtower().stop()
        obs.set_watchtower(None)


def _export_reports(parsed) -> None:
    """After a run: the heartbeat's last sample (``--heartbeat-out``), the
    history's last record (``--history-dir``), ``--trace-out FILE`` (the
    Chrome trace and ``FILE.jsonl``), ``--metrics-out FILE`` (the registry
    snapshot), ``--coverage-out FILE`` (the exploration ledger) and
    ``--staticpass-report FILE`` (the static pass's JSON)."""
    if parsed.heartbeat_out:
        from mythril_tpu_torch.observability import get_heartbeat

        hb = get_heartbeat()
        hb.sample_now()  # final depths before export
        hb.stop()
        log.info("wrote %d heartbeat samples to %s", hb.ticks, parsed.heartbeat_out)
    if parsed.history_dir:
        from mythril_tpu_torch.observability import get_watchtower, set_watchtower

        wt = get_watchtower()
        if wt is not None:
            wt.tick()  # final snapshot so the ring ends at run end
            wt.stop()
            set_watchtower(None)
            log.info("wrote %d history records to %s", wt.history.records,
                     parsed.history_dir)
    if parsed.trace_out:
        from mythril_tpu_torch.observability import get_tracer

        tracer = get_tracer()
        tracer.export_chrome_trace(parsed.trace_out)
        tracer.export_jsonl(parsed.trace_out + ".jsonl")
        log.info(
            "wrote %d spans (%d dropped) to %s [+.jsonl]",
            len(tracer), tracer.dropped, parsed.trace_out,
        )
    if parsed.metrics_out:
        from mythril_tpu_torch.observability import observability_meta

        with open(parsed.metrics_out, "w") as f:
            json.dump(observability_meta(), f, indent=2, sort_keys=True)
        log.info("wrote metrics snapshot to %s", parsed.metrics_out)
    if parsed.coverage_out:
        from mythril_tpu_torch.observability import get_exploration_ledger

        snap = get_exploration_ledger().snapshot()
        with open(parsed.coverage_out, "w") as f:
            json.dump(snap, f, indent=2, sort_keys=True)
        log.info(
            "wrote exploration ledger (%d contracts, %.1f%% coverage) to %s",
            len(snap.get("coverage", {})),
            snap.get("coverage_pct") or 0.0, parsed.coverage_out,
        )
    if parsed.staticpass_report:
        from mythril_tpu_torch.staticpass import export_report

        export_report(parsed.staticpass_report)
        log.info("wrote static pre-analysis report to %s", parsed.staticpass_report)


def _execute_history(parsed) -> None:
    """``history``: the metrics history ring's samples as JSON lines
    (``query``) or its on-disk segments (``segments``)."""
    from mythril_tpu_torch.observability.history import HistoryReader

    hist_dir = parsed.history_dir
    if not hist_dir:
        if not parsed.cache_root:
            raise CriticalError("history needs --dir or --cache-root")
        hist_dir = os.path.join(parsed.cache_root, "history")
    reader = HistoryReader(hist_dir)
    if parsed.action == "segments":
        for row in reader.segments():
            print(json.dumps(row), flush=True)
        return
    since = None
    if parsed.since is not None:
        since = time.time() - parsed.since
    names = parsed.metric or None
    for t, values in reader.samples(since=since, names=names):
        if names and not values:
            continue
        print(json.dumps({"t": t, **values}), flush=True)


def _execute_drift(parsed) -> None:
    """``drift``: the ranked movement between two bench artifacts, or
    between the last two ``--window`` windows of a history ring."""
    from mythril_tpu_torch.observability.drift import (
        diff_history_windows,
        diff_tables,
        format_drift,
        load_bench_table,
    )

    if parsed.drift_history:
        from mythril_tpu_torch.observability.history import HistoryReader

        reader = HistoryReader(parsed.drift_history)
        samples = list(reader.samples())
        report = diff_history_windows(samples, parsed.window, bounds=reader.bucket_bounds)
    else:
        if len(parsed.artifacts) != 2:
            raise CriticalError(
                "drift needs two bench artifacts (PRIOR CURRENT) or --history DIR")
        prior_path, current_path = parsed.artifacts
        prior = load_bench_table(prior_path)
        current = load_bench_table(current_path)
        if not prior or not current:
            raise CriticalError(
                "no workload table recoverable from "
                + (prior_path if not prior else current_path))
        report = diff_tables(prior, current, prior_name=prior_path,
                             current_name=current_path)
    if parsed.outform == "json":
        print(json.dumps(report, indent=2, sort_keys=True), flush=True)
    else:
        print(format_drift(report, limit=parsed.limit), flush=True)


def _execute_serve(parsed) -> int:
    """``serve``: the analysis service on ``--device``, until SIGTERM or
    SIGINT drains it (or a device fault stops it: exit code 1)."""
    from mythril_tpu_torch import observability as obs
    from mythril_tpu_torch.device import resolve
    from mythril_tpu_torch.service import server
    from mythril_tpu_torch.service.daemon import ServiceConfig
    from mythril_tpu_torch.service.request import AnalysisOptions

    resolve(parsed.device)  # no card: NoCudaDevice before anything binds or spawns
    modules = tuple(parsed.modules.split(",")) if parsed.modules else None
    config = ServiceConfig(
        default_options=AnalysisOptions(
            transaction_count=parsed.transaction_count,
            modules=modules,
            strategy=parsed.strategy,
            execution_timeout=parsed.execution_timeout,
            coverage_target=parsed.coverage_target,
        ),
        max_batch_width=parsed.batch_width,
        batch_window_s=parsed.batch_window,
        frontier=parsed.frontier,
        probe=parsed.probe,
        cache_root=parsed.cache_root,
        warmup=parsed.warmup,
        heartbeat=True,
        heartbeat_interval_s=parsed.heartbeat_interval,
        request_log=parsed.request_log,
        workers=parsed.workers,
        tenant_quota=parsed.tenant_quota,
        shed_queue_depth=parsed.shed_depth,
        age_priority_s=parsed.age_priority,
        trace=bool(parsed.trace_out),
        request_log_max_mb=parsed.request_log_max_mb,
        watchtower=parsed.watchtower,
        watchtower_interval_s=parsed.watchtower_interval,
        slo_file=parsed.slo_file,
        device=parsed.device,
    )
    if parsed.heartbeat_out:
        obs.get_heartbeat().start(
            period_s=parsed.heartbeat_interval, out_path=parsed.heartbeat_out)
    if parsed.trace_out:
        obs.get_tracer().reset()
        obs.get_tracer().enabled = True
    if parsed.flight_recorder:
        # armed on the main thread before run_server so the SIGUSR1
        # handler lands here, not in a worker
        obs.arm_flight_recorder(parsed.flight_recorder)
    rc = server.run_server(config, host=parsed.host, port=parsed.port)
    if parsed.trace_out:
        obs.get_tracer().export_chrome_trace(parsed.trace_out)
        print(f"trace written to {parsed.trace_out}", flush=True)
    return rc


def _execute_submit(parsed) -> None:
    """``submit``: one contract to a running service; its events as they
    arrive (``-o json``: one JSON object a line)."""
    from mythril_tpu_torch.service.client import ServiceClient

    if parsed.code:
        code = parsed.code
    elif parsed.codefile:
        with open(parsed.codefile) as f:
            code = f.read().strip()
    else:
        raise CriticalError("submit needs -c/--code or -f/--codefile")
    client = ServiceClient(parsed.host, parsed.port)
    modules = parsed.modules.split(",") if parsed.modules else None
    as_json = parsed.outform == "json"
    try:
        for event in client.submit_stream(
            code,
            name=parsed.name,
            tier=parsed.tier,
            transaction_count=parsed.transaction_count,
            modules=modules,
            execution_timeout=parsed.execution_timeout,
            tenant=parsed.tenant,
            coverage_target=parsed.coverage_target,
        ):
            if as_json:
                print(json.dumps(event), flush=True)
                continue
            kind = event.get("event")
            if kind == "accepted":
                dd = " (deduplicated)" if event.get("deduped") else ""
                print(f"accepted {event['request_id']}{dd}", flush=True)
            elif kind == "issue":
                prov = " [provisional]" if event.get("provisional") else ""
                print(
                    f"issue SWC-{event.get('swc_id')} "
                    f"{event.get('title')} @ {event.get('function')}"
                    f"{prov}",
                    flush=True,
                )
            elif kind == "error":
                raise CriticalError(f"analysis failed: {event.get('error')}")
            else:
                target_note = ""
                if "coverage_target_met" in event:
                    target_note = (
                        " [coverage target met]"
                        if event["coverage_target_met"]
                        else " [coverage target not met]"
                    )
                print(
                    f"done: {len(event.get('issues', []))} issues in "
                    f"{event.get('elapsed_s')}s{target_note}",
                    flush=True,
                )
    except (ConnectionError, OSError) as e:
        raise CriticalError(f"cannot reach analysis service: {e}") from e


def _execute_health(parsed) -> int:
    """``health``: the service's watchtower state; 1 on an active breach."""
    from mythril_tpu_torch.service.client import ServiceClient
    from mythril_tpu_torch.service.top import format_health

    client = ServiceClient(parsed.host, parsed.port, timeout=10.0)
    try:
        health = client.health()
    except OSError as e:
        raise CriticalError(
            f"cannot reach analysis service at "
            f"{parsed.host}:{parsed.port}: {e}"
        ) from e
    if parsed.outform == "json":
        print(json.dumps(health, indent=2, sort_keys=True), flush=True)
    else:
        print(format_health(
            health, address=f"{parsed.host}:{parsed.port}"), flush=True)
    # exit 1 on an active breach so scripts can gate on health
    return 1 if health.get("enabled") and not health.get("ok") else 0


def execute_command(parsed) -> Optional[int]:
    """Run the parsed command; its exit code where it has one of its own
    (``serve``, ``top``, ``health``), else None."""
    command = COMMAND_ALIASES.get(parsed.command, parsed.command)

    if command == "version":
        print(f"{PROG} v{__version__}")
        return

    if command == "help":
        create_parser().print_help()
        return

    if command == "function-to-hash":
        from mythril_tpu_torch.support.signatures import selector_of

        print(selector_of(parsed.func_name))
        return

    if command == "hash-to-address":
        from mythril_tpu_torch.support.signatures import SignatureDB

        sigs = SignatureDB().get(parsed.hash)
        for sig in sigs:
            print(sig)
        if not sigs:
            print(f"no signature found for {parsed.hash}")
        return

    if command == "list-detectors":
        from mythril_tpu_torch.analysis.module.loader import ModuleLoader

        modules = ModuleLoader().get_detection_modules()
        if parsed.outform == "json":
            print(
                json.dumps(
                    [
                        {
                            "classname": type(m).__name__,
                            "title": m.name,
                            "swc_id": m.swc_id,
                            "description": m.description.strip(),
                        }
                        for m in modules
                    ]
                )
            )
        else:
            for m in modules:
                print(f"{type(m).__name__}: {m.name} (SWC-{m.swc_id})")
        return

    if command == "read-storage":
        from mythril_tpu_torch.facade.mythril_config import MythrilConfig
        from mythril_tpu_torch.facade.mythril_disassembler import MythrilDisassembler

        config = MythrilConfig()
        config.set_api_rpc(parsed.rpc, parsed.rpctls)
        disassembler = MythrilDisassembler(eth=config.eth)
        print(
            disassembler.get_state_variable_from_storage(
                parsed.address, parsed.storage_slots
            )
        )
        return

    if command == "concolic":
        with open(parsed.input) as f:
            concrete_data = json.load(f)
        from mythril_tpu_torch.concolic.concolic_execution import concolic_execution

        branches = [int(b, 0) for b in parsed.branches.split(",")]
        results = concolic_execution(concrete_data, branches, parsed.solver_timeout,
                                     device=parsed.device)
        print(json.dumps(results, indent=2))
        return

    if command == "disassemble":
        disassembler = _disassembler(parsed)
        _load_code(parsed, disassembler)
        for contract in disassembler.contracts:
            if contract.disassembly is not None:
                print(contract.disassembly.get_easm())
            elif contract.creation_disassembly is not None:
                print(contract.creation_disassembly.get_easm())
        return

    if command == "static":
        _execute_static(parsed)
        return

    if command == "serve":
        return _execute_serve(parsed)

    if command == "submit":
        _execute_submit(parsed)
        return

    if command == "top":
        from mythril_tpu_torch.service.top import run_top

        return run_top(host=parsed.host, port=parsed.port,
                       interval=parsed.interval, once=parsed.once)

    if command == "health":
        return _execute_health(parsed)

    if command == "history":
        _execute_history(parsed)
        return

    if command == "drift":
        _execute_drift(parsed)
        return

    if command == "safe-functions":
        from mythril_tpu_torch.support.support_args import args as global_args

        _arm_observability(parsed)
        analyzer = _build_analyzer(parsed)
        analyzer.cmd_args.transaction_count = 1
        global_args.unconstrained_storage = True
        try:
            report = analyzer.fire_lasers()
        finally:
            _export_reports(parsed)
        issue_functions = {i["function"] for i in report.sorted_issues()}
        all_functions = set()
        for contract in analyzer.contracts:
            dis = contract.disassembly or contract.creation_disassembly
            if dis:
                all_functions |= set(dis.function_name_to_address.keys())
        safe = sorted(all_functions - issue_functions)
        print(f"{len(safe)} functions found to be safe (no issue found in 1-tx analysis "
              "with unconstrained storage; probe-based, not a completeness proof):")
        for fn in safe:
            print(f"  - {fn}")
        return

    if command == "analyze":
        _arm_observability(parsed)
        analyzer = _build_analyzer(parsed)
        if parsed.graph:
            html = analyzer.graph_html(enable_physics=parsed.enable_physics)
            with open(parsed.graph, "w") as f:
                f.write(html)
            return
        if parsed.statespace_json:
            with open(parsed.statespace_json, "w") as f:
                f.write(analyzer.dump_statespace())
            return
        try:
            report = analyzer.fire_lasers()
        finally:
            _export_reports(parsed)
        outputs = {
            "json": report.as_json,
            "jsonv2": report.as_swc_standard_format,
            "text": report.as_text,
            "markdown": report.as_markdown,
        }
        rendered = outputs[parsed.outform]()
        if parsed.epic and parsed.outform in ("text", "markdown"):
            from mythril_tpu_torch.interfaces.epic import print_epic

            print_epic(rendered)
        else:
            print(rendered)
        return

    raise CriticalError(f"unknown command {command}")


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Run one command line (``sys.argv[1:]`` when ``argv`` is None) and
    return its exit code.  argparse's own usage errors exit with code 2."""
    from mythril_tpu_torch.support.support_args import args

    parser = create_parser()
    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        argv = screen(argv)
    except Refused as e:
        print(f"{PROG}: {e}", file=sys.stderr)
        return 2
    parsed = parser.parse_args(argv)
    if parsed.version:
        print(f"{PROG} v{__version__}")
        return 0
    if not parsed.command:
        parser.print_help()
        return 0
    _set_logging(getattr(parsed, "v", 2))
    saved = dataclasses.replace(args)
    from mythril_tpu_torch.observability import get_tracer

    tracing = get_tracer().enabled
    try:
        rc = execute_command(parsed)
    except Refused as e:
        print(f"{PROG}: {e}", file=sys.stderr)
        return 2
    except MythrilBaseException as e:
        return exit_with_error(getattr(parsed, "outform", "text"), str(e))
    except DeviceError as e:
        return exit_with_error(getattr(parsed, "outform", "text"), f"{type(e).__name__}: {e}")
    except Exception:
        # the excepthook's bundle, written before the recorder is disarmed
        from mythril_tpu_torch.observability import get_flight_recorder

        recorder = get_flight_recorder()
        if recorder is not None:
            recorder.dump("exception", extra={"exception": traceback.format_exc()[-8000:]})
        raise
    finally:
        _disarm_observability(parsed)
        for field in dataclasses.fields(args):
            setattr(args, field.name, getattr(saved, field.name))
        # the tracer as it was (``--trace-out`` switched it on)
        get_tracer().enabled = tracing
        # the query cache singleton's switch and disk store, and the kernel
        # build cache's directory, as they were
        from mythril_tpu_torch.ops import _build
        from mythril_tpu_torch.querycache import configure

        configure(enabled=args.query_cache, cache_dir=args.query_cache_dir)
        _build.set_cache_dir(args.compile_cache_dir)
    return rc or 0
