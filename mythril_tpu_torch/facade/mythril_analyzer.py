"""Analyzer facade: run symbolic execution + detectors per contract.

Reference parity: mythril/mythril/mythril_analyzer.py:27-189 — copies CLI
args into the global flag object, runs fire_lasers per contract with graceful
degradation to partial results, and offers statespace/graph dumps.

The port's analyzer runs on one device (``device``: None is the CUDA card and
raises ``NoCudaDevice`` without one; ``"cpu"`` runs the plain PyTorch
kernels).  It passes that device to every ``SymExecWrapper`` it builds, and
every solver call it makes after a wrapper returns (the detection modules'
post pass, issue collection, code info, function names) runs with it as
``args.device``.  A device fault (``device.is_device_fault``: no card, a
kernel that did not build, launch or run, an allocation the card refused)
fails the analysis instead of degrading to partial results.  Under the
``auto`` probe backend the report's execution info carries the link
calibration (``CalibrationInfo``) once a decision for the card measured it.
"""

from __future__ import annotations

import logging
import traceback
from dataclasses import dataclass
from typing import List, Optional

from mythril_tpu_torch.analysis.report import Issue, Report
from mythril_tpu_torch.analysis.security import fire_lasers, retrieve_callback_issues
from mythril_tpu_torch.analysis.symbolic import SymExecWrapper, analysis_device
from mythril_tpu_torch.device import DeviceLike, is_device_fault, resolve
from mythril_tpu_torch.smt.solver import SolverStatistics
from mythril_tpu_torch.support.support_args import args

log = logging.getLogger(__name__)


@dataclass
class AnalyzerArgs:
    """The JAX package's ``AnalyzerArgs`` for the options the port has;
    ``probe_backend`` is one of ``support_args.PROBE_BACKENDS``, ``auto`` by
    default as in the JAX package."""

    strategy: str = "dfs"
    max_depth: int = 128
    execution_timeout: int = 86400
    create_timeout: int = 10
    loop_bound: int = 3
    call_depth_limit: int = 3
    transaction_count: int = 2
    modules: Optional[List[str]] = None
    disable_dependency_pruning: bool = False
    solver_timeout: int = 10000
    unconstrained_storage: bool = False
    sparse_pruning: bool = False
    solver_log: Optional[str] = None
    enable_iprof: bool = False
    benchmark_path: Optional[str] = None
    enable_coverage_strategy: bool = False
    custom_modules_directory: str = ""
    checkpoint_file: Optional[str] = None
    resume_from: Optional[str] = None
    probe_backend: str = "auto"
    frontier: bool = False
    frontier_width: int = 64
    frontier_force: bool = False
    query_cache: bool = True
    query_cache_dir: Optional[str] = None
    staticpass: bool = True
    staticpass_interproc: bool = True
    code_paging: bool = True
    code_page_budget: int = 2048
    prefilter: bool = True
    devsolver: bool = True
    devsolver_bit_budget: int = 64
    devsolver_iters: int = 2048
    frontier_mesh: bool = True
    pipeline: bool = True
    solver_workers: int = 2
    harvest_workers: int = 4
    adaptive: bool = True
    coverage_target: Optional[float] = None
    compile_cache_dir: Optional[str] = None
    # one directory pinning both persistent caches (querycache/ + kernels/);
    # explicit query_cache_dir / compile_cache_dir win over the derivation
    cache_root: Optional[str] = None
    heartbeat_out: Optional[str] = None
    heartbeat_interval: float = 0.5
    flight_recorder: Optional[str] = None
    watchdog_deadline: Optional[float] = None
    #: record the metrics registry into a persistent delta-encoded
    #: history ring under this directory (``history`` reads it)
    history_dir: Optional[str] = None


class MythrilAnalyzer:
    def __init__(
        self,
        disassembler,
        cmd_args: AnalyzerArgs,
        strategy: str = "dfs",
        address: Optional[str] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve(device)
        self.eth = disassembler.eth
        self.contracts = disassembler.contracts or []
        self.strategy = strategy or cmd_args.strategy
        self.address = address
        self.cmd_args = cmd_args

        # anchor issue discovery timestamps before any analysis starts
        from mythril_tpu_torch.analysis.report import StartTime

        StartTime()

        # propagate flags to the global args object (reference :63-70)
        from mythril_tpu_torch.facade.warm import apply_analyzer_args

        apply_analyzer_args(cmd_args)

    def _sym_exec(self, contract, run_analysis_modules: bool = True) -> SymExecWrapper:
        from mythril_tpu_torch.support.loader import DynLoader

        dynloader = DynLoader(self.eth, active=self.eth is not None)
        return SymExecWrapper(
            contract,
            self.address or "0x" + "0" * 38 + "06",
            strategy=self.strategy,
            dynloader=dynloader,
            max_depth=self.cmd_args.max_depth,
            execution_timeout=self.cmd_args.execution_timeout,
            create_timeout=self.cmd_args.create_timeout,
            loop_bound=self.cmd_args.loop_bound,
            transaction_count=self.cmd_args.transaction_count,
            modules=self.cmd_args.modules,
            disable_dependency_pruning=self.cmd_args.disable_dependency_pruning,
            run_analysis_modules=run_analysis_modules,
            enable_coverage_strategy=self.cmd_args.enable_coverage_strategy,
            custom_modules_directory=self.cmd_args.custom_modules_directory,
            device=self.device,
        )

    def dump_statespace(self, contract=None) -> str:
        import json

        from mythril_tpu_torch.analysis.traceexplore import get_serializable_statespace

        sym = self._sym_exec(
            contract or self.contracts[0], run_analysis_modules=False
        )
        return json.dumps(get_serializable_statespace(sym))

    def graph_html(
        self, contract=None, enable_physics: bool = False, phrackify: bool = False
    ) -> str:
        from mythril_tpu_torch.analysis.callgraph import generate_graph

        sym = self._sym_exec(
            contract or self.contracts[0], run_analysis_modules=False
        )
        return generate_graph(sym, physics=enable_physics, phrackify=phrackify)

    def fire_lasers(self, modules: Optional[List[str]] = None) -> Report:
        from mythril_tpu_torch.frontier.engine import reset_isolation_gauges

        reset_isolation_gauges()
        SolverStatistics().enabled = True
        benchmark_base = args.benchmark_path
        try:
            with analysis_device(self.device):
                all_issues, exceptions, execution_info = self._fire_lasers_loop(
                    modules, benchmark_base)
        finally:
            args.benchmark_path = benchmark_base
        report = Report(
            contracts=self.contracts,
            exceptions=exceptions,
            execution_info=execution_info,
        )
        for issue in all_issues:
            report.append_issue(issue)
        return report

    def _fire_lasers_loop(self, modules, benchmark_base):
        from mythril_tpu_torch.core.execution_info import (
            CalibrationInfo,
            EngineStatsInfo,
            FrontierStatsInfo,
            SolverStatsInfo,
        )
        from mythril_tpu_torch.support.signatures import SignatureDB

        all_issues: List[Issue] = []
        exceptions = []
        execution_info = []
        for n_contract, contract in enumerate(self.contracts):
            if benchmark_base and len(self.contracts) > 1:
                # one series file per contract instead of silent overwrites
                args.benchmark_path = f"{benchmark_base}.{n_contract}"
            # the counters are process-wide: without a per-contract reset,
            # contract N's report would count the earlier contracts too;
            # reset_analysis_metrics also sweeps the exploration ledger's
            # bitmaps and the adaptive controller's scope
            from mythril_tpu_torch.observability import reset_analysis_metrics

            reset_analysis_metrics()
            try:
                sym = self._sym_exec(contract)
                issues = fire_lasers(sym, modules or self.cmd_args.modules)
                execution_info = [
                    EngineStatsInfo(sym.laser),
                    SolverStatsInfo(),
                    CalibrationInfo(),
                ]
                if args.frontier:
                    execution_info.append(FrontierStatsInfo())
            except KeyboardInterrupt:
                log.critical("keyboard interrupt: saving partial results")
                issues = retrieve_callback_issues(modules or self.cmd_args.modules)
            except Exception as e:  # noqa: BLE001 - graceful degradation to partial results
                if is_device_fault(e):
                    raise  # the device failed the run, not this contract
                log.exception("exception during analysis; saving partial results")
                issues = retrieve_callback_issues(modules or self.cmd_args.modules)
                exceptions.append(traceback.format_exc())
            sigdb = SignatureDB()
            for issue in issues:
                issue.add_code_info(contract)
                issue.resolve_function_name(sigdb)
            log.info("solver statistics: %s", SolverStatistics())
            all_issues += issues
        return all_issues, exceptions, execution_info
