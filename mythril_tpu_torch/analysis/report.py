"""Issues and reports: text / markdown / json / SWC-standard jsonv2 renderers.

Reference parity: mythril/analysis/report.py:21-341 — Issue with source-map
resolution and function-name resolution, Report with the four output formats
(jsonv2 kept structurally compatible: issues sorted by (swc-id, address),
extra.discoveryTime, sourceMap/sourceList fields).  The port's jsonv2 meta
carries the JAX package's blocks: the execution info, the metrics snapshot
(``meta.observability``, with the trace summary when tracing was on), the
prefilter's and the devsolver's rollups, the exploration ledger, the static
pass's rollup, the watchtower's SLO state (``meta.health``), the device
plane (``meta.device``) and the frontier's isolation and paging rollup.
"""

from __future__ import annotations

import hashlib
import json
import time
from typing import Dict, List, Optional

from mythril_tpu_torch.support.support_utils import get_code_hash


class StartTime:
    """Singleton capturing analysis start (reference support/start_time.py)."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
            cls._instance.global_start_time = time.time()
        return cls._instance


class Issue:
    def __init__(
        self,
        contract: str,
        function_name: str,
        address: int,
        swc_id: str,
        title: str,
        bytecode,
        gas_used=(None, None),
        severity: Optional[str] = None,
        description_head: str = "",
        description_tail: str = "",
        transaction_sequence: Optional[Dict] = None,
    ):
        self.contract = contract
        self.function = function_name
        self.address = address
        self.title = title
        self.description_head = description_head
        self.description_tail = description_tail
        self.swc_id = swc_id
        self.min_gas_used, self.max_gas_used = gas_used
        self.severity = severity or "Medium"
        self.filename = None
        self.code = None
        self.lineno = None
        self.source_mapping = None
        self.discovery_time = time.time() - StartTime().global_start_time
        self.bytecode_hash = get_code_hash(bytecode) if bytecode is not None else ""
        self.transaction_sequence = transaction_sequence
        self.source_location = None

    @property
    def description(self) -> str:
        if self.description_tail:
            return f"{self.description_head}\n{self.description_tail}"
        return self.description_head

    @property
    def transaction_sequence_users(self) -> Optional[Dict]:
        """Tx sequence with symbolic leftovers pretty-printed for humans."""
        return self.transaction_sequence

    def as_dict(self) -> Dict:
        issue = {
            "title": self.title,
            "swc-id": self.swc_id,
            "contract": self.contract,
            "description": self.description,
            "function": self.function,
            "severity": self.severity,
            "address": self.address,
            "min_gas_used": self.min_gas_used,
            "max_gas_used": self.max_gas_used,
            "sourceMap": self.source_mapping,
        }
        if self.filename and self.lineno:
            issue["filename"] = self.filename
            issue["lineno"] = self.lineno
        if self.code:
            issue["code"] = self.code
        if self.transaction_sequence:
            issue["tx_sequence"] = self.transaction_sequence
        return issue

    def add_code_info(self, contract) -> None:
        """Resolve bytecode address -> source snippet (reference :140-175)."""
        if not self.address or not hasattr(contract, "get_source_info"):
            return
        source_info = contract.get_source_info(
            self.address, constructor=self.function == "constructor"
        )
        if source_info is None:
            return
        self.filename = source_info.filename
        self.code = source_info.code
        self.lineno = source_info.lineno
        self.source_mapping = source_info.solidity_file_idx

    def resolve_function_name(self, sigdb=None) -> None:
        """Resolve _function_0x... names via the signature DB (reference :177-199)."""
        if not self.function.startswith("_function_0x") or sigdb is None:
            return
        sigs = sigdb.get(self.function[len("_function_") :])
        if sigs:
            self.function = sigs[0]


class Report:
    environment: Dict = {}

    def __init__(self, contracts=None, exceptions=None, execution_info=None):
        self.issues: Dict[bytes, Issue] = {}
        self.solc_version = ""
        self.meta: Dict = {}
        self.source = SourceHolder()
        self.exceptions = exceptions or []
        self.execution_info = execution_info or []
        if contracts:
            self.source.from_contracts(contracts)

    def sorted_issues(self) -> List[Dict]:
        issue_list = [issue.as_dict() for issue in self.issues.values()]
        return sorted(issue_list, key=lambda k: (k["swc-id"], k["address"]))

    def append_issue(self, issue: Issue) -> None:
        # the FUNCTION is part of the identity (reference report.py:236-246
        # keys contract+function+address+title): solc >= 0.8 routes every
        # assert through one shared panic block, so two assert sites in
        # different functions report the same pc
        key = hashlib.md5(
            (
                issue.bytecode_hash
                + issue.function
                + str(issue.address)
                + issue.swc_id
                + issue.title
            ).encode()
        ).digest()
        self.issues[key] = issue

    # -- renderers ----------------------------------------------------------

    def as_text(self) -> str:
        if not self.issues:
            return "The analysis was completed successfully. No issues were detected.\n"
        blocks = []
        for issue in self.issues.values():
            lines = [
                f"==== {issue.title} ====",
                f"SWC ID: {issue.swc_id}",
                f"Severity: {issue.severity}",
                f"Contract: {issue.contract}",
                f"Function name: {issue.function}",
                f"PC address: {issue.address}",
                f"Estimated Gas Usage: {issue.min_gas_used} - {issue.max_gas_used}",
                issue.description,
            ]
            if issue.filename and issue.lineno:
                lines.append(f"--------------------\nIn file: {issue.filename}:{issue.lineno}")
            if issue.code:
                lines.append(f"\n{issue.code}\n")
            if issue.transaction_sequence:
                lines.append(
                    "\nTransaction Sequence:\n\n"
                    + json.dumps(issue.transaction_sequence, indent=4)
                )
            blocks.append("\n".join(lines))
        return "\n\n".join(blocks) + "\n"

    def as_markdown(self) -> str:
        if not self.issues:
            return "# Analysis results\n\nThe analysis was completed successfully. No issues were detected.\n"
        blocks = ["# Analysis results"]
        for issue in self.issues.values():
            block = [
                f"## {issue.title}",
                f"- SWC ID: {issue.swc_id}",
                f"- Severity: {issue.severity}",
                f"- Contract: {issue.contract}",
                f"- Function name: `{issue.function}`",
                f"- PC address: {issue.address}",
                f"- Estimated Gas Usage: {issue.min_gas_used} - {issue.max_gas_used}",
                "",
                "### Description",
                issue.description,
            ]
            if issue.filename and issue.lineno:
                block.append(f"\nIn file: {issue.filename}:{issue.lineno}")
            blocks.append("\n".join(block))
        return "\n\n".join(blocks) + "\n"

    def as_json(self) -> str:
        result = {"success": True, "error": None, "issues": self.sorted_issues()}
        return json.dumps(result, sort_keys=True)

    def _get_exception_data(self) -> Dict:
        if not self.exceptions:
            return {}
        return {"logs": [{"level": "error", "hidden": True, "msg": e} for e in self.exceptions]}

    def as_swc_standard_format(self) -> str:
        """SWC-standard jsonv2 (reference :250-341)."""
        _issues = []
        for issue in self.issues.values():
            idx = self.source.get_source_index(issue.bytecode_hash)
            extra = {"discoveryTime": int(issue.discovery_time * 10**9)}
            if issue.transaction_sequence:
                extra["testCases"] = [issue.transaction_sequence]
            _issues.append(
                {
                    "swcID": "SWC-" + issue.swc_id,
                    "swcTitle": _swc_title(issue.swc_id),
                    "description": {
                        "head": issue.description_head,
                        "tail": issue.description_tail,
                    },
                    "severity": issue.severity,
                    "locations": [{"sourceMap": f"{issue.address}:1:{idx}"}],
                    "extra": extra,
                }
            )
        meta = self._get_exception_data()
        if self.execution_info:
            meta["mythril_execution_info"] = {}
            for ei in self.execution_info:
                meta["mythril_execution_info"].update(ei.as_dict())
        # full metrics snapshot (and trace summary when tracing was on):
        # the machine-readable per-stage breakdown next to the execution
        # info rollups
        from mythril_tpu_torch.observability import observability_meta
        from mythril_tpu_torch.observability.deviceplane import device_meta
        from mythril_tpu_torch.observability.exploration import exploration_meta
        from mythril_tpu_torch.observability.watchtower import health_meta

        meta["observability"] = observability_meta()
        meta["prefilter"] = _prefilter_meta()
        meta["devsolver"] = _devsolver_meta()
        meta["exploration"] = exploration_meta()
        meta["staticpass"] = _staticpass_meta()
        meta["health"] = health_meta()
        meta["device"] = device_meta()
        meta["frontier"] = _frontier_meta()
        result = [
            {
                "issues": sorted(_issues, key=lambda k: k["swcID"]),
                "sourceType": self.source.source_type,
                "sourceFormat": self.source.source_format,
                "sourceList": self.source.source_list,
                "meta": meta,
            }
        ]
        return json.dumps(result, sort_keys=True)


def _staticpass_meta() -> dict:
    """Static-pass rollup for report ``meta``: gate state (including
    self-disable reasons), recovered functions, the reachable-edge
    oracle, and the top ranked interesting points."""
    try:
        from mythril_tpu_torch.staticpass import staticpass_meta

        return staticpass_meta()
    except Exception:  # reporting must never fail the report
        return {}


def _prefilter_meta() -> dict:
    """Abstract pre-filter rollup for report ``meta`` (kill-rate at a
    glance; the full counter set lives under meta.observability)."""
    from mythril_tpu_torch.observability import get_registry

    reg = get_registry()
    evaluated = reg.counter("prefilter.evaluated").value or 0
    killed = reg.counter("prefilter.killed").value or 0
    return {
        "evaluated": evaluated,
        "killed": killed,
        "fallthrough": reg.counter("prefilter.fallthrough").value or 0,
        "kill_rate": round(killed / evaluated, 4) if evaluated else 0.0,
    }


def _devsolver_meta() -> dict:
    """Device SAT tier rollup for report ``meta`` — decide-rate at a
    glance (decided / admitted; admission denials are not attempts)."""
    from mythril_tpu_torch.observability import get_registry

    reg = get_registry()
    admitted = reg.counter("devsolver.admitted").value or 0
    sat = reg.counter("devsolver.decided_sat").value or 0
    unsat = reg.counter("devsolver.decided_unsat").value or 0
    return {
        "admitted": admitted,
        "decided_sat": sat,
        "decided_unsat": unsat,
        "unknown": reg.counter("devsolver.unknown").value or 0,
        "model_validation_failures": reg.counter(
            "devsolver.model_validation_failures").value or 0,
        "kernel_wall_s": round(
            float(reg.counter("devsolver.kernel_wall_s").value or 0.0), 4),
        "decide_rate": round((sat + unsat) / admitted, 4) if admitted else 0.0,
    }


def _frontier_meta() -> dict:
    """Large-code frontier rollup for report ``meta`` — pad economics and
    paging pressure at a glance (bucket classes, pad-waste after
    isolation vs the single-bucket counterfactual, fault/repack counts
    and the resident fraction of paged codes)."""
    from mythril_tpu_torch.observability import get_registry

    reg = get_registry()
    return {
        "bucket_classes": reg.gauge("frontier.bucket_classes").value or 0,
        "pad_waste_pct": reg.gauge("frontier.pad_waste_pct").value or 0.0,
        "pad_waste_single_bucket_pct": reg.gauge(
            "frontier.pad_waste_single_bucket_pct").value or 0.0,
        "page_faults": reg.counter("frontier.page_faults").value or 0,
        "page_repacks": reg.counter("frontier.page_repacks").value or 0,
        "page_resident_pct": reg.gauge(
            "frontier.page_resident_pct").value or 100.0,
    }


def _swc_title(swc_id: str) -> str:
    from mythril_tpu_torch.analysis.swc_data import SWC_TO_TITLE

    return SWC_TO_TITLE.get(swc_id, "")


class SourceHolder:
    """Maps bytecode hashes to source identifiers for jsonv2 locations.

    Reference parity: mythril/support/source_support.py:1-65.
    """

    def __init__(self):
        self.source_type = "raw-bytecode"
        self.source_format = "evm-byzantium-bytecode"
        self.source_list: List[str] = []
        self._hash_index: Dict[str, int] = {}

    def from_contracts(self, contracts) -> None:
        for contract in contracts or []:
            if getattr(contract, "solidity_files", None):
                self.source_type = "solidity-file"
                self.source_format = "text"
                for f in contract.solidity_files:
                    self._append(f.filename)
                idx = self.source_list.index(contract.solidity_files[0].filename)
            else:
                code_hash = get_code_hash(getattr(contract, "code", "") or "")
                self._append(code_hash)
                idx = len(self.source_list) - 1
            if getattr(contract, "code", None):
                self._hash_index.setdefault(get_code_hash(contract.code), idx)
            if getattr(contract, "creation_code", None):
                self._hash_index.setdefault(get_code_hash(contract.creation_code), idx)

    def _append(self, name: str) -> None:
        if name not in self.source_list:
            self.source_list.append(name)

    def get_source_index(self, bytecode_hash: str) -> int:
        return self._hash_index.get(bytecode_hash, 0)
