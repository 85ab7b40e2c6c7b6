"""fire_lasers: run POST modules and collect all issues.

Reference parity: mythril/analysis/security.py:28-45.
"""

from __future__ import annotations

import logging
from typing import List, Optional

from mythril_tpu_torch.analysis.module.base import EntryPoint
from mythril_tpu_torch.analysis.module.loader import ModuleLoader
from mythril_tpu_torch.analysis.report import Issue
from mythril_tpu_torch.observability import tracer as _otrace

log = logging.getLogger(__name__)


def retrieve_callback_issues(white_list: Optional[List[str]] = None) -> List[Issue]:
    issues: List[Issue] = []
    for module in ModuleLoader().get_detection_modules(
        entry_point=EntryPoint.CALLBACK, white_list=white_list
    ):
        issues.extend(module.issues)
    reset_callback_modules(module_names=white_list)
    return issues


def fire_lasers(statespace, white_list: Optional[List[str]] = None) -> List[Issue]:
    log.info("Starting analysis")
    issues: List[Issue] = []
    with _otrace.span("analysis.post_modules", cat="analysis"):
        for module in ModuleLoader().get_detection_modules(
            entry_point=EntryPoint.POST, white_list=white_list
        ):
            log.info("Executing %s", module.name)
            result = module.execute(statespace)
            if result:
                issues.extend(result)
    issues.extend(retrieve_callback_issues(white_list))
    return issues


def reset_callback_modules(module_names: Optional[List[str]] = None) -> None:
    for module in ModuleLoader().get_detection_modules(
        entry_point=EntryPoint.CALLBACK, white_list=module_names
    ):
        module.reset_module()
