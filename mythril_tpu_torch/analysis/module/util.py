"""Wiring of detection-module hooks onto the engine.

Reference parity: mythril/analysis/module/util.py:13-44 — builds the
opcode -> [module.execute] dicts, with START* wildcard support.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, List

from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.support.opcodes import OPCODES

OP_NAMES = [name for name in OPCODES]


def get_detection_module_hooks(
    modules: List[DetectionModule], hook_type: str = "pre"
) -> Dict[str, List[Callable]]:
    hook_dict: Dict[str, List[Callable]] = defaultdict(list)
    for module in modules:
        if module.entry_point != EntryPoint.CALLBACK:
            continue
        hooks = module.pre_hooks if hook_type == "pre" else module.post_hooks
        for op in hooks:
            if op.endswith("*"):
                prefix = op[:-1]
                for opcode in OP_NAMES:
                    if opcode.startswith(prefix):
                        hook_dict[opcode].append(module.execute)
            else:
                hook_dict[op].append(module.execute)
    return dict(hook_dict)
