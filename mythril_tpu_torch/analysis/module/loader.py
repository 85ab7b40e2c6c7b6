"""ModuleLoader: singleton registry of the 14 built-in detection modules.

Reference parity: mythril/analysis/module/loader.py:31-108 — whitelist
filtering by module name and dropping IntegerArithmetics for solc >= 0.8
(whose checked arithmetic already reverts on overflow).
"""

from __future__ import annotations

import logging
from typing import List, Optional

from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.support.support_args import args
from mythril_tpu_torch.support.support_utils import Singleton

log = logging.getLogger(__name__)


class ModuleLoader(metaclass=Singleton):
    def __init__(self):
        self._modules: List[DetectionModule] = []
        self._register_mythril_modules()

    def register_module(self, detection_module: DetectionModule) -> None:
        if not isinstance(detection_module, DetectionModule):
            raise ValueError("registered module must be a DetectionModule instance")
        self._modules.append(detection_module)

    def get_detection_modules(
        self,
        entry_point: Optional[EntryPoint] = None,
        white_list: Optional[List[str]] = None,
        static_view=None,
    ) -> List[DetectionModule]:
        """``static_view`` (a staticpass GateView, or None) drops CALLBACK
        modules statically proven irrelevant for the contract being set up.
        Only the hook-registration path (analysis/symbolic.py) passes it;
        issue collection always sees every module, so nothing a non-skipped
        module found is ever lost."""
        result = self._modules[:]
        if white_list:
            available = {type(m).__name__ for m in result}
            for name in white_list:
                if name not in available:
                    from mythril_tpu_torch.exceptions import DetectorNotFoundError

                    raise DetectorNotFoundError(f"unknown detection module: {name}")
            result = [m for m in result if type(m).__name__ in white_list]
        if not args.use_integer_module:
            result = [m for m in result if type(m).__name__ != "IntegerArithmetics"]
        if entry_point:
            result = [m for m in result if m.entry_point == entry_point]
        if static_view is not None and entry_point == EntryPoint.CALLBACK:
            from mythril_tpu_torch.observability import get_registry
            from mythril_tpu_torch.staticpass import filter_modules

            result, skipped = filter_modules(result, static_view)
            if skipped:
                reg = get_registry()
                reg.counter("staticpass.modules_skipped").inc(len(skipped))
                reg.counter("staticpass.hooks_elided").inc(
                    sum(len(m.pre_hooks) + len(m.post_hooks) for m in skipped)
                )
        return result

    def load_custom_modules(self, directory: str) -> None:
        """Load DetectionModule subclasses from every .py file in ``directory``
        (counterpart of the reference's --custom-modules-directory)."""
        import importlib.util
        import inspect
        import os

        for fname in sorted(os.listdir(directory)):
            if not fname.endswith(".py") or fname.startswith("_"):
                continue
            path = os.path.join(directory, fname)
            spec = importlib.util.spec_from_file_location(f"custom_module_{fname[:-3]}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            for _, cls in inspect.getmembers(mod, inspect.isclass):
                if (
                    issubclass(cls, DetectionModule)
                    and cls is not DetectionModule
                    and cls.__module__ == mod.__name__
                ):
                    # dedup by qualified name: exec_module creates a fresh
                    # class object per load, so identity can never match
                    key = (cls.__module__, cls.__qualname__)
                    if not any(
                        (type(m).__module__, type(m).__qualname__) == key
                        for m in self._modules
                    ):
                        self.register_module(cls())
                        log.info("loaded custom detection module %s", cls.__name__)

    def _register_mythril_modules(self) -> None:
        from mythril_tpu_torch.analysis.module.modules.arbitrary_jump import ArbitraryJump
        from mythril_tpu_torch.analysis.module.modules.arbitrary_write import ArbitraryStorage
        from mythril_tpu_torch.analysis.module.modules.delegatecall import ArbitraryDelegateCall
        from mythril_tpu_torch.analysis.module.modules.dependence_on_origin import TxOrigin
        from mythril_tpu_torch.analysis.module.modules.dependence_on_predictable_vars import (
            PredictableVariables,
        )
        from mythril_tpu_torch.analysis.module.modules.ether_thief import EtherThief
        from mythril_tpu_torch.analysis.module.modules.exceptions import Exceptions
        from mythril_tpu_torch.analysis.module.modules.external_calls import ExternalCalls
        from mythril_tpu_torch.analysis.module.modules.integer import IntegerArithmetics
        from mythril_tpu_torch.analysis.module.modules.multiple_sends import MultipleSends
        from mythril_tpu_torch.analysis.module.modules.state_change_external_calls import (
            StateChangeAfterCall,
        )
        from mythril_tpu_torch.analysis.module.modules.suicide import AccidentallyKillable
        from mythril_tpu_torch.analysis.module.modules.unchecked_retval import UncheckedRetval
        from mythril_tpu_torch.analysis.module.modules.user_assertions import UserAssertions

        self._modules.extend(
            [
                ArbitraryJump(),
                ArbitraryStorage(),
                ArbitraryDelegateCall(),
                PredictableVariables(),
                TxOrigin(),
                EtherThief(),
                Exceptions(),
                ExternalCalls(),
                IntegerArithmetics(),
                MultipleSends(),
                StateChangeAfterCall(),
                AccidentallyKillable(),
                UncheckedRetval(),
                UserAssertions(),
            ]
        )
