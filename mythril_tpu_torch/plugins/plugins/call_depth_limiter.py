"""Call-depth limiter (reference parity: laser/plugin/plugins/call_depth_limiter.py:27-30)."""

from __future__ import annotations

from mythril_tpu_torch.core.state.global_state import GlobalState
from mythril_tpu_torch.plugins.interface import LaserPlugin, PluginBuilder
from mythril_tpu_torch.plugins.signals import PluginSkipState


class CallDepthLimit(LaserPlugin):
    def __init__(self, call_depth_limit: int = 3):
        self.call_depth_limit = call_depth_limit

    def initialize(self, symbolic_vm) -> None:
        def execute_state_hook(global_state: GlobalState):
            if len(global_state.transaction_stack) - 1 > self.call_depth_limit:
                raise PluginSkipState

        symbolic_vm.register_laser_hooks("execute_state", execute_state_hook)


class CallDepthLimitBuilder(PluginBuilder):
    name = "call-depth-limit"

    def __call__(self, *args, **kwargs) -> LaserPlugin:
        return CallDepthLimit(kwargs.get("call_depth_limit", 3))
