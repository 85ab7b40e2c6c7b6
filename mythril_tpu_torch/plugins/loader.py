"""Plugin loader singleton (reference parity: laser/plugin/loader.py:12-75)."""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

from mythril_tpu_torch.plugins.interface import LaserPlugin, PluginBuilder
from mythril_tpu_torch.support.support_utils import Singleton

log = logging.getLogger(__name__)


class LaserPluginLoader(metaclass=Singleton):
    def __init__(self):
        self.laser_plugin_builders: Dict[str, PluginBuilder] = {}
        self.plugin_args: Dict[str, Dict] = {}

    def load(self, builder: PluginBuilder) -> None:
        if builder.name in self.laser_plugin_builders:
            log.warning("plugin %s already loaded; skipping", builder.name)
            return
        self.laser_plugin_builders[builder.name] = builder

    def add_args(self, plugin_name: str, **kwargs) -> None:
        self.plugin_args[plugin_name] = kwargs

    def is_enabled(self, plugin_name: str) -> bool:
        builder = self.laser_plugin_builders.get(plugin_name)
        return builder is not None and builder.enabled

    def enable(self, plugin_name: str) -> None:
        if plugin_name in self.laser_plugin_builders:
            self.laser_plugin_builders[plugin_name].enabled = True

    def disable(self, plugin_name: str) -> None:
        if plugin_name in self.laser_plugin_builders:
            self.laser_plugin_builders[plugin_name].enabled = False

    def instrument_virtual_machine(self, symbolic_vm, with_plugins: Optional[List[str]] = None):
        for name, builder in self.laser_plugin_builders.items():
            if not builder.enabled:
                continue
            if with_plugins is not None and name not in with_plugins:
                continue
            plugin = builder(**self.plugin_args.get(name, {}))
            plugin.initialize(symbolic_vm)
            log.debug("instrumented vm with plugin %s", name)
