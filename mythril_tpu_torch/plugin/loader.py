"""Routing loader for discovered plugins.

Reference parity: mythril/plugin/loader.py:21-90 — validates the plugin type
and dispatches to the matching subsystem: detection modules go to the
analysis ModuleLoader, engine plugins to the laser LaserPluginLoader.
"""

from __future__ import annotations

import logging
from typing import Dict, List

from mythril_tpu_torch.analysis.module.base import DetectionModule
from mythril_tpu_torch.analysis.module.loader import ModuleLoader
from mythril_tpu_torch.plugin.discovery import PluginDiscovery
from mythril_tpu_torch.plugin.interface import MythrilLaserPlugin, MythrilPlugin
from mythril_tpu_torch.plugins.loader import LaserPluginLoader
from mythril_tpu_torch.support.support_utils import Singleton

log = logging.getLogger(__name__)


class UnsupportedPluginType(Exception):
    """Raised when a discovered plugin matches no loadable interface."""


class MythrilPluginLoader(metaclass=Singleton):
    """Loads discovered plugins into the right subsystem."""

    def __init__(self):
        self.loaded_plugins: List[MythrilPlugin] = []
        self.plugin_args: Dict[str, Dict] = {}
        self._load_default_enabled()

    def set_args(self, plugin_name: str, **kwargs) -> None:
        self.plugin_args[plugin_name] = kwargs

    def load(self, plugin: MythrilPlugin) -> None:
        if not isinstance(plugin, MythrilPlugin):
            raise ValueError("passed plugin is not a MythrilPlugin")
        log.info("loading plugin: %s", plugin)
        if isinstance(plugin, DetectionModule):
            ModuleLoader().register_module(plugin)
        elif isinstance(plugin, MythrilLaserPlugin):
            LaserPluginLoader().load(plugin)
        else:
            raise UnsupportedPluginType(
                f"plugin type of {plugin!r} is not supported"
            )
        self.loaded_plugins.append(plugin)

    def _load_default_enabled(self) -> None:
        for name in PluginDiscovery().get_plugins(default_enabled=True):
            try:
                plugin = PluginDiscovery().build_plugin(
                    name, self.plugin_args.get(name, {})
                )
                self.load(plugin)
            except Exception as e:
                log.warning("could not load plugin %s: %s", name, e)
