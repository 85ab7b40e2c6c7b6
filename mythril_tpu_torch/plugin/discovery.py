"""Discovery of plugins installed by other python packages.

Reference parity: mythril/plugin/discovery.py:8-57 (pkg_resources entry
points); this build uses ``importlib.metadata``, the modern equivalent.
Plugins register under the ``mythril_tpu_torch.plugins`` entry-point group.
"""

from __future__ import annotations

from importlib.metadata import entry_points
from typing import Any, Dict, List, Optional

from mythril_tpu_torch.plugin.interface import MythrilPlugin
from mythril_tpu_torch.support.support_utils import Singleton


class PluginDiscovery(metaclass=Singleton):
    """Finds and builds plugins exposed by installed python packages."""

    ENTRY_POINT_GROUP = "mythril_tpu_torch.plugins"

    _installed_plugins: Optional[Dict[str, Any]] = None

    def init_installed_plugins(self) -> None:
        found: Dict[str, Any] = {}
        try:
            eps = entry_points(group=self.ENTRY_POINT_GROUP)
        except TypeError:  # pre-3.10 importlib.metadata API
            eps = entry_points().get(self.ENTRY_POINT_GROUP, [])
        for ep in eps:
            try:
                found[ep.name] = ep.load()
            except Exception:  # a broken plugin must not break the host
                continue
        self._installed_plugins = found

    @property
    def installed_plugins(self) -> Dict[str, Any]:
        if self._installed_plugins is None:
            self.init_installed_plugins()
        return self._installed_plugins

    def is_installed(self, plugin_name: str) -> bool:
        return plugin_name in self.installed_plugins

    def build_plugin(self, plugin_name: str, plugin_args: Dict) -> MythrilPlugin:
        if not self.is_installed(plugin_name):
            raise ValueError(f"plugin `{plugin_name}` is not installed")
        plugin = self.installed_plugins.get(plugin_name)
        if plugin is None or not issubclass(plugin, MythrilPlugin):
            raise ValueError(f"no valid plugin found for {plugin_name}")
        return plugin(**plugin_args)

    def get_plugins(self, default_enabled: Optional[bool] = None) -> List[str]:
        if default_enabled is None:
            return list(self.installed_plugins.keys())
        return [
            name
            for name, cls in self.installed_plugins.items()
            if getattr(cls, "plugin_default_enabled", False) == default_enabled
        ]
