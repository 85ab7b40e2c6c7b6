"""Top-level plugin system: discovery + loading of externally-installed
extensions.

Distinct from the engine-level hook plugins (mythril_tpu_torch/plugins/): this
package finds plugins shipped by OTHER python packages and routes them into
the right subsystem (detection modules, engine plugins, CLI commands).
Reference parity: mythril/plugin/ (discovery.py:8-57, interface.py:5-45,
loader.py:21+), rebuilt on importlib.metadata instead of pkg_resources.
"""

from mythril_tpu_torch.plugin.discovery import PluginDiscovery
from mythril_tpu_torch.plugin.interface import (
    MythrilCLIPlugin,
    MythrilLaserPlugin,
    MythrilPlugin,
)
from mythril_tpu_torch.plugin.loader import MythrilPluginLoader, UnsupportedPluginType

__all__ = [
    "PluginDiscovery",
    "MythrilPlugin",
    "MythrilCLIPlugin",
    "MythrilLaserPlugin",
    "MythrilPluginLoader",
    "UnsupportedPluginType",
]
