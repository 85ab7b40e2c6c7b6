"""Interfaces for externally-installed plugins.

Reference parity: mythril/plugin/interface.py:5-45.  A plugin package
exposes an entry point in the ``mythril_tpu_torch.plugins`` group whose value is a
class implementing one of these interfaces:

  * ``MythrilPlugin`` + DetectionModule -> a new detection module;
  * ``MythrilLaserPlugin`` (also a laser PluginBuilder) -> an engine hook
    plugin instrumented into the symbolic VM;
  * ``MythrilCLIPlugin`` -> extra CLI behavior (e.g. the concolic trace
    recorder the reference gates `myth concolic` on, cli.py:296).
"""

from __future__ import annotations

from abc import ABC

from mythril_tpu_torch.plugins.interface import PluginBuilder as LaserPluginBuilder


class MythrilPlugin:
    """Base interface carrying the metadata shown by plugin listings."""

    author = "Unknown Author"
    name = "Plugin"
    plugin_license = "All rights reserved."
    plugin_type = "Mythril Plugin"
    plugin_version = "0.0.1"
    plugin_description = ""
    plugin_default_enabled = False

    def __init__(self, **kwargs):
        pass

    def __repr__(self):
        return f"{type(self).__name__} - {self.plugin_version} - {self.author}"


class MythrilCLIPlugin(MythrilPlugin):
    """Plugins extending the command-line interface."""


class MythrilLaserPlugin(MythrilPlugin, LaserPluginBuilder, ABC):
    """Plugins instrumenting the symbolic VM (engine hook plugins)."""
