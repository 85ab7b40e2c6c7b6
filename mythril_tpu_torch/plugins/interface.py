"""Plugin interfaces (reference parity: laser/plugin/interface.py:4, builder.py:6)."""

from __future__ import annotations


class LaserPlugin:
    def initialize(self, symbolic_vm) -> None:
        raise NotImplementedError


class PluginBuilder:
    name = "plugin"

    def __init__(self):
        self.enabled = True

    def __call__(self, *args, **kwargs) -> LaserPlugin:
        raise NotImplementedError
