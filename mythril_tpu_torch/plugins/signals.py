"""Plugin control-flow signals (reference parity: laser/plugin/signals.py:1-27)."""


class PluginSignal(Exception):
    pass


class PluginSkipState(PluginSignal):
    """Raised inside a state hook: drop this state from the work list."""


class PluginSkipWorldState(PluginSignal):
    """Raised inside a world-state hook: do not reseed from this world state."""
