"""Device selection for the port's entry points.

Every entry point takes ``device=None``; None means the CUDA card.  Without a
card the call raises unless the caller asked for the CPU explicitly — the
port never moves to the CPU on its own.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


class DeviceError(RuntimeError):
    """The device failed the run: no card, or a kernel that did not build or
    launch.  Never the fault of one analysed path, so the engine lets it
    propagate where it drops a path whose replay raised."""


class NoCudaDevice(DeviceError):
    """CUDA was needed (no explicit ``device="cpu"``) but no card is visible."""


# what the card raises besides the port's own ``DeviceError``: a kernel that
# faults while it runs surfaces at the next synchronization as an
# ``AcceleratorError``, a failed allocation as an ``OutOfMemoryError``
_DEVICE_FAULTS = (DeviceError, torch.AcceleratorError, torch.OutOfMemoryError)


def is_device_fault(exc: BaseException) -> bool:
    """Whether ``exc`` is the device failing the run rather than one
    analysed path: a ``DeviceError``, a ``torch.AcceleratorError`` or a
    ``torch.OutOfMemoryError``.  Any other ``RuntimeError`` is host code's,
    which raises them too."""
    return isinstance(exc, _DEVICE_FAULTS)


def resolve(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: CUDA unless CPU was requested."""
    if device is None:
        if not torch.cuda.is_available():
            raise NoCudaDevice(
                "no CUDA device is visible; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoCudaDevice(f"device {dev} requested but CUDA is not available")
    return dev
