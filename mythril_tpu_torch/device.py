"""Device selection for the port's entry points.

Every entry point takes ``device=None``; None means the CUDA card.  Without a
card the call raises unless the caller asked for the CPU explicitly — the
port never moves to the CPU on its own.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


class NoCudaDevice(RuntimeError):
    """CUDA was needed (no explicit ``device="cpu"``) but no card is visible."""


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
