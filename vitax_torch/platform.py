"""Device selection: the port runs on the card unless asked for the CPU.

There is no silent fallback: asking for cuda on a host without a usable
card raises, so a measurement never lands on the CPU by accident.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """torch.device for `device` (default "cuda"); raises when a CUDA device
    is asked for and torch sees none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} asked for but no CUDA card is available "
            f"(torch {torch.__version__}, CUDA build: {torch.version.cuda}); "
            f"pass device='cpu' (CLI: --device cpu) to run on the CPU")
    return dev


def device_kind(device: Optional[torch.device] = None) -> str:
    """The hardware name of `device` (the card's name, or "cpu")."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "cpu"
