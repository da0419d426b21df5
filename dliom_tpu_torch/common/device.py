"""Device selection. Torch dispatch follows each tensor's device, so the
port needs no platform context (dliom_tpu/common/platform.py): callers pick
a device once and every `make_*` constructor takes it."""

from __future__ import annotations

import torch


def get_device(name: str = "cuda") -> torch.device:
    """`torch.device(name)`; raises when CUDA is asked for and absent."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda.is_available() is False")
    return device
