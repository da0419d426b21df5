"""Device selection. Torch dispatch follows each tensor's device, so the
port needs no platform context (dliom_tpu/common/platform.py): callers pick
a device once and every `make_*` constructor takes it. `constant` keeps the
steps' small host-made constants on each device."""

from __future__ import annotations

import torch


_CONSTANTS: dict = {}


def _frozen(values):
    return tuple(_frozen(v) for v in values) if isinstance(values, (list, tuple)) else values


def constant(values, dtype=torch.float32, device=None) -> torch.Tensor:
    """`torch.tensor(values, dtype=dtype, device=device)`, made once per
    (values, dtype, device) and reused after. A step that reads its
    constants this way copies no host data after its first call, so a CUDA
    graph can capture it. Callers must not write to the tensor."""
    device = torch.device("cpu" if device is None else device)
    key = (_frozen(values), dtype, device)
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS.setdefault(key, torch.tensor(values, dtype=dtype, device=device))
    return t


def get_device(name: str | torch.device = "cuda") -> torch.device:
    """`torch.device(name)`; raises when CUDA is asked for and absent."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda.is_available() is False")
    return device
