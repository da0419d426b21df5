"""Integer helpers of grid insertion (port of the part of
dliom_tpu/ops/grid_update.py that the brick-grid insert uses).

The dense-bank insert (`_insert_slots`) is not ported yet."""

from __future__ import annotations

import torch


def _trunc_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C++-style integer division truncating toward zero (b > 0). Torch's
    `//` floors, so the remainder corrects negative quotients."""
    q = torch.div(a, b, rounding_mode="floor")
    r = a - q * b
    return q + ((r != 0) & (a < 0)).to(a.dtype)
