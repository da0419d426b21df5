"""Morton (z-order) encoding for voxel keys (port of dliom_tpu/ops/morton.py).

10 bits per axis interleave into one int32, so the level-i voxel of a point
is its Morton code shifted right by 3i.
"""

from __future__ import annotations

import torch

BITS = 10
RANGE = 1 << BITS


def part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits of x so there are two zero bits between each."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def compact1by2(x: torch.Tensor) -> torch.Tensor:
    """Inverse of part1by2."""
    x = x & 0x9249249
    x = (x | (x >> 2)) & 0x30C30C3
    x = (x | (x >> 4)) & 0x300F00F
    x = (x | (x >> 8)) & 0x30000FF
    x = (x | (x >> 16)) & 0x3FF
    return x


def encode(cells: torch.Tensor) -> torch.Tensor:
    """Signed int32 voxel indices (..., 3) in [-512, 512) -> Morton codes;
    out-of-range indices clamp onto the boundary shell."""
    c = torch.clamp(cells + RANGE // 2, 0, RANGE - 1)
    return part1by2(c[..., 0]) | (part1by2(c[..., 1]) << 1) | (part1by2(c[..., 2]) << 2)
