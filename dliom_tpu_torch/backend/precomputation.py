"""Multi-resolution max-pool pyramid for correlative loop-closure search
(port of dliom_tpu/backend/precomputation.py; reference
PrecomputationGrid3D, precomputation_grid_3d.cc, and
PrecomputationGridStack3D, fast_correlative_scan_matcher_3d.cc:60-77).

Depth 0 holds probabilities as uint8 bytes over [0.1, 0.9]; each deeper
level holds, per cell, the max over a 2^depth-wide window (three axis-wise
shifted-max passes); beyond `full_resolution_depth` levels also halve
resolution with a 2x2x2 max."""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch

from dliom_tpu_torch.mapping import probability as pv
from dliom_tpu_torch.mapping.grid import GridSpec


def to_precomputation_values(values: torch.Tensor) -> torch.Tensor:
    """int16 cell values -> uint8 probability bytes (unknown -> 0)."""
    p = pv.value_to_probability(values.to(torch.int32))
    b = torch.round((p - pv.MIN_PROBABILITY)
                    * (255.0 / (pv.MAX_PROBABILITY - pv.MIN_PROBABILITY)))
    return torch.clamp(b, 0, 255).to(torch.uint8)


def probability_from_byte(b: torch.Tensor) -> torch.Tensor:
    """PrecomputationGrid3D::ToProbability."""
    return pv.MIN_PROBABILITY + b.to(torch.float32) * (
        (pv.MAX_PROBABILITY - pv.MIN_PROBABILITY) / 255.0)


def _shift_max_axis(g: torch.Tensor, axis: int, shift: int) -> torch.Tensor:
    """max(g[i], g[i + shift]) along `axis` (zero beyond the boundary)."""
    n = g.shape[axis]
    shifted = torch.zeros_like(g)
    shifted.narrow(axis, 0, n - shift).copy_(g.narrow(axis, shift, n - shift))
    return torch.maximum(g, shifted)


def _halve(g: torch.Tensor) -> torch.Tensor:
    """2x2x2 max downsample."""
    e = g.shape[0] // 2
    return g.reshape(e, 2, e, 2, e, 2).amax(dim=(1, 3, 5))


class Pyramid(NamedTuple):
    """uint8 grids, one per depth; levels[d] covers windows of 2^d
    full-resolution cells, at halved resolution beyond full_resolution_depth."""

    levels: Tuple[torch.Tensor, ...]  # each (e_d, e_d, e_d) uint8


def build_pyramid(values: torch.Tensor, spec: GridSpec, depth: int = 8,
                  full_resolution_depth: int = 3) -> Pyramid:
    """PrecomputationGridStack3D ctor."""
    e = spec.extent
    cur = to_precomputation_values(values).reshape(e, e, e)
    levels: List[torch.Tensor] = [cur]
    for d in range(1, depth):
        s = 1 << (d - 1)
        if d >= full_resolution_depth:
            s = max(1, s // (1 << max(0, d - full_resolution_depth)))
        for axis in range(3):
            cur = _shift_max_axis(cur, axis, min(s, cur.shape[axis] - 1))
        if d >= full_resolution_depth:
            cur = _halve(cur)
        levels.append(cur)
    return Pyramid(levels=tuple(levels))


def lookup(pyramid_level: torch.Tensor, cells: torch.Tensor, half: int) -> torch.Tensor:
    """uint8 values at signed cell indices (centered at `half` per axis of
    this level) as int32; out of bounds -> 0."""
    e = pyramid_level.shape[0]
    shifted = cells + half
    ok = torch.all((shifted >= 0) & (shifted < e), dim=-1)
    c = torch.clamp(shifted, 0, e - 1)
    flat = (c[..., 0] * e + c[..., 1]) * e + c[..., 2]
    vals = pyramid_level.reshape(-1)[flat.long()]
    return torch.where(ok, vals.to(torch.int32), 0)
