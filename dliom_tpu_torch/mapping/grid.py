"""Dense submap probability grids (port of dliom_tpu/mapping/grid.py).

Cell index `i` has its center at `i * resolution`; a point maps to
`round(point / resolution)` per component (hybrid_grid.h:430-446). Values
are int16: 0 unknown, [1, 32767] onto probabilities [0.1, 0.9].
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from dliom_tpu_torch.mapping import probability as pv

GRID_DTYPE = torch.int16


@dataclass(frozen=True)
class GridSpec:
    """Static description of one dense grid."""

    resolution: float
    extent: int  # cells per axis; grid covers [-extent/2, extent/2)
    apply_groups: int = 0

    @property
    def num_cells(self) -> int:
        return self.extent ** 3

    @property
    def half(self) -> int:
        return self.extent // 2


def make_grid(spec: GridSpec, device=None) -> torch.Tensor:
    """A fresh all-unknown grid, flat (extent^3,) int16."""
    return torch.zeros(spec.num_cells, dtype=GRID_DTYPE, device=device)


def cell_index(points: torch.Tensor, resolution: float) -> torch.Tensor:
    """Point(s) (..., 3) -> signed int32 cell index; torch.round rounds half
    to even, as jnp.round does."""
    return torch.round(points / resolution).to(torch.int32)


def linear_index(cells: torch.Tensor, spec: GridSpec) -> Tuple[torch.Tensor, torch.Tensor]:
    """Signed cell index (..., 3) -> (flat index, in-bounds mask);
    out-of-bounds indices are clamped and must be masked by the caller."""
    shifted = cells + spec.half
    in_bounds = torch.all((shifted >= 0) & (shifted < spec.extent), dim=-1)
    clamped = torch.clamp(shifted, 0, spec.extent - 1)
    lin = (clamped[..., 0] * spec.extent + clamped[..., 1]) * spec.extent + clamped[..., 2]
    return lin, in_bounds


_CORNERS = np.asarray(
    [[dx, dy, dz] for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)], np.int32
)


def _corners_like(t: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(_CORNERS, device=t.device)


def _corner_weights(s: torch.Tensor) -> torch.Tensor:
    """Trilinear corner weights (..., 8) from per-axis upper weights (..., 3)."""
    return torch.stack(
        [
            (s[..., 0] if dx else 1.0 - s[..., 0])
            * (s[..., 1] if dy else 1.0 - s[..., 1])
            * (s[..., 2] if dz else 1.0 - s[..., 2])
            for dx in (0, 1)
            for dy in (0, 1)
            for dz in (0, 1)
        ],
        dim=-1,
    )


def smoothstep_trilinear(points: torch.Tensor, resolution: float, lookup) -> torch.Tensor:
    """Smoothstep-trilinear probability at point(s) (..., 3).

    Per axis the interpolant is lerp(q_lo, q_hi, s(t)) with
    s(t) = 3t^2 - 2t^3 (InterpolatedGrid::GetProbability,
    interpolated_grid.h:50-103); the lower corner is floor(p / res). `lookup`
    maps signed int32 corner cells (..., 8, 3) to cell values."""
    pr = points / resolution
    lower = torch.floor(pr)
    t = pr - lower
    s = t * t * (3.0 - 2.0 * t)
    lower = lower.to(torch.int32)
    q = pv.value_to_probability(lookup(lower[..., None, :] + _corners_like(lower)))
    return torch.sum(q * _corner_weights(s), dim=-1)


def lookup_value(values: torch.Tensor, cells: torch.Tensor, spec: GridSpec, base=0) -> torch.Tensor:
    """Cell value(s) at signed cell indices; unknown (0) out of bounds.
    `base` offsets into a flat multi-submap bank."""
    lin, ok = linear_index(cells, spec)
    v = values[base + lin].to(torch.int32)
    return torch.where(ok, v, 0)


def interpolated_probability(values: torch.Tensor, points: torch.Tensor, spec: GridSpec,
                             base=0) -> torch.Tensor:
    """Smoothstep-trilinear probability at point(s) (..., 3) in the grid
    frame (see smoothstep_trilinear)."""
    return smoothstep_trilinear(
        points, spec.resolution, lambda cells: lookup_value(values, cells, spec, base))
