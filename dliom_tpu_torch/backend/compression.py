"""Fixed-capacity sparse compression of finished submap grids (port of
dliom_tpu/backend/compression.py).

A finished submap's dense grid is kept as its occupied cells — (linear
index, value) pairs at a fixed capacity — and decompressed on demand when
it is the target of a loop search (the sparsity of HybridGrid::ToProto,
hybrid_grid.h:530-545)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from dliom_tpu_torch.mapping.grid import GRID_DTYPE, GridSpec


class CompressedGrid(NamedTuple):
    indices: torch.Tensor  # (K,) int32 linear cell indices (sorted; pad = num_cells)
    values: torch.Tensor  # (K,) int16
    count: torch.Tensor  # () int32 number of valid entries


def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries, descending, the lower
    index first among equal values (jax.lax.top_k's order): one stable
    descending sort."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def compress(values: torch.Tensor, spec: GridSpec, capacity: int) -> CompressedGrid:
    """Keep up to `capacity` non-zero cells, the highest values first when
    over capacity; entries sorted by index."""
    flat = values.reshape(-1).to(torch.int32)
    neg = torch.where(flat > 0, -flat, 1)  # empty cells sort last
    _, top_idx = top_k(-neg, capacity)
    top_vals = flat[top_idx]
    valid = top_vals > 0
    count = torch.sum(valid, dtype=torch.int32)
    key = torch.where(valid, top_idx.to(torch.int32), spec.num_cells)
    key, order = torch.sort(key, stable=True)
    return CompressedGrid(
        indices=key,
        values=torch.where(valid, top_vals, 0)[order].to(GRID_DTYPE),
        count=count,
    )


def decompress(comp: CompressedGrid, spec: GridSpec) -> torch.Tensor:
    """Scatter back to a dense flat grid (padding entries drop)."""
    dense = torch.zeros(spec.num_cells + 1, dtype=GRID_DTYPE, device=comp.values.device)
    dense[comp.indices.long()] = comp.values
    return dense[: spec.num_cells]
