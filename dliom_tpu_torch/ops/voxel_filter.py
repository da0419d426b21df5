"""Fixed-capacity voxel downsampling filters (port of
dliom_tpu/ops/voxel_filter.py; reference sensor/internal/voxel_filter.cc).

  * voxel index = round(point / edge_length) per component;
  * keep the first point (in input order) of each voxel;
  * the adaptive variant picks the coarsest level of a dyadic ladder of
    edge lengths <= max_length that still keeps >= min_num_points points
    (the JAX package's documented deviation from the reference's halving +
    binary refinement, kept here so the two packages agree).

JAX sorts (code, idx) as a two-key `lax.sort`; here one stable sort on the
code gives the same order, since idx is the input position. Every sort key
of this module is unique once idx breaks ties, so the survivor set is unique.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from dliom_tpu_torch.ops import morton

_LINEAR_R = 1280  # linear keys: 1280^3 < 2^31
_IDX_SENTINEL = 2**31 - 1


class FilteredCloud(NamedTuple):
    """Survivors compacted to the front (input order preserved)."""

    points: torch.Tensor  # (N, 3)
    times: torch.Tensor  # (N,)
    mask: torch.Tensor  # (N,)


def _first_of_sorted_group(codes: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    new = torch.ones_like(codes, dtype=torch.bool)
    new[1:] = codes[1:] != codes[:-1]
    return new & valid


def _linear_code(points: torch.Tensor, mask: torch.Tensor, edge_length: float) -> torch.Tensor:
    cells = torch.round(points / edge_length).to(torch.int32)
    c = torch.clamp(cells + _LINEAR_R // 2, 0, _LINEAR_R - 1)
    code = (c[:, 0] * _LINEAR_R + c[:, 1]) * _LINEAR_R + c[:, 2]
    return torch.where(mask, code, 2**31 - 1)


def _select_compact(
    points: torch.Tensor,
    times: torch.Tensor,
    keep_sorted: torch.Tensor,  # (N,) keep flags in sorted-key order
    s_idx: torch.Tensor,  # (N,) input index per sorted position
    out_capacity: int,
) -> FilteredCloud:
    """Capacity-select survivors and emit them compacted to the front in
    input order. Over capacity, rank r is kept iff its slot
    `(r * capacity) // count` differs from rank r-1's: a uniform stride over
    the code-sorted survivors."""
    n = s_idx.shape[0]
    cap = min(out_capacity, n)
    if cap < n:
        assert n * cap < 2**31, "capacity cut exceeds int32 rank arithmetic"
        keep_i = keep_sorted.to(torch.int32)
        rank = torch.cumsum(keep_i, 0, dtype=torch.int32) - keep_i
        count = torch.clamp(torch.sum(keep_i, dtype=torch.int32), min=1)
        over = count > cap
        slot = torch.div(rank * cap, count, rounding_mode="floor")
        prev_slot = torch.div((rank - 1) * cap, count, rounding_mode="floor")
        sel = keep_sorted & (~over | (rank == 0) | (slot != prev_slot))
    else:
        sel = keep_sorted
    out_key = torch.where(sel, s_idx, _IDX_SENTINEL)
    out_sorted, perm = torch.sort(out_key, stable=True)
    src = s_idx[perm[:cap]].long()
    out_mask = out_sorted[:cap] < _IDX_SENTINEL
    out_p = torch.where(out_mask[:, None], points[src], 0.0)
    out_t = torch.where(out_mask, times[src], 0.0)
    if out_capacity > cap:
        pad = out_capacity - cap
        out_p = torch.nn.functional.pad(out_p, (0, 0, 0, pad))
        out_t = torch.nn.functional.pad(out_t, (0, pad))
        out_mask = torch.nn.functional.pad(out_mask, (0, pad))
    return FilteredCloud(out_p, out_t, out_mask)


def voxel_filter_mask(points: torch.Tensor, mask: torch.Tensor, edge_length: float) -> torch.Tensor:
    """Keep-mask (in input order) of the plain voxel filter."""
    code = _linear_code(points, mask, edge_length)
    s_code, s_idx = torch.sort(code, stable=True)
    keep_sorted = _first_of_sorted_group(s_code, s_code < 2**31 - 1)
    keep = torch.empty_like(keep_sorted)
    keep[s_idx] = keep_sorted
    return keep


def voxel_filter(
    points: torch.Tensor,
    times: torch.Tensor,
    mask: torch.Tensor,
    edge_length: float,
    out_capacity: int | None = None,
) -> FilteredCloud:
    """Plain voxel filter at a fixed edge length, optionally capacity-cut."""
    n = points.shape[0]
    code = _linear_code(points, mask, edge_length)
    s_code, s_idx = torch.sort(code, stable=True)
    keep_sorted = _first_of_sorted_group(s_code, s_code < 2**31 - 1)
    return _select_compact(points, times, keep_sorted, s_idx.to(torch.int32), out_capacity or n)


def adaptive_voxel_filter(
    points: torch.Tensor,
    times: torch.Tensor,
    mask: torch.Tensor,
    *,
    max_length: float,
    min_num_points: int,
    max_range: float,
    num_octaves: int = 7,
    out_capacity: int | None = None,
) -> FilteredCloud:
    """Adaptive voxel filter (AdaptivelyVoxelFiltered, voxel_filter.cc:37-74):
    one Morton sort at the finest dyadic level; the chosen level is the
    coarsest with >= min_num_points survivors (finest if none reaches it)."""
    n = points.shape[0]
    max_levels = int(
        math.floor(math.log2(max(morton.RANGE // 2 * max_length / max_range, 1.0)))
    ) + 1
    levels = max(1, min(num_octaves, max_levels))
    finest = max_length / (2.0 ** (levels - 1))

    in_range = mask & (torch.sqrt(torch.sum(points * points, dim=-1)) <= max_range)
    n_valid = torch.sum(in_range, dtype=torch.int32)

    code = morton.encode(torch.round(points / finest).to(torch.int32))
    code = torch.where(in_range, code, 2**30)
    s_code, s_idx = torch.sort(code, stable=True)
    s_valid = s_code < 2**30

    firsts = torch.stack(
        [_first_of_sorted_group(s_code >> (3 * i), s_valid) for i in range(levels)]
    )  # (levels, N), finest first
    counts = torch.sum(firsts, dim=1, dtype=torch.int32)
    admissible = counts >= min_num_points
    # coarsest admissible level: the highest index with admissible set
    level_ids = torch.arange(levels, device=points.device)
    pick = torch.max(torch.where(admissible, level_ids, 0))
    keep_sorted = firsts.index_select(0, pick.reshape(1))[0]
    # sparse-enough input bypasses filtering (voxel_filter.cc:39-42)
    keep_sorted = torch.where(n_valid <= min_num_points, s_valid, keep_sorted)
    return _select_compact(points, times, keep_sorted, s_idx.to(torch.int32), out_capacity or n)
