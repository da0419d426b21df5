"""Deterministic float segment sums.

`index_add_` on a CUDA float tensor adds with atomics, so its result
changes in the last bits from run to run. The JAX package sums with one-hot
matmuls, which are deterministic. Here the sum is a sorted segment
reduction instead: a stable sort of the segment ids, then
`torch.segment_reduce` over the sorted values, which adds each segment's
values one after another in input order (one thread per output element on
CUDA for 2-D data; 1-D values are summed as one column for that reason).
That is the order of the CPU's `index_add_`, so the CPU result is the same
as before, bit for bit, and the card gives the same bits on every run. A
one-hot matmul would need (values x segments) memory, too much for the NDT
field's 4096 voxels.

`segment_plan` does the sort once for ids that are reused (the SPA's
constraint -> node maps, summed many times per solve).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SegmentPlan(NamedTuple):
    order: torch.Tensor  # (N,) int64 positions sorted by segment, stable
    lengths: torch.Tensor  # (num_segments + 1,) int64; the last counts dropped ids
    num_segments: int


def segment_plan(segment_ids: torch.Tensor, num_segments: int) -> SegmentPlan:
    """Sort `segment_ids` (N,) once; ids outside [0, num_segments) drop."""
    ids = segment_ids.long()
    key = torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)
    s_key, order = torch.sort(key, stable=True)
    bounds = torch.arange(num_segments + 1, dtype=s_key.dtype, device=s_key.device)
    starts = torch.searchsorted(s_key, bounds)
    lengths = torch.diff(starts, append=starts.new_full((1,), key.shape[0]))
    return SegmentPlan(order, lengths, num_segments)


def segment_sum(values: torch.Tensor, segment_ids, num_segments: int | None = None) -> torch.Tensor:
    """Sum of `values` (N, ...) per segment: (num_segments, ...). The ids
    are an (N,) tensor, or a `SegmentPlan` made from them."""
    plan = segment_ids if isinstance(segment_ids, SegmentPlan) else segment_plan(segment_ids, num_segments)
    n = values.shape[0]
    out_shape = (plan.num_segments,) + values.shape[1:]
    if n == 0:
        return values.new_zeros(out_shape)
    data = values[plan.order].reshape(n, -1)
    out = torch.segment_reduce(data, "sum", lengths=plan.lengths, unsafe=True)
    return out[: plan.num_segments].reshape(out_shape)
