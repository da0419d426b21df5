"""Rotational scan-matcher histogram (port of
dliom_tpu/ops/rotational_histogram.py::compute_histogram; reference
mapping/internal/3d/scan_matching/rotational_scan_matcher.cc).

Points are cut into 0.2 m z-slices and sorted by angle about their slice's
xy centroid; each consecutive pair within a slice adds the orthogonality
of its xy delta to the centroid ray into the bucket of the delta's angle.
Segment sums use `index_add_`: the JAX package's one-hot matmuls work
around TPU scatters, which a GPU does not need.
"""

from __future__ import annotations

import math

import torch

MIN_DISTANCE = 0.2
MAX_DISTANCE = 0.9
SLICE_HEIGHT = 0.2
_NUM_SLICES = 1024  # z in [-102.4, 102.4) m


def compute_histogram(points: torch.Tensor, mask: torch.Tensor, num_buckets: int = 120) -> torch.Tensor:
    """Histogram of a gravity-aligned cloud; (num_buckets,) float32."""
    dev = points.device
    z_slice = torch.round(points[:, 2] / SLICE_HEIGHT).to(torch.int32)
    slice_id = torch.clamp(z_slice + _NUM_SLICES // 2, 0, _NUM_SLICES - 1)
    seg = torch.where(mask, slice_id, _NUM_SLICES)  # sentinel row for invalid points

    ones = mask.to(torch.float32)
    sums = torch.zeros(_NUM_SLICES + 1, 3, dtype=torch.float32, device=dev)
    sums.index_add_(0, seg.long(), torch.cat([points[:, :2] * ones[:, None], ones[:, None]], dim=1))
    centroids = sums[:, :2] / torch.clamp(sums[:, 2], min=1.0)[:, None]
    centroid = torch.where(mask[:, None], centroids[seg.long()], 0.0)

    offs = points[:, :2] - centroid
    far_enough = torch.sqrt(torch.sum(offs * offs, dim=-1)) >= MIN_DISTANCE
    angle_about_centroid = torch.atan2(offs[:, 1], offs[:, 0])

    # one int32 key: slice in the high bits, angle quantized to 20 bits
    valid = mask & far_enough
    aq = torch.clamp(
        ((angle_about_centroid + math.pi) * ((1 << 20) / (2.0 * math.pi))).to(torch.int32),
        0, (1 << 20) - 1,
    )
    key = torch.where(valid, (seg << 20) | aq, (_NUM_SLICES + 1) << 20)
    skey, order = torch.sort(key, stable=True)
    sseg = skey >> 20
    svalid = sseg < _NUM_SLICES
    sp = points[order, :2]
    sc = centroid[order]

    delta = sp[1:] - sp[:-1]
    direction = sp[1:] - sc[1:]
    dist = torch.sqrt(torch.sum(delta * delta, dim=-1))
    dirn = torch.sqrt(torch.sum(direction * direction, dim=-1))
    same_slice = (sseg[1:] == sseg[:-1]) & svalid[1:] & svalid[:-1]
    keep = same_slice & (dist >= MIN_DISTANCE) & (dist <= MAX_DISTANCE)
    angle = torch.atan2(delta[:, 1], delta[:, 0])
    ortho = 1.0 - torch.abs(
        torch.sum(delta * direction, dim=-1) / torch.clamp(dist * dirn, min=1e-12))
    value = torch.clamp(ortho, min=0.0)

    a = torch.remainder(angle, math.pi)
    bucket = torch.clamp(
        torch.round(num_buckets * (a / math.pi) - 0.5).to(torch.int32), 0, num_buckets - 1)
    bucket = torch.where(keep, bucket, num_buckets)
    hist = torch.zeros(num_buckets + 1, dtype=torch.float32, device=dev)
    hist.index_add_(0, bucket.long(), torch.where(keep, value, 0.0))
    return hist[:num_buckets]
