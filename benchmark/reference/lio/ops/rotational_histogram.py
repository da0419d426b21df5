"""Rotational scan-matcher histogram (port of
dliom_tpu/ops/rotational_histogram.py::compute_histogram; reference
mapping/internal/3d/scan_matching/rotational_scan_matcher.cc).

Points are cut into 0.2 m z-slices and sorted by angle about their slice's
xy centroid; each consecutive pair within a slice adds the orthogonality
of its xy delta to the centroid ray into the bucket of the delta's angle.
The slice and bucket sums are `ops/segment.py::segment_sum`, a sorted
segment reduction: it adds in a fixed order, so a node's histogram has the
same bits on every run on the card (the JAX package's one-hot matmuls are
deterministic too; `index_add_` on the card is not). B lanes' clouds go
through in one pass, each lane's slices and buckets segments of their own.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.lio.ops.segment import segment_sum

MIN_DISTANCE = 0.2
MAX_DISTANCE = 0.9
SLICE_HEIGHT = 0.2
_NUM_SLICES = 1024  # z in [-102.4, 102.4) m


def compute_histogram(points: torch.Tensor, mask: torch.Tensor, num_buckets: int = 120) -> torch.Tensor:
    """Histogram of a gravity-aligned cloud (N, 3): (num_buckets,) float32;
    of B lanes' clouds (B, N, 3): (B, num_buckets)."""
    batched = points.dim() == 3
    if not batched:
        points, mask = points[None], mask[None]
    b, n = mask.shape
    dev = points.device
    lane = torch.arange(b, device=dev)[:, None]
    z_slice = torch.round(points[..., 2] / SLICE_HEIGHT).to(torch.int32)
    slice_id = torch.clamp(z_slice + _NUM_SLICES // 2, 0, _NUM_SLICES - 1)
    seg = torch.where(mask, slice_id, _NUM_SLICES)  # sentinel row for invalid points

    ones = mask.to(torch.float32)
    rows = _NUM_SLICES + 1
    sums = segment_sum(torch.cat([points[..., :2] * ones[..., None], ones[..., None]], dim=-1).reshape(b * n, 3),
                       (seg + lane * rows).reshape(-1), b * rows).reshape(b, rows, 3)
    centroids = sums[..., :2] / torch.clamp(sums[..., 2], min=1.0)[..., None]
    centroid = torch.where(mask[..., None], _rows(centroids, seg), 0.0)

    offs = points[..., :2] - centroid
    far_enough = torch.sqrt(torch.sum(offs * offs, dim=-1)) >= MIN_DISTANCE
    angle_about_centroid = torch.atan2(offs[..., 1], offs[..., 0])

    # one int32 key: slice in the high bits, angle quantized to 20 bits;
    # one sort of every lane's row
    valid = mask & far_enough
    aq = torch.clamp(
        ((angle_about_centroid + math.pi) * ((1 << 20) / (2.0 * math.pi))).to(torch.int32),
        0, (1 << 20) - 1,
    )
    key = torch.where(valid, (seg << 20) | aq, (_NUM_SLICES + 1) << 20)
    skey, order = torch.sort(key, dim=-1, stable=True)
    sseg = skey >> 20
    svalid = sseg < _NUM_SLICES
    sp = _rows(points[..., :2], order)
    sc = _rows(centroid, order)

    delta = sp[:, 1:] - sp[:, :-1]
    direction = sp[:, 1:] - sc[:, 1:]
    dist = torch.sqrt(torch.sum(delta * delta, dim=-1))
    dirn = torch.sqrt(torch.sum(direction * direction, dim=-1))
    same_slice = (sseg[:, 1:] == sseg[:, :-1]) & svalid[:, 1:] & svalid[:, :-1]
    keep = same_slice & (dist >= MIN_DISTANCE) & (dist <= MAX_DISTANCE)
    angle = torch.atan2(delta[..., 1], delta[..., 0])
    ortho = 1.0 - torch.abs(
        torch.sum(delta * direction, dim=-1) / torch.clamp(dist * dirn, min=1e-12))
    value = torch.clamp(ortho, min=0.0)

    a = torch.remainder(angle, math.pi)
    bucket = torch.clamp(
        torch.round(num_buckets * (a / math.pi) - 0.5).to(torch.int32), 0, num_buckets - 1)
    bucket = torch.where(keep, bucket, num_buckets)
    hist = segment_sum(torch.where(keep, value, 0.0).reshape(-1),
                       (bucket + lane * (num_buckets + 1)).reshape(-1), b * (num_buckets + 1))
    hist = hist.reshape(b, num_buckets + 1)[:, :num_buckets]
    return hist if batched else hist[0]


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b, i]] for x (B, K, C) and idx (B, N)."""
    return torch.gather(x, 1, idx.long()[..., None].expand(idx.shape + x.shape[2:]))


def rotate_histogram(histogram: torch.Tensor, angle) -> torch.Tensor:
    """Rotate by `angle` (scalar or (A,) batch) with linear interpolation of
    fractional buckets (RotateHistogram, rotational_scan_matcher.cc:118-140);
    returns (n,) or (A, n)."""
    n = histogram.shape[-1]
    angle = torch.as_tensor(angle, dtype=torch.float32, device=histogram.device)
    rotate_by = -angle * n / math.pi
    full = torch.round(rotate_by - 0.5).to(torch.int64)
    frac = (rotate_by - full)[..., None]
    idx = torch.arange(n, device=histogram.device)
    src0 = torch.remainder(idx + full[..., None], n)
    src1 = torch.remainder(idx + full[..., None] + 1, n)
    return (1.0 - frac) * histogram[src0] + frac * histogram[src1]


def match_histograms(histogram: torch.Tensor, reference: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Cosine similarity of `histogram` rotated by each angle vs `reference`
    (RotationalScanMatcher::Match); (A,) scores, 1 for an empty histogram."""
    rotated = rotate_histogram(histogram, angles)  # (A, n)
    denom = torch.sqrt(torch.sum(rotated * rotated, dim=-1)) * torch.sqrt(torch.sum(reference * reference))
    s = torch.sum(rotated * reference, dim=-1) / torch.clamp(denom, min=1e-12)
    return torch.where(denom < 1e-12, 1.0, s)


def np_rotate_histogram(histogram, angle: float):
    """Host numpy mirror of rotate_histogram for node-rate pose-graph
    bookkeeping."""
    histogram = np.asarray(histogram)
    n = histogram.shape[0]
    rotate_by = -float(angle) * n / np.pi
    full = int(np.round(rotate_by - 0.5))
    frac = rotate_by - full
    idx = np.arange(n)
    return (1.0 - frac) * histogram[np.mod(idx + full, n)] + frac * histogram[np.mod(idx + full + 1, n)]
