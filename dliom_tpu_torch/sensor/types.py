"""Fixed-capacity point clouds (numpy copy of the part of
dliom_tpu/sensor/types.py that drives the LIO step, with no jax).

Per-point relative times follow the reference convention (sensor_bridge.cc:
last point = 0, earlier points negative, relative to the scan-end stamp).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class TimedPointCloud(NamedTuple):
    """Padded cloud: points (N, 3), times (N,), mask (N,)."""

    points: np.ndarray
    times: np.ndarray
    mask: np.ndarray


def pad_point_cloud(points: np.ndarray, times: np.ndarray | None, capacity: int) -> TimedPointCloud:
    """Pad/truncate a variable-size cloud to `capacity`; truncation keeps a
    uniform subsample rather than a prefix."""
    points = np.asarray(points, np.float32).reshape(-1, 3)
    n = points.shape[0]
    if times is None:
        times = np.zeros(n, np.float32)
    times = np.asarray(times, np.float32).reshape(-1)
    if n > capacity:
        idx = np.linspace(0, n - 1, capacity).round().astype(np.int64)
        points, times = points[idx], times[idx]
        n = capacity
    out_p = np.zeros((capacity, 3), np.float32)
    out_t = np.zeros(capacity, np.float32)
    out_m = np.zeros(capacity, bool)
    out_p[:n] = points
    out_t[:n] = times
    out_m[:n] = True
    return TimedPointCloud(out_p, out_t, out_m)
