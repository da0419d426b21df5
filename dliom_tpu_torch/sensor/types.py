"""Sensor data types (port of dliom_tpu/sensor/types.py): fixed-capacity
batches with an explicit validity mask. `pad_point_cloud` is host-side
numpy; the others hold tensors.

Per-point relative times follow the reference convention (sensor_bridge.cc:
last point = 0, earlier points negative, relative to the scan-end stamp).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class ImuData(NamedTuple):
    """A batch of IMU samples (time-ascending): time (N,),
    linear_acceleration / angular_velocity (N, 3)."""

    time: torch.Tensor
    linear_acceleration: torch.Tensor
    angular_velocity: torch.Tensor


class OdometryData(NamedTuple):
    time: torch.Tensor
    rotation: torch.Tensor  # (N, 4) wxyz
    translation: torch.Tensor  # (N, 3)


class RangeData(NamedTuple):
    """Deskewed range data in some frame: sensor origin (3,), hit points
    (N, 3) with mask (N,), and the misses cloud with its own mask."""

    origin: torch.Tensor
    returns: torch.Tensor
    returns_mask: torch.Tensor
    misses: torch.Tensor
    misses_mask: torch.Tensor

    @staticmethod
    def empty(capacity: int, miss_capacity: int | None = None, device=None) -> "RangeData":
        miss_capacity = capacity if miss_capacity is None else miss_capacity
        f32 = dict(dtype=torch.float32, device=device)
        return RangeData(
            origin=torch.zeros(3, **f32),
            returns=torch.zeros(capacity, 3, **f32),
            returns_mask=torch.zeros(capacity, dtype=torch.bool, device=device),
            misses=torch.zeros(miss_capacity, 3, **f32),
            misses_mask=torch.zeros(miss_capacity, dtype=torch.bool, device=device),
        )


class TimedPointCloud(NamedTuple):
    """Padded cloud: points (N, 3), times (N,), mask (N,)."""

    points: np.ndarray
    times: np.ndarray
    mask: np.ndarray

    @property
    def capacity(self) -> int:
        return self.points.shape[-2]

    def num_valid(self):
        """int32 count of valid points per cloud, numpy or a tensor as the
        mask is."""
        if isinstance(self.mask, torch.Tensor):
            return torch.sum(self.mask, dim=-1, dtype=torch.int32)
        return np.sum(self.mask, axis=-1, dtype=np.int32)


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
