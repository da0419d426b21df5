"""Per-LiDAR-model point decoders (SensorBridge analog, R2).

Counterpart of the reference's per-model point readers
(cartographer_ros/sensor_bridge.cc:183-236): each LiDAR family stamps
per-point acquisition times in a different field/unit; all are rebased to
the D-LIOM convention "last point = 0, times <= 0, scan stamp = last-point
time". Inputs are numpy structured arrays (what a PointCloud2 deserializes
to) or plain (N, >=3) float arrays.

  ouster:    field `t` in nanoseconds from scan start (sensor_bridge.cc:183)
  velodyne:  field `time` in seconds, stamp at FIRST point (:195, rebased)
  robosense: field `timestamp` in absolute seconds, stamp at last (:209)
  fallback:  XYZ(I), zero per-point times (:226)

Non-finite points are dropped (masked), as in the reference's isnan/isinf
filter. A copy of dliom_tpu/io/pointcloud_formats.py (numpy only).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _xyz(arr: np.ndarray) -> np.ndarray:
    if arr.dtype.names:
        return np.stack(
            [arr["x"], arr["y"], arr["z"]], axis=-1
        ).astype(np.float32)
    return np.asarray(arr, np.float32)[:, :3]


def _finite_mask(xyz: np.ndarray) -> np.ndarray:
    return np.isfinite(xyz).all(axis=-1)


def decode_points(
    arr: np.ndarray,
    sensor_type: str = "generic",
    header_stamp: float = 0.0,
) -> Tuple[float, np.ndarray, np.ndarray]:
    """Decode one scan. Returns (scan_stamp, points (M, 3), rel_times (M,))
    with rel_times <= 0 and scan_stamp = acquisition time of the LAST point
    (the deskew convention, sensor_bridge.cc:186-235)."""
    xyz = _xyz(arr)
    ok = _finite_mask(xyz)
    names = arr.dtype.names or ()

    if len(xyz) == 0:
        # empty scans (occlusion / startup / all-NaN frames) must decode to
        # an empty cloud, not crash on t[-1]
        return float(header_stamp), xyz, np.zeros(0, np.float32)

    if sensor_type == "ouster":
        t = arr["t"].astype(np.float64) * 1e-9
        rel_last = float(t[-1])
        rel = (t - rel_last).astype(np.float32)
        stamp = header_stamp + rel_last
    elif sensor_type == "velodyne":
        t = arr["time"].astype(np.float64)
        rel_last = float(t[-1])
        rel = (t - rel_last).astype(np.float32)
        # velodyne stamps the FIRST point (:199-201)
        stamp = header_stamp + rel_last
    elif sensor_type == "robosense":
        t = arr["timestamp"].astype(np.float64)  # absolute seconds
        rel_last = float(t[-1])
        rel = (t - rel_last).astype(np.float32)
        # robosense stamps the LAST point already (:225-227)
        stamp = header_stamp
    else:
        rel = np.zeros(len(xyz), np.float32)
        stamp = header_stamp

    return float(stamp), xyz[ok], rel[ok]
