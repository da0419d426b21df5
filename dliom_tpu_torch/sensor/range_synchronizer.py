"""Multi-LiDAR range-data synchronizer.

Counterpart of the reference's `RangeDataSynchronizer`
(`cartographer/mapping/internal/3d/range_data_synchronizer.{h,cc}`):

  * the FIRST sensor id is the primary (range_data_synchronizer.h:35);
  * secondary clouds buffer until the primary scan arrives (:29-117);
  * secondary points whose absolute stamps fall inside the primary scan's
    [start, end] window are merged, with per-point times rebased so the
    primary scan's last point is 0 (:119-178);
  * the merged cloud is sorted by per-point time (:180-199);
  * `stamp_range_data`: synthesize per-point times over the scan period when
    the driver provides none (eable_mannually_discrew, :119).

Host-side numpy (sensor ingest path); a copy of
dliom_tpu/sensor/range_synchronizer.py, which imports no jax."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class RangeDataSynchronizer:
    def __init__(self, sensor_ids: Sequence[str], scan_period: float = 0.1):
        if not sensor_ids:
            raise ValueError("need at least one range sensor id")
        self._ids = list(sensor_ids)
        self._primary = self._ids[0]
        self._scan_period = scan_period
        self._buffer: Dict[str, List[Tuple[float, np.ndarray, np.ndarray]]] = {
            s: [] for s in self._ids[1:]
        }
        self._last_end: Optional[float] = None

    @property
    def primary(self) -> str:
        return self._primary

    @property
    def sensor_ids(self) -> List[str]:
        return list(self._ids)

    def stamp_range_data(
        self, points: np.ndarray, times: Optional[np.ndarray]
    ) -> np.ndarray:
        """Synthesize per-point relative times (StampRangeData): spread the
        points uniformly over [-scan_period, 0] in acquisition order."""
        n = len(points)
        if times is not None and np.any(np.asarray(times) != 0.0):
            return np.asarray(times, np.float32)
        return np.linspace(-self._scan_period, 0.0, n).astype(np.float32)

    def add_range_data(
        self,
        sensor_id: str,
        stamp: float,
        points: np.ndarray,
        times: Optional[np.ndarray] = None,
        synthesize_times: bool = False,
    ) -> Optional[Tuple[float, np.ndarray, np.ndarray]]:
        """Returns (stamp, merged_points, merged_times) when `sensor_id` is
        the primary; buffers and returns None for secondaries."""
        points = np.asarray(points, np.float32).reshape(-1, 3)
        if times is None:
            times = np.zeros(len(points), np.float32)
        times = np.asarray(times, np.float32).reshape(-1)
        if synthesize_times:
            times = self.stamp_range_data(points, times)

        if sensor_id != self._primary:
            if sensor_id not in self._buffer:
                raise KeyError(f"unknown range sensor '{sensor_id}'")
            self._buffer[sensor_id].append((stamp, points, times))
            # bound the buffer (reference keeps one pending cloud per sensor)
            if len(self._buffer[sensor_id]) > 4:
                self._buffer[sensor_id].pop(0)
            return None

        # primary scan window in absolute time
        end = stamp
        start = stamp + float(times.min()) if len(times) else stamp
        merged_p = [points]
        merged_t = [times]
        for sid, bufs in self._buffer.items():
            keep: List[Tuple[float, np.ndarray, np.ndarray]] = []
            for (s_stamp, s_pts, s_times) in bufs:
                abs_t = s_stamp + s_times
                sel = (abs_t >= start) & (abs_t <= end)
                if self._last_end is not None:
                    # a partially-consumed cloud stays buffered for the next
                    # window; exclude what the previous window already took
                    # (consecutive windows share their boundary instant)
                    sel &= abs_t > self._last_end
                if np.any(sel):
                    merged_p.append(s_pts[sel])
                    merged_t.append((abs_t[sel] - end).astype(np.float32))
                # drop clouds fully before the window; keep future ones
                if s_stamp + (s_times.max() if len(s_times) else 0.0) > end:
                    keep.append((s_stamp, s_pts, s_times))
            self._buffer[sid] = keep

        pts = np.concatenate(merged_p)
        tms = np.concatenate(merged_t)
        order = np.argsort(tms, kind="stable")
        self._last_end = end
        return end, pts[order], tms[order]
