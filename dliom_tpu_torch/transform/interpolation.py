"""Time-indexed pose interpolation buffer.

Host-side counterpart (a copy of dliom_tpu/transform/interpolation.py) of
the reference's `cartographer/transform/transform_interpolation_buffer.{h,cc}`: a sorted
(time, pose) buffer supporting lookup of an interpolated pose at any covered
time. Used by trajectory export and evaluation tooling; implemented on numpy
(this is bookkeeping, not device compute).
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

import numpy as np

from dliom_tpu_torch.transform.rigid import Rigid3, np_quat_slerp


class TransformInterpolationBuffer:
    def __init__(self, buffer_size_limit: Optional[int] = None):
        self._times: List[float] = []
        self._rotations: List[np.ndarray] = []
        self._translations: List[np.ndarray] = []
        self._limit = buffer_size_limit

    def push(self, time: float, pose: Rigid3) -> None:
        if self._times and time <= self._times[-1]:
            # Replace or ignore out-of-order pushes (reference CHECKs order;
            # we tolerate equal timestamps by replacing).
            if time == self._times[-1]:
                self._rotations[-1] = np.asarray(pose.rotation, np.float64)
                self._translations[-1] = np.asarray(pose.translation, np.float64)
                return
            raise ValueError("pushed time is before the latest buffered time")
        self._times.append(float(time))
        self._rotations.append(np.asarray(pose.rotation, np.float64))
        self._translations.append(np.asarray(pose.translation, np.float64))
        if self._limit is not None:
            while len(self._times) > self._limit:
                self._times.pop(0)
                self._rotations.pop(0)
                self._translations.pop(0)

    def __len__(self) -> int:
        return len(self._times)

    @property
    def earliest_time(self) -> float:
        return self._times[0]

    @property
    def latest_time(self) -> float:
        return self._times[-1]

    def has(self, time: float) -> bool:
        return bool(self._times) and self.earliest_time <= time <= self.latest_time

    def trim_before(self, time: float) -> None:
        """Drop samples no lookup at >= `time` can need (keeps one sample at
        or before `time` for bracketing)."""
        while len(self._times) > 1 and self._times[1] <= time:
            self._times.pop(0)
            self._rotations.pop(0)
            self._translations.pop(0)

    def lookup(self, time: float) -> Rigid3:
        """Interpolated pose at `time` — numpy-backed (host bookkeeping path;
        zero device dispatch: this runs per-node during ingest/eval)."""
        if not self.has(time):
            raise KeyError(f"time {time} not covered by buffer")
        i = bisect.bisect_left(self._times, time)
        if self._times[i] == time:
            return Rigid3(self._rotations[i], self._translations[i])
        t0, t1 = self._times[i - 1], self._times[i]
        s = (time - t0) / (t1 - t0)
        q = np_quat_slerp(self._rotations[i - 1], self._rotations[i], s)
        p = (1.0 - s) * self._translations[i - 1] + s * self._translations[i]
        return Rigid3(q, p)

    def items(self) -> List[Tuple[float, Rigid3]]:
        return [
            (t, Rigid3(r, p))
            for t, r, p in zip(self._times, self._rotations, self._translations)
        ]
