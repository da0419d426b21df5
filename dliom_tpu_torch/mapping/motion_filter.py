"""Motion filter: skip submap insertion when the pose barely moved (port of
dliom_tpu/mapping/motion_filter.py; reference mapping/internal/motion_filter.cc)."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from dliom_tpu_torch.transform.rigid import Rigid3, _norm, quat_angle, quat_conjugate, quat_multiply


class MotionFilterState(NamedTuple):
    last_time: torch.Tensor  # () f32 seconds; -inf initially
    last_pose: Rigid3
    num_total: torch.Tensor  # () int32
    num_different: torch.Tensor  # () int32

    @staticmethod
    def initial(device=None) -> "MotionFilterState":
        return MotionFilterState(
            last_time=torch.tensor(float("-inf"), dtype=torch.float32, device=device),
            last_pose=Rigid3.identity(device=device),
            num_total=torch.zeros((), dtype=torch.int32, device=device),
            num_different=torch.zeros((), dtype=torch.int32, device=device),
        )


def is_similar(state: MotionFilterState, time: torch.Tensor, pose: Rigid3, *,
               max_time_seconds: float, max_distance_meters: float,
               max_angle_radians: float) -> Tuple[torch.Tensor, MotionFilterState]:
    """(similar, new_state); a similar scan is skipped (IsSimilar)."""
    dt = time - state.last_time
    dd = _norm(pose.translation - state.last_pose.translation)
    da = quat_angle(quat_multiply(quat_conjugate(state.last_pose.rotation), pose.rotation))
    keep = (
        (state.num_total == 0)
        | (dt > max_time_seconds)
        | (dd > max_distance_meters)
        | (da > max_angle_radians)
    )
    new_state = MotionFilterState(
        last_time=torch.where(keep, time, state.last_time),
        last_pose=Rigid3(
            rotation=torch.where(keep, pose.rotation, state.last_pose.rotation),
            translation=torch.where(keep, pose.translation, state.last_pose.translation),
        ),
        num_total=state.num_total + 1,
        num_different=state.num_different + keep.to(torch.int32),
    )
    return ~keep, new_state
