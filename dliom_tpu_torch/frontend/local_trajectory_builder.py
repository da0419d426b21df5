"""The per-scan frontend step (port of
dliom_tpu/frontend/local_trajectory_builder.py::step; reference
LocalTrajectoryBuilder3D, local_trajectory_builder_3d.cc):

  voxel filter (half size)   AddRangeData:393
  -> per-point deskew        :408-446
  -> min/max-range clipping  :454-473
  -> voxel filter (full)     :477-482
  -> adaptive filters        AddAccumulatedRangeData:506-534
  -> [correlative pre-search] :514-520 with use_online_correlative_scan_matching
  -> scan-to-submap LM match :535 (the front submap's two grids)
  -> [window optimize]       :555 via `fuse_fn`
  -> motion-filtered insert  InsertIntoSubmap:584-622
  -> rotational histogram    :605

The submap banks are updated in place; the returned FrontendState shares
them with the one passed in. The stages run under `record_function` spans
(frontend.filter, .correlative, .match, .insert, .histogram) that
torch.profiler reads.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.profiler import record_function

from dliom_tpu_torch.common.config import TrajectoryBuilderConfig
from dliom_tpu_torch.imu.window_optimizer import tree_where
from dliom_tpu_torch.mapping import motion_filter as mf
from dliom_tpu_torch.mapping.submap import (
    ActiveSubmaps,
    apply_pending_spawn,
    brick_spec,
    brick_spec_low,
    grid_specs,
    insert_range_data_into_submaps,
    make_active_submaps,
    matching_slot,
    slot_pose,
)
from dliom_tpu_torch.ops import real_time_correlative
from dliom_tpu_torch.ops.rotational_histogram import compute_histogram
from dliom_tpu_torch.ops.scan_matcher import match
from dliom_tpu_torch.ops.voxel_filter import adaptive_voxel_filter, voxel_filter, voxel_filter_mask
from dliom_tpu_torch.transform.rigid import Rigid3, _norm, quat_slerp


class FrontendState(NamedTuple):
    submaps: ActiveSubmaps
    pose: Rigid3  # latest optimized pose
    motion_filter: mf.MotionFilterState
    scan_index: torch.Tensor  # () int32


class ScanInput(NamedTuple):
    time: torch.Tensor  # () f32 scan-end stamp
    points: torch.Tensor  # (N, 3) tracking frame
    times: torch.Tensor  # (N,) per-point relative times (<= 0)
    mask: torch.Tensor  # (N,)
    relative_prediction: Rigid3


class ScanResult(NamedTuple):
    time: torch.Tensor
    local_pose: Rigid3
    inserted: torch.Tensor
    finished_submap: torch.Tensor
    matcher_cost: torch.Tensor
    matcher_iterations: torch.Tensor
    num_hits: torch.Tensor
    histogram: torch.Tensor
    high_points: torch.Tensor
    high_mask: torch.Tensor
    low_points: torch.Tensor
    low_mask: torch.Tensor
    insertion_submap_ids: torch.Tensor  # (2,)
    gravity_alignment: torch.Tensor  # (4,)
    insertion_batch: object = None


def make_initial_state(cfg: TrajectoryBuilderConfig, device=None) -> FrontendState:
    return FrontendState(
        submaps=make_active_submaps(cfg.submaps, device),
        pose=Rigid3.identity(device=device),
        motion_filter=mf.MotionFilterState.initial(device),
        scan_index=torch.zeros((), dtype=torch.int32, device=device),
    )


def step(state: FrontendState, scan: ScanInput, cfg: TrajectoryBuilderConfig, fuse_fn=None):
    """One frontend scan. Without `fuse_fn` the matched pose is the output;
    with `fuse_fn(pose_estimate) -> (opt_pose, aux)` the tightly-coupled
    stage runs between matching and insertion and `(result, aux)` is
    returned."""
    state = state._replace(submaps=apply_pending_spawn(state.submaps, cfg.submaps))
    prev_pose = state.pose
    prediction = prev_pose.compose(scan.relative_prediction)
    dev = scan.points.device
    n = scan.points.shape[0]

    with record_function("frontend.filter"):
        # 1. half-size voxel filter, as a keep-mask
        half_keep = voxel_filter_mask(scan.points, scan.mask, 0.5 * cfg.voxel_filter_size)

        # 2. deskew: per-hit pose = prev_pose * slerp(s, relative_prediction)
        s = torch.clamp((cfg.scan_period + scan.times) / cfg.scan_period, 0.0, 1.0)
        rel = scan.relative_prediction
        ident = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float32, device=dev).expand(n, 4)
        hit_poses = Rigid3(quat_slerp(ident, rel.rotation.expand(n, 4), s), s[:, None] * rel.translation)
        hits_local = prev_pose.apply(hit_poses.apply(scan.points))
        origins_local = prev_pose.apply(hit_poses.apply(torch.zeros_like(scan.points)))

        # 3. range clipping
        rng = _norm(hits_local - origins_local)
        in_range = half_keep & (rng >= cfg.min_range) & (rng <= cfg.max_range)

        # 4. full-size voxel filter in the local frame
        filtered = voxel_filter(hits_local, scan.times, in_range, cfg.voxel_filter_size,
                                out_capacity=cfg.max_filtered_points)

        # 5. tracking frame; adaptive filters
        filtered_tracking = prediction.inverse().apply(filtered.points)
        hr = cfg.high_resolution_adaptive_voxel_filter
        lr = cfg.low_resolution_adaptive_voxel_filter
        high = adaptive_voxel_filter(
            filtered_tracking, filtered.times, filtered.mask, max_length=hr.max_length,
            min_num_points=hr.min_num_points, max_range=hr.max_range,
            out_capacity=cfg.max_high_res_points)
        low = adaptive_voxel_filter(
            filtered_tracking, filtered.times, filtered.mask, max_length=lr.max_length,
            min_num_points=lr.min_num_points, max_range=lr.max_range,
            out_capacity=cfg.max_low_res_points)

    # 6. match against the front submap's two grids (brick or dense each)
    sm_cfg = cfg.submaps
    hi_spec, lo_spec = grid_specs(sm_cfg)
    mslot = matching_slot(state.submaps)
    submap_pose = slot_pose(state.submaps, mslot)
    csm = cfg.ceres_scan_matcher
    bank_slot = 2 * state.submaps.lane + mslot
    initial_in_submap = submap_pose.inverse().compose(prediction)
    if cfg.use_online_correlative_scan_matching:
        # exhaustive local pre-search seeding the LM matcher (:514-520)
        rtc = cfg.real_time_correlative_scan_matcher
        with record_function("frontend.correlative"):
            initial_in_submap = real_time_correlative.match(
                initial_in_submap, high.points, high.mask,
                state.submaps.high_brick if sm_cfg.use_brick_grid else state.submaps.high_values,
                brick_spec(sm_cfg) if sm_cfg.use_brick_grid else hi_spec,
                linear_search_window=rtc.linear_search_window,
                angular_search_window=rtc.angular_search_window,
                translation_delta_cost_weight=rtc.translation_delta_cost_weight,
                rotation_delta_cost_weight=rtc.rotation_delta_cost_weight,
                max_scan_range=cfg.max_range,
                max_angular_steps=rtc.max_angular_steps,
                base=bank_slot if sm_cfg.use_brick_grid else bank_slot * hi_spec.num_cells,
            ).pose
    with record_function("frontend.match"):
        result = match(
            initial_in_submap,
            clouds=[(high.points, high.mask), (low.points, low.mask)],
            grids=[state.submaps.high_brick if sm_cfg.use_brick_grid else state.submaps.high_values,
                   state.submaps.low_brick if sm_cfg.use_brick_grid_low else state.submaps.low_values],
            grid_bases=[bank_slot if sm_cfg.use_brick_grid else bank_slot * hi_spec.num_cells,
                        bank_slot if sm_cfg.use_brick_grid_low else bank_slot * lo_spec.num_cells],
            specs=[brick_spec(sm_cfg) if sm_cfg.use_brick_grid else hi_spec,
                   brick_spec_low(sm_cfg) if sm_cfg.use_brick_grid_low else lo_spec],
            occupied_space_weights=[csm.occupied_space_weight_0, csm.occupied_space_weight_1],
            translation_weight=csm.translation_weight,
            rotation_weight=csm.rotation_weight,
            only_optimize_yaw=csm.only_optimize_yaw,
            max_iterations=csm.max_num_iterations,
            function_tolerance=csm.function_tolerance,
        )
    pose_estimate = submap_pose.compose(result.pose)

    # 7. fusion stage
    if fuse_fn is None:
        opt_pose, fuse_aux = pose_estimate, None
    else:
        opt_pose, fuse_aux = fuse_fn(pose_estimate)
    gravity_alignment = opt_pose.rotation
    filtered_in_opt = opt_pose.apply(prediction.inverse().apply(filtered.points))

    with record_function("frontend.insert"):
        # 8. motion filter gate + insertion; an empty scan leaves the filter alone
        has_points = torch.sum(filtered.mask) > 0
        mfc = cfg.motion_filter
        similar, mf_candidate = mf.is_similar(
            state.motion_filter, scan.time, opt_pose, max_time_seconds=mfc.max_time_seconds,
            max_distance_meters=mfc.max_distance_meters, max_angle_radians=mfc.max_angle_radians)
        new_mf = mf.MotionFilterState(
            last_time=torch.where(has_points, mf_candidate.last_time, state.motion_filter.last_time),
            last_pose=tree_where(has_points, mf_candidate.last_pose, state.motion_filter.last_pose),
            num_total=torch.where(has_points, mf_candidate.num_total, state.motion_filter.num_total),
            num_different=torch.where(has_points, mf_candidate.num_different,
                                      state.motion_filter.num_different),
        )
        insert = (~similar) & has_points
        new_submaps, finished = insert_range_data_into_submaps(
            state.submaps, opt_pose.translation, filtered_in_opt, filtered.mask,
            gravity_alignment, cfg.submaps, insert)

    # 9. rotational histogram of the gravity-aligned scan
    with record_function("frontend.histogram"):
        hist = compute_histogram(
            Rigid3.rotation_only(gravity_alignment).apply(prediction.inverse().apply(filtered.points)),
            filtered.mask, num_buckets=cfg.rotational_histogram_size)

    new_state = FrontendState(submaps=new_submaps, pose=opt_pose, motion_filter=new_mf,
                              scan_index=state.scan_index + 1)
    nc = new_submaps.num_created
    insertion_ids = torch.stack([torch.where(nc >= 2, nc - 2, -1), nc - 1]).to(torch.int32)
    out = ScanResult(
        time=scan.time,
        local_pose=opt_pose,
        inserted=insert,
        finished_submap=finished,
        matcher_cost=result.cost,
        matcher_iterations=result.iterations,
        num_hits=torch.sum(filtered.mask, dtype=torch.int32),
        histogram=hist,
        high_points=high.points,
        high_mask=high.mask,
        low_points=low.points,
        low_mask=low.mask,
        insertion_submap_ids=insertion_ids,
        gravity_alignment=gravity_alignment,
    )
    if fuse_fn is None:
        return new_state, out
    return new_state, (out, fuse_aux)
