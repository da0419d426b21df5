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
them with the one passed in. The stages are functions of their own
(`filter_scan`, `match_target`, `match_scan`, `insert_scan`,
`histogram_points`, `finish_step`) that the batched run
(parallel/batch.py) drives over B lanes. The stages run under `record_function` spans
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
    mark_insertion,
    matching_slot,
    prepare_insertion,
    slot_pose,
)
from dliom_tpu_torch.ops import real_time_correlative
from dliom_tpu_torch.ops.rotational_histogram import compute_histogram
from dliom_tpu_torch.ops.scan_matcher import match
from dliom_tpu_torch.ops.voxel_filter import FilteredCloud, adaptive_voxel_filter, voxel_filter, voxel_filter_mask
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
    insertion_batch: object = None  # InsertionBatch of a batched step (parallel/batch.py)


def make_initial_state(cfg: TrajectoryBuilderConfig, device=None) -> FrontendState:
    return FrontendState(
        submaps=make_active_submaps(cfg.submaps, device),
        pose=Rigid3.identity(device=device),
        motion_filter=mf.MotionFilterState.initial(device),
        scan_index=torch.zeros((), dtype=torch.int32, device=device),
    )


class ScanClouds(NamedTuple):
    """The filter stage's output: the predicted pose and the filtered clouds."""

    prediction: Rigid3
    filtered: FilteredCloud  # local frame
    high: FilteredCloud  # tracking frame
    low: FilteredCloud


def step(state: FrontendState, scan: ScanInput, cfg: TrajectoryBuilderConfig, fuse_fn=None):
    """One frontend scan. Without `fuse_fn` the matched pose is the output;
    with `fuse_fn(pose_estimate) -> (opt_pose, aux)` the tightly-coupled
    stage runs between matching and insertion and `(result, aux)` is
    returned."""
    state = state._replace(submaps=apply_pending_spawn(state.submaps, cfg.submaps))
    with record_function("frontend.filter"):
        clouds = filter_scan(state.pose, scan, cfg)
    submap_pose, bank_slot, initial_in_submap = match_target(state.submaps, clouds.prediction)
    sm_cfg = cfg.submaps
    if cfg.use_online_correlative_scan_matching:
        # exhaustive local pre-search seeding the LM matcher (:514-520)
        rtc = cfg.real_time_correlative_scan_matcher
        hi_spec = grid_specs(sm_cfg)[0]
        with record_function("frontend.correlative"):
            initial_in_submap = real_time_correlative.match(
                initial_in_submap, clouds.high.points, clouds.high.mask,
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
        result = match_scan(state.submaps, clouds, bank_slot, initial_in_submap, cfg)
    pose_estimate = submap_pose.compose(result.pose)

    # 7. fusion stage
    if fuse_fn is None:
        opt_pose, fuse_aux = pose_estimate, None
    else:
        opt_pose, fuse_aux = fuse_fn(pose_estimate)

    with record_function("frontend.insert"):
        new_submaps, new_mf, insert, finished, batch = insert_scan(state, scan.time, clouds, opt_pose, cfg)

    with record_function("frontend.histogram"):
        hist = compute_histogram(histogram_points(clouds, opt_pose), clouds.filtered.mask,
                                 num_buckets=cfg.rotational_histogram_size)
    new_state, out = finish_step(state, scan, clouds, opt_pose, result, new_submaps, new_mf, insert,
                                 finished, hist, batch)
    if fuse_fn is None:
        return new_state, out
    return new_state, (out, fuse_aux)


def filter_scan(prev_pose: Rigid3, scan: ScanInput, cfg: TrajectoryBuilderConfig) -> ScanClouds:
    """Steps 1-5: the prediction, deskew, range clip and voxel filters."""
    prediction = prev_pose.compose(scan.relative_prediction)
    dev = scan.points.device
    n = scan.points.shape[0]

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
    return ScanClouds(prediction, filtered, high, low)


def match_target(submaps: ActiveSubmaps, prediction: Rigid3):
    """(pose, bank slot, prediction in its frame) of the front submap, the
    matching target."""
    mslot = matching_slot(submaps)
    submap_pose = slot_pose(submaps, mslot)
    return submap_pose, 2 * submaps.lane + mslot, submap_pose.inverse().compose(prediction)


def match_scan(submaps: ActiveSubmaps, clouds: ScanClouds, bank_slot, initial_in_submap: Rigid3,
               cfg: TrajectoryBuilderConfig):
    """Step 6: the LM match of the high and low clouds against the bank
    slot's two grids (brick or dense each). For B lanes every argument but
    the shared banks carries the lane axis."""
    sm_cfg = cfg.submaps
    hi_spec, lo_spec = grid_specs(sm_cfg)
    csm = cfg.ceres_scan_matcher
    return match(
        initial_in_submap,
        clouds=[(clouds.high.points, clouds.high.mask), (clouds.low.points, clouds.low.mask)],
        grids=[submaps.high_brick if sm_cfg.use_brick_grid else submaps.high_values,
               submaps.low_brick if sm_cfg.use_brick_grid_low else submaps.low_values],
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


def insert_scan(state: FrontendState, time: torch.Tensor, clouds: ScanClouds, opt_pose: Rigid3,
                cfg: TrajectoryBuilderConfig, defer_grid_writes: bool = False):
    """Step 8: the motion filter gate and the insertion (only prepared and
    counted with `defer_grid_writes`); an empty scan leaves the filter
    alone. Returns (submaps, motion filter, inserted, finished id or -1,
    InsertionBatch or None)."""
    gravity_alignment = opt_pose.rotation
    filtered = clouds.filtered
    filtered_in_opt = opt_pose.apply(clouds.prediction.inverse().apply(filtered.points))
    has_points = torch.sum(filtered.mask) > 0
    mfc = cfg.motion_filter
    similar, mf_candidate = mf.is_similar(
        state.motion_filter, time, opt_pose, max_time_seconds=mfc.max_time_seconds,
        max_distance_meters=mfc.max_distance_meters, max_angle_radians=mfc.max_angle_radians)
    new_mf = mf.MotionFilterState(
        last_time=torch.where(has_points, mf_candidate.last_time, state.motion_filter.last_time),
        last_pose=tree_where(has_points, mf_candidate.last_pose, state.motion_filter.last_pose),
        num_total=torch.where(has_points, mf_candidate.num_total, state.motion_filter.num_total),
        num_different=torch.where(has_points, mf_candidate.num_different,
                                  state.motion_filter.num_different),
    )
    insert = (~similar) & has_points
    if defer_grid_writes:
        batch = prepare_insertion(state.submaps, opt_pose.translation, filtered_in_opt, filtered.mask,
                                  cfg.submaps, insert)
        new_submaps, finished = mark_insertion(state.submaps, gravity_alignment, opt_pose.translation,
                                               cfg.submaps, insert)
    else:
        batch = None
        new_submaps, finished = insert_range_data_into_submaps(
            state.submaps, opt_pose.translation, filtered_in_opt, filtered.mask,
            gravity_alignment, cfg.submaps, insert)
    return new_submaps, new_mf, insert, finished, batch


def histogram_points(clouds: ScanClouds, opt_pose: Rigid3) -> torch.Tensor:
    """Step 9's input: the filtered scan, gravity-aligned."""
    return Rigid3.rotation_only(opt_pose.rotation).apply(
        clouds.prediction.inverse().apply(clouds.filtered.points))


def finish_step(state: FrontendState, scan: ScanInput, clouds: ScanClouds, opt_pose: Rigid3, result,
                new_submaps: ActiveSubmaps, new_mf, insert, finished, hist, batch):
    """The new FrontendState and the ScanResult (of one lane or of B)."""
    new_state = FrontendState(submaps=new_submaps, pose=opt_pose, motion_filter=new_mf,
                              scan_index=state.scan_index + 1)
    nc = new_submaps.num_created
    insertion_ids = torch.stack([torch.where(nc >= 2, nc - 2, -1), nc - 1], dim=-1).to(torch.int32)
    out = ScanResult(
        time=scan.time,
        local_pose=opt_pose,
        inserted=insert,
        finished_submap=finished,
        matcher_cost=result.cost,
        matcher_iterations=result.iterations,
        num_hits=torch.sum(clouds.filtered.mask, dim=-1, dtype=torch.int32),
        histogram=hist,
        high_points=clouds.high.points,
        high_mask=clouds.high.mask,
        low_points=clouds.low.points,
        low_mask=clouds.low.mask,
        insertion_submap_ids=insertion_ids,
        gravity_alignment=opt_pose.rotation,
        insertion_batch=batch,
    )
    return new_state, out
