"""Coarse-to-fine correlative scan matching for loop closure (port of
dliom_tpu/backend/fast_correlative.py; reference
FastCorrelativeScanMatcher3D, fast_correlative_scan_matcher_3d.cc).

A search over (x, y, z, yaw) against a precomputation pyramid. In place of
recursive best-first branch-and-bound, each depth expands every kept
candidate into its 8 children, scores them in one batched gather-sum and
keeps the top K per yaw (a beam). The pyramid values are admissible upper
bounds, so with K above the number of candidates whose bound beats the
final best, the winner equals exhaustive BnB's. Scoring at depth d is the
mean pyramid byte of the scan's cells at the candidate offset, indices
right-shifted by max(0, d - full_resolution_depth + 1) (DiscretizeScan
:252-295). Top-k keeps the lower index first among equal scores, as
jax.lax.top_k does.

Nothing here reads the host or sizes a tensor from data, and the lattice
offsets are `common/device.py` constants, so the pose graph captures a
search in a CUDA graph.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import torch

from dliom_tpu_torch.backend.compression import top_k
from dliom_tpu_torch.backend.precomputation import Pyramid, probability_from_byte
from dliom_tpu_torch.common.config import FastCorrelativeConfig
from dliom_tpu_torch.common.device import constant
from dliom_tpu_torch.mapping.grid import GridSpec, cell_index, interpolated_probability
from dliom_tpu_torch.ops.rotational_histogram import match_histograms
from dliom_tpu_torch.transform.rigid import (
    Rigid3,
    quat_from_yaw,
    quat_multiply,
    quat_normalize,
    quat_yaw,
)


class CorrelativeResult(NamedTuple):
    score: torch.Tensor  # () best score (-inf when nothing passed)
    pose: Rigid3  # node pose in the submap frame
    rotational_score: torch.Tensor
    low_resolution_score: torch.Tensor
    found: torch.Tensor  # () bool


def _depth_cells(cells: torch.Tensor, depth: int, full_depth: int, window_start):
    """Per-depth cell indices (DiscretizeScan): full resolution below
    full_depth, shifted-window halving beyond."""
    if depth < full_depth:
        return cells
    e = depth - full_depth + 1
    start = constant(window_start, torch.int32, cells.device)
    return ((cells + start) >> e) - (start >> e)


def _top_k_rows(x: torch.Tensor, k: int):
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def match_candidates(
    pyramid: Pyramid,
    spec: GridSpec,
    points: torch.Tensor,  # (N, 3) high-res cloud in the node frame
    mask: torch.Tensor,  # (N,)
    base_pose: Rigid3,  # initial node-in-submap pose
    yaw_angles: torch.Tensor,  # (A,) candidate yaw offsets about submap z
    yaw_mask: torch.Tensor,  # (A,) rotational-score gate
    cfg: FastCorrelativeConfig,
    *,
    beam_width: int = 256,
    coarse_point_stride: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Coarse-to-fine search. Returns (scores (K,), offsets (K, 3) int32,
    scan_idx (K,)) of the top-K depth-0 candidates, descending. Candidate
    (offset, a) is translate(resolution * offset) * R_z(yaw_a) * base_pose.
    Depths above 1 score every `coarse_point_stride`-th point only (the JAX
    package's documented deviation from ScoreCandidates)."""
    depth = len(pyramid.levels)
    full_depth = min(cfg.full_resolution_depth, depth)
    res = spec.resolution
    half = spec.half
    dev = points.device
    lin_xy = int(round(cfg.linear_xy_search_window / res))
    lin_z = int(round(cfg.linear_z_search_window / res))
    window_start = (-lin_xy, -lin_xy, -lin_z)

    # discretized scan per yaw candidate: cells of R_z(a) * base_pose * points
    rot = quat_normalize(quat_multiply(quat_from_yaw(yaw_angles), base_pose.rotation[None]))
    posed = Rigid3(rot[:, None, :], base_pose.translation[None, None, :]).apply(points[None])
    all_cells = cell_index(posed, res)  # (A, N, 3)

    stride = max(1, int(coarse_point_stride))
    cells_per_depth = []
    for d in range(depth):
        cells = _depth_cells(all_cells, d, full_depth, window_start)
        cells_per_depth.append(cells[:, ::stride] if d > 1 else cells)
    mask_per_depth = [mask[::stride] if d > 1 else mask for d in range(depth)]
    nv_per_depth = [torch.clamp(torch.sum(m.to(torch.float32)), min=1.0) for m in mask_per_depth]

    def score(depth_idx: int, offsets: torch.Tensor) -> torch.Tensor:
        """(A, C) scores of offsets (A, C, 3): mean pyramid byte over the
        scan cells, the full point count dividing (ScoreCandidates)."""
        level = pyramid.levels[depth_idx]
        e_level = level.shape[0]
        red = max(0, depth_idx - full_depth + 1)
        half_level = half >> red if depth_idx >= full_depth else half
        d_mask = mask_per_depth[depth_idx]
        cells = cells_per_depth[depth_idx]  # (A, N, 3)
        shifted = cells[:, None, :, :] + (offsets >> red)[:, :, None, :] + half_level  # (A, C, N, 3)
        ok = torch.all((shifted >= 0) & (shifted < e_level), dim=-1) & d_mask
        c = torch.clamp(shifted, 0, e_level - 1)
        flat = (c[..., 0] * e_level + c[..., 1]) * e_level + c[..., 2]
        vals = level.reshape(-1)[flat.long()]
        s = torch.sum(torch.where(ok, vals.to(torch.float32), 0.0), dim=-1)
        return probability_from_byte(s / nv_per_depth[depth_idx])

    # lowest-resolution lattice, identical for every yaw; the beam is kept
    # per yaw so one yaw family's ties cannot flood out the others
    step = 1 << (depth - 1)
    xs = torch.arange(-lin_xy, lin_xy + 1, step, device=dev)
    zs = torch.arange(-lin_z, lin_z + 1, step, device=dev)
    a_count = yaw_angles.shape[0]
    gx, gy, gz = torch.meshgrid(xs, xs, zs, indexing="ij")
    lattice = torch.stack([gx.reshape(-1), gy.reshape(-1), gz.reshape(-1)], -1).to(torch.int32)
    per_yaw = max(8, beam_width // a_count)
    offsets = lattice[None].expand(a_count, -1, 3)
    scores = torch.where(yaw_mask[:, None], score(depth - 1, offsets), -1.0)

    for d in range(depth - 2, -1, -1):
        k = min(per_yaw, scores.shape[1])
        top_scores, top = _top_k_rows(scores, k)
        offsets = torch.gather(offsets, 1, top[..., None].expand(-1, -1, 3))
        hw = 1 << d
        children = constant(
            ((0, 0, 0), (hw, 0, 0), (0, hw, 0), (hw, hw, 0),
             (0, 0, hw), (hw, 0, hw), (0, hw, hw), (hw, hw, hw)), torch.int32, dev)
        child_off = (offsets[:, :, None, :] + children[None, None]).reshape(a_count, k * 8, 3)
        in_win = (child_off[..., 0] <= lin_xy) & (child_off[..., 1] <= lin_xy) \
            & (child_off[..., 2] <= lin_z)
        parent_ok = (top_scores > 0.0)[:, :, None].expand(-1, -1, 8).reshape(a_count, k * 8)
        scores = torch.where(in_win & parent_ok, score(d, child_off), -1.0)
        offsets = child_off

    k = min(beam_width, scores.numel())
    flat_scan = torch.arange(a_count, dtype=torch.int32, device=dev)[:, None].expand(scores.shape)
    top_scores, top = top_k(scores.reshape(-1), k)
    return top_scores, offsets.reshape(-1, 3)[top], flat_scan.reshape(-1)[top]


def low_resolution_scores(low_values: torch.Tensor, low_spec: GridSpec, low_points: torch.Tensor,
                          low_mask: torch.Tensor, poses: Rigid3) -> torch.Tensor:
    """Mean interpolated probability of the low-res cloud under each of the
    (K,) poses, full-count denominator (low_resolution_matcher.cc)."""
    world = Rigid3(poses.rotation[:, None, :], poses.translation[:, None, :]).apply(low_points[None])
    p = interpolated_probability(low_values, world, low_spec)
    n = torch.clamp(torch.sum(low_mask.to(torch.float32)), min=1.0)
    return torch.sum(torch.where(low_mask[None], p, 0.0), dim=-1) / n


def match(
    pyramid: Pyramid,
    spec: GridSpec,
    low_values: torch.Tensor,
    low_spec: GridSpec,
    high_points: torch.Tensor,
    high_mask: torch.Tensor,
    low_points: torch.Tensor,
    low_mask: torch.Tensor,
    initial_pose: Rigid3,  # node in the submap frame
    histogram: torch.Tensor,  # node rotational histogram (gravity-aligned)
    submap_histogram: torch.Tensor,  # accumulated submap reference histogram
    submap_histogram_yaw: torch.Tensor,  # initial yaw of node-in-submap
    cfg: FastCorrelativeConfig,
    min_score: float,
    *,
    num_angles: int = 0,
    max_scan_range: float = 60.0,
    use_rotational_gate: bool = True,
    beam_width: int = 256,
    coarse_point_stride: int = 1,
) -> CorrelativeResult:
    """Search around `initial_pose` (Match / MatchWith3DofInitial). With
    num_angles 1 and no rotational gate this is MatchWith3DofInitial;
    otherwise yaw candidates are gated by histogram score."""
    res = spec.resolution
    dev = high_points.device
    if num_angles <= 0:
        step = (1.0 - 1e-2) * math.acos(max(-1.0, 1.0 - res**2 / (2.0 * max_scan_range**2)))
        n_side = int(round(cfg.angular_search_window / step))
        angles = torch.arange(-n_side, n_side + 1, dtype=torch.float32, device=dev) * step
    elif num_angles == 1:
        angles = torch.zeros(1, dtype=torch.float32, device=dev)
    elif cfg.angular_search_window >= math.pi - 1e-6:
        step = 2.0 * math.pi / num_angles
        angles = (torch.arange(num_angles, dtype=torch.float32, device=dev) - num_angles // 2) * step
    else:
        angles = torch.linspace(-cfg.angular_search_window, cfg.angular_search_window, num_angles,
                                dtype=torch.float32, device=dev)
    if use_rotational_gate:
        rot_scores = match_histograms(histogram, submap_histogram, angles + submap_histogram_yaw)
        yaw_mask = rot_scores >= cfg.min_rotational_score
    else:
        rot_scores = torch.ones_like(angles)
        yaw_mask = torch.ones_like(angles, dtype=torch.bool)

    scores, offsets, scan_idx = match_candidates(
        pyramid, spec, high_points, high_mask, initial_pose, angles, yaw_mask, cfg,
        beam_width=beam_width, coarse_point_stride=coarse_point_stride)

    # candidate poses; low-resolution gate in score order: the best-scoring
    # candidate that passes wins (BnB depth-0 walk, :433-452)
    cand_rot = quat_normalize(quat_multiply(quat_from_yaw(angles[scan_idx.long()]),
                                            initial_pose.rotation[None]))
    poses = Rigid3(cand_rot, initial_pose.translation[None] + res * offsets.to(torch.float32))
    low_scores = low_resolution_scores(low_values, low_spec, low_points, low_mask, poses)
    passes = (low_scores >= cfg.min_low_resolution_score) & (scores > min_score)
    # a (1,) index, not a 0-dim one: indexing by a 0-dim tensor reads it on the host
    pick = torch.argmax(passes.to(torch.int32)).reshape(1)  # first True in descending-score order
    found = torch.any(passes)
    return CorrelativeResult(
        score=torch.where(found, scores[pick][0], -math.inf),
        pose=Rigid3(poses.rotation[pick][0], poses.translation[pick][0]),
        rotational_score=rot_scores[scan_idx[pick].long()][0],
        low_resolution_score=low_scores[pick][0],
        found=found,
    )


def match_full_submap(
    pyramid: Pyramid,
    spec: GridSpec,
    low_values: torch.Tensor,
    low_spec: GridSpec,
    high_points: torch.Tensor,
    high_mask: torch.Tensor,
    low_points: torch.Tensor,
    low_mask: torch.Tensor,
    node_rotation: torch.Tensor,  # (4,) gravity-consistent node-in-submap rotation
    histogram: torch.Tensor,
    submap_histogram: torch.Tensor,
    cfg: FastCorrelativeConfig,
    min_score: float,
    *,
    beam_width: int = 1024,
    coarse_point_stride: int = 1,
) -> CorrelativeResult:
    """Whole-submap, all-yaw search (MatchFullSubmap,
    fast_correlative_scan_matcher_3d.cc:199-250): the linear window spans
    the grid extent around the submap center, yaw spans +-pi; the node
    rotation supplies roll and pitch only."""
    res = spec.resolution
    wide = dataclasses.replace(cfg, linear_xy_search_window=spec.half * res,
                               linear_z_search_window=spec.half * res,
                               angular_search_window=math.pi)
    initial = Rigid3(node_rotation, torch.zeros(3, dtype=torch.float32, device=node_rotation.device))
    return match(
        pyramid, spec, low_values, low_spec, high_points, high_mask, low_points, low_mask,
        initial, histogram, submap_histogram, quat_yaw(node_rotation), wide, min_score,
        num_angles=int(cfg.full_submap_num_angles), use_rotational_gate=True,
        beam_width=beam_width, coarse_point_stride=coarse_point_stride,
    )
