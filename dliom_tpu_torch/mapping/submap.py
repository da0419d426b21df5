"""Submap3D / ActiveSubmaps3D as two fixed slots (port of
dliom_tpu/mapping/submap.py; reference mapping/3d/submap_3d.cc).

Submap k lives in slot k % 2; the front (older) submap is the matching
target; every scan is inserted into both active submaps; when the back
submap reaches `num_range_data` scans, a new submap spawns at the start of
the next step (`apply_pending_spawn`). Each of the two grids is either a
dense flat bank (two slots of extent^3 cells, plus one padding group with
grouped apply) or a two-level brick bank, independently.

Banks are updated in place by insertion and spawn, so a finished submap's
grids must be copied out before the next step recycles its slot
(map_builder.py captures them).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from dliom_tpu_torch.common.config import SubmapsConfig
from dliom_tpu_torch.mapping.brick_grid import (
    BrickBank,
    BrickGridSpec,
    _insert_brick_slots,
    _take,
    add_to_first,
    make_brick_bank,
    reset_slot,
)
from dliom_tpu_torch.mapping.grid import GRID_DTYPE, GridSpec
from dliom_tpu_torch.ops.grid_update import _insert_slots
from dliom_tpu_torch.ops.grouped_apply import dense_bank_size
from dliom_tpu_torch.transform.rigid import Rigid3, _norm


class ActiveSubmaps(NamedTuple):
    high_values: torch.Tensor  # flat dense bank, (0,) on the brick path
    low_values: torch.Tensor  # flat dense bank, (0,) on the brick path
    pose_rotation: torch.Tensor  # (2, 4)
    pose_translation: torch.Tensor  # (2, 3)
    num_range_data: torch.Tensor  # (2,) int32
    num_created: torch.Tensor  # () int32
    pending_spawn: torch.Tensor  # () bool
    pending_rotation: torch.Tensor  # (4,)
    pending_translation: torch.Tensor  # (3,)
    high_brick: Optional[BrickBank] = None
    lane: torch.Tensor = None  # () int32: 0, or the lane of a batched run (parallel/batch.py)
    low_brick: Optional[BrickBank] = None
    dense_dropped: torch.Tensor = None  # (1,) int32 ((B,) batched, aggregated in [0])


class InsertionBatch(NamedTuple):
    origins: torch.Tensor  # (2, 3)
    points: torch.Tensor  # (2, N, 3)
    masks: torch.Tensor  # (2, N) full-range validity
    hi_masks: torch.Tensor  # (2, N) + high_resolution_max_range crop


def grid_specs(cfg: SubmapsConfig) -> Tuple[GridSpec, GridSpec]:
    """Dense specs of both grids. On a brick path the dense spec is only
    the backend's capture crop, with no insert and no padding group."""
    return (
        GridSpec(cfg.high_resolution, cfg.high_resolution_extent,
                 0 if cfg.use_brick_grid else cfg.dense_apply_groups),
        GridSpec(cfg.low_resolution, cfg.low_resolution_extent,
                 0 if cfg.use_brick_grid_low else cfg.dense_apply_groups),
    )


def brick_spec(cfg: SubmapsConfig) -> BrickGridSpec:
    return BrickGridSpec(
        resolution=cfg.high_resolution,
        dir_extent=cfg.brick_dir_extent,
        max_bricks=cfg.brick_max_bricks,
        apply_groups=cfg.brick_apply_groups,
        apply_group_bricks=cfg.brick_apply_group_bricks,
    )


def brick_spec_low(cfg: SubmapsConfig) -> BrickGridSpec:
    return BrickGridSpec(
        resolution=cfg.low_resolution,
        dir_extent=cfg.low_brick_dir_extent,
        max_bricks=cfg.low_brick_max_bricks,
        apply_groups=cfg.low_brick_apply_groups,
        apply_group_bricks=cfg.low_brick_apply_group_bricks,
    )


def make_active_submaps(cfg: SubmapsConfig, device=None) -> ActiveSubmaps:
    """One submap at identity (ActiveSubmaps3D ctor, submap_3d.cc:286-295)."""
    hi, lo = grid_specs(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    q = torch.zeros(2, 4, **f32)
    q[:, 0] = 1.0

    def dense(spec: GridSpec, bricks: bool):
        n = 0 if bricks else dense_bank_size(spec.num_cells, 2, spec.apply_groups)
        return torch.zeros(n, dtype=GRID_DTYPE, device=device)

    return ActiveSubmaps(
        high_values=dense(hi, cfg.use_brick_grid),
        low_values=dense(lo, cfg.use_brick_grid_low),
        pose_rotation=q,
        pose_translation=torch.zeros(2, 3, **f32),
        num_range_data=torch.zeros(2, dtype=torch.int32, device=device),
        num_created=torch.ones((), dtype=torch.int32, device=device),
        pending_spawn=torch.zeros((), dtype=torch.bool, device=device),
        pending_rotation=torch.tensor([1.0, 0.0, 0.0, 0.0], **f32),
        pending_translation=torch.zeros(3, **f32),
        high_brick=make_brick_bank(brick_spec(cfg), device) if cfg.use_brick_grid else None,
        lane=torch.zeros((), dtype=torch.int32, device=device),
        low_brick=make_brick_bank(brick_spec_low(cfg), device) if cfg.use_brick_grid_low else None,
        dense_dropped=torch.zeros(1, dtype=torch.int32, device=device),
    )


def matching_slot(state: ActiveSubmaps) -> torch.Tensor:
    """Slot of the front (older, matching) submap."""
    nc = state.num_created
    front_id = torch.clamp(nc - 2, min=0)
    return torch.where(nc >= 2, torch.remainder(front_id, 2), torch.remainder(nc - 1, 2))


def back_slot(state: ActiveSubmaps) -> torch.Tensor:
    return torch.remainder(state.num_created - 1, 2)


def slot_pose(state: ActiveSubmaps, slot) -> Rigid3:
    return Rigid3(_take(state.pose_rotation, slot), _take(state.pose_translation, slot))


def _slot_active(state: ActiveSubmaps) -> torch.Tensor:
    slot_ids = torch.arange(2, dtype=torch.int32, device=state.num_created.device)
    return torch.where(
        state.num_created >= 2,
        torch.ones(2, dtype=torch.bool, device=slot_ids.device),
        slot_ids == torch.remainder(state.num_created - 1, 2),
    )


def prepare_insertion(state, origin_in_local, returns_in_local, returns_mask,
                      cfg: SubmapsConfig, enabled) -> InsertionBatch:
    """The scan in both slot frames plus the per-slot gates."""
    inv = Rigid3(state.pose_rotation, state.pose_translation).inverse()
    pts2 = Rigid3(inv.rotation[:, None, :], inv.translation[:, None, :]).apply(
        returns_in_local[None])  # (2, N, 3)
    org2 = inv.apply(origin_in_local[None])  # (2, 3)
    use = _slot_active(state) & enabled
    masks2 = returns_mask[None, :] & use[:, None]
    hi_masks = masks2 & (_norm(pts2 - org2[:, None, :]) <= cfg.high_resolution_max_range)
    return InsertionBatch(origins=org2, points=pts2, masks=masks2, hi_masks=hi_masks)


def mark_insertion(state: ActiveSubmaps, gravity_alignment, origin_in_local,
                   cfg: SubmapsConfig, enabled):
    """Count the scan per active slot and mark a pending spawn when the
    back submap fills (submap_3d.cc:310-315). Returns (state, finished)."""
    use = _slot_active(state) & enabled
    state = state._replace(num_range_data=state.num_range_data + use.to(torch.int32))
    spawn = enabled & (_take(state.num_range_data, back_slot(state)) >= cfg.num_range_data) \
        & ~state.pending_spawn
    finished = torch.where(spawn & (state.num_created >= 2), state.num_created - 2, -1)
    state = state._replace(
        pending_spawn=state.pending_spawn | spawn,
        pending_rotation=torch.where(spawn, gravity_alignment, state.pending_rotation),
        pending_translation=torch.where(spawn, origin_in_local, state.pending_translation),
    )
    return state, finished


def write_insertion_batch(high_values, low_values, high_brick, batch: InsertionBatch,
                          cfg: SubmapsConfig, low_brick=None, dense_dropped=None) -> dict:
    """Insert a batch into both grids' banks (in place). Dense grouped-apply
    overflow drops add into `dense_dropped` (brick drops live in the
    banks). Returns the fields of ActiveSubmaps it rewrote."""
    hi, lo = grid_specs(cfg)
    ins = cfg.range_data_inserter
    kw = dict(hit_probability=ins.hit_probability, miss_probability=ins.miss_probability,
              num_free_space_voxels=ins.num_free_space_voxels)
    drops = []
    if cfg.use_brick_grid:
        high_brick = _insert_brick_slots(high_brick, batch.origins, batch.points, batch.hi_masks,
                                         spec=brick_spec(cfg), **kw)
    else:
        high_values, d = _insert_slots(high_values, batch.origins, batch.points, batch.hi_masks,
                                       spec=hi, **kw)
        drops.append(d)
    if cfg.use_brick_grid_low:
        low_brick = _insert_brick_slots(low_brick, batch.origins, batch.points, batch.masks,
                                        spec=brick_spec_low(cfg), **kw)
    else:
        low_values, d = _insert_slots(low_values, batch.origins, batch.points, batch.masks,
                                      spec=lo, **kw)
        drops.append(d)
    out = dict(high_values=high_values, high_brick=high_brick, low_values=low_values,
               low_brick=low_brick)
    if dense_dropped is not None:
        out["dense_dropped"] = add_to_first(dense_dropped, sum(drops)) if drops else dense_dropped
    return out


def insert_range_data_into_submaps(state: ActiveSubmaps, origin_in_local, returns_in_local,
                                   returns_mask, gravity_alignment, cfg: SubmapsConfig,
                                   enabled):
    """One ActiveSubmaps3D::InsertRangeData step (submap_3d.cc:303-315);
    `enabled` gates it arithmetically. Returns (state, finished id or -1)."""
    batch = prepare_insertion(state, origin_in_local, returns_in_local, returns_mask, cfg, enabled)
    state = state._replace(**write_insertion_batch(
        state.high_values, state.low_values, state.high_brick, batch, cfg,
        low_brick=state.low_brick, dense_dropped=state.dense_dropped))
    return mark_insertion(state, gravity_alignment, origin_in_local, cfg, enabled)


def _clear_dense_slot_(values: torch.Tensor, spec: GridSpec, slot: torch.Tensor,
                       pending: torch.Tensor, num_slots: int = 2) -> None:
    """Zero slot `slot` of a flat dense bank of `num_slots` slots in place
    when `pending`, with no host read (the padding group is never
    touched). `slot` and `pending` may be (L,): one distinct slot per lane."""
    ar = torch.arange(num_slots, dtype=torch.int32, device=values.device)
    here = (ar == slot[..., None]) & pending[..., None]
    if slot.dim():
        here = torch.any(here, dim=0)
    values[: num_slots * spec.num_cells].view(num_slots, spec.num_cells).masked_fill_(here[:, None], 0)


def apply_pending_spawn(state: ActiveSubmaps, cfg: SubmapsConfig,
                        defer_bank_clears: bool = False) -> ActiveSubmaps:
    """Execute a deferred AddSubmap (submap_3d.cc:318-326): recycle the
    finished submap's slot for the new one, gated on `pending_spawn`. With
    `defer_bank_clears` only the per-slot state changes and the banks are
    left alone: the batched run clears all lanes' slots at once
    (parallel/batch.py::clear_spawned_slots)."""
    hi, lo = grid_specs(cfg)
    s = state
    pending = s.pending_spawn
    new_slot = torch.remainder(s.num_created, 2)
    here = (torch.arange(2, dtype=torch.int32, device=new_slot.device) == new_slot) & pending
    high_brick, low_brick = s.high_brick, s.low_brick
    if not defer_bank_clears:
        if cfg.use_brick_grid:
            high_brick = reset_slot(s.high_brick, brick_spec(cfg), new_slot, pending)
        else:
            _clear_dense_slot_(s.high_values, hi, new_slot, pending)
        if cfg.use_brick_grid_low:
            low_brick = reset_slot(s.low_brick, brick_spec_low(cfg), new_slot, pending)
        else:
            _clear_dense_slot_(s.low_values, lo, new_slot, pending)
    return s._replace(
        high_brick=high_brick,
        low_brick=low_brick,
        pose_rotation=torch.where(here[:, None], s.pending_rotation, s.pose_rotation),
        pose_translation=torch.where(here[:, None], s.pending_translation, s.pose_translation),
        num_range_data=torch.where(here, 0, s.num_range_data),
        num_created=s.num_created + pending.to(torch.int32),
        pending_spawn=torch.zeros_like(pending),
    )
