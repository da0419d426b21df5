"""Batched multi-sequence mapping (port of dliom_tpu/parallel/batch.py:46-308).

B independent sequences step in lockstep, one scan of each per step. Every
per-sequence leaf of the state carries a leading lane axis; the grid banks
are shared and flat, with 2B slots (lane b's two active submaps in slots
2b and 2b + 1, `ActiveSubmaps.lane` = b), and the drop counters are (B,),
aggregated in element 0. A batched step runs, in the JAX body's order:

  1. the spawn clears of every lane, from the previous step's pending
     flags, as masked writes over all 2B slots (`clear_spawned_slots`);
  2. every lane's scan with its grid writes deferred (`lio_step`'s stages);
  3. one flat insert of all lanes' records into the 2B slots: one call of
     K1 per brick grid (or of K1's dense entry per dense grid), and one
     call of K2 per step for all B IMU bridges, whatever B is.

The lane axis is explicit: the stages that launch a kernel, read or write
a bank, or read on the host take all lanes at once (K2 over (B, M, 15, 15)
in `pre.integrate`, the LM match with a bank slot per lane that stops when
every lane has converged, the histogram's lane-offset segment sums, the
spawn clears and the flat insert). The pure-torch stages between them (the
prediction, deskew and voxel filters, the window Gauss-Newton and gravity
estimate, the motion filter and the insertion's bookkeeping) run under
`torch.func.vmap`, whose batched ops launch once for all lanes (a voxel
filter's sort is one sort of B rows). No stage loops over lanes on the
host, so the launches of a step do not grow with B.

K1's capacities (`apply_groups`) are per call, so at B lanes one call
holds every lane's touched groups: a run without drops scales them by B.
The online correlative pre-search and the mesh sharding (:311-411) are not
ported: the port runs on one card.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import torch
from torch.func import vmap
from torch.profiler import record_function
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from dliom_tpu_torch.common.config import TrajectoryBuilderConfig
from dliom_tpu_torch.common.device import get_device
from dliom_tpu_torch.frontend.lio import (
    LioResult,
    LioScanInput,
    LioState,
    _window_gravity,
    fuse_window,
    imu_carry,
    make_lio_state,
)
from dliom_tpu_torch.frontend.local_trajectory_builder import (
    FrontendState,
    ScanInput,
    ScanResult,
    filter_scan,
    finish_step,
    histogram_points,
    insert_scan,
    make_initial_state,
    match_scan,
    match_target,
)
from dliom_tpu_torch.imu import preintegration as pre
from dliom_tpu_torch.mapping.brick_grid import make_brick_bank, reset_slot
from dliom_tpu_torch.mapping.grid import GRID_DTYPE
from dliom_tpu_torch.mapping.submap import (
    ActiveSubmaps,
    InsertionBatch,
    _clear_dense_slot_,
    apply_pending_spawn,
    brick_spec,
    brick_spec_low,
    grid_specs,
    write_insertion_batch,
)
from dliom_tpu_torch.ops.grouped_apply import dense_bank_size
from dliom_tpu_torch.ops.rotational_histogram import compute_histogram

_BANKS = ("high_values", "low_values", "high_brick", "low_brick", "dense_dropped")


def _over_lanes(fn, *args):
    """`fn` over the leading lane axis of every tensor in `args`
    (torch.func.vmap); None fields pass through, in and out."""
    spec = {}

    def flat_fn(*a):
        leaves, spec["tree"] = tree_flatten(fn(*a))
        spec["none"] = [x is None for x in leaves]
        return [x for x in leaves if x is not None]

    outs = iter(vmap(flat_fn, in_dims=tree_map(lambda x: None if x is None else 0, args))(*args))
    return tree_unflatten([None if none else next(outs) for none in spec["none"]], spec["tree"])


def _lane_fields(sm: ActiveSubmaps) -> ActiveSubmaps:
    """The per-lane fields; the shared banks and drop counter as None."""
    return sm._replace(**{f: None for f in _BANKS})


def _with_banks(lanes: ActiveSubmaps, shared: ActiveSubmaps) -> ActiveSubmaps:
    return lanes._replace(**{f: getattr(shared, f) for f in _BANKS})


def _lanes_of(tree, batch: int):
    """Every tensor of one lane's tree copied to B lanes."""
    return tree_map(lambda x: None if x is None else x.expand((batch,) + x.shape).clone(), tree)


def _batched_submaps(sm: ActiveSubmaps, cfg: TrajectoryBuilderConfig, batch: int, device) -> ActiveSubmaps:
    """One lane's ActiveSubmaps made B lanes: flat banks of 2B slots."""
    smc = cfg.submaps
    hi, lo = grid_specs(smc)
    lanes = _lanes_of(_lane_fields(sm), batch)

    def dense(spec, bricks):
        n = 0 if bricks else dense_bank_size(spec.num_cells, 2 * batch, spec.apply_groups)
        if n >= 2**31:
            raise ValueError(f"{batch} lanes: a flat dense bank of {n} cells exceeds int32 offsets")
        return torch.zeros(n, dtype=GRID_DTYPE, device=device)

    def bricks(spec):
        if 2 * batch * spec.num_pool_cells >= 2**31:
            raise ValueError(f"{batch} lanes: a flat brick pool of {2 * batch} x {spec.num_pool_cells} "
                             "cells exceeds int32 offsets")
        return make_brick_bank(spec, device, lanes=batch)

    return lanes._replace(
        high_values=dense(hi, smc.use_brick_grid),
        low_values=dense(lo, smc.use_brick_grid_low),
        high_brick=bricks(brick_spec(smc)) if smc.use_brick_grid else None,
        low_brick=bricks(brick_spec_low(smc)) if smc.use_brick_grid_low else None,
        lane=torch.arange(batch, dtype=torch.int32, device=device),
        dense_dropped=torch.zeros(batch, dtype=torch.int32, device=device),
    )


def make_batched_state(cfg: TrajectoryBuilderConfig, batch: int, device="cuda") -> FrontendState:
    """B independent frontend states: per-lane fields (B, ·), flat banks
    of 2B slots. A bank reshapes to the JAX package's per-lane (B, ·)
    layout (a dense bank with grouped apply ends in one padding group)."""
    device = get_device(device)
    one = make_initial_state(cfg, device)
    return _lanes_of(one._replace(submaps=None), batch)._replace(
        submaps=_batched_submaps(one.submaps, cfg, batch, device))


def make_batched_lio_state(cfg: TrajectoryBuilderConfig, batch: int, device="cuda") -> LioState:
    """B LIO states at the identity with zero biases, the banks shared and
    flat (2B slots), `lane` = arange(B)."""
    device = get_device(device)
    zero = torch.zeros(3, device=device)
    one = make_lio_state(cfg, pre.NavState.identity(device), zero, zero)
    lanes = _lanes_of(one._replace(frontend=one.frontend._replace(submaps=None)), batch)
    return lanes._replace(frontend=lanes.frontend._replace(
        submaps=_batched_submaps(one.frontend.submaps, cfg, batch, device)))


def lane_banks(cfg: TrajectoryBuilderConfig, sm: ActiveSubmaps, b: int) -> dict:
    """Copies of lane b's two slots of the flat banks as a single
    sequence's banks (a dense bank keeps its padding group; the drop
    counters start at zero): the ActiveSubmaps fields they fill."""
    smc = cfg.submaps
    hi, lo = grid_specs(smc)

    def dense(values, spec):
        if values.numel() == 0:
            return values.clone()
        lanes = sm.lane.shape[0]
        return torch.cat([values[2 * b * spec.num_cells:(2 * b + 2) * spec.num_cells],
                          values[2 * lanes * spec.num_cells:]])

    def bricks(bank, spec):
        if bank is None:
            return None

        def two(x, per_slot):
            return x[2 * b * per_slot:(2 * b + 2) * per_slot].clone()

        return bank._replace(directory=two(bank.directory, spec.num_dir_groups),
                             pool=two(bank.pool, spec.num_pool_cells), counts=two(bank.counts, 1),
                             group_of_slot=two(bank.group_of_slot, spec.num_pool_groups),
                             dropped=torch.zeros_like(bank.dropped[:1]), epochs=two(bank.epochs, 1))

    return dict(high_values=dense(sm.high_values, hi), low_values=dense(sm.low_values, lo),
                high_brick=bricks(sm.high_brick, brick_spec(smc)),
                low_brick=bricks(sm.low_brick, brick_spec_low(smc)),
                dense_dropped=torch.zeros_like(sm.dense_dropped[:1]))


def lane_state(cfg: TrajectoryBuilderConfig, state: LioState, b: int) -> LioState:
    """Lane b of a batched state as a single sequence's LioState, with
    copies of its banks (`lane_banks`), for `lio_step` to run alone."""
    sm = state.frontend.submaps
    one = tree_map(lambda x: None if x is None else x[b].clone(),
                   state._replace(frontend=state.frontend._replace(submaps=_lane_fields(sm))))
    sub = one.frontend.submaps._replace(lane=torch.zeros_like(sm.lane[0]), **lane_banks(cfg, sm, b))
    return one._replace(frontend=one.frontend._replace(submaps=sub))


def _clear_spawned(cfg: TrajectoryBuilderConfig, fs: FrontendState) -> FrontendState:
    smc = cfg.submaps
    sm = fs.submaps
    hi, lo = grid_specs(smc)
    slots = 2 * sm.lane.shape[0]
    new_slot = 2 * sm.lane + torch.remainder(sm.num_created, 2)
    pending = sm.pending_spawn
    high_brick, low_brick = sm.high_brick, sm.low_brick
    if smc.use_brick_grid:
        high_brick = reset_slot(sm.high_brick, brick_spec(smc), new_slot, pending)
    else:
        _clear_dense_slot_(sm.high_values, hi, new_slot, pending, slots)
    if smc.use_brick_grid_low:
        low_brick = reset_slot(sm.low_brick, brick_spec_low(smc), new_slot, pending)
    else:
        _clear_dense_slot_(sm.low_values, lo, new_slot, pending, slots)
    return fs._replace(submaps=sm._replace(high_brick=high_brick, low_brick=low_brick))


def clear_spawned_slots(cfg: TrajectoryBuilderConfig, state: LioState) -> LioState:
    """The pending spawn clears of every lane (slot 2b + num_created[b] % 2
    where pending_spawn[b]) as masked writes over the 2B slots, in place."""
    return state._replace(frontend=_clear_spawned(cfg, state.frontend))


def write_flat_insertion(cfg: TrajectoryBuilderConfig, sm: ActiveSubmaps, ib: InsertionBatch) -> ActiveSubmaps:
    """The lanes' (B, 2, ·) insertion batch as one insert into 2B slots."""
    slots = 2 * ib.origins.shape[0]
    flat = InsertionBatch(
        origins=ib.origins.reshape(slots, 3),
        points=ib.points.reshape((slots,) + ib.points.shape[2:]),
        masks=ib.masks.reshape(slots, -1),
        hi_masks=ib.hi_masks.reshape(slots, -1),
    )
    return sm._replace(**write_insertion_batch(
        sm.high_values, sm.low_values, sm.high_brick, flat, cfg.submaps,
        low_brick=sm.low_brick, dense_dropped=sm.dense_dropped))


def frontend_lanes(state: FrontendState, scan: ScanInput, cfg: TrajectoryBuilderConfig, fuse_fn=None):
    """The frontend `step` over B lanes with its grid writes deferred:
    the insertion comes back in `ScanResult.insertion_batch` (B, 2, ·)."""
    if cfg.use_online_correlative_scan_matching:
        raise ValueError("the batched run has no online correlative pre-search")
    shared = state.submaps
    lanes = state._replace(submaps=_over_lanes(
        functools.partial(apply_pending_spawn, cfg=cfg.submaps, defer_bank_clears=True),
        _lane_fields(shared)))
    with record_function("frontend.filter"):
        clouds = _over_lanes(functools.partial(filter_scan, cfg=cfg), lanes.pose, scan)
    submap_pose, bank_slot, initial_in_submap = _over_lanes(match_target, lanes.submaps,
                                                            clouds.prediction)
    with record_function("frontend.match"):
        result = match_scan(shared, clouds, bank_slot, initial_in_submap, cfg)
    pose_estimate = submap_pose.compose(result.pose)
    if fuse_fn is None:
        opt_pose, fuse_aux = pose_estimate, None
    else:
        opt_pose, fuse_aux = fuse_fn(pose_estimate)
    with record_function("frontend.insert"):
        new_submaps, new_mf, insert, finished, batch = _over_lanes(
            functools.partial(insert_scan, cfg=cfg, defer_grid_writes=True),
            lanes, scan.time, clouds, opt_pose)
    with record_function("frontend.histogram"):
        hist = compute_histogram(_over_lanes(histogram_points, clouds, opt_pose),
                                 clouds.filtered.mask, num_buckets=cfg.rotational_histogram_size)
    new_state, out = finish_step(lanes, scan, clouds, opt_pose, result,
                                 _with_banks(new_submaps, shared), new_mf, insert, finished, hist, batch)
    return new_state, (out if fuse_fn is None else (out, fuse_aux))


def batched_step(cfg: TrajectoryBuilderConfig):
    """The frontend step over B lanes: (state[B], scan[B]) -> (state[B],
    result[B]), the banks updated in place."""

    def run(state: FrontendState, scan: ScanInput) -> Tuple[FrontendState, ScanResult]:
        state = _clear_spawned(cfg, state)
        new_state, result = frontend_lanes(state, scan, cfg)
        return new_state._replace(submaps=write_flat_insertion(cfg, new_state.submaps,
                                                      result.insertion_batch)), result

    return run


def lio_lanes(state: LioState, inp: LioScanInput, cfg: TrajectoryBuilderConfig):
    """`lio_step` over B lanes with its grid writes deferred."""
    b = inp.points.shape[0]
    dev = inp.points.device
    noise = pre.noise_matrix(cfg.imu, dev)
    g_norm = cfg.imu.gravity
    with record_function("lio.preintegrate"):
        p0 = _over_lanes(pre.make_preintegrated, state.ba, state.bg, state.last_acc, state.last_gyr)
        preint = pre.integrate(p0, inp.imu_dts, inp.imu_acc, inp.imu_gyr, inp.imu_mask, noise)
        predicted = _over_lanes(functools.partial(pre.predict, gravity=g_norm), state.nav, preint)
    rel = state.nav.pose.inverse().compose(predicted.pose)
    if cfg.enable_gravity_factor:
        grav_dir, grav_ok = _over_lanes(functools.partial(_window_gravity, cfg=cfg), state.window)
    else:
        grav_dir = torch.tensor([0.0, 0.0, -1.0], dtype=torch.float32, device=dev).expand(b, 3)
        grav_ok = torch.zeros(b, dtype=torch.bool, device=dev)

    def fuse(pose_estimate):
        with record_function("lio.window"):
            return _over_lanes(functools.partial(fuse_window, cfg=cfg), state.window, preint,
                               predicted, pose_estimate, grav_dir, grav_ok, state.ba, state.bg)

    scan = ScanInput(time=inp.time, points=inp.points, times=inp.times, mask=inp.mask,
                     relative_prediction=rel)
    new_frontend, (result, (win, nav2, ba2, bg2, failed)) = frontend_lanes(
        state.frontend, scan, cfg, fuse_fn=fuse)
    last_acc, last_gyr = _over_lanes(imu_carry, inp.imu_acc, inp.imu_gyr, inp.imu_mask,
                                     state.last_acc, state.last_gyr)
    new_state = LioState(frontend=new_frontend, window=win, nav=nav2, ba=ba2, bg=bg2,
                         last_acc=last_acc, last_gyr=last_gyr,
                         failures=state.failures + failed.to(torch.int32))
    return new_state, LioResult(scan=result, velocity=nav2.velocity, ba=ba2, bg=bg2,
                                failed=failed, gravity_valid=grav_ok)


def batched_lio_body(cfg: TrajectoryBuilderConfig, batch: int):
    """The multi-sequence LIO step: (state[B], scans[B]) -> (state[B],
    results[B]), all B sequences' grid traffic in single flat calls."""

    def run(state: LioState, scans: LioScanInput) -> Tuple[LioState, LioResult]:
        if scans.points.shape[0] != batch or state.frontend.submaps.lane.shape[0] != batch:
            raise ValueError(f"batched step of {batch} lanes given {scans.points.shape[0]} scans "
                             f"and {state.frontend.submaps.lane.shape[0]} lanes")
        state = clear_spawned_slots(cfg, state)
        new_state, results = lio_lanes(state, scans, cfg)
        fe = new_state.frontend
        fe = fe._replace(submaps=write_flat_insertion(cfg, fe.submaps, results.scan.insertion_batch))
        return new_state._replace(frontend=fe), results

    return run


def make_batched_lio_step(cfg: TrajectoryBuilderConfig, batch: int):
    """The multi-sequence LIO step; the banks are updated in place (the
    JAX package donates them to the same effect)."""
    return batched_lio_body(cfg, batch)


def make_batched_lio_chunk(cfg: TrajectoryBuilderConfig, batch: int, chunk: int):
    """`chunk` consecutive batched steps per call, over a sequence of
    B-stacked scans (the port's counterpart of the JAX package's
    `lax.scan`, as `frontend/lio.py::run_lio_chunk` is)."""
    body = batched_lio_body(cfg, batch)

    def run(state: LioState, scans: Sequence[LioScanInput]) -> Tuple[LioState, List[LioResult]]:
        if len(scans) != chunk:
            raise ValueError(f"chunk of {chunk} steps given {len(scans)} scans")
        results = []
        for scan in scans:
            state, res = body(state, scan)
            results.append(res)
        return state, results

    return run
