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
spawn clears and the flat insert, and the window Gauss-Newton, K3 over the
(B, W, ...) window). The pure-torch stages between them (the prediction,
deskew and voxel filters, the window's key push and finish, the gravity
estimate, the motion filter and the insertion's bookkeeping) run under
`torch.func.vmap`, whose batched ops launch once for all lanes (a voxel
filter's sort is one sort of B rows). No stage loops over lanes on the
host, so the launches of a step do not grow with B.

The online correlative pre-search, where the config enables it, scores
every lane's lattice against its own front-submap slot in one call
(`local_trajectory_builder.correlative_match`), its candidate chunks sized
from the shapes alone, so the batched step still captures.

K1's capacities (`apply_groups`) are per call, so at B lanes one call
holds every lane's touched groups: a run without drops scales them by B.

Sharding over a mesh (:311-411, `common/mesh.py`): each of the D shards
owns batch/D sequences with their own flat banks on its own device, and
their lanes restart at 0 on every shard (`make_sharded_lio_state`), as in
the JAX package. `sharded_lio_step` and the frontend's `sharded_step`
hold one compiled batched step per shard; a call queues every shard's
input copy and step from the one calling thread (forward-mode AD is
process-global) with no host wait in between, so the devices run at
once. The hot loop has no cross-device traffic. State and results are
lists of per-shard trees; `gather` reads them as the JAX package's global
arrays (a dense grouped bank keeps one padding group per shard).
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch
from torch.func import vmap
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from dliom_tpu_torch.common import mesh as _mesh
from dliom_tpu_torch.common.config import TrajectoryBuilderConfig
from dliom_tpu_torch.common.device import constant, get_device
from dliom_tpu_torch.common.graph import StepGraph, sum_counts
from dliom_tpu_torch.common.stages import stage
from dliom_tpu_torch.common.mesh import Mesh, gather, make_mesh  # noqa: F401  (the JAX package's names)
from dliom_tpu_torch.frontend.lio import (
    LioResult,
    LioScanInput,
    LioState,
    _window_gravity,
    bank_leaves,
    chunk_body,
    finish_window,
    frontend_bank_leaves,
    imu_carry,
    make_lio_state,
    push_window,
)
from dliom_tpu_torch.frontend.local_trajectory_builder import (
    FrontendState,
    ScanInput,
    ScanResult,
    correlative_match,
    filter_scan,
    finish_step,
    histogram_points,
    insert_scan,
    make_initial_state,
    match_scan,
    match_target,
)
from dliom_tpu_torch.imu import preintegration as pre
from dliom_tpu_torch.imu import window_optimizer as wo
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
    shared = state.submaps
    lanes = state._replace(submaps=_over_lanes(
        functools.partial(apply_pending_spawn, cfg=cfg.submaps, defer_bank_clears=True),
        _lane_fields(shared)))
    with stage("frontend.filter"):
        clouds = _over_lanes(functools.partial(filter_scan, cfg=cfg), lanes.pose, scan)
    submap_pose, bank_slot, initial_in_submap = _over_lanes(match_target, lanes.submaps,
                                                            clouds.prediction)
    if cfg.use_online_correlative_scan_matching:
        with stage("frontend.correlative"):
            initial_in_submap = correlative_match(shared, clouds, bank_slot, initial_in_submap, cfg)
    with stage("frontend.match"):
        result = match_scan(shared, clouds, bank_slot, initial_in_submap, cfg)
    pose_estimate = submap_pose.compose(result.pose)
    if fuse_fn is None:
        opt_pose, fuse_aux = pose_estimate, None
    else:
        opt_pose, fuse_aux = fuse_fn(pose_estimate)
    with stage("frontend.insert"):
        new_submaps, new_mf, insert, finished, batch = _over_lanes(
            functools.partial(insert_scan, cfg=cfg, defer_grid_writes=True),
            lanes, scan.time, clouds, opt_pose)
    with stage("frontend.histogram"):
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
        with stage("frontend.insert"):
            submaps = write_flat_insertion(cfg, new_state.submaps, result.insertion_batch)
        return new_state._replace(submaps=submaps), result

    return run


def window_lanes(window, preint, predicted, pose_estimate, grav_dir, grav_ok, ba, bg,
                 cfg: TrajectoryBuilderConfig):
    """`fuse_window` over B lanes: the pushes under vmap, one Gauss-Newton
    over the (B, W, ...) window (one K3 launch on the card), the finish
    under vmap."""
    win = _over_lanes(functools.partial(push_window, cfg=cfg), window, preint, predicted,
                      pose_estimate, grav_dir, grav_ok)
    win = wo.optimize(win, cfg.imu, cfg.imu.gravity, iterations=cfg.gn_iterations)
    return _over_lanes(functools.partial(finish_window, cfg=cfg), win, predicted, ba, bg)


def lio_lanes(state: LioState, inp: LioScanInput, cfg: TrajectoryBuilderConfig):
    """`lio_step` over B lanes with its grid writes deferred."""
    b = inp.points.shape[0]
    dev = inp.points.device
    noise = pre.noise_matrix(cfg.imu, dev)
    g_norm = cfg.imu.gravity
    with stage("lio.preintegrate"):
        p0 = _over_lanes(pre.make_preintegrated, state.ba, state.bg, state.last_acc, state.last_gyr)
        preint = pre.integrate(p0, inp.imu_dts, inp.imu_acc, inp.imu_gyr, inp.imu_mask, noise)
        predicted = _over_lanes(functools.partial(pre.predict, gravity=g_norm), state.nav, preint)
    rel = state.nav.pose.inverse().compose(predicted.pose)
    if cfg.enable_gravity_factor:
        grav_dir, grav_ok = _over_lanes(functools.partial(_window_gravity, cfg=cfg), state.window)
    else:
        grav_dir = constant([0.0, 0.0, -1.0], device=dev).expand(b, 3)
        grav_ok = torch.zeros(b, dtype=torch.bool, device=dev)

    def fuse(pose_estimate):
        with stage("lio.window"):
            return window_lanes(state.window, preint, predicted, pose_estimate, grav_dir, grav_ok,
                                state.ba, state.bg, cfg)

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
        with stage("frontend.insert"):
            fe = fe._replace(submaps=write_flat_insertion(cfg, fe.submaps, results.scan.insertion_batch))
        return new_state._replace(frontend=fe), results

    return run


def make_batched_lio_step(cfg: TrajectoryBuilderConfig, batch: int) -> StepGraph:
    """The compiled multi-sequence LIO step (the JAX package jits it with
    the state donated): one CUDA graph replay per batched step on the card,
    the banks updated in place, state and results in the graph's buffers
    (`frontend/lio.py::make_jit_lio_step`)."""
    return StepGraph(batched_lio_body(cfg, batch), adopt=bank_leaves)


def make_batched_lio_chunk(cfg: TrajectoryBuilderConfig, batch: int, chunk: int) -> StepGraph:
    """The compiled chunk of `chunk` batched steps, one replay per call:
    scans' leaves carry a leading (chunk, B, ...) axis, and so do the
    results (the JAX package's `lax.scan` in one dispatch)."""
    return StepGraph(chunk_body(batched_lio_body(cfg, batch), chunk), adopt=bank_leaves)


# ----- sharding over a mesh (dliom_tpu/parallel/batch.py:311-411) -----


def _local_batch(batch: int, mesh: Mesh) -> int:
    if batch % mesh.size:
        raise ValueError(f"a batch of {batch} sequences does not divide over the {mesh.size} shards "
                         f"of mesh axis {mesh.axis!r}")
    return batch // mesh.size


def _rebase_lanes(state):
    """A shard of a batched state with its lanes numbered from 0 (the
    shard's banks hold only its own lanes' slots)."""
    fe = state.frontend if isinstance(state, LioState) else state
    sm = fe.submaps
    fe = fe._replace(submaps=sm._replace(lane=torch.arange(sm.lane.shape[0], dtype=torch.int32,
                                                             device=sm.lane.device)))
    return state._replace(frontend=fe) if isinstance(state, LioState) else fe


def shard_over_mesh(tree, mesh: Mesh) -> list:
    """`common/mesh.py::shard_over_mesh`: per-shard copies of a batched
    tree's leading (lane) axis. A batched state's flat banks split with its
    lanes (2 slots each), and each shard's lanes restart at 0. A dense bank
    on the grouped path ends in one padding group and does not split so:
    make such shards with `make_sharded_lio_state`."""
    shards = _mesh.shard_over_mesh(tree, mesh)
    if isinstance(tree, (LioState, FrontendState)):
        shards = [_rebase_lanes(s) for s in shards]
    return shards


def make_sharded_lio_state(cfg: TrajectoryBuilderConfig, batch: int, mesh: Mesh) -> list:
    """Per shard, `make_batched_lio_state` of batch/D lanes on the shard's
    device: each shard owns its sequences with their own flat banks, lanes
    from 0. Gathered, it equals the JAX package's sharded state."""
    local = _local_batch(batch, mesh)
    return [make_batched_lio_state(cfg, local, dev) for dev in mesh.devices]


class ShardedStep:
    """One compiled step per shard of a mesh (a `StepGraph` on the shard's
    device), called as `(states, inputs) -> (states, results)` over lists
    of per-shard trees; an input that is one batched tree (not a list) is
    split over the mesh first. Each call runs the shards in shard order
    from the calling thread and waits for none of them. The states and
    results it returns are the graphs' buffers: shard k's next step
    rewrites its state in place (the banks, adopted, and every other leaf)
    and its result, so a caller that keeps any of them across a step
    clones it first."""

    def __init__(self, steps, mesh: Mesh):
        self.steps = list(steps)
        self.mesh = mesh

    def __call__(self, states, inputs):
        if not isinstance(inputs, list):
            inputs = _mesh.shard_over_mesh(inputs, self.mesh)
        if len(states) != self.mesh.size or len(inputs) != self.mesh.size:
            raise ValueError(f"{len(states)} states and {len(inputs)} inputs for {self.mesh.size} shards")
        outs = [step(st, inp) for step, st, inp in zip(self.steps, states, inputs)]
        return [o[0] for o in outs], [o[1] for o in outs]

    def counts(self):
        """The shards' StepGraph counts, summed (`common/graph.py`)."""
        return sum_counts(self.steps)


def sharded_lio_step(cfg: TrajectoryBuilderConfig, batch: int, mesh: Mesh) -> ShardedStep:
    """The compiled batched LIO step of batch/D lanes on every shard
    (`make_batched_lio_step`: one CUDA graph per shard on the card), the
    banks updated in place on their shard's device. State and results of a
    shard are its graph's buffers, rewritten by its next step."""
    local = _local_batch(batch, mesh)
    return ShardedStep((make_batched_lio_step(cfg, local) for _ in mesh.devices), mesh)


def sharded_step(cfg: TrajectoryBuilderConfig, mesh: Mesh) -> ShardedStep:
    """The compiled frontend `batched_step` on every shard of the mesh (one
    CUDA graph per shard on the card; the JAX package jits it,
    dliom_tpu/parallel/batch.py:396-411), over per-shard states
    (`shard_over_mesh(make_batched_state(...), mesh)`, or
    `make_batched_state` of batch/D lanes per shard where a dense grouped
    bank, which ends in one padding group, does not split), the banks
    updated in place on their shard's device. State and results of a shard are its
    graph's buffers, rewritten by its next step."""
    return ShardedStep((StepGraph(batched_step(cfg), adopt=frontend_bank_leaves) for _ in mesh.devices), mesh)
