"""Batched multi-sequence mapping (dliom_tpu_torch/parallel/batch.py) on
the CPU, where K1 and K2 run their plain versions:

(a) the port's `make_batched_lio_step` against the JAX package's, B = 2,
    five scans, at a brick and at a dense-grouped config, from the same
    initial state (the port's `make_batched_lio_state` equals JAX's);
(b) the port's batched step against its own `lio_step` per lane, lanes
    that spawn on different steps (lane 1's first scan is empty), with the
    gravity factor off and on, and its flat 2B-slot insert against each
    lane's own 2-slot insert of the same InsertionBatch;
(c) `make_batched_state` / `batched_step` (the frontend alone) against the
    JAX package's at B = 4 (tests/test_parallel.py's frontend config);
(d) the batched LM matcher: lanes that converge on different iterations
    each equal their own single `match`.

Integer bank state is held bit for bit. Poses: within POSE_ATOL of JAX
(tests/test_torch_lio.py) and 2e-4 of the single-sequence port
(tests/test_parallel.py holds JAX's batched run to its single runs so).

Once the course moves, the two packages' f32 solves round apart
(tests/test_torch_window.py) and the run is chaotic: at the brick config,
from the corkscrew's pose 3 over IMU seeds 0-3, the lane poses part from
JAX by 3e-4 to 9e-3 m within five scans and up to 6% of the touched pool
cells differ (a cell near a ray's end rounds into a neighbour). So
(a) runs each config on a course where its lanes agree with JAX and holds
the banks bit for bit: brick from pose 2 with seed 1 (four scans at rest,
then the corkscrew's first 0.2 m; within 1e-7 m of JAX), dense from pose
3 with seed 0 (three scans at rest, then two moving).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dliom_tpu.common.config import load_config as j_load_config
from dliom_tpu.frontend.lio import LioScanInput as JScan
from dliom_tpu.frontend.local_trajectory_builder import ScanInput as JFrontScan
from dliom_tpu.parallel import batch as JB
from dliom_tpu_torch.common.config import load_config as t_load_config
from dliom_tpu_torch.frontend.lio import lio_step, make_lio_state
from dliom_tpu_torch.frontend.local_trajectory_builder import ScanInput
from dliom_tpu_torch.imu.preintegration import NavState
from dliom_tpu_torch.interop import lio_scan_input_from_numpy, lio_state_from_numpy, to_numpy
from dliom_tpu_torch.io.synthetic import SyntheticWorld, corkscrew_trajectory
from dliom_tpu_torch.mapping import brick_grid as TB
from dliom_tpu_torch.mapping.grid import GridSpec, set_cells
from dliom_tpu_torch.mapping.submap import InsertionBatch, write_insertion_batch
from dliom_tpu_torch.ops.scan_matcher import match
from dliom_tpu_torch.parallel import batch as TBatch
from dliom_tpu_torch.sensor.types import pad_point_cloud
from dliom_tpu_torch.transform.rigid import Rigid3

G = 9.80511
POSE_ATOL = 2e-3
LANE_ATOL = 2e-4
B = 2
NUM_POINTS = 2048
CPU = torch.device("cpu")


def _overrides(brick: bool, gravity: bool = False):
    sub = {"high_resolution": 0.2, "high_resolution_max_range": 20.0, "low_resolution": 0.5,
           "num_range_data": 2, "high_resolution_extent": 64, "low_resolution_extent": 32}
    if brick:
        sub.update({"use_brick_grid": True, "brick_dir_extent": 16, "brick_max_bricks": 4096,
                    "brick_apply_groups": 512, "use_brick_grid_low": True,
                    "low_brick_dir_extent": 8, "low_brick_max_bricks": 512,
                    "low_brick_apply_groups": 256, "low_brick_apply_group_bricks": 8})
    else:
        sub["dense_apply_groups"] = 64
    return {"trajectory_builder": {
        "scan_period": 0.1, "voxel_filter_size": 0.3, "enable_gravity_factor": gravity,
        "frames_for_online_gravity_estimate": 3,
        "motion_filter": {"max_time_seconds": 0.0, "max_distance_meters": 0.0, "max_angle_radians": 0.0},
        "submaps": sub,
        "max_raw_points": NUM_POINTS, "max_filtered_points": 1024,
        "max_high_res_points": 256, "max_low_res_points": 256,
        "max_imu_per_scan": 16, "window_size": 3, "gn_iterations": 2,
        "ceres_scan_matcher": {"max_num_iterations": 4, "function_tolerance": 1e-3},
    }}


def _scans(n_scans=5, empty_first=1, start=3, seed=0):
    """B-stacked numpy scans of the corkscrew from its pose `start` with the
    bench IMU recipe (noise from `seed`); lane `empty_first`'s first scan
    has no points, so its map starts one scan later and it spawns on other
    steps than lane 0."""
    world = SyntheticWorld.create(num_beams=8, num_azimuths=200)
    course = corkscrew_trajectory()
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_scans):
        lanes = []
        for b in range(B):
            t, pose = course[start + i]
            cloud = pad_point_cloud(*world.cast_scan(pose), NUM_POINTS)
            mask = np.asarray(cloud.mask) & (i > 0 or b != empty_first)
            accs = np.tile(np.array([0, 0, G], np.float32), (16, 1))
            lanes.append(JScan(
                time=np.float32(0.1 * (i + 1)), points=np.asarray(cloud.points),
                times=np.asarray(cloud.times), mask=mask,
                imu_dts=np.full(16, 0.00625, np.float32),
                imu_acc=accs + rng.normal(0, 0.01, accs.shape).astype(np.float32),
                imu_gyr=rng.normal(0, 0.002, (16, 3)).astype(np.float32), imu_mask=np.arange(16) < 14))
        out.append(JScan(*(np.stack(x) for x in zip(*lanes))))
    return out


def _lane(tree, b):
    return type(tree)(*(None if x is None else x[b] for x in tree))


def _assert_banks_equal(t_sm, j_sm):
    """Every bank tensor bit for bit and the drop gauges zero."""
    for name in ("high_brick", "low_brick"):
        tb, jb = getattr(t_sm, name), getattr(j_sm, name)
        assert (tb is None) == (jb is None), name
        if tb is not None:
            for f in ("directory", "pool", "counts", "group_of_slot", "dropped", "epochs"):
                np.testing.assert_array_equal(getattr(tb, f), getattr(jb, f), err_msg=f"{name}.{f}")
            assert int(tb.dropped.sum()) == 0
            assert int((tb.pool != 0).sum()) > 0, name
    for name in ("high_values", "low_values", "dense_dropped"):
        np.testing.assert_array_equal(getattr(t_sm, name), getattr(j_sm, name), err_msg=name)
    assert int(t_sm.dense_dropped.sum()) == 0


@pytest.mark.parametrize("brick,start,seed", [(True, 2, 1), (False, 3, 0)], ids=["brick", "dense"])
def test_batched_lio_matches_jax(brick, start, seed):
    j_cfg = j_load_config("basic", _overrides(brick)).trajectory_builder
    t_cfg = t_load_config("basic", _overrides(brick)).trajectory_builder
    jstate = JB.make_batched_lio_state(j_cfg, B)
    tstate = TBatch.make_batched_lio_state(t_cfg, B, CPU)
    ref = lio_state_from_numpy(jax.tree.map(np.asarray, jstate), CPU)
    for a, b_ in zip(torch.utils._pytree.tree_leaves(tstate), torch.utils._pytree.tree_leaves(ref)):
        assert (a is None and b_ is None) or (a.dtype == b_.dtype and torch.equal(a, b_))
    jstep = JB.make_batched_lio_step(j_cfg, B)
    tstep = TBatch.make_batched_lio_step(t_cfg, B)
    spawned = set()
    for k, scan in enumerate(_scans(start=start, seed=seed)):
        jstate, jres = jstep(jstate, jax.tree.map(jnp.asarray, scan))
        tstate, tres = tstep(tstate, lio_scan_input_from_numpy(scan, CPU))
        jr, tr = jax.tree.map(np.asarray, jres), to_numpy(tres)
        np.testing.assert_allclose(tr.scan.local_pose.translation, jr.scan.local_pose.translation,
                                   atol=POSE_ATOL, err_msg=f"scan {k}")
        np.testing.assert_allclose(tr.scan.local_pose.rotation, jr.scan.local_pose.rotation,
                                   atol=POSE_ATOL, err_msg=f"scan {k}")
        for f in ("inserted", "finished_submap", "matcher_iterations", "num_hits", "insertion_submap_ids"):
            np.testing.assert_array_equal(getattr(tr.scan, f), getattr(jr.scan, f), err_msg=f"{f} {k}")
        assert not tr.failed.any()
        spawned |= {(b, k) for b in range(B) if tr.scan.finished_submap[b] >= 0}
    assert {b for b, _ in spawned} == {0, 1} and len({k for _, k in spawned}) >= 2, spawned
    js, ts = jax.tree.map(np.asarray, jstate), to_numpy(tstate)
    np.testing.assert_array_equal(ts.frontend.submaps.num_created, js.frontend.submaps.num_created)
    assert (ts.frontend.submaps.num_created == 3).any()  # a slot recycled
    _assert_banks_equal(ts.frontend.submaps, js.frontend.submaps)
    np.testing.assert_allclose(ts.window.p, js.window.p, atol=POSE_ATOL)


def _bank_copy(sm):
    return sm._replace(
        high_values=sm.high_values.clone(), low_values=sm.low_values.clone(),
        dense_dropped=sm.dense_dropped.clone(),
        high_brick=None if sm.high_brick is None else TB.BrickBank(*(x.clone() for x in sm.high_brick)),
        low_brick=None if sm.low_brick is None else TB.BrickBank(*(x.clone() for x in sm.low_brick)))


@pytest.mark.parametrize("gravity", [False, True], ids=["no_gravity", "gravity"])
def test_lanes_match_single_sequences(gravity):
    cfg = t_load_config("basic", _overrides(True, gravity)).trajectory_builder
    state = TBatch.make_batched_lio_state(cfg, B, CPU)
    singles = [make_lio_state(cfg, NavState.identity(CPU), torch.zeros(3), torch.zeros(3))
               for _ in range(B)]
    spawn_steps = {b: [] for b in range(B)}
    for k, scan in enumerate(_scans()):
        inp = lio_scan_input_from_numpy(scan, CPU)
        pre_batch = state
        # the batched body's three stages, with the flat insert held
        # against per-lane inserts of the same batch on copies
        state = TBatch.clear_spawned_slots(cfg, state)
        state, res = TBatch.lio_lanes(state, inp, cfg)
        before = _bank_copy(state.frontend.submaps)
        sm = TBatch.write_flat_insertion(cfg, state.frontend.submaps, res.scan.insertion_batch)
        state = state._replace(frontend=state.frontend._replace(submaps=sm))
        for b in range(B):
            if k == 3:  # lane b taken out of the batch steps as its own sequence did
                pre_step = TBatch.lane_state(cfg, pre_batch, b)
                for f in ("pose_rotation", "pose_translation", "num_range_data", "num_created"):
                    assert torch.equal(getattr(pre_step.frontend.submaps, f),
                                       getattr(singles[b].frontend.submaps, f)), f
            singles[b], one = lio_step(singles[b], _lane(inp, b), cfg)
            tr = res.scan.local_pose
            torch.testing.assert_close(tr.translation[b], one.scan.local_pose.translation,
                                       atol=LANE_ATOL, rtol=0)
            torch.testing.assert_close(tr.rotation[b], one.scan.local_pose.rotation,
                                       atol=LANE_ATOL, rtol=0)
            assert int(res.scan.matcher_iterations[b]) == int(one.scan.matcher_iterations)
            assert bool(res.scan.inserted[b]) == bool(one.scan.inserted)
            if int(res.scan.finished_submap[b]) >= 0 or bool(before.pending_spawn[b]):
                spawn_steps[b].append(k)
            lane = TBatch.lane_banks(cfg, before, b)
            ib = InsertionBatch(*(x[b] for x in res.scan.insertion_batch))
            out = write_insertion_batch(lane["high_values"], lane["low_values"], lane["high_brick"], ib,
                                        cfg.submaps, low_brick=lane["low_brick"])
            flat = TBatch.lane_banks(cfg, sm, b)
            for name in ("high_brick", "low_brick"):
                for f in ("directory", "pool", "counts", "group_of_slot", "epochs"):
                    assert torch.equal(getattr(out[name], f), getattr(flat[name], f)), (k, b, name, f)
                assert int(out[name].dropped) == 0
        assert int(sm.high_brick.dropped.sum()) == int(sm.low_brick.dropped.sum()) == 0
        if gravity:
            assert res.gravity_valid.shape == (B,)
    assert spawn_steps[0] and spawn_steps[1] and spawn_steps[0] != spawn_steps[1], spawn_steps
    assert state.frontend.submaps.num_created.tolist() == [int(s.frontend.submaps.num_created)
                                                            for s in singles]


def _frontend_cfg(lib):
    # tests/test_parallel.py::_cfg
    return lib("basic", {"trajectory_builder": {
        "min_range": 0.5, "max_range": 50.0, "voxel_filter_size": 0.2, "scan_period": 0.3,
        "ceres_scan_matcher": {"max_num_iterations": 6},
        "motion_filter": {"max_time_seconds": 0.0, "max_distance_meters": 0.0, "max_angle_radians": 0.0},
        "submaps": {"high_resolution": 0.25, "high_resolution_max_range": 50.0, "low_resolution": 0.8,
                    "num_range_data": 100, "high_resolution_extent": 96, "low_resolution_extent": 48},
        "max_filtered_points": 1024, "max_high_res_points": 512, "max_low_res_points": 512,
    }}).trajectory_builder


def test_batched_frontend_step_matches_jax():
    batch = 4
    j_cfg, t_cfg = _frontend_cfg(j_load_config), _frontend_cfg(t_load_config)
    world = SyntheticWorld.create(num_beams=4, num_azimuths=100)
    pts, times = [], []
    for b in range(batch):
        p, t = world.cast_scan(Rigid3(np.array([1.0, 0, 0, 0], np.float32),
                                      np.array([0.05 * b, -0.02 * b, 0.0], np.float32)))
        cloud = pad_point_cloud(p, t, 1024)
        pts.append(np.asarray(cloud.points))
        times.append(np.asarray(cloud.times))
    host = dict(time=np.full(batch, 0.3, np.float32), points=np.stack(pts), times=np.stack(times),
                mask=np.ones((batch, 1024), bool))
    ident = (np.tile(np.array([1.0, 0, 0, 0], np.float32), (batch, 1)), np.zeros((batch, 3), np.float32))
    import dliom_tpu.transform.rigid as JR
    jstate, jres = jax.jit(JB.batched_step(j_cfg))(
        JB.make_batched_state(j_cfg, batch),
        JFrontScan(**{k: jnp.asarray(v) for k, v in host.items()},
                   relative_prediction=JR.Rigid3(*(jnp.asarray(x) for x in ident))))
    tstate = TBatch.make_batched_state(t_cfg, batch, CPU)
    tstate, tres = TBatch.batched_step(t_cfg)(
        tstate, ScanInput(**{k: torch.from_numpy(v) for k, v in host.items()},
                          relative_prediction=Rigid3(*(torch.from_numpy(x) for x in ident))))
    js, jr = jax.tree.map(np.asarray, jstate), jax.tree.map(np.asarray, jres)
    np.testing.assert_allclose(tres.local_pose.translation.numpy(), jr.local_pose.translation, atol=POSE_ATOL)
    assert tres.inserted.all() and jr.inserted.all()
    for name in ("high_values", "low_values"):
        t_bank = getattr(tstate.submaps, name).numpy().reshape(batch, -1)  # the JAX (B, ·) layout
        np.testing.assert_array_equal(t_bank, getattr(js.submaps, name), err_msg=name)
    occupied = (tstate.submaps.high_values > 0).reshape(batch, -1).sum(1)
    assert bool((occupied > 100).all())


def test_batched_matcher_freezes_converged_lanes():
    """Four lanes from four initial offsets against one dense grid: they
    converge on different iterations (one runs to the limit), and each
    lane's pose and iteration count equal its own single `match`."""
    spec = GridSpec(0.1, 64)
    rng = np.random.default_rng(3)
    surface = np.concatenate([
        np.stack([rng.uniform(-2, 2, 400), rng.uniform(-2, 2, 400), np.full(400, -1.0)], 1),
        np.stack([np.full(400, 2.0), rng.uniform(-2, 2, 400), rng.uniform(-1, 1, 400)], 1),
        np.stack([rng.uniform(-2, 2, 400), np.full(400, 2.5), rng.uniform(-1, 1, 400)], 1)]).astype(np.float32)
    cells = torch.round(torch.from_numpy(surface) / spec.resolution).to(torch.int32)
    grid = set_cells(torch.zeros(2 * spec.num_cells, dtype=torch.int16), cells, 30000, spec)
    pts = torch.from_numpy(surface[::4].copy())
    mask = torch.ones(pts.shape[0], dtype=torch.bool)
    offsets = [(0.0, 0.0, 0.0), (0.02, -0.01, 0.01), (0.04, -0.03, 0.02), (0.08, 0.05, -0.04)]
    kw = dict(specs=[spec], occupied_space_weights=[1.0], translation_weight=0.1, rotation_weight=0.1,
              max_iterations=12, function_tolerance=1e-2)
    singles = []
    for o in offsets:
        init = Rigid3(torch.tensor([1.0, 0, 0, 0]), torch.tensor(o, dtype=torch.float32))
        singles.append(match(init, clouds=[(pts, mask)], grids=[grid], grid_bases=[0], **kw))
    n = len(offsets)
    init = Rigid3(torch.tensor([[1.0, 0, 0, 0]] * n), torch.tensor(offsets, dtype=torch.float32))
    out = match(init, clouds=[(pts.expand(n, -1, -1), mask.expand(n, -1))], grids=[grid],
                grid_bases=[torch.zeros(n, dtype=torch.int32)], **kw)
    iters = [int(s.iterations) for s in singles]
    assert len(set(iters)) > 1, iters  # the lanes converge on different iterations
    assert out.iterations.tolist() == iters
    for b, s in enumerate(singles):
        torch.testing.assert_close(out.pose.translation[b], s.pose.translation, atol=1e-6, rtol=0)
        torch.testing.assert_close(out.pose.rotation[b], s.pose.rotation, atol=1e-6, rtol=0)
        torch.testing.assert_close(out.cost[b], s.cost, atol=1e-6, rtol=1e-5)
