"""The slice as a whole: the port's `lio_step` against the JAX package's,
from one `interop`-converted state, over six scans of the synthetic
corkscrew with the bench's IMU recipe at a reduced two-brick config.

The run crosses a submap spawn (num_range_data 2) and then inserts into
both active submaps. Held per scan: pose within 2e-3 (m, and quaternion
components), equal `inserted` flags, matcher iterations, failure flags,
brick counts, epochs and drop gauges (all zero). The two packages' f32
solves round apart (see tests/test_torch_window.py), so a few grid cells
near a ray's end can round into a neighbour: the share of differing pool
cells is reported and must stay under 0.1% of the touched cells.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dliom_tpu.common.config import load_config as j_load_config
from dliom_tpu.frontend.lio import LioScanInput as JScan
from dliom_tpu.frontend.lio import lio_step as j_lio_step
from dliom_tpu.frontend.lio import make_lio_state as j_make_lio_state
from dliom_tpu.imu import preintegration as JP
from dliom_tpu_torch.common.config import load_config as t_load_config
from dliom_tpu_torch.frontend.lio import lio_step as t_lio_step
from dliom_tpu_torch.interop import lio_scan_input_from_numpy, lio_state_from_numpy, lio_state_to_numpy
from dliom_tpu_torch.io.synthetic import SyntheticWorld, corkscrew_trajectory
from dliom_tpu_torch.sensor.types import pad_point_cloud
import torch_threads  # noqa: F401  (one torch thread per test process)

G = 9.80511
POSE_ATOL = 2e-3
OVERRIDES = {
    "trajectory_builder": {
        "scan_period": 0.1,
        "voxel_filter_size": 0.3,
        "enable_gravity_factor": False,
        "submaps": {
            "high_resolution": 0.1,
            "high_resolution_max_range": 30.0,
            "low_resolution": 0.45,
            "num_range_data": 2,
            "use_brick_grid": True,
            "brick_dir_extent": 96,
            "brick_max_bricks": 16384,
            # two active submaps each touch ~440 high / ~90 low groups
            "brick_apply_groups": 1024,
            "dense_apply_groups": 256,
            "high_resolution_extent": 128,
            "low_resolution_extent": 64,
            "use_brick_grid_low": True,
            "low_brick_dir_extent": 24,
            "low_brick_max_bricks": 4096,
            "low_brick_apply_groups": 384,
            "low_brick_apply_group_bricks": 8,
        },
        "max_raw_points": 32768,
        "max_filtered_points": 2048,
        "max_high_res_points": 256,
        "max_low_res_points": 256,
        "max_imu_per_scan": 48,
        "window_size": 4,
        "gn_iterations": 2,
        "ceres_scan_matcher": {"max_num_iterations": 4, "function_tolerance": 1e-3},
    }
}
NUM_POINTS = 4096


def _scans():
    """Six scans: two at rest, four on the corkscrew; bench IMU recipe."""
    world = SyntheticWorld.create(num_beams=8, num_azimuths=200)
    rng = np.random.default_rng(0)
    out = []
    for t, pose in corkscrew_trajectory()[3:9]:
        pts, times = world.cast_scan(pose)
        cloud = pad_point_cloud(pts, times, NUM_POINTS)
        accs = np.tile(np.array([0, 0, G], np.float32), (48, 1))
        accs += rng.normal(0, 0.01, accs.shape).astype(np.float32)
        out.append(JScan(
            time=np.float32(t), points=cloud.points, times=cloud.times, mask=cloud.mask,
            imu_dts=np.full(48, 0.0025, np.float32), imu_acc=accs,
            imu_gyr=rng.normal(0, 0.002, (48, 3)).astype(np.float32),
            imu_mask=np.arange(48) < 40,
        ))
    return out


@pytest.fixture(scope="module")
def runs():
    j_cfg = j_load_config("basic", OVERRIDES).trajectory_builder
    t_cfg = t_load_config("basic", OVERRIDES).trajectory_builder
    jstate = j_make_lio_state(j_cfg, JP.NavState.identity(), jnp.zeros(3), jnp.zeros(3))
    tstate = lio_state_from_numpy(jax.tree.map(np.asarray, jstate), torch.device("cpu"))
    step = jax.jit(functools.partial(j_lio_step, cfg=j_cfg))
    per_scan = []
    for scan in _scans():
        jstate, jres = step(jstate, jax.tree.map(jnp.asarray, scan))
        tstate, tres = t_lio_step(tstate, lio_scan_input_from_numpy(scan, torch.device("cpu")), t_cfg)
        per_scan.append((jax.tree.map(np.asarray, jres), lio_state_to_numpy(tres)))
    return per_scan, jax.tree.map(np.asarray, jstate), lio_state_to_numpy(tstate)


def test_poses_and_flags_per_scan(runs):
    per_scan, _, _ = runs
    worst = max(float(np.abs(tr.scan.local_pose.translation - jr.scan.local_pose.translation).max())
                for jr, tr in per_scan)
    print(f"largest per-scan translation difference: {worst:.2e} m")
    for k, (jr, tr) in enumerate(per_scan):
        np.testing.assert_allclose(tr.scan.local_pose.translation, jr.scan.local_pose.translation,
                                   atol=POSE_ATOL, err_msg=f"scan {k}")
        np.testing.assert_allclose(tr.scan.local_pose.rotation, jr.scan.local_pose.rotation,
                                   atol=POSE_ATOL, err_msg=f"scan {k}")
        np.testing.assert_allclose(tr.velocity, jr.velocity, atol=10 * POSE_ATOL, err_msg=f"scan {k}")
        for f in ("inserted", "finished_submap", "matcher_iterations", "num_hits",
                  "insertion_submap_ids"):
            np.testing.assert_array_equal(getattr(tr.scan, f), getattr(jr.scan, f), err_msg=f"{f} {k}")
        assert bool(tr.failed) == bool(jr.failed) is False
        assert np.isfinite(tr.scan.histogram).all()
    assert sum(bool(tr.scan.inserted) for _, tr in per_scan) >= 3


def test_map_state(runs):
    _, js, ts = runs
    jsm, tsm = js.frontend.submaps, ts.frontend.submaps
    assert int(tsm.num_created) == int(jsm.num_created) == 2  # crossed a spawn
    np.testing.assert_array_equal(tsm.num_range_data, jsm.num_range_data)
    np.testing.assert_array_equal(tsm.dense_dropped, jsm.dense_dropped)
    for name in ("high_brick", "low_brick"):
        jb, tb = getattr(jsm, name), getattr(tsm, name)
        for f in ("counts", "epochs", "dropped"):
            np.testing.assert_array_equal(getattr(tb, f), getattr(jb, f), err_msg=f"{name}.{f}")
        assert int(tb.dropped[0]) == 0
        touched = (jb.pool != 0) | (tb.pool != 0)
        share = float(np.sum(jb.pool != tb.pool)) / max(int(touched.sum()), 1)
        print(f"{name}: {share:.2e} of {int(touched.sum())} touched pool cells differ")
        assert share < 1e-3, (name, share)
    np.testing.assert_allclose(ts.window.p, js.window.p, atol=POSE_ATOL)
    assert int(ts.failures) == int(js.failures) == 0
