"""tools/torch_long_course.py against tools/long_course.py.

- `course_pose` at 50 times across the speed ramp and all four segments of
  the stadium, `CourseWorld` (its features and rays), `cast_scan` at three
  poses and `course_overrides()` are bit-identical to the JAX tool's.
- One generation per package at laps 0.015, seed 5: the two .npz files are
  equal key for key, bit for bit. The port's file then feeds the strapdown
  IMU-consistency check of tests/test_long_course.py (max error < 1.0 m)
  and the port's runner on the CPU through the tool's `replay`, at that
  test's small overrides and under its assertions.
- `evaluate_constraints` on a JAX graph with INTER constraints (a correct
  and a wrong one) and revisit pairs (hit and missed) equals the port's on
  the same graph carried across (tests/test_torch_serialization.py).
- The tool runs on the card unless told otherwise, and imports no JAX.
"""

import importlib.util
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dliom_tpu.backend.pose_graph import Constraint as JConstraint
from dliom_tpu.backend.pose_graph import PoseGraph as JPoseGraph
from dliom_tpu.transform.rigid import Rigid3 as JRigid3
from test_multi_trajectory import _grids
from test_pose_graph import _cfg, _make_node, _world_cloud
from test_torch_serialization import carried_graph
import torch_threads  # noqa: F401  (one torch thread per test process)

ROOT = Path(__file__).resolve().parents[1]
PORT_TOOL = ROOT / "tools" / "torch_long_course.py"
JAX_TOOL = ROOT / "tools" / "long_course.py"
LAPS, SEED = 0.015, 5
SMALL_OVERRIDES = {  # tests/test_long_course.py:86-117
    "trajectory_builder": {
        "scan_period": 0.1,
        "min_range": 1.0,
        "max_range": 50.0,
        "voxel_filter_size": 0.4,
        "frames_for_static_initialization": 8,
        "enable_ndt_initialization": False,
        "enable_gravity_factor": False,
        "motion_filter": {"max_time_seconds": 0.2, "max_distance_meters": 0.1, "max_angle_radians": 0.004},
        "submaps": {"high_resolution": 0.3, "high_resolution_max_range": 30.0, "low_resolution": 0.9,
                    "num_range_data": 8, "high_resolution_extent": 128, "low_resolution_extent": 64},
        "max_filtered_points": 4096,
        "max_high_res_points": 512,
        "max_low_res_points": 512,
        "window_size": 4,
        "gn_iterations": 2,
        "ceres_scan_matcher": {"max_num_iterations": 6},
    },
    "pose_graph": {"optimize_every_n_nodes": 0, "constraint_builder": {"every_nodes_to_find_constraint": 4}},
}


def load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tools():
    return load(PORT_TOOL, "torch_long_course"), load(JAX_TOOL, "jax_long_course")


@pytest.fixture(scope="module")
def generated(tools, tmp_path_factory):
    port, jt = tools
    d = tmp_path_factory.mktemp("course")
    paths = str(d / "port.npz"), str(d / "jax.npz")
    return paths, port.generate(paths[0], LAPS, SEED), jt.generate(paths[1], LAPS, SEED)


def test_course_world_and_overrides_bit_identical(tools):
    port, jt = tools
    period = jt._perimeter() / jt.SPEED
    taus = np.concatenate([np.linspace(0.0, jt.T_RAMP, 6), np.linspace(jt.T_RAMP + 0.1, period + jt.T_RAMP, 44)])
    segments = set()
    for tau in taus:
        (qa, pa), (qb, pb) = port.course_pose(tau), jt.course_pose(tau)
        np.testing.assert_array_equal(qa, qb)
        np.testing.assert_array_equal(pa, pb)
        segments.add(int(np.searchsorted(np.cumsum([jt.STRAIGHT, np.pi * jt.RADIUS, jt.STRAIGHT]),
                                          jt._arclength(tau) % jt._perimeter(), side="right")))
    assert segments == {0, 1, 2, 3}
    wa, wb = port.CourseWorld(), jt.CourseWorld()
    for f in ("centers", "radii", "dirs"):
        np.testing.assert_array_equal(getattr(wa, f), getattr(wb, f))
    for tau in (0.0, 50.0, 100.0):
        q, p = jt.course_pose(tau)
        a, b = wa.cast_scan(q, p), wb.cast_scan(q, p)
        assert a.dtype == b.dtype == np.float32 and len(a) > 1000
        np.testing.assert_array_equal(a, b)
    assert port.course_overrides() == jt.course_overrides()


def test_generated_datasets_bit_identical(generated):
    (pa, pb), ga, gb = generated
    for x, y in zip(ga, gb, strict=True):
        np.testing.assert_array_equal(x, y)
    a, b = np.load(pa), np.load(pb)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _qmat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _qmul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2, w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2, w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2])


def test_generated_imu_consistent_with_ground_truth(tools, generated):
    """tests/test_long_course.py's strapdown check on the port's dataset:
    integrating its IMU from the first true state tracks the true positions."""
    port, _ = tools
    (path, _), (gt_t, gt_q, gt_p), _ = generated
    z = np.load(path)
    t_imu, acc, gyr = z["imu/times"], z["imu/acc"].astype(np.float64), z["imu/gyr"].astype(np.float64)
    q, p, v = gt_q[0].astype(np.float64), gt_p[0].astype(np.float64).copy(), np.zeros(3)
    gw = np.array([0.0, 0.0, -port.G])
    prev_t, max_err, gi = gt_t[0], 0.0, 1
    for i in range(int(np.searchsorted(t_imu, gt_t[0], side="right")), len(t_imu)):
        dt = t_imu[i] - prev_t
        prev_t = t_imu[i]
        w = gyr[i] * dt
        th = np.linalg.norm(w)
        dq = np.array([np.cos(th / 2), *(np.sin(th / 2) * w / th)]) if th > 1e-12 else np.array([1.0, *(0.5 * w)])
        a_w = _qmat(q) @ acc[i] + gw
        q = _qmul(q, dq)
        q /= np.linalg.norm(q)
        v = v + a_w * dt
        p = p + v * dt + 0.5 * a_w * dt * dt
        while gi < len(gt_t) and gt_t[gi] <= t_imu[i] + 1e-9:
            max_err = max(max_err, float(np.linalg.norm(p - gt_p[gi])))
            gi += 1
    assert gi == len(gt_t) and max_err < 1.0, max_err


def test_runner_reports_pre_optimization_and_latency(tools, generated):
    """tests/test_long_course.py::test_runner_reports_pre_optimization_and_latency
    on the port, through the tool's `replay` on the CPU."""
    port, _ = tools
    (path, _), gt, _ = generated
    captured = {}

    def on_builder(builder, report):
        captured.update(port.evaluate_constraints(builder, gt))
        captured["n_lat"] = len(builder.pose_graph.constraint_search_seconds)

    report = port.replay(path, "cpu", SMALL_OVERRIDES, on_builder=on_builder)
    assert "pre_optimization_ate_rmse_m" in report and "ate_rmse_m" in report
    assert report["num_submaps"] >= 2
    assert captured["n_lat"] >= 1
    assert report["constraint_search_latency_s"]["count"] == captured["n_lat"]
    assert report["pre_optimization_ate_rmse_aligned_m"] < 0.5
    assert "constraint_precision" in captured and "revisit_recall" in captured


def jax_loop_graph(radius=8.0):
    """A JAX graph on a 10-node loop, 10 s apart, on a circle of `radius`
    (yaw along it), whose local poses drift: nodes 8 and 9 revisit the
    places of nodes 0 and 1. Submaps of two nodes each, the first four
    finished; INTER constraints from node 8 to submap 0 (the true relative
    pose) and node 9 to submap 0 (2 m off), with yaw corrections. Every
    node sees the same cloud and every finished submap holds it. Returns
    (cfg, graph, ground truth (times, quats, positions), cloud)."""
    cfg = _cfg()
    pg = JPoseGraph(cfg.pose_graph, cfg.trajectory_builder)
    points = _world_cloud(np.random.default_rng(21), 300)
    grids = _grids(cfg, points)
    times = 10.0 * np.arange(10)
    th = 2 * np.pi * np.arange(10) / 8
    gt_q = np.stack([np.cos(th / 2), 0 * th, 0 * th, np.sin(th / 2)], -1)
    gt_p = np.stack([radius * np.sin(th), radius * (1 - np.cos(th)), 0 * th], -1)
    for k in range(10):
        yaw = th[k] + 0.01 * k
        local = JRigid3(jnp.asarray([np.cos(yaw / 2), 0, 0, np.sin(yaw / 2)], jnp.float32),
                        jnp.asarray(gt_p[k] + np.array([0.05, -0.03, 0.01]) * k, jnp.float32))
        if k % 2 == 0:
            sid = pg.add_submap(local)
        node = _make_node(cfg, points, local)
        node.time = float(times[k])
        pg.add_node(node, (sid,))
        if k % 2 == 1 and sid < 4:
            pg.finish_submap(sid, *grids)
    lc = load(JAX_TOOL, "jax_long_course_graph")
    for nid, off, dyaw in ((8, 0.0, 0.01), (9, 2.0, 0.2)):
        q, p = lc._np_rigid_inv_compose(gt_q[0], gt_p[0], gt_q[nid], gt_p[nid])
        pg.constraints.append(JConstraint(
            submap_id=0, node_id=nid, relative=JRigid3(jnp.asarray(q, jnp.float32),
                                                        jnp.asarray(p + off, jnp.float32)),
            translation_weight=1.0, rotation_weight=1.0, tag="INTER", score=0.6, yaw_correction=dyaw))
    return cfg, pg, (times, gt_q, gt_p), points


def carried_with_inter(jpg):
    """The port's graph holding `jpg`'s records, INTER scores and yaw
    corrections included."""
    pg = carried_graph(jpg)
    for a, b in zip(jpg.constraints, pg.constraints, strict=True):
        b.score, b.yaw_correction = a.score, a.yaw_correction
    return pg


def test_evaluate_constraints_equals_jax_on_a_carried_graph(tools):
    port, jt = tools
    _, jpg, gt, _ = jax_loop_graph()
    want = jt.evaluate_constraints(SimpleNamespace(pose_graph=jpg), gt)
    got = port.evaluate_constraints(SimpleNamespace(pose_graph=carried_with_inter(jpg)), gt)
    assert got == want
    assert want["num_inter"] == 2 and want["constraint_precision"] == 0.5
    assert want["revisit_opportunities"] >= 3 and 0 < want["revisit_recall"] < 1
    assert want["yaw_correction_rad"]["frac_beyond_half_fan"] == 0.5


def test_cuda_without_a_card_raises(tools, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tools[0].main(["--laps", "0.01"])


def test_imports_no_jax():
    code = (f"import importlib.util, sys; s = importlib.util.spec_from_file_location('t', {str(PORT_TOOL)!r}); "
            "m = importlib.util.module_from_spec(s); s.loader.exec_module(m); "
            "print(sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'dliom_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True, cwd=ROOT)
    assert out.stdout.strip() == "[]"
