"""Parity of `MapBuilder` (dliom_tpu_torch/map_builder.py) with the JAX
package on tests/test_map_builder.py's `_config()` stream: static start,
static initialization, then a slow x-motion that spawns and finishes
submaps (num_range_data 2). Held: the same nodes (count and trajectory
ids), submaps, constraint set (submap, node, tag) and finished-submap
flags; local poses within 2e-3 (m, and quaternion components) of JAX's,
the tolerance of tests/test_torch_lio.py; optimized node poses after
`finish_trajectory()` within 5e-3 m. Cases: one trajectory with the port
at pipeline_depth 1 (the JAX package at 0: pipelining only defers reads),
and two trajectories fed interleaved into one builder.
tests/test_torch_map_builder_capture.py holds the capture rule.
"""

import numpy as np
import pytest
import torch

from dliom_tpu.common.config import load_config as j_load_config
from dliom_tpu.map_builder import MapBuilder as JMapBuilder
from dliom_tpu_torch import map_builder as TMB
from dliom_tpu_torch.common.config import load_config as t_load_config
from dliom_tpu_torch.io.synthetic import SyntheticWorld
from dliom_tpu_torch.transform.rigid import Rigid3 as TRigid3
import torch_threads  # noqa: F401  (one torch thread per test process)

G = 9.80511
POSE_ATOL = 2e-3


def _overrides(num_range_data=2, submaps=None):
    """tests/test_map_builder.py::_config with a short final optimization."""
    sub = {"high_resolution": 0.2, "high_resolution_max_range": 50.0, "low_resolution": 0.5,
           "num_range_data": num_range_data, "high_resolution_extent": 160,
           "low_resolution_extent": 80,
           "range_data_inserter": {"hit_probability": 0.7, "miss_probability": 0.4,
                                   "num_free_space_voxels": 0}}
    sub.update(submaps or {})
    return {
        "trajectory_builder": {
            "min_range": 0.5, "max_range": 50.0, "voxel_filter_size": 0.2, "scan_period": 0.3,
            "enable_gravity_factor": False, "frames_for_static_initialization": 3,
            "high_resolution_adaptive_voxel_filter": {"max_length": 0.7, "min_num_points": 150,
                                                      "max_range": 50.0},
            "low_resolution_adaptive_voxel_filter": {"max_length": 0.7, "min_num_points": 150,
                                                     "max_range": 50.0},
            "ceres_scan_matcher": {"occupied_space_weight_0": 5.0, "occupied_space_weight_1": 20.0,
                                   "translation_weight": 0.1, "rotation_weight": 0.3,
                                   "max_num_iterations": 10},
            "motion_filter": {"max_time_seconds": 0.1, "max_distance_meters": 0.0,
                              "max_angle_radians": 0.0},
            "imu": {"prior_vel_noise": 0.5, "prior_bias_noise": 0.05},
            "submaps": sub,
            "max_filtered_points": 4096, "max_high_res_points": 1024, "max_low_res_points": 1024,
            "max_imu_per_scan": 64, "window_size": 4, "gn_iterations": 4,
        },
        "pose_graph": {"optimize_every_n_nodes": 0, "max_submaps": 16, "max_nodes": 64,
                       "max_constraints": 256, "max_num_final_iterations": 4},
    }


def _stream(num_scans, trajectories=1, step=(0.05, 0.0, 0.0)):
    """Per trajectory: static IMU at 100 Hz, then a scan every 0.3 s; the
    first 4 scans stand still (3 initialize), then x advances 0.05 m per
    scan. Trajectory k starts 0.3 m further along y. Returns a list of
    (kind, trajectory, time, payload) events in feed order."""
    world = SyntheticWorld.create(num_beams=8, num_azimuths=200)
    events, t = [], 0.0
    for k in range(num_scans):
        for i in range(30):
            for tid in range(trajectories):
                events.append(("imu", tid, t + i * 0.01, None))
        t += 0.3
        for tid in range(trajectories):
            moved = max(0, k - 3)
            p = np.asarray(step, np.float32) * moved + np.asarray([0.0, 0.3 * tid, 0.0], np.float32)
            pts, ptimes = world.cast_scan(TRigid3(np.asarray([1.0, 0, 0, 0], np.float32), p))
            events.append(("scan", tid, t, (pts, ptimes)))
    return events


def _feed(builder, events, trajectories):
    for tid in range(1, trajectories):
        builder.add_trajectory_builder()
    for kind, tid, t, payload in events:
        if kind == "imu":
            builder.add_imu_data(t, [0.0, 0.0, G], [0.0, 0.0, 0.0], trajectory_id=tid)
        else:
            builder.add_range_data(t, *payload, trajectory_id=tid)
    builder.flush()


def _compare_graphs(jb, tb):
    jpg, tpg = jb.pose_graph, tb.pose_graph
    assert len(tpg.nodes) == len(jpg.nodes) > 0
    assert [n.trajectory_id for n in tpg.nodes] == [n.trajectory_id for n in jpg.nodes]
    assert [n.submap_ids for n in tpg.nodes] == [n.submap_ids for n in jpg.nodes]
    assert len(tpg.submaps) == len(jpg.submaps)
    assert [s.finished for s in tpg.submaps] == [s.finished for s in jpg.submaps]
    key = lambda c: (c.submap_id, c.node_id, c.tag)  # noqa: E731
    assert sorted(map(key, tpg.constraints)) == sorted(map(key, jpg.constraints))
    for tid in range(jb.num_trajectory_builders):
        jr, tr = jb.local_trajectory(tid), tb.local_trajectory(tid)
        assert len(tr) == len(jr) > 0
        for a, b in zip(jr, tr):
            assert a["inserted"] == b["inserted"] and a["failed"] == b["failed"]
            np.testing.assert_allclose(b["local_pose"].translation, np.asarray(a["local_pose"].translation),
                                       atol=POSE_ATOL)
            np.testing.assert_allclose(b["local_pose"].rotation, np.asarray(a["local_pose"].rotation),
                                       atol=POSE_ATOL)


@pytest.mark.parametrize("trajectories,scans,depth", [(1, 10, 1), (2, 7, 0)])
def test_map_builder_matches_jax(trajectories, scans, depth):
    over = _overrides()
    jb = JMapBuilder(j_load_config("basic", over))
    tb = TMB.MapBuilder(t_load_config("basic", over), pipeline_depth=depth,
                        device=torch.device("cpu"))
    events = _stream(scans, trajectories)
    _feed(jb, events, trajectories)
    _feed(tb, events, trajectories)
    _compare_graphs(jb, tb)
    assert sum(s.finished for s in tb.pose_graph.submaps) >= trajectories
    jb.finish_trajectory()
    tb.finish_trajectory()
    for (_, a), (_, b) in zip(jb.optimized_node_poses(), tb.optimized_node_poses()):
        np.testing.assert_allclose(b.translation, np.asarray(a.translation), atol=5e-3)


def test_map_builder_needs_a_card_unless_told_cpu(monkeypatch):
    """Without `device` MapBuilder runs on the CUDA card; with none it
    raises instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = t_load_config("basic", _overrides())
    with pytest.raises(RuntimeError, match="CUDA"):
        TMB.MapBuilder(cfg)
    assert TMB.MapBuilder(cfg, device="cpu").device.type == "cpu"
