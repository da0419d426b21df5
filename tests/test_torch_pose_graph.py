"""Parity of the pose graph (dliom_tpu_torch/backend/pose_graph.py) with the
JAX package on the loop-closure scenarios of tests/test_pose_graph.py: the
same constraint set (submap, node, tag) after the loop search, INTER
relative poses within 0.05 m / 0.02 (quaternion components) of JAX's, and
node poses after the final optimization within 1e-3 m.

Where the port departs from the JAX package on purpose (all around
threads): the SPA write-back and the extrapolation of poses added during a
pool-task solve hold `_mutex`, as does `add_node`'s seeding of global
poses; `_opt_pending` is set under a lock; and a submap's decompression is
guarded in flight. The last is tested here: two pool workers that search
against the same finished submap at once decompress it once."""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dliom_tpu.backend.pose_graph import PoseGraph as JPoseGraph
from dliom_tpu.mapping import probability as jpv
from dliom_tpu.mapping.grid import cell_index, make_grid, set_cells
from dliom_tpu.mapping.submap import grid_specs
from dliom_tpu.transform.rigid import Rigid3 as JRigid3
from dliom_tpu_torch.backend import pose_graph as TPG
from dliom_tpu_torch.common.config import load_config as t_load_config
from dliom_tpu_torch.interop import node_record_from_numpy
from dliom_tpu_torch.native import TaskThreadPool
from test_pose_graph import _cfg, _make_node, _world_cloud
import torch_threads  # noqa: F401  (one torch thread per test process)

PG_OVERRIDES = {
    "trajectory_builder": {"submaps": {"high_resolution": 0.2, "low_resolution": 0.8,
                                       "high_resolution_extent": 128,
                                       "low_resolution_extent": 64}},
    "pose_graph": {
        "optimize_every_n_nodes": 0, "max_submaps": 16, "max_nodes": 128, "max_constraints": 512,
        "max_radius_enable_loop_detection": 10.0, "num_close_submaps_loop_with_initial_value": 5,
        "max_num_final_iterations": 10,
        "constraint_builder": {
            "min_score": 0.4, "every_nodes_to_find_constraint": 1,
            "fast_correlative_scan_matcher": {
                "branch_and_bound_depth": 6, "full_resolution_depth": 3,
                "min_low_resolution_score": 0.35, "linear_xy_search_window": 3.0,
                "linear_z_search_window": 1.5},
        },
    },
}


def _port_config(**pose_graph):
    over = dict(PG_OVERRIDES, pose_graph=dict(PG_OVERRIDES["pose_graph"], **pose_graph))
    return t_load_config("basic", over)


def _grids(points, offset, hi, lo):
    pts = jnp.asarray(points) + jnp.asarray(offset)[None, :]
    vals = jnp.full((points.shape[0],), jpv.probability_to_value(jnp.float32(0.9)))
    return (set_cells(make_grid(hi), cell_index(pts, hi.resolution), vals, hi),
            set_cells(make_grid(lo), cell_index(pts, lo.resolution), vals, lo))


def _scenario(pg, cfg, seed, drift, s1_offset, finish_s1):
    """Both packages get the same calls: submap 0 with the world cloud,
    submap 1 beside it, submap 2 a drifted revisit whose finish runs the
    loop search. `pg` is a JAX or a port PoseGraph."""
    port = isinstance(pg, TPG.PoseGraph)
    hi, lo = grid_specs(cfg.trajectory_builder.submaps)
    points = _world_cloud(np.random.default_rng(seed))

    def node(offset):
        n = _make_node(cfg, points, JRigid3.translation_only(jnp.asarray(offset, jnp.float32)))
        return node_record_from_numpy(n) if port else n

    def pose(offset):
        return JRigid3(np.asarray([1.0, 0, 0, 0]), np.asarray(offset, np.float64)) if port \
            else JRigid3.translation_only(jnp.asarray(offset, jnp.float32))

    def grids(offset):
        g = _grids(points, offset, hi, lo)
        return tuple(torch.from_numpy(np.asarray(x)) for x in g) if port else g

    s0 = pg.add_submap(pose([0.0, 0.0, 0.0]))
    pg.add_node(node([0.0, 0.0, 0.0]), (s0,))
    pg.finish_submap(s0, *grids([0.0, 0.0, 0.0]))
    s1 = pg.add_submap(pose(s1_offset))
    pg.add_node(node(s1_offset), (s1,))
    if finish_s1:
        pg.finish_submap(s1, *grids([0.0, 0.0, 0.0]))
    s2 = pg.add_submap(pose(drift))
    g2 = grids(drift if not finish_s1 else [0.0, 0.0, 0.0])
    pg.add_node(node(drift), (s2,), newly_finished_submap_id=s2, finished_grids=g2)
    return s0


def _compare(jpg, tpg):
    key = lambda c: (c.submap_id, c.node_id, c.tag)  # noqa: E731
    assert sorted(map(key, tpg.constraints)) == sorted(map(key, jpg.constraints))
    jc = {key(c): c for c in jpg.constraints}
    for c in tpg.constraints:
        r = jc[key(c)].relative
        np.testing.assert_allclose(np.asarray(c.relative.translation), np.asarray(r.translation),
                                   atol=0.05)
        np.testing.assert_allclose(np.asarray(c.relative.rotation), np.asarray(r.rotation),
                                   atol=0.02)
    jpg.run_final_optimization()
    tpg.run_final_optimization()
    for a, b in zip(jpg.nodes, tpg.nodes):
        np.testing.assert_allclose(b.global_pose.translation, np.asarray(a.global_pose.translation),
                                   atol=1e-3)


def test_loop_closure_same_constraints_and_poses():
    """tests/test_pose_graph.py::test_loop_closure_finds_and_corrects_drift."""
    jcfg = _cfg()
    jcfg = dataclasses.replace(jcfg, pose_graph=dataclasses.replace(
        jcfg.pose_graph, max_num_final_iterations=10))
    tcfg = _port_config()
    jpg = JPoseGraph(jcfg.pose_graph, jcfg.trajectory_builder)
    tpg = TPG.PoseGraph(tcfg.pose_graph, tcfg.trajectory_builder, device="cpu")
    for pg, cfg in ((jpg, jcfg), (tpg, jcfg)):
        _scenario(pg, cfg, 2, [0.8, -0.5, 0.2], [4.0, 0.0, 0.0], finish_s1=False)
    assert any(c.tag == "INTER" and c.submap_id == 0 for c in tpg.constraints)
    _compare(jpg, tpg)


def test_image_proposal_same_constraints():
    """tests/test_pose_graph.py::test_image_proposal_recovers_high_drift_loop:
    drift beyond the proximity gate, found through the image proposal."""
    jcfg = _cfg()
    jcfg = dataclasses.replace(jcfg, pose_graph=dataclasses.replace(
        jcfg.pose_graph, max_radius_enable_loop_detection=2.0,
        num_close_submaps_loop_with_initial_value=1, max_num_final_iterations=10))
    tcfg = _port_config(max_radius_enable_loop_detection=2.0,
                        num_close_submaps_loop_with_initial_value=1)
    jpg = JPoseGraph(jcfg.pose_graph, jcfg.trajectory_builder)
    tpg = TPG.PoseGraph(tcfg.pose_graph, tcfg.trajectory_builder, device="cpu")
    for pg in (jpg, tpg):
        _scenario(pg, jcfg, 4, [6.0, -5.0, 0.1], [5.0, 0.0, 0.0], finish_s1=True)
    assert any(c.tag == "INTER" and c.submap_id == 0 for c in tpg.constraints)
    _compare(jpg, tpg)


def test_in_flight_guard_decompresses_once(monkeypatch):
    """Port departure on purpose: two pool workers searching against the
    same finished submap at once share one decompression."""
    tcfg = _port_config()
    pool = TaskThreadPool(2)
    tpg = TPG.PoseGraph(tcfg.pose_graph, tcfg.trajectory_builder, pool=pool,
                        device="cpu")
    hi, lo = grid_specs(_cfg().trajectory_builder.submaps)
    points = _world_cloud(np.random.default_rng(2))
    g = tuple(torch.from_numpy(np.asarray(x)) for x in _grids(points, [0.0, 0.0, 0.0], hi, lo))
    calls, gate = [], threading.Barrier(2, timeout=30)
    real = TPG.decompress

    def counting(comp, spec):
        calls.append(threading.get_ident())
        return real(comp, spec)

    monkeypatch.setattr(TPG, "decompress", counting)
    s0 = tpg.add_submap(JRigid3(np.asarray([1.0, 0, 0, 0]), np.zeros(3)))
    tpg.finish_submap(s0, *g)
    targets = []
    for k in (1, 2):
        tpg.add_submap(JRigid3(np.asarray([1.0, 0, 0, 0]), np.asarray([4.0 * k, 0, 0])))
    real_grids = tpg._decompressed_grids

    def synced(to_id):
        targets.append(to_id)
        gate.wait()  # both workers ask at once
        return real_grids(to_id)

    monkeypatch.setattr(tpg, "_decompressed_grids", synced)
    for sid in (1, 2):
        pool.add_task(lambda: tpg._decompressed_grids(s0))
    tpg.wait_for_all_computations()
    pool.close()
    assert targets == [s0, s0]
    assert len(calls) == 2  # one high and one low grid: decompressed once


def test_pose_graph_needs_a_card_unless_told_cpu(monkeypatch):
    """Without `device` PoseGraph runs on the CUDA card; with none it
    raises instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tcfg = _port_config()
    with pytest.raises(RuntimeError, match="CUDA"):
        TPG.PoseGraph(tcfg.pose_graph, tcfg.trajectory_builder)
    assert TPG.PoseGraph(tcfg.pose_graph, tcfg.trajectory_builder, device="cpu").device.type == "cpu"
