"""Map state and live checkpoint of the port (dliom_tpu_torch/io/serialization.py)
against the JAX package (dliom_tpu/io/serialization.py).

Map state: `_state_arrays` of a graph carried across with `interop` has the
JAX package's key set and equal arrays; a state written by either package
loads into the other with equal records (integers, grids and clouds exact,
poses within 1e-6), the legacy keys included.

Live checkpoint, on tests/test_torch_map_builder.py's stream and config,
checkpointed after one submap has finished and the next is half full, at
`pipeline_depth` 0 and 1: the resumed builder's `LioState` equals the
checkpointed one tensor for tensor, and the resumed run equals the
uninterrupted port run bit for bit and the JAX package's uninterrupted run
within POSE_ATOL. Where the port departs from the JAX package on purpose
(ADVICE, dliom_tpu/io/serialization.py:123, whose live checkpoint drops
them): with non-empty fixed-frame, landmark, odometry, accumulation and
synchronizer buffers the resume still equals the uninterrupted run; and
state that cannot be restored equal (a trajectory inside the NDT dynamic
initializer's window, a native collator holding queued items) or a
checkpoint of another configuration is refused with ValueError.
"""

import numpy as np
import pytest
import torch

from dliom_tpu.common.config import load_config as j_load_config
from dliom_tpu.io import serialization as JS
from dliom_tpu.map_builder import MapBuilder as JMapBuilder
from dliom_tpu_torch import map_builder as TMB
from dliom_tpu_torch.backend import pose_graph as TPG
from dliom_tpu_torch.common.config import load_config as t_load_config
from dliom_tpu_torch.interop import node_record_from_numpy, submap_record_from_numpy
from dliom_tpu_torch.io import serialization as TS
from dliom_tpu_torch.transform.rigid import Rigid3 as TRigid3
from dliom_tpu_torch.transform.rigid import np_rigid
from test_pbstream import _sample_graph
from test_pose_graph import _cfg
from test_torch_map_builder import POSE_ATOL, G, _overrides, _stream
import torch_threads  # noqa: F401  (one torch thread per test process)

CPU = torch.device("cpu")


# ----- a JAX graph carried across, and record comparison ------------------


def carried_graph(jpg, cfg=None):
    """The port's PoseGraph holding the JAX graph's records."""
    cfg = cfg or _cfg()
    pg = TPG.PoseGraph(cfg.pose_graph, cfg.trajectory_builder, device=CPU)
    for tid, state in jpg.trajectory_states().items():
        pg.add_trajectory(frozen=state == "FROZEN")
    pg._traj_submap_counts = dict(jpg._traj_submap_counts)
    pg.submaps = [submap_record_from_numpy(s, CPU) for s in jpg.submaps]
    pg.nodes = [node_record_from_numpy(n) for n in jpg.nodes]
    pg.constraints = [TPG.Constraint(
        submap_id=c.submap_id, node_id=c.node_id, tag=c.tag,
        relative=np_rigid(TRigid3(np.asarray(c.relative.rotation), np.asarray(c.relative.translation))),
        translation_weight=c.translation_weight, rotation_weight=c.rotation_weight)
        for c in jpg.constraints]
    pg.reindex_constraints()
    pg.fixed_frame_observations = list(jpg.fixed_frame_observations)
    pg.landmark_observations = list(jpg.landmark_observations)
    pg._landmark_ids = dict(jpg._landmark_ids)
    pg.odometry_links = [(a, b, np_rigid(TRigid3(np.asarray(r.rotation), np.asarray(r.translation))))
                         for a, b, r in jpg.odometry_links]
    return pg


def _np(x):
    return None if x is None else np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def assert_same_pose(a, b, atol=1e-6):
    np.testing.assert_allclose(_np(b.rotation), _np(a.rotation), atol=atol)
    np.testing.assert_allclose(_np(b.translation), _np(a.translation), atol=atol)


def assert_same_records(a, b, pose_atol=1e-6, grids=True):
    """Graph `b` holds graph `a`'s records (either package): integers,
    grids, clouds and histograms exact, poses within `pose_atol`."""
    assert len(b.submaps) == len(a.submaps)
    assert len(b.nodes) == len(a.nodes)
    assert len(b.constraints) == len(a.constraints)
    for x, y in zip(a.submaps, b.submaps):
        assert (y.finished, y.trajectory_id, y.index_in_trajectory) == \
               (x.finished, x.trajectory_id, x.index_in_trajectory)
        assert list(y.node_ids) == list(x.node_ids)
        assert_same_pose(x.local_pose, y.local_pose, pose_atol)
        assert_same_pose(x.global_pose, y.global_pose, pose_atol)
        np.testing.assert_array_equal(_np(y.histogram), _np(x.histogram))
        if grids:
            assert (x.high is None) == (y.high is None)
            for gx, gy in ((x.high, y.high), (x.low, y.low)):
                if gx is not None:
                    for u, v in zip(gx, gy):
                        np.testing.assert_array_equal(_np(v), _np(u))
    for x, y in zip(a.nodes, b.nodes):
        assert y.time == x.time and y.trajectory_id == x.trajectory_id
        assert tuple(y.submap_ids) == tuple(x.submap_ids)
        assert_same_pose(x.local_pose, y.local_pose, pose_atol)
        assert_same_pose(x.global_pose, y.global_pose, pose_atol)
        for f in ("gravity_alignment", "histogram"):
            np.testing.assert_array_equal(_np(getattr(y, f)), _np(getattr(x, f)))
        for pts, mask in (("high_points", "high_mask"), ("low_points", "low_mask")):
            np.testing.assert_array_equal(_np(getattr(y, mask)), _np(getattr(x, mask)))
            # clouds: the 1 mm compressed cloud decompresses identically
            np.testing.assert_array_equal(_np(getattr(y, pts))[_np(getattr(y, mask))],
                                          _np(getattr(x, pts))[_np(getattr(x, mask))])
    for x, y in zip(a.constraints, b.constraints):
        assert (y.submap_id, y.node_id, y.tag) == (x.submap_id, x.node_id, x.tag)
        assert np.float32(y.translation_weight) == np.float32(x.translation_weight)
        assert np.float32(y.rotation_weight) == np.float32(x.rotation_weight)
        assert_same_pose(x.relative, y.relative, pose_atol)


def _roundtripped(jpg, tmp_path):
    """The JAX sample graph after a JAX save/load, so its node clouds are
    1 mm-quantized as every loaded graph's are."""
    path = str(tmp_path / "jax_src.npz")
    JS.save_state(path, jpg)
    return JS.load_state(path, _cfg())


# ----- map state ----------------------------------------------------------


def test_state_arrays_same_keys_and_values():
    _, jpg, _ = _sample_graph()
    jpg.add_fixed_frame_pose(0, [0.1, 0.2, 0.3])
    want = JS._state_arrays(jpg, "basic")
    got = TS._state_arrays(carried_graph(jpg), "basic")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("legacy", [False, True])
def test_state_cross_loads_both_ways(tmp_path, legacy):
    """A JAX file into the port and a port file into the JAX package; with
    `legacy`, the pre-trajectory keys (`submap/i/trajectory`,
    `node/i/trajectory`) are removed first, as old states lack them."""
    _, jpg, _ = _sample_graph()
    jpg = _roundtripped(jpg, tmp_path)
    tpg = carried_graph(jpg)

    def strip(path):
        if legacy:
            z = dict(np.load(path))
            np.savez_compressed(path, **{k: v for k, v in z.items() if not k.endswith("/trajectory")})

    j_path, t_path = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    JS.save_state(j_path, jpg)
    TS.save_state(t_path, tpg)
    strip(j_path)
    strip(t_path)
    into_port = TS.load_state(j_path, t_load_config("basic", _pg_overrides()), device=CPU)
    into_jax = JS.load_state(t_path, _cfg())
    assert_same_records(jpg, into_port)
    assert_same_records(tpg, into_jax)
    assert all(s.high is None or s.high.indices.device == CPU for s in into_port.submaps)
    assert isinstance(into_port.nodes[0].high_points, np.ndarray)


def _pg_overrides():
    """tests/test_pose_graph.py::_cfg's overrides, for the port's config."""
    j = _cfg()
    sm = j.trajectory_builder.submaps
    return {"trajectory_builder": {"submaps": {
        "high_resolution": sm.high_resolution, "low_resolution": sm.low_resolution,
        "high_resolution_extent": sm.high_resolution_extent,
        "low_resolution_extent": sm.low_resolution_extent}},
        "pose_graph": {"optimize_every_n_nodes": 0, "max_submaps": 16, "max_nodes": 128,
                       "max_constraints": 512}}


# ----- live checkpoint ----------------------------------------------------

SCANS = 9
CUT = 7  # scans fed before the checkpoint: submap 0 finished, submap 1 half full


def _feed(builder, events):
    for kind, tid, t, payload in events:
        if kind == "imu":
            builder.add_imu_data(t, [0.0, 0.0, G], [0.0, 0.0, 0.0], trajectory_id=tid)
        else:
            builder.add_range_data(t, *payload, trajectory_id=tid)


def _split(events, scans):
    """Index just past the `scans`-th scan event."""
    return [i for i, e in enumerate(events) if e[0] == "scan"][scans - 1] + 1


@pytest.fixture(scope="module")
def jax_uninterrupted():
    events = _stream(SCANS)
    jb = JMapBuilder(j_load_config("basic", _overrides()))
    _feed(jb, events)
    jb.flush()
    return jb


def assert_same_state(a, b):
    la, lb = list(TS.state_leaves(a)), list(TS.state_leaves(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.device == y.device, path
        assert torch.equal(x, y), path


def assert_same_run(a, b):
    """Two port builders hold the same graph and results, bit for bit."""
    pa, pb = a.pose_graph, b.pose_graph
    assert len(pa.nodes) == len(pb.nodes) > 0
    assert_same_records(pa, pb, pose_atol=0.0)
    for x, y in zip(pa.constraints, pb.constraints):
        assert (x.score, x.yaw_correction) == (y.score, y.yaw_correction)
    assert len(pa.fixed_frame_observations) == len(pb.fixed_frame_observations)
    for x, y in zip(pa.fixed_frame_observations, pb.fixed_frame_observations):
        assert x[0] == y[0] and x[2] == y[2]
        np.testing.assert_array_equal(y[1], x[1])
    assert len(pa.landmark_observations) == len(pb.landmark_observations)
    for x, y in zip(pa.landmark_observations, pb.landmark_observations):
        assert x[:4] == y[:4] and x[6:] == y[6:]
        np.testing.assert_array_equal(y[4], x[4])
        np.testing.assert_array_equal(y[5], x[5])
    assert [(p, n) for p, n, _ in pa.odometry_links] == [(p, n) for p, n, _ in pb.odometry_links]
    for (_, _, x), (_, _, y) in zip(pa.odometry_links, pb.odometry_links):
        np.testing.assert_array_equal(y.translation, x.translation)
    assert pa._nodes_since_optimization == pb._nodes_since_optimization
    ra, rb = a.local_trajectory(0), b.local_trajectory(0)
    assert len(ra) == len(rb)
    for x, y in zip(ra, rb):
        assert (x["time"], x["inserted"], x["failed"]) == (y["time"], y["inserted"], y["failed"])
        np.testing.assert_array_equal(y["local_pose"].translation, x["local_pose"].translation)
    assert_same_state(a.trajectory(0)._lio, b.trajectory(0)._lio)


@pytest.mark.parametrize("depth", [0, 1])
def test_live_checkpoint_resumes_mid_submap(depth, tmp_path, jax_uninterrupted):
    cfg = t_load_config("basic", _overrides())
    events = _stream(SCANS)
    cut = _split(events, CUT)
    a = TMB.MapBuilder(cfg, pipeline_depth=depth, device=CPU)
    _feed(a, events[:cut])
    path = str(tmp_path / "live.npz")
    a.save_checkpoint(path)
    pg = a.pose_graph
    assert sum(s.finished for s in pg.submaps) == 1 and not pg.submaps[-1].finished
    b = TMB.map_builder_from_checkpoint(path, cfg, pipeline_depth=depth, device=CPU)
    assert_same_state(a.trajectory(0)._lio, b.trajectory(0)._lio)
    assert_same_run(a, b)
    # the map part is the JAX package's schema
    assert len(JS.load_state(path, j_load_config("basic", _overrides())).nodes) == len(pg.nodes)

    _feed(b, events[cut:])
    b.flush()
    if depth:
        # the uninterrupted run, never flushed mid-way
        c = TMB.MapBuilder(cfg, pipeline_depth=depth, device=CPU)
        _feed(c, events)
        c.flush()
    else:
        c = a
        _feed(c, events[cut:])
    assert sum(s.finished for s in c.pose_graph.submaps) == 2
    assert_same_run(c, b)

    jb = jax_uninterrupted
    jn, bn = jb.pose_graph.nodes, b.pose_graph.nodes
    assert len(bn) == len(jn)
    key = lambda c: (c.submap_id, c.node_id, c.tag)  # noqa: E731
    assert sorted(map(key, b.pose_graph.constraints)) == sorted(map(key, jb.pose_graph.constraints))
    for x, y in zip(jn, bn):
        np.testing.assert_allclose(y.local_pose.translation, np.asarray(x.local_pose.translation),
                                   atol=POSE_ATOL)
        np.testing.assert_allclose(y.local_pose.rotation, np.asarray(x.local_pose.rotation),
                                   atol=POSE_ATOL)


def _buffered_stream(num_scans):
    """The stream with per-point times over the 0.3 s period, a second LiDAR
    (its cloud stamped half a period after the primary's, so its second
    half stays buffered for the next window), and fixed-frame, landmark and
    odometry samples that stay buffered between nodes."""
    out = []
    for kind, tid, t, payload in _stream(num_scans):
        if kind == "scan":
            pts = payload[0]
            sweep = np.linspace(-0.3, 0.0, len(pts)).astype(np.float32)
            pose = TRigid3(np.asarray([1.0, 0, 0, 0]), np.asarray([0.01 * t, 0.0, 0.0]))
            out.append(("odom", None, t, pose))
            out.append(("scan", "points1", t + 0.15, (pts[::3] + 0.01, sweep[::3])))
            out.append(("scan", "points0", t, (pts, sweep)))
            out.append(("ff", None, t + 0.05, np.asarray([0.02 * t, 0.0, 0.0], np.float32)))
            out.append(("lm", "lm_a", t + 0.1, np.asarray([1.0, 0.5, 0.0], np.float32)))
        else:
            out.append((kind, tid, t, payload))
    return out


def _feed_buffered(builder, events):
    for kind, sid, t, payload in events:
        if kind == "imu":
            builder.add_imu_data(t, [0.0, 0.0, G], [0.0, 0.0, 0.0])
        elif kind == "scan":
            builder.add_range_data(t, *payload, sensor_id=sid)
        elif kind == "ff":
            builder.add_fixed_frame_pose_data(t, payload)
        elif kind == "lm":
            builder.add_landmark_data(t, sid, payload)
        else:
            builder.add_odometry_data(t, payload)


def test_live_checkpoint_restores_buffers_jax_drops(tmp_path):
    """Where the port departs from the JAX package: ff/lm/odom, the
    accumulation buffer and the synchronizer's partial merge are non-empty
    at the checkpoint, and the resume equals the uninterrupted run."""
    over = _overrides()
    over["trajectory_builder"]["num_accumulated_range_data"] = 2
    cfg = t_load_config("basic", over)
    events = _buffered_stream(12)
    # 8 primary scans: initialized on the 4th, steps on the 5th and 7th,
    # the 8th accumulated
    cut = _split(events, 2 * 8)
    sensors = ["points0", "points1"]
    a = TMB.MapBuilder(cfg, range_sensor_ids=sensors, device=CPU)
    _feed_buffered(a, events[:cut])
    t = a.trajectory(0)
    assert t._ff_buffer and t._lm_buffer and len(t._odom_buffer) and len(t._accum_points) == 1
    assert t._synchronizer._buffer["points1"]
    assert a.pose_graph.fixed_frame_observations and a.pose_graph.odometry_links
    path = str(tmp_path / "buffers.npz")
    a.save_checkpoint(path)
    b = TMB.map_builder_from_checkpoint(path, cfg, range_sensor_ids=sensors, device=CPU)
    _feed_buffered(a, events[cut:])
    _feed_buffered(b, events[cut:])
    assert len(b.pose_graph.nodes) > len(TS.load_state(path, cfg, device=CPU).nodes)
    assert b.pose_graph.landmark_observations
    assert_same_run(a, b)


def test_live_checkpoint_refuses_dynamic_initialization(tmp_path):
    over = _overrides()
    over["trajectory_builder"]["enable_ndt_initialization"] = True
    b = TMB.MapBuilder(t_load_config("basic", over), device=CPU)
    _feed(b, _stream(1))
    with pytest.raises(ValueError, match="dynamic initializer"):
        b.save_checkpoint(str(tmp_path / "x.npz"))


def test_live_checkpoint_refuses_queued_collator_items(tmp_path):
    b = TMB.MapBuilder(t_load_config("basic", _overrides()), use_native_collator=True, device=CPU)
    b.add_imu_data(0.0, [0.0, 0.0, G], [0.0, 0.0, 0.0])  # waits for the range queue
    with pytest.raises(ValueError, match="collator"):
        b.save_checkpoint(str(tmp_path / "x.npz"))


def test_live_checkpoint_refuses_another_config(tmp_path):
    cfg = t_load_config("basic", _overrides())
    a = TMB.MapBuilder(cfg, device=CPU)
    _feed(a, _stream(4))
    assert a.initialized
    path = str(tmp_path / "x.npz")
    a.save_checkpoint(path)
    other = t_load_config("basic", _overrides(submaps={"high_resolution_extent": 96}))
    with pytest.raises(ValueError, match="frontend.submaps.high_values"):
        TMB.map_builder_from_checkpoint(path, other, device=CPU)
    with pytest.raises(ValueError, match="no live checkpoint"):
        TS.save_state(path, a.pose_graph)
        TMB.map_builder_from_checkpoint(path, cfg, device=CPU)
