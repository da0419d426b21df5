"""The port's host-side IO and evaluation modules against the JAX package,
on the same numpy inputs (made from seeds):

  sensor/compressed_point_cloud.py   the same block_origins, block_counts and
                                     packed arrays;
  io/geodesy.py                      within 1e-9 relative, and
                                     `MapBuilder.add_navsat_data` buffers the
                                     same fixed-frame positions;
  io/pointcloud_formats.py,
  io/datasets.py                     equal decoded scans and converted files;
  io/assets_writer.py,
  io/points_pipeline.py              equal point files (byte for byte), the
                                     probability grid's points within 1e-5;
  evaluation/ate.py,
  evaluation/ground_truth.py         equal metrics and exports (float32 JAX
                                     poses against the port's float64 ones
                                     within 1e-6), NDT refinement within
                                     1e-3 m.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from dliom_tpu.common.config import load_config as j_load_config
from dliom_tpu.evaluation import ate as JA
from dliom_tpu.evaluation import ground_truth as JG
from dliom_tpu.io import assets_writer as JW
from dliom_tpu.io import datasets as JD
from dliom_tpu.io import geodesy as JGeo
from dliom_tpu.io import points_pipeline as JPP
from dliom_tpu.io.pointcloud_formats import decode_points as j_decode
from dliom_tpu.map_builder import MapBuilder as JMapBuilder
from dliom_tpu.sensor import compressed_point_cloud as JC
from dliom_tpu.transform.rigid import Rigid3 as JRigid3
from dliom_tpu.transform.rigid import quat_from_yaw
from dliom_tpu_torch import map_builder as TMB
from dliom_tpu_torch.common.config import load_config as t_load_config
from dliom_tpu_torch.evaluation import ate as TA
from dliom_tpu_torch.evaluation import ground_truth as TG
from dliom_tpu_torch.io import assets_writer as TW
from dliom_tpu_torch.io import datasets as TD
from dliom_tpu_torch.io import geodesy as TGeo
from dliom_tpu_torch.io import points_pipeline as TPP
from dliom_tpu_torch.io.pointcloud_formats import decode_points as t_decode
from dliom_tpu_torch.sensor import compressed_point_cloud as TC
from dliom_tpu_torch.transform.rigid import np_rigid
from test_ground_truth import _loop_graph
from test_io_tools import _small_pose_graph
from test_torch_serialization import CPU, carried_graph
import torch_threads  # noqa: F401  (one torch thread per test process)


@pytest.mark.parametrize("case", ["empty", "one", "room", "spread"])
def test_compressed_point_cloud_matches_jax(case):
    rng = np.random.default_rng(7)
    pts = {"empty": np.zeros((0, 3)), "one": np.asarray([[0.0005, -0.0015, 1.0235]]),
           "room": rng.uniform(-8, 8, (2000, 3)),
           "spread": rng.normal(0, 60, (5000, 3))}[case].astype(np.float32)
    a, b = JC.compress(pts), TC.compress(pts)
    for f in ("block_origins", "block_counts", "packed"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
        assert getattr(b, f).dtype == getattr(a, f).dtype
    assert b.num_points == a.num_points and b.nbytes == a.nbytes
    np.testing.assert_array_equal(TC.decompress(b), JC.decompress(a))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_geodesy_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        lat, lon, alt = rng.uniform(-90, 90), rng.uniform(-180, 180), rng.uniform(-500, 9000)
        np.testing.assert_allclose(TGeo.lat_long_alt_to_ecef(lat, lon, alt),
                                   JGeo.lat_long_alt_to_ecef(lat, lon, alt), rtol=1e-9)
        for x, y in zip(TGeo.compute_local_frame_from_lat_long(lat, lon),
                        JGeo.compute_local_frame_from_lat_long(lat, lon)):
            np.testing.assert_allclose(x, y, rtol=1e-9, atol=1e-9 * np.abs(y).max())
    tc, jc = TGeo.NavSatConverter(), JGeo.NavSatConverter()
    fixes = [(48.1372149 + 1e-4 * k, 11.5748024 - 2e-4 * k, 517.1 + k) for k in range(5)]
    for fix in fixes:
        np.testing.assert_allclose(tc.to_local(*fix), jc.to_local(*fix), rtol=1e-9, atol=1e-9)
    restored = TGeo.NavSatConverter.from_anchor(*tc.anchor())
    np.testing.assert_array_equal(restored.to_local(*fixes[-1]), tc.to_local(*fixes[-1]))


def test_navsat_ingest_matches_jax():
    over = {"pose_graph": {"optimize_every_n_nodes": 0}}
    jb = JMapBuilder(j_load_config("basic", over))
    tb = TMB.MapBuilder(t_load_config("basic", over), device=CPU)
    for k in range(4):
        fix = (0.1 * k, 48.1372149 + 2e-5 * k, 11.5748024, 517.1 + 0.5 * k)
        jb.add_navsat_data(*fix)
        tb.add_navsat_data(*fix)
    want, got = jb.trajectory(0)._ff_buffer, tb.trajectory(0)._ff_buffer
    assert len(got) == len(want) == 4
    for (ta, pa), (tb_, pb) in zip(want, got):
        assert ta == tb_ and pb.dtype == pa.dtype
        np.testing.assert_array_equal(pb, pa)
    assert tb.trajectory(0)._navsat.anchored


def _structured(kind, n, rng):
    field = {"ouster": ("t", "u4"), "velodyne": ("time", "f4"), "robosense": ("timestamp", "f8")}[kind]
    arr = np.zeros(n, dtype=[("x", "f4"), ("y", "f4"), ("z", "f4"), field])
    for c in "xyz":
        arr[c] = rng.normal(0, 5, n)
    arr["x"][3] = np.nan
    arr[field[0]] = {"ouster": np.arange(n) * 10_000_000, "velodyne": np.arange(n) * 0.01,
                     "robosense": 200.0 + np.arange(n) * 0.01}[kind]
    return arr


@pytest.mark.parametrize("kind", ["ouster", "velodyne", "robosense", "generic", "empty"])
def test_pointcloud_decoders_match_jax(kind):
    rng = np.random.default_rng(3)
    if kind == "generic":
        arr = rng.normal(0, 5, (40, 4)).astype(np.float32)
        arr[5, 1] = np.inf
    elif kind == "empty":
        arr = np.zeros((0, 3), np.float32)
    else:
        arr = _structured(kind, 40, rng)
    a, b = j_decode(arr, kind, 100.0), t_decode(arr, kind, 100.0)
    assert b[0] == a[0]
    for x, y in zip(a[1:], b[1:]):
        np.testing.assert_array_equal(y, x)


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_dataset_converters_match_jax(tmp_path):
    vdir = tmp_path / "velodyne"
    vdir.mkdir()
    rng = np.random.default_rng(0)
    for k in range(3):
        rng.uniform(-10, 10, size=(100, 4)).astype(np.float32).tofile(str(vdir / f"{k:06d}.bin"))
    imu = {"times": np.arange(5) * 0.05, "acc": rng.normal(size=(5, 3)), "gyr": rng.normal(size=(5, 3))}
    gt = (np.asarray([0.0, 0.2]), rng.normal(size=(2, 3)))
    scans = [(0.1 * k, rng.normal(size=(50, 3)), None if k else rng.normal(size=50)) for k in range(3)]
    for name, fn in (("kitti", lambda m, p: m.convert_kitti_sequence(str(vdir), p, imu=imu, gt=gt,
                                                                     max_scans=2)),
                     ("sequence", lambda m, p: m.write_npz_sequence(p, scans, imu["times"], imu["acc"],
                                                                    imu["gyr"], gt=gt))):
        a, b = str(tmp_path / f"{name}_jax.npz"), str(tmp_path / f"{name}_port.npz")
        assert fn(TD, b) == fn(JD, a)
        want, got = _npz(a), _npz(b)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got[k].dtype == want[k].dtype
    raw = str(vdir / "000001.bin")
    np.testing.assert_array_equal(TD.load_kitti_velodyne_bin(raw), JD.load_kitti_velodyne_bin(raw))
    assert TD.POINT_TIME_FIELDS == JD.POINT_TIME_FIELDS
    with pytest.raises(ImportError, match="rosbag"):
        TD.convert_ntu_viral("missing.bag", str(tmp_path / "x.npz"))


def _files_equal(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read(), (a, b)


def _grid_npz_equal(a, b):
    want, got = _npz(a), _npz(b)
    np.testing.assert_allclose(got["points"], want["points"], atol=1e-5)
    np.testing.assert_array_equal(got["probabilities"], want["probabilities"])
    assert got["resolution"] == want["resolution"]


def test_assets_writers_match_jax(tmp_path):
    jpg = _small_pose_graph()
    tpg = carried_graph(jpg)
    want, got = JW.aggregate_point_cloud(jpg), TW.aggregate_point_cloud(tpg)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(TW.aggregate_point_cloud(tpg, use_low=True),
                                  JW.aggregate_point_cloud(jpg, use_low=True))
    np.testing.assert_array_equal(TW.voxel_dedup(got, 0.3), JW.voxel_dedup(want, 0.3))
    for name, j_fn, t_fn in (("map.ply", JW.write_ply, TW.write_ply), ("map.pcd", JW.write_pcd, TW.write_pcd),
                             ("xray.pgm", JW.write_xray_pgm, TW.write_xray_pgm)):
        j_fn(str(tmp_path / f"jax_{name}"), want)
        t_fn(str(tmp_path / f"port_{name}"), got)
        _files_equal(str(tmp_path / f"jax_{name}"), str(tmp_path / f"port_{name}"))
    JW.write_probability_grid_npz(str(tmp_path / "jax_grid.npz"), jpg)
    TW.write_probability_grid_npz(str(tmp_path / "port_grid.npz"), tpg)
    _grid_npz_equal(str(tmp_path / "jax_grid.npz"), str(tmp_path / "port_grid.npz"))
    assert len(_npz(str(tmp_path / "port_grid.npz"))["points"]) > 0


def test_points_pipeline_matches_jax(tmp_path):
    jpg = _small_pose_graph()
    tpg = carried_graph(jpg)
    pipeline = [
        {"action": "min_max_range_filter", "min_range": 0.0, "max_range": 9.0},
        {"action": "fixed_ratio_sampler", "sampling_ratio": 0.5},
        {"action": "voxel_filter", "voxel_size": 0.05},
        {"action": "dump_num_points"},
        {"action": "write_pcd", "filename": "points.pcd"},
        {"action": "write_ply", "filename": "points.ply"},
        {"action": "write_xray_image", "filename": "xray.pgm", "voxel_size": 0.2},
        {"action": "write_probability_grid", "filename": "grid.npz"},
    ]
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    want, got = JPP.run_pipeline(jpg, pipeline, a), TPP.run_pipeline(tpg, pipeline, b)
    assert got == want and got["num_points"] > 0
    for name in ("points.pcd", "points.ply", "xray.pgm"):
        _files_equal(os.path.join(a, name), os.path.join(b, name))
    _grid_npz_equal(os.path.join(a, "grid.npz"), os.path.join(b, "grid.npz"))
    with pytest.raises(KeyError):
        TPP.build_pipeline([{"action": "nope"}], str(tmp_path))


def test_ate_matches_jax(tmp_path):
    rng = np.random.default_rng(11)
    gt_t = np.arange(0.0, 20.0, 0.1)
    gt_p = np.cumsum(rng.normal(0, 0.1, (len(gt_t), 3)), axis=0)
    est_t = np.arange(-0.5, 21.0, 0.37)
    est_p = rng.normal(0, 0.05, (len(est_t), 3)) + np.stack(
        [np.interp(est_t, gt_t, gt_p[:, k]) for k in range(3)], -1)
    a, b = JA.associate(est_t, est_p, gt_t, gt_p), TA.associate(est_t, est_p, gt_t, gt_p)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(y, x)
    for x, y in zip(JA.umeyama_alignment(a[0], a[1]), TA.umeyama_alignment(b[0], b[1])):
        np.testing.assert_array_equal(y, x)
    for align in (False, True):
        assert TA.ate_rmse(b[0], b[1], align=align) == JA.ate_rmse(a[0], a[1], align=align)
    assert TA.rpe_rmse(b[0], b[1], delta=5) == JA.rpe_rmse(a[0], a[1], delta=5)
    assert TA.rpe_rmse(b[0][:3], b[1][:3]) == JA.rpe_rmse(a[0][:3], a[1][:3]) == 0.0

    jposes = [JRigid3(quat_from_yaw(jnp.float32(0.3 * k)), jnp.asarray([1.0 * k, 2.0, 0.5], jnp.float32))
              for k in range(4)]
    tposes = [np_rigid(JRigid3(np.asarray(p.rotation), np.asarray(p.translation))) for p in jposes]
    times = [0.0, 0.1, 0.2, 0.3]
    for name, j_fn, t_fn in (("csv", lambda p: JA.write_trajectory_csv(p, times, jposes),
                              lambda p: TA.write_trajectory_csv(p, times, tposes)),
                             ("tum", lambda p: JA.write_tum_trajectory(p, times, jposes),
                              lambda p: TA.write_tum_trajectory(p, times, tposes)),
                             ("kitti", lambda p: JA.write_kitti_trajectory(p, jposes),
                              lambda p: TA.write_kitti_trajectory(p, tposes))):
        j_path, t_path = str(tmp_path / f"jax.{name}"), str(tmp_path / f"port.{name}")
        j_fn(j_path)
        t_fn(t_path)
        want, got = np.loadtxt(j_path), np.loadtxt(t_path)
        np.testing.assert_allclose(got, want, atol=1e-6)
        if name != "kitti":
            _files_equal(j_path, t_path)
    for x, y in zip(JA.read_trajectory_csv(str(tmp_path / "jax.csv")),
                    TA.read_trajectory_csv(str(tmp_path / "port.csv"))):
        np.testing.assert_array_equal(y, x)


@pytest.mark.parametrize("noise,min_distance", [(0.0, 50.0), (0.5, 50.0), (0.0, 1e6)])
def test_ground_truth_matches_jax(tmp_path, noise, min_distance):
    g, _ = _loop_graph(constraint_noise=noise)
    want, want_out = JG.generate_ground_truth(g, min_covered_distance=min_distance)
    got, got_out = TG.generate_ground_truth(g, min_covered_distance=min_distance)
    assert (len(got), got_out) == (len(want), want_out)
    for a, b in zip(want, got):
        assert (b.timestamp1, b.timestamp2) == (a.timestamp1, a.timestamp2)
        assert abs(b.covered_distance - a.covered_distance) < 1e-9
        for x, y in zip(a.expected, b.expected):
            np.testing.assert_allclose(y, np.asarray(x), atol=1e-6)
    times = [n.time for n in g.nodes]
    poses = [n.global_pose for n in g.nodes]
    drifted = [JRigid3(p.rotation, p.translation + jnp.asarray([0.0, 0.5 * (i % 7 == 0), 0.0]))
               for i, p in enumerate(poses)]
    for trajectory in (poses, drifted):
        m_j = JG.compute_relations_metrics(want, times, trajectory)
        m_t = TG.compute_relations_metrics(got, times, trajectory)
        assert set(m_t) == set(m_j)
        for k in m_j:
            assert abs(m_t[k] - m_j[k]) < 1e-5, k
    j_path, t_path = str(tmp_path / "jax.csv"), str(tmp_path / "port.csv")
    JG.write_relations_csv(j_path, want)
    TG.write_relations_csv(t_path, got)
    if want:
        np.testing.assert_allclose(np.loadtxt(t_path, delimiter=",", skiprows=1, ndmin=2),
                                   np.loadtxt(j_path, delimiter=",", skiprows=1, ndmin=2), atol=1e-6)
    for a, b in zip(JG.read_relations_csv(j_path), TG.read_relations_csv(j_path)):
        np.testing.assert_array_equal(b.expected.translation, np.asarray(a.expected.translation))


def test_refine_relations_ndt_matches_jax():
    """tests/test_ground_truth.py::test_refine_relations_ndt's graph: the
    second node sees the world 0.4 m away; a seed 10 cm off is refined by
    NDT on the port's pose graph device (the CPU here) to within 1e-3 m of
    the JAX package's refinement."""
    import test_pose_graph as tpg
    from dliom_tpu.backend.pose_graph import PoseGraph

    cfg = tpg._cfg()
    pg = PoseGraph(cfg.pose_graph, cfg.trajectory_builder)
    pts = tpg._world_cloud(np.random.default_rng(5), 400)
    s0 = pg.add_submap(JRigid3.identity())
    n0 = tpg._make_node(cfg, pts, JRigid3.identity())
    n0.time = 1.0
    pg.add_node(n0, (s0,))
    true_rel = JRigid3.translation_only(jnp.asarray([0.4, 0.0, 0.0]))
    n1 = tpg._make_node(cfg, np.asarray(true_rel.inverse().apply(jnp.asarray(pts))), true_rel)
    n1.time = 2.0
    pg.add_node(n1, (s0,))
    seed = JRigid3.translation_only(jnp.asarray([0.3, 0.05, 0.0]))
    rels = [JG.Relation(1.0, 2.0, seed, 10.0), JG.Relation(7.7, 8.8, seed, 10.0)]
    want, want_dropped = JG.refine_relations_ndt(pg, rels)
    t_rels = [TG.Relation(r.timestamp1, r.timestamp2, np_rigid(JRigid3(np.asarray(seed.rotation),
                                                                       np.asarray(seed.translation))),
                          r.covered_distance) for r in rels]
    got, got_dropped = TG.refine_relations_ndt(carried_graph(pg, cfg), t_rels)
    assert (len(got), got_dropped) == (len(want), want_dropped) == (1, 1)
    np.testing.assert_allclose(got[0].expected.translation, np.asarray(want[0].expected.translation),
                               atol=1e-3)
    np.testing.assert_allclose(got[0].expected.translation, [0.4, 0.0, 0.0], atol=0.05)
    assert isinstance(got[0].expected.translation, np.ndarray)


def test_io_modules_import_nothing_of_the_jax_package():
    """The slice's modules import with `dliom_tpu` and `jax` made to fail."""
    import subprocess
    import sys

    mods = ["dliom_tpu_torch.sensor.compressed_point_cloud", "dliom_tpu_torch.evaluation.ate",
            "dliom_tpu_torch.evaluation.ground_truth", "dliom_tpu_torch.runner.offline",
            "dliom_tpu_torch.map_builder"] + [
        f"dliom_tpu_torch.io.{m}" for m in ("geodesy", "serialization", "pbstream", "pointcloud_formats",
                                            "datasets", "assets_writer", "points_pipeline")]
    code = "import sys\nsys.modules['jax'] = None\nsys.modules['dliom_tpu'] = None\n" + "\n".join(
        f"import {m}" for m in mods) + "\nprint('ok')"
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert r.returncode == 0 and "ok" in r.stdout, r.stdout + r.stderr
