"""The port's cloud service (dliom_tpu_torch/cloud/) against the JAX
package's (dliom_tpu/cloud/).

  * tests/test_cloud_uploader.py's seven cases on the port's classes, with
    the same `_Recorder` stand-in: batch order, trajectory-id translation,
    a server restart without loss, a transient reconnect without
    re-registration, dead-lettering, the unknown-kind refusal and
    `submap_query` on a port `PoseGraph` on the CPU;
  * the wire both ways: every sensor RPC and uploader batch from either
    package's stub and uploader into either package's server records the
    same calls with equal arrays;
  * the slice on the CPU, on tests/test_torch_map_builder.py's `_overrides()`
    and `_stream()` with odometry and a fixed-frame position per scan: a
    port `MapBuilder` behind the port's server, fed by the port's stub, bit
    for bit against the same stream fed directly to a second port builder
    (every LioState tensor, the pose graph, every node pose), its query
    replies against the same calls in-process; the same stream through the
    JAX stub into the port's server and into the JAX server with a JAX
    `MapBuilder`: `node_poses` within 2e-3 before and 5e-3 m after
    `finish_trajectory`, every reply's dtypes equal; and the port server's
    `write_state` file loaded by the JAX package.
"""

import threading
import time
import warnings

import numpy as np
import pytest
import torch

from dliom_tpu.cloud import LocalTrajectoryUploader as JUploader
from dliom_tpu.cloud import MapBuilderServer as JServer
from dliom_tpu.cloud import MapBuilderStub as JStub
from dliom_tpu.common.config import load_config as j_load_config
from dliom_tpu.io.serialization import load_state as j_load_state
from dliom_tpu.map_builder import MapBuilder as JMapBuilder
from dliom_tpu_torch.backend.pose_graph import PoseGraph
from dliom_tpu_torch.cloud import LocalTrajectoryUploader, MapBuilderServer, MapBuilderStub
from dliom_tpu_torch.common.config import load_config as t_load_config
from dliom_tpu_torch.io.serialization import load_state, state_leaves
from dliom_tpu_torch.map_builder import MapBuilder
from dliom_tpu_torch.transform.rigid import Rigid3
from test_torch_map_builder import G, POSE_ATOL, _overrides, _stream
import torch_threads  # noqa: F401  (one torch thread per test process)

CPU = torch.device("cpu")
SCANS = 10  # static start, then motion that finishes two submaps
OPT_ATOL = 5e-3  # m, optimized poses after finish_trajectory (test_torch_map_builder.py)


class _Recorder:
    """MapBuilder stand-in recording every ingest call (the reference's
    mock_map_builder.h role in client_server_test.cc)."""

    def __init__(self):
        self.calls = []
        self.lock = threading.Lock()
        self._next_tid = 1  # 0 is the implicit default trajectory

    def add_trajectory_builder(self, range_sensor_ids=None):
        with self.lock:
            tid = self._next_tid
            self._next_tid += 1
            self.calls.append(("trajectory", tid, None))
            return tid

    def add_imu_data(self, time, acc, gyr, trajectory_id=0):
        with self.lock:
            self.calls.append(("imu", trajectory_id, float(time)))

    def add_range_data(self, time, points, times=None, sensor_id=None, trajectory_id=0):
        with self.lock:
            self.calls.append(("range", trajectory_id, float(time)))

    def finish_trajectory(self, trajectory_id=None):
        with self.lock:
            self.calls.append(("finish", trajectory_id, None))

    def of(self, kind):
        with self.lock:
            return [c for c in self.calls if c[0] == kind]


def _wait_drained(server, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if server._queue.unfinished_tasks == 0:
            return
        time.sleep(0.01)
    raise TimeoutError("server SLAM queue did not drain")


# ----- tests/test_cloud_uploader.py on the port's classes -----


def test_uploader_batches_in_order():
    rec = _Recorder()
    server = MapBuilderServer(rec)
    server.start()
    up = LocalTrajectoryUploader(*server.address, batch_size=8, flush_interval=0.02)
    # enqueue everything BEFORE starting the drain thread: the first pops
    # then always fill whole batches, making the batch count deterministic
    for i in range(50):
        up.add_imu_data(float(i), [0.0, 0.0, 9.8], [0.0, 0.0, 0.0])
    up.start()
    try:
        up.flush()
        _wait_drained(server)
        assert [t for _, _, t in rec.of("imu")] == [float(i) for i in range(50)]
        assert up.num_batches_sent == 7  # ceil(50 / 8) batch RPCs
        assert up.num_items_sent == 50
    finally:
        up.shutdown()
        server.shutdown()


def test_uploader_translates_trajectory_ids():
    rec = _Recorder()
    server = MapBuilderServer(rec)
    server.start()
    up = LocalTrajectoryUploader(*server.address, batch_size=4, flush_interval=0.01)
    up.start()
    try:
        local = up.add_trajectory(["lidar"])
        assert local == 0
        for i in range(8):
            up.add_range_data(float(i), np.zeros((4, 3), np.float32), trajectory_id=local)
        up.flush()
        _wait_drained(server)
        # the recorder minted cloud id 1 for the uploader's local id 0
        assert {tid for _, tid, _ in rec.of("range")} == {1}
    finally:
        up.shutdown()
        server.shutdown()


def test_uploader_survives_server_restart_without_loss():
    """A fresh server takes over the port mid-stream: the uploader
    reconnects, re-registers its trajectory (fresh cloud id) and delivers
    every enqueued datum at least once."""
    rec = _Recorder()
    server_a = MapBuilderServer(rec)
    server_a.start()
    host, port = server_a.address
    up = LocalTrajectoryUploader(host, port, batch_size=4, flush_interval=0.01, reconnect_backoff=0.05)
    up.start()
    local = up.add_trajectory()
    server_b = None
    try:
        for i in range(20):
            up.add_range_data(float(i), np.zeros((2, 3), np.float32), trajectory_id=local)
        up.flush()
        _wait_drained(server_a)
        server_a.shutdown()
        for i in range(20, 40):  # into the dead link: enqueue must not drop
            up.add_range_data(float(i), np.zeros((2, 3), np.float32), trajectory_id=local)
        time.sleep(0.3)  # let the upload thread hit the dead connection
        for _ in range(50):
            try:
                server_b = MapBuilderServer(rec, host=host, port=port)
                break
            except OSError:
                time.sleep(0.1)
        server_b.start()
        up.flush(timeout=30.0)
        _wait_drained(server_b)
        assert {t for _, _, t in rec.of("range")} == {float(i) for i in range(40)}
        tids = [tid for _, tid, _ in rec.of("range")]
        assert tids[0] == 1 and tids[-1] == 2  # re-registered on server B
        assert up.num_reconnects >= 2
    finally:
        up.shutdown()
        if server_b is not None:
            server_b.shutdown()


def test_transient_reconnect_does_not_reregister():
    """A reconnect to a surviving server (same boot token) reuses the cloud
    trajectory ids."""
    rec = _Recorder()
    server = MapBuilderServer(rec)
    server.start()
    up = LocalTrajectoryUploader(*server.address, batch_size=4, flush_interval=0.01,
                                 reconnect_backoff=0.02)
    up.start()
    local = up.add_trajectory()
    try:
        for i in range(8):
            up.add_range_data(float(i), np.zeros((2, 3), np.float32), trajectory_id=local)
        up.flush()
        _wait_drained(server)
        up._drop_connection()  # transient transport failure, the server lives on
        for i in range(8, 16):
            up.add_range_data(float(i), np.zeros((2, 3), np.float32), trajectory_id=local)
        up.flush()
        _wait_drained(server)
        assert len(rec.of("trajectory")) == 1
        assert {tid for _, tid, _ in rec.of("range")} == {1}
        assert {t for _, _, t in rec.of("range")} == {float(i) for i in range(16)}
        assert up.num_reconnects >= 2
    finally:
        up.shutdown()
        server.shutdown()


def test_rejected_batch_is_dead_lettered_not_retried():
    rec = _Recorder()
    server = MapBuilderServer(rec)
    server.start()
    up = LocalTrajectoryUploader(*server.address, batch_size=2, flush_interval=0.01,
                                 reconnect_backoff=0.02)
    local = up.add_trajectory()
    up.add_imu_data(0.0, [0.0, 0.0, 9.8], [0.0, 0.0, 0.0])
    up.add_imu_data(0.1, [0.0, 0.0, 9.8], [0.0, 0.0, 0.0])
    up._enqueue("bogus_kind", {}, local)
    up._enqueue("bogus_kind", {}, local)
    up.add_imu_data(0.2, [0.0, 0.0, 9.8], [0.0, 0.0, 0.0])
    up.add_imu_data(0.3, [0.0, 0.0, 9.8], [0.0, 0.0, 0.0])
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        up.start()
        try:
            up.flush(timeout=10.0)  # would time out if the uplink wedged
            _wait_drained(server)
        finally:
            up.shutdown()
            server.shutdown()
    assert any("dead-lettered" in str(x.message) for x in w)
    assert up.num_batches_rejected == 1 and up.num_items_rejected == 2
    assert len(up.dead_letters) == 1
    assert "unknown batch item kind" in up.dead_letters[0]["error"]
    assert [t for _, _, t in rec.of("imu")] == [0.0, 0.1, 0.2, 0.3]
    assert len(rec.of("trajectory")) == 1


def test_batch_rpc_rejects_unknown_kind():
    rec = _Recorder()
    server = MapBuilderServer(rec)
    server.start()
    stub = MapBuilderStub(*server.address)
    try:
        with pytest.raises(RuntimeError, match="unknown batch item kind"):
            stub._call("add_sensor_data_batch", items=[{"kind": "bogus", "params": {}}])
        assert len(rec.calls) == 0  # nothing partially enqueued
    finally:
        stub.close()
        server.shutdown()


class _SubmapHost:
    """map_builder stand-in owning a PoseGraph for the submap_query RPC."""

    def __init__(self, pose_graph):
        self.pose_graph = pose_graph

    def submap_query(self, submap_id):
        return self.pose_graph.submap_query(submap_id)


def test_submap_query_rpc_renders_headlessly():
    from dliom_tpu_torch.mapping.grid import make_grid, set_cells
    from dliom_tpu_torch.mapping.submap import grid_specs

    cfg = t_load_config("basic", {"trajectory_builder": {"submaps": {
        "high_resolution": 0.2, "low_resolution": 0.8, "high_resolution_extent": 128,
        "low_resolution_extent": 64}}})
    pg = PoseGraph(cfg.pose_graph, cfg.trajectory_builder, device=CPU)
    hi_spec, lo_spec = grid_specs(cfg.trajectory_builder.submaps)
    sid = pg.add_submap(Rigid3(np.array([1.0, 0, 0, 0]), np.zeros(3)))
    q = pg.submap_query(sid)
    assert q["finished"] is False and "texture" not in q  # pose-only while unfinished

    rng = np.random.default_rng(3)  # a wall of occupied cells
    cells = torch.as_tensor(np.stack([np.full(300, 20), rng.integers(-40, 40, 300),
                                      rng.integers(-5, 5, 300)], -1), dtype=torch.int32)
    hi = set_cells(make_grid(hi_spec), cells, torch.full((300,), 32000, dtype=torch.int32), hi_spec)
    pg.finish_submap(sid, hi, make_grid(lo_spec))

    server = MapBuilderServer(_SubmapHost(pg))
    server.start()
    stub = MapBuilderStub(*server.address)
    try:
        r = stub.submap_query(sid)
        assert r["finished"] is True and r["version"] == 0
        img = r["texture"]
        assert img.dtype == np.uint8 and img.ndim == 2
        assert img.max() > 128  # the wall renders as bright pixels
        assert r["meters_per_pixel"] > 0
        np.testing.assert_allclose(r["global_pose_q"], [1, 0, 0, 0])
        with pytest.raises(RuntimeError, match="does not exist"):
            stub.submap_query(99)
        assert stub.submap_query(sid)["submap_id"] == sid  # the connection stays usable
    finally:
        stub.close()
        server.shutdown()


class _SlowRecorder(_Recorder):
    def add_imu_data(self, time, acc, gyr, trajectory_id=0):
        threading.Event().wait(0.005)
        super().add_imu_data(time, acc, gyr, trajectory_id)


def test_shutdown_drains_acknowledged_items_and_stops():
    """Items acknowledged before shutdown are processed; the SLAM and
    accept threads then end."""
    rec = _SlowRecorder()
    server = MapBuilderServer(rec)
    server.start()
    stub = MapBuilderStub(*server.address)
    for i in range(40):
        stub.add_imu_data(float(i), [0.0, 0.0, G], [0.0, 0.0, 0.0])
    stub.close()
    server.shutdown()
    for t in server._threads:
        t.join(10)
    assert not any(t.is_alive() for t in server._threads)
    assert [t for _, _, t in rec.of("imu")] == [float(i) for i in range(40)]


class _TensorHost:
    """A stand-in whose query answers with tensors."""

    def submap_query(self, submap_id):
        return {"submap_id": submap_id, "texture": torch.arange(6, dtype=torch.uint8).reshape(2, 3),
                "global_pose_t": torch.zeros(3), "nested": [torch.ones(2, dtype=torch.float64)]}


def test_replies_reach_the_wire_as_host_numpy():
    server = MapBuilderServer(_TensorHost())
    server.start()
    stub = MapBuilderStub(*server.address)
    try:
        r = stub.submap_query(3)
        assert r["texture"].dtype == np.uint8 and r["texture"].tolist() == [[0, 1, 2], [3, 4, 5]]
        assert r["global_pose_t"].dtype == np.float32 and r["nested"][0].dtype == np.float64
    finally:
        stub.close()
        server.shutdown()


# ----- the wire both ways -----


class _FullRecorder(_Recorder):
    """A recorder of every ingest call with its arguments as host numpy."""

    def _add(self, *call):
        with self.lock:
            self.calls.append(call)

    def add_imu_data(self, time, acc, gyr, trajectory_id=0):
        self._add("imu", trajectory_id, time, np.asarray(acc), np.asarray(gyr))

    def add_range_data(self, time, points, times=None, sensor_id=None, trajectory_id=0):
        self._add("range", trajectory_id, time, np.asarray(points),
                  None if times is None else np.asarray(times), sensor_id)

    def add_fixed_frame_pose_data(self, time, position, trajectory_id=0):
        self._add("fixed_frame", trajectory_id, time, np.asarray(position))

    def add_navsat_data(self, time, latitude, longitude, altitude, trajectory_id=0):
        self._add("navsat", trajectory_id, time, latitude, longitude, altitude)

    def add_odometry_data(self, time, pose, trajectory_id=0):
        self._add("odometry", trajectory_id, time, np.asarray(pose.rotation), np.asarray(pose.translation))

    def add_landmark_data(self, time, landmark_id, position, trajectory_id=0):
        self._add("landmark", trajectory_id, time, landmark_id, np.asarray(position))


def _wire_session(server_cls, stub_cls, uploader_cls):
    """Every sensor RPC through `stub_cls` and every uploader kind through
    `uploader_cls` into `server_cls` around a recorder; its calls."""
    rec = _FullRecorder()
    server = server_cls(rec)
    server.start()
    stub = stub_cls(*server.address)
    up = uploader_cls(*server.address, batch_size=3, flush_interval=0.01)
    pts = np.random.default_rng(11).random((9600, 3)).astype(np.float32)
    try:
        tid = stub.add_trajectory(["lidar"])
        stub.add_imu_data(0.01, [0.1, 0.2, G], [0.0, 0.01, -0.02], trajectory_id=tid)
        stub.add_range_data(0.1, pts, np.linspace(0, 0.1, 9600), sensor_id="lidar", trajectory_id=tid)
        stub.add_range_data(0.2, pts[:5])
        stub.add_fixed_frame_pose_data(0.15, [1.0, 2.0, 3.0], trajectory_id=tid)
        stub.add_navsat_data(0.16, 48.1372149, 11.5748024, 517.1)
        stub.add_odometry_data(0.17, [1.0, 0.0, 0.0, 0.0], np.array([0.5, 0.25, 0.0]), trajectory_id=tid)
        stub.add_landmark_data(0.18, 7, [0.0, 1.0, 0.0])
        stub.finish_trajectory(tid)
        local = up.add_trajectory()
        up.add_imu_data(0.3, np.array([0.0, 0.0, G]), [0.0, 0.0, 0.5], trajectory_id=local)
        up.add_range_data(0.4, pts[::7], np.zeros(len(pts[::7])), trajectory_id=local)
        up.add_fixed_frame_pose_data(0.45, [4.0, 5.0, 6.0], trajectory_id=local)
        up.add_odometry_data(0.46, [0.0, 1.0, 0.0, 0.0], [1.0, 1.0, 1.0], trajectory_id=local)
        up.add_landmark_data(0.47, "tag", [2.0, 0.0, 1.0], trajectory_id=local)
        up.finish_trajectory(local)
        up.start()
        up.flush()
        _wait_drained(server)
        assert stub.ping() == 0 and stub._call("status")["num_errors"] == 0
    finally:
        up.shutdown()
        stub.close()
        server.shutdown()
    return rec.calls


def _same(x, y) -> bool:
    if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
        return (type(x) is type(y) and x.dtype == y.dtype and x.shape == y.shape
                and np.array_equal(x, y))
    if isinstance(x, (tuple, list)):
        return type(x) is type(y) and len(x) == len(y) and all(_same(a, b) for a, b in zip(x, y))
    return type(x) is type(y) and x == y


def test_wire_compatible_both_ways():
    want = _wire_session(JServer, JStub, JUploader)
    assert len(want) == 16
    for server_cls, stub_cls, uploader_cls in ((MapBuilderServer, JStub, JUploader),
                                               (JServer, MapBuilderStub, LocalTrajectoryUploader),
                                               (MapBuilderServer, MapBuilderStub, LocalTrajectoryUploader)):
        got = _wire_session(server_cls, stub_cls, uploader_cls)
        assert _same(got, want), (server_cls.__module__, stub_cls.__module__)


# ----- the slice -----


def _events(num_scans=SCANS):
    """`_stream` with odometry (the true pose at the scan stamp, before the
    scan) and a fixed-frame position 50 ms after each scan."""
    out, k = [], 0
    for kind, _, t, payload in _stream(num_scans):
        if kind == "imu":
            out.append(("imu", t, None))
            continue
        p = np.asarray([0.05 * max(0, k - 3), 0.0, 0.0], np.float32)
        out += [("odometry", t, p), ("range", t, payload), ("fixed_frame", t + 0.05, p)]
        k += 1
    return out


_IDENTITY = np.asarray([1.0, 0.0, 0.0, 0.0], np.float32)


def _feed(target, events, direct: bool):
    """The events into a MapBuilder (`direct`) or a stub of either package."""
    for kind, t, x in events:
        if kind == "imu":
            target.add_imu_data(t, [0.0, 0.0, G], [0.0, 0.0, 0.0])
        elif kind == "range":
            target.add_range_data(t, *x)
        elif kind == "fixed_frame":
            target.add_fixed_frame_pose_data(t, x)
        elif direct:
            target.add_odometry_data(t, Rigid3(_IDENTITY, x))
        else:
            target.add_odometry_data(t, _IDENTITY, x)


def _port_builder():
    return MapBuilder(t_load_config("basic", _overrides()), pipeline_depth=1, device=CPU)


def _serve(builder, stub_cls, events):
    """`builder` behind the port's server, fed through `stub_cls`; returns
    (server, stub) with the queue drained and the builder flushed in-process
    (the server has no flush RPC)."""
    server = MapBuilderServer(builder)
    server.start()
    stub = stub_cls(*server.address)
    _feed(stub, events, direct=False)
    _wait_drained(server)
    with server._lock:
        builder.flush()
    return server, stub


def _graph_differences(a, b, map_state=False):
    """Where port pose graph `b` differs from `a`, exactly. With `map_state`
    (`b` loaded from a saved map state, which keeps no sensor observations
    and node clouds quantized to 1 mm) the observations are skipped and the
    node clouds compared by their point counts."""
    out = []
    clouds = ("low_mask", "high_mask") if map_state else ("high_points", "high_mask", "low_points", "low_mask")
    lists = ("submaps", "nodes", "constraints") + (() if map_state else ("fixed_frame_observations",
                                                                          "odometry_links"))
    for name in lists:
        if len(getattr(a, name)) != len(getattr(b, name)):
            out.append(name)
    if out:
        return out

    def same_pose(x, y):
        return np.array_equal(x.rotation, y.rotation) and np.array_equal(x.translation, y.translation)

    for i, (x, y) in enumerate(zip(a.submaps, b.submaps)):
        if (x.finished, list(x.node_ids)) != (y.finished, list(y.node_ids)) \
                or not (same_pose(x.local_pose, y.local_pose) and same_pose(x.global_pose, y.global_pose)) \
                or not np.array_equal(x.histogram, y.histogram):
            out.append(f"submap {i}")
        if (x.high is None) != (y.high is None) or (x.high is not None and not all(
                torch.equal(u, v) for g, h in ((x.high, y.high), (x.low, y.low)) for u, v in zip(g, h))):
            out.append(f"submap {i} grids")
    for i, (x, y) in enumerate(zip(a.nodes, b.nodes)):
        if x.time != y.time or x.submap_ids != y.submap_ids \
                or not (same_pose(x.local_pose, y.local_pose) and same_pose(x.global_pose, y.global_pose)) \
                or not all(np.array_equal(getattr(x, f), getattr(y, f)) for f in ("histogram", "gravity_alignment")) \
                or not all((np.count_nonzero(getattr(x, f)) == np.count_nonzero(getattr(y, f))) if map_state
                           else np.array_equal(getattr(x, f), getattr(y, f)) for f in clouds):
            out.append(f"node {i}")
    for i, (x, y) in enumerate(zip(a.constraints, b.constraints)):
        if (x.submap_id, x.node_id, x.tag) != (y.submap_id, y.node_id, y.tag) \
                or not same_pose(x.relative, y.relative):
            out.append(f"constraint {i}")
    if map_state:
        return out
    for i, (x, y) in enumerate(zip(a.fixed_frame_observations, b.fixed_frame_observations)):
        if x[0] != y[0] or x[2] != y[2] or not np.array_equal(x[1], y[1]):
            out.append(f"fixed-frame {i}")
    for i, (x, y) in enumerate(zip(a.odometry_links, b.odometry_links)):
        if x[:2] != y[:2] or not same_pose(x[2], y[2]):
            out.append(f"odometry {i}")
    return out


def test_served_port_builder_matches_direct_bit_for_bit(tmp_path):
    events = _events()
    direct = _port_builder()
    _feed(direct, events, direct=True)
    direct.flush()
    served = _port_builder()
    server, stub = _serve(served, MapBuilderStub, events)
    try:
        status = stub._call("status")
        assert status["num_errors"] == 0 and status["last_error"] == ""
        pg, dg = served.pose_graph, direct.pose_graph
        assert sum(s.finished for s in pg.submaps) >= 1 and len(pg.nodes) >= 5
        assert pg.odometry_links and pg.fixed_frame_observations
        la, lb = list(state_leaves(direct.trajectory(0)._lio)), list(state_leaves(served.trajectory(0)._lio))
        assert [p for p, _ in la] == [p for p, _ in lb]
        assert all(torch.equal(x, y) for (_, x), (_, y) in zip(la, lb))
        assert _graph_differences(dg, pg) == []

        # queries over the wire against the same calls in-process
        times, trans, rots = stub.node_poses()
        nodes = served.optimized_node_poses()
        assert np.array_equal(times, [t for t, _ in nodes])
        assert np.array_equal(trans, np.stack([p.translation for _, p in nodes]))
        assert np.array_equal(rots, np.stack([p.rotation for _, p in nodes]))
        assert np.array_equal(stub.submap_poses(), np.stack([p.translation for p in pg.submap_poses()]))
        s, n, inter = stub.constraints()
        assert s.tolist() == [c.submap_id for c in pg.constraints]
        assert n.tolist() == [c.node_id for c in pg.constraints]
        assert inter.tolist() == [c.tag == "INTER" for c in pg.constraints]
        first = next(i for i, x in enumerate(pg.submaps) if x.finished)
        r, want = stub.submap_query(first), served.submap_query(first)
        assert set(r) == set(want) and np.array_equal(r["texture"], want["texture"])
        assert all(_same(r[k], want[k]) for k in want)
        path = str(tmp_path / "served.npz")
        stub.write_state(path)
        loaded = load_state(path, t_load_config("basic", _overrides()), device=CPU)
        assert _graph_differences(pg, loaded, map_state=True) == []
    finally:
        stub.close()
        server.shutdown()


def _replies(stub):
    """Every query reply of a served map, through a JAX stub."""
    out = {m: stub._call(m) for m in ("trajectory_states", "node_poses", "submap_poses", "constraints",
                                       "metrics", "status", "session_info", "ping")}
    out["occupancy_grid"] = stub._call("occupancy_grid", resolution=0.25)
    out["map_cloud"] = stub._call("map_cloud", voxel_size=0.2)
    out["submap_query"] = stub._call("submap_query", submap_id=0)
    return out


def _kinds(x):
    """The type structure of a reply: dtypes and ranks of arrays."""
    if isinstance(x, np.ndarray):
        return ("ndarray", str(x.dtype), x.ndim)
    if isinstance(x, dict):
        return {k: _kinds(v) for k, v in x.items() if k not in ("states", "text")}
    return type(x).__name__


def test_port_server_matches_jax_server(tmp_path):
    events = _events()
    port = _port_builder()
    server, stub = _serve(port, JStub, events)
    jserver = JServer(JMapBuilder(j_load_config("basic", _overrides())))
    jserver.start()
    jstub = JStub(*jserver.address)
    try:
        _feed(jstub, events, direct=False)
        _wait_drained(jserver)
        got, want = _replies(stub), _replies(jstub)
        for r in (got, want):
            assert r["status"]["num_errors"] == 0 and r["node_poses"]["translations"].shape[0] >= 5
        # The JAX package's submap poses are the frontend's float32 until its
        # SPA rewrites them as float64 (np_rigid); the port's host poses are
        # float64 from the start, so its submap_poses are float64 throughout.
        # Every other field has the JAX server's dtype before and after
        # finish_trajectory.
        assert want["submap_poses"]["translations"].dtype == np.float32
        assert got["submap_poses"]["translations"].dtype == np.float64
        got_kinds, want_kinds = _kinds(got), _kinds(want)
        del got_kinds["submap_poses"], want_kinds["submap_poses"]
        assert got_kinds == want_kinds
        assert got["trajectory_states"]["states"] == want["trajectory_states"]["states"]
        for k in ("translations", "rotations"):
            np.testing.assert_allclose(got["node_poses"][k], want["node_poses"][k], atol=POSE_ATOL)
        np.testing.assert_array_equal(got["node_poses"]["times"], want["node_poses"]["times"])
        assert sorted(zip(got["constraints"]["submap"].tolist(), got["constraints"]["node"].tolist())) == \
            sorted(zip(want["constraints"]["submap"].tolist(), want["constraints"]["node"].tolist()))

        path = str(tmp_path / "port.npz")
        stub.write_state(path)
        jpg = j_load_state(path, j_load_config("basic", _overrides()))
        assert len(jpg.nodes) == len(port.pose_graph.nodes)
        assert len(jpg.submaps) == len(port.pose_graph.submaps)
        np.testing.assert_allclose(np.stack([np.asarray(n.global_pose.translation) for n in jpg.nodes]),
                                   got["node_poses"]["translations"], atol=1e-5)

        stub.finish_trajectory()
        jstub.finish_trajectory()
        got, want = _replies(stub), _replies(jstub)
        assert got["status"]["num_errors"] == 0 and _kinds(got) == _kinds(want)
        np.testing.assert_allclose(got["node_poses"]["translations"], want["node_poses"]["translations"],
                                   atol=OPT_ATOL)
    finally:
        for s in (stub, jstub):
            s.close()
        server.shutdown()
        jserver.shutdown()
