"""Mapping server owning a MapBuilder; port of dliom_tpu/cloud/server.py.

Mirrors `MapBuilderServer` (cloud/internal/map_builder_server.cc): sensor
RPCs enqueue into a blocking queue (the handlers in cloud/internal/handlers/
add_{imu,rangefinder,fixed_frame,landmark}_data_handler.cc); one dedicated
SLAM thread drains it in arrival order (`ProcessSensorDataQueue` :142-153,
`StartSlamThread` :155-161); query RPCs read the pose graph under the
server's lock. `finish_trajectory` drains the queue, runs final optimization
and answers when done (finish_trajectory_handler.cc).

The server owns the `MapBuilder` it is given, on whatever device that
builder was made for (the card unless the caller asked for the CPU); it
moves nothing. What differs from the JAX package:
  * the odometry handler builds the port's numpy-backed `Rigid3` from the
    payload's float32 arrays;
  * every reply passes through `_host_reply`, which turns a tensor into host
    numpy (the replies below are numpy already, with the JAX server's
    dtypes), so a tensor never reaches the wire, whose encoder refuses one;
  * threads. Only the SLAM thread steps a frontend: forward-mode AD keeps
    process-global state (dliom_tpu_torch/ops/scan_matcher.py), so two
    threads stepping at once would crash. Connection threads read the pose
    graph, and `add_trajectory` constructs a trajectory builder, always under
    the server's lock, which the SLAM thread holds for each item, so neither
    overlaps a step;
  * streams. A query thread runs on the card's default stream, the stream
    the SLAM thread queues its steps and captured (compressed) submap grids
    on, so its reads of those grids are ordered after their writes, and
    `PoseGraph._host`'s `.cpu()` waits for them. What pool workers make on
    their own streams reaches a query only after the worker synchronized its
    stream: decompressed grids enter the pose graph's cache after
    `synchronize()` (`PoseGraph._decompressed_grids`), and submap images,
    SPA poses and search results are host numpy copied on the worker's
    stream before they are published. So no query reads a grid that is
    still being written, and nothing here synchronizes.
"""

from __future__ import annotations

import logging
import queue
import socket
import threading
import uuid

import numpy as np
import torch

from dliom_tpu_torch.cloud import wire
from dliom_tpu_torch.transform.rigid import Rigid3

_LOG = logging.getLogger("dliom_tpu_torch.cloud")
_SENSOR_KINDS = {"add_imu_data": "imu", "add_range_data": "range",
                 "add_fixed_frame_pose_data": "fixed_frame", "add_landmark_data": "landmark",
                 "add_odometry_data": "odometry", "add_navsat_data": "navsat"}
_BATCH_KINDS = {"imu", "range", "fixed_frame", "navsat", "odometry", "landmark", "finish"}


def _host_reply(obj):
    """A reply with every tensor in it turned into host numpy."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _host_reply(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_host_reply(v) for v in obj]
    return obj


def _stack(vectors, width: int) -> np.ndarray:
    """The JAX server's stacking: the vectors' own dtype, (0, width) float32
    when there are none."""
    return np.stack([np.asarray(v) for v in vectors]) if vectors else np.zeros((0, width), np.float32)


class MapBuilderServer:
    def __init__(self, map_builder, host: str = "127.0.0.1", port: int = 0):
        self.map_builder = map_builder
        # Boot/session token: minted once per server PROCESS. An uplink
        # client (LocalTrajectoryUploader) compares it across reconnects to
        # tell a transient transport failure to a surviving server (same
        # token -> its cloud trajectory ids are still valid, do NOT
        # re-register) from an actual server restart (new token -> the
        # trajectory registry is gone, re-register).
        self.boot_token = uuid.uuid4().hex
        self.num_errors = 0
        self.last_error = ""
        self._queue: queue.Queue = queue.Queue(maxsize=2048)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(8)
        self.address = self._listener.getsockname()
        self._threads = []
        self._conns: set = set()
        self._conns_lock = threading.Lock()

    # ----- lifecycle -----

    def start(self) -> None:
        """StartSlamThread + accept loop (both daemonized)."""
        for target in (self._slam_loop, self._accept_loop):
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)

    def shutdown(self) -> None:
        """Stop accepting and close the connections; the SLAM thread drains
        the acknowledged items, then both threads end."""
        self._stop.set()
        try:
            # wakes the accept loop, which a close alone leaves blocked in accept()
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        # Close live connections too: once the SLAM thread stops draining,
        # acking further sensor RPCs would fake acceptance of data that will
        # never be processed (an uplink client must instead see the failure
        # and retain its batch — LocalTrajectoryUploader resend semantics).
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass

    # ----- SLAM thread (ProcessSensorDataQueue) -----

    def _slam_loop(self) -> None:
        # Drain stays alive until the queue is empty even after shutdown():
        # an acked sensor RPC means "will be processed"; dropping queued
        # items at stop would silently break that contract for uplink
        # clients whose batches were already acknowledged.
        while not self._stop.is_set() or not self._queue.empty():
            try:
                kind, payload, done = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            try:
                with self._lock:
                    self._process(kind, payload)
            except Exception as e:  # noqa: BLE001
                # one malformed message must not kill the drain thread: the
                # queue would fill and every sensor RPC would block forever.
                # Record the error (surfaced by the status RPC) and keep
                # draining.
                _LOG.exception("SLAM thread: a %r item failed", kind)
                self.last_error = f"{kind}: {e!r}"
                self.num_errors += 1
            finally:
                if done is not None:
                    done.set()
                self._queue.task_done()

    def _process(self, kind: str, p: dict) -> None:
        mb = self.map_builder
        tid = int(p.get("trajectory_id", 0))
        if kind == "imu":
            mb.add_imu_data(p["time"], p["acc"], p["gyr"], trajectory_id=tid)
        elif kind == "range":
            mb.add_range_data(p["time"], p["points"], p.get("times"), p.get("sensor_id"), trajectory_id=tid)
        elif kind == "fixed_frame":
            mb.add_fixed_frame_pose_data(p["time"], p["position"], trajectory_id=tid)
        elif kind == "navsat":
            mb.add_navsat_data(p["time"], p["latitude"], p["longitude"], p["altitude"], trajectory_id=tid)
        elif kind == "odometry":
            pose = Rigid3(np.asarray(p["rotation"], np.float32), np.asarray(p["translation"], np.float32))
            mb.add_odometry_data(p["time"], pose, trajectory_id=tid)
        elif kind == "landmark":
            mb.add_landmark_data(p["time"], p["id"], p["position"], trajectory_id=tid)
        elif kind == "finish":
            mb.finish_trajectory(p.get("trajectory_id"))

    # ----- network -----

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            with self._conns_lock:
                self._conns.add(conn)
            t = threading.Thread(target=self._serve_conn, args=(conn,), daemon=True)
            t.start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            with conn:
                while not self._stop.is_set():
                    try:
                        msg = wire.recv_msg(conn)
                    except (OSError, ValueError):
                        return
                    if msg is None or self._stop.is_set():
                        return
                    try:
                        reply = _host_reply(self._handle(msg))
                    except Exception as e:  # handler errors answer, not kill
                        reply = {"ok": False, "error": f"{type(e).__name__}: {e}"}
                    try:
                        wire.send_msg(conn, reply)
                    except OSError:
                        return
        finally:
            with self._conns_lock:
                self._conns.discard(conn)

    # ----- handlers (cloud/internal/handlers/) -----

    def _handle(self, msg) -> dict:
        method = msg.get("method")
        p = msg.get("params", {})
        if not isinstance(method, str):
            return {"ok": False, "error": f"unknown method {method!r}"}
        if method in _SENSOR_KINDS:
            self._queue.put((_SENSOR_KINDS[method], p, None))
            return {"ok": True}
        handler = getattr(self, f"_rpc_{method}", None)
        if handler is None:
            return {"ok": False, "error": f"unknown method {method!r}"}
        return handler(p)

    def _rpc_add_sensor_data_batch(self, p) -> dict:
        # batching uplink (add_sensor_data_batch_handler.cc): one RPC
        # carries many sensor items from a LocalTrajectoryUploader; all
        # enqueue in order, the ack means "accepted into the SLAM queue"
        items = p.get("items", [])
        for item in items:
            if item.get("kind") not in _BATCH_KINDS:
                return {"ok": False, "error": f"unknown batch item kind {item.get('kind')!r}"}
        for item in items:
            self._queue.put((item["kind"], item.get("params", {}), None))
        return {"ok": True, "count": len(items)}

    def _rpc_submap_query(self, p) -> dict:
        # per-submap texture+pose query (MapBuilder::SubmapToProto,
        # map_builder.cc:186-204; ROS SubmapQuery service, node.cc:107-114)
        with self._lock:
            return dict(self.map_builder.submap_query(int(p["submap_id"])), ok=True)

    def _rpc_add_trajectory(self, p) -> dict:
        # synchronous (add_trajectory_handler): the id must return
        with self._lock:
            tid = self.map_builder.add_trajectory_builder(p.get("range_sensor_ids"))
        return {"ok": True, "trajectory_id": tid}

    def _rpc_finish_trajectory(self, p) -> dict:
        done = threading.Event()
        self._queue.put(("finish", p, done))
        done.wait()
        return {"ok": True}

    def _rpc_trajectory_states(self, p) -> dict:
        with self._lock:
            states = self.map_builder.pose_graph.trajectory_states()
        return {"ok": True, "states": {str(k): v for k, v in states.items()}}

    def _rpc_node_poses(self, p) -> dict:
        with self._lock:
            nodes = self.map_builder.optimized_node_poses()
        return {"ok": True,
                "times": np.asarray([t for t, _ in nodes], np.float64),
                "translations": _stack([pose.translation for _, pose in nodes], 3),
                "rotations": _stack([pose.rotation for _, pose in nodes], 4)}

    def _rpc_submap_poses(self, p) -> dict:
        with self._lock:
            poses = self.map_builder.pose_graph.submap_poses()
        return {"ok": True, "translations": _stack([pose.translation for pose in poses], 3)}

    def _rpc_constraints(self, p) -> dict:
        with self._lock:
            cs = list(self.map_builder.pose_graph.constraints)
        return {"ok": True,
                "submap": np.asarray([c.submap_id for c in cs], np.int32),
                "node": np.asarray([c.node_id for c in cs], np.int32),
                "inter": np.asarray([c.tag == "INTER" for c in cs], bool)}

    def _rpc_metrics(self, p) -> dict:
        return {"ok": True, "text": self.map_builder.metrics_text()}

    def _world_cloud(self) -> np.ndarray:
        """Node clouds under the current optimized poses. The host refs are
        snapshot under the lock; the O(nodes) transform work runs outside it
        so a polling viewer never stalls the SLAM thread."""
        from dliom_tpu_torch.io.assets_writer import aggregate_point_cloud, snapshot_node_clouds

        with self._lock:
            snap = snapshot_node_clouds(self.map_builder.pose_graph)
        return aggregate_point_cloud(snapshot=snap)

    def _rpc_occupancy_grid(self, p) -> dict:
        # live top-down occupancy surface (occupancy_grid_node analog)
        from dliom_tpu_torch.io.assets_writer import xray_image

        res = float(p.get("resolution", 0.2))
        img, origin = xray_image(self._world_cloud(), res)
        return {"ok": True, "image": img, "origin_xy": origin, "resolution": res}

    def _rpc_map_cloud(self, p) -> dict:
        # full-map point cloud under current optimized poses (node.cc
        # full-map publisher analog); optional voxel downsample
        from dliom_tpu_torch.io.assets_writer import voxel_dedup

        pts = self._world_cloud()
        voxel = float(p.get("voxel_size", 0.0))
        if voxel > 0.0 and len(pts):
            pts = voxel_dedup(pts, voxel)
        return {"ok": True, "points": pts.astype(np.float32)}

    def _rpc_status(self, p) -> dict:
        return {"ok": True, "queue_depth": self._queue.qsize(), "num_errors": self.num_errors,
                "last_error": self.last_error}

    def _rpc_write_state(self, p) -> dict:
        from dliom_tpu_torch.io.serialization import save_state

        with self._lock:
            save_state(p["path"], self.map_builder.pose_graph)
        return {"ok": True}

    def _rpc_session_info(self, p) -> dict:
        return {"ok": True, "boot_token": self.boot_token}

    def _rpc_ping(self, p) -> dict:
        return {"ok": True, "queued": self._queue.qsize(), "boot_token": self.boot_token}
