"""Client stub (MapBuilderStub, cloud/client/map_builder_stub.cc): the same
call surface as MapBuilder, forwarded over the wire — a robot-side frontend
uses it as a drop-in MapBuilder replacement (LocalTrajectoryUploader role).
Port of dliom_tpu/cloud/client.py: the same methods, casts and replies; it
talks to either package's server."""

from __future__ import annotations

import socket
import threading

import numpy as np

from dliom_tpu_torch.cloud import wire


class MapBuilderStub:
    # Default generous: on a card the first scan builds the CUDA kernels
    # with nvcc (and the native pool with g++) at first use, a step costs
    # about a second of host dispatch, a sensor RPC blocks while the
    # server's queue is full, and finish_trajectory runs the final
    # optimization — a tight RPC timeout turns host load into spurious
    # stream desyncs.
    def __init__(self, host: str, port: int, timeout: float = 300.0):
        self._addr = (host, port)
        self._timeout = timeout
        self._sock = socket.create_connection(self._addr, timeout=timeout)
        self._lock = threading.Lock()

    def _call(self, method: str, **params):
        with self._lock:
            try:
                wire.send_msg(self._sock, {"method": method, "params": params})
                reply = wire.recv_msg(self._sock)
            except OSError:
                # A timed-out/failed call leaves the request/reply stream
                # desynchronized (the late reply would be read as the NEXT
                # call's response). Drop the connection so the next call
                # starts on a clean stream, then re-raise.
                try:
                    self._sock.close()
                finally:
                    self._sock = socket.create_connection(
                        self._addr, timeout=self._timeout
                    )
                raise
        if reply is None:
            raise ConnectionError("server closed connection")
        if not reply.get("ok"):
            raise RuntimeError(reply.get("error", "remote error"))
        return reply

    # ----- MapBuilder surface -----

    def add_trajectory(self, range_sensor_ids=None) -> int:
        """AddTrajectory RPC (add_trajectory_handler.cc): a new trajectory
        on the server's map; returns its id for subsequent sensor calls."""
        params = {}
        if range_sensor_ids is not None:
            params["range_sensor_ids"] = list(range_sensor_ids)
        return int(self._call("add_trajectory", **params)["trajectory_id"])

    def add_imu_data(
        self, time, linear_acceleration, angular_velocity, trajectory_id=0
    ):
        self._call(
            "add_imu_data",
            time=float(time),
            acc=np.asarray(linear_acceleration, np.float32),
            gyr=np.asarray(angular_velocity, np.float32),
            trajectory_id=int(trajectory_id),
        )

    def add_range_data(
        self, time, points, point_times=None, sensor_id=None, trajectory_id=0
    ):
        params = {
            "time": float(time),
            "points": np.asarray(points, np.float32),
            "trajectory_id": int(trajectory_id),
        }
        if point_times is not None:
            params["times"] = np.asarray(point_times, np.float32)
        if sensor_id is not None:
            params["sensor_id"] = sensor_id
        self._call("add_range_data", **params)

    def add_fixed_frame_pose_data(self, time, position, trajectory_id=0):
        self._call(
            "add_fixed_frame_pose_data",
            time=float(time),
            position=np.asarray(position, np.float32),
            trajectory_id=int(trajectory_id),
        )

    def add_navsat_data(
        self, time, latitude, longitude, altitude, trajectory_id=0
    ):
        self._call(
            "add_navsat_data",
            time=float(time),
            latitude=float(latitude),
            longitude=float(longitude),
            altitude=float(altitude),
            trajectory_id=int(trajectory_id),
        )

    def add_odometry_data(self, time, rotation, translation, trajectory_id=0):
        self._call(
            "add_odometry_data",
            time=float(time),
            rotation=np.asarray(rotation, np.float32),
            translation=np.asarray(translation, np.float32),
            trajectory_id=int(trajectory_id),
        )

    def add_landmark_data(
        self, time, landmark_id, position_in_tracking, trajectory_id=0
    ):
        self._call(
            "add_landmark_data",
            time=float(time),
            id=str(landmark_id),
            position=np.asarray(position_in_tracking, np.float32),
            trajectory_id=int(trajectory_id),
        )

    def finish_trajectory(self, trajectory_id=None):
        if trajectory_id is None:
            self._call("finish_trajectory")
        else:
            self._call("finish_trajectory", trajectory_id=int(trajectory_id))

    def trajectory_states(self) -> dict:
        return {
            int(k): v
            for k, v in self._call("trajectory_states")["states"].items()
        }

    # ----- queries -----

    def node_poses(self):
        r = self._call("node_poses")
        return r["times"], r["translations"], r["rotations"]

    def submap_poses(self):
        return self._call("submap_poses")["translations"]

    def constraints(self):
        r = self._call("constraints")
        return r["submap"], r["node"], r["inter"]

    def metrics_text(self) -> str:
        return self._call("metrics")["text"]

    def occupancy_grid(self, resolution: float = 0.2):
        """Live top-down occupancy image (occupancy_grid_node analog).
        Returns (uint8 image, origin_xy, resolution)."""
        r = self._call("occupancy_grid", resolution=float(resolution))
        return r["image"], r["origin_xy"], r["resolution"]

    def submap_query(self, submap_id: int) -> dict:
        """Per-submap texture + pose (SubmapQuery service analog,
        cartographer_ros/node.cc:107-114): dict with poses/version and,
        for finished submaps, a uint8 top-down texture + meters_per_pixel."""
        r = dict(self._call("submap_query", submap_id=int(submap_id)))
        r.pop("ok", None)
        return r

    def map_cloud(self, voxel_size: float = 0.0) -> np.ndarray:
        """Full-map point cloud under the current optimized poses (node.cc
        full-map publisher analog); voxel_size > 0 downsamples."""
        return self._call("map_cloud", voxel_size=float(voxel_size))["points"]

    def write_state(self, path: str):
        self._call("write_state", path=path)

    def ping(self) -> int:
        return self._call("ping")["queued"]

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass
