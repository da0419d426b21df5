"""Robot-side batching uplink (LocalTrajectoryUploader analog).

Mirrors the reference's `LocalTrajectoryUploader`
(cloud/internal/local_trajectory_uploader.h:31-58, .cc ProcessSendQueue):
the robot-side frontend enqueues sensor data into a bounded queue; one
dedicated upload thread drains it, packs `batch_size` items into a single
`add_sensor_data_batch` RPC (served by the batch handler analog of
cloud/internal/handlers/add_sensor_data_batch_handler.cc), and translates
the robot's LOCAL trajectory ids into the uplink server's CLOUD ids at send
time (`TranslateTrajectoryId`, local_trajectory_uploader.cc:143).

Beyond the reference (whose gRPC client retries writes with an unlimited
constant-delay strategy on the SAME channel and never re-registers,
local_trajectory_uploader.cc:133-143), the reconnect path here also
survives a server RESTART: on connection loss the in-flight batch is
retained and resent. The uploader distinguishes the two failure worlds by
the server's boot/session token (`session_info` RPC): a reconnect to a
SURVIVING server (transient TCP reset / RPC timeout) reuses the existing
cloud trajectory ids — matching the reference's retry-without-re-register
semantics — while a token change (actual restart: the server's trajectory
registry is gone) re-registers every known local trajectory (fresh cloud
ids) and re-translates before resending. No enqueued datum is ever
dropped by transport failures; delivery is at-least-once and
order-preserving per uploader.

Application-level rejections (the server is alive and deterministically
refuses a batch, e.g. a malformed item kind) are NOT retried — retrying a
persistently rejected batch would wedge the uplink forever. Such batches
are dead-lettered (bounded `dead_letters` buffer + counters) and the
stream continues.

Port of dliom_tpu/cloud/uploader.py, unchanged but for its imports: it
speaks to either package's server.
"""

from __future__ import annotations

import threading
import time
import warnings
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from dliom_tpu_torch.cloud.client import MapBuilderStub


class LocalTrajectoryUploader:
    def __init__(
        self,
        host: str,
        port: int,
        batch_size: int = 100,
        queue_capacity: int = 4096,
        flush_interval: float = 0.05,
        reconnect_backoff: float = 0.2,
        rpc_timeout: float = 300.0,
    ):
        self._addr = (host, port)
        self._batch_size = int(batch_size)
        self._capacity = int(queue_capacity)
        self._flush_interval = float(flush_interval)
        self._backoff = float(reconnect_backoff)
        self._rpc_timeout = float(rpc_timeout)

        self._queue: deque = deque()  # items: {"kind", "params", local tid}
        self._not_full = threading.Condition()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._stub: Optional[MapBuilderStub] = None

        # local trajectory id -> (cloud id, range_sensor_ids); the cloud half
        # (TranslateTrajectoryId state) is valid for one server SESSION —
        # identified by the boot token below — and rebuilt only when the
        # token changes (server restart), never on a mere reconnect.
        self._trajectories: Dict[int, dict] = {}
        self._to_cloud: Dict[int, int] = {}
        self._server_token: Optional[str] = None
        self._traj_lock = threading.Lock()

        # observability
        self.num_batches_sent = 0
        self.num_items_sent = 0
        self.num_reconnects = 0
        self.num_batches_rejected = 0
        self.num_items_rejected = 0
        self.dead_letters: List[dict] = []  # last few rejected batches

    # ----- lifecycle (Start/Shutdown, local_trajectory_uploader.cc:97-110) --

    def start(self) -> None:
        assert self._thread is None, "already started"
        self._thread = threading.Thread(
            target=self._process_send_queue, daemon=True
        )
        self._thread.start()

    def shutdown(self) -> None:
        """Blocks until the queue is drained and the thread exits (the
        reference's Shutdown joins the upload thread)."""
        self.flush()
        self._stop.set()
        with self._not_full:
            self._not_full.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._stub is not None:
            self._stub.close()
            self._stub = None

    def flush(self, timeout: float = 120.0) -> None:
        """Block until everything enqueued so far has been acked."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._not_full:
                if not self._queue and not getattr(self, "_in_flight", 0):
                    return
            time.sleep(0.01)
        raise TimeoutError("uplink flush timed out")

    # ----- trajectory registration (AddTrajectory/FinishTrajectory) -----

    def add_trajectory(self, range_sensor_ids=None) -> int:
        """Register a LOCAL trajectory; the cloud id is created lazily by
        the upload thread (and re-created after reconnects). Returns the
        local id, which all enqueue calls below use."""
        with self._traj_lock:
            local_id = len(self._trajectories)
            self._trajectories[local_id] = {
                "range_sensor_ids": (
                    list(range_sensor_ids) if range_sensor_ids else None
                )
            }
        return local_id

    def finish_trajectory(self, local_trajectory_id: int = 0) -> None:
        self._enqueue("finish", {}, local_trajectory_id)

    # ----- sensor enqueue surface (EnqueueSensorData; the per-kind methods
    # mirror MapBuilderStub so a frontend can swap the two) -----

    def add_imu_data(
        self, time_s, linear_acceleration, angular_velocity, trajectory_id=0
    ) -> None:
        self._enqueue(
            "imu",
            {
                "time": float(time_s),
                "acc": np.asarray(linear_acceleration, np.float32),
                "gyr": np.asarray(angular_velocity, np.float32),
            },
            trajectory_id,
        )

    def add_range_data(
        self, time_s, points, point_times=None, sensor_id=None, trajectory_id=0
    ) -> None:
        params = {"time": float(time_s), "points": np.asarray(points, np.float32)}
        if point_times is not None:
            params["times"] = np.asarray(point_times, np.float32)
        if sensor_id is not None:
            params["sensor_id"] = sensor_id
        self._enqueue("range", params, trajectory_id)

    def add_fixed_frame_pose_data(self, time_s, position, trajectory_id=0):
        self._enqueue(
            "fixed_frame",
            {"time": float(time_s), "position": np.asarray(position, np.float32)},
            trajectory_id,
        )

    def add_odometry_data(self, time_s, rotation, translation, trajectory_id=0):
        self._enqueue(
            "odometry",
            {
                "time": float(time_s),
                "rotation": np.asarray(rotation, np.float32),
                "translation": np.asarray(translation, np.float32),
            },
            trajectory_id,
        )

    def add_landmark_data(
        self, time_s, landmark_id, position_in_tracking, trajectory_id=0
    ):
        self._enqueue(
            "landmark",
            {
                "time": float(time_s),
                "id": str(landmark_id),
                "position": np.asarray(position_in_tracking, np.float32),
            },
            trajectory_id,
        )

    def _enqueue(self, kind: str, params: dict, local_tid: int) -> None:
        with self._not_full:
            while len(self._queue) >= self._capacity and not self._stop.is_set():
                # bounded blocking queue, as the reference's send_queue_
                self._not_full.wait(0.1)
            if self._stop.is_set():
                raise RuntimeError("uploader is shut down")
            self._queue.append({"kind": kind, "params": params, "tid": local_tid})

    # ----- upload thread (ProcessSendQueue) -----

    def _process_send_queue(self) -> None:
        self._in_flight = 0
        pending: List[dict] = []  # popped but unacked items (resend buffer)
        last_send = time.monotonic()
        while True:
            with self._not_full:
                while self._queue and len(pending) < self._batch_size:
                    pending.append(self._queue.popleft())
                    self._not_full.notify_all()
                self._in_flight = len(pending)
            now = time.monotonic()
            full = len(pending) >= self._batch_size
            stale = pending and (now - last_send) >= self._flush_interval
            if full or stale or (pending and self._stop.is_set()):
                self._send_with_retry(pending)
                self.num_batches_sent += 1
                self.num_items_sent += len(pending)
                pending.clear()
                with self._not_full:
                    self._in_flight = 0
                last_send = now
            elif self._stop.is_set():
                return
            elif not pending:
                time.sleep(0.005)
            else:
                time.sleep(min(0.005, self._flush_interval / 4))

    def _send_with_retry(self, items: List[dict]) -> None:
        """One batch, at-least-once across TRANSPORT failures: retried over
        reconnects (and server restarts) until acked. Translation
        local->cloud happens here, per attempt, because a server restart
        mints fresh cloud ids. APPLICATION rejections (the server answered
        ok=False: it is alive and refuses this batch deterministically) are
        dead-lettered instead — retrying them would wedge the uplink and,
        before the session-token fix, minted an unbounded stream of empty
        trajectories on the live server."""
        while True:  # items is non-empty; drain even after stop is set
            try:
                stub = self._ensure_connected()
            except (OSError, ConnectionError):
                self._drop_connection()
                time.sleep(self._backoff)
                continue
            except RuntimeError:
                # server alive but rejected session query / registration:
                # back off and retry on the same connection — dropping it
                # would only churn
                time.sleep(self._backoff)
                continue
            wire_items = [
                {
                    "kind": it["kind"],
                    "params": dict(
                        it["params"],
                        trajectory_id=self._to_cloud.get(it["tid"], it["tid"]),
                    ),
                }
                for it in items
            ]
            try:
                stub._call("add_sensor_data_batch", items=wire_items)
                return
            except (OSError, ConnectionError):
                self._drop_connection()
                time.sleep(self._backoff)
            except RuntimeError as e:
                self.num_batches_rejected += 1
                self.num_items_rejected += len(items)
                self.dead_letters.append(
                    {"error": str(e), "items": list(items)}
                )
                del self.dead_letters[:-8]  # bounded
                warnings.warn(
                    f"uplink batch of {len(items)} items rejected by the "
                    f"server and dead-lettered: {e}",
                    stacklevel=2,
                )
                return

    def _ensure_connected(self) -> MapBuilderStub:
        if self._stub is None:
            self._stub = MapBuilderStub(
                self._addr[0], self._addr[1], timeout=self._rpc_timeout
            )
            self.num_reconnects += 1
            # Same server session (matching boot token) -> the existing
            # cloud ids are still valid; re-registering would fork the
            # stream onto brand-new server trajectories mid-flight. Only a
            # token CHANGE (restart: registry lost) invalidates them.
            try:
                token = self._stub._call("session_info").get("boot_token")
            except RuntimeError:
                token = None  # server without session_info: can't tell
            if token is None or token != self._server_token:
                self._to_cloud.clear()
                self._server_token = token
        # register any local trajectory this server session doesn't know yet
        # (first connect, post-restart, or added after the last connect)
        with self._traj_lock:
            missing = [
                (lid, info)
                for lid, info in sorted(self._trajectories.items())
                if lid not in self._to_cloud
            ]
        for local_id, info in missing:
            cloud_id = self._stub.add_trajectory(info["range_sensor_ids"])
            self._to_cloud[local_id] = cloud_id
        return self._stub

    def _drop_connection(self) -> None:
        if self._stub is not None:
            self._stub.close()
            self._stub = None
