"""Top-level mapping API (port of dliom_tpu/map_builder.py; reference
MapBuilder + GlobalTrajectoryBuilder + CollatedTrajectoryBuilder,
map_builder.cc:73-169, global_trajectory_builder.cc).

`MapBuilder` owns the pose graph and N per-trajectory frontend chains.
Per trajectory, IMU samples buffer on the host between scans; the first
`frames_for_static_initialization` scans feed the static initializer
(InitializeStatic, local_trajectory_builder_3d.cc:203-229), or, with
`enable_ndt_initialization`, the scans and IMU samples feed the dynamic
initializer (InitilizeByNDT, :231-330) until it aligns a moving window;
afterwards every scan runs the LIO step on `device`, and its results flow
to `PoseGraph.add_node`.

The compiled step. Each trajectory steps through its own
`make_jit_lio_step`: on the card a CUDA graph bound to its banks (the
graphs share one memory pool), whose first step after initialization is
the warm-up, eager, and every later one a replay; on the CPU the same
static buffers and copies with the body run eagerly. Each scan's input is
written into one pinned host buffer and goes to the graph's static input
in one non-blocking copy. The graph's state and result are overwritten by the
next replay, so whatever outlives a step is copied or read before the next
one is queued: the fetch below packs its fields into a new tensor, the
finished grids are compressed into new tensors, and a checkpoint copies
the state to the host. A restored checkpoint makes new trajectory
builders, so their graphs capture again at their first step; a state put
into `_lio` otherwise is copied into the graph's buffers at the next step.

One device-to-host copy per scan: every field the host bookkeeping needs
is packed into one float32 tensor and copied once. With `pipeline_depth=1`
that copy goes non-blocking into pinned memory with a CUDA event and is
read when the next scan arrives; results lag ingestion by one scan and
`flush()` drains the tail.

Captured grids. The submap banks are updated in place, and the step after
a submap finishes recycles that submap's slot. So the finished submap's
grids are captured — compressed into new tensors (`compress` for a dense
grid, `compress_brick` for a brick grid) — from the post-step state of the
scan that finished it, before the next step is queued. Under
pipelining the pending scan's fetch is therefore read at the start of the
next scan, before its step, rather than after it as in the JAX package.

Saved maps and checkpoints (`io/serialization.py`, `io/pbstream.py`):
`save_checkpoint` snapshots a running builder and
`map_builder_from_checkpoint` resumes it; `map_builder_from_state` loads a
saved map (.npz or a Cartographer .pbstream) to localize against or extend.
"""

from __future__ import annotations

import time as _wall
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from dliom_tpu_torch.backend.compression import compress
from dliom_tpu_torch.backend.pose_graph import NodeRecord, PoseGraph
from dliom_tpu_torch.common.config import EngineConfig
from dliom_tpu_torch.common.device import get_device
from dliom_tpu_torch.common.graph import sum_counts
from dliom_tpu_torch.frontend.lio import LioScanInput, LioState, make_jit_lio_step, make_lio_state
from dliom_tpu_torch.imu import preintegration as pre
from dliom_tpu_torch.imu.dynamic_initializer import DynamicInitializer
from dliom_tpu_torch.imu.initialization import static_initialize
from dliom_tpu_torch.mapping.brick_grid import compress_brick
from dliom_tpu_torch.mapping.submap import brick_spec, brick_spec_low, grid_specs
from dliom_tpu_torch.metrics import global_registry, register_all_metrics
from dliom_tpu_torch.metrics.metrics import RateTimer
from dliom_tpu_torch.sensor.range_synchronizer import RangeDataSynchronizer
from dliom_tpu_torch.sensor.types import pad_point_cloud
from dliom_tpu_torch.transform.interpolation import TransformInterpolationBuffer
from dliom_tpu_torch.transform.rigid import Rigid3

class _Fetch:
    """One scan's host-bound fields, packed into one float32 tensor and
    copied to the host in one transfer (non-blocking into pinned memory
    with an event when `non_blocking`)."""

    def __init__(self, fields: Dict[str, torch.Tensor], non_blocking: bool):
        self.layout = [(k, tuple(v.shape), v.dtype) for k, v in fields.items()]
        flat = torch.cat([v.reshape(-1).to(torch.float32) for v in fields.values()])
        self.event = None
        if flat.device.type == "cuda":
            self.host = torch.empty(flat.shape, dtype=torch.float32, pin_memory=True)
            self.host.copy_(flat, non_blocking=non_blocking)
            if non_blocking:
                self.event = torch.cuda.Event()
                self.event.record(torch.cuda.current_stream(flat.device))
        else:
            self.host = flat.clone()

    def read(self) -> Dict[str, np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        flat = self.host.numpy()
        out, o = {}, 0
        for name, shape, dtype in self.layout:
            n = int(np.prod(shape)) if shape else 1
            v = flat[o:o + n].reshape(shape)
            if dtype == torch.bool:
                v = v > 0.5
            elif dtype in (torch.int32, torch.int64):
                v = np.rint(v).astype(np.int64)
            else:
                v = v.copy()
            out[name] = v
            o += n
        return out


class _TrajectoryBuilder:
    """One CollatedTrajectoryBuilder -> GlobalTrajectoryBuilder ->
    LocalTrajectoryBuilder3D chain: the per-trajectory sensor state machine
    and frontend, forwarding into the shared pose graph."""

    def __init__(self, parent: "MapBuilder", trajectory_id: int, range_sensor_ids: List[str],
                 use_native_collator: bool, config: Optional[EngineConfig] = None):
        self.parent = parent
        self.trajectory_id = trajectory_id
        self.config = config or parent.config
        self.tb = self.config.trajectory_builder
        self.device = parent.device
        self._dyn_init = (DynamicInitializer(self.tb, self.device)
                          if self.tb.enable_ndt_initialization else None)
        self._synchronizer = RangeDataSynchronizer(range_sensor_ids, self.tb.scan_period)
        self._lio: Optional[LioState] = None
        self._step = None  # the compiled step (make_jit_lio_step), made at the first step
        self._initialized = False
        self._init_acc: List[np.ndarray] = []
        self._init_gyr: List[np.ndarray] = []
        self._init_frames = 0
        self._imu_times: List[float] = []
        self._imu_acc: List[np.ndarray] = []
        self._imu_gyr: List[np.ndarray] = []
        self._last_imu_time: Optional[float] = None
        self._time_origin: Optional[float] = None
        self._results: List[dict] = []
        self._pg_submap_ids: List[int] = []  # frontend submap id -> pose-graph id
        self._ff_buffer: List[Tuple[float, np.ndarray]] = []
        self._lm_buffer: List[Tuple[float, str, np.ndarray]] = []
        self._odom_buffer = TransformInterpolationBuffer()
        self._navsat = None  # NavSatConverter, anchored by the first fix
        self._collator = None
        self._last_queue_time: dict = {}
        self.num_out_of_order_dropped = 0
        self.finished = False
        self._prev_node = None  # (pose-graph node id, time) of the last node
        self._pending: Optional[Tuple] = None  # (time, _Fetch, t0) awaiting its read
        self._accum_points: List[np.ndarray] = []
        self._accum_times: List[np.ndarray] = []
        if use_native_collator:
            from dliom_tpu_torch.native import OrderedMultiQueue

            self._collator = OrderedMultiQueue(["imu"] + list(range_sensor_ids))

    # ----- sensor ingest -----

    def _drain_collator(self) -> Optional[dict]:
        out = None
        for queue, t, payload in self._collator.dispatch():
            if queue == "imu":
                self._handle_imu_data(t, *payload)
            else:
                res = self._handle_range_data(t, payload[0], payload[1], queue)
                if res is not None:
                    out = res
        return out

    def add_imu_data(self, time, linear_acceleration, angular_velocity):
        """SensorBridge::HandleImuMessage -> AddImuData."""
        if self._collator is not None:
            self._collator.add("imu", float(time), (linear_acceleration, angular_velocity))
            self._drain_collator()
            return
        if self._reject_out_of_order("imu", float(time)):
            return
        self._handle_imu_data(time, linear_acceleration, angular_velocity)

    def _reject_out_of_order(self, queue: str, time: float, allow_equal: bool = False) -> bool:
        """Per-queue monotonicity (ordered_multi_queue.cc:112): a decreasing
        stamp (or, for IMU, a repeated one) is dropped with a warning."""
        last = self._last_queue_time.get(queue)
        if last is not None and (time < last if allow_equal else time <= last):
            self.num_out_of_order_dropped += 1
            warnings.warn(
                f"out-of-order {queue} sample dropped: t={time:.6f} <= last dispatched "
                f"t={last:.6f} (trajectory {self.trajectory_id}); feed sensors in time order or "
                "enable the native collator (MapBuilder(use_native_collator=True))",
                stacklevel=3)
            return True
        self._last_queue_time[queue] = time
        return False

    def _handle_imu_data(self, time, linear_acceleration, angular_velocity):
        self.parent._pulse(self.trajectory_id, "imu", time)
        acc = np.asarray(linear_acceleration, np.float32)
        gyr = np.asarray(angular_velocity, np.float32)
        if not self._initialized:
            self._init_acc.append(acc)
            self._init_gyr.append(gyr)
            if self._dyn_init is not None:
                self._dyn_init.add_imu(float(time), acc, gyr)
        self._imu_times.append(float(time))
        self._imu_acc.append(acc)
        self._imu_gyr.append(gyr)

    def add_odometry_data(self, time, pose: Rigid3):
        """Buffered odometry; out-of-order or repeated stamps are dropped."""
        if len(self._odom_buffer) and float(time) <= self._odom_buffer.latest_time:
            return
        self._odom_buffer.push(float(time), pose)

    def _imu_bridge(self, scan_time: float, warn_overflow: bool = True):
        """Consume buffered samples up to `scan_time` into a fixed-capacity
        numpy batch (dts from consecutive stamps). The capacity scales with
        num_accumulated_range_data; overflow drops the oldest with a warning."""
        cap = self.tb.max_imu_per_scan * max(1, self.tb.num_accumulated_range_data)
        take = 0
        while take < len(self._imu_times) and self._imu_times[take] <= scan_time:
            take += 1
        times = self._imu_times[:take]
        accs = self._imu_acc[:take]
        gyrs = self._imu_gyr[:take]
        del self._imu_times[:take], self._imu_acc[:take], self._imu_gyr[:take]
        dts = []
        last = self._last_imu_time
        for t in times:
            dts.append((t - last) if last is not None else 1.0 / 500.0)
            last = t
        if times:
            self._last_imu_time = times[-1]
        n = min(len(times), cap)
        if len(times) > cap and warn_overflow:
            warnings.warn(
                f"IMU bridge overflow: {len(times)} samples this window > capacity {cap}; "
                f"dropping the oldest {len(times) - cap} (preintegration window shortens — raise "
                "trajectory_builder.max_imu_per_scan)", stacklevel=2)
        out_dt = np.zeros(cap, np.float32)
        out_a = np.zeros((cap, 3), np.float32)
        out_g = np.zeros((cap, 3), np.float32)
        if n:
            out_dt[:n] = np.asarray(dts[-n:], np.float32)
            out_a[:n] = np.asarray(accs[-n:], np.float32)
            out_g[:n] = np.asarray(gyrs[-n:], np.float32)
        return out_dt, out_a, out_g, np.arange(cap) < n

    def add_range_data(self, time, points, point_times=None, sensor_id=None) -> Optional[dict]:
        if self._collator is not None:
            self._collator.add(sensor_id or self._synchronizer.primary, float(time),
                               (points, point_times))
            return self._drain_collator()
        if self._reject_out_of_order(sensor_id or self._synchronizer.primary, float(time),
                                     allow_equal=True):
            return None
        return self._handle_range_data(time, points, point_times, sensor_id)

    def _handle_range_data(self, time, points, point_times=None, sensor_id=None) -> Optional[dict]:
        """SensorBridge -> AddRangeData: secondary LiDARs buffer into the
        synchronizer; the primary triggers a step with the merged cloud.
        Returns a result dict (of the previous scan under pipelining)."""
        sensor_id = sensor_id or self._synchronizer.primary
        self.parent._pulse(self.trajectory_id, sensor_id, time)
        merged = self._synchronizer.add_range_data(
            sensor_id, time, points, point_times, synthesize_times=self.tb.manual_deskew_stamps)
        if merged is None:
            return None
        time, points, point_times = merged
        if not self._initialized and self._dyn_init is not None:
            # dynamic (in-motion) initialization (InitilizeByNDT)
            result = self._dyn_init.add_scan(time, points)
            if result is None:
                return None
            self._lio = make_lio_state(self.tb, result.nav, result.ba, result.bg)
            self._initialized = True
            self._init_acc.clear()
            self._init_gyr.clear()
            # flush stale IMU so the bridge starts at this scan
            self._imu_bridge(time, warn_overflow=False)
            return None
        if not self._initialized:
            self._init_frames += 1
            if self._init_frames > self.tb.frames_for_static_initialization:
                self._initialize_static()
            if not self._initialized:
                return None
            # the first step's preintegration covers one scan interval, not
            # the whole static phase
            self._imu_bridge(time - self.tb.scan_period, warn_overflow=False)

        n_acc = max(1, self.tb.num_accumulated_range_data)
        if n_acc > 1:
            if point_times is None:
                point_times = np.zeros(len(points), np.float32)
            self._accum_points.append(np.asarray(points, np.float32))
            self._accum_times.append(np.asarray(point_times, np.float32) + float(time))
            if len(self._accum_points) < n_acc:
                return None
            points = np.concatenate(self._accum_points)
            point_times = (np.concatenate(self._accum_times) - float(time)).astype(np.float32)
            self._accum_points.clear()
            self._accum_times.clear()

        cloud = pad_point_cloud(points, point_times, self.tb.max_raw_points // 8)
        dts, accs, gyrs, imask = self._imu_bridge(time)
        # trajectory-relative time before the f32 cast (absolute stamps
        # would quantize the motion filter's dt to zero)
        if self._time_origin is None:
            self._time_origin = float(time)
        arrays = LioScanInput(np.float32(time - self._time_origin), cloud.points, cloud.times,
                              cloud.mask, dts, accs, gyrs, imask)
        pipelined = self.parent._pipeline_depth > 0
        # the pending scan is read (and its finished grids captured) before
        # this step can recycle their slot
        prev = self._read_pending() if pipelined else None
        t0 = _wall.perf_counter()
        self._lio, res = self._lio_step(arrays)
        self.parent.pose_graph._phase("ingest_dispatch", _wall.perf_counter() - t0)
        fetch = self._start_fetch(res, non_blocking=pipelined)
        if pipelined:
            self._pending = (time, fetch, t0)
            return self._complete_scan(*prev) if prev is not None else None
        host = fetch.read()
        return self._complete_scan(time, host, self._capture_grids(host), t0)

    def _lio_step(self, arrays: LioScanInput):
        """One LIO step on the host arrays of a scan, through the compiled
        step (module docstring)."""
        if self._step is None:
            inp = LioScanInput(*(torch.from_numpy(np.asarray(a)).to(self.device) for a in arrays))
            self._step = make_jit_lio_step(self.tb)
            return self._step(self._lio, inp)
        self._step.load_state(self._lio)
        self._step.stage_input(arrays)
        self._step.step()
        return self._step.state, self._step.result

    def _start_fetch(self, res, non_blocking: bool) -> _Fetch:
        submaps = self._lio.frontend.submaps
        fields = {
            "matcher_cost": res.scan.matcher_cost,
            "failed": res.failed,
            "inserted": res.scan.inserted,
            "finished_submap": res.scan.finished_submap,
            "insertion_submap_ids": res.scan.insertion_submap_ids,
            "gravity_alignment": res.scan.gravity_alignment,
            "local_q": res.scan.local_pose.rotation,
            "local_t": res.scan.local_pose.translation,
            "velocity": res.velocity,
            "num_created": submaps.num_created,
            "pending_spawn": submaps.pending_spawn,
            "pose_rotation": submaps.pose_rotation,
            "pose_translation": submaps.pose_translation,
            "pending_rotation": submaps.pending_rotation,
            "pending_translation": submaps.pending_translation,
            "high_points": res.scan.high_points,
            "high_mask": res.scan.high_mask,
            "low_points": res.scan.low_points,
            "low_mask": res.scan.low_mask,
            "histogram": res.scan.histogram,
        }
        if submaps.high_brick is not None:
            fields["hi_dropped"] = submaps.high_brick.dropped
        if submaps.low_brick is not None:
            fields["lo_dropped"] = submaps.low_brick.dropped
        if submaps.dense_dropped is not None:
            fields["dense_dropped"] = submaps.dense_dropped
        return _Fetch(fields, non_blocking)

    def _read_pending(self):
        """Read the pending scan's fetch and capture its finished grids from
        the current (its own post-step) state; returns the arguments of
        `_complete_scan`, or None."""
        if self._pending is None:
            return None
        time, fetch, t0 = self._pending
        self._pending = None
        t_get = _wall.perf_counter()
        host = fetch.read()
        self.parent.pose_graph._phase("ingest_get", _wall.perf_counter() - t_get)
        return time, host, self._capture_grids(host), t0

    def _capture_grids(self, host):
        """Compressed copies of the grids of the submap finished by this
        scan, or None. They are new tensors, queued before the next step."""
        finished = int(host["finished_submap"])
        if finished < 0:
            return None
        t0 = _wall.perf_counter()
        slot = finished % 2
        sm_cfg = self.tb.submaps
        submaps = self._lio.frontend.submaps
        pg = self.parent.pose_graph
        hi_spec, lo_spec = grid_specs(sm_cfg)
        if sm_cfg.use_brick_grid:
            high = compress_brick(submaps.high_brick, brick_spec(sm_cfg), slot, hi_spec,
                                  pg._compress_capacity)
        else:
            n = hi_spec.num_cells
            high = compress(submaps.high_values[slot * n:(slot + 1) * n], hi_spec, pg._compress_capacity)
        if sm_cfg.use_brick_grid_low:
            low = compress_brick(submaps.low_brick, brick_spec_low(sm_cfg), slot, lo_spec,
                                 pg.low_compress_capacity)
        else:
            n = lo_spec.num_cells
            low = compress(submaps.low_values[slot * n:(slot + 1) * n], lo_spec, pg.low_compress_capacity)
        pg._phase("compress", _wall.perf_counter() - t0)  # host time: the compressions are queued, not awaited
        return high, low

    def _finish_pending(self) -> Optional[dict]:
        prev = self._read_pending()
        return self._complete_scan(*prev) if prev is not None else None

    def flush(self) -> Optional[dict]:
        """Drain the pipelined-ingest tail (no-op without pipelining)."""
        return self._finish_pending()

    def _complete_scan(self, time, host, grids, t0) -> dict:
        """Host-side completion of one scan: pose graph, metrics, result."""
        t_f = _wall.perf_counter()
        self._forward_to_pose_graph(time, host, grids)
        self.parent.pose_graph._phase("ingest_forward", _wall.perf_counter() - t_f)
        dt = _wall.perf_counter() - t0
        m = self.parent._metrics
        m["local_slam_latency"].add().set(dt)
        self.parent.local_slam_latency_seconds.append(dt)
        m["scan_matcher_cost"].add().observe(float(host["matcher_cost"]))
        dropped = [float(host[k][0]) for k in ("hi_dropped", "lo_dropped", "dense_dropped") if k in host]
        if dropped:
            # brick and dense grouped-apply drops count in one gauge
            m["brick_groups_dropped"].add().set(sum(dropped))
        out = {
            "time": time,
            "trajectory_id": self.trajectory_id,
            "local_pose": Rigid3(host["local_q"], host["local_t"]),
            "velocity": host["velocity"],
            "failed": bool(host["failed"]),
            "inserted": bool(host["inserted"]),
        }
        self._results.append(out)
        return out

    # ----- initialization -----

    def _initialize_static(self):
        """InitializeStatic + InitializeIMU (:203-229, :332-357)."""
        if not self._init_acc:
            return
        dev = self.device
        accs = torch.from_numpy(np.stack(self._init_acc)).to(dev)
        gyrs = torch.from_numpy(np.stack(self._init_gyr)).to(dev)
        mask = torch.ones(accs.shape[0], dtype=torch.bool, device=dev)
        rot, ba, bg = static_initialize(accs, gyrs, mask, self.tb.imu.gravity)
        zero = torch.zeros(3, dtype=torch.float32, device=dev)
        self._lio = make_lio_state(self.tb, pre.NavState(rot, zero, zero.clone()), ba, bg)
        self._initialized = True
        self._init_acc.clear()
        self._init_gyr.clear()

    # ----- local -> global routing (global_trajectory_builder.cc:56-97) -----

    def _sync_submaps(self, host):
        """Mirror frontend submap spawns into the pose graph."""
        pg = self.parent.pose_graph
        num_created = int(host["num_created"])
        while len(self._pg_submap_ids) < num_created:
            slot = len(self._pg_submap_ids) % 2
            pose = Rigid3(host["pose_rotation"][slot], host["pose_translation"][slot])
            self._pg_submap_ids.append(pg.add_submap(pose, trajectory_id=self.trajectory_id))
        if bool(host["pending_spawn"]) and len(self._pg_submap_ids) == num_created:
            # the next step spawns submap num_created with the pending pose
            pose = Rigid3(host["pending_rotation"], host["pending_translation"])
            self._pg_submap_ids.append(pg.add_submap(pose, trajectory_id=self.trajectory_id))

    def add_fixed_frame_pose_data(self, time, position):
        """Fixed-frame (GPS) position ingest; attached at node time."""
        self._ff_buffer.append((float(time), np.asarray(position, np.float32)))

    def add_navsat_data(self, time, latitude, longitude, altitude):
        """Geodetic fix -> local fixed-frame position (sensor_bridge.cc:87-111:
        the first fix anchors the ECEF->local frame, every fix becomes a
        fixed-frame observation)."""
        if self._navsat is None:
            from dliom_tpu_torch.io.geodesy import NavSatConverter

            self._navsat = NavSatConverter()
        self.add_fixed_frame_pose_data(time, self._navsat.to_local(latitude, longitude, altitude))

    def add_landmark_data(self, time, landmark_id, position_in_tracking):
        self._lm_buffer.append((float(time), str(landmark_id),
                                np.asarray(position_in_tracking, np.float32)))

    def _attach_aux_observations(self, node_id: int, node_time: float):
        pg = self.parent.pose_graph
        if self._ff_buffer:
            ts = [t for t, _ in self._ff_buffer]
            if ts[0] <= node_time <= ts[-1] or abs(ts[-1] - node_time) < 0.5:
                ps = np.stack([p for _, p in self._ff_buffer])
                pos = np.stack([np.interp(node_time, ts, ps[:, k]) for k in range(3)]).astype(np.float32)
                pg.add_fixed_frame_pose(node_id, pos)
            while len(self._ff_buffer) > 1 and self._ff_buffer[1][0] <= node_time:
                self._ff_buffer.pop(0)
        keep = []
        prev = self._prev_node
        for t, lid, rel in self._lm_buffer:
            if t <= node_time + 0.5 * self.tb.scan_period:
                if prev is not None and prev[1] < node_time:
                    alpha = float(np.clip((t - prev[1]) / (node_time - prev[1]), 0.0, 1.0))
                    pg.add_landmark_observation(prev[0], lid, rel, node_id2=node_id, alpha=alpha)
                else:
                    pg.add_landmark_observation(node_id, lid, rel)
            else:
                keep.append((t, lid, rel))
        self._lm_buffer = keep
        if len(self._odom_buffer):
            pg.add_odometry_between(node_id, node_time, self._odom_buffer,
                                    trajectory_id=self.trajectory_id,
                                    prev_node_id=prev[0] if prev is not None else None)
            self._odom_buffer.trim_before(node_time)

    def _forward_to_pose_graph(self, time, host, grids):
        if not bool(host["inserted"]):
            return
        self._sync_submaps(host)
        ids = tuple(int(i) for i in host["insertion_submap_ids"] if int(i) >= 0)
        node = NodeRecord(
            time=time,
            local_pose=Rigid3(host["local_q"], host["local_t"]),
            gravity_alignment=host["gravity_alignment"],
            high_points=host["high_points"],
            high_mask=host["high_mask"],
            low_points=host["low_points"],
            low_mask=host["low_mask"],
            histogram=host["histogram"],
            submap_ids=ids,
            trajectory_id=self.trajectory_id,
        )
        finished = int(host["finished_submap"])
        pg = self.parent.pose_graph
        pg.add_node(node, tuple(self._pg_submap_ids[i] for i in ids),
                    newly_finished_submap_id=self._pg_submap_ids[finished] if finished >= 0 else -1,
                    finished_grids=grids)
        self._attach_aux_observations(len(pg.nodes) - 1, time)
        self._prev_node = (len(pg.nodes) - 1, time)
        if self.parent._pure_localization:
            pg.trim_to_last_submaps(3)

    def finish(self):
        """FinishTrajectory: flush the collator and the pipelined tail and
        mark the trajectory finished (no final optimization here)."""
        if self.finished:
            return
        if self._collator is not None:
            for name in ["imu"] + list(self._synchronizer.sensor_ids):
                self._collator.finish_queue(name)
            self._drain_collator()
        self._finish_pending()
        self.parent.pose_graph.finish_trajectory(self.trajectory_id)
        self.finished = True

    @property
    def initialized(self) -> bool:
        return self._initialized


class MapBuilder:
    """Multi-trajectory mapping API (MapBuilderInterface surface); calls
    without a trajectory id go to trajectory 0, created eagerly."""

    def __init__(self, config: EngineConfig, range_sensor_ids: Optional[List[str]] = None,
                 use_background_threads: bool = False, use_native_collator: bool = False,
                 pipeline_depth: int = 0, create_default_trajectory: bool = True, device=None,
                 mesh=None):
        """`range_sensor_ids`: one per LiDAR (the first is the primary).
        `use_background_threads`: loop search and the periodic SPA run on a
        native task pool of map_builder.num_background_threads workers.
        `use_native_collator`: ingest merges through the native
        OrderedMultiQueue. `pipeline_depth=1` defers each scan's host read
        to the next scan. `device`: where the frontend and backend run; the
        CUDA card by default (raises where there is none), "cpu" on request.
        `mesh`: a `common/mesh.py::Mesh` the pose graph splits its loop
        search's node batches and its SPA's constraint rows over (as
        dliom_tpu/map_builder.py:717-720); the frontend stays on `device`."""
        if not config.map_builder.use_trajectory_builder_3d:
            raise ValueError("only the 3D pipeline is built; set "
                             "map_builder.use_trajectory_builder_3d=True")
        self.config = config
        self.tb = config.trajectory_builder
        self.device = get_device("cuda" if device is None else device)
        self._pipeline_depth = int(pipeline_depth)
        self.local_slam_latency_seconds: List[float] = []
        self._metrics = register_all_metrics(global_registry())
        pool = None
        if use_background_threads:
            from dliom_tpu_torch.native import TaskThreadPool

            pool = TaskThreadPool(config.map_builder.num_background_threads)
        self._pool = pool
        self.pose_graph = PoseGraph(config.pose_graph, self.tb, pool=pool, metrics=self._metrics,
                                    device=self.device, mesh=mesh)
        self._default_sensor_ids = range_sensor_ids or [
            f"points{i}" for i in range(max(1, config.num_point_clouds))]
        self._use_native_collator = use_native_collator
        self._trajectories: Dict[int, _TrajectoryBuilder] = {}
        self._pure_localization = False
        self._rate_timers: dict = {}
        if create_default_trajectory:
            self.add_trajectory_builder(self._default_sensor_ids)

    # ----- trajectory lifecycle (AddTrajectoryBuilder, map_builder.cc:98) --

    def add_trajectory_builder(self, range_sensor_ids: Optional[List[str]] = None,
                               config: Optional[EngineConfig] = None) -> int:
        tid = self.pose_graph.add_trajectory()
        self._trajectories[tid] = _TrajectoryBuilder(
            self, tid, range_sensor_ids or self._default_sensor_ids, self._use_native_collator,
            config=config)
        return tid

    def trajectory(self, trajectory_id: int) -> _TrajectoryBuilder:
        return self._trajectories[trajectory_id]

    def _pulse(self, trajectory_id: int, sensor: str, time: float):
        key = sensor if trajectory_id == 0 else f"t{trajectory_id}/{sensor}"
        self._rate_timers.setdefault(key, RateTimer()).pulse(time)

    # ----- sensor ingest (trajectory 0 by default) -----

    def add_imu_data(self, time, linear_acceleration, angular_velocity, trajectory_id: int = 0):
        self._trajectories[trajectory_id].add_imu_data(time, linear_acceleration, angular_velocity)

    def add_range_data(self, time, points, point_times=None, sensor_id=None,
                       trajectory_id: int = 0) -> Optional[dict]:
        return self._trajectories[trajectory_id].add_range_data(time, points, point_times, sensor_id)

    def add_fixed_frame_pose_data(self, time, position, trajectory_id: int = 0):
        self._trajectories[trajectory_id].add_fixed_frame_pose_data(time, position)

    def add_navsat_data(self, time, latitude, longitude, altitude, trajectory_id: int = 0):
        self._trajectories[trajectory_id].add_navsat_data(time, latitude, longitude, altitude)

    def add_landmark_data(self, time, landmark_id, position_in_tracking, trajectory_id: int = 0):
        self._trajectories[trajectory_id].add_landmark_data(time, landmark_id, position_in_tracking)

    def add_odometry_data(self, time, pose: Rigid3, trajectory_id: int = 0):
        self._trajectories[trajectory_id].add_odometry_data(time, pose)

    def flush(self):
        """Drain every trajectory's pipelined-ingest tail."""
        for t in self._trajectories.values():
            t.flush()

    # ----- finishing (FinishTrajectory / RunFinalOptimization) -----

    def finish_trajectory(self, trajectory_id: Optional[int] = None):
        """With an id: finish that trajectory only. Without: finish all, run
        the final optimization and release the pool."""
        if trajectory_id is not None:
            self._trajectories[trajectory_id].finish()
            return
        for t in self._trajectories.values():
            t.finish()
        self.pose_graph.run_final_optimization()
        if self._pool is not None:
            self._pool.close()
            self._pool = None

    def metrics_text(self) -> str:
        lines = [global_registry().dump_text()]
        for name, rt in sorted(self._rate_timers.items()):
            lines.append(f"sensor_rate_hz{{sensor=\"{name}\"}} {rt.rate():.3f}")
        return "\n".join(lines)

    def sensor_rates(self) -> dict:
        return {k: v.rate() for k, v in self._rate_timers.items()}

    # ----- queries -----

    def submap_query(self, submap_id: int) -> dict:
        return self.pose_graph.submap_query(submap_id)

    def local_trajectory(self, trajectory_id: int = 0) -> List[dict]:
        return list(self._trajectories[trajectory_id]._results)

    def optimized_node_poses(self, trajectory_id: Optional[int] = None) -> List[Tuple[float, Rigid3]]:
        return [(n.time, n.global_pose) for n in self.pose_graph.nodes
                if trajectory_id is None or n.trajectory_id == trajectory_id]

    @property
    def initialized(self) -> bool:
        return 0 in self._trajectories and self._trajectories[0].initialized

    def save_checkpoint(self, path: str, config_preset: str = "basic"):
        """Snapshot the running state: the map, every trajectory's device
        state (LIO window, biases, active submap banks) and its host
        bookkeeping; `map_builder_from_checkpoint` resumes it mid-submap with
        the same subsequent results (io/serialization.py says what is saved
        and what is refused)."""
        from dliom_tpu_torch.io.serialization import save_live_checkpoint

        save_live_checkpoint(path, self, config_preset)

    @property
    def num_trajectory_builders(self) -> int:
        return len(self._trajectories)

    def step_counts(self) -> Dict[str, int]:
        """The compiled steps' steps, warm-ups, captures and replays, summed
        over the trajectories."""
        return sum_counts(t._step for t in self._trajectories.values())

    def graph_counts(self) -> Dict[str, Dict[str, int]]:
        """Every compiled program's steps, warm-ups, captures and replays:
        the step's (`step_counts`), the dynamic initializers' NDT odometry
        and the pose graph's programs by name (`PoseGraph.graph_counts`)."""
        ndt = [t._dyn_init.odometry_graph for t in self._trajectories.values() if t._dyn_init is not None]
        return {"step": self.step_counts(), "ndt": sum_counts(ndt), **self.pose_graph.graph_counts()}


def map_builder_from_state(path: str, config: EngineConfig, pure_localization: bool = True,
                           **kwargs) -> MapBuilder:
    """Localize against or extend a saved map (MapBuilder::LoadState,
    map_builder.cc:209-367): a new builder whose live trajectory 0 maps
    against the loaded trajectories, remapped onto fresh ids. With
    `pure_localization` the loaded trajectories are frozen and the live one
    keeps only its 3 newest submaps (PureLocalizationTrimmer,
    map_builder.cc:147-151). `path` is the .npz state or a reference-schema
    .pbstream. `kwargs` go to MapBuilder (`device`, `use_background_threads`,
    `pipeline_depth`, ...)."""
    builder = MapBuilder(config, **kwargs)
    if path.endswith(".pbstream"):
        from dliom_tpu_torch.io.pbstream import load_pbstream_into

        load_pbstream_into(builder.pose_graph, path, frozen=pure_localization)
    else:
        from dliom_tpu_torch.io.serialization import load_state_into

        load_state_into(builder.pose_graph, path, config, frozen=pure_localization)
    builder._pure_localization = pure_localization
    return builder


def map_builder_from_checkpoint(path: str, config: EngineConfig, **kwargs) -> MapBuilder:
    """Resume a running map from a `MapBuilder.save_checkpoint` file, with
    its trajectory ids, device state and host bookkeeping; `config` must be
    the one it was saved under (each state tensor's shape and dtype are
    checked). `kwargs` go to MapBuilder."""
    from dliom_tpu_torch.io.serialization import restore_live_checkpoint

    builder = MapBuilder(config, create_default_trajectory=False, **kwargs)
    restore_live_checkpoint(builder, path)
    return builder
