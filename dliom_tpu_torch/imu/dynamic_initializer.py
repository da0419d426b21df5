"""Dynamic (in-motion) IMU-LiDAR initialization (port of
dliom_tpu/imu/dynamic_initializer.py; reference InitilizeByNDT,
local_trajectory_builder_3d.cc:231-330, and AlignWithWorld, :1010-1086):

  * buffer `frames_for_dynamic_initialization` + 1 scans, each with the
    zero-bias IMU preintegration since the previous scan (`integrate`, so
    kernel K2 on the card, once per segment);
  * inter-scan odometry by NDT (ops/ndt.py), seeded by the preintegrated
    rotation and the constant-velocity translation;
  * the VINS excitation gate: the spread of the per-segment mean specific
    force must reach 0.25 (AlignWithWorld :1014-1042);
  * linear alignment (imu/initialization.py::initialize_dynamic), then the
    newest frame rotated into the gravity-aligned world frame.

As in the JAX package, poses accumulate (T_i = T_{i-1} * T_rel), which the
alignment assumes; the reference stores (relative translation, accumulated
rotation) (:296-300). Everything runs on `device`; the host reads one
velocity per scan and the gate's and the solve's results.

The NDT odometry (`build_field` of the last scan, then `ndt_match` of the
current one) is one compiled program, as the JAX package jits it: a
`common/graph.py::StepGraph` at ODOM_POINTS and ODOM_SPEC (on the card one
eager warm-up, one capture, then a replay per scan). It runs on the thread
that feeds the scans, the one thread that may use forward-mode AD
(`ndt_match` takes its Jacobian with `jacfwd`).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from dliom_tpu_torch.common.config import TrajectoryBuilderConfig
from dliom_tpu_torch.common.device import get_device
from dliom_tpu_torch.common.graph import StepGraph
from dliom_tpu_torch.imu import preintegration as pre
from dliom_tpu_torch.imu.initialization import AlignmentInput, initialize_dynamic
from dliom_tpu_torch.mapping.grid import GridSpec
from dliom_tpu_torch.ops.ndt import build_field, match as ndt_match
from dliom_tpu_torch.ops.voxel_filter import FilteredCloud, voxel_filter
from dliom_tpu_torch.transform.rigid import (
    Rigid3,
    quat_from_two_vectors,
    quat_multiply,
    quat_normalize,
    quat_rotate,
)


def odometry_body(spec: GridSpec):
    """`body((), (last points, mask, current points, mask, guess rotation,
    guess translation)) -> ((), (rotation, translation))`: the NDT field of
    the last scan and the match of the current one against it."""
    def body(state, inp):
        last_pts, last_mask, cur_pts, cur_mask, q, t = inp
        field = build_field(last_pts, last_mask, spec)
        rel = ndt_match(field, spec, cur_pts, cur_mask, Rigid3(q, t))
        return state, (rel.rotation, rel.translation)
    return body


class InitResult(NamedTuple):
    nav: pre.NavState  # the newest frame's state in the world (gravity) frame
    ba: torch.Tensor
    bg: torch.Tensor


class DynamicInitializer:
    ODOM_SPEC = GridSpec(resolution=1.0, extent=128)  # NDT voxel size
    ODOM_POINTS = 4096

    def __init__(self, cfg: TrajectoryBuilderConfig, device):
        self.cfg = cfg
        self.device = get_device(device)
        self._frames = cfg.frames_for_dynamic_initialization
        self._noise = pre.noise_matrix(cfg.imu, self.device)
        self.odometry_graph = StepGraph(odometry_body(self.ODOM_SPEC), name="ndt")
        self._reset()

    def _reset(self):
        self._poses: List[Rigid3] = []
        self._preints: List[Optional[pre.Preintegrated]] = []
        self._last_points: Optional[FilteredCloud] = None
        self._last_stamp: Optional[float] = None
        self._lin_vel = np.zeros(3, np.float32)
        self._seg_dts: List[float] = []
        self._seg_acc: List[np.ndarray] = []
        self._seg_gyr: List[np.ndarray] = []
        self._last_imu_t: Optional[float] = None

    def _start(self, stamp: float, cur: FilteredCloud):
        """The first frame of a window: identity pose, no segment."""
        self._poses = [Rigid3.identity(device=self.device)]
        self._preints = [None]
        self._last_points = cur
        self._last_stamp = stamp

    def add_imu(self, t: float, acc, gyr):
        dt = (t - self._last_imu_t) if self._last_imu_t is not None else 1.0 / 500.0
        self._last_imu_t = t
        self._seg_dts.append(dt)
        self._seg_acc.append(np.asarray(acc, np.float32))
        self._seg_gyr.append(np.asarray(gyr, np.float32))

    def _segment_preint(self) -> pre.Preintegrated:
        """Zero-bias preintegration of the samples since the last scan,
        padded to the next multiple of 32 samples (the JAX package's padding
        against recompiles; here it fixes K2's chain lengths)."""
        n = len(self._seg_dts)
        cap = max(32 * ((n + 31) // 32), 32)
        dts = np.zeros(cap, np.float32)
        accs = np.zeros((cap, 3), np.float32)
        gyrs = np.zeros((cap, 3), np.float32)
        if n:
            dts[:n] = self._seg_dts
            accs[:n] = np.stack(self._seg_acc)
            gyrs[:n] = np.stack(self._seg_gyr)
        dev = self.device
        zero = torch.zeros(3, dtype=torch.float32, device=dev)
        accs_t, gyrs_t = torch.from_numpy(accs).to(dev), torch.from_numpy(gyrs).to(dev)
        p0 = pre.make_preintegrated(zero, zero, accs_t[0], gyrs_t[0])
        out = pre.integrate(p0, torch.from_numpy(dts).to(dev), accs_t, gyrs_t,
                            torch.from_numpy(np.arange(cap) < n).to(dev), self._noise)
        self._seg_dts, self._seg_acc, self._seg_gyr = [], [], []
        return out

    def _prep(self, points: np.ndarray) -> FilteredCloud:
        pts = torch.from_numpy(np.asarray(points, np.float32).reshape(-1, 3)).to(self.device)
        n = pts.shape[0]
        return voxel_filter(pts, torch.zeros(n, device=self.device),
                            torch.ones(n, dtype=torch.bool, device=self.device), 0.3,
                            out_capacity=self.ODOM_POINTS)

    def add_scan(self, stamp: float, points: np.ndarray) -> Optional[InitResult]:
        cur = self._prep(points)
        if self._last_points is None:
            self._start(stamp, cur)
            self._seg_dts, self._seg_acc, self._seg_gyr = [], [], []
            return None

        dt = stamp - self._last_stamp
        seg = self._segment_preint()
        guess = Rigid3(seg.delta_q, torch.from_numpy(self._lin_vel * dt).to(self.device))
        rel = self._odometry(self._last_points, cur, guess)  # MatchByNDT :969
        self._poses.append(self._poses[-1].compose(rel))
        self._preints.append(seg)
        self._lin_vel = rel.translation.cpu().numpy() / max(dt, 1e-6)
        self._last_points = cur
        self._last_stamp = stamp
        if len(self._poses) < self._frames + 1:
            return None
        result = self._align_with_world()
        if result is None:
            # re-initialization (InitilizeByNDT :316-319)
            self._reset()
            self._start(stamp, cur)
        return result

    def _odometry(self, last: FilteredCloud, cur: FilteredCloud, guess: Rigid3) -> Rigid3:
        """The relative pose of `cur` in `last`'s frame from `guess` (the
        compiled program's result, copied off its buffers)."""
        _, (q, t) = self.odometry_graph((), (last.points, last.mask, cur.points, cur.mask,
                                             guess.rotation, guess.translation))
        return Rigid3(q.clone(), t.clone())

    def _excitation_ok(self, dvs: np.ndarray, dts: np.ndarray) -> bool:
        """VINS IMU-observability check (AlignWithWorld :1014-1042) on the
        segments' delta_v and dt."""
        use = dts > 0
        if not use.any():
            return False
        gs = dvs[use] / dts[use][:, None]
        return float(np.sqrt(np.mean(np.sum((gs - gs.mean(axis=0)) ** 2, axis=1)))) >= 0.25

    def _align_with_world(self) -> Optional[InitResult]:
        segs = self._preints[1:]
        dvs = torch.stack([p.delta_v for p in segs])
        dts = torch.stack([p.dt for p in segs])
        if not self._excitation_ok(dvs.cpu().numpy(), dts.cpu().numpy()):
            return None
        dev = self.device
        w = len(self._poses)
        zero3 = torch.zeros(1, 3, dtype=torch.float32, device=dev)
        inp = AlignmentInput(
            rotations=torch.stack([p.rotation for p in self._poses]),
            translations=torch.stack([p.translation for p in self._poses]),
            delta_p=torch.cat([zero3, torch.stack([p.delta_p for p in segs])]),
            delta_v=torch.cat([zero3, dvs]),
            dts=torch.cat([torch.zeros(1, dtype=torch.float32, device=dev), dts]),
            pair_mask=torch.arange(w, device=dev) > 0,
        )
        g_norm = self.cfg.imu.gravity
        g_est, vels_body, ok = initialize_dynamic(inp, Rigid3.identity(device=dev), g_norm)
        if not bool(ok):
            return None
        # AlignWithWorld (:1056-1084): the solved g is the "up" specific
        # force in frame 0, so gravity in the base frame is -g_est; R0 turns
        # it onto world down
        g_vec = torch.tensor([0.0, 0.0, -g_norm], dtype=torch.float32, device=dev)
        r0 = quat_from_two_vectors(-g_est, g_vec)
        last = self._poses[-1]
        nav = pre.NavState(
            quat_normalize(quat_multiply(r0, last.rotation)),
            quat_rotate(r0, last.translation),
            quat_rotate(r0, quat_rotate(last.rotation, vels_body[-1])),
        )
        zero = torch.zeros(3, dtype=torch.float32, device=dev)
        return InitResult(nav=nav, ba=zero, bg=zero.clone())
