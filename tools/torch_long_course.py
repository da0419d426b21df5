#!/usr/bin/env python3
"""≥1 km multi-loop synthetic sequence through the port's offline runner.

    python3 tools/torch_long_course.py [--laps 2.0] [--dataset PATH] [--keep-dataset PATH]
        [--seed 11] [--extra-overrides JSON] [--device cuda]

The counterpart of tools/long_course.py on dliom_tpu_torch: the same
stadium course (~529 m per lap, distinct sceneries along the track, IMU
white noise + bias offsets + bias random walk, a constant 3 deg mount
roll), written in the offline runner's .npz dataset schema by a pure numpy
generator (the same bits as the JAX tool's), then replayed with
`dliom_tpu_torch.runner.offline.run` (background loop search on the
native pool, the host fetch pipelined one scan deep) at the course's
configuration. It runs on the card unless given `--device cpu`, and
imports nothing of JAX.

Prints JSON lines (and `main` returns them):
  - with a generated dataset, {"phase": "generated", ...};
  - the runner report (end-to-end scans/s with the backend on,
    per-finished-submap constraint-search latency, pre- and
    post-final-optimization ATE) plus `evaluate_constraints`:
    constraint precision vs ground truth (an INTER constraint is correct
    if its relative pose matches the ground-truth relative, the submap's
    truth anchored through its first node, within 1.0 m / 0.25 rad),
    revisit recall (of the (finished submap, sampled node) pairs whose
    true positions lie within `recall_radius` and are >= 60 s apart, the
    fraction with a found constraint) and the yaw fan.

`LC_VERBOSE=1` makes the runner print every scan's pose.
"""

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from dliom_tpu_torch.common.device import get_device  # noqa: E402
from dliom_tpu_torch.io.synthetic import (  # noqa: E402
    ImuNoise,
    ImuSimulator,
    _np_quat_multiply,
    _np_quat_to_matrix,
)
from dliom_tpu_torch.runner import offline  # noqa: E402
from dliom_tpu_torch.transform.rigid import Rigid3  # noqa: E402

G = 9.80511
SCAN_PERIOD = 0.1
SPEED = 4.0  # m/s: brisk ground robot / slow vehicle
STRAIGHT = 170.0  # stadium straight length (m)
RADIUS = 30.0  # stadium end-cap radius (m)
REST = 1.6  # static-init phase (s)
ROLL_TILT = 0.05  # rad (~3 deg): gravity misalignment of the IMU mount
Z_AMPL = 0.8  # gentle vertical undulation (m)
Z_WAVELEN = 120.0  # (m)
SENSOR_Z = 1.5  # sensor height above the ground plane (m)
T_RAMP = 3.0  # s of linear acceleration from rest to SPEED (~1.3 m/s^2)


def _perimeter() -> float:
    return 2.0 * STRAIGHT + 2.0 * np.pi * RADIUS


def _centerline(s: float):
    """Stadium centerline: arclength s -> (xy position, heading angle).
    Straights along +-x at y=0 and y=2R; end caps at x=+-STRAIGHT/2."""
    s = s % _perimeter()
    L, R = STRAIGHT, RADIUS
    if s < L:  # bottom straight, +x
        return np.array([s - L / 2, 0.0]), 0.0
    s -= L
    if s < np.pi * R:  # right cap, CCW
        a = s / R
        return np.array([L / 2, R]) + R * np.array([np.sin(a), -np.cos(a)]), a
    s -= np.pi * R
    if s < L:  # top straight, -x
        return np.array([L / 2 - s, 2 * R]), np.pi
    s -= L
    a = s / R  # left cap
    return np.array([-L / 2, R]) + R * np.array([-np.sin(a), np.cos(a)]), np.pi + a


def _quat_yaw_roll(yaw: float, roll: float) -> np.ndarray:
    qz = np.array([np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)])
    qx = np.array([np.cos(roll / 2), np.sin(roll / 2), 0.0, 0.0])
    return _np_quat_multiply(qz, qx)


def _arclength(tau: float) -> float:
    if tau < T_RAMP:
        return SPEED * tau * tau / (2.0 * T_RAMP)
    return SPEED * (tau - T_RAMP / 2.0)


def course_pose(tau: float):
    """Ground-truth pose (numpy q wxyz, p) at time tau along the course:
    the body origin is the sensor origin, SENSOR_Z above the ground with a
    gentle vertical undulation, the mount rolled by ROLL_TILT."""
    s = _arclength(tau)
    xy, heading = _centerline(s)
    z = SENSOR_Z + Z_AMPL * np.sin(2 * np.pi * s / Z_WAVELEN)
    return _quat_yaw_roll(heading, ROLL_TILT), np.array([xy[0], xy[1], z])


class CourseWorld:
    """Procedural pillar-and-wall world along the course corridor: every
    `seg` meters of arclength a distinct feature group seeded by its
    segment index (a wall of stacked sphere rows at a random world angle,
    or scattered post stacks), plus ground clutter in every segment (a
    correct revisit must find repeatable near-field structure; without it
    such a pose scored 0.28-0.53 at the 0.45 gate in the JAX package's
    tools/loop_debug.py) and a ground plane. Ray casting is pure numpy with
    per-scan distance culling."""

    def __init__(self, seed: int = 7, seg: float = 6.0):
        centers, radii = [], []
        for k in range(int(_perimeter() / seg)):
            xy, heading = _centerline((k + 0.5) * seg)
            srng = np.random.default_rng(seed * 100003 + k)
            n_world = np.array([-np.sin(heading), np.cos(heading)])
            t_world = np.array([np.cos(heading), np.sin(heading)])
            if srng.random() < 0.5:
                # a wall: a dense sphere row, 4 layers tall, at a fully
                # random angle (track-parallel walls would leave the
                # longitudinal translation unconstrained)
                side = 1.0 if srng.random() < 0.5 else -1.0
                dist = srng.uniform(7.0, 16.0)
                ang = srng.uniform(0.0, np.pi)
                length = srng.uniform(6.0, 12.0)
                base = xy + side * dist * n_world
                d = np.array([np.cos(ang), np.sin(ang)])
                for u in np.arange(-length / 2, length / 2, 0.8):
                    for h in (0.4, 1.2, 2.0, 2.8):
                        c = base + u * d
                        centers.append([c[0], c[1], h])
                        radii.append(0.5)
            else:
                # scattered posts: longitudinal and lateral anchors at once
                for _ in range(srng.integers(5, 10)):
                    side = 1.0 if srng.random() < 0.5 else -1.0
                    dist = srng.uniform(5.0, 18.0)
                    along = srng.uniform(-seg / 2, seg / 2)
                    c = xy + side * dist * n_world + along * t_world
                    r = srng.uniform(0.3, 0.7)
                    for h in (0.5, 1.5, 2.5, 3.5, 4.5):
                        centers.append([c[0], c[1], h])
                        radii.append(r)
            for _ in range(srng.integers(8, 14)):  # ground clutter
                side = 1.0 if srng.random() < 0.5 else -1.0
                dist = srng.uniform(2.0, 14.0)
                along = srng.uniform(-seg / 2, seg / 2)
                c = xy + side * dist * n_world + along * t_world
                r = srng.uniform(0.2, 0.5)
                centers.append([c[0], c[1], 0.8 * r])
                radii.append(r)
        self.centers = np.asarray(centers, np.float64)
        self.radii = np.asarray(radii, np.float64)
        self.ground_z = 0.0

        # 16-beam x 400-azimuth rangefinder, +-15 deg elevation (VIRAL-like)
        az, el = np.meshgrid(np.pi * np.arange(-200, 200) / 200.0,
                             np.pi / 12.0 * np.arange(-8, 8) / 8.0, indexing="ij")
        self.dirs = np.stack(
            [np.cos(az) * np.cos(el), np.sin(az) * np.cos(el), -np.sin(el)], axis=-1
        ).reshape(-1, 3)

    def cast_scan(self, q: np.ndarray, p: np.ndarray, max_range: float = 75.0):
        """Hit points in the tracking frame (N, 3) float32."""
        rmat = _np_quat_to_matrix(q)
        origin = np.asarray(p, np.float64)
        d = self.dirs @ rmat.T  # (R, 3) world directions
        t = np.full(d.shape[0], 1e9)
        dz = d[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            tg = (self.ground_z - origin[2]) / dz
        t = np.where((dz < 0) & (tg > 0), np.minimum(t, tg), t)
        near = np.linalg.norm(self.centers[:, :2] - origin[None, :2], axis=1) < max_range + 2.0
        C, R = self.centers[near], self.radii[near]
        if len(C):
            oc = origin[None, :] - C  # (M, 3)
            beta = d @ oc.T  # (R, M)
            c = np.sum(oc * oc, axis=-1)[None, :] - (R**2)[None, :]
            disc = beta * beta - c
            root = -beta - np.sqrt(np.maximum(disc, 0.0))
            root = np.where((disc >= 0.0) & (root > 0.0), root, 1e9)
            t = np.minimum(t, np.min(root, axis=1))
        hit = t < max_range
        world = origin[None, :] + t[:, None] * d
        return ((world[hit] - origin[None, :]) @ rmat).astype(np.float32)


def generate(path: str, laps: float, seed: int = 11):
    """Write the .npz dataset; returns (gt_times, gt_quats, gt_positions).
    Pure numpy: a torch op per scan would dispatch to the card thousands of
    times."""
    world = CourseWorld()
    sim = ImuSimulator(
        rate=100.0,
        noise=ImuNoise(acc_noise=0.02, gyr_noise=0.002, acc_bias_walk=2e-4, gyr_bias_walk=2e-5,
                       acc_bias0=(0.05, -0.03, 0.02), gyr_bias0=(0.0004, -0.0003, 0.0012)),
        gravity=G,
        seed=seed,
    )
    arrays = {}
    imu_t, imu_a, imu_g = [], [], []
    # The rest phase holds scans, not only IMU: the static initializer takes
    # frames_for_static_initialization scans as at rest, and a motion from
    # the first scan would leave it a ~1.3 m/s velocity error. The rest
    # poses carry the tilted mount the initializer must estimate away.
    q0, p0 = course_pose(0.0)
    t = 0.0
    total = int(round((REST + laps * _perimeter() / SPEED + T_RAMP / 2.0) / SCAN_PERIOD))
    gt_times, gt_quats, gt_pos = [], [], []
    prev_q, prev_p, prev_v = q0, p0, np.zeros(3)
    tau = -REST
    for n_scan in range(total):
        tau += SCAN_PERIOD
        q, p = course_pose(max(tau, 0.0))
        _, pn = course_pose(max(tau + SCAN_PERIOD, 0.0))
        v = (pn - prev_p) / (2 * SCAN_PERIOD)  # central difference
        dts, accs, gyrs, mask = sim.between(Rigid3(prev_q, prev_p), Rigid3(q, p), prev_v, v,
                                            SCAN_PERIOD, 16)
        for i in range(int(mask.sum())):
            t += float(dts[i])
            imu_t.append(t)
            imu_a.append(accs[i])
            imu_g.append(gyrs[i])
        pts = world.cast_scan(q, p)
        arrays[f"scans/{n_scan}/points"] = pts
        arrays[f"scans/{n_scan}/times"] = np.zeros(len(pts), np.float32)
        arrays[f"scans/{n_scan}/stamp"] = np.float64(t)
        gt_times.append(t)
        gt_quats.append(q)
        gt_pos.append(p)
        prev_q, prev_p, prev_v = q, p, v

    arrays["imu/times"] = np.asarray(imu_t)
    arrays["imu/acc"] = np.stack(imu_a)
    arrays["imu/gyr"] = np.stack(imu_g)
    arrays["gt/times"] = np.asarray(gt_times)
    # the truth rebased onto the run's local frame origin (the run starts at
    # identity), so the raw unaligned ATE means something
    arrays["gt/positions"] = np.stack(gt_pos) - p0
    arrays["gt/rotations"] = np.stack(gt_quats)  # wxyz, an extra key
    np.savez_compressed(path, **arrays)
    return np.asarray(gt_times), np.stack(gt_quats), arrays["gt/positions"]


def load_ground_truth(path: str):
    z = np.load(path)
    return z["gt/times"], z["gt/rotations"], z["gt/positions"]


def _np_rigid_inv_compose(qa, pa, qb, pb):
    """T_a^-1 * T_b as (q, p) numpy wxyz."""
    q = _np_quat_multiply(qa * np.array([1.0, -1.0, -1.0, -1.0]), qb)
    return q, _np_quat_to_matrix(qa).T @ (pb - pa)


def _quat_angle(q):
    return float(2.0 * np.arctan2(np.linalg.norm(q[1:]), abs(q[0])))


def _f64(x):
    return np.asarray(x, np.float64)


def truth_lookup(pg, gt):
    """(node_gt, submap_gt): a node's true (q, p) at its time, and a
    submap's through its first node (the local offset between a submap and
    its first node is drift-free over their shared creation epoch), None
    for a submap without nodes."""
    gt_times, gt_quats, gt_pos = gt

    def node_gt(nid):
        i = int(np.argmin(np.abs(gt_times - pg.nodes[nid].time)))
        return gt_quats[i], gt_pos[i]

    def submap_gt(sid):
        sub = pg.submaps[sid]
        if not sub.node_ids:
            return None
        n0 = sub.node_ids[0]
        qn, pn = node_gt(n0)
        node_l = pg.nodes[n0].local_pose
        qo, po = _np_rigid_inv_compose(_f64(node_l.rotation), _f64(node_l.translation),
                                       _f64(sub.local_pose.rotation), _f64(sub.local_pose.translation))
        return _np_quat_multiply(qn, qo), pn + _np_quat_to_matrix(qn) @ po

    return node_gt, submap_gt


def evaluate_constraints(builder, gt, recall_radius=7.0, min_sep=60.0):
    """Constraint precision vs ground truth, revisit recall and the yaw fan
    (see the module docstring). Host poses are read as float64, as the JAX
    tool reads its float32 ones, so one graph gives one dict."""
    pg = builder.pose_graph
    node_gt, submap_gt = truth_lookup(pg, gt)

    inter = [c for c in pg.constraints if c.tag == "INTER"]
    correct = 0
    errs = []
    for c in inter:
        sgt = submap_gt(c.submap_id)
        if sgt is None:
            continue
        q_rel, p_rel = _np_rigid_inv_compose(*sgt, *node_gt(c.node_id))
        dt_ = float(np.linalg.norm(p_rel - _f64(c.relative.translation)))
        dr = _quat_angle(_np_quat_multiply(q_rel * np.array([1.0, -1.0, -1.0, -1.0]),
                                           _f64(c.relative.rotation)))
        errs.append((dt_, dr))
        if dt_ < 1.0 and dr < 0.25:
            correct += 1

    # revisit recall over time-separated close pairs, sampled at the
    # constraint builder's node stride
    every = max(1, pg.cfg.constraint_builder.every_nodes_to_find_constraint)
    have = {(c.submap_id, c.node_id) for c in inter}
    sub_centers = {}
    for sid, sub in enumerate(pg.submaps):
        if sub.finished and sub.node_ids:
            sgt = submap_gt(sid)
            if sgt is not None:
                sub_centers[sid] = (sgt[1], pg.nodes[sub.node_ids[0]].time)
    opportunities = hits = 0
    for sid, (ps, ts) in sub_centers.items():
        sub_nodes = set(pg.submaps[sid].node_ids)
        for nid in range(0, len(pg.nodes), every):
            if nid in sub_nodes or abs(pg.nodes[nid].time - ts) < min_sep:
                continue
            if np.linalg.norm(node_gt(nid)[1] - ps) < recall_radius:
                opportunities += 1
                hits += (sid, nid) in have
    out = {
        "num_inter": len(inter),
        "constraint_precision": round(correct / len(inter), 4) if inter else None,
        "mean_constraint_t_err_m": round(float(np.mean([e[0] for e in errs])), 3) if errs else None,
        "revisit_opportunities": opportunities,
        "revisit_recall": round(hits / opportunities, 4) if opportunities else None,
    }
    # the yaw each constraint's search had to recover from its initial
    # guess, against the fan half-width (with_initial_yaw_window), with the
    # later half of the course apart
    yc = np.asarray([abs(c.yaw_correction) for c in inter])
    if len(yc):
        fan = pg.cfg.constraint_builder.with_initial_yaw_window
        t_nodes = np.asarray([pg.nodes[c.node_id].time for c in inter])
        half = t_nodes > np.median(t_nodes)
        out["yaw_correction_rad"] = {
            "p50": round(float(np.percentile(yc, 50)), 4),
            "p95": round(float(np.percentile(yc, 95)), 4),
            "max": round(float(np.max(yc)), 4),
            "fan_half_width": fan,
            "frac_beyond_half_fan": round(float(np.mean(yc > fan / 2)), 4),
            "late_half_p95": round(float(np.percentile(yc[half], 95)), 4) if half.any() else None,
        }
    return out


def course_overrides() -> dict:
    """The course's engine configuration (shared with tools/torch_loop_debug.py)."""
    return {
        # 2 background workers, as the JAX tool runs
        "map_builder": {"num_background_threads": 2},
        "trajectory_builder": {
            "scan_period": SCAN_PERIOD,
            "min_range": 1.0,
            "max_range": 60.0,
            "voxel_filter_size": 0.25,
            "frames_for_static_initialization": 10,
            "enable_ndt_initialization": False,
            # the reference's outdoor configs (viral.lua, kaist.lua) turn the
            # gravity factor off: it fights a persistent mount tilt
            "enable_gravity_factor": False,
            "motion_filter": {"max_time_seconds": 0.2,
                              "max_distance_meters": 0.1,
                              "max_angle_radians": 0.004},
            "submaps": {
                "high_resolution": 0.2,
                "high_resolution_max_range": 40.0,
                "low_resolution": 0.8,
                "num_range_data": 40,
                "high_resolution_extent": 256,
                # extent * resolution must cover the matched low cloud's
                # 60 m from anywhere in the submap (a node sits up to ~16 m
                # from its origin): +-76.8 m at 192 cells
                "low_resolution_extent": 192,
            },
            "max_filtered_points": 8192,
            "max_high_res_points": 512,
            "max_low_res_points": 512,
            "window_size": 6,
            "gn_iterations": 3,
            "ceres_scan_matcher": {"max_num_iterations": 12},
        },
        "pose_graph": {
            "optimize_every_n_nodes": 100,  # VIRAL (viral.lua:20)
            "max_submaps": 256,
            "max_nodes": 8192,
            "max_constraints": 8192,
            "max_radius_enable_loop_detection": 15.0,
            "num_close_submaps_loop_with_initial_value": 5,
            "constraint_builder": {
                "min_score": 0.45,
                "every_nodes_to_find_constraint": 4,
            },
        },
    }


def _deep_merge(base: dict, extra: dict) -> None:
    for k, v in extra.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _deep_merge(base[k], v)
        else:
            base[k] = v


def replay(path, device, overrides=None, verbose=False, on_builder=None):
    """`runner.offline.run` over the dataset at `path` with the course's
    configuration (or `overrides`), loop search on 2 pool threads and the
    host fetch one scan deep; `on_builder(builder, report)` as the runner
    calls it. Returns the report."""
    argv = ["--dataset", path, "--preset", "basic", "--device", str(device),
            "--config-overrides", json.dumps(course_overrides() if overrides is None else overrides),
            "--background-threads", "--pipeline-depth", "1"]
    return offline.run(offline.build_parser().parse_args(argv + ["--verbose"] * bool(verbose)),
                       on_builder=on_builder)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--laps", type=float, default=2.0)
    ap.add_argument("--dataset", default=None, help="reuse an existing generated .npz")
    ap.add_argument("--keep-dataset", default=None, help="write the generated .npz here (default: temp)")
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--extra-overrides", default=None,
                    help="JSON config dict deep-merged over the course defaults (A/B experiments, e.g. "
                         "'{\"pose_graph\": {\"constraint_builder\": {\"coarse_scoring_stride\": 1}}}')")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = get_device(args.device)

    lines = []
    if args.dataset:
        path = args.dataset
        gt = load_ground_truth(path)
    else:
        path = args.keep_dataset or os.path.join(tempfile.gettempdir(),
                                                 f"long_course_{args.laps}_{args.seed}.npz")
        gt = generate(path, args.laps, args.seed)
        lines.append({"phase": "generated", "dataset": path, "num_scans": int(len(gt[0])),
                      "course_length_m": round(args.laps * _perimeter(), 1)})
        print(json.dumps(lines[-1]), flush=True)

    overrides = course_overrides()
    if args.extra_overrides:
        _deep_merge(overrides, json.loads(args.extra_overrides))
    extra = {}
    report = replay(path, device, overrides, verbose=bool(os.environ.get("LC_VERBOSE")),
                    on_builder=lambda builder, report: extra.update(evaluate_constraints(builder, gt)))
    report.update(extra)
    print(json.dumps(report), flush=True)
    return lines + [report]


if __name__ == "__main__":
    main()
