#!/usr/bin/env python3
"""End-to-end loop-closure ATE on a drifting circle, through the port's MapBuilder.

    python3 tools/torch_e2e_loop_ate.py [--device cuda]

The counterpart of tools/e2e_loop_ate.py on dliom_tpu_torch: a full
`MapBuilder` run (static initialization, the tightly-coupled frontend with
a biased, noisy gyro, the submap lifecycle, loop search inline, the final
optimization) around a 5 m circle in the 16 x 600 synthetic world. The yaw
bias makes the odometry drift; the revisit must be found by loop closure
and the final optimization must cut the trajectory ATE. It runs on the card
unless given `--device cpu`, and imports nothing of JAX.

Prints two JSON lines (and `main` returns them):
  {"phase": "pre_final_optimization", "ate_rmse_m", "endpoint_err_m", "num_inter", "num_nodes", "num_submaps"}
  {"phase": "post_final_optimization", "ate_rmse_m", "endpoint_err_m", "improvement"}

Knobs (environment, as the JAX tool's): E2E_NOISE (IMU white-noise scale,
1.0), E2E_BIAS (yaw-rate bias rad/s, 0.004), E2E_LAPS (1.12), E2E_HUBER
(1: Huber loss on INTER constraints), E2E_MIN_SCORE (0.45) and E2E_DEBUG
(per-node error and per-INTER residual lines).

As in the JAX tool, the truth is recorded for each scan that added a node
in the moving phase and paired with the nodes by index (`evaluate`); a
caller whose nodes lag their scans (pipeline_depth 1) pairs them by node
time with `ground_truth_by_time`.
"""

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from dliom_tpu_torch.common.config import load_config  # noqa: E402
from dliom_tpu_torch.common.device import get_device  # noqa: E402
from dliom_tpu_torch.evaluation.ate import ate_rmse  # noqa: E402
from dliom_tpu_torch.io.synthetic import ImuNoise, ImuSimulator, SyntheticWorld  # noqa: E402
from dliom_tpu_torch.map_builder import MapBuilder  # noqa: E402
from dliom_tpu_torch.transform.rigid import Rigid3, np_compose, np_inverse, np_rigid  # noqa: E402

G = 9.80511
RADIUS = 5.0
SPEED = 1.5  # m/s: one lap ~21 s at 10 Hz scans
SCAN_PERIOD = 0.1
REST = 1.6  # static-init phase (s)
N_REST = int(round(REST / SCAN_PERIOD))  # static scans before the circle


def circle_pose(tau: float, radius: float = RADIUS):
    """True pose (float32 numpy Rigid3) and world velocity on the circle
    of `radius` at time tau (tangent heading)."""
    ang = SPEED / radius * tau
    p = np.array([radius * np.sin(ang), radius * (1.0 - np.cos(ang)), 0.0], np.float32)
    v = np.array([SPEED * np.cos(ang), SPEED * np.sin(ang), 0.0])
    q = np.array([np.cos(ang / 2), 0.0, 0.0, np.sin(ang / 2)], np.float32)
    return Rigid3(q, p), v


def course(n_scans, noise_scale=1.0, bias_z=0.004, radius=RADIUS):
    """The feed, made up front: per scan its IMU samples [(t, acc, gyr)],
    its stamp, points, point times and true pose. The first N_REST scans
    stand still at the circle's start; then the circle of `radius` at
    SPEED. The gyro's yaw-rate bias `bias_z` makes the odometry drift;
    white noise on top."""
    world = SyntheticWorld.create(num_beams=16, num_azimuths=600)
    sim = ImuSimulator(rate=100.0, noise=ImuNoise(acc_noise=0.02 * noise_scale,
                                                  gyr_noise=0.002 * noise_scale,
                                                  gyr_bias0=(0.0, 0.0, bias_z)),
                       gravity=G, seed=4)
    out, t, tau = [], 0.0, 0.0
    prev_pose, prev_v = circle_pose(0.0, radius)[0], np.zeros(3)
    for k in range(n_scans):
        if k < N_REST:
            pose, v = prev_pose, np.zeros(3)
        else:
            tau += SCAN_PERIOD
            pose, v = circle_pose(tau, radius)
        dts, accs, gyrs, mask = sim.between(prev_pose, pose, prev_v, v, SCAN_PERIOD, 64)
        imu = []
        for i in range(int(mask.sum())):
            t += float(dts[i])
            imu.append((t, accs[i], gyrs[i]))
        pts, ptimes = world.cast_scan(pose)
        out.append((imu, t, pts, ptimes, pose))
        prev_pose, prev_v = pose, v
    return out


def config_overrides(huber=True, min_score=0.45) -> dict:
    return {
        "trajectory_builder": {
            "scan_period": SCAN_PERIOD,
            "frames_for_static_initialization": 8,
            "enable_ndt_initialization": False,
            "submaps": {
                "high_resolution": 0.2,
                "low_resolution": 0.8,
                "high_resolution_extent": 128,
                "low_resolution_extent": 64,
                "num_range_data": 16,
            },
        },
        "pose_graph": {
            "optimization_problem": {"use_inter_huber": huber},
            "optimize_every_n_nodes": 32,  # periodic, as the reference
            "max_submaps": 32,
            "max_nodes": 512,
            "max_constraints": 2048,
            "max_radius_enable_loop_detection": 10.0,
            "num_close_submaps_loop_with_initial_value": 5,
            "constraint_builder": {"min_score": min_score, "every_nodes_to_find_constraint": 2},
        },
    }


def ground_truth_by_time(pg, stamps, positions):
    """[(node time, true position)] for each node of `pg`, the position of
    the scan whose stamp is nearest the node's time."""
    stamps = np.asarray(stamps)
    return [(n.time, np.asarray(positions[int(np.argmin(np.abs(stamps - n.time)))], np.float64))
            for n in pg.nodes]


def evaluate(pg, gt) -> dict:
    """ATE (unaligned RMSE) and endpoint error of the nodes' global poses
    against `gt`, [(time, true position)] paired with the nodes by index
    over the shorter of the two, plus the graph's counts."""
    n = min(len(pg.nodes), len(gt))
    est = np.stack([np.asarray(pg.nodes[i].global_pose.translation, np.float64) for i in range(n)])
    true = np.stack([gt[i][1] for i in range(n)])
    return {"ate_rmse_m": float(ate_rmse(est, true, align=False)),
            "endpoint_err_m": float(np.linalg.norm(est[-1] - true[-1])),
            "num_inter": sum(c.tag == "INTER" for c in pg.constraints), "num_nodes": len(pg.nodes),
            "num_submaps": len(pg.submaps)}


def print_inter_residuals(pg):
    """E2E_DEBUG: each INTER constraint against the relative pose its
    submap's and node's global poses imply."""
    for c in pg.constraints:
        if c.tag != "INTER":
            continue
        implied = np_compose(np_inverse(np_rigid(pg.submaps[c.submap_id].global_pose)),
                             np_rigid(pg.nodes[c.node_id].global_pose))
        rel_t = np.asarray(c.relative.translation)
        dt_ = float(np.linalg.norm(implied.translation - rel_t))
        print(f"INTER s{c.submap_id} n{c.node_id} score {c.score:.2f} resid_t {dt_:6.2f} rel_t "
              f"{rel_t.round(2)}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = get_device(args.device)
    env = os.environ.get
    laps = float(env("E2E_LAPS", "1.12"))
    debug = bool(env("E2E_DEBUG"))
    cfg = load_config("basic", config_overrides(huber=env("E2E_HUBER", "1") == "1",
                                                min_score=float(env("E2E_MIN_SCORE", "0.45"))))
    builder = MapBuilder(cfg, device=device)
    pg = builder.pose_graph
    total = int(round(laps * 2 * np.pi * RADIUS / SPEED / SCAN_PERIOD))
    gt = []
    for k, (imu, t, pts, ptimes, pose) in enumerate(
            course(N_REST + total, float(env("E2E_NOISE", "1.0")), float(env("E2E_BIAS", "0.004")))):
        for ti, acc, gyr in imu:
            builder.add_imu_data(ti, acc, gyr)
        n_before = len(pg.nodes)
        builder.add_range_data(t, pts, ptimes)
        # the truth follows the nodes: the motion filter drops slow scans
        # without making a node (reference semantics)
        if k >= N_REST and len(pg.nodes) > n_before:
            gt.append((t, np.asarray(pose.translation, np.float64)))
            if debug:
                est = np.asarray(pg.nodes[-1].global_pose.translation)
                err = float(np.linalg.norm(est - gt[-1][1]))
                print(f"scan {k - N_REST:3d} err {err:7.3f}  est {est.round(2)}  gt {gt[-1][1].round(2)}",
                      flush=True)
    pg.wait_for_all_computations()
    if debug:
        print_inter_residuals(pg)

    pre = evaluate(pg, gt)
    lines = [{"phase": "pre_final_optimization", "ate_rmse_m": round(pre["ate_rmse_m"], 4),
              "endpoint_err_m": round(pre["endpoint_err_m"], 4), "num_inter": pre["num_inter"],
              "num_nodes": pre["num_nodes"], "num_submaps": pre["num_submaps"]}]
    print(json.dumps(lines[-1]), flush=True)
    pg.run_final_optimization()
    post = evaluate(pg, gt)
    lines.append({"phase": "post_final_optimization", "ate_rmse_m": round(post["ate_rmse_m"], 4),
                  "endpoint_err_m": round(post["endpoint_err_m"], 4),
                  "improvement": round(pre["ate_rmse_m"] / max(post["ate_rmse_m"], 1e-9), 2)})
    print(json.dumps(lines[-1]), flush=True)
    return lines


if __name__ == "__main__":
    main()
