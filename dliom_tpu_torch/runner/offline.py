"""Offline deterministic replay runner (CLI); port of
dliom_tpu/runner/offline.py.

Counterpart of the reference's `cartographer_offline_node`
(`cartographer_ros/offline_node.cc`): feed a recorded sequence through the
full pipeline at maximum speed, run final optimization, export the
trajectory CSV (`WriteTrajectoryForDLIO`) and a state checkpoint, and report
accuracy vs ground truth when available.

Dataset format (the "bag" analog): one .npz (or a comma-separated list) with

  scans/<k>/points (N, 3) float32, scans/<k>/times (N,), scans/<k>/stamp ()
  imu/times (M,), imu/acc (M, 3), imu/gyr (M, 3)
  gt/times (K,), gt/positions (K, 3)            [optional ground truth]

plus a `synthetic` mode that generates the corkscrew bubbles world on the
fly (the canonical fidelity sequence). The replay runs on the CUDA card
(`--device cuda`, the default) or, on request, on the CPU. Usage:

  python -m dliom_tpu_torch.runner.offline --dataset synthetic --preset basic \
      --output-csv traj.csv --output-state state.npz

`--profile DIR` writes a torch.profiler trace (`DIR/trace.json`, Chrome
trace format) of the replay.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time as wall

import numpy as np
import torch

from dliom_tpu_torch.common.config import load_config
from dliom_tpu_torch.evaluation.ate import ate_rmse, write_trajectory_csv
from dliom_tpu_torch.map_builder import MapBuilder


def _synthetic_dataset(num_static: int = 8, imu_rate: float = 100.0):
    """Generate the corkscrew bubbles sequence with consistent IMU (host
    data: float32 quaternion math on CPU tensors, as the JAX package does
    it in float32)."""
    from dliom_tpu_torch.io.synthetic import SyntheticWorld, corkscrew_trajectory
    from dliom_tpu_torch.transform.rigid import (
        quat_conjugate,
        quat_inverse_rotate,
        quat_multiply,
        quat_slerp,
        quat_to_axis_angle,
    )

    g_norm = 9.80511
    world = SyntheticWorld.create()
    traj = corkscrew_trajectory()
    times = np.asarray([t for t, _ in traj])
    positions = np.stack([np.asarray(p.translation) for _, p in traj])
    vels = np.zeros_like(positions)
    vels[1:-1] = (positions[2:] - positions[:-2]) / (times[2:, None] - times[:-2, None])
    vels[-1] = (positions[-1] - positions[-2]) / (times[-1] - times[-2])

    imu = []
    # static samples before the first scan (for the static initializer) —
    # ending BEFORE the moving stream below starts at times[0] - 0.3, so
    # the combined stream stays strictly time-ordered with no duplicates
    for i in range(int(1.2 * imu_rate)):
        imu.append((0.01 * i - 1.51 + times[0], np.array([0, 0, g_norm], np.float32),
                    np.zeros(3, np.float32)))
    scans = []
    prev_q, prev_t = torch.tensor([1.0, 0.0, 0.0, 0.0]), times[0] - 0.3
    g_world = torch.tensor([0.0, 0.0, -g_norm])
    for k, (t, pose) in enumerate(traj):
        q = torch.from_numpy(np.asarray(pose.rotation, np.float32))
        dt_total = t - prev_t
        n = max(2, int(round(dt_total * imu_rate)))
        sub = dt_total / n
        dq = quat_multiply(quat_conjugate(prev_q), q)
        omega = quat_to_axis_angle(dq).numpy() / dt_total
        a_world = (vels[k] - vels[max(k - 1, 0)]) / dt_total
        for i in range(n):
            s = (i + 0.5) / n
            q_t = quat_slerp(prev_q, q, np.float32(s))
            a_meas = quat_inverse_rotate(
                q_t, torch.from_numpy(a_world.astype(np.float32)) - g_world).numpy()
            imu.append((prev_t + (i + 1) * sub, a_meas.astype(np.float32),
                        omega.astype(np.float32)))
        pts, ptimes = world.cast_scan(pose)
        scans.append((t, pts, ptimes))
        prev_q, prev_t = q, t
    gt = (times, positions)
    return scans, imu, gt


def _load_npz_dataset(path: str):
    z = np.load(path, allow_pickle=False)
    scans = []
    k = 0
    while True:
        key = f"scans/{k}/points"
        if key not in z:
            break
        stamp = float(z[f"scans/{k}/stamp"])
        pts = z[key]
        tms = z.get(f"scans/{k}/times", np.zeros(len(pts), np.float32))
        scans.append((stamp, pts, tms))
        k += 1
    imu = [
        (float(t), a.astype(np.float32), g.astype(np.float32))
        for t, a, g in zip(z["imu/times"], z["imu/acc"], z["imu/gyr"])
    ]
    gt = None
    if "gt/times" in z:
        gt = (z["gt/times"], z["gt/positions"])
    return scans, imu, gt


def run_config(args):
    """The configuration a replay of `args` runs under: the preset with the
    JSON overrides, and for the synthetic dataset its sensor and grid
    settings."""
    cfg = load_config(args.preset, json.loads(args.config_overrides or "{}"))
    if args.dataset != "synthetic":
        return cfg
    return cfg.override(
        {
            "trajectory_builder": {
                "min_range": 0.5, "max_range": 50.0, "voxel_filter_size": 0.2,
                "scan_period": 0.3, "enable_gravity_factor": False,
                "frames_for_static_initialization": 4,
                "high_resolution_adaptive_voxel_filter": {
                    "max_length": 0.7, "min_num_points": 200, "max_range": 50.0},
                "low_resolution_adaptive_voxel_filter": {
                    "max_length": 0.7, "min_num_points": 200, "max_range": 50.0},
                "ceres_scan_matcher": {
                    "occupied_space_weight_0": 5.0, "occupied_space_weight_1": 20.0,
                    "translation_weight": 0.1, "rotation_weight": 0.3,
                    "max_num_iterations": 15},
                "motion_filter": {"max_time_seconds": 0.2,
                                  "max_distance_meters": 0.02,
                                  "max_angle_radians": 0.001},
                "imu": {"ceres_pose_noise_t": 0.05, "ceres_pose_noise_r": 0.05,
                        "prior_vel_noise": 0.5, "prior_bias_noise": 0.05},
                "submaps": {
                    "high_resolution": 0.2, "high_resolution_max_range": 50.0,
                    "low_resolution": 0.5, "num_range_data": 6,
                    "high_resolution_extent": 192, "low_resolution_extent": 96,
                    "range_data_inserter": {"hit_probability": 0.7,
                                            "miss_probability": 0.4,
                                            "num_free_space_voxels": 0}},
                "max_filtered_points": 16384,
                "max_high_res_points": 2048, "max_low_res_points": 2048,
                "window_size": 6, "gn_iterations": 6,
            }
        }
    )


def run(args, on_builder=None) -> dict:
    """Replay the dataset and return the report dict. `on_builder`
    (optional) is called with the finished MapBuilder just before
    returning, so callers can derive extra metrics — constraint precision
    vs ground truth — from the final pose graph without re-running the
    replay. `args.device` (default "cuda") is where the builder runs."""
    cfg = run_config(args)
    if args.dataset == "synthetic":
        scans, imu, gt = _synthetic_dataset()
    else:
        # multi-bag replay (offline_node's sequential bag list): a
        # comma-separated dataset list maps as ONE continuous trajectory
        paths = [p for p in args.dataset.split(",") if p]
        scans, imu, gt = _load_npz_dataset(paths[0])
        for p in paths[1:]:
            s2, i2, g2 = _load_npz_dataset(p)
            scans.extend(s2)
            imu.extend(i2)
            if g2 is not None:
                gt = g2 if gt is None else (np.concatenate([gt[0], g2[0]]),
                                            np.concatenate([gt[1], g2[1]]))
        scans.sort(key=lambda s: s[0])
        imu.sort(key=lambda s: s[0])
        if gt is not None:
            order = np.argsort(gt[0])
            gt = (gt[0][order], gt[1][order])

    builder_kwargs = dict(
        device=getattr(args, "device", None) or "cuda",
        # backend-on replay (the reference's 8 background threads + free
        # ROS/SLAM thread overlap): loop search on the native task pool,
        # per-scan host fetch pipelined one scan deep
        use_background_threads=bool(getattr(args, "background_threads", False)),
        pipeline_depth=int(getattr(args, "pipeline_depth", 0)),
    )
    if getattr(args, "load_state", None):
        from dliom_tpu_torch.map_builder import map_builder_from_state

        builder = map_builder_from_state(
            args.load_state, cfg,
            pure_localization=bool(getattr(args, "pure_localization", False)), **builder_kwargs)
    else:
        builder = MapBuilder(cfg, **builder_kwargs)
    profile_dir = getattr(args, "profile", None)
    prof = None
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if builder.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
    imu_idx = 0
    t0 = wall.perf_counter()
    n_results = 0
    for stamp, points, ptimes in scans:
        while imu_idx < len(imu) and imu[imu_idx][0] <= stamp:
            t, a, g = imu[imu_idx]
            builder.add_imu_data(t, a, g)
            imu_idx += 1
        res = builder.add_range_data(stamp, points, ptimes)
        if res is not None:
            n_results += 1
            if args.verbose:
                p = res["local_pose"].translation
                print(
                    f"t={stamp:8.2f} p=({p[0]:+7.2f},{p[1]:+7.2f},{p[2]:+7.2f})"
                    f" inserted={res['inserted']}",
                    file=sys.stderr,
                )
    # Finish trajectories and wait for the background constraint searches,
    # then capture PRE-final-optimization poses (the frontend+periodic-SPA
    # estimate) before RunFinalOptimization — the reference's eval loop
    # likewise distinguishes the online estimate from the final one
    # (offline_node.cc RunFinalOptimization after the bag ends).
    for tid in list(builder._trajectories):
        builder.finish_trajectory(tid)
    builder.pose_graph.wait_for_all_computations()
    pre_nodes = builder.optimized_node_poses()
    builder.finish_trajectory()
    if builder.device.type == "cuda":
        torch.cuda.synchronize(builder.device)
    elapsed = wall.perf_counter() - t0
    if prof is not None:
        prof.stop()
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))

    nodes = builder.optimized_node_poses()
    report = {
        # frame names ride along for downstream tooling (the TF tree's
        # map_frame/tracking_frame, node_constants.h)
        "map_frame": cfg.map_frame,
        "tracking_frame": cfg.tracking_frame,
        "num_scans": len(scans),
        "num_matched": n_results,
        "num_nodes": len(nodes),
        "num_submaps": len(builder.pose_graph.submaps),
        "num_constraints": len(builder.pose_graph.constraints),
        "num_loop_constraints": builder.pose_graph.num_inter_constraints(),
        "wall_seconds": round(elapsed, 2),
        "scans_per_sec": round(len(scans) / max(elapsed, 1e-9), 2),
    }
    if prof is not None:
        report["profile_trace"] = os.path.join(profile_dir, "trace.json")
    lat = builder.pose_graph.constraint_search_seconds
    if lat:
        # per-finished-submap loop-search latency (backend-on benchmark
        # surface; the reference runs these on 8 background threads)
        report["constraint_search_latency_s"] = {
            "count": len(lat),
            "mean": round(float(np.mean(lat)), 3),
            "p50": round(float(np.median(lat)), 3),
            "p99": round(float(np.percentile(np.asarray(lat), 99)), 3),
            "max": round(float(np.max(lat)), 3),
        }
    slat = builder.local_slam_latency_seconds
    if slat:
        # per-scan online latency (local_slam_latency metric parity,
        # local_trajectory_builder_3d.cc:624-649)
        a = np.asarray(slat)
        report["scan_latency_ms"] = {
            "p50": round(float(np.percentile(a, 50)) * 1e3, 2),
            "p99": round(float(np.percentile(a, 99)) * 1e3, 2),
            "max": round(float(np.max(a)) * 1e3, 2),
        }
    if builder.pose_graph.phase_seconds:
        report["phase_seconds"] = {
            k: round(v, 3)
            for k, v in sorted(builder.pose_graph.phase_seconds.items())
        }
    if nodes and args.output_csv:
        write_trajectory_csv(
            args.output_csv, [t for t, _ in nodes], [p for _, p in nodes]
        )
        report["trajectory_csv"] = args.output_csv
    if getattr(args, "output_pbstream", None):
        from dliom_tpu_torch.io.pbstream import write_pbstream

        write_pbstream(args.output_pbstream, builder.pose_graph)
        report["pbstream_file"] = args.output_pbstream
    if getattr(args, "output_range_data", None):
        from dliom_tpu_torch.io.pbstream import write_range_data_pbstream

        write_range_data_pbstream(args.output_range_data, builder.pose_graph)
        report["range_data_file"] = args.output_range_data
    if nodes and args.output_kitti:
        from dliom_tpu_torch.evaluation.ate import write_kitti_trajectory

        write_kitti_trajectory(args.output_kitti, [p for _, p in nodes])
        report["kitti_file"] = args.output_kitti
    if nodes and args.output_tum:
        from dliom_tpu_torch.evaluation.ate import write_tum_trajectory

        write_tum_trajectory(
            args.output_tum, [t for t, _ in nodes], [p for _, p in nodes]
        )
        report["tum_file"] = args.output_tum
    if args.output_relations:
        from dliom_tpu_torch.evaluation.ground_truth import (
            generate_ground_truth,
            write_relations_csv,
        )

        rels, outliers = generate_ground_truth(
            builder.pose_graph,
            min_covered_distance=args.relations_min_covered_distance,
        )
        write_relations_csv(args.output_relations, rels)
        report["relations_file"] = args.output_relations
        report["num_relations"] = len(rels)
        report["num_relation_outliers"] = outliers
    if args.output_state:
        from dliom_tpu_torch.io.serialization import save_state

        save_state(args.output_state, builder.pose_graph, args.preset)
        report["state_file"] = args.output_state
    if args.output_ply or args.output_xray:
        from dliom_tpu_torch.io.assets_writer import (
            aggregate_point_cloud,
            write_ply,
            write_xray_pgm,
        )

        cloud = aggregate_point_cloud(builder.pose_graph)
        if args.output_ply:
            write_ply(args.output_ply, cloud)
            report["ply_file"] = args.output_ply
        if args.output_xray:
            write_xray_pgm(args.output_xray, cloud)
            report["xray_file"] = args.output_xray
    if args.assets_pipeline:
        # declarative points-processor pipeline (assets_writer_main analog;
        # same {"action": ...} stage schema as the reference's Lua pipeline)
        from dliom_tpu_torch.io.points_pipeline import run_pipeline

        with open(args.assets_pipeline) as f:
            pipeline = json.load(f)
        stats = run_pipeline(
            builder.pose_graph, pipeline, args.assets_dir or "."
        )
        report["assets_pipeline"] = stats
    if gt is not None and nodes:
        gt_t, gt_p = gt
        from dliom_tpu_torch.evaluation.ate import associate

        def _ate(node_list):
            est_t = np.asarray([t for t, _ in node_list])
            est_p = np.stack(
                [np.asarray(p.translation) for _, p in node_list]
            )
            est_cov, gt_interp = associate(est_t, est_p, gt_t, gt_p)
            if len(est_cov) < 3:
                return None, None
            return (
                round(ate_rmse(est_cov, gt_interp, align=False), 4),
                round(ate_rmse(est_cov, gt_interp, align=True), 4),
            )

        raw, aligned = _ate(nodes)
        if raw is not None:
            report["ate_rmse_m"] = raw
            report["ate_rmse_aligned_m"] = aligned
        if pre_nodes:
            raw, aligned = _ate(pre_nodes)
            if raw is not None:
                report["pre_optimization_ate_rmse_m"] = raw
                report["pre_optimization_ate_rmse_aligned_m"] = aligned
    if on_builder is not None:
        on_builder(builder, report)
    return report


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", default="synthetic",
                    help="'synthetic' or path(s) to .npz dataset(s); a "
                         "comma-separated list replays sequentially as one "
                         "trajectory (offline_node multi-bag analog)")
    ap.add_argument("--preset", default="basic")
    ap.add_argument("--config-overrides", default=None,
                    help="JSON dict of config overrides")
    ap.add_argument("--output-csv", default=None)
    ap.add_argument("--output-state", default=None)
    ap.add_argument("--output-pbstream", default=None,
                    help="reference-schema pbstream export "
                         "(offline_node.cc -save_pbstream analog; readable "
                         "by cartographer pbstream tooling)")
    ap.add_argument("--output-range-data", default=None,
                    help="per-node range data pbstream "
                         "(-save_range_data analog, consumed by the "
                         "reference's offline map viewer)")
    ap.add_argument("--assets-pipeline", default=None,
                    help="JSON file with a points-processor pipeline "
                         "(assets_writer pipeline analog)")
    ap.add_argument("--assets-dir", default=None,
                    help="output directory for --assets-pipeline products")
    ap.add_argument("--output-ply", default=None,
                    help="export the aggregate map point cloud (assets writer)")
    ap.add_argument("--output-xray", default=None,
                    help="export a top-down xray PGM image")
    ap.add_argument("--output-kitti", default=None,
                    help="export trajectory in KITTI 3x4 row format")
    ap.add_argument("--output-tum", default=None,
                    help="export trajectory in TUM (evo-compatible) format")
    ap.add_argument("--output-relations", default=None,
                    help="autogenerate ground-truth relations CSV from loops")
    ap.add_argument("--relations-min-covered-distance", type=float, default=100.0)
    ap.add_argument("--load-state", default=None,
                    help="resume from / localize against a saved state "
                         "(-load_state_filename analog)")
    ap.add_argument("--pure-localization", action="store_true",
                    help="freeze the loaded map (PureLocalizationTrimmer)")
    ap.add_argument("--profile", default=None,
                    help="write a torch.profiler trace (trace.json) of the "
                         "replay to this directory (the TicToc/RateTimer "
                         "analog, SURVEY §5)")
    ap.add_argument("--device", default="cuda",
                    help="where the replay runs: 'cuda' (the card, the "
                         "default; raises where there is none) or 'cpu'")
    ap.add_argument("--background-threads", action="store_true",
                    help="run loop-constraint search on the native task "
                         "pool (MAP_BUILDER.num_background_threads analog)")
    ap.add_argument("--pipeline-depth", type=int, default=0,
                    help="defer each scan's host fetch N scans (hides the "
                         "device round trip; results lag by N)")
    ap.add_argument("--verbose", action="store_true")
    return ap


def main(argv=None):
    report = run(build_parser().parse_args(argv))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
