#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port (dliom_tpu_torch) on one card: the
counterpart of bench.py, with its configurations, courses, gates and keys.

    python3 bench_torch.py                        # frontend, then bench_e2e
    BENCH_E2E=0 python3 bench_torch.py            # frontend only
    BENCH_E2E_FLAGSHIP=1 python3 bench_torch.py   # adds the dual-brick flagship course

Full tightly-coupled LIO scans/sec at bench.py's VIRAL-faithful config
(IMU preintegration + deskew + voxel filters + GN scan match + window
fusion + grid insertion), through the compiled chunk
(`frontend/lio.py::make_jit_lio_chunk`: CHUNK steps captured into one CUDA
graph, one replay per chunk), then the backend-on course of `bench_e2e`
through `MapBuilder` (submap finish, background loop search, periodic SPA).

Prints ONE JSON line with bench.py's keys, in its order and rounding:
  {"metric": "lio_scans_per_sec", "value": N, "unit": "scans/s", "vs_baseline": N,
   "brick_groups_dropped": 0, "low_brick_groups_dropped": 0, "dense_groups_dropped": 0,
   "e2e_scans_per_sec": N, ...}
plus one key bench.py's line lacks: `e2e_phase_compress_s` (and
`e2e_flagship_phase_compress_s`), the host seconds the port's MapBuilder
spends queueing a finished submap's compression, a phase JAX's MapBuilder
does not time.

Environment, as bench.py's: BENCH_E2E=0 skips the backend-on course;
BENCH_E2E_FLAGSHIP=1 adds it at the flagship dual-brick config (keys
prefixed e2e_flagship_); BENCH_E2E_POOL sets the background threads (2;
0 runs the searches inline); BENCH_E2E_CHUNK the nodes per search dispatch
(4).

It runs on the CUDA card, and raises where there is none, unless `main`
or `bench_e2e` is given `device="cpu"`. It imports nothing of JAX. The
chunk's state and results are the graph's buffers, rewritten by the next
replay: the drop gauges are read after the last replay, before anything
else is queued. `bench_e2e` ends its timed lap as bench.py does
(`builder.flush()`, `pg.wait_for_all_computations()`), never with a
device-wide synchronize, which would lose a capture underway on a pool
thread.
"""

import json
import os
import time

import numpy as np
import torch

import dliom_tpu_torch  # noqa: F401  (pins f32, TF32 off)
from dliom_tpu_torch.common.config import load_config
from dliom_tpu_torch.common.device import get_device
from dliom_tpu_torch.frontend.lio import LioScanInput, make_jit_lio_chunk, make_lio_state
from dliom_tpu_torch.imu import preintegration as pre
from dliom_tpu_torch.io.synthetic import SyntheticWorld, corkscrew_trajectory
from dliom_tpu_torch.sensor.types import pad_point_cloud
from dliom_tpu_torch.transform.rigid import Rigid3

CAPACITY = 32768  # raw points per scan (VIRAL-like density)
IMU_CAP = 48  # 400 Hz x 0.1 s + margin
CHUNK = 10  # scans per compiled chunk (one graph replay)
WARMUP = 2
MEASURE = 8
G = 9.80511

E2E_RADIUS, E2E_SPEED, E2E_SCAN_PERIOD = 5.0, 1.5, 0.1


def build_config():
    """bench.py's build_config: the VIRAL-faithful bench config (0.1 m
    high and 0.45 m low brick grids on the grouped apply)."""
    return load_config(
        "basic",
        {
            "trajectory_builder": {
                "scan_period": 0.1,
                "voxel_filter_size": 0.3,
                "enable_gravity_factor": False,
                "submaps": {
                    "high_resolution": 0.1,
                    "high_resolution_max_range": 60.0,
                    "low_resolution": 0.45,
                    "num_range_data": 100,
                    "use_brick_grid": True,
                    "brick_dir_extent": 160,  # ±64 m at 0.1 m
                    "brick_max_bricks": 65536,
                    "brick_apply_groups": 512,
                    "dense_apply_groups": 256,
                    "high_resolution_extent": 448,  # backend capture crop
                    "low_resolution_extent": 128,  # backend capture crop
                    "use_brick_grid_low": True,
                    "low_brick_dir_extent": 40,
                    "low_brick_max_bricks": 8192,
                    "low_brick_apply_groups": 192,
                    "low_brick_apply_group_bricks": 8,
                },
                "max_filtered_points": 8192,
                "max_high_res_points": 256,
                "max_low_res_points": 256,
                "max_imu_per_scan": IMU_CAP,
                "window_size": 6,
                "gn_iterations": 3,
                "ceres_scan_matcher": {
                    "max_num_iterations": 6,
                    "function_tolerance": 1e-3,
                },
            }
        },
    ).trajectory_builder


def flagship_submaps():
    """bench.py's flagship submaps: the dual-brick grids of build_config,
    with backend crops of 448 / 288 cells (±22.4 m high against the 15 m
    high cloud, ±64.8 m low against the 60 m low cloud)."""
    return {
        "high_resolution": 0.1,
        "high_resolution_max_range": 60.0,
        "low_resolution": 0.45,
        "num_range_data": 16,
        "use_brick_grid": True,
        "brick_dir_extent": 160,
        "brick_max_bricks": 65536,
        "brick_apply_groups": 512,
        "dense_apply_groups": 256,
        "high_resolution_extent": 448,
        "low_resolution_extent": 288,
        "use_brick_grid_low": True,
        "low_brick_dir_extent": 40,
        "low_brick_max_bricks": 8192,
        "low_brick_apply_groups": 192,
        "low_brick_apply_group_bricks": 8,
    }


def e2e_config(flagship: bool = False):
    """bench.py's bench_e2e config, with BENCH_E2E_POOL's background
    threads (what bench.py gives its MapBuilder)."""
    submaps = flagship_submaps() if flagship else {
        "high_resolution": 0.2,
        "low_resolution": 0.8,
        "high_resolution_extent": 128,
        "low_resolution_extent": 64,
        "num_range_data": 16,
    }
    cfg = load_config(
        "basic",
        {
            "trajectory_builder": {
                "scan_period": E2E_SCAN_PERIOD,
                "frames_for_static_initialization": 8,
                "enable_ndt_initialization": False,
                "submaps": submaps,
                "max_filtered_points": 8192,
                "max_high_res_points": 256,
                "max_low_res_points": 256,
            },
            "pose_graph": {
                "optimize_every_n_nodes": 32,
                "max_submaps": 32,
                "max_nodes": 512,
                "max_constraints": 2048,
                "max_radius_enable_loop_detection": 10.0,
                "num_close_submaps_loop_with_initial_value": 5,
                "constraint_builder": {
                    "min_score": 0.45,
                    "every_nodes_to_find_constraint": 2,
                    "max_nodes_per_search_dispatch": int(os.environ.get("BENCH_E2E_CHUNK", "4")),
                },
            },
        },
    )
    n_pool = e2e_pool()
    if n_pool > 0:
        cfg = cfg.override({"map_builder": {"num_background_threads": n_pool}})
    return cfg


def e2e_pool() -> int:
    """BENCH_E2E_POOL: the background threads of bench_e2e (0: inline)."""
    return int(os.environ.get("BENCH_E2E_POOL", "2"))


def circle_pose(tau: float, radius: float = E2E_RADIUS, speed: float = E2E_SPEED):
    """bench_e2e's true pose (numpy Rigid3) and world velocity at time tau
    on the circle, heading along its tangent."""
    ang = speed / radius * tau
    p = np.array([radius * np.sin(ang), radius * (1.0 - np.cos(ang)), 0.0], np.float32)
    v = np.array([speed * np.cos(ang), speed * np.sin(ang), 0.0])
    q = np.array([np.cos(ang / 2), 0.0, 0.0, np.sin(ang / 2)], np.float32)
    return Rigid3(q, p), v


def bench_e2e(flagship: bool = False, prefix: str = "e2e", device=None):
    """Full-pipeline throughput, bench.py's bench_e2e: a drifted circle
    through MapBuilder with submap finish, background loop search and the
    periodic optimization running. 16 static scans and a warm-up of 1.12
    laps (235 scans) untimed, which pay every capture (the step, the
    decompression and pyramid, the searches, the SPA); then one timed lap
    (209 scans). Returns the extra JSON fields, prefixed `prefix`.

    `flagship=True` runs the same course at the VIRAL-faithful dual-brick
    config (`flagship_submaps`) instead of the dense 0.2 / 0.8 m grids."""
    from dliom_tpu_torch.io.synthetic import ImuNoise, ImuSimulator
    from dliom_tpu_torch.map_builder import MapBuilder

    scan_period = E2E_SCAN_PERIOD
    cfg = e2e_config(flagship)
    n_pool = e2e_pool()
    builder = MapBuilder(cfg, use_background_threads=n_pool > 0, pipeline_depth=1,
                         device=get_device("cuda" if device is None else device))
    world = SyntheticWorld.create(num_beams=16, num_azimuths=600)
    sim = ImuSimulator(
        rate=100.0,
        noise=ImuNoise(acc_noise=0.02, gyr_noise=0.002, gyr_bias0=(0.0, 0.0, 0.004)),
        gravity=G,
        seed=4,
    )
    t = 0.0
    pose0, _ = circle_pose(0.0)

    def feed(prev_pose, pose, prev_v, v):
        nonlocal t
        dts, accs, gyrs, mask = sim.between(prev_pose, pose, prev_v, v, scan_period, 64)
        for i in range(int(np.asarray(mask).sum())):
            t += float(dts[i])
            builder.add_imu_data(t, np.asarray(accs[i]), np.asarray(gyrs[i]))
        pts, ptimes = world.cast_scan(pose)
        builder.add_range_data(t, pts, ptimes)

    # untimed: static init + 1.12 laps, loop closure active (the revisit)
    for _ in range(int(round(1.6 / scan_period))):
        feed(pose0, pose0, np.zeros(3), np.zeros(3))
    lap = 2 * np.pi * E2E_RADIUS / E2E_SPEED / scan_period
    warm = int(round(1.12 * lap))
    prev_pose, prev_v = pose0, np.zeros(3)
    tau = 0.0
    for _ in range(warm):
        tau += scan_period
        pose, v = circle_pose(tau)
        feed(prev_pose, pose, prev_v, v)
        prev_pose, prev_v = pose, v
    pg = builder.pose_graph
    builder.flush()
    pg.wait_for_all_computations()
    # the percentile and phase surfaces cover the timed lap only
    builder.local_slam_latency_seconds.clear()
    pg.constraint_search_seconds.clear()
    pg.phase_seconds.clear()

    # timed: one more full lap
    timed = int(round(lap))
    t0 = time.perf_counter()
    for _ in range(timed):
        tau += scan_period
        pose, v = circle_pose(tau)
        feed(prev_pose, pose, prev_v, v)
        prev_pose, prev_v = pose, v
    builder.flush()
    pg.wait_for_all_computations()
    dt = time.perf_counter() - t0
    inter = sum(1 for c in pg.constraints if c.tag == "INTER")
    lat = np.asarray(builder.local_slam_latency_seconds)
    search = np.asarray(pg.constraint_search_seconds)
    p = prefix
    out = {
        f"{p}_scans_per_sec": round(timed / dt, 2),
        f"{p}_vs_baseline": round(timed / dt / 30.0, 2),
        f"{p}_num_inter_constraints": inter,
        f"{p}_num_nodes": len(pg.nodes),
        f"{p}_num_submaps": len(pg.submaps),
    }
    if len(lat):
        # online-latency percentiles (local_trajectory_builder_3d.cc:624-649)
        out[f"{p}_scan_latency_p50_ms"] = round(float(np.percentile(lat, 50)) * 1e3, 2)
        out[f"{p}_scan_latency_p99_ms"] = round(float(np.percentile(lat, 99)) * 1e3, 2)
    if len(search):
        out[f"{p}_search_p50_s"] = round(float(np.percentile(search, 50)), 3)
        out[f"{p}_search_p99_s"] = round(float(np.percentile(search, 99)), 3)
    # per-phase wall breakdown over the timed lap (seconds)
    for k, v in sorted(pg.phase_seconds.items()):
        out[f"{p}_phase_{k}_s"] = round(v, 3)
    out[f"{p}_wall_s"] = round(dt, 2)
    return out


def bench_scans():
    """bench.py's ten scans as host arrays (LioScanInput's fields): the
    corkscrew poses cast in the default world, padded to CAPACITY, each
    with 40 IMU samples at 400 Hz of gravity plus noise drawn from
    default_rng(0) in bench.py's order."""
    world = SyntheticWorld.create()
    traj = corkscrew_trajectory()
    scans = []
    rng = np.random.default_rng(0)
    for t, pose in traj[:10]:
        pts, times = world.cast_scan(pose)
        cloud = pad_point_cloud(pts, times, CAPACITY)
        n_imu = 40  # 400 Hz IMU at 10 Hz scans
        dts = np.full(IMU_CAP, 0.0025, np.float32)
        accs = np.tile(np.array([0, 0, G], np.float32), (IMU_CAP, 1))
        accs += rng.normal(0, 0.01, accs.shape).astype(np.float32)
        gyrs = rng.normal(0, 0.002, (IMU_CAP, 3)).astype(np.float32)
        mask = np.arange(IMU_CAP) < n_imu
        scans.append(LioScanInput(time=np.float32(t), points=cloud.points, times=cloud.times,
                                  mask=cloud.mask, imu_dts=dts, imu_acc=accs, imu_gyr=gyrs,
                                  imu_mask=mask))
    return scans


def stack_scans(scans, device):
    """Host scans stacked on a leading axis, on `device`."""
    return LioScanInput(*(torch.from_numpy(np.stack([np.asarray(getattr(s, f)) for s in scans])).to(device)
                          for f in LioScanInput._fields))


def drop_gauges(state):
    """bench.py's validity gauges: groups the apply capacities dropped."""
    sm = state.frontend.submaps
    return {
        "brick_groups_dropped": int(sm.high_brick.dropped[0]) if sm.high_brick is not None else 0,
        "low_brick_groups_dropped": int(sm.low_brick.dropped[0]) if sm.low_brick is not None else 0,
        "dense_groups_dropped": int(sm.dense_dropped[0]) if sm.dense_dropped is not None else 0,
    }


def drop_gate(drops):
    """Apply-group capacity overflow silently degrades the map (updates
    dropped, only a gauge increments) while throughput stays flat: a
    bench number with nonzero drops is not a valid result."""
    if any(drops.values()):
        raise SystemExit(
            f"benchmark invalid: grid updates were dropped {drops} — raise "
            "the apply-group capacities (brick_apply_groups / "
            "low_brick_apply_groups / dense_apply_groups)"
        )


def inter_gate(e2e):
    """The backend-on phase must close a loop, else its throughput covers
    no constraint work."""
    if e2e and e2e["e2e_num_inter_constraints"] < 1:
        raise SystemExit(
            "benchmark invalid: the backend-on phase closed no loop — the "
            f"e2e throughput would not cover constraint work ({e2e})"
        )


def _sync(device):
    """Wait for the work queued on this thread's stream (not the device)."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def main(device=None):
    """bench.py's main on the port; prints the JSON line and returns it as
    a dict."""
    dev = get_device("cuda" if device is None else device)
    cfg = build_config()
    # the chunk replays CHUNK of bench.py's ten scans (all ten at CHUNK 10)
    stacked = stack_scans(bench_scans()[:CHUNK], dev)
    zero = torch.zeros(3, device=dev)
    state = make_lio_state(cfg, pre.NavState.identity(dev), zero, zero)
    # one CUDA graph of CHUNK steps: the first call is the eager warm-up
    # and the capture, every later call one replay (bench.py's lax.scan in
    # one dispatch)
    chunk = make_jit_lio_chunk(cfg, CHUNK)

    for _ in range(WARMUP):
        state, results = chunk(state, stacked)
    _sync(dev)

    t0 = time.perf_counter()
    for _ in range(MEASURE):
        state, results = chunk(state, stacked)
    _sync(dev)
    dt = time.perf_counter() - t0

    scans_per_sec = MEASURE * CHUNK / dt

    drops = drop_gauges(state)
    drop_gate(drops)

    e2e = {} if os.environ.get("BENCH_E2E") == "0" else bench_e2e(device=dev)
    inter_gate(e2e)
    if os.environ.get("BENCH_E2E_FLAGSHIP") == "1":
        e2e.update(bench_e2e(flagship=True, prefix="e2e_flagship", device=dev))

    out = {
        "metric": "lio_scans_per_sec",
        "value": round(scans_per_sec, 2),
        "unit": "scans/s",
        "vs_baseline": round(scans_per_sec / 30.0, 2),
        **drops,
        **e2e,
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
