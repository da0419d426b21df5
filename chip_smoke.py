#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (dliom_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failed check raises and the exit code is non-zero:

  1. environment: torch and CUDA versions, the card's name and power limit;
  2. build: compile the CUDA kernels of dliom_tpu_torch/csrc with nvcc;
  3. K1 (grouped grid-update apply) against its plain PyTorch version at
     the bench config's two brick shapes, bit for bit, and both timed;
  4. K2 (IMU affine chain) against its plain version, rtol 1e-5 / atol
     1e-6, both timed;
  5. the slice: `lio_step` at the bench config (bench.py's
     build_config values, 32768 raw points and 48 IMU samples per scan,
     the synthetic corkscrew with bench.py's IMU recipe), 2 warm-up scans
     then timed scans across a submap spawn; finite poses, no failure, no
     dropped grid updates, kernel launch counts from the timed run, and
     the first 3 scans against the port's own CPU run (plain versions);
  6. where the time goes: torch.profiler over 3 more scans, per span of
     lio_step (host time, kernel time, launches) and the card's idle share.

Scan stamps are spaced 0.6 s apart so the motion filter (max_time_seconds
0.5) admits every scan and the run reaches num_range_data = 100 inserts.
bench.py's apply capacities (512 high / 192 low groups per insert) hold one
active submap; after a spawn both active submaps take every scan, which
touches about twice the groups, so this run sets 1024 / 384. They are
capacity knobs: a run without drops inserts the same map at any capacity.
K1 is checked at both pairs of shapes.

The line before the last is the per-kernel JSON record ({"kernels": [...]});
the last line is {"ok": true, "device": {...}}. Imports nothing of JAX.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

CAPACITY = 32768  # raw points per scan
IMU_CAP = 48
WARMUP = 2
TIMED = 104  # crosses the spawn at the 100th inserted scan
COMPARE = 3  # scans compared with the CPU run
POSE_ATOL = 2e-3  # m and quaternion components, as tests/test_torch_lio.py
REPEATS = 25
PROFILED = 3  # scans under torch.profiler after the timed run (phase 6)
SPANS = ("lio.preintegrate", "frontend.filter", "frontend.match", "lio.window",
         "frontend.insert", "frontend.histogram")
G = 9.80511

BENCH_OVERRIDES = {
    # bench.py build_config (the VIRAL-faithful bench config)
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
            "brick_dir_extent": 160,
            "brick_max_bricks": 65536,
            "brick_apply_groups": 512,
            "dense_apply_groups": 256,
            "high_resolution_extent": 448,
            "low_resolution_extent": 128,
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
        "ceres_scan_matcher": {"max_num_iterations": 6, "function_tolerance": 1e-3},
    }
}
# two active submaps after a spawn: twice bench.py's apply capacities
SPAWN_CAPACITIES = {"brick_apply_groups": 1024, "low_brick_apply_groups": 384}


def check(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def timed_median(fn, repeats=REPEATS):
    """Median wall time in ms of fn(), each run bracketed by synchronize."""
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def environment():
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
    check(torch.cuda.is_available(), "torch.cuda.is_available()")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    return card


def grouped_apply_case(rng, cells_per_group, num_groups, num_steps, num_records, real_steps):
    """A bank and one insert's tables at a bench shape: sorted records with
    duplicate cells and mixed hit/miss, fresh steps, and empty-range steps
    (parking and mid-sequence drops) sharing the parking row."""
    bank = rng.integers(0, 32768, num_groups * cells_per_group).astype(np.int16)
    park = num_groups - 1
    rows = np.full(num_steps, park, np.int32)
    rows[:real_steps] = rng.choice(park, real_steps, replace=False)
    rows[rng.choice(real_steps, 8, replace=False)] = park  # pool-full drops
    fresh = np.zeros(num_steps, np.int32)
    fresh[rng.choice(np.flatnonzero(rows != park), 16, replace=False)] = 1
    counts = np.where(rows != park, rng.multinomial(num_records, np.ones(num_steps) / num_steps), 0)
    keys, starts, ends = [], [], []
    for n in counts:
        starts.append(len(keys))
        cells = rng.integers(0, cells_per_group // 4, n) * 4  # duplicates
        keys.extend(sorted((cells << 1) | rng.integers(0, 2, n)))
        ends.append(len(keys))
    keys = np.asarray(keys + [2**31 - 1] * (num_records - len(keys) + 1), np.int32)
    return [torch.from_numpy(x).cuda() for x in
            (bank, rows, np.asarray(starts, np.int32), np.asarray(ends, np.int32), keys, fresh)]


def check_grouped_apply(ga, rng):
    hit_odds, miss_odds = 0.55 / 0.45, 0.49 / 0.51
    out = {}
    # (cells_per_group, pool groups over both slots, steps, steps with
    # records): high and low bricks at bench.py's and at the spawn capacities
    for tag, cpg, groups, steps, real in (("high", 16384, 2 * 2048, 512, 440),
                                          ("low", 4096, 2 * 1024, 192, 170),
                                          ("high_spawn", 16384, 2 * 2048, 1024, 900),
                                          ("low_spawn", 4096, 2 * 1024, 384, 260)):
        bank, rows, starts, ends, keys, fresh = grouped_apply_case(rng, cpg, groups, steps, 49152, real)
        kw = dict(cells_per_group=cpg, hit_odds=hit_odds, miss_odds=miss_odds, fresh=fresh)
        k = ga.apply_grouped_rows(bank.clone(), rows, starts, ends, keys, **kw)
        p = ga.apply_grouped_rows_plain(bank.clone(), rows, starts, ends, keys, **kw)
        torch.cuda.synchronize()
        err = int((k.int() - p.int()).abs().max())
        check(torch.equal(k, p), f"K1 {tag}: kernel bank differs from plain ({err})")
        check(not torch.equal(k, bank), f"K1 {tag}: nothing changed")
        work = bank.clone()
        ms = timed_median(lambda: ga.apply_grouped_rows(work, rows, starts, ends, keys, **kw))
        plain_ms = timed_median(lambda: ga.apply_grouped_rows_plain(work, rows, starts, ends, keys, **kw))
        print(f"K1 grouped_apply {tag}: cpg {cpg} steps {steps} records {int(ends[-1])}: "
              f"bit-identical; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        out[tag] = (err, ms, plain_ms)
    return out


def check_affine_chain(ac, rng):
    f = torch.from_numpy((np.eye(15) + 0.01 * rng.normal(size=(IMU_CAP, 15, 15))).astype(np.float32)).cuda()
    q = rng.normal(size=(IMU_CAP, 15, 15)).astype(np.float32) * 1e-3
    q = torch.from_numpy(q @ np.swapaxes(q, 1, 2)).cuda()
    a_k, p_k = ac.affine_chain(f, q)
    a_p, p_p = ac.affine_chain_plain(f, q)
    torch.cuda.synchronize()
    torch.testing.assert_close(a_k, a_p, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(p_k, p_p, rtol=1e-5, atol=1e-6)
    err = float(max((a_k - a_p).abs().max(), (p_k - p_p).abs().max()))
    ms = timed_median(lambda: ac.affine_chain(f, q))
    plain_ms = timed_median(lambda: ac.affine_chain_plain(f, q))
    print(f"K2 affine_chain M={IMU_CAP}: max abs err {err:.3e} (rtol 1e-5, atol 1e-6); "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return err, ms, plain_ms


def bench_scans(device):
    """bench.py's ten scans (corkscrew poses, IMU recipe, seed 0), cycled,
    stamped 0.6 s apart."""
    from dliom_tpu_torch.frontend.lio import LioScanInput
    from dliom_tpu_torch.io.synthetic import SyntheticWorld, corkscrew_trajectory
    from dliom_tpu_torch.sensor.types import pad_point_cloud

    world = SyntheticWorld.create()
    rng = np.random.default_rng(0)
    base = []
    for _, pose in corkscrew_trajectory()[:10]:
        pts, times = world.cast_scan(pose)
        cloud = pad_point_cloud(pts, times, CAPACITY)
        accs = np.tile(np.array([0, 0, G], np.float32), (IMU_CAP, 1))
        accs += rng.normal(0, 0.01, accs.shape).astype(np.float32)
        gyrs = rng.normal(0, 0.002, (IMU_CAP, 3)).astype(np.float32)
        base.append((cloud, accs, gyrs))

    def scan(i):
        cloud, accs, gyrs = base[i % len(base)]
        host = dict(points=cloud.points, times=cloud.times, mask=cloud.mask,
                    imu_dts=np.full(IMU_CAP, 0.0025, np.float32), imu_acc=accs, imu_gyr=gyrs,
                    imu_mask=np.arange(IMU_CAP) < 40)
        return LioScanInput(time=torch.tensor(0.6 * (i + 1), dtype=torch.float32, device=device),
                            **{k: torch.from_numpy(v).to(device) for k, v in host.items()})
    return scan


def fresh_state(cfg, device):
    from dliom_tpu_torch.frontend.lio import make_lio_state
    from dliom_tpu_torch.imu.preintegration import NavState

    zero = torch.zeros(3, device=device)
    return make_lio_state(cfg, NavState.identity(device), zero, zero)


def profile_slice(cfg, state, inputs):
    """Phase 6, where the time goes: torch.profiler over a few more scans.
    Per span of lio_step (record_function): host time, kernel time on the
    card and kernel count per scan, and the card's idle share of the wall
    time. The profiler's own overhead inflates the host times."""
    from torch.profiler import ProfilerActivity, profile

    from dliom_tpu_torch.frontend.lio import run_lio_chunk

    n = len(inputs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_lio_chunk(state, inputs, cfg)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    events = prof.events()

    def kernels(ev):
        return list(ev.kernels) + [k for c in ev.cpu_children for k in kernels(c)]

    busy = sum(k.duration for ev in events for k in ev.kernels) / 1e3 / n
    count = sum(len(ev.kernels) for ev in events) / n
    print(f"profile: {n} scans, {wall:.1f} ms/scan wall under the profiler, kernels "
          f"{busy:.2f} ms/scan ({count:.0f} launches), card idle share {1 - busy / wall:.3f}")
    for name in SPANS:
        spans = [ev for ev in events if ev.name == name]
        check(spans, f"profiler saw span {name}")
        ks = [k for ev in spans for k in kernels(ev)]
        host = sum(ev.cpu_time_total for ev in spans) / 1e3 / n
        print(f"profile: {name:20s} host {host:8.2f} ms/scan  kernels "
              f"{sum(k.duration for k in ks) / 1e3 / n:7.3f} ms/scan  "
              f"{len(ks) / n:8.0f} launches/scan")


def check_slice(ga, ac, dev):
    from dliom_tpu_torch.common.config import load_config
    from dliom_tpu_torch.frontend.lio import run_lio_chunk

    cfg = load_config("basic", BENCH_OVERRIDES).override(
        {"trajectory_builder": {"submaps": SPAWN_CAPACITIES}}).trajectory_builder
    scan = bench_scans(dev)
    inputs = [scan(i) for i in range(WARMUP + TIMED + PROFILED)]  # cast before timing
    torch.cuda.reset_peak_memory_stats()
    state, results = run_lio_chunk(fresh_state(cfg, dev), inputs[:WARMUP], cfg)
    torch.cuda.synchronize()
    ga.LAUNCHES = 0  # the timed run starts: zero the launch counts
    ac.LAUNCHES = 0
    t0 = time.perf_counter()
    state, timed = run_lio_chunk(state, inputs[WARMUP:WARMUP + TIMED], cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"grouped_apply": ga.LAUNCHES, "affine_chain": ac.LAUNCHES}
    results += timed
    scans_per_s = TIMED / wall
    inserted = sum(bool(r.scan.inserted) for r in timed)
    sm = state.frontend.submaps
    drops = {"brick": int(sm.high_brick.dropped[0]), "low_brick": int(sm.low_brick.dropped[0]),
             "dense": int(sm.dense_dropped[0])}
    print(f"slice: {TIMED} timed scans in {wall:.3f} s = {scans_per_s:.2f} scans/s; "
          f"{inserted} inserted; submaps created {int(sm.num_created)}; drops {drops}; "
          f"launches {launches}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    for k, r in enumerate(results):
        check(bool(torch.isfinite(r.scan.local_pose.translation).all()
                   and torch.isfinite(r.scan.local_pose.rotation).all()), f"scan {k} pose finite")
        check(not bool(r.failed), f"scan {k} failed")
    check(int(state.failures) == 0, "no failure resets")
    check(not any(drops.values()), f"no dropped grid updates {drops}")
    check(int(sm.num_created) >= 2, "crossed a submap spawn")
    check(launches["grouped_apply"] >= 2 * inserted and launches["grouped_apply"] > 0,
          "K1 launched for both brick banks on every inserted scan")
    check(launches["affine_chain"] >= TIMED, "K2 launched on every scan")

    profile_slice(cfg, state, inputs[WARMUP + TIMED:])

    # the first scans against the port's CPU run, where K1/K2 run plain
    cpu, cpu_scan = torch.device("cpu"), bench_scans(torch.device("cpu"))
    _, cpu_results = run_lio_chunk(fresh_state(cfg, cpu), [cpu_scan(i) for i in range(COMPARE)], cfg)
    worst = 0.0
    for k in range(COMPARE):
        g, c = results[k].scan.local_pose, cpu_results[k].scan.local_pose
        d = max(float((g.translation.cpu() - c.translation).abs().max()),
                float((g.rotation.cpu() - c.rotation).abs().max()))
        worst = max(worst, d)
        check(d <= POSE_ATOL, f"scan {k}: CUDA vs CPU pose differ by {d:.3e} > {POSE_ATOL}")
        check(bool(results[k].scan.inserted) == bool(cpu_results[k].scan.inserted), f"scan {k} inserted")
    print(f"slice: first {COMPARE} scans CUDA vs CPU: largest pose difference {worst:.3e} "
          f"(tolerance {POSE_ATOL})")
    return launches, scans_per_s


def main():
    card = environment()
    import dliom_tpu_torch  # noqa: F401  (pins f32, TF32 off)
    from dliom_tpu_torch import kernels
    from dliom_tpu_torch.common.device import get_device
    from dliom_tpu_torch.imu import affine_chain as ac
    from dliom_tpu_torch.ops import grouped_apply as ga

    t0 = time.perf_counter()
    path = kernels.build()
    kernels.library()
    print(f"build: {path.name} in {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(0)
    k1 = check_grouped_apply(ga, rng)
    k2 = check_affine_chain(ac, rng)
    launches, scans_per_s = check_slice(ga, ac, get_device("cuda"))
    check("jax" not in sys.modules, "no jax imported")

    print(json.dumps({"card": card, "slice_scans_per_s": scans_per_s,
                      "grouped_apply_by_shape": {t: {"max_abs_err": v[0], "ms": v[1], "plain_ms": v[2]}
                                                 for t, v in k1.items()}}))
    print(json.dumps({"kernels": [
        {"name": "grouped_apply", "route": "cuda", "source": "dliom_tpu_torch/csrc/grouped_apply.cu",
         "replaces": "dliom_tpu/ops/pallas_apply.py:257", "launches": launches["grouped_apply"],
         "max_abs_err": max(v[0] for v in k1.values()),
         "ms": k1["high_spawn"][1], "plain_ms": k1["high_spawn"][2]},
        {"name": "affine_chain", "route": "cuda", "source": "dliom_tpu_torch/csrc/affine_chain.cu",
         "replaces": "dliom_tpu/imu/preintegration.py:102", "launches": launches["affine_chain"],
         "max_abs_err": k2[0], "ms": k2[1], "plain_ms": k2[2]},
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
