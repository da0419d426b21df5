#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (dliom_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failed check raises and the exit code is non-zero:

  1. environment: torch and CUDA versions, the card's name and power limit;
  2. build: compile the CUDA kernels of dliom_tpu_torch/csrc with nvcc;
  3. K1 (grouped grid-update apply) against its plain PyTorch version at
     the bench config's two brick shapes, bit for bit, and both timed;
  4. K2 (IMU affine chain) against its plain version, rtol 1e-5 / atol
     1e-6, at M = 32 (the dynamic initializer's padded segment), 48 (the
     bench config), 64 (the default) and 200 (longer than one warp's ring
     of samples), both timed;
  5. the slice: `lio_step` at the bench config (bench.py's
     build_config values, 32768 raw points and 48 IMU samples per scan,
     the synthetic corkscrew with bench.py's IMU recipe), 2 warm-up scans
     then timed scans across a submap spawn; finite poses, no failure, no
     dropped grid updates, kernel launch counts from the timed run, and
     the first 3 scans against the port's own CPU run (plain versions);
  6. where the time goes: torch.profiler over 3 more scans after a
     warm-up cycle of 3, per span of lio_step (host time, kernel time,
     launches) and the card's idle share;
  7. K1's dense-bank entry (`apply_grouped_updates`) against its plain
     version at bench_e2e's dense shapes (the 2 x 128^3 high bank and the
     2 x 64^3 low bank, each plus the padding group; 256 steps, 49152
     records), bit for bit, `dropped` included, the padding group
     unchanged: all steps used, steps parked on the padding group (the
     low bank parks most of its steps on every insert), a
     capacity-overflow case and the table kernel's edge cases (all keys
     sentinel, one group, exactly and one past the capacity, the last real
     group beside the padding group, one group of more than 1024 records);
     both timed, and the device kernels of one call counted with
     torch.profiler (at most 2: the table kernel and K1);
  8. the mapping slice: `MapBuilder` on bench.py's bench_e2e course at
     bench_e2e's config (dense 0.2 m / 0.8 m grids, extents 128 / 64,
     dense_apply_groups 256, 2 background threads, pipeline_depth 1):
     static start, a warm-up lap and a bit (the revisit closes loops), a
     timed stretch, a short profiled window (the card's activity: busy
     time, idle share, the costliest kernels) after a warm-up cycle of the
     same length, `finish_trajectory()`. Checks:
     initialized, finite poses, no failure reset, zero dropped groups, at
     least one INTER constraint, the final optimization ran, K1's dense
     entry launched twice and K2 once per stepped scan; in a window of
     steps after the motion starts that runs across a submap finish, every
     dense K1 call of the main path against its plain version on a CPU
     copy of the same bank and keys, bit for bit; and each of the first 10
     steps, the window's first two and the steps either side of the
     finish, re-run on the CPU (plain versions) from the card's pre-step
     state and input, within 2e-3 of the card's local pose;
  9. the shipped presets' own paths through `MapBuilder`, at their
     published sizes: (a) `campus` as shipped (dense 0.2 m / 0.45 m grids
     of 512^3 / 256^3 cells, per-record insertion, NDT dynamic
     initialization, the gravity factor) on a course that moves from the
     first scan with a time-varying acceleration: initialization in motion
     (up within 0.99, velocity within 0.4 m/s of the truth, the result
     re-run on the CPU from the same buffered inputs within INIT_ATOL),
     then CAMPUS_STEPS stepped scans (finite, no failure reset, no drops,
     the gravity factor valid), K2 launched exactly once per initializer
     segment and once per stepped scan, the first CAMPUS_COMPARE steps
     re-run on the CPU from the card's pre-step state within 2e-3; (b)
     `viral` as shipped but for num_range_data (high 0.1 m brick grid on
     the per-record insert, `brick_apply_groups` 0) on phase 8's course:
     every high-grid brick insert and slot reset from the first step to
     the first insert with records after the first slot recycle held bit
     for bit against the same call on a CPU copy (directory, pool, counts,
     group_of_slot, dropped, epochs), K2 once per stepped scan; (c)
     `campus` with the online correlative matcher for RTC_STEPS scans:
     each pre-search's best candidate and score on the card against the
     same call on the CPU. The overrides the course forces are printed as `reduced`;
 10. save, resume and reload a map on the card (dliom_tpu_torch/io/): (a) a
     live checkpoint at bench_e2e's config (phase 8's dense grids and
     course, with the truth fed as odometry and fixed-frame positions,
     pipeline_depth 1, no pool threads): builder A runs until its first
     submap has finished and CKPT_AFTER_FINISH scans more, `save_checkpoint`,
     `map_builder_from_checkpoint` into builder B on the card; every tensor
     of B's LioState equals A's bit for bit, the pose graphs are equal
     (poses, compressed grids, node data, constraints, fixed-frame and
     odometry observations, exactly) and so are the trajectory buffers;
     then A and B take the same next CKPT_NEXT scans: B launches K1's dense
     entry twice and K2 once per stepped scan, the counts of nodes, submaps
     and constraints agree, every node and submap histogram is
     bit-identical (the sums are deterministic, ops/segment.py), and so are
     the graphs (or poses within 2e-3, which is reported);
     the checkpoint's bytes and the save and restore times are printed.
     (b) `write_pbstream` of A's graph loaded back on the card with
     `map_builder_from_state(pure_localization=True)`: the same counts,
     every finished submap's grids decompress identically, poses within
     1e-5, the loaded trajectories FROZEN; `write_range_data_pbstream`
     writes nodes + 1 messages. (c) tests/fixtures/reference_map.pbstream,
     written through the reference's own schema, loaded on the card and a
     live revisit from the wrong start (3, -2, 0) localized against it (an
     INTER constraint, the node within 0.4 m of the origin). (d)
     `runner.offline.run` over the synthetic corkscrew on the card with
     state, pbstream and CSV outputs: the JAX runner's report keys, ATE,
     K2 once per stepped scan, the state reloads;
 11. batched LIO on the card (dliom_tpu_torch/parallel/batch.py): (a) the
     bench config at B = 1, 2, 4, 8 sequences in lockstep, each lane on the
     corkscrew in its own world, K1's capacities SPAWN_CAPACITIES x B:
     BATCH_WARMUP steps, then BATCH_TIMED timed ones: finite poses, no
     failure reset, zero dropped groups, exactly 2 K1 and 1 K2 launches per
     batched step, device kernels per step (torch.profiler with the card's
     activity only, after a warm-up cycle, at B = 1 and 8) at B = 8 at most
     1.5 x those at B = 1; aggregate and per-sequence scans/s, K1 and K2
     launches per step and peak device memory per B beside phase 5's
     single-sequence rate (tools/torch_batch_scaling.py --profile prints
     the spans of a batched step). (b) B = 2 at num_range_data 2
     (printed as `reduced`), lane 1's first scan empty so the lanes spawn on
     different steps, across a slot recycle: on every step each lane's pose
     against `lio_step` from that lane's own pre-step state and input on
     the card (2e-3), and the flat 2B-slot insert against each lane's own
     2-slot insert of the same InsertionBatch on a copy of its banks,
     directory, pool, counts, group_of_slot, epochs and dropped bit for bit.
     (c) bench_e2e's dense grids at B = 4 across a spawn: K1's dense entry
     twice per batched step, each call bit-identical to its plain version
     on a CPU copy. Phase 3 adds K1 at 16 slots with 8 x the capacities and
     phase 4 K2 at B = 8, M = 48, the batched step's shapes.

Phase 8 compares step by step, not the free-running CPU trajectory: on
this course an input change of 1e-6 moves the CPU run's fifth local pose
by 1e-2 (PERF.md, Findings), so a free-running comparison would
measure that sensitivity, not the port. For the same reason the banks are
compared at K1's dense entry, from the card's own inputs: a CPU step
inserts at a pose that differs from the card's in the last bits.

Kernel times (phases 3, 4 and 7): `ms` is the host clock around one call
with a synchronize either side (median of REPEATS); `event_ms` is CUDA
events around EVENT_LAUNCHES back-to-back calls after a warm-up, per call
(the card waits on the host where the wrapper's dispatch is the slower);
`graph_ms` is the same calls captured in one CUDA graph and replayed, per
call: device time without host dispatch. `bound_ms` is the least time the
card could take for the work of those inputs: bytes (each input read once,
each output written once, counted from the data) over 3.35 TB/s, or
float32 operations over 67 TFLOP/s, whichever is larger.

Phase 8's timed stretch is TIMED_E2E scans, not bench.py's full lap: the
whole script must stay well inside its time limit (PERF.md says so).

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
EVENT_LAUNCHES = 200  # calls per CUDA-event timing (phases 3, 4, 7)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12  # float32 outside the tensor cores, the same
K2_LENGTHS = (32, 48, 64, 200)  # IMU samples per chain: initializer, bench config, default, long
PROFILED_CALLS = 20  # dense-entry calls under torch.profiler (phase 7)
PROFILED = 3  # scans under torch.profiler after the timed run (phase 6)
E2E_STATIC = 16  # bench.py: round(1.6 / scan_period) stationary scans
E2E_WARM = 235  # bench.py: round(1.12 * lap), lap = 2 pi 5 m / 1.5 m/s / 0.1 s
E2E_TIMED = 20  # bench.py times a full lap (209 scans); cut to fit the limit
E2E_PROFILED = 2  # scans under torch.profiler after the timed stretch
E2E_COMPARE = 10  # local poses compared with the port's CPU run
E2E_BANK_FROM = 100  # the bank window starts here (steps; the motion starts at step 8)
E2E_BANK_MAX = 60  # steps, enough for a submap finish (every ~32 steps here)
CAMPUS_V0 = 0.5  # m/s along x at the first scan: the course starts in motion
CAMPUS_STEPS = 40  # stepped scans after the dynamic initialization
CAMPUS_COMPARE = 5  # steps re-run on the CPU from the card's pre-step state
INIT_ATOL = 1e-2  # card vs CPU initializer result: six chained NDT solves
CAMPUS_PROFILED = 2  # stepped scans under torch.profiler, after a warm-up cycle as long
VIRAL_MOVING = 24  # moving scans after phase 8's E2E_STATIC static ones
VIRAL_RANGE_DATA = 3  # inserts per submap: the course makes ~14 inserts
RTC_STEPS = 5  # stepped scans with the online correlative pre-search
RTC_SCORE_ATOL = 1e-6
CKPT_RANGE_DATA = 8  # bench_e2e ships 16: at 16 phase 10 took 120.6 s on an H100 80GB HBM3, 700 W
CKPT_AFTER_FINISH = 3  # scans fed after the first submap finishes, then the checkpoint
CKPT_NEXT = 6  # scans fed to builders A and B after the checkpoint
PHASE10_AIM_S = 120.0
BATCHES = (1, 2, 4, 8)  # phase 11 (a): sequences per batched step
BATCH_WARMUP = 1  # phases 5-10 ran the single-lane step's kernels before
BATCH_TIMED = 4
BATCH_COUNTED = 1  # batched steps whose device kernels are counted, after a warm-up cycle as long
BATCH_LAUNCH_RATIO = 1.5  # device kernels per step at the largest B over B = 1, at most
LANE_OFFSET = np.array([0.25, -0.15, 0.05], np.float32)  # m: lane b's world is offset b times this
LANES_RANGE_DATA = 2  # phase 11 (b): bench.py ships 100; 2 spawns and recycles within LANES_STEPS
LANES_STEPS = 6  # lane 0 recycles a slot at step 4, lane 1 (first scan empty) at step 5
DENSE_LANES = 4  # phase 11 (c)
DENSE_LANES_RANGE_DATA = 2  # bench_e2e ships 16: a spawn at the third step
DENSE_LANES_STEPS = 3
PHASE11_AIM_S = 120.0
FIXTURE = "tests/fixtures/reference_map.pbstream"
FIXTURE_OVERRIDES = {  # tests/test_pose_graph.py::_cfg, the fixture's grid specs
    "trajectory_builder": {"submaps": {"high_resolution": 0.2, "low_resolution": 0.8,
                                       "high_resolution_extent": 128, "low_resolution_extent": 64}},
    "pose_graph": {
        "optimize_every_n_nodes": 0, "max_submaps": 16, "max_nodes": 128, "max_constraints": 512,
        "max_radius_enable_loop_detection": 10.0, "num_close_submaps_loop_with_initial_value": 5,
        "constraint_builder": {
            "min_score": 0.4, "every_nodes_to_find_constraint": 1,
            "fast_correlative_scan_matcher": {
                "branch_and_bound_depth": 6, "full_resolution_depth": 3,
                "min_low_resolution_score": 0.35, "linear_xy_search_window": 3.0,
                "linear_z_search_window": 1.5}}},
}
# the keys of the JAX package's runner report on a dataset with ground truth
# and these outputs (dliom_tpu/runner/offline.py:264-402)
RUNNER_REPORT_KEYS = ("map_frame", "tracking_frame", "num_scans", "num_matched", "num_nodes",
                      "num_submaps", "num_constraints", "num_loop_constraints", "wall_seconds",
                      "scans_per_sec", "scan_latency_ms", "phase_seconds", "trajectory_csv",
                      "pbstream_file", "state_file", "ate_rmse_m", "ate_rmse_aligned_m",
                      "pre_optimization_ate_rmse_m", "pre_optimization_ate_rmse_aligned_m")
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
# bench.py bench_e2e (the dense end-to-end config) with dense grouped apply
E2E_OVERRIDES = {
    "trajectory_builder": {
        "scan_period": 0.1,
        "frames_for_static_initialization": 8,
        "enable_ndt_initialization": False,
        "submaps": {"high_resolution": 0.2, "low_resolution": 0.8,
                    "high_resolution_extent": 128, "low_resolution_extent": 64,
                    "num_range_data": 16, "dense_apply_groups": 256},
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
        "constraint_builder": {"min_score": 0.45, "every_nodes_to_find_constraint": 2,
                               "max_nodes_per_search_dispatch": 4},
    },
    "map_builder": {"num_background_threads": 2},
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


def event_ms(fn, launches=EVENT_LAUNCHES):
    """Per call: CUDA events around `launches` back-to-back calls of fn()
    after a warm-up."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / launches


def graph_ms(fn, launches=EVENT_LAUNCHES):
    """Per call: `launches` calls of fn() captured in one CUDA graph, whose
    replay is timed with CUDA events (no host dispatch inside)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / launches


def bound(nbytes, flops=0.0):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    float32 operations over the peak rate."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def k1_bytes(starts, ends, keys, fresh, cpg):
    """Bytes K1 must move for these tables: 16 per step (rows, starts, ends,
    fresh), each record read once (4), and per step each distinct touched
    cell read and written (2 + 2), or its whole group written once (2 per
    cell) when the step is fresh."""
    s, e, k, f = (x.cpu().numpy() for x in (starts, ends, keys, fresh))
    total = 16 * len(s)
    for a, b, fr in zip(s, e, f):
        total += 4 * max(0, b - a)
        if fr:
            total += 2 * cpg
        elif b > a:
            total += 4 * len(np.unique((k[a:b] >> 1) & (cpg - 1)))
    return total


def k1_dense_bytes(keys, num_groups, cpg, cb):
    """Bytes K1's dense entry must move: every key read once (4), each
    distinct touched cell of the kept groups read and written (2 + 2),
    `dropped` written (4)."""
    k = keys.cpu().numpy()
    k = k[k != 2**31 - 1]
    kept = np.unique(k >> cb)[:num_groups]
    k = k[np.isin(k >> cb, kept)]
    return 4 * keys.numel() + 4 * len(np.unique(k >> 1)) + 4


def k2_work(batch, m):
    """(bytes, float32 operations) of the chain: F and Q read, A and P
    written; per sample three 15x15 products (2 x 15^3 each) and Q's add."""
    return 2 * batch * (m + 1) * 225 * 4, batch * m * (6 * 15 ** 3 + 225)


def device_events(events):
    """The device-side activities of a profile (kernels, copies, sets),
    without the projections of host spans onto the device timeline."""
    from torch.autograd import DeviceType

    host_names = {e.name for e in events if e.device_type == DeviceType.CPU}
    return [e for e in events if e.device_type == DeviceType.CUDA and e.name not in host_names
            and not getattr(e, "is_user_annotation", False)]


def timings(fn, plain):
    """The kernel's `ms`, `event_ms` and `graph_ms`, and the plain
    version's `plain_ms` (host clock, as `ms`)."""
    return {"ms": timed_median(fn), "event_ms": event_ms(fn), "graph_ms": graph_ms(fn),
            "plain_ms": timed_median(plain)}


def fmt_times(t):
    return (f"kernel {t['ms']:.4f} ms (events {t['event_ms']:.4f} ms, graph {t['graph_ms']:.4f} ms), "
            f"plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.6f} ms ({t['bound_by']})")


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
    bank = rng.integers(0, 32768, num_groups * cells_per_group, dtype=np.int16)
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
    for tag, cpg, groups, steps, real, records in (
            ("high", 16384, 2 * 2048, 512, 440, 49152),
            ("low", 4096, 2 * 1024, 192, 170, 49152),
            ("high_spawn", 16384, 2 * 2048, 1024, 900, 49152),
            ("low_spawn", 4096, 2 * 1024, 384, 260, 49152),
            # phase 11's batched step at B = 8: 16 slots, 8 x the capacities
            ("high_batch8", 16384, 16 * 2048, 8 * 1024, 8 * 900, 8 * 49152),
            ("low_batch8", 4096, 16 * 1024, 8 * 384, 8 * 260, 8 * 49152)):
        bank, rows, starts, ends, keys, fresh = grouped_apply_case(rng, cpg, groups, steps, records, real)
        kw = dict(cells_per_group=cpg, hit_odds=hit_odds, miss_odds=miss_odds, fresh=fresh)
        k = ga.apply_grouped_rows(bank.clone(), rows, starts, ends, keys, **kw)
        p = ga.apply_grouped_rows_plain(bank.clone(), rows, starts, ends, keys, **kw)
        torch.cuda.synchronize()
        err = int((k.int() - p.int()).abs().max())
        check(torch.equal(k, p), f"K1 {tag}: kernel bank differs from plain ({err})")
        check(not torch.equal(k, bank), f"K1 {tag}: nothing changed")
        work = bank.clone()
        t = timings(lambda: ga.apply_grouped_rows(work, rows, starts, ends, keys, **kw),
                    lambda: ga.apply_grouped_rows_plain(work, rows, starts, ends, keys, **kw))
        t["bound_ms"], t["bound_by"] = bound(k1_bytes(starts, ends, keys, fresh, cpg))
        print(f"K1 grouped_apply {tag}: cpg {cpg} steps {steps} records {int(ends[-1])}: "
              f"bit-identical; {fmt_times(t)}")
        out[tag] = dict(t, max_abs_err=err)
    return out


def check_affine_chain(ac, rng):
    out = {}
    for batch, m in [(1, m) for m in K2_LENGTHS] + [(max(BATCHES), IMU_CAP)]:
        shape = (m, 15, 15) if batch == 1 else (batch, m, 15, 15)
        f = torch.from_numpy((np.eye(15) + 0.01 * rng.normal(size=shape)).astype(np.float32)).cuda()
        q = rng.normal(size=shape).astype(np.float32) * 1e-3
        q = torch.from_numpy(q @ np.swapaxes(q, -1, -2)).cuda()
        a_k, p_k = ac.affine_chain(f, q)
        a_p, p_p = ac.affine_chain_plain(f, q)
        torch.cuda.synchronize()
        torch.testing.assert_close(a_k, a_p, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(p_k, p_p, rtol=1e-5, atol=1e-6)
        err = float(max((a_k - a_p).abs().max(), (p_k - p_p).abs().max()))
        t = timings(lambda: ac.affine_chain(f, q), lambda: ac.affine_chain_plain(f, q))
        t["bound_ms"], t["bound_by"] = bound(*k2_work(batch, m))
        print(f"K2 affine_chain B={batch} M={m}: max abs err {err:.3e} (rtol 1e-5, atol 1e-6); {fmt_times(t)}")
        out[m if batch == 1 else f"B{batch}_M{m}"] = dict(t, max_abs_err=err)
    return out


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


def lane_scans(device, batch, n, n_points=CAPACITY, imu_cap=IMU_CAP, empty_first=()):
    """n steps of B-stacked scans: lane b on bench_scans' ten corkscrew
    poses, cycled, cast in its own world (offset b * LANE_OFFSET), with
    bench.py's IMU recipe, stamped 0.6 s apart; the lanes in `empty_first`
    see no points on the first step."""
    from dliom_tpu_torch.frontend.lio import LioScanInput
    from dliom_tpu_torch.io.synthetic import SyntheticWorld, corkscrew_trajectory
    from dliom_tpu_torch.sensor.types import pad_point_cloud
    from dliom_tpu_torch.transform.rigid import Rigid3

    world = SyntheticWorld.create()
    poses = [p for _, p in corkscrew_trajectory()[:10]]
    clouds = {}
    rng = np.random.default_rng(0)
    valid = imu_cap * 5 // 6  # 40 of bench.py's 48
    out = []
    for i in range(n):
        lanes = []
        for b in range(batch):
            key = (b, i % len(poses))
            if key not in clouds:
                pose = poses[key[1]]
                clouds[key] = pad_point_cloud(*world.cast_scan(Rigid3(
                    pose.rotation, pose.translation + b * LANE_OFFSET)), n_points)
            cloud = clouds[key]
            accs = np.tile(np.array([0, 0, G], np.float32), (imu_cap, 1))
            accs += rng.normal(0, 0.01, accs.shape).astype(np.float32)
            lanes.append(dict(
                time=np.float32(0.6 * (i + 1)), points=np.asarray(cloud.points),
                times=np.asarray(cloud.times),
                mask=np.asarray(cloud.mask) & (i > 0 or b not in empty_first),
                imu_dts=np.full(imu_cap, 0.0025, np.float32), imu_acc=accs,
                imu_gyr=rng.normal(0, 0.002, (imu_cap, 3)).astype(np.float32),
                imu_mask=np.arange(imu_cap) < valid))
        out.append(LioScanInput(**{k: torch.from_numpy(np.stack([x[k] for x in lanes])).to(device)
                                   for k in LioScanInput._fields}))
    return out


def fresh_state(cfg, device):
    from dliom_tpu_torch.frontend.lio import make_lio_state
    from dliom_tpu_torch.imu.preintegration import NavState

    zero = torch.zeros(3, device=device)
    return make_lio_state(cfg, NavState.identity(device), zero, zero)


def warm_profile(cycles, host=True):
    """torch.profiler over the last of `cycles` (callables run in turn): the
    first is a warm-up cycle, whose events are dropped (a profile without
    one lost device events at its start, PERF.md Findings, PR 3). With
    `host=False` only the card's activity is recorded: no host ops or
    spans, and the events take seconds, not tens, to read. Returns (the
    profiler, host ms of the recorded cycle)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU] if host else []
    with profile(activities=activities + [ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=len(cycles) - 1, active=1, repeat=1)) as prof:
        for cycle in cycles:
            t0 = time.perf_counter()
            cycle()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            prof.step()
    return prof, wall


def profile_slice(cfg, state, inputs):
    """Phase 6, where the time goes: torch.profiler over a few more scans,
    after a warm-up cycle of as many. Per span of lio_step
    (record_function): host time, kernel time on the card and kernel count
    per scan, and the card's idle share of the wall time. The profiler's
    own overhead inflates the host times."""
    from dliom_tpu_torch.frontend.lio import run_lio_chunk

    n = len(inputs) // 2
    box = {"state": state}

    def cycle(chunk):
        def run():
            box["state"], _ = run_lio_chunk(box["state"], chunk, cfg)
        return run

    prof, wall = warm_profile([cycle(inputs[:n]), cycle(inputs[n:])])
    print_spans(prof.events(), n, wall / n, "profile")


def print_spans(events, n, wall, tag):
    """Per span of lio_step over `n` profiled scans of `wall` ms each: host
    time, kernel time on the card and kernel count per scan, and the
    card's idle share. Returns the idle share."""
    def kernels(ev):
        return list(ev.kernels) + [k for c in ev.cpu_children for k in kernels(c)]

    busy = sum(k.duration for ev in events for k in ev.kernels) / 1e3 / n
    count = sum(len(ev.kernels) for ev in events) / n
    print(f"{tag}: {n} scans, {wall:.1f} ms/scan wall under the profiler, kernels "
          f"{busy:.2f} ms/scan ({count:.0f} launches), card idle share {1 - busy / wall:.3f}")
    for name in SPANS:
        spans = [ev for ev in events if ev.name == name]
        check(spans, f"profiler saw span {name}")
        ks = [k for ev in spans for k in kernels(ev)]
        host = sum(ev.cpu_time_total for ev in spans) / 1e3 / n
        print(f"{tag}: {name:20s} host {host:8.2f} ms/scan  kernels "
              f"{sum(k.duration for k in ks) / 1e3 / n:7.3f} ms/scan  "
              f"{len(ks) / n:8.0f} launches/scan")
    return 1 - busy / wall


def check_slice(ga, ac, dev):
    from dliom_tpu_torch.common.config import load_config
    from dliom_tpu_torch.frontend.lio import run_lio_chunk

    cfg = load_config("basic", BENCH_OVERRIDES).override(
        {"trajectory_builder": {"submaps": SPAWN_CAPACITIES}}).trajectory_builder
    scan = bench_scans(dev)
    inputs = [scan(i) for i in range(WARMUP + TIMED + 2 * PROFILED)]  # cast before timing
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


def dense_keys(ga, rng, groups, num_records, cpg, cells=None):
    """One insert's sorted packed keys over the bank groups `groups`, each
    touched at least once, with duplicate cells (4 apart, or only `cells`
    distinct ones), mixed hit/miss and 5% sentinel records."""
    group = np.asarray(groups, np.int32)[rng.integers(0, len(groups), num_records)]
    group[:len(groups)] = groups
    cell = rng.integers(0, cpg // 4, num_records) * 4 if cells is None else rng.integers(0, cells, num_records)
    valid = rng.random(num_records) < 0.95
    valid[:len(groups)] = True
    keys = ga.pack_keys(torch.from_numpy(group), torch.from_numpy(cell.astype(np.int32)),
                        torch.from_numpy(rng.integers(0, 2, num_records).astype(np.int32)),
                        torch.from_numpy(valid), cpg)
    return torch.sort(keys).values.cuda()


def check_dense_grouped_apply(ga, rng):
    """Phase 7: K1's dense entry at bench_e2e's dense banks, one insert's
    49152 records: the high bank (2 x 128^3 cells plus the padding group =
    257 groups of 16384) with all 256 steps used, with 100 groups touched
    (156 steps park on the padding group) and with 200 touched at capacity
    64 (136 dropped); the low bank (2 x 64^3 plus padding = 33 groups) at
    256 steps, where 224 steps park, as on every insert of phase 8; then the
    table kernel's edge cases on the high bank. Returns the timed cases and
    the device kernels of one call (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    cpg = ga.DENSE_CELLS_PER_GROUP
    cases = [  # tag, extent, capacity, touched groups, records, distinct cells, timed
        ("dense", 128, 256, range(256), 49152, None, True),
        ("dense_park", 128, 256, range(100), 49152, None, True),
        ("dense_overflow", 128, 64, range(200), 49152, None, True),
        ("dense_low", 64, 256, range(32), 49152, None, True),
        ("all_sentinel", 128, 256, [], 49152, None, False),
        ("one_group", 128, 256, [17], 49152, None, False),
        ("exact_capacity", 128, 64, range(0, 256, 4), 49152, None, False),
        ("capacity_plus_one", 128, 64, range(0, 260, 4), 49152, None, False),
        ("last_real_group", 128, 256, [3, 254, 255], 49152, None, False),
        ("duplicate_heavy", 128, 256, [9, 10], 3000, 12, False),
    ]
    out, kernels_per_call = {}, None
    for tag, extent, capacity, touched, records, cells, timed in cases:
        touched = list(touched)
        groups = 2 * extent ** 3 // cpg + 1
        kw = dict(cells_per_group=cpg, hit_odds=0.55 / 0.45, miss_odds=0.49 / 0.51,
                  dummy_group=groups - 1, num_groups=capacity)
        bank = torch.from_numpy(rng.integers(0, 32768, groups * cpg).astype(np.int16)).cuda()
        if touched:
            keys = dense_keys(ga, rng, touched, records, cpg, cells)
        else:
            keys = torch.full((records,), 2**31 - 1, dtype=torch.int32).cuda()
        k, kd = ga.apply_grouped_updates(bank.clone(), keys, **kw)
        p, pd = ga.apply_grouped_updates_plain(bank.clone(), keys, **kw)
        torch.cuda.synchronize()
        err = int((k.int() - p.int()).abs().max())
        check(torch.equal(k, p), f"K1 {tag}: kernel bank differs from plain ({err})")
        check(int(kd) == int(pd) == max(0, len(touched) - capacity),
              f"K1 {tag}: dropped {int(kd)} (kernel) vs {int(pd)} (plain)")
        check(torch.equal(k[-cpg:], bank[-cpg:]), f"K1 {tag}: padding group changed")
        check(torch.equal(k, bank) == (not touched), f"K1 {tag}: the bank changed where it should")
        line = (f"K1 apply_grouped_updates {tag}: {groups} groups, {capacity} steps, "
                f"{len(touched)} touched, {max(0, capacity - len(touched))} parked, dropped {int(kd)}: "
                f"bit-identical, padding group unchanged")
        if not timed:
            print(line)
            continue
        work = bank.clone()
        if kernels_per_call is None:
            # one warm-up cycle, then one recorded cycle: after phase 6's
            # profile, a profile without a warm-up lost the device events
            # at its start (it saw none of one call's two kernels)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         schedule=torch.profiler.schedule(wait=0, warmup=1, active=1,
                                                          repeat=1)) as prof:
                for _ in range(2):
                    for _ in range(PROFILED_CALLS):
                        ga.apply_grouped_updates(work, keys, **kw)
                    torch.cuda.synchronize()
                    prof.step()
            kernels_per_call = len(device_events(prof.events())) / PROFILED_CALLS
            line += f"; {kernels_per_call:g} device kernels per call"
        t = timings(lambda: ga.apply_grouped_updates(work, keys, **kw),
                    lambda: ga.apply_grouped_updates_plain(work, keys, **kw))
        t["bound_ms"], t["bound_by"] = bound(k1_dense_bytes(keys, capacity, cpg, ga.cell_bits(cpg)))
        print(f"{line}; {fmt_times(t)}")
        out[tag] = dict(t, max_abs_err=err)
    return out, kernels_per_call


def e2e_course(n_scans, poses=False):
    """bench.py's bench_e2e feed, made up front: per scan its IMU samples
    [(t, acc, gyr)], its stamp, points and point times, and with `poses`
    the true pose. The first E2E_STATIC scans stand still; then the 5 m
    circle at 1.5 m/s."""
    from dliom_tpu_torch.io.synthetic import ImuNoise, ImuSimulator, SyntheticWorld
    from dliom_tpu_torch.transform.rigid import Rigid3

    radius, speed, period = 5.0, 1.5, 0.1
    world = SyntheticWorld.create(num_beams=16, num_azimuths=600)
    sim = ImuSimulator(rate=100.0, noise=ImuNoise(acc_noise=0.02, gyr_noise=0.002,
                                                  gyr_bias0=(0.0, 0.0, 0.004)), gravity=G, seed=4)

    def circle_pose(tau):
        ang = speed / radius * tau
        p = np.array([radius * np.sin(ang), radius * (1.0 - np.cos(ang)), 0.0], np.float32)
        v = np.array([speed * np.cos(ang), speed * np.sin(ang), 0.0])
        q = np.array([np.cos(ang / 2), 0.0, 0.0, np.sin(ang / 2)], np.float32)
        return Rigid3(q, p), v

    course, t, tau = [], 0.0, 0.0
    prev_pose, prev_v = circle_pose(0.0)[0], np.zeros(3)
    for k in range(n_scans):
        if k < E2E_STATIC:
            pose, v = prev_pose, np.zeros(3)
        else:
            tau += period
            pose, v = circle_pose(tau)
        dts, accs, gyrs, mask = sim.between(prev_pose, pose, prev_v, v, period, 64)
        imu = []
        for i in range(int(mask.sum())):
            t += float(dts[i])
            imu.append((t, accs[i], gyrs[i]))
        pts, ptimes = world.cast_scan(pose)
        course.append((imu, t, pts, ptimes) + ((pose,) if poses else ()))
        prev_pose, prev_v = pose, v
    return course


def drive(builder, scans):
    for imu, t, pts, ptimes in scans:
        for ti, acc, gyr in imu:
            builder.add_imu_data(ti, acc, gyr)
        builder.add_range_data(t, pts, ptimes)


def card_busy_ms(events):
    """Union of the device-side intervals (ms) the profiler saw, over all
    streams (overlapping kernels of two streams count once), and the five
    device activities with the most time (name, ms, count). The profiler
    also projects each record_function span onto the device timeline; those
    annotations are left out, so only kernels, copies and sets count."""
    from collections import Counter

    device = device_events(events)
    ms, count = Counter(), Counter()
    for e in device:
        ms[e.name] += e.time_range.elapsed_us() / 1e3
        count[e.name] += 1
    top = [(name, t, count[name]) for name, t in ms.most_common(5)]
    busy, end = 0.0, -1.0
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in device):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3, top


def record_steps(pose_steps, bank_from, bank_max):
    """Make MapBuilder record what phase 8 holds against the CPU; returns
    the dict it fills. `lio_step` is wrapped to keep a CPU copy of the
    pre-step state and input (the banks are updated in place, so the copy
    comes first) of the steps in `pose_steps` and of every step of the bank
    window. The bank window starts at step `bank_from` and ends one step
    after the first step in it that finishes a submap (so it holds the next
    step's slot recycle), after at most `bank_max` steps. In it, every call
    of K1's dense entry is held against its plain version on a CPU copy of
    the same bank and keys at once, bit for bit, `dropped` included."""
    from torch.utils._pytree import tree_map

    from dliom_tpu_torch import map_builder
    from dliom_tpu_torch.ops import grouped_apply as ga

    rec = {"n": 0, "steps": {}, "calls": [], "finished": [], "end": bank_from + bank_max,
           "window": False, "gravity_valid": []}
    step, dense = map_builder.lio_step, ga.apply_grouped_updates

    def cpu(tree):
        return tree_map(lambda x: x.to("cpu", copy=True) if isinstance(x, torch.Tensor) else x, tree)

    def recording(state, inp, cfg):
        k = rec["n"]
        rec["window"] = bank_from <= k < rec["end"]
        if k in pose_steps or rec["window"]:
            rec["steps"][k] = cpu((state, inp))
        out = step(state, inp, cfg)
        rec["gravity_valid"].append(out[1].gravity_valid)
        if rec["window"] and int(out[1].scan.finished_submap) >= 0:
            rec["finished"].append(k)
            rec["end"] = min(rec["end"], k + 2)
        rec["n"] = k + 1
        return out

    def dense_recording(pool, keys, **kw):
        if not rec["window"]:
            return dense(pool, keys, **kw)
        cpg, before, keys_c = kw["cells_per_group"], pool.to("cpu", copy=True), keys.cpu()
        pool, dropped = dense(pool, keys, **kw)
        want, want_dropped = ga.apply_grouped_updates_plain(before.clone(), keys_c, **kw)
        got = pool.cpu()
        valid = keys_c != 2**31 - 1
        touched = int(torch.unique(keys_c[valid] >> ga.cell_bits(cpg)).numel())
        rec["calls"].append(dict(
            step=rec["n"], groups=got.numel() // cpg, touched=touched,
            parked=max(0, kw["num_groups"] - touched), records=int(valid.sum()),
            equal=torch.equal(got, want), padding=torch.equal(got[-cpg:], before[-cpg:]),
            changed=not torch.equal(got, before), dropped=(int(dropped), int(want_dropped))))
        return pool, dropped

    def restore():
        map_builder.lio_step, ga.apply_grouped_updates = step, dense

    map_builder.lio_step = recording
    ga.apply_grouped_updates = dense_recording
    rec["restore"] = restore
    return rec


def check_mapping(ga, ac, dev):
    """Phase 8: MapBuilder on the bench_e2e course, see the module docstring."""
    from dliom_tpu_torch.common.config import load_config
    from dliom_tpu_torch.map_builder import MapBuilder

    cfg = load_config("basic", E2E_OVERRIDES)
    n_warm = E2E_STATIC + E2E_WARM
    course = e2e_course(n_warm + E2E_TIMED + 2 * E2E_PROFILED)
    builder = MapBuilder(cfg, use_background_threads=True, pipeline_depth=1, device=dev)
    pg = builder.pose_graph
    rec = record_steps(set(range(E2E_COMPARE)), E2E_BANK_FROM, E2E_BANK_MAX)
    ga.LAUNCHES = 0  # the main path starts: zero the launch counts
    ga.DENSE_LAUNCHES = 0
    ac.LAUNCHES = 0
    t_all = time.perf_counter()
    drive(builder, course[:n_warm])
    builder.flush()
    pg.wait_for_all_computations()
    warm_s = time.perf_counter() - t_all
    print(f"mapping: warm-up {n_warm} scans in {warm_s:.1f} s; nodes {len(pg.nodes)} submaps "
          f"{len(pg.submaps)} INTER {pg.num_inter_constraints()}", flush=True)
    builder.local_slam_latency_seconds.clear()
    pg.constraint_search_seconds.clear()
    pg.phase_seconds.clear()
    t0 = time.perf_counter()
    drive(builder, course[n_warm:n_warm + E2E_TIMED])
    builder.flush()
    pg.wait_for_all_computations()
    torch.cuda.synchronize()
    timed_s = time.perf_counter() - t0
    lat = np.asarray(builder.local_slam_latency_seconds) * 1e3
    phases = dict(sorted(pg.phase_seconds.items()))
    search = np.asarray(pg.constraint_search_seconds)
    print(f"mapping: timed {E2E_TIMED} scans in {timed_s:.3f} s", flush=True)

    def cycle(scans):
        def run():
            drive(builder, scans)
            builder.flush()
            pg.wait_for_all_computations()
        return run

    a = n_warm + E2E_TIMED
    # the card's activity only: these figures read nothing else, and a
    # profile with host ops took ~70 s to read here
    prof, prof_wall = warm_profile([cycle(course[a:a + E2E_PROFILED]), cycle(course[a + E2E_PROFILED:])],
                                   host=False)
    busy, top = card_busy_ms(prof.events())

    spa_before = pg.phase_seconds.get("spa", 0.0)
    builder.finish_trajectory()
    torch.cuda.synchronize()
    final_spa_s = pg.phase_seconds.get("spa", 0.0) - spa_before
    total_s = time.perf_counter() - t_all
    launches = {"grouped_apply": ga.LAUNCHES, "grouped_apply_dense": ga.DENSE_LAUNCHES,
                "affine_chain": ac.LAUNCHES}
    rec["restore"]()

    results = builder.local_trajectory(0)
    stepped = len(results)
    inserted = sum(r["inserted"] for r in results)
    inter = pg.num_inter_constraints()
    drops = int(builder.trajectory(0)._lio.frontend.submaps.dense_dropped[0])
    print(f"mapping: {len(course)} scans ({E2E_STATIC} static, {E2E_WARM} warm-up, {E2E_TIMED} "
          f"timed, {E2E_PROFILED} + {E2E_PROFILED} profiled after a warm-up cycle) in {total_s:.1f} s "
          f"(warm-up {warm_s:.1f} s); "
          f"{stepped} stepped, {inserted} inserted")
    print(f"mapping: timed {E2E_TIMED} scans in {timed_s:.3f} s = {E2E_TIMED / timed_s:.3f} scans/s; "
          f"scan latency p50 {np.percentile(lat, 50):.1f} ms p99 {np.percentile(lat, 99):.1f} ms; "
          f"searches {len(search)} (p50 {np.percentile(search, 50) if len(search) else 0:.3f} s)")
    print(f"mapping: nodes {len(pg.nodes)} submaps {len(pg.submaps)} constraints "
          f"{len(pg.constraints)} INTER {inter}; final optimization {final_spa_s:.2f} s; "
          f"dense groups dropped {drops}; launches {launches}")
    print("mapping: phase_seconds over the timed stretch: "
          + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()))
    print(f"mapping: profiled {E2E_PROFILED} scans (card activity only): {prof_wall / E2E_PROFILED:.1f} ms/scan wall, "
          f"card busy {busy / E2E_PROFILED:.2f} ms/scan, idle share {1 - busy / prof_wall:.3f}; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    for name, ms, n in top:
        print(f"mapping: profiled card time {ms:9.2f} ms in {n:6d} x {name[:90]}")

    check(builder.initialized, "MapBuilder initialized")
    for k, r in enumerate(results):
        check(np.all(np.isfinite(r["local_pose"].translation))
              and np.all(np.isfinite(r["local_pose"].rotation)), f"local pose {k} finite")
        check(not r["failed"], f"scan {k}: FailureDetection reset")
    for k, (_, pose) in enumerate(builder.optimized_node_poses()):
        check(np.all(np.isfinite(pose.translation)) and np.all(np.isfinite(pose.rotation)),
              f"node {k} pose finite")
    check(drops == 0, f"no dropped dense groups ({drops})")
    check(inter >= 1, "at least one INTER constraint")
    check(final_spa_s > 0.0, "the final optimization ran")
    check(stepped == rec["n"] > 0, f"{stepped} results for {rec['n']} steps")
    # the insert runs masked where the motion filter skips: K1 dense on
    # both banks every step
    check(launches["grouped_apply_dense"] == 2 * stepped, "K1 dense entry twice per stepped scan")
    check(launches["affine_chain"] == stepped, "K2 once per stepped scan")

    # K1's dense entry on the main path, held against plain in the bank window
    calls = rec["calls"]
    check(rec["finished"], f"a submap finished in the bank window (steps {E2E_BANK_FROM}-"
          f"{rec['end'] - 1})")
    check(len(calls) == 2 * (rec["end"] - E2E_BANK_FROM), "recorded both dense banks of every "
          "step of the bank window")
    for c in calls:
        check(c["equal"] and c["padding"] and c["dropped"][0] == c["dropped"][1] == 0,
              f"K1 dense entry on the card against plain at step {c['step']}: {c}")
    inserting = [c for c in calls if c["records"]]
    check(inserting and all(c["changed"] for c in inserting), "the window's inserts wrote the banks")
    parks = {}
    for c in inserting:
        parks.setdefault(c["groups"], []).append(c["parked"])
    check(any(max(v) > 0 for v in parks.values()), "steps parked on the padding group")
    print(f"mapping: K1 dense entry on the main path, steps {E2E_BANK_FROM}-{rec['end'] - 1} "
          f"(submap finished at step {rec['finished'][0]}): {len(calls)} calls ({len(inserting)} "
          f"with records) bit-identical to plain on the CPU, dropped 0, padding group unchanged; "
          + "; ".join(f"{g}-group bank: {min(v)}-{max(v)} of 256 steps parked"
                      for g, v in sorted(parks.items())))

    # steps again on the CPU (K1, K2 plain), each from the card's pre-step
    # state and input: the first E2E_COMPARE, then the start of the bank
    # window and the steps either side of the submap finish
    from dliom_tpu_torch.frontend.lio import lio_step

    fin = rec["finished"][0]
    compared = sorted(set(range(E2E_COMPARE)) | {E2E_BANK_FROM, E2E_BANK_FROM + 1, fin, fin + 1})
    worst = 0.0
    for k in compared:
        state, inp = rec["steps"][k]
        _, res = lio_step(state, inp, cfg.trajectory_builder)
        g = results[k]["local_pose"]
        d = max(float(np.abs(g.translation - res.scan.local_pose.translation.numpy()).max()),
                float(np.abs(g.rotation - res.scan.local_pose.rotation.numpy()).max()))
        worst = max(worst, d)
        check(d <= POSE_ATOL, f"mapping step {k}: CUDA vs CPU pose differ by {d:.3e}")
        check(bool(res.scan.inserted) == results[k]["inserted"], f"mapping step {k} inserted")
        check((int(res.scan.finished_submap) >= 0) == (k == fin) or k < E2E_BANK_FROM,
              f"mapping step {k}: the CPU finishes a submap where the card does")
    print(f"mapping: steps {compared} re-run on the CPU from the card's state: largest "
          f"pose difference {worst:.3e} (tolerance {POSE_ATOL})")
    return launches, {"scans_per_s": E2E_TIMED / timed_s, "p50_ms": float(np.percentile(lat, 50)),
                      "p99_ms": float(np.percentile(lat, 99)), "inter": inter,
                      "nodes": len(pg.nodes), "submaps": len(pg.submaps),
                      "idle_share": 1 - busy / prof_wall, "phase_seconds": phases}


def campus_course(n_scans):
    """Phase 9's course for `campus`: bench.py's scan world (8000 returns
    per scan) and phase 8's IMU recipe at 100 Hz, a level body moving from
    the first scan (CAMPUS_V0 along x) under tests/test_dynamic_init.py's
    time-varying acceleration (1.4 cos 1.8t, 1.0 sin 1.8t), a scan every
    0.1 s. Per scan: its IMU samples [(t, acc, gyr)], its stamp, points,
    point times and the true velocity."""
    from dliom_tpu_torch.io.synthetic import ImuNoise, ImuSimulator, SyntheticWorld
    from dliom_tpu_torch.transform.rigid import Rigid3

    period = 0.1
    world = SyntheticWorld.create()
    sim = ImuSimulator(rate=100.0, noise=ImuNoise(acc_noise=0.02, gyr_noise=0.002,
                                                  gyr_bias0=(0.0, 0.0, 0.004)), gravity=G, seed=5)
    q = np.array([1.0, 0.0, 0.0, 0.0], np.float32)

    def velocity(tau):
        return np.array([CAMPUS_V0 + 1.4 * np.sin(1.8 * tau) / 1.8, (1.0 - np.cos(1.8 * tau)) / 1.8, 0.0])

    course, t, p = [], 0.0, np.zeros(3)
    for k in range(n_scans):
        v0, v1 = velocity(k * period), velocity((k + 1) * period)
        p1 = p + 0.5 * (v0 + v1) * period  # exact under the interval's constant acceleration
        dts, accs, gyrs, mask = sim.between(Rigid3(q, p.astype(np.float32)), Rigid3(q, p1.astype(np.float32)),
                                            v0, v1, period, 64)
        imu = []
        for i in range(int(mask.sum())):
            t += float(dts[i])
            imu.append((t, accs[i], gyrs[i]))
        pts, ptimes = world.cast_scan(Rigid3(q, p1.astype(np.float32)))
        course.append((imu, t, pts, ptimes, v1))
        p = p1
    return course


def drive_until(builder, course, steps):
    """Feed `course` scan by scan until `steps` scans were stepped (the
    builder runs unpipelined); returns the number of scans fed."""
    for k, (imu, t, pts, ptimes, _) in enumerate(course):
        for ti, acc, gyr in imu:
            builder.add_imu_data(ti, acc, gyr)
        builder.add_range_data(t, pts, ptimes)
        if len(builder.local_trajectory(0)) >= steps:
            return k + 1
    raise RuntimeError(f"check failed: the course ended before {steps} stepped scans")


def record_initializer(builder):
    """Wrap the builder's dynamic initializer: keep its calls (to replay
    them on the CPU), count its segments (each a K2 launch), time its scans
    and, with a synchronize either side, its preintegrations, NDT fields
    and NDT matches. Returns the dict it fills."""
    from dliom_tpu_torch.imu import dynamic_initializer as di

    init = builder.trajectory(0)._dyn_init
    rec = {"calls": [], "segments": 0, "scans": 0, "seconds": 0.0, "result": None,
           "parts": {"preintegrate": 0.0, "build_field": 0.0, "ndt_match": 0.0}}
    add_imu, add_scan, segment = init.add_imu, init.add_scan, init._segment_preint

    def timed(part, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            rec["parts"][part] += time.perf_counter() - t0
            return out
        return run

    build_field, match = di.build_field, di.ndt_match
    di.build_field, di.ndt_match = timed("build_field", build_field), timed("ndt_match", match)
    segment = timed("preintegrate", segment)

    def restore():
        di.build_field, di.ndt_match = build_field, match

    def imu(t, acc, gyr):
        rec["calls"].append(("imu", t, acc, gyr))
        return add_imu(t, acc, gyr)

    def scan(t, points):
        rec["calls"].append(("scan", t, points))
        t0 = time.perf_counter()
        out = add_scan(t, points)
        torch.cuda.synchronize()
        rec["seconds"] += time.perf_counter() - t0
        rec["scans"] += 1
        if out is not None:
            rec["result"] = out
        return out

    def counted_segment():
        rec["segments"] += 1
        return segment()

    init.add_imu, init.add_scan, init._segment_preint = imu, scan, counted_segment
    rec["restore"] = restore
    return rec


def check_campus(ac, dev):
    """Phase 9 (a): campus as shipped, initialized in motion, see the
    module docstring."""
    from dliom_tpu_torch.common.config import load_config
    from dliom_tpu_torch.frontend.lio import lio_step
    from dliom_tpu_torch.imu.dynamic_initializer import DynamicInitializer
    from dliom_tpu_torch.map_builder import MapBuilder
    from dliom_tpu_torch.transform.rigid import quat_rotate

    cfg = load_config("campus")
    tb = cfg.trajectory_builder
    check(tb.enable_ndt_initialization and tb.enable_gravity_factor
          and tb.submaps.dense_apply_groups == 0, "campus ships NDT init, gravity factor, per-record insert")
    course = campus_course(2 * (tb.frames_for_dynamic_initialization + 1) + CAMPUS_STEPS
                           + 2 * CAMPUS_PROFILED)
    builder = MapBuilder(cfg, device=dev)
    init = record_initializer(builder)
    rec = record_steps(set(range(CAMPUS_COMPARE)), 10**9, 0)
    ac.LAUNCHES = 0  # the main path starts: zero the launch counts
    t0 = time.perf_counter()
    fed = drive_until(builder, course, CAMPUS_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ac.LAUNCHES
    rec["restore"]()
    init["restore"]()
    results = builder.local_trajectory(0)[:]
    stepped = len(results)
    lat = np.asarray(builder.local_slam_latency_seconds[CAMPUS_COMPARE:]) * 1e3

    # where a campus step's time goes
    def cycle(scans):
        return lambda: drive(builder, [c[:4] for c in scans])

    prof, prof_wall = warm_profile([cycle(course[fed:fed + CAMPUS_PROFILED]),
                                    cycle(course[fed + CAMPUS_PROFILED:fed + 2 * CAMPUS_PROFILED])])
    idle = print_spans(prof.events(), CAMPUS_PROFILED, prof_wall / CAMPUS_PROFILED, "campus profile")

    res = init["result"]
    check(res is not None and builder.initialized, "campus: dynamic initialization triggered")
    init_scan = init["scans"] - 1
    up = float(quat_rotate(res.nav.rotation, torch.tensor([0.0, 0.0, 1.0], device=dev))[2])
    v_err = float(np.linalg.norm(res.nav.velocity.cpu().numpy() - course[init_scan][4]))
    print(f"campus: initialized in motion on scan {init_scan} after {init['segments']} segments, "
          f"initializer {init['seconds']:.3f} s over {init['scans']} scans ("
          + ", ".join(f"{k} {v:.3f} s" for k, v in init["parts"].items()) + f"); up.z {up:.5f}, velocity "
          f"{np.round(res.nav.velocity.cpu().numpy(), 3).tolist()} vs truth "
          f"{np.round(course[init_scan][4], 3).tolist()} (error {v_err:.3f} m/s)", flush=True)
    check(up > 0.99, f"campus: gravity-aligned after initialization (up.z {up:.4f})")
    check(v_err < 0.4, f"campus: initial velocity within 0.4 m/s of the truth ({v_err:.3f})")

    # the initializer again on the CPU (plain versions) from the same inputs
    cpu_init = DynamicInitializer(tb, "cpu")
    cpu_res = None
    for call in init["calls"]:
        out = cpu_init.add_imu(*call[1:]) if call[0] == "imu" else cpu_init.add_scan(*call[1:])
        cpu_res = out if out is not None else cpu_res
    check(cpu_res is not None, "campus: the CPU initializer triggers on the same inputs")
    init_diff = max(float((a.cpu() - b).abs().max()) for a, b in zip(res.nav, cpu_res.nav))
    print(f"campus: initializer CUDA vs CPU: largest nav difference {init_diff:.3e} (tolerance {INIT_ATOL})")
    check(init_diff <= INIT_ATOL, f"campus: initializer CUDA vs CPU differ by {init_diff:.3e}")

    submaps = builder.trajectory(0)._lio.frontend.submaps
    drops = int(submaps.dense_dropped[0])
    gravity = int(torch.stack(rec["gravity_valid"]).sum())
    for k, r in enumerate(results):
        pose = r["local_pose"]
        check(np.all(np.isfinite(pose.translation)) and np.all(np.isfinite(pose.rotation)),
              f"campus: local pose {k} finite")
        check(not r["failed"], f"campus: scan {k}: FailureDetection reset")
    check(drops == 0, f"campus: no dropped dense groups ({drops})")
    check(gravity > 0, "campus: the gravity factor was valid on some step")
    check(launches == init["segments"] + stepped,
          f"campus: K2 {launches} launches, not {init['segments']} segments + {stepped} steps")
    steps_s = wall - init["seconds"]
    print(f"campus: {fed} scans fed, {stepped} stepped, {int(sum(r['inserted'] for r in results))} inserted; "
          f"gravity factor valid on {gravity} steps; dense groups dropped {drops}; K2 launches {launches} "
          f"= {init['segments']} segments + {stepped} steps; {stepped / steps_s:.3f} scans/s over the "
          f"stepped scans ({steps_s:.2f} s, the first {CAMPUS_COMPARE} copied to the host); scan latency "
          f"p50 {np.percentile(lat, 50):.1f} ms p99 {np.percentile(lat, 99):.1f} ms (steps "
          f"{CAMPUS_COMPARE}-{stepped - 1}); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB", flush=True)

    worst = 0.0
    for k in range(CAMPUS_COMPARE):
        state, inp = rec["steps"][k]
        _, out = lio_step(state, inp, tb)
        g = results[k]["local_pose"]
        d = max(float(np.abs(g.translation - out.scan.local_pose.translation.numpy()).max()),
                float(np.abs(g.rotation - out.scan.local_pose.rotation.numpy()).max()))
        worst = max(worst, d)
        check(d <= POSE_ATOL, f"campus step {k}: CUDA vs CPU pose differ by {d:.3e}")
    print(f"campus: steps 0-{CAMPUS_COMPARE - 1} re-run on the CPU from the card's state: largest pose "
          f"difference {worst:.3e} (tolerance {POSE_ATOL})")
    return launches, {"scans_per_s": stepped / steps_s, "p50_ms": float(np.percentile(lat, 50)),
                      "p99_ms": float(np.percentile(lat, 99)), "idle_share": idle,
                      "init_seconds": init["seconds"], "init_parts": init["parts"],
                      "init_scan": init_scan, "init_velocity_error": v_err, "init_cuda_vs_cpu": init_diff}


def record_brick_calls(spec):
    """Hold every high-grid brick insert and slot reset of the main path
    against the same call on a CPU copy of its inputs, bit for bit, from
    now until the first insert with records after the second pending
    reset (the first that recycles a slot). Returns the dict it fills."""
    from torch.utils._pytree import tree_map

    from dliom_tpu_torch.mapping import submap

    rec = {"open": True, "inserts": [], "resets": []}
    insert, reset = submap._insert_brick_slots, submap.reset_slot

    def cpu(tree):
        return tree_map(lambda x: x.to("cpu", copy=True) if isinstance(x, torch.Tensor) else x, tree)

    def same(got, want):
        return all(torch.equal(getattr(got, f).cpu(), getattr(want, f)) for f in got._fields)

    def recording_insert(bank, origins, hits, masks, **kw):
        if not (rec["open"] and kw["spec"] == spec):
            return insert(bank, origins, hits, masks, **kw)
        before = cpu((bank, origins, hits, masks))
        out = insert(bank, origins, hits, masks, **kw)
        rec["inserts"].append(dict(equal=same(out, insert(*before, **kw)), records=int(masks.sum()),
                                   counts=out.counts.tolist()))
        if sum(r["pending"] for r in rec["resets"]) >= 2 and rec["inserts"][-1]["records"]:
            rec["open"] = False
        return out

    def recording_reset(bank, bspec, slot, pending=True):
        if not (rec["open"] and bspec == spec):
            return reset(bank, bspec, slot, pending)
        before = cpu((bank, slot, pending))
        out = reset(bank, bspec, slot, pending)
        rec["resets"].append(dict(equal=same(out, reset(before[0], bspec, *before[1:])),
                                  pending=bool(before[2]), slot=int(before[1])))
        return out

    submap._insert_brick_slots, submap.reset_slot = recording_insert, recording_reset

    def restore():
        submap._insert_brick_slots, submap.reset_slot = insert, reset

    rec["restore"] = restore
    return rec


def check_viral(ac, dev):
    """Phase 9 (b): viral's per-record brick insert, see the module
    docstring."""
    from dliom_tpu_torch.common.config import load_config
    from dliom_tpu_torch.map_builder import MapBuilder
    from dliom_tpu_torch.mapping.submap import brick_spec

    cfg = load_config("viral", {"trajectory_builder": {"submaps": {"num_range_data": VIRAL_RANGE_DATA}}})
    spec = brick_spec(cfg.trajectory_builder.submaps)
    check(spec.apply_groups == 0 and spec.resolution == 0.1, "viral ships a 0.1 m per-record brick grid")
    course = e2e_course(E2E_STATIC + VIRAL_MOVING)
    builder = MapBuilder(cfg, pipeline_depth=1, device=dev)
    rec = record_brick_calls(spec)
    ac.LAUNCHES = 0  # the main path starts: zero the launch counts
    window_scans, t0 = None, None
    for k, scan in enumerate(course):
        drive(builder, [scan])
        if window_scans is None and not rec["open"]:
            builder.flush()
            torch.cuda.synchronize()
            window_scans, t0 = k + 1, time.perf_counter()
            builder.local_slam_latency_seconds.clear()
    builder.flush()
    torch.cuda.synchronize()
    check(t0 is not None, "viral: a slot was recycled within the course")
    timed_s = time.perf_counter() - t0
    launches = ac.LAUNCHES
    rec["restore"]()

    results = builder.local_trajectory(0)
    stepped = len(results)
    sm = builder.trajectory(0)._lio.frontend.submaps
    drops = {"brick": int(sm.high_brick.dropped[0]), "dense": int(sm.dense_dropped[0])}
    for k, r in enumerate(results):
        pose = r["local_pose"]
        check(np.all(np.isfinite(pose.translation)) and np.all(np.isfinite(pose.rotation)),
              f"viral: local pose {k} finite")
        check(not r["failed"], f"viral: scan {k}: FailureDetection reset")
    check(not any(drops.values()), f"viral: no dropped grid updates {drops}")
    check(launches == stepped, f"viral: K2 {launches} launches for {stepped} stepped scans")
    inserts, resets = rec["inserts"], rec["resets"]
    differ = [c for c in inserts + resets if not c["equal"]]
    check(not differ, f"viral: brick calls on the card differ from the CPU: {differ}")
    pending = [c for c in resets if c["pending"]]
    check(len(pending) >= 2 and any(c["records"] for c in inserts),
          "viral: the window crossed a slot recycle")
    lat = np.asarray(builder.local_slam_latency_seconds) * 1e3
    timed = len(course) - window_scans
    print(f"viral: {len(course)} scans ({E2E_STATIC} static), {stepped} stepped, "
          f"{int(sum(r['inserted'] for r in results))} inserted; brick inserts of the first "
          f"{window_scans} scans ({len(inserts)} calls, "
          f"{sum(1 for c in inserts if c['records'])} with records) "
          f"and {len(resets)} slot resets ({len(pending)} pending, slots {[c['slot'] for c in pending]}) "
          f"bit-identical to the CPU; pool groups {inserts[-1]['counts']}; drops {drops}; K2 launches "
          f"{launches}; timed {timed} scans after the window in {timed_s:.3f} s = {timed / timed_s:.3f} "
          f"scans/s, scan latency p50 {np.percentile(lat, 50):.1f} ms p99 {np.percentile(lat, 99):.1f} ms",
          flush=True)
    return launches, {"scans_per_s": timed / timed_s, "p50_ms": float(np.percentile(lat, 50)),
                      "p99_ms": float(np.percentile(lat, 99)), "bit_identical_inserts": len(inserts),
                      "bit_identical_resets": len(resets)}


def check_correlative(ac, dev):
    """Phase 9 (c): campus with the online correlative matcher; each
    pre-search on the card against the same call on the CPU."""
    from dliom_tpu_torch.common.config import load_config
    from dliom_tpu_torch.map_builder import MapBuilder
    from dliom_tpu_torch.ops import real_time_correlative as rtc

    cfg = load_config("campus", {"trajectory_builder": {"use_online_correlative_scan_matching": True}})
    tb = cfg.trajectory_builder
    course = campus_course(2 * (tb.frames_for_dynamic_initialization + 1) + RTC_STEPS)
    builder = MapBuilder(cfg, device=dev)
    calls, match = [], rtc.match

    def recording(initial, points, mask, values, spec, **kw):
        t0 = time.perf_counter()
        out = match(initial, points, mask, values, spec, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        host = [x.cpu() for x in (initial.rotation, initial.translation, points, mask, values)]
        want = match(type(initial)(*host[:2]), *host[2:], spec, **dict(kw, base=kw["base"].cpu()))
        calls.append(dict(index=(int(out.index), int(want.index)), ms=ms,
                          score=(float(out.score), float(want.score))))
        return out

    rtc.match = recording
    ac.LAUNCHES = 0
    drive_until(builder, course, RTC_STEPS)
    launches = ac.LAUNCHES
    rtc.match = match
    check(len(calls) == RTC_STEPS, f"correlative: {len(calls)} pre-searches for {RTC_STEPS} steps")
    worst = max(abs(c["score"][0] - c["score"][1]) for c in calls)
    for k, c in enumerate(calls):
        check(c["index"][0] == c["index"][1],
              f"correlative scan {k}: best candidate {c['index']} (card, CPU)")
        check(abs(c["score"][0] - c["score"][1]) <= RTC_SCORE_ATOL,
              f"correlative scan {k}: scores {c['score']}")
    rc = tb.real_time_correlative_scan_matcher
    n_cand = len(rtc._lattice(tb.submaps.high_resolution, rc.linear_search_window,
                              rc.angular_search_window, tb.max_range, rc.max_angular_steps)[0])
    print(f"correlative: {RTC_STEPS} pre-searches over {n_cand} candidates x {tb.max_high_res_points} "
          f"points: "
          f"best candidates {[c['index'][0] for c in calls]} equal to the CPU's, largest score difference "
          f"{worst:.3e} (tolerance {RTC_SCORE_ATOL}); {np.median([c['ms'] for c in calls]):.1f} ms per "
          f"pre-search (median, host clock); K2 launches {launches}")
    return launches, {"candidates": n_cand, "score_diff": worst,
                      "ms": float(np.median([c["ms"] for c in calls]))}


def feed_with_sensors(builder, scans):
    """Phase 10's feed: phase 8's course with the truth as odometry at each
    scan stamp and as a fixed-frame (GPS) position 50 ms after it, so the
    odometry and fixed-frame buffers hold samples at every checkpoint."""
    for imu, t, pts, ptimes, pose in scans:
        for ti, acc, gyr in imu:
            builder.add_imu_data(ti, acc, gyr)
        builder.add_odometry_data(t, pose)
        builder.add_range_data(t, pts, ptimes)
        builder.add_fixed_frame_pose_data(t + 0.05, pose.translation)


def count_steps():
    """Count `lio_step` calls of MapBuilder; returns the dict it fills."""
    from dliom_tpu_torch import map_builder

    step, box = map_builder.lio_step, {"n": 0}

    def counting(state, inp, cfg):
        box["n"] += 1
        return step(state, inp, cfg)

    map_builder.lio_step = counting
    box["restore"] = lambda: setattr(map_builder, "lio_step", step)
    return box


def graph_differences(a, b, pose_atol=0.0, grids=True):
    """Where pose graph `b` differs from `a`: counts, ids, poses (beyond
    `pose_atol`), compressed grids (exact), node data (exact), constraints
    and the fixed-frame, landmark and odometry observations."""
    out = []

    def pose_diff(x, y):
        return max(float(np.abs(np.asarray(x.rotation) - np.asarray(y.rotation)).max()),
                   float(np.abs(np.asarray(x.translation) - np.asarray(y.translation)).max()))

    for name in ("submaps", "nodes", "constraints", "fixed_frame_observations", "landmark_observations",
                 "odometry_links"):
        if len(getattr(a, name)) != len(getattr(b, name)):
            out.append(f"{name}: {len(getattr(a, name))} vs {len(getattr(b, name))}")
    if out:
        return out
    for i, (x, y) in enumerate(zip(a.submaps, b.submaps)):
        if (x.finished, x.trajectory_id, x.index_in_trajectory, list(x.node_ids)) != \
                (y.finished, y.trajectory_id, y.index_in_trajectory, list(y.node_ids)):
            out.append(f"submap {i}: ids")
        if max(pose_diff(x.local_pose, y.local_pose), pose_diff(x.global_pose, y.global_pose)) > pose_atol:
            out.append(f"submap {i}: pose")
        if not np.array_equal(np.asarray(x.histogram), np.asarray(y.histogram)):
            out.append(f"submap {i}: histogram")
        if grids and (x.high is None) != (y.high is None):
            out.append(f"submap {i}: grids present")
        elif grids and x.high is not None:
            for gx, gy in ((x.high, y.high), (x.low, y.low)):
                if not all(torch.equal(u, v) for u, v in zip(gx, gy)):
                    out.append(f"submap {i}: grid")
    for i, (x, y) in enumerate(zip(a.nodes, b.nodes)):
        if (x.time, x.trajectory_id, tuple(x.submap_ids)) != (y.time, y.trajectory_id, tuple(y.submap_ids)):
            out.append(f"node {i}: ids")
        if max(pose_diff(x.local_pose, y.local_pose), pose_diff(x.global_pose, y.global_pose)) > pose_atol:
            out.append(f"node {i}: pose")
        for f in ("high_points", "high_mask", "low_points", "low_mask", "histogram", "gravity_alignment"):
            if not np.array_equal(np.asarray(getattr(x, f)), np.asarray(getattr(y, f))):
                out.append(f"node {i}: {f}")
    for i, (x, y) in enumerate(zip(a.constraints, b.constraints)):
        if (x.submap_id, x.node_id, x.tag, x.translation_weight, x.rotation_weight) != \
                (y.submap_id, y.node_id, y.tag, y.translation_weight, y.rotation_weight) \
                or pose_diff(x.relative, y.relative) > pose_atol:
            out.append(f"constraint {i}")
    for i, (x, y) in enumerate(zip(a.fixed_frame_observations, b.fixed_frame_observations)):
        if x[0] != y[0] or x[2] != y[2] or not np.array_equal(x[1], y[1]):
            out.append(f"fixed-frame observation {i}")
    for i, (x, y) in enumerate(zip(a.odometry_links, b.odometry_links)):
        if x[:2] != y[:2] or pose_diff(x[2], y[2]) > pose_atol:
            out.append(f"odometry link {i}")
    return out


def check_checkpoint(ga, ac, dev, tmp):
    """Phase 10 (a): a live checkpoint at bench_e2e's config, see the module
    docstring. Returns (builder A, config, launches, numbers)."""
    import os

    from dliom_tpu_torch.common.config import load_config
    from dliom_tpu_torch.io.serialization import state_leaves
    from dliom_tpu_torch.map_builder import MapBuilder, map_builder_from_checkpoint

    cfg = load_config("basic", E2E_OVERRIDES).override(
        {"trajectory_builder": {"submaps": {"num_range_data": CKPT_RANGE_DATA}}})
    course = e2e_course(E2E_STATIC + 8 * CKPT_RANGE_DATA, poses=True)
    a = MapBuilder(cfg, pipeline_depth=1, device=dev)
    pg = a.pose_graph
    steps = count_steps()
    ga.DENSE_LAUNCHES = 0  # the main path starts: zero the launch counts
    ac.LAUNCHES = 0
    t0 = time.perf_counter()
    fed, finished_at = 0, None
    for scan in course:
        feed_with_sensors(a, [scan])
        fed += 1
        if finished_at is None and any(s.finished for s in pg.submaps):
            finished_at = fed
        if finished_at is not None and fed == finished_at + CKPT_AFTER_FINISH:
            break
    a.flush()
    torch.cuda.synchronize()
    drive_s = time.perf_counter() - t0
    launches_a = {"grouped_apply_dense": ga.DENSE_LAUNCHES, "affine_chain": ac.LAUNCHES}
    steps_a = steps["n"]
    check(finished_at is not None, "phase 10: a submap finished on the course")
    check(launches_a["grouped_apply_dense"] == 2 * steps_a and launches_a["affine_chain"] == steps_a,
          f"phase 10: builder A launches {launches_a} for {steps_a} steps")
    t = a.trajectory(0)
    check(bool(t._ff_buffer) and len(t._odom_buffer) > 0 and pg.fixed_frame_observations
          and pg.odometry_links, "phase 10: fixed-frame and odometry buffers and observations non-empty")
    active = pg.submaps[-1]
    print(f"checkpoint: builder A fed {fed} scans ({steps_a} stepped) in {drive_s:.1f} s; first submap "
          f"finished on scan {finished_at}; submaps {len(pg.submaps)} (finished "
          f"{sum(s.finished for s in pg.submaps)}, the newest holds {len(active.node_ids)} of "
          f"{2 * CKPT_RANGE_DATA} nodes), nodes {len(pg.nodes)}", flush=True)

    path = os.path.join(tmp, "live.npz")
    t0 = time.perf_counter()
    a.save_checkpoint(path)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    b = map_builder_from_checkpoint(path, cfg, pipeline_depth=1, device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    size = os.path.getsize(path)
    la, lb = list(state_leaves(a.trajectory(0)._lio)), list(state_leaves(b.trajectory(0)._lio))
    check([p for p, _ in la] == [p for p, _ in lb], "phase 10: the same LioState fields")
    for (p, x), (_, y) in zip(la, lb):
        check(y.device == x.device and y.device.type == dev.type and y.dtype == x.dtype and torch.equal(x, y),
              f"phase 10: restored LioState field {p} equals A's on the card")
    diff = graph_differences(pg, b.pose_graph)
    check(not diff, f"phase 10: restored pose graph differs: {diff[:5]}")
    tb_ = b.trajectory(0)
    check(len(tb_._ff_buffer) == len(t._ff_buffer) and tb_._odom_buffer._times == t._odom_buffer._times
          and tb_._imu_times == t._imu_times and tb_._pg_submap_ids == t._pg_submap_ids,
          "phase 10: restored trajectory buffers")
    print(f"checkpoint: {size} bytes; save {save_s:.3f} s, restore {restore_s:.3f} s; {len(la)} LioState "
          f"tensors bit-identical on the card; pose graph ({len(pg.submaps)} submaps, {len(pg.nodes)} nodes, "
          f"{len(pg.constraints)} constraints, {len(pg.fixed_frame_observations)} fixed-frame, "
          f"{len(pg.odometry_links)} odometry) equal", flush=True)

    nxt = course[fed:fed + CKPT_NEXT]
    check(len(nxt) == CKPT_NEXT, "phase 10: the course has scans left after the checkpoint")
    feed_with_sensors(a, nxt)
    a.flush()
    steps["n"] = 0
    ga.DENSE_LAUNCHES = 0  # the resumed builder's main path: zero the launch counts
    ac.LAUNCHES = 0
    t0 = time.perf_counter()
    feed_with_sensors(b, nxt)
    b.flush()
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    launches_b = {"grouped_apply_dense": ga.DENSE_LAUNCHES, "affine_chain": ac.LAUNCHES}
    steps_b = steps["n"]
    steps["restore"]()
    check(steps_b == CKPT_NEXT, f"phase 10: B stepped {steps_b} of {CKPT_NEXT} scans")
    check(launches_b["grouped_apply_dense"] == 2 * steps_b and launches_b["affine_chain"] == steps_b,
          f"phase 10: builder B launches {launches_b} for {steps_b} steps")
    pb = b.pose_graph
    check((len(pb.nodes), len(pb.submaps), len(pb.constraints)) == (len(pg.nodes), len(pg.submaps),
                                                                     len(pg.constraints)),
          "phase 10: A and B hold as many nodes, submaps and constraints")
    differ = graph_differences(pg, pb)
    exact = not differ
    check(not [d for d in differ if "histogram" in d],
          f"phase 10: A's and B's node and submap histograms differ: {differ[:5]}")
    worst = 0.0
    for x, y in zip(pg.nodes, pb.nodes):
        for u, v in ((x.local_pose, y.local_pose), (x.global_pose, y.global_pose)):
            worst = max(worst, float(np.abs(u.translation - v.translation).max()),
                        float(np.abs(u.rotation - v.rotation).max()))
    check(exact or worst <= POSE_ATOL, f"phase 10: A and B poses differ by {worst:.3e} > {POSE_ATOL}")
    print(f"checkpoint: A and B fed the next {CKPT_NEXT} scans (B {resume_s:.2f} s): B launched K1 dense "
          f"{launches_b['grouped_apply_dense']} and K2 {launches_b['affine_chain']} for {steps_b} steps; "
          + ("graphs bit-identical" if exact else f"not bit-identical ({len(differ)} differences, the first "
                                                  f"{differ[:4]}); poses within {worst:.3e}"),
          flush=True)
    launches = {k: launches_a[k] + launches_b[k] for k in launches_a}
    return a, cfg, launches, {"bytes": size, "save_s": save_s, "restore_s": restore_s,
                              "bit_identical": exact, "pose_diff": worst, "scans_a": fed,
                              "steps_a": steps_a, "steps_b": steps_b}


def check_pbstream(a, cfg, dev, tmp):
    """Phase 10 (b): A's graph through a pbstream and back onto the card."""
    import os

    from dliom_tpu_torch.backend.compression import decompress
    from dliom_tpu_torch.io.pbstream import PbstreamReader, write_pbstream, write_range_data_pbstream
    from dliom_tpu_torch.map_builder import map_builder_from_state

    pg = a.pose_graph
    path, range_path = os.path.join(tmp, "map.pbstream"), os.path.join(tmp, "range.pbstream")
    t0 = time.perf_counter()
    write_pbstream(path, pg)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = map_builder_from_state(path, cfg, pure_localization=True, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    lpg = loaded.pose_graph
    check((len(lpg.nodes), len(lpg.submaps), len(lpg.constraints))
          == (len(pg.nodes), len(pg.submaps), len(pg.constraints)), "phase 10: pbstream counts")
    worst, grids = 0.0, 0
    hi, lo = pg._hi_spec, pg._lo_spec
    for x, y in zip(pg.submaps + pg.nodes, lpg.submaps + lpg.nodes):
        worst = max(worst, float(np.abs(x.global_pose.translation - y.global_pose.translation).max()),
                    float(np.abs(x.global_pose.rotation - y.global_pose.rotation).max()),
                    float(np.abs(x.local_pose.translation - y.local_pose.translation).max()))
    for x, y in zip(pg.submaps, lpg.submaps):
        if x.finished and x.high is not None:
            check(y.high is not None and y.high.indices.device.type == dev.type, "phase 10: grids on the card")
            check(torch.equal(decompress(x.high, hi), decompress(y.high, hi))
                  and torch.equal(decompress(x.low, lo), decompress(y.low, lo)),
                  "phase 10: a finished submap's grids decompress identically")
            grids += 1
    check(grids >= 1 and worst <= 1e-5, f"phase 10: {grids} grids, poses within {worst:.3e} (1e-5)")
    states = lpg.trajectory_states()
    check(all(states[s.trajectory_id] == "FROZEN" and s.frozen for s in lpg.submaps),
          "phase 10: the loaded trajectories are FROZEN")
    write_range_data_pbstream(range_path, pg)
    messages = sum(1 for _ in PbstreamReader(range_path))
    check(messages == len(pg.nodes) + 1, f"phase 10: {messages} range-data messages")
    print(f"pbstream: {os.path.getsize(path)} bytes written in {write_s:.3f} s, loaded frozen on the card "
          f"in {load_s:.3f} s; {grids} finished submaps' grids identical, poses within {worst:.3e}; "
          f"range data {messages} messages ({os.path.getsize(range_path)} bytes)", flush=True)
    return {"bytes": os.path.getsize(path), "write_s": write_s, "load_s": load_s, "pose_diff": worst}


def fixture_world_cloud(n=1200):
    """tools/make_reference_fixture.py's world (seed 1234): two walls and a
    floor, the cloud tests/fixtures/reference_map.pbstream was made from."""
    rng = np.random.default_rng(1234)
    wall_a = np.stack([np.full(n // 3, 8.0), rng.uniform(-6, 6, n // 3), rng.uniform(-2, 2, n // 3)], -1)
    wall_b = np.stack([rng.uniform(-6, 6, n // 3), np.full(n // 3, -7.0), rng.uniform(-2, 2, n // 3)], -1)
    m = n - 2 * (n // 3)
    floor = np.stack([rng.uniform(-6, 6, m), rng.uniform(-6, 6, m), np.full(m, -2.0)], -1)
    return np.concatenate([wall_a, wall_b, floor]).astype(np.float32)


def check_fixture(dev):
    """Phase 10 (c): localize a live revisit against the reference-schema
    fixture on the card (tests/test_pbstream.py:232-290)."""
    from dliom_tpu_torch.backend.pose_graph import NodeRecord
    from dliom_tpu_torch.common.config import load_config
    from dliom_tpu_torch.map_builder import map_builder_from_state
    from dliom_tpu_torch.mapping import probability as pv
    from dliom_tpu_torch.mapping.grid import cell_index, make_grid, set_cells
    from dliom_tpu_torch.mapping.submap import grid_specs
    from dliom_tpu_torch.ops.rotational_histogram import compute_histogram
    from dliom_tpu_torch.transform.rigid import Rigid3

    cfg = load_config("basic", FIXTURE_OVERRIDES)
    t0 = time.perf_counter()
    builder = map_builder_from_state(FIXTURE, cfg, pure_localization=True, device=dev)
    pg = builder.pose_graph
    frozen = pg.submaps[0].trajectory_id
    check(pg.submaps[0].frozen and pg.submaps[0].finished and pg.trajectory_states()[frozen] == "FROZEN"
          and int(pg.submaps[0].high.count) > 0, "phase 10: the fixture loads frozen with its grids")
    world = fixture_world_cloud()
    wrong = Rigid3(np.asarray([1.0, 0.0, 0.0, 0.0]), np.asarray([3.0, -2.0, 0.0]))
    s1 = pg.add_submap(wrong, trajectory_id=0)
    pts = torch.from_numpy(world).to(dev)
    mask = torch.ones(len(world), dtype=torch.bool, device=dev)
    node = NodeRecord(time=0.0, local_pose=wrong, gravity_alignment=np.asarray([1.0, 0, 0, 0], np.float32),
                      high_points=world, high_mask=np.ones(len(world), bool), low_points=world,
                      low_mask=np.ones(len(world), bool),
                      histogram=compute_histogram(pts, mask, cfg.trajectory_builder.rotational_histogram_size)
                      .cpu().numpy(), submap_ids=(), trajectory_id=0)
    value = pv.probability_to_value(torch.tensor(0.9))
    grids = [set_cells(make_grid(spec, dev), cell_index(pts, spec.resolution), value, spec)
             for spec in grid_specs(cfg.trajectory_builder.submaps)]
    pg.add_node(node, (s1,), newly_finished_submap_id=s1, finished_grids=tuple(grids))
    inter = [c for c in pg.constraints if c.tag == "INTER"]
    check(inter and pg.trajectories_connected(frozen, 0), "phase 10: the revisit found an INTER constraint")
    pg.run_final_optimization()
    err = float(np.linalg.norm(pg.nodes[-1].global_pose.translation))
    origin = float(np.abs(pg.submaps[0].global_pose.translation).max())
    seconds = time.perf_counter() - t0
    check(err < 0.4 and origin <= 1e-6, f"phase 10: live node {err:.3f} m from the origin, fixture map "
          f"moved {origin:.2e}")
    print(f"fixture: {len(inter)} INTER constraint(s) (score {inter[0].score:.3f}); the live node from "
          f"(3, -2, 0) lands {err:.4f} m from the fixture's origin; {seconds:.2f} s", flush=True)
    return {"error_m": err, "seconds": seconds}


def check_runner(ac, dev, tmp):
    """Phase 10 (d): `runner.offline.run` over the synthetic corkscrew."""
    import os

    from dliom_tpu_torch.map_builder import map_builder_from_state
    from dliom_tpu_torch.runner import offline

    files = {k: os.path.join(tmp, v) for k, v in (("csv", "traj.csv"), ("state", "state.npz"),
                                                  ("pbstream", "runner.pbstream"))}
    args = offline.build_parser().parse_args(
        ["--dataset", "synthetic", "--device", dev.type, "--output-csv", files["csv"],
         "--output-state", files["state"], "--output-pbstream", files["pbstream"]])
    steps = count_steps()
    ac.LAUNCHES = 0  # the runner's main path: zero the launch count
    report = offline.run(args)
    launches = ac.LAUNCHES
    steps["restore"]()
    missing = [k for k in RUNNER_REPORT_KEYS if k not in report]
    check(not missing, f"phase 10: runner report lacks {missing}")
    check(report["num_nodes"] > 0 and all(os.path.getsize(f) > 0 for f in files.values()),
          "phase 10: runner nodes and files")
    check(launches == steps["n"] > 0, f"phase 10: runner K2 {launches} launches for {steps['n']} steps")
    reloaded = map_builder_from_state(files["state"], offline.run_config(args), device=dev)
    check(len(reloaded.pose_graph.nodes) == report["num_nodes"], "phase 10: the runner's state reloads")
    print(f"runner: {report['num_scans']} scans, {steps['n']} stepped, {report['num_nodes']} nodes, "
          f"{report['num_submaps']} submaps in {report['wall_seconds']} s = {report['scans_per_sec']} "
          f"scans/s; ATE {report['ate_rmse_m']} m (aligned {report['ate_rmse_aligned_m']} m, before the "
          f"final optimization {report['pre_optimization_ate_rmse_m']} m); K2 {launches} launches; the "
          "state reloads", flush=True)
    return launches, {k: report[k] for k in ("num_scans", "num_nodes", "scans_per_sec", "wall_seconds",
                                             "ate_rmse_m", "ate_rmse_aligned_m")} | {"steps": steps["n"]}


def check_io(ga, ac, dev):
    """Phase 10: save, resume and reload a map on the card."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        a, cfg, launches, ckpt = check_checkpoint(ga, ac, dev, tmp)
        pbstream = check_pbstream(a, cfg, dev, tmp)
        fixture = check_fixture(dev)
        runner_k2, runner = check_runner(ac, dev, tmp)
    return launches, runner_k2, {"checkpoint": ckpt, "pbstream": pbstream, "fixture": fixture,
                                 "runner": runner}


def batched_config(overrides, lanes, capacities, **submaps):
    """The engine config at `lanes` sequences: K1's per-call `capacities`
    times the lanes (one call holds every lane's groups)."""
    from dliom_tpu_torch.common.config import load_config

    caps = {k: lanes * v for k, v in capacities.items()}
    return load_config("basic", overrides).override({"trajectory_builder": {"submaps": {**caps, **submaps}}})


def batched_scaling(ga, ac, dev, single_rate):
    """Phase 11 (a): the bench config at B = BATCHES, each lane on its own
    world. Per B: BATCH_WARMUP steps, then BATCH_TIMED timed steps (K1 and
    K2 counted); at the smallest and largest B, device kernels and their
    time per step from torch.profiler (the card's activity only) after a
    warm-up cycle (tools/torch_batch_scaling.py --profile prints the spans
    at every B). Returns (rows, K1 launches, K2 launches)."""
    from dliom_tpu_torch.parallel.batch import make_batched_lio_state, make_batched_lio_step

    import gc

    rows, k1, k2 = {}, 0, 0
    all_lanes = lane_scans(dev, max(BATCHES), 10)
    for b in BATCHES:
        t_b = time.perf_counter()
        cfg = batched_config(BENCH_OVERRIDES, b, SPAWN_CAPACITIES).trajectory_builder
        scans = [type(s)(*(x[:b] for x in s)) for s in all_lanes]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        box = {"state": make_batched_lio_state(cfg, b, dev), "i": 0, "results": []}
        step = make_batched_lio_step(cfg, b)

        def run(n):
            for _ in range(n):
                box["state"], res = step(box["state"], scans[box["i"] % len(scans)])
                box["results"].append(res)
                box["i"] += 1

        run(BATCH_WARMUP)
        torch.cuda.synchronize()
        ga.LAUNCHES = 0  # the batched main path starts: zero the launch counts
        ac.LAUNCHES = 0
        t0 = time.perf_counter()
        run(BATCH_TIMED)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"grouped_apply": ga.LAUNCHES, "affine_chain": ac.LAUNCHES}
        k1, k2 = k1 + ga.LAUNCHES, k2 + ac.LAUNCHES
        check(launches == {"grouped_apply": 2 * BATCH_TIMED, "affine_chain": BATCH_TIMED},
              f"phase 11: B={b} launches {launches} for {BATCH_TIMED} steps (2 K1, 1 K2 per step)")
        peak = (torch.cuda.max_memory_allocated() - held) / 2**20
        t_prof = time.perf_counter()
        per_step = idle = None
        if b in (BATCHES[0], BATCHES[-1]):
            prof, prof_wall = warm_profile([lambda: run(BATCH_COUNTED), lambda: run(BATCH_COUNTED)],
                                           host=False)
            events = prof.events()
            busy, _ = card_busy_ms(events)
            per_step = len(device_events(events)) / BATCH_COUNTED
            check(per_step > 0, f"phase 11: B={b}: the profiler saw no device kernels")
            idle = 1 - busy / prof_wall
            del prof, events
        state = box["state"]
        sm = state.frontend.submaps
        drops = {"brick": int(sm.high_brick.dropped.sum()), "low_brick": int(sm.low_brick.dropped.sum()),
                 "dense": int(sm.dense_dropped.sum())}
        for k, r in enumerate(box["results"]):
            pose = r.scan.local_pose
            check(bool(torch.isfinite(pose.translation).all() and torch.isfinite(pose.rotation).all()),
                  f"phase 11: B={b} step {k} poses finite")
            check(not bool(r.failed.any()), f"phase 11: B={b} step {k} failed")
        check(int(state.failures.sum()) == 0, f"phase 11: B={b} no failure resets")
        check(not any(drops.values()), f"phase 11: B={b} dropped grid updates {drops}")
        rows[b] = {"aggregate_scans_per_s": b * BATCH_TIMED / wall, "per_seq_scans_per_s": BATCH_TIMED / wall,
                   "device_kernels_per_step": per_step, "idle_share": idle, "peak_mem_mib": peak}
        r = rows[b]
        profiled = (f"{per_step:.0f} device kernels per step, card idle {idle:.3f}" if per_step is not None
                    else "kernels not counted")
        print(f"batched B={b}: {r['aggregate_scans_per_s']:.3f} scans/s aggregate, "
              f"{r['per_seq_scans_per_s']:.3f} per sequence (phase 5 single sequence {single_rate:.3f}); "
              f"{profiled}; K1 and K2 per step {launches['grouped_apply'] / BATCH_TIMED:.0f} and "
              f"{launches['affine_chain'] / BATCH_TIMED:.0f}; peak device memory {peak:.0f} MiB above the "
              f"{held / 2**20:.0f} MiB held before; drops {drops}; {time.perf_counter() - t_b:.1f} s "
              f"({time.perf_counter() - t_prof:.1f} s counting kernels)", flush=True)
        del box, state, sm, scans
    lo, hi = rows[BATCHES[0]]["device_kernels_per_step"], rows[BATCHES[-1]]["device_kernels_per_step"]
    check(hi <= BATCH_LAUNCH_RATIO * lo, f"phase 11: {hi:.0f} kernels per step at B={BATCHES[-1]} over "
          f"{BATCH_LAUNCH_RATIO} x {lo:.0f} at B={BATCHES[0]}")
    return rows, k1, k2


def batched_lanes(dev):
    """Phase 11 (b): B = 2 at the bench config (num_range_data cut so that
    spawns and a slot recycle happen; lane 1's first scan is empty, so the
    lanes spawn on different steps). On every step each lane's pose against
    `lio_step` from that lane's own pre-step state and input on the card,
    and the flat 2B-slot insert against each lane's own 2-slot insert of
    the same InsertionBatch on a copy of its banks, bit for bit."""
    from dliom_tpu_torch.frontend.lio import LioScanInput, lio_step
    from dliom_tpu_torch.mapping.brick_grid import BrickBank
    from dliom_tpu_torch.mapping.submap import InsertionBatch, write_insertion_batch
    from dliom_tpu_torch.parallel import batch as pb

    lanes = 2
    cfg = batched_config(BENCH_OVERRIDES, lanes, SPAWN_CAPACITIES,
                         num_range_data=LANES_RANGE_DATA).trajectory_builder
    state = pb.make_batched_lio_state(cfg, lanes, dev)
    worst, spawns, compared = 0.0, {b: [] for b in range(lanes)}, 0
    for k, inp in enumerate(lane_scans(dev, lanes, LANES_STEPS, empty_first=(1,))):
        pre = [pb.lane_state(cfg, state, b) for b in range(lanes)]
        state = pb.clear_spawned_slots(cfg, state)
        state, res = pb.lio_lanes(state, inp, cfg)
        sm = state.frontend.submaps
        before = sm._replace(high_brick=BrickBank(*(x.clone() for x in sm.high_brick)),
                             low_brick=BrickBank(*(x.clone() for x in sm.low_brick)))
        sm = pb.write_flat_insertion(cfg, sm, res.scan.insertion_batch)
        state = state._replace(frontend=state.frontend._replace(submaps=sm))
        drops = {}
        for b in range(lanes):
            _, one = lio_step(pre[b], LioScanInput(*(x[b] for x in inp)), cfg)
            d = max(float((res.scan.local_pose.translation[b] - one.scan.local_pose.translation).abs().max()),
                    float((res.scan.local_pose.rotation[b] - one.scan.local_pose.rotation).abs().max()))
            worst = max(worst, d)
            check(d <= POSE_ATOL, f"phase 11: step {k} lane {b}: batched vs single pose {d:.3e} > {POSE_ATOL}")
            check(bool(res.scan.inserted[b]) == bool(one.scan.inserted), f"phase 11: step {k} lane {b} inserted")
            if int(res.scan.finished_submap[b]) >= 0:
                spawns[b].append(k)
            own = pb.lane_banks(cfg, before, b)
            out = write_insertion_batch(own["high_values"], own["low_values"], own["high_brick"],
                                        InsertionBatch(*(x[b] for x in res.scan.insertion_batch)),
                                        cfg.submaps, low_brick=own["low_brick"])
            flat = pb.lane_banks(cfg, sm, b)
            for name in ("high_brick", "low_brick"):
                for f in ("directory", "pool", "counts", "group_of_slot", "epochs"):
                    check(torch.equal(getattr(out[name], f), getattr(flat[name], f)),
                          f"phase 11: step {k} lane {b} {name}.{f}: flat insert vs the lane's own")
                drops[name] = drops.get(name, 0) + int(out[name].dropped.sum())
            compared += 1
        for name in ("high_brick", "low_brick"):
            got = int(getattr(sm, name).dropped.sum()) - int(getattr(before, name).dropped.sum())
            check(got == drops[name] == 0, f"phase 11: step {k} {name} dropped {got} vs lanes' {drops[name]}")
    created = state.frontend.submaps.num_created.tolist()
    check(all(spawns.values()) and spawns[0] != spawns[1] and min(created) >= 3,
          f"phase 11: lanes spawn on different steps {spawns} and recycle a slot ({created} created)")
    print(f"batched lanes: B={lanes}, {LANES_STEPS} steps, spawns {spawns}, submaps created {created}: every "
          f"step's poses within {worst:.3e} of the lanes' own lio_step (tolerance {POSE_ATOL}); {compared} flat "
          "inserts bit-identical to the lanes' own", flush=True)
    return {"steps": LANES_STEPS, "spawns": spawns, "pose_diff": worst, "inserts_compared": compared}


def batched_dense(ga, dev):
    """Phase 11 (c): bench_e2e's dense grids at B = DENSE_LANES across a
    spawn; every call of K1's dense entry against its plain version on a
    CPU copy of the same bank and keys, bit for bit, `dropped` included."""
    from dliom_tpu_torch.parallel.batch import make_batched_lio_state, make_batched_lio_step

    cfg = batched_config(E2E_OVERRIDES, DENSE_LANES,
                         {"dense_apply_groups": E2E_OVERRIDES["trajectory_builder"]["submaps"]["dense_apply_groups"]},
                         num_range_data=DENSE_LANES_RANGE_DATA).trajectory_builder
    dense, calls = ga.apply_grouped_updates, []

    def held(pool, keys, **kw):
        before, keys_c = pool.to("cpu", copy=True), keys.cpu()
        pool, dropped = dense(pool, keys, **kw)
        want, want_dropped = ga.apply_grouped_updates_plain(before, keys_c, **kw)
        calls.append((torch.equal(pool.cpu(), want), int(dropped), int(want_dropped)))
        return pool, dropped

    state = make_batched_lio_state(cfg, DENSE_LANES, dev)
    step = make_batched_lio_step(cfg, DENSE_LANES)
    ga.apply_grouped_updates = held
    try:
        for inp in lane_scans(dev, DENSE_LANES, DENSE_LANES_STEPS):
            state, res = step(state, inp)
    finally:
        ga.apply_grouped_updates = dense
    sm = state.frontend.submaps
    spawned = bool((sm.num_created >= 2).all())
    check(len(calls) == 2 * DENSE_LANES_STEPS, f"phase 11: {len(calls)} K1 dense calls for {DENSE_LANES_STEPS} steps")
    check(all(eq and d == w == 0 for eq, d, w in calls), f"phase 11: K1 dense calls vs plain {calls}")
    check(spawned and int(sm.dense_dropped.sum()) == 0, "phase 11: dense lanes spawned, no drops")
    print(f"batched dense: B={DENSE_LANES}, {DENSE_LANES_STEPS} steps across a spawn: {len(calls)} K1 dense calls "
          f"(2 per step) bit-identical to plain on a CPU copy of {sm.high_values.numel()} + "
          f"{sm.low_values.numel()} cells", flush=True)
    return {"lanes": DENSE_LANES, "steps": DENSE_LANES_STEPS, "k1_dense_calls": len(calls)}


def check_batched(ga, ac, dev, single_rate):
    """Phase 11: batched LIO on the card."""
    t0 = time.perf_counter()
    rows, k1, k2 = batched_scaling(ga, ac, dev, single_rate)
    t1 = time.perf_counter()
    lanes = batched_lanes(dev)
    t2 = time.perf_counter()
    dense = batched_dense(ga, dev)
    seconds = time.perf_counter() - t0
    print(f"phase 11: {seconds:.1f} s (aim {PHASE11_AIM_S:.0f} s; (a) {t1 - t0:.1f}, (b) {t2 - t1:.1f}, "
          f"(c) {t0 + seconds - t2:.1f})", flush=True)
    return {"grouped_apply": k1, "affine_chain": k2}, {"scaling": rows, "lanes": lanes, "dense": dense,
                                                        "seconds": seconds}


def main():
    start = time.perf_counter()
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
    t5 = time.perf_counter()
    launches, scans_per_s = check_slice(ga, ac, get_device("cuda"))
    print(f"phases 5-6: {time.perf_counter() - t5:.1f} s")
    k1d, dense_kernels = check_dense_grouped_apply(ga, rng)
    check(0 < dense_kernels <= 2, f"K1 dense entry: {dense_kernels} device kernels per call, "
          "not 1 or 2")
    t8 = time.perf_counter()
    map_launches, mapping = check_mapping(ga, ac, get_device("cuda"))
    print(f"phase 8: {time.perf_counter() - t8:.1f} s")
    t9 = time.perf_counter()
    campus_k2, campus = check_campus(ac, get_device("cuda"))
    viral_k2, viral = check_viral(ac, get_device("cuda"))
    rtc_k2, correlative = check_correlative(ac, get_device("cuda"))
    print(f"phase 9: {time.perf_counter() - t9:.1f} s")
    t10 = time.perf_counter()
    io_launches, runner_k2, io = check_io(ga, ac, get_device("cuda"))
    phase10_s = time.perf_counter() - t10
    print(f"phase 10: {phase10_s:.1f} s (aim {PHASE10_AIM_S:.0f} s)")
    batched_launches, batched = check_batched(ga, ac, get_device("cuda"), scans_per_s)
    check("jax" not in sys.modules, "no jax imported")
    k2_launches = {"slice": launches["affine_chain"], "mapping": map_launches["affine_chain"],
                   "campus": campus_k2, "viral": viral_k2, "correlative": rtc_k2,
                   "checkpoint": io_launches["affine_chain"], "runner": runner_k2,
                   "batched": batched_launches["affine_chain"]}
    k1_launches = {"slice": launches["grouped_apply"], "batched": batched_launches["grouped_apply"]}
    dense_launches = {"mapping": map_launches["grouped_apply_dense"],
                      "checkpoint": io_launches["grouped_apply_dense"]}

    print(json.dumps({"card": card, "slice_scans_per_s": scans_per_s, "mapping": mapping,
                      "campus": campus, "viral": viral, "correlative": correlative, "io": io,
                      "phase10_seconds": phase10_s, "batched": batched,
                      "dense_kernels_per_call": dense_kernels,
                      "grouped_apply_by_shape": {**k1, **k1d},
                      "affine_chain_by_length": k2, "affine_chain_launches": k2_launches,
                      "reduced": {"viral": f"submaps.num_range_data 100 -> {VIRAL_RANGE_DATA}: the "
                                           f"course's {E2E_STATIC + VIRAL_MOVING} scans insert ~14 times, "
                                           "a slot recycle needs 2 x num_range_data inserts",
                                  "campus": "none",
                                  "checkpoint": f"submaps.num_range_data 16 -> {CKPT_RANGE_DATA}: "
                                                "at 16 phase 10 took 120.6 s on an H100 80GB HBM3 "
                                                "(700 W), over its 120 s aim",
                                  "batched_lanes": f"submaps.num_range_data 100 -> {LANES_RANGE_DATA}: "
                                                   "spawns and a slot recycle within "
                                                   f"{LANES_STEPS} steps",
                                  "batched_dense": f"submaps.num_range_data 16 -> {DENSE_LANES_RANGE_DATA}: "
                                                   f"a spawn within {DENSE_LANES_STEPS} steps"}}))

    def record(name, source, replaces, n, timed, err, **extra):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": n,
                "max_abs_err": err, **{k: timed[k] for k in ("ms", "event_ms", "graph_ms", "plain_ms",
                                                              "bound_ms", "bound_by")},
                "library_ms": None, **extra}

    print(json.dumps({"kernels": [
        record("grouped_apply", "dliom_tpu_torch/csrc/grouped_apply.cu",
               "dliom_tpu/ops/pallas_apply.py:257", sum(k1_launches.values()), k1["high_spawn"],
               max(v["max_abs_err"] for v in k1.values()), launches_by_path=k1_launches),
        record("affine_chain", "dliom_tpu_torch/csrc/affine_chain.cu",
               "dliom_tpu/imu/preintegration.py:102", sum(k2_launches.values()), k2[IMU_CAP],
               max(v["max_abs_err"] for v in k2.values()), launches_by_path=k2_launches),
        record("grouped_apply_dense", "dliom_tpu_torch/csrc/grouped_apply.cu",
               "dliom_tpu/ops/pallas_apply.py:215", sum(dense_launches.values()), k1d["dense"],
               max(v["max_abs_err"] for v in k1d.values()), launches_by_path=dense_launches),
    ]}))
    print(f"chip_smoke: {time.perf_counter() - start:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
