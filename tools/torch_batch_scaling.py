#!/usr/bin/env python3
"""Batched multi-sequence scaling of the port (dliom_tpu_torch/parallel/batch.py).

    python3 tools/torch_batch_scaling.py [--bs 1,2,4,8] [--profile DIR] [--device cuda]

For each B, B sequences at the bench config (chip_smoke.py's
BENCH_OVERRIDES: bench.py's build_config, 32768 raw points and 48 IMU
samples per scan), each on the synthetic corkscrew from its own world
offset, step in lockstep through `make_batched_lio_chunk`, with K1's
capacities at chip_smoke.py's SPAWN_CAPACITIES times B (one call holds all
lanes' groups, so no update drops): WARMUP steps, then MEASURE timed steps.
One JSON line per B: `batch`, `aggregate_scans_per_sec`,
`per_seq_scans_per_sec`, `scaling_vs_b1` (the per-sequence rate over the
first B's), `launches_per_step` (device kernels per batched step, from
torch.profiler over PROFILED steps after a warm-up cycle of as many; on
the CPU, where ops run inline, the ATen operator calls) and `peak_mem_mib`
(peak device memory; null on the CPU). --profile writes the last B's
trace (Chrome format) into DIR. `--small` runs a reduced config and scan
and fewer steps (tests/test_torch_batch_scaling.py). The counterpart of
tools/batch_scaling.py: it runs on the card unless given --device cpu,
prints the card's name and power limit first, and imports nothing of JAX.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from dliom_tpu_torch.common.device import get_device  # noqa: E402
from dliom_tpu_torch.parallel.batch import make_batched_lio_chunk, make_batched_lio_state  # noqa: E402

CHUNK = 2  # steps per make_batched_lio_chunk call
WARMUP = 2
MEASURE = 6
PROFILED = 2
SMALL_STEPS = dict(chunk=1, warmup=1, measure=2, profiled=1)
SMALL = {"trajectory_builder": {
    "max_filtered_points": 1024, "max_high_res_points": 128, "max_low_res_points": 128,
    "max_imu_per_scan": 16, "window_size": 3, "gn_iterations": 1,
    "ceres_scan_matcher": {"max_num_iterations": 2},
    "submaps": {"brick_dir_extent": 16, "brick_max_bricks": 2048, "low_brick_dir_extent": 8,
                "low_brick_max_bricks": 512},
}}


def top_level_ops(events):
    """ATen operator calls not made inside another ATen operator."""
    def nested(e):
        p = e.cpu_parent
        while p is not None:
            if p.name.startswith("aten::"):
                return True
            p = p.cpu_parent
        return False
    return sum(1 for e in events if e.name.startswith("aten::") and not nested(e))


def run_b(b, device, small, profile_dir=None):
    n = SMALL_STEPS if small else dict(chunk=CHUNK, warmup=WARMUP, measure=MEASURE, profiled=PROFILED)
    cfg = chip_smoke.batched_config(chip_smoke.BENCH_OVERRIDES, b, chip_smoke.SPAWN_CAPACITIES)
    cfg = (cfg.override(SMALL) if small else cfg).trajectory_builder
    n_points = 2048 if small else chip_smoke.CAPACITY
    scans = chip_smoke.lane_scans(device, b, 10, n_points=n_points, imu_cap=cfg.max_imu_per_scan)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    state = make_batched_lio_state(cfg, b, device)
    chunk = make_batched_lio_chunk(cfg, b, n["chunk"])
    k = 0

    def steps(count):
        nonlocal state, k
        for _ in range(count // n["chunk"]):
            state, results = chunk(state, [scans[(k + i) % len(scans)] for i in range(n["chunk"])])
            k += n["chunk"]
        return results

    steps(n["warmup"])
    sync()
    t0 = time.perf_counter()
    results = steps(n["measure"])
    sync()
    wall = time.perf_counter() - t0
    for r in results:
        if not bool(torch.isfinite(r.scan.local_pose.translation).all()):
            raise RuntimeError(f"B={b}: a pose is not finite")
    cycle = lambda: steps(n["profiled"])  # noqa: E731
    prof = chip_smoke.warm_profile([cycle, cycle])[0] if cuda else _cpu_profile(cycle)
    events = prof.events()
    launches = (len(chip_smoke.device_events(events)) if cuda else top_level_ops(events)) / n["profiled"]
    if profile_dir:
        Path(profile_dir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(profile_dir) / f"batch_{b}.json"))
    return {"rate": n["measure"] * b / wall, "launches_per_step": launches,
            "peak_mem_mib": torch.cuda.max_memory_allocated() / 2**20 if cuda else None}


def _cpu_profile(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bs", default="1,2,4,8")
    ap.add_argument("--profile", default=None, help="trace dir; captured for the last B only")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true", help="a reduced config and scan size")
    args = ap.parse_args(argv)
    device = get_device(args.device)
    if device.type == "cuda":
        chip_smoke.environment()
    import dliom_tpu_torch  # noqa: F401  (pins f32, TF32 off)
    if device.type == "cuda":
        from dliom_tpu_torch import kernels
        kernels.build()
    bs = [int(x) for x in args.bs.split(",")]
    base = None
    lines = []
    for i, b in enumerate(bs):
        out = run_b(b, device, args.small, args.profile if i == len(bs) - 1 else None)
        per_seq = out["rate"] / b
        base = base or per_seq
        line = {"batch": b, "aggregate_scans_per_sec": out["rate"], "per_seq_scans_per_sec": per_seq,
                "scaling_vs_b1": per_seq / base, "launches_per_step": out["launches_per_step"],
                "peak_mem_mib": out["peak_mem_mib"]}
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()
