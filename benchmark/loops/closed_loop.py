"""Closed loop, one step in flight: each step is handed in once the last
one's answer is on the host. The mix names the system it drives
(benchmark/systems/<system>.py) and sets the lanes, the course, the
warm-up, the checked steps and the traced stretch:

  lanes, radius_m, lap_scans   the course (benchmark/generator.py)
  warmup_steps                 steps in set-up: the eager warm-up, the capture
  check_strata, check_run      [[lo, hi), ...] of window steps: in each a
                               run of check_run steps drawn from the seed
  check_lanes                  lanes checked a step, one from each equal part
  roofline_steps               window steps checked, every lane, in `--trace 1`
                               runs: the rooflines' work, the same on every seed
  trace_steps, trace_tries     a traced stretch's steps, and how many
                               stretches a `--trace 1` run tries for one
                               whose steps count the same kernels

`run` returns what the harness prints: the end-to-end values, the
context that per-layer metrics read, and the numbers compared.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import generator as gen
from benchmark import trace as tr
from benchmark.metrics import roofline
from benchmark.reference import step as ref
from benchmark.reference.lio.ops import grouped_apply as ref_ga

TRACE_AT = 0.4  # the first traced stretch starts this share of the window in
IMU_FACTORS = "window.pre_"  # the window's IMU preintegration factors (imu_factor_gap)


def draw_checks(traffic: dict, seed: int, lanes: int, trace: bool = False) -> Dict[int, List[int]]:
    """The window's steps that the reference checks, and the lanes of each,
    drawn from the seed: in each of `check_strata` a run of `check_run`
    consecutive steps (the motion filter lets every other scan into the
    map on the course, so a run of 2 holds an insert), and of each run one
    lane from each of `check_lanes` equal parts of the lanes (so that any
    half of them holds a checked lane); with `trace`, also every lane of
    each of `roofline_steps`, the same steps on every seed, whose kernel
    work the rooflines count."""
    rng = np.random.default_rng(gen.seeds(seed, 1)[0] % 2**63)
    run = traffic.get("check_run", 1)
    starts = [int(rng.integers(lo, hi)) for lo, hi in traffic["check_strata"]]
    parts = min(lanes, traffic.get("check_lanes", 1))
    bounds = np.linspace(0, lanes, parts + 1).astype(int)
    out: Dict[int, List[int]] = {}
    for k in starts:
        chosen = [int(rng.integers(lo, hi)) for lo, hi in zip(bounds[:-1], bounds[1:])]
        for j in range(run):
            out[k + j] = chosen
    if trace:
        for k in traffic.get("roofline_steps", []):
            out.setdefault(k, list(range(lanes)))
    return dict(sorted(out.items()))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def check(system, lap, checks, offset: int, pre, post, host, spec: dict) -> Dict[str, float]:
    """The reference from the program's pre-step state of each checked
    step and lane: the largest gap of each kind, and K1's bytes by step
    (over the checked lanes). Of the state's float
    leaves (and the answer read back), each as its largest difference over
    the larger of its largest magnitude and the median leaf's, the IMU
    preintegration factors give `imu_factor_gap` and the rest `state_gap`."""
    from benchmark.reference.lio.frontend.lio import LioScanInput

    cfg = ref.config(spec)
    worst = dict.fromkeys(("pose_gap_m", "rot_gap_rad", "vel_gap_mps", "bias_gap", "map_mismatch_share",
                           "state_gap", "imu_factor_gap"), 0.0)
    leaves: Dict[str, float] = {}
    k1_bytes: Dict[int, int] = {}
    for k, lanes in checks.items():
        for b in lanes:
            state = ref.convert(system.lane(pre[k], b))
            before = ref.cell_map(state, cfg)
            inp = gen.scan_input(lap, offset + k, LioScanInput, lane=b)
            ref_ga.RECORD = []
            try:
                new_state, res = ref.step(cfg, state, inp)
                records = ref_ga.RECORD
            finally:
                ref_ga.RECORD = None
            k1_bytes[k] = k1_bytes.get(k, 0) + sum(roofline.k1_record_bytes(r) for r in records)
            prog_post = system.lane(post[k], b)
            # the answer read back, and the state the step left
            gaps = tuple(max(x, y) for x, y in zip(
                ref.nav_gaps(host[k][b].double(), ref.pack(res).double().cpu()),
                ref.nav_gaps(ref.pack_state(prog_post).double().cpu(), ref.pack_state(new_state).double().cpu())))
            # the map: cells (and integer bookkeeping) that differ from the
            # reference's, over the cells the reference's step changed
            after = ref.cell_map(new_state, cfg)
            changed = ref.mismatched_cells(before, after)
            share = ref.mismatched_cells(ref.cell_map(prog_post, cfg), after) / max(1, changed)
            by_leaf = ref.leaf_gaps(prog_post, new_state, host[k][b][:16].to(torch.float64),
                                    ref.pack(res)[:16].to(torch.float64).cpu())
            for n, v in by_leaf.items():
                leaves[n] = max(leaves.get(n, 0.0), v)
            imu = [v for n, v in by_leaf.items() if n.startswith(IMU_FACTORS)]
            rest = [v for n, v in by_leaf.items() if not n.startswith(IMU_FACTORS)]
            for name, v in zip(worst, gaps + (share, max(rest, default=0.0), max(imu, default=0.0))):
                worst[name] = max(worst[name], v)
            del state, new_state, res
    worst["k1_bytes_by_step"] = k1_bytes
    worst["leaf_gaps"] = leaves
    return worst


def run(cell, seed: int, seconds: float, trace: bool, t_start: float, device: torch.device, make) -> dict:
    """One run of the cell: set-up, the window, the check. `make(spec,
    lanes, device)` builds the system."""
    traffic, spec = cell.traffic, cell.spec
    lanes = traffic.get("lanes", 1)
    parts = {"imports": time.perf_counter() - t_start}
    lap = gen.make_lap(spec, traffic, seed, device, lanes)
    _sync(device)
    parts["lap"] = time.perf_counter() - t_start - sum(parts.values())
    system = make(spec, lanes, device)
    system.start(lap.starts)
    _sync(device)
    parts["program"] = time.perf_counter() - t_start - sum(parts.values())
    checks = draw_checks(traffic, seed, lanes, trace)
    roofline_steps = [k for k in traffic.get("roofline_steps", []) if trace]
    last_check = max(checks)
    before_checked = getattr(system, "before_checked", None)
    step_no = 0

    def one_step(k: int, tracing: bool, out: torch.Tensor, done):
        with tr.span("stage", tracing):
            inp = gen.scan_input(lap, k, system.input_type)
        with tr.span("step", tracing):
            system.step(inp)
        with tr.span("read", tracing):
            out.copy_(system.packed(), non_blocking=True)
            if done is not None:
                done.record()
                done.synchronize()

    host_buf = torch.empty((lanes, ref.PACKED), dtype=torch.float32, pin_memory=device.type == "cuda")
    done = torch.cuda.Event() if device.type == "cuda" else None
    for i in range(traffic["warmup_steps"]):
        one_step(step_no, False, host_buf, done)
        step_no += 1
        parts[f"warmup_step{i}"] = time.perf_counter() - t_start - sum(parts.values())
    if trace:
        tr.warm_up()
    _sync(device)
    setup_s = time.perf_counter() - t_start

    # ----- the window; then the checked steps it did not reach, and a
    # traced stretch not finished -----
    latencies, host, pre, post, traced_steps = [], {}, {}, {}, set()
    stretch = {"prof": None, "steps": 0, "tries": 0, "summary": None, "last": None}
    trace_steps, trace_tries = traffic["trace_steps"], traffic.get("trace_tries", 3)

    def want_trace() -> bool:
        return trace and stretch["summary"] is None and stretch["tries"] < trace_tries

    def after_traced_step() -> None:
        stretch["steps"] += 1
        if stretch["steps"] == trace_steps:
            prof = stretch["prof"]
            prof.stop()
            s = tr.reduce(prof, trace_steps)
            stretch.update(prof=None, steps=0, tries=stretch["tries"] + 1, last=s)
            if s and s["stable"]:
                stretch["summary"] = s

    def take(k: int) -> None:
        """Before step k: the checked lanes' pre-step state of k and the
        state step k - 1 left, one copy where both are due."""
        if k in checks:
            pre[k] = system.snapshot(checks[k])
            if before_checked is not None:
                before_checked(checks[k])
        if k - 1 in checks:
            same = k in checks and checks[k] == checks[k - 1] and before_checked is None
            post[k - 1] = pre[k] if same else system.snapshot(checks[k - 1])

    t0 = time.perf_counter()
    k, in_window, window_s = 0, None, 0.0
    while in_window is None or k <= last_check or want_trace() or stretch["prof"] is not None:
        take(k)
        if stretch["prof"] is None and want_trace() and (
                in_window is not None or time.perf_counter() - t0 >= TRACE_AT * seconds):
            stretch["prof"] = tr.profiler()
            stretch["prof"].start()
        tracing = stretch["prof"] is not None
        th = time.perf_counter()
        one_step(step_no, tracing, host_buf, done)
        te = time.perf_counter()
        if tracing:
            traced_steps.add(k)
            after_traced_step()
        if in_window is None:
            latencies.append(te - th)
        host[k] = host_buf.clone()
        step_no += 1
        k += 1
        if in_window is None and te - t0 >= seconds:
            in_window, window_s = k, te - t0
    take(k)
    _sync(device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    drops = system.drops()
    counts = system.counts()
    roofline_trace = {}
    if roofline_steps:
        # the roofline steps once more, each from its own pre-step state (every
        # lane), under the profiler: the device time of exactly the calls
        # whose work the reference counts
        prof = tr.profiler()
        prof.start()
        for k in roofline_steps:
            system.restore(pre[k])
            one_step(traffic["warmup_steps"] + k, True, host_buf, done)
        prof.stop()
        roofline_trace = tr.reduce(prof, len(roofline_steps))
    system.free()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    poses = torch.stack([host[i] for i in range(in_window)])
    failed = int((~torch.isfinite(poses[..., :16]).all(-1)).sum())
    error = None
    numbers: Dict[str, float] = {}
    t_check = time.perf_counter()
    try:
        numbers = check(system, lap, checks, traffic["warmup_steps"], pre, post, host, spec)
    except Exception as e:  # a reference that cannot follow the program is a failed check
        error = f"{type(e).__name__}: {e}"
    t_check = time.perf_counter() - t_check
    k1_by_step = numbers.pop("k1_bytes_by_step", {})
    k1_bytes = sum(k1_by_step.get(k, 0) for k in roofline_steps) or None
    leaf_gaps = numbers.pop("leaf_gaps", {})
    numbers["dropped_groups"] = float(sum(v for v in drops.values() if isinstance(v, int)))

    summary = stretch["summary"] or stretch["last"] or {}
    untraced = [x for i, x in enumerate(latencies) if i not in traced_steps]
    info = {"steps_in_window": in_window, "window_s": window_s, "setup_parts_s": parts,
            "graph_counts": counts, "checked": {str(k): v for k, v in checks.items()}, "check_s": t_check,
            "latency_ms_median": float(np.median(untraced)) * 1e3,
            "max_filtered": int(poses[..., 16].max()), "drops": drops, "leaf_gaps": leaf_gaps}
    if summary:
        info["trace"] = {"tries": stretch["tries"], "stable": bool(summary["stable"]),
                         "kernels_by_step": summary["kernels_by_step"],
                         "traced_ms_per_step": 1e3 * summary["window_s"] / summary["steps"]}
        if not summary["stable"]:
            print(f"no traced stretch of {trace_steps} steps counted the same kernels in each step "
                  f"(last: {json.dumps(summary['kernels_by_step'])})", file=sys.stderr, flush=True)
    lat_ms = np.asarray(latencies) * 1e3
    return {
        "setup_s": setup_s,
        "values": {"scans_per_s": in_window * lanes / window_s,
                   "scan_latency_p95_ms": float(np.percentile(lat_ms, 95)),
                   "setup_s": setup_s},
        "ctx": {"trace": summary, "lanes": lanes, "imu_samples": lap.imu_samples,
                "roofline_trace": roofline_trace, "k1_bytes": k1_bytes, "counts": counts},
        "numbers": numbers,
        "error": error,
        "attempted": in_window * lanes,
        "failed": failed,
        "peak": int(peak),
        "info": info,
    }
