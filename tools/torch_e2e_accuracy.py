#!/usr/bin/env python3
"""The e2e circle's accuracy with the truth paired by node time, on the port.

    python3 tools/torch_e2e_accuracy.py [--config tool|bench_e2e] [--device cuda]

tools/torch_e2e_loop_ate.py pairs its truth with the nodes by index from
the first moving scan, as the JAX tool does, though the static phase makes
nodes too. This script drives the same course through `MapBuilder` and
pairs each node with the true pose of its own scan:

  * `--config tool` runs tools/torch_e2e_loop_ate.py's `main` itself (its
    configuration, inline searches, its E2E_* knobs; its two JSON lines
    are printed as usual) and reads its graph just before and after the
    final optimization;
  * `--config bench_e2e` runs chip_smoke.py's phase 8 course and
    configuration (bench.py's bench_e2e: 2 pool threads, pipeline depth 1,
    275 scans) and reads the graph after the last scan and after
    `finish_trajectory()`.

Prints one JSON line (and `main` returns it): the nodes made in the static
phase, `evaluate` before and after the final optimization with the truth
paired by node time, and each INTER constraint's error against its true
relative pose (the submap's truth through its first node, as
tools/torch_long_course.py's `evaluate_constraints`) with its score. It
runs on the card unless given `--device cpu`, and imports nothing of JAX.
"""

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_e2e_loop_ate as te  # noqa: E402
import torch_long_course as lc  # noqa: E402
from dliom_tpu_torch.common.device import get_device  # noqa: E402


def truth(course):
    """(stamps, quats, positions) of the course's scans."""
    return (np.asarray([c[1] for c in course]), np.stack([np.asarray(c[4].rotation, np.float64) for c in course]),
            np.stack([np.asarray(c[4].translation, np.float64) for c in course]))


def accuracy(pg, gt) -> dict:
    """`evaluate` with the truth paired by node time."""
    return te.evaluate(pg, te.ground_truth_by_time(pg, gt[0], gt[2]))


def inter_errors(pg, gt) -> list:
    """[(submap, node, score, translation error m, rotation error rad)] of
    each INTER constraint against the true relative pose."""
    node_gt, submap_gt = lc.truth_lookup(pg, gt)
    out = []
    for c in pg.constraints:
        if c.tag != "INTER":
            continue
        q, p = lc._np_rigid_inv_compose(*submap_gt(c.submap_id), *node_gt(c.node_id))
        dq = lc._np_quat_multiply(q * np.array([1.0, -1.0, -1.0, -1.0]), np.asarray(c.relative.rotation, np.float64))
        out.append((c.submap_id, c.node_id, round(float(c.score), 3),
                    round(float(np.linalg.norm(p - np.asarray(c.relative.translation, np.float64))), 3),
                    round(lc._quat_angle(dq), 4)))
    return out


def run_tool(device, out):
    """tools/torch_e2e_loop_ate.py's `main`, its graph read around the final optimization."""
    laps = float(os.environ.get("E2E_LAPS", "1.12"))
    n = te.N_REST + int(round(laps * 2 * np.pi * te.RADIUS / te.SPEED / te.SCAN_PERIOD))
    gt = truth(te.course(n))

    class Reading(te.MapBuilder):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            pg, final = self.pose_graph, self.pose_graph.run_final_optimization

            def run_final_optimization():
                out["before"] = accuracy(pg, gt)
                final()
                out["after"] = accuracy(pg, gt)
                out["static_nodes"] = int(sum(node.time <= gt[0][te.N_REST - 1] for node in pg.nodes))
                out["inter"] = inter_errors(pg, gt)

            pg.run_final_optimization = run_final_optimization

    builder_class, te.MapBuilder = te.MapBuilder, Reading
    try:
        te.main(["--device", str(device)])
    finally:
        te.MapBuilder = builder_class


def run_bench_e2e(device, out):
    """chip_smoke.py's phase 8 course and configuration."""
    import chip_smoke as cs
    from dliom_tpu_torch.common.config import load_config
    from dliom_tpu_torch.map_builder import MapBuilder

    course = te.course(cs.E2E_STATIC + cs.E2E_WARM + cs.E2E_TIMED + 2 * cs.E2E_PROFILED)
    gt = truth(course)
    builder = MapBuilder(load_config("basic", cs.E2E_OVERRIDES), use_background_threads=True, pipeline_depth=1,
                         device=device)
    pg = builder.pose_graph
    cs.drive(builder, course)
    builder.flush()
    pg.wait_for_all_computations()
    out["before"] = accuracy(pg, gt)
    builder.finish_trajectory()
    out["after"] = accuracy(pg, gt)
    out["static_nodes"] = int(sum(node.time <= gt[0][te.N_REST - 1] for node in pg.nodes))
    out["inter"] = inter_errors(pg, gt)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", choices=("tool", "bench_e2e"), default="tool")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = get_device(args.device)
    out = {"config": args.config}
    (run_tool if args.config == "tool" else run_bench_e2e)(device, out)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
