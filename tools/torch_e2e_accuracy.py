#!/usr/bin/env python3
"""The e2e circle's accuracy with the truth paired by node time, on the port.

    python3 tools/torch_e2e_accuracy.py [--config tool|bench_e2e] [--device cuda] [--pairs PATH]

tools/torch_e2e_loop_ate.py pairs its truth with the nodes by index from
the first moving scan, as the JAX tool does, though the static phase makes
nodes too. This script drives the same course through `MapBuilder` and
pairs each node with the true pose of its own scan:

  * `--config tool` runs tools/torch_e2e_loop_ate.py's `main` itself (its
    configuration, inline searches, its E2E_* knobs; its two JSON lines
    are printed as usual) and reads its graph just before and after the
    final optimization;
  * `--config bench_e2e` runs chip_smoke.py's phase 8 configuration
    (bench.py's bench_e2e: 2 pool threads, pipeline depth 1) on bench.py's
    5 m circle for BENCH_E2E_SCANS scans and reads the graph after the
    last scan and after `finish_trajectory()`; `--pairs PATH` writes each
    INTER constraint's search inputs there (`save_pairs`), for
    tests/torch_loop_pair.py to run through both packages' searches.

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

# phase 8's course before chip_smoke.py cut its circle to 2 m: 16 static
# scans, bench.py's 1.12-lap warm-up (235), 20 timed and 4 profiled
BENCH_E2E_SCANS = 275


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


def record_searches(pg) -> list:
    """Wrap `pg._search` so that each with-initial search chunk appends
    (target submap, its host arrays, its packed (B, 9) result) to the list
    returned."""
    calls, search = [], pg._search

    def run(kind, hit, arrays):
        out = search(kind, hit, arrays)
        if kind == "search_initial":
            with pg._phase_lock:
                to_id = next(k for k, v in pg._grid_cache.items() if v is hit)
            calls.append((to_id, [np.array(a, copy=True) for a in arrays], pg._host(out)))
        return out

    pg._search = run
    return calls


# a with-initial search's arrays of one node, in `PoseGraph._search`'s order
NODE_KEYS = ("high_points", "high_mask", "low_points", "low_mask", "initial_q", "initial_t", "histogram", "yaw0")


def save_pairs(path, pg, calls, gt):
    """Each INTER constraint of a with-initial search, as one .npz: per
    pair i, `i_<name>` for the node's NODE_KEYS (its row of the chunk), the
    target submap's histogram (`submap_hist`) and compressed grids cut to
    their count (`high_indices`, `high_values`, `low_indices`,
    `low_values`), the port's packed result row (`result`), the true
    relative pose of node in submap (`true_q`, `true_t`) and (submap,
    node) as `ids`."""
    node_gt, submap_gt = lc.truth_lookup(pg, gt)
    out = {}
    for c in (x for x in pg.constraints if x.tag == "INTER"):
        high = pg.nodes[c.node_id].high_points
        found = next(((t, a, r, k) for t, a, r in calls for k in range(len(a[0]))
                      if t == c.submap_id and np.array_equal(a[0][k], high) and r[k, 0] > 0.5
                      and r[k, 1] == np.float32(c.score)), None)
        if found is None:  # a global search's constraint
            continue
        to_id, arrays, res, row = found
        sub = pg.submaps[to_id]
        q, p = lc._np_rigid_inv_compose(*submap_gt(to_id), *node_gt(c.node_id))
        fields = dict(zip(NODE_KEYS, (a[row] for a in arrays)))
        fields.update(submap_hist=arrays[len(NODE_KEYS)], result=res[row], true_q=q, true_t=p,
                      ids=np.array([to_id, c.node_id]))
        for name, comp in (("high", sub.high), ("low", sub.low)):
            n = int(comp.count)
            fields[f"{name}_indices"] = pg._host(comp.indices)[:n]
            fields[f"{name}_values"] = pg._host(comp.values)[:n]
        i = len(out) // len(fields)
        out.update({f"{i}_{k}": v for k, v in fields.items()})
    np.savez_compressed(path, **out)


def run_bench_e2e(device, out, pairs=None):
    """chip_smoke.py's phase 8 configuration on bench.py's 5 m circle."""
    import chip_smoke as cs
    from dliom_tpu_torch.common.config import load_config
    from dliom_tpu_torch.map_builder import MapBuilder

    course = te.course(BENCH_E2E_SCANS)
    gt = truth(course)
    builder = MapBuilder(load_config("basic", cs.E2E_OVERRIDES), use_background_threads=True, pipeline_depth=1,
                         device=device)
    pg = builder.pose_graph
    calls = record_searches(pg)
    cs.drive(builder, course)
    builder.flush()
    pg.wait_for_all_computations()
    out["before"] = accuracy(pg, gt)
    builder.finish_trajectory()
    out["after"] = accuracy(pg, gt)
    out["static_nodes"] = int(sum(node.time <= gt[0][te.N_REST - 1] for node in pg.nodes))
    out["inter"] = inter_errors(pg, gt)
    if pairs:
        save_pairs(pairs, pg, calls, gt)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", choices=("tool", "bench_e2e"), default="tool")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--pairs", help="bench_e2e: write each INTER's search inputs to this .npz")
    args = ap.parse_args(argv)
    device = get_device(args.device)
    out = {"config": args.config}
    run_tool(device, out) if args.config == "tool" else run_bench_e2e(device, out, args.pairs)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
