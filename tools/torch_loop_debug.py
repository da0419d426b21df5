#!/usr/bin/env python3
"""Diagnose missed loop closures on the long course, on the port.

    python3 tools/torch_loop_debug.py --dataset PATH [--pairs 12] [--device cuda]

The counterpart of tools/loop_debug.py on dliom_tpu_torch. It replays a
dataset written by tools/torch_long_course.py (or tools/long_course.py:
the bits are the same) through the port's runner at the course's
configuration, then, for a sample of ground-truth-close (finished submap,
node) pairs without a found constraint, scores the node at its true pose
in the submap frame (`score_at_pose`):

  - the branch-and-bound pyramid's depth-0 score of the high cloud there
    (what the search would see had it landed exactly right), over all
    valid points and over those inside the cropped grid;
  - the low-resolution grid's score there (the min_low_resolution_score
    gate's input), likewise;
  - the share of high and low points inside the cropped grids;
  - the initial guess's translation error against the true relative pose.

This separates "the score gates reject a correct pose" (crop dilution,
gate tuning) from "the search never reaches the correct pose" (initial
drift beyond the window, pruning). Prints the runner report's scalar
fields, the count of missed pairs and one JSON line per sampled pair;
`main` returns the JSON lines. It runs on the card unless given
`--device cpu`, and imports nothing of JAX.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_long_course as lc  # noqa: E402
from dliom_tpu_torch.backend.precomputation import lookup, probability_from_byte  # noqa: E402
from dliom_tpu_torch.common.device import get_device  # noqa: E402
from dliom_tpu_torch.mapping.grid import cell_index, interpolated_probability  # noqa: E402
from dliom_tpu_torch.transform.rigid import Rigid3  # noqa: E402

SCORE_KEYS = ("score_all", "score_inbounds", "hi_frac_in", "low_all", "low_inbounds", "lo_frac_in")


def _inside(cells, spec):
    return torch.all((cells + spec.half >= 0) & (cells + spec.half < spec.extent), dim=-1)


def score_at_pose(pg, submap_id, node, rel) -> dict:
    """The node's clouds scored against finished submap `submap_id`'s grids
    at relative pose `rel` (node in the submap frame, numpy or tensors):
    SCORE_KEYS, as floats, from one host read."""
    dev = pg.device
    hi, lo = pg._hi_spec, pg._lo_spec
    rel = Rigid3(*(torch.as_tensor(x, dtype=torch.float32, device=dev) for x in rel))
    _, g_lo, pyr = pg._decompressed_grids(submap_id)
    hp, hm, lp, lm = (torch.tensor(np.asarray(x), device=dev)
                      for x in (node.high_points, node.high_mask, node.low_points, node.low_mask))

    def mean_over(mask, values, count):
        return torch.sum(torch.where(mask, values, 0).to(torch.float32)) / count

    # depth-0 pyramid score at the pose
    cells = cell_index(rel.apply(hp), hi.resolution)
    vals = lookup(pyr.levels[0], cells, hi.half)
    inb = _inside(cells, hi) & hm
    n_valid = torch.clamp(hm.to(torch.float32).sum(), min=1.0)
    n_in = torch.clamp(inb.to(torch.float32).sum(), min=1.0)
    # the low-resolution gate at the pose
    lo_pts = rel.apply(lp)
    lo_inb = _inside(cell_index(lo_pts, lo.resolution), lo) & lm
    p_low = interpolated_probability(g_lo, lo_pts, lo)
    n_lo = torch.clamp(lm.to(torch.float32).sum(), min=1.0)
    n_lo_in = torch.clamp(lo_inb.to(torch.float32).sum(), min=1.0)
    out = torch.stack([
        probability_from_byte(mean_over(hm, vals, n_valid)),
        probability_from_byte(mean_over(inb, vals, n_in)),
        n_in / n_valid,
        mean_over(lm, p_low, n_lo),
        mean_over(lo_inb, p_low, n_lo_in),
        n_lo_in / n_lo,
    ]).cpu().numpy()
    return {k: float(v) for k, v in zip(SCORE_KEYS, out)}


def missed_pairs(pg, gt, radius=7.0, min_sep=60.0):
    """(submap, node, submap truth, node truth) of the finished submaps and
    nodes (at the constraint builder's node stride) at least `min_sep` s
    apart whose true positions lie within `radius` and that have no INTER
    constraint."""
    node_gt, submap_gt = lc.truth_lookup(pg, gt)
    every = max(1, pg.cfg.constraint_builder.every_nodes_to_find_constraint)
    have = {(c.submap_id, c.node_id) for c in pg.constraints if c.tag == "INTER"}
    missed = []
    for sid, sub in enumerate(pg.submaps):
        if not (sub.finished and sub.high is not None):
            continue
        qs, ps = submap_gt(sid)
        ts = pg.nodes[sub.node_ids[0]].time
        sub_nodes = set(sub.node_ids)
        for nid in range(0, len(pg.nodes), every):
            if nid in sub_nodes or (sid, nid) in have or abs(pg.nodes[nid].time - ts) < min_sep:
                continue
            qn, pn = node_gt(nid)
            if np.linalg.norm(pn - ps) < radius:
                missed.append((sid, nid, (qs, ps), (qn, pn)))
    return missed


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--pairs", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = get_device(args.device)
    gt = lc.load_ground_truth(args.dataset)
    holder = {}
    report = lc.replay(args.dataset, device, on_builder=lambda builder, report: holder.update(builder=builder))
    lines = [{k: v for k, v in report.items() if not isinstance(v, dict)}]
    print(json.dumps(lines[-1]), flush=True)

    pg = holder["builder"].pose_graph
    missed = missed_pairs(pg, gt)
    print(f"missed gt-close pairs: {len(missed)}", flush=True)
    np.random.default_rng(0).shuffle(missed)
    for sid, nid, (qs, ps), (qn, pn) in missed[: args.pairs]:
        q_rel, p_rel = lc._np_rigid_inv_compose(qs, ps, qn, pn)
        node = pg.nodes[nid]
        init = pg._initial_guess(pg.submaps[sid], node)
        init_t_err = float(np.linalg.norm(np.asarray(init.translation, np.float64) - p_rel))
        scores = score_at_pose(pg, sid, node, Rigid3(q_rel.astype(np.float32), p_rel.astype(np.float32)))
        lines.append({"pair": [sid, nid], "init_t_err_m": round(init_t_err, 2),
                      "gt_rel_t": [round(float(x), 1) for x in p_rel],
                      # in the JAX tool's order: its device_get sorts the keys
                      **{k: round(scores[k], 3) for k in sorted(scores)}})
        print(json.dumps(lines[-1]), flush=True)
    return lines


if __name__ == "__main__":
    main()
