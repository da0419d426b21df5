#!/usr/bin/env python3
"""Loop-proposal recall and precision of the submap-image path, on the port.

    python3 tools/torch_loop_recall.py [trials] [--device cuda]

The counterpart of tools/loop_recall.py on dliom_tpu_torch's PoseGraph: a
synthetic long loop whose revisit drift exceeds both the proximity gate
and the branch-and-bound window, so only the image proposals (FFT-NCC
over top-down submap images, the SURF substitute) can close it. Over
`trials` random worlds (seeds 1000, 1001, ...) it measures:

  * proposal recall: the true revisit target is among the proposals;
  * proposal precision: the share of proposals that are the true target
    (each visited place has its own scenery, so a proposal to another
    place is a false positive);
  * end-to-end closure rate: an INTER constraint to the true target with a
    correct relative pose survives the branch-and-bound verifier and the
    refinement (the reference verifies its SURF proposals the same way,
    constraint_builder_3d.cc:202-347).

Prints one JSON line (and `main` returns it in a list). It runs on the card
unless given `--device cpu`, and imports nothing of JAX: `_cfg` and
`_make_node` are its own copies of the pose-graph test helpers.
"""

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from dliom_tpu_torch.backend.pose_graph import NodeRecord, PoseGraph  # noqa: E402
from dliom_tpu_torch.common.config import load_config  # noqa: E402
from dliom_tpu_torch.common.device import get_device  # noqa: E402
from dliom_tpu_torch.mapping import probability as pv  # noqa: E402
from dliom_tpu_torch.mapping.grid import cell_index, make_grid, set_cells  # noqa: E402
from dliom_tpu_torch.mapping.submap import grid_specs  # noqa: E402
from dliom_tpu_torch.ops.rotational_histogram import compute_histogram  # noqa: E402
from dliom_tpu_torch.transform.rigid import Rigid3  # noqa: E402

IDENTITY = np.asarray([1.0, 0.0, 0.0, 0.0])


def _cfg():
    """The pose-graph tests' engine configuration (tests/test_pose_graph.py)."""
    return load_config("basic", {
        "trajectory_builder": {
            "submaps": {
                "high_resolution": 0.2,
                "low_resolution": 0.8,
                "high_resolution_extent": 128,
                "low_resolution_extent": 64,
            },
        },
        "pose_graph": {
            "optimize_every_n_nodes": 0,  # manual
            "max_submaps": 16,
            "max_nodes": 128,
            "max_constraints": 512,
            "max_radius_enable_loop_detection": 10.0,
            "num_close_submaps_loop_with_initial_value": 5,
            "constraint_builder": {
                "min_score": 0.4,
                "every_nodes_to_find_constraint": 1,
                "fast_correlative_scan_matcher": {
                    "branch_and_bound_depth": 6,
                    "full_resolution_depth": 3,
                    "min_low_resolution_score": 0.35,
                    "linear_xy_search_window": 3.0,
                    "linear_z_search_window": 1.5,
                },
            },
        },
    })


def _make_node(cfg, points, local_pose, device="cpu"):
    """A node whose high and low clouds are `points` (host numpy), all
    valid, its histogram computed on `device`."""
    pts = np.asarray(points)
    mask = np.ones(pts.shape[0], bool)
    hist = compute_histogram(torch.from_numpy(pts).to(device), torch.from_numpy(mask).to(device),
                             cfg.trajectory_builder.rotational_histogram_size)
    return NodeRecord(
        time=0.0,
        local_pose=local_pose,
        gravity_alignment=np.asarray([1.0, 0, 0, 0], np.float32),
        high_points=pts,
        high_mask=mask,
        low_points=pts,
        low_mask=mask,
        histogram=hist.cpu().numpy(),
        submap_ids=(),
    )


def _place_cloud(rng, n=1200):
    """A distinct scenery per place: random wall segments and scattered
    posts on a floor, structure enough for both the image and the grids."""
    out = []
    for _ in range(4):  # wall segments
        c = rng.uniform(-6, 6, 2)
        ang = rng.uniform(0, np.pi)
        length = rng.uniform(4, 10)
        s = rng.uniform(-length / 2, length / 2, n // 6)
        out.append(np.stack([c[0] + s * np.cos(ang), c[1] + s * np.sin(ang),
                             rng.uniform(-2, 2, n // 6)], -1))
    k = n - 4 * (n // 6)
    out.append(np.stack([rng.uniform(-7, 7, k), rng.uniform(-7, 7, k), np.full(k, -2.0)], -1))
    return np.concatenate(out).astype(np.float32)


def place_grids(cloud, hi, lo, device):
    """(high, low) dense grids with every cell of `cloud` at probability 0.9."""
    pts = torch.from_numpy(cloud).to(device)
    vals = torch.full((pts.shape[0],), int(pv.probability_to_value(torch.tensor(0.9))),
                      dtype=torch.int32, device=device)
    return tuple(set_cells(make_grid(spec, device), cell_index(pts, spec.resolution), vals, spec)
                 for spec in (hi, lo))


def run_trial(seed: int, num_places: int = 5, drift_norm: float = 8.0, device="cuda", keep=None):
    """One world: `num_places` places 30 m apart, then a revisit of place 0
    with a drift of `drift_norm` m. Returns recall, precision, closed and
    false_constraints; `keep` (a dict), if given, receives the pose graph,
    the proposals and the revisit node's id."""
    device = get_device(device)
    cfg = _cfg()
    pgc = dataclasses.replace(
        cfg.pose_graph,
        max_radius_enable_loop_detection=2.0,  # the proximity gate: too small
        num_close_submaps_loop_with_initial_value=1,
        optimize_every_n_nodes=0,
    )
    tb = cfg.trajectory_builder
    pg = PoseGraph(pgc, tb, device=device)
    hi, lo = grid_specs(tb.submaps)
    rng = np.random.default_rng(seed)
    clouds = [_place_cloud(rng) for _ in range(num_places)]
    grids = [place_grids(c, hi, lo, device) for c in clouds]

    # travel through distinct places 30 m apart, then revisit place 0 with
    # drift far beyond the gate and the branch-and-bound window
    for k in range(num_places):
        pose = Rigid3(IDENTITY, np.asarray([30.0 * k, 0.0, 0.0]))
        s = pg.add_submap(pose)
        pg.add_node(_make_node(cfg, clouds[k], pose, device), (s,))
        pg.finish_submap(s, *grids[k])

    d = rng.normal(0, 1, 3)
    d[2] *= 0.05
    revisit_pose = Rigid3(IDENTITY, np.asarray(drift_norm * d / np.linalg.norm(d), np.float32))
    s_new = pg.add_submap(revisit_pose)
    proposals = {}
    orig = pg._image_proposals

    def spy(from_id):
        out = orig(from_id)
        proposals.update(out)
        return out

    pg._image_proposals = spy
    node_id = pg.add_node(_make_node(cfg, clouds[0], revisit_pose, device), (s_new,),
                          newly_finished_submap_id=s_new, finished_grids=grids[0])

    proposed = set(proposals)
    inter = [c for c in pg.constraints if c.tag == "INTER" and c.submap_id == 0]
    closed = bool(inter) and float(np.linalg.norm(np.asarray(inter[0].relative.translation))) < 0.5
    false_inter = [c for c in pg.constraints if c.tag == "INTER" and c.submap_id != 0]
    if keep is not None:
        keep.update(pg=pg, proposals=proposals, node_id=node_id)
    return {
        "recall": 1.0 if 0 in proposed else 0.0,
        "precision": (1.0 / len(proposed)) if 0 in proposed else 0.0 if proposed else 1.0,
        "closed": 1.0 if closed else 0.0,
        "false_constraints": len(false_inter),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trials", nargs="?", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = get_device(args.device)
    rows = [run_trial(1000 + k, device=device) for k in range(args.trials)]
    agg = {
        "trials": args.trials,
        "proposal_recall": sum(r["recall"] for r in rows) / args.trials,
        "proposal_precision": sum(r["precision"] for r in rows) / args.trials,
        "e2e_closure_rate": sum(r["closed"] for r in rows) / args.trials,
        "false_constraints_total": sum(r["false_constraints"] for r in rows),
    }
    print(json.dumps(agg), flush=True)
    return [agg]


if __name__ == "__main__":
    main()
