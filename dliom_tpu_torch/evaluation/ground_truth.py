"""Ground-truth relation tools (port of dliom_tpu/evaluation/ground_truth.py,
the cartographer/ground_truth/ analog, C38).

`generate_ground_truth` derives loop-closure *relations* from an optimized
pose graph (autogenerate_ground_truth_main.cc:92-167): every INTER constraint
whose endpoints are far apart along the trajectory (covered distance >=
`min_covered_distance`) and whose constraint agrees with the optimized
solution within the outlier thresholds yields an expected relative pose
between the submap's representative node (its first INTRA node,
ComputeSubmapRepresentativeNode :72-89) and the matched node.

`compute_relations_metrics` replays relations against a (possibly different)
trajectory and reports the reference's statistics
(compute_relations_metrics_main.cc:55-112): abs translational error (m) and
abs rotational error (deg), each mean +/- stddev, plus squared versions.

Poses are the port's host `Rigid3` (float64 numpy) and compose with the
`np_*` mirrors; only `refine_relations_ndt` runs device work (NDT), on the
pose graph's device.
"""

from __future__ import annotations

import math
import warnings
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from dliom_tpu_torch.transform.rigid import Rigid3, np_compose, np_inverse, np_rigid


@dataclass
class Relation:
    timestamp1: float
    timestamp2: float
    expected: Rigid3  # node1 -> node2
    covered_distance: float


def _quat_angle(q) -> float:
    """Absolute rotation angle of a quaternion (transform.h GetAngle)."""
    q = np.asarray(q, np.float64)
    q = q / max(float(np.linalg.norm(q)), 1e-12)
    return float(2.0 * np.arctan2(np.linalg.norm(q[1:4]), abs(q[0])))


def _error(solution: Rigid3, expected: Rigid3) -> Tuple[float, float]:
    """(translation m, rotation rad) of solution * expected^-1."""
    err = np_compose(solution, np_inverse(expected))
    return float(np.linalg.norm(err.translation)), _quat_angle(err.rotation)


def _covered_distance(node_positions: np.ndarray) -> np.ndarray:
    """Cumulative trajectory arc length per node (:49-63)."""
    steps = np.linalg.norm(np.diff(node_positions, axis=0), axis=1)
    return np.concatenate([[0.0], np.cumsum(steps)])


def generate_ground_truth(
    pose_graph,
    min_covered_distance: float = 100.0,
    outlier_threshold_meters: float = 0.15,
    outlier_threshold_radians: float = 0.02,
) -> Tuple[List[Relation], int]:
    """Relations from INTER constraints of an optimized PoseGraph. Returns
    (relations, num_outliers)."""
    nodes = pose_graph.nodes
    positions = np.stack([np.asarray(n.global_pose.translation, np.float64) for n in nodes])
    covered = _covered_distance(positions)

    # representative node per submap = its first INTRA-constrained node
    rep: Dict[int, int] = {}
    for c in pose_graph.constraints:
        if c.tag == "INTRA" and c.submap_id not in rep:
            rep[c.submap_id] = c.node_id

    relations: List[Relation] = []
    num_outliers = 0
    for c in pose_graph.constraints:
        if c.tag != "INTER" or c.submap_id not in rep:
            continue
        rep_node = rep[c.submap_id]
        matched = c.node_id
        d = abs(covered[matched] - covered[rep_node])
        if d < min_covered_distance:
            continue
        sol1_inv = np_inverse(np_rigid(nodes[rep_node].global_pose))
        solution = np_compose(sol1_inv, np_rigid(nodes[matched].global_pose))
        submap_sol = np_rigid(pose_graph.submaps[c.submap_id].global_pose)
        expected = np_compose(np_compose(sol1_inv, submap_sol), np_rigid(c.relative))
        t_err, r_err = _error(solution, expected)
        if t_err > outlier_threshold_meters or r_err > outlier_threshold_radians:
            num_outliers += 1
            continue
        relations.append(Relation(timestamp1=nodes[rep_node].time, timestamp2=nodes[matched].time,
                                  expected=expected, covered_distance=d))
    return relations, num_outliers


def _interpolated_pose(times: np.ndarray, poses: Sequence[Rigid3], t: float) -> Rigid3:
    """Pose at time t: nearest-neighbor between trajectory nodes (the
    reference interpolates through TransformInterpolationBuffer; relations
    are stamped at node times, so the lookup is exact in practice)."""
    i = int(np.clip(np.searchsorted(times, t), 0, len(times) - 1))
    if i > 0 and abs(times[i - 1] - t) < abs(times[i] - t):
        i -= 1
    return poses[i]


def compute_relations_metrics(
    relations: Sequence[Relation],
    times: np.ndarray,
    poses: Sequence[Rigid3],
) -> Dict[str, float]:
    """Abs trans/rot errors of a trajectory vs relations (:55-112)."""
    t_errs, r_errs_deg = [], []
    times = np.asarray(times)
    for rel in relations:
        p1 = np_rigid(_interpolated_pose(times, poses, rel.timestamp1))
        p2 = np_rigid(_interpolated_pose(times, poses, rel.timestamp2))
        t_err, r_err = _error(np_compose(np_inverse(p1), p2), np_rigid(rel.expected))
        t_errs.append(t_err)
        r_errs_deg.append(math.degrees(r_err))
    t = np.asarray(t_errs) if t_errs else np.zeros(0)
    r = np.asarray(r_errs_deg) if r_errs_deg else np.zeros(0)

    def stats(v):
        if len(v) == 0:
            return 0.0, 0.0
        return float(v.mean()), float(v.std())

    tm, ts = stats(t)
    rm, rs = stats(r)
    sq_tm, sq_ts = stats(t**2)
    sq_rm, sq_rs = stats(r**2)
    return {
        "num_relations": len(relations),
        "abs_translational_error_mean_m": tm,
        "abs_translational_error_std_m": ts,
        "sq_translational_error_mean_m2": sq_tm,
        "sq_translational_error_std_m2": sq_ts,
        "abs_rotational_error_mean_deg": rm,
        "abs_rotational_error_std_deg": rs,
        "sq_rotational_error_mean_deg2": sq_rm,
        "sq_rotational_error_std_deg2": sq_rs,
    }


def write_relations_csv(path: str, relations: Sequence[Relation]) -> None:
    """Text export (relations_text_file.cc analog; CSV instead of proto)."""
    with open(path, "w") as f:
        f.write("t1,t2,covered_distance,tx,ty,tz,qw,qx,qy,qz\n")
        for r in relations:
            t = np.asarray(r.expected.translation)
            q = np.asarray(r.expected.rotation)
            f.write(
                f"{r.timestamp1},{r.timestamp2},{r.covered_distance},"
                f"{t[0]},{t[1]},{t[2]},{q[0]},{q[1]},{q[2]},{q[3]}\n"
            )


def read_relations_csv(path: str) -> List[Relation]:
    """Relations back from `write_relations_csv`; poses float32 as the JAX
    package reads them, held as host numpy."""
    out = []
    with open(path) as f:
        next(f)
        for line in f:
            vals = [float(x) for x in line.strip().split(",")]
            out.append(Relation(
                timestamp1=vals[0], timestamp2=vals[1], covered_distance=vals[2],
                expected=Rigid3(rotation=np.asarray(vals[6:10], np.float32),
                                translation=np.asarray(vals[3:6], np.float32))))
    return out


def refine_relations_ndt(
    pose_graph,
    relations: List[Relation],
    *,
    ndt_resolution: float = 1.0,
    max_iterations: int = 35,
    max_refinement_meters: float = 0.5,
) -> Tuple[List[Relation], int]:
    """Refine relation transforms by NDT-aligning the two nodes' stored
    clouds, seeded with the optimized relative pose
    (gen_ground_truth_by_ndt_match.cc: PCL NDT at resolution 1.0, 35
    iterations, seeded with the pbstream relative; non-converged pairs are
    dropped). A refinement that moves the relative by more than
    `max_refinement_meters` is treated as non-converged. The NDT runs on the
    pose graph's device. Returns (refined relations, num_dropped)."""
    from dliom_tpu_torch.mapping.grid import GridSpec
    from dliom_tpu_torch.ops.ndt import build_field, match as ndt_match

    dev = pose_graph.device
    spec = GridSpec(resolution=float(ndt_resolution), extent=128)
    # Relations carry no trajectory id (reference relations files don't
    # either), so an ambiguous stamp — two trajectories sharing a clock
    # origin — cannot be resolved; drop it loudly rather than refine
    # against the wrong trajectory's cloud.
    by_time: Dict[float, int] = {}
    ambiguous = set()
    for i, n in enumerate(pose_graph.nodes):
        k = round(n.time, 9)
        if k in by_time:
            ambiguous.add(k)
        by_time[k] = i

    def dev_tensor(x):
        return torch.from_numpy(np.array(x)).to(dev)

    refined: List[Relation] = []
    dropped = 0
    for rel in relations:
        k1, k2 = round(rel.timestamp1, 9), round(rel.timestamp2, 9)
        if k1 in ambiguous or k2 in ambiguous:
            warnings.warn(
                f"relation stamp {rel.timestamp1}/{rel.timestamp2} matches "
                "nodes on multiple trajectories; dropping (stamps must be "
                "unique to refine)",
                stacklevel=2,
            )
            dropped += 1
            continue
        i = by_time.get(k1)
        j = by_time.get(k2)
        if i is None or j is None:
            dropped += 1
            continue
        a, b = pose_graph.nodes[i], pose_graph.nodes[j]
        field = build_field(dev_tensor(a.high_points), dev_tensor(a.high_mask), spec)
        initial = Rigid3(dev_tensor(np.asarray(rel.expected.rotation, np.float32)),
                         dev_tensor(np.asarray(rel.expected.translation, np.float32)))
        out = np_rigid(ndt_match(field, spec, dev_tensor(b.high_points), dev_tensor(b.high_mask),
                                 initial, max_iterations=max_iterations))
        shift = float(np.linalg.norm(out.translation - np.asarray(rel.expected.translation)))
        if shift > max_refinement_meters:
            dropped += 1
            continue
        refined.append(Relation(timestamp1=rel.timestamp1, timestamp2=rel.timestamp2,
                                expected=out, covered_distance=rel.covered_distance))
    return refined, dropped
