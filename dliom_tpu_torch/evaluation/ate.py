"""Trajectory evaluation: ATE / RPE.

Counterpart of the reference's evaluation tooling
(`cartographer/ground_truth/compute_relations_metrics_main.cc` relation
metrics + the evo-style CSV workflow via `dlio_eval_node.cc` /
`WriteTrajectoryForDLIO`, map_builder_bridge.cc:310-348): absolute trajectory
error with optional SE(3)/Umeyama alignment, and relative pose error over a
fixed time/space delta. Pure numpy (host-side analysis); a copy of
dliom_tpu/evaluation/ate.py whose KITTI export builds the rotation matrix in
numpy."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _interp(times, positions, t):
    return np.stack(
        [np.interp(t, times, positions[:, k]) for k in range(positions.shape[1])],
        axis=-1,
    )


def associate(
    est_times: np.ndarray,
    est_positions: np.ndarray,
    gt_times: np.ndarray,
    gt_positions: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Interpolate ground truth at estimate timestamps (within coverage)."""
    ok = (est_times >= gt_times[0]) & (est_times <= gt_times[-1])
    t = est_times[ok]
    return est_positions[ok], _interp(gt_times, gt_positions, t)


def umeyama_alignment(src: np.ndarray, dst: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """SE(3) (no scale) least-squares alignment: returns (R, t) with
    dst ~= src @ R.T + t."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    cov = (dst - mu_d).T @ (src - mu_s) / src.shape[0]
    u, _, vt = np.linalg.svd(cov)
    s = np.eye(3)
    if np.linalg.det(u @ vt) < 0:
        s[2, 2] = -1.0
    r = u @ s @ vt
    t = mu_d - r @ mu_s
    return r, t


def ate_rmse(
    est_positions: np.ndarray,
    gt_positions: np.ndarray,
    align: bool = True,
) -> float:
    """Absolute trajectory error (RMSE of position residuals)."""
    est = np.asarray(est_positions, np.float64)
    gt = np.asarray(gt_positions, np.float64)
    if align:
        r, t = umeyama_alignment(est, gt)
        est = est @ r.T + t
    d = est - gt
    return float(np.sqrt(np.mean(np.sum(d * d, axis=1))))


def rpe_rmse(
    est_positions: np.ndarray,
    gt_positions: np.ndarray,
    delta: int = 10,
) -> float:
    """Relative pose (translation) error over a fixed index delta: RMSE of
    the relative-displacement ERROR VECTOR norm (comparing only segment
    lengths would be blind to direction-only drift). Returns 0.0 for
    trajectories shorter than the delta."""
    est = np.asarray(est_positions, np.float64)
    gt = np.asarray(gt_positions, np.float64)
    if len(est) <= delta:
        return 0.0
    de = est[delta:] - est[:-delta]
    dg = gt[delta:] - gt[:-delta]
    d = np.linalg.norm(de - dg, axis=1)
    return float(np.sqrt(np.mean(d * d)))


def write_trajectory_csv(path: str, times, poses) -> None:
    """CSV export (WriteTrajectoryForDLIO format: time x y z qx qy qz qw)."""
    with open(path, "w") as f:
        for t, pose in zip(times, poses):
            q = np.asarray(pose.rotation)
            p = np.asarray(pose.translation)
            f.write(
                f"{t:.9f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                f"{q[1]:.9f} {q[2]:.9f} {q[3]:.9f} {q[0]:.9f}\n"
            )


def read_trajectory_csv(path: str):
    times, positions = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 4:
                continue
            times.append(float(parts[0]))
            positions.append([float(x) for x in parts[1:4]])
    return np.asarray(times), np.asarray(positions)


def _rotation_matrix(q: np.ndarray) -> np.ndarray:
    """Unit quaternion (w, x, y, z), normalized first -> 3x3 rotation."""
    w, x, y, z = q / max(float(np.linalg.norm(q)), 1e-12)
    return np.asarray([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def write_kitti_trajectory(path: str, poses) -> None:
    """KITTI odometry format: one row per pose, the 3x4 [R|t] matrix
    row-major (kitti_trajectory_from_pbstream.cc analog)."""
    with open(path, "w") as f:
        for p in poses:
            r = _rotation_matrix(np.asarray(p.rotation, np.float64))
            t = np.asarray(p.translation)
            m = np.hstack([r, t[:, None]]).reshape(-1)
            f.write(" ".join(f"{x:.9f}" for x in m) + "\n")


def write_tum_trajectory(path: str, times, poses) -> None:
    """TUM format: `t tx ty tz qx qy qz qw` (evo-compatible; the reference's
    dlio_eval_node.cc records the same fields from the pose topic)."""
    with open(path, "w") as f:
        for t, p in zip(times, poses):
            tr = np.asarray(p.translation)
            q = np.asarray(p.rotation)  # internal order wxyz
            f.write(
                f"{t:.6f} {tr[0]:.6f} {tr[1]:.6f} {tr[2]:.6f} "
                f"{q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {q[0]:.6f}\n"
            )
