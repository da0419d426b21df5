"""Synthetic world generator for end-to-end fidelity tests and benches
(numpy copy of the world and trajectory of dliom_tpu/io/synthetic.py,
with no jax).

Host-side (numpy) port of the reference's canonical test fixture
(`cartographer/mapping/internal/3d/local_trajectory_builder_3d_test.cc:40-283`):
a 30 m box containing 100 spherical "bubbles" of radius 0.5, scanned by two
orthogonal 16-beam 360-degree rangefinders along an analytic trajectory.
Ray casting is vectorized numpy rather than per-ray loops.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from dliom_tpu_torch.transform.rigid import Rigid3, np_quat_from_axis_angle

BOX_HALF = 15.0
BUBBLE_RADIUS = 0.5


def _np_quat_to_matrix(q: np.ndarray) -> np.ndarray:
    """(w,x,y,z) quaternion -> 3x3 rotation matrix, pure numpy."""
    w, x, y, z = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


@dataclass
class SyntheticWorld:
    bubbles: np.ndarray  # (B, 3)
    directions: np.ndarray  # (R, 3) unit rays in the rangefinder frame

    @staticmethod
    def create(
        num_bubbles: int = 100,
        num_beams: int = 16,
        num_azimuths: int = 500,
        seed: int = 42,
        two_rangefinders: bool = True,
    ) -> "SyntheticWorld":
        rng = np.random.default_rng(seed)
        v = rng.uniform(-1.0, 1.0, size=(num_bubbles, 3))
        v /= np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-9)
        bubbles = 10.0 * v

        # 16 beams spread +-15 deg in elevation x 500 azimuths (the fixture's
        # r in [-8,8) x s in [-250,250)).
        rs = np.arange(-num_beams // 2, num_beams // 2)
        ss = np.arange(-num_azimuths // 2, num_azimuths // 2)
        az, el = np.meshgrid(
            np.pi * ss / (num_azimuths // 2), np.pi / 12.0 * rs / (num_beams // 2),
            indexing="ij",
        )
        d = np.stack(
            [
                np.cos(az) * np.cos(el),
                np.sin(az) * np.cos(el),
                -np.sin(el),
            ],
            axis=-1,
        ).reshape(-1, 3)
        if two_rangefinders:
            # Second orthogonal rangefinder: rotate 90 deg about x.
            rot_x = np.array(
                [[1.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]]
            )
            d = np.concatenate([d, d @ rot_x.T])
        return SyntheticWorld(bubbles=bubbles, directions=d.astype(np.float32))

    def cast_scan(self, pose: Rigid3) -> Tuple[np.ndarray, np.ndarray]:
        """Ray-cast one scan from `pose`. Returns (points_in_tracking (N,3),
        relative_times (N,)). Pure numpy — host data generation must never
        dispatch device ops."""
        rmat = _np_quat_to_matrix(np.asarray(pose.rotation, np.float64))
        origin = np.asarray(pose.translation, np.float64)
        d = self.directions.astype(np.float64) @ rmat.T  # (R, 3) world dirs

        # Box intersection: first axis-plane hit along +t.
        with np.errstate(divide="ignore", invalid="ignore"):
            t_box = np.full(d.shape[0], 1e9)
            for axis in range(3):
                pos = (BOX_HALF - origin[axis]) / d[:, axis]
                neg = (-BOX_HALF - origin[axis]) / d[:, axis]
                cand = np.where(d[:, axis] > 0, pos, np.where(d[:, axis] < 0, neg, 1e9))
                t_box = np.minimum(t_box, cand)

        # Bubble intersection: smallest positive root per ray over all bubbles.
        oc = origin[None, :] - self.bubbles  # (B, 3)
        beta = d @ oc.T  # (R, B)
        c = np.sum(oc * oc, axis=-1)[None, :] - BUBBLE_RADIUS**2  # (1, B)
        disc = beta * beta - c
        root = -beta - np.sqrt(np.maximum(disc, 0.0))
        root = np.where((disc >= 0.0) & (root > 0.0), root, 1e9)
        t_bub = np.min(root, axis=1)

        t = np.minimum(t_box, t_bub)
        world = origin[None, :] + t[:, None] * d
        rot_inv = (world - origin[None, :]) @ rmat  # back to tracking frame
        n = rot_inv.shape[0]
        # The fixture produces an instantaneous snapshot (per-point time 0,
        # GenerateRangeData). Sweep simulation for deskew tests sets
        # `sweep_period` instead.
        times = np.zeros(n, np.float32)
        return rot_inv.astype(np.float32), times


def corkscrew_trajectory() -> List[Tuple[float, Rigid3]]:
    """The fixture's trajectory (local_trajectory_builder_3d_test.cc:230-247):
    1.5 s at rest, then a corkscrew translation + slow rotation."""
    out: List[Tuple[float, Rigid3]] = []
    t = 0.0
    for _ in range(5):
        t += 0.3
        out.append((t, Rigid3(np.asarray([1.0, 0.0, 0.0, 0.0], np.float32), np.zeros(3, np.float32))))
    axis = np.array([1.0, -1.0, 2.0])
    axis /= np.linalg.norm(axis)
    for tau in np.arange(0.0, 0.6 + 1e-9, 0.05):
        t += 0.3
        pose = Rigid3(
            rotation=np_quat_from_axis_angle(0.3 * tau * axis).astype(np.float32),
            translation=np.asarray(
                [np.sin(4.0 * tau), 1.0 - np.cos(4.0 * tau), 1.0 * tau],
                np.float32,
            ),
        )
        out.append((t, pose))
    return out
