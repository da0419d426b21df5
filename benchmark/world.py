"""The benchmark's synthetic world and IMU, made on the device from the seed.

A frozen copy of `dliom_tpu_torch/io/synthetic.py`'s `SyntheticWorld` and
`ImuSimulator` (the reference fixture of local_trajectory_builder_3d_test.cc:
a 30 m box holding spherical bubbles, scanned by 16-beam rangefinders),
rewritten to work in batches on the device: a whole lap of scans is cast in
a few calls at set-up, and the IMU samples of every interval are made at
once. The arithmetic is the original's, in float64, so at equal inputs the
two agree to rounding (benchmark/tests/test_benchmark_world.py).

The course is a closed circle at constant speed, a whole number of scans a
lap, so that cycling the lap keeps the trajectory continuous.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

BOX_HALF = 15.0
BUBBLE_RADIUS = 0.5
CAST_BLOCK_RAYS = 1 << 22  # rays x bubbles per block of the cast, to bound its memory


def bubbles(num_bubbles: int, seed: int) -> np.ndarray:
    """(B, 3) bubble centres, as SyntheticWorld.create draws them."""
    rng = np.random.default_rng(seed)
    v = rng.uniform(-1.0, 1.0, size=(num_bubbles, 3))
    v /= np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-9)
    return 10.0 * v


def directions(num_beams: int, num_azimuths: int, two_rangefinders: bool) -> np.ndarray:
    """(R, 3) unit rays in the sensor frame, as SyntheticWorld.create makes
    them: beams spread +-15 degrees in elevation, azimuths over the circle,
    and a second rangefinder turned 90 degrees about x."""
    rs = np.arange(-num_beams // 2, num_beams // 2)
    ss = np.arange(-num_azimuths // 2, num_azimuths // 2)
    az, el = np.meshgrid(np.pi * ss / (num_azimuths // 2), np.pi / 12.0 * rs / (num_beams // 2),
                         indexing="ij")
    d = np.stack([np.cos(az) * np.cos(el), np.sin(az) * np.cos(el), -np.sin(el)], axis=-1).reshape(-1, 3)
    if two_rangefinders:
        rot_x = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]])
        d = np.concatenate([d, d @ rot_x.T])
    return d.astype(np.float32)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) (w, x, y, z) quaternions -> (..., 3, 3) rotation matrices."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def cast(bubble_centres: torch.Tensor, rays: torch.Tensor, rotations: torch.Tensor,
         translations: torch.Tensor) -> torch.Tensor:
    """Ray-cast S scans at once: (S, 4) rotations and (S, 3) translations of
    the sensor -> (S, R, 3) float32 points in the sensor frame (the
    original's `cast_scan`, its per-point times all 0)."""
    f64 = torch.float64
    rmat = quat_to_matrix(rotations.to(f64))  # (S, 3, 3)
    origin = translations.to(f64)  # (S, 3)
    d = rays.to(f64) @ rmat.transpose(-1, -2)  # (S, R, 3) world directions
    t_box = torch.full(d.shape[:-1], 1e9, dtype=f64, device=d.device)
    for axis in range(3):
        da = d[..., axis]
        o = origin[:, None, axis]
        pos = (BOX_HALF - o) / da
        neg = (-BOX_HALF - o) / da
        cand = torch.where(da > 0, pos, torch.where(da < 0, neg, torch.full_like(da, 1e9)))
        t_box = torch.minimum(t_box, cand)
    oc = origin[:, None, :] - bubble_centres.to(f64)[None]  # (S, B, 3)
    c = torch.sum(oc * oc, dim=-1) - BUBBLE_RADIUS ** 2  # (S, B)
    n_rays, n_bub = d.shape[1], oc.shape[1]
    step = max(1, CAST_BLOCK_RAYS // max(1, n_bub))
    t_bub = torch.empty_like(t_box)
    for lo in range(0, n_rays, step):
        beta = d[:, lo:lo + step] @ oc.transpose(-1, -2)  # (S, r, B)
        disc = beta * beta - c[:, None, :]
        root = -beta - torch.sqrt(torch.clamp(disc, min=0.0))
        root = torch.where((disc >= 0.0) & (root > 0.0), root, torch.full_like(root, 1e9))
        t_bub[:, lo:lo + step] = torch.amin(root, dim=-1)
    t = torch.minimum(t_box, t_bub)
    world = origin[:, None, :] + t[..., None] * d
    return ((world - origin[:, None, :]) @ rmat).to(torch.float32)


class Course(NamedTuple):
    """A circle of `radius` m about (0, radius, 0), driven at `speed` m/s,
    heading along its tangent, `lap_scans` scans a lap."""

    radius: float
    lap_scans: int
    scan_period: float

    @property
    def speed(self) -> float:
        return 2.0 * math.pi * self.radius / (self.lap_scans * self.scan_period)

    def angle(self, k) -> torch.Tensor:
        """Heading at scan k (k = 0 at the start), float64."""
        return torch.as_tensor(k, dtype=torch.float64) * (2.0 * math.pi / self.lap_scans)

    def pose(self, k):
        """(rotation (..., 4), translation (..., 3), velocity (..., 3)) at scan k, float64."""
        ang = self.angle(k)
        zero = torch.zeros_like(ang)
        rot = torch.stack([torch.cos(ang / 2), zero, zero, torch.sin(ang / 2)], -1)
        pos = torch.stack([self.radius * torch.sin(ang), self.radius * (1.0 - torch.cos(ang)), zero], -1)
        vel = torch.stack([self.speed * torch.cos(ang), self.speed * torch.sin(ang), zero], -1)
        return rot, pos, vel


def _slerp(a: torch.Tensor, b: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Slerp of (..., 4) quaternions at fractions s (...), as the original's."""
    d = torch.sum(a * b, dim=-1, keepdim=True)
    b = torch.where(d < 0, -b, b)
    d = torch.abs(d)
    th = torch.arccos(torch.clamp(d, -1.0, 1.0))
    s = s[..., None]
    near = d > 1.0 - 1e-9
    sin_th = torch.where(near, torch.ones_like(th), torch.sin(th))
    out = torch.where(near, a + s * (b - a), (torch.sin((1 - s) * th) * a + torch.sin(s * th) * b) / sin_th)
    return out / torch.linalg.vector_norm(out, dim=-1, keepdim=True)


def _quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    w1, x1, y1, z1 = a.unbind(-1)
    w2, x2, y2, z2 = b.unbind(-1)
    return torch.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2, w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2, w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], -1)


def _quat_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    q = torch.where(q[..., :1] < 0, -q, q)
    v = q[..., 1:]
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    safe = torch.clamp(n, min=1e-300)
    return torch.where(n < 1e-12, 2.0 * v, 2.0 * torch.atan2(n, q[..., :1]) * v / safe)


def imu_between(rot_a, rot_b, vel_a, vel_b, dt_total: float, rate: float, gravity: float):
    """Noise-free IMU samples over each interval (the original's
    `ImuSimulator.between` before its noise): constant body rate and
    constant world acceleration, gravity added. Inputs (I, 4) and (I, 3)
    float64; returns (dt, acc (I, n, 3), gyr (I, n, 3)) with n samples."""
    n = max(2, int(round(dt_total * rate)))
    sub = dt_total / n
    dq = _quat_mul(rot_a * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=rot_a.dtype, device=rot_a.device),
                   rot_b)
    omega = _quat_to_axis_angle(dq) / dt_total  # (I, 3)
    a_world = (vel_b - vel_a) / dt_total
    g_world = torch.tensor([0.0, 0.0, -gravity], dtype=rot_a.dtype, device=rot_a.device)
    s = (torch.arange(n, dtype=rot_a.dtype, device=rot_a.device) + 0.5) / n  # (n,)
    q_t = _slerp(rot_a[:, None, :].expand(-1, n, -1), rot_b[:, None, :].expand(-1, n, -1), s.expand(rot_a.shape[0], n))
    acc = (quat_to_matrix(q_t).transpose(-1, -2) @ (a_world - g_world)[:, None, :, None])[..., 0]
    gyr = omega[:, None, :].expand(-1, n, -1)
    return sub, acc, gyr
