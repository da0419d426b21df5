"""IMU initialization (port of the parts of dliom_tpu/imu/initialization.py
that MapBuilder and `lio.py::_window_gravity` use):

  * `static_initialize` — InitializeStatic (local_trajectory_builder_3d.cc:
    203-229): average buffered IMU samples into the gravity-aligned initial
    rotation and the biases;
  * `estimate_gravity` — the online sliding-window gravity estimator
    (gravity_factor/gravity_estimator.cc:20-170).

The dynamic (linear-alignment) initializer is not ported yet."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from dliom_tpu_torch.transform.rigid import (
    Rigid3,
    _cross,
    _norm,
    quat_from_two_vectors,
    quat_inverse_rotate,
    quat_to_rotation_matrix,
)


class AlignmentInput(NamedTuple):
    """W odometry frames with preintegrations between them; pair (i, i+1)
    quantities are stored at index i+1."""

    rotations: torch.Tensor  # (W, 4)
    translations: torch.Tensor  # (W, 3)
    delta_p: torch.Tensor  # (W, 3)
    delta_v: torch.Tensor  # (W, 3)
    dts: torch.Tensor  # (W,)
    pair_mask: torch.Tensor  # (W,)


def static_initialize(accs: torch.Tensor, gyrs: torch.Tensor, mask: torch.Tensor,
                      gravity_norm: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(M, 3) accelerometer and gyro samples with a (M,) mask -> (rotation
    quaternion body->world, accel bias, gyro bias)."""
    w = mask.to(torch.float32)[:, None]
    n = torch.clamp(torch.sum(w), min=1.0)
    accel_mean = torch.sum(accs * w, dim=0) / n
    gyro_mean = torch.sum(gyrs * w, dim=0) / n
    g_vec = torch.tensor([0.0, 0.0, -gravity_norm], dtype=torch.float32, device=accs.device)
    # R maps the measured specific force onto +z*g (frame I to frame G)
    rot = quat_from_two_vectors(accel_mean, -g_vec)
    ba = quat_inverse_rotate(rot, g_vec) + accel_mean
    return rot, ba, gyro_mean


def tangent_basis(g0: torch.Tensor) -> torch.Tensor:
    """(3, 2) basis of the tangent plane at direction g0 (TangentBasis)."""
    a = g0 / torch.clamp(_norm(g0), min=1e-12)
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=g0.dtype, device=g0.device)
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=g0.dtype, device=g0.device)
    tmp = torch.where(torch.abs(a[2]) > 1.0 - 1e-6, ex, ez)
    b = tmp - a * torch.dot(a, tmp)
    b = b / torch.clamp(_norm(b), min=1e-12)
    return torch.stack([b, _cross(a, b)], dim=1)


def _solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_ex(a, b[:, None], check_errors=False).result[:, 0]


def estimate_gravity(inp: AlignmentInput, velocities: torch.Tensor, tlb_pose: Rigid3,
                     g_norm: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gravity with known body-frame velocities. Returns (g, ok)."""
    r = quat_to_rotation_matrix(inp.rotations)
    ri, rj = r[:-1], r[1:]
    rit = ri.transpose(-1, -2)
    ti, tj = inp.translations[:-1], inp.translations[1:]
    dt = inp.dts[1:]
    dp, dv = inp.delta_p[1:], inp.delta_v[1:]
    m = inp.pair_mask[1:].to(torch.float32)
    tlb = tlb_pose.translation
    vs_i, vs_j = velocities[:-1], velocities[1:]
    eye = lambda n: torch.eye(n, dtype=torch.float32, device=dt.device)  # noqa: E731

    a_p = rit * (0.5 * dt * dt)[:, None, None]
    b_p = (
        dp
        + torch.einsum("kij,kj->ki", rit @ rj, tlb.expand(dp.shape))
        - tlb
        - torch.einsum("kij,kj->ki", rit, tj - ti)
        + dt[:, None] * vs_i
    )
    a_v = rit * dt[:, None, None]
    b_v = dv + vs_i - torch.einsum("kij,kj->ki", rit @ rj, vs_j)

    mm = m[:, None, None]
    big_a = torch.sum(a_p.transpose(1, 2) @ a_p * mm + a_v.transpose(1, 2) @ a_v * mm, dim=0)
    big_b = torch.sum(
        torch.einsum("kji,kj->ki", a_p, b_p * m[:, None])
        + torch.einsum("kji,kj->ki", a_v, b_v * m[:, None]),
        dim=0,
    )
    g = _solve(big_a * 1000.0 + 1e-6 * eye(3), big_b * 1000.0)
    ok = torch.abs(_norm(g) - g_norm) < 0.5

    def one_round(g0):
        lxly = tangent_basis(g0)
        ap2 = a_p @ lxly
        av2 = a_v @ lxly
        bp2 = b_p - torch.einsum("kij,j->ki", a_p, g0)
        bv2 = b_v - torch.einsum("kij,j->ki", a_v, g0)
        aa = torch.sum(ap2.transpose(1, 2) @ ap2 * mm + av2.transpose(1, 2) @ av2 * mm, dim=0)
        bb = torch.sum(
            torch.einsum("kji,kj->ki", ap2, bp2 * m[:, None])
            + torch.einsum("kji,kj->ki", av2, bv2 * m[:, None]),
            dim=0,
        )
        g_new = g0 + lxly @ _solve(aa * 1000.0 + 1e-6 * eye(2), bb * 1000.0)
        return g_new / torch.clamp(_norm(g_new), min=1e-12) * g_norm

    g0 = g / torch.clamp(_norm(g), min=1e-12) * g_norm
    for _ in range(4):
        g0 = one_round(g0)
    return g0, ok
