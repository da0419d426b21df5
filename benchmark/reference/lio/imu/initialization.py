"""IMU initialization (port of dliom_tpu/imu/initialization.py):

  * `static_initialize` — InitializeStatic (local_trajectory_builder_3d.cc:
    203-229): average buffered IMU samples into the gravity-aligned initial
    rotation and the biases;
  * `approximate_gravity` / `refine_gravity` / `initialize_dynamic` — the
    VINS-style linear alignment (initialization/imu_lidar_initializer.cc:
    50-229): per-frame body velocities and gravity from odometry poses and
    IMU preintegrations, then a norm-constrained re-solve on the gravity
    tangent basis;
  * `estimate_gravity` — the online sliding-window gravity estimator
    (gravity_factor/gravity_estimator.cc:20-170).

The systems are a few dozen unknowns, solved densely in f32 with the JAX
package's 1000x scaling and 1e-6 ridge."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from benchmark.reference.lio.common.device import constant
from benchmark.reference.lio.ops.segment import segment_sum
from benchmark.reference.lio.transform.rigid import (
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
    ex = constant([1.0, 0.0, 0.0], g0.dtype, g0.device)
    ez = constant([0.0, 0.0, 1.0], g0.dtype, g0.device)
    tmp = torch.where(torch.abs(a[2]) > 1.0 - 1e-6, ex, ez)
    b = tmp - a * torch.dot(a, tmp)
    b = b / torch.clamp(_norm(b), min=1e-12)
    return torch.stack([b, _cross(a, b)], dim=1)


def _solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_ex(a, b[:, None], check_errors=False).result[:, 0]


def _pair_terms(inp: AlignmentInput):
    """Per pair (i, i+1): R_i, R_j, R_i^T, t_i, t_j, dt, dp, dv, mask."""
    r = quat_to_rotation_matrix(inp.rotations)
    return (r[:-1], r[1:], r[:-1].transpose(-1, -2), inp.translations[:-1], inp.translations[1:],
            inp.dts[1:], inp.delta_p[1:], inp.delta_v[1:], inp.pair_mask[1:].to(torch.float32))


def _normal_equations(blk: torch.Tensor, rhs: torch.Tensor,
                      m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked per-pair blocks (K, 6, 3+3+g) over [v_i, v_j, g] -> the
    scaled, ridged dense system over [v_0 .. v_W-1, g], the pairs' terms
    added in pair order."""
    k, _, cols = blk.shape
    g_dim = cols - 6
    n = 3 * (k + 1) + g_dim
    dev = blk.device
    blk = blk * m[:, None, None]
    rhs = rhs * m[:, None]
    ra = blk.transpose(1, 2) @ blk
    rb = (blk.transpose(1, 2) @ rhs[:, :, None])[..., 0]
    sl = torch.cat([3 * torch.arange(k, device=dev)[:, None] + torch.arange(6, device=dev),
                    (n - g_dim + torch.arange(g_dim, device=dev)).expand(k, g_dim)], dim=1)
    big_a = segment_sum(ra.reshape(-1), (sl[:, :, None] * n + sl[:, None, :]).reshape(-1), n * n).reshape(n, n)
    big_b = segment_sum(rb.reshape(-1), sl.reshape(-1), n)
    return big_a * 1000.0 + 1e-6 * torch.eye(n, dtype=torch.float32, device=dev), big_b * 1000.0


def _mv(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.einsum("kij,kj->ki", a, v)


def approximate_gravity(inp: AlignmentInput, tlb_pose: Rigid3,
                        g_norm: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Linear alignment (imu_lidar_initializer.cc:50-123): unknowns
    [v_0 .. v_W-1 (body frame), g]. Returns (g, velocities, ok)."""
    w = inp.rotations.shape[0]
    ri, rj, rit, ti, tj, dt, dp, dv, m = _pair_terms(inp)
    tlb = tlb_pose.translation
    eye = torch.eye(3, dtype=torch.float32, device=dt.device).expand(ri.shape)
    zero = torch.zeros_like(ri)
    b_p = dp + _mv(rit @ rj, tlb.expand(dp.shape)) - tlb - _mv(rit, tj - ti)
    blk = torch.cat([
        torch.cat([-dt[:, None, None] * eye, zero, rit * (0.5 * dt * dt)[:, None, None]], dim=2),
        torch.cat([-eye, rit @ rj, rit * dt[:, None, None]], dim=2),
    ], dim=1)
    x = _solve(*_normal_equations(blk, torch.cat([b_p, dv], dim=1), m))
    g = x[3 * w:]
    return g, x[: 3 * w].reshape(w, 3), torch.abs(_norm(g) - g_norm) < 1.0


def refine_gravity(inp: AlignmentInput, tlb_pose: Rigid3, g_norm: float,
                   g_approx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Norm-constrained refinement on the gravity tangent basis, 4 rounds
    (imu_lidar_initializer.cc:126-210). Returns (g, velocities)."""
    w = inp.rotations.shape[0]
    ri, rj, rit, ti, tj, dt, dp, dv, m = _pair_terms(inp)
    tlb = tlb_pose.translation
    eye = torch.eye(3, dtype=torch.float32, device=dt.device).expand(ri.shape)
    zero = torch.zeros_like(ri)
    half_dt2 = 0.5 * dt * dt
    g0 = g_approx / torch.clamp(_norm(g_approx), min=1e-12) * g_norm
    vs = torch.zeros(w, 3, dtype=torch.float32, device=dt.device)
    for _ in range(4):
        lxly = tangent_basis(g0)
        rl = rit @ lxly
        blk = torch.cat([
            torch.cat([-dt[:, None, None] * eye, zero, rl * half_dt2[:, None, None]], dim=2),
            torch.cat([-eye, rit @ rj, rl * dt[:, None, None]], dim=2),
        ], dim=1)
        bp = (dp + _mv(rit @ rj, tlb.expand(dp.shape)) - tlb - _mv(rit, half_dt2[:, None] * g0)
              - _mv(rit, tj - ti))
        bv = dv - _mv(rit, dt[:, None] * g0)
        x = _solve(*_normal_equations(blk, torch.cat([bp, bv], dim=1), m))
        g_new = g0 + lxly @ x[3 * w:]
        g0 = g_new / torch.clamp(_norm(g_new), min=1e-12) * g_norm
        vs = x[: 3 * w].reshape(w, 3)
    return g0, vs


def initialize_dynamic(inp: AlignmentInput, tlb_pose: Rigid3,
                       g_norm: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Initializer::Initialization (imu_lidar_initializer.cc:213-229): the
    approximate solve, the refinement, and the success check. The refined
    g has norm g_norm by construction, so the check rejects a refinement
    that swings more than ~25 degrees from the approximate direction.
    Returns (g, velocities, ok)."""
    g, _, ok0 = approximate_gravity(inp, tlb_pose, g_norm)
    g_ref, vs = refine_gravity(inp, tlb_pose, g_norm, g)
    cos = torch.dot(g_ref, g) / torch.clamp(_norm(g_ref) * _norm(g), min=1e-12)
    return g_ref, vs, ok0 & (cos > 0.9)


def estimate_gravity(inp: AlignmentInput, velocities: torch.Tensor, tlb_pose: Rigid3,
                     g_norm: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gravity with known body-frame velocities. Returns (g, ok)."""
    ri, rj, rit, ti, tj, dt, dp, dv, m = _pair_terms(inp)
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
