"""IMU preintegration with midpoint integration and full 15x15 covariance
(port of dliom_tpu/imu/preintegration.py; reference VINS-Mono
IntegrationBase, integration_base.h:156-265).

Error-state order: [delta_p 0:3, delta_theta 3:6, delta_v 6:9, d_ba 9:12,
d_bg 12:15]. `integrate` builds every step's F and Q = V N V^T as one batch
and composes them with the affine-chain kernel K2 (imu/affine_chain.py);
`integrate_sequential` is the reference-shaped step-by-step ground truth.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch
from torch.func import vmap

from benchmark.reference.lio.common.config import ImuConfig
from benchmark.reference.lio.common.device import constant
from benchmark.reference.lio.imu.affine_chain import affine_chain
from benchmark.reference.lio.transform.rigid import (
    Rigid3,
    quat_from_axis_angle,
    quat_identity,
    quat_multiply,
    quat_normalize,
    quat_rotate,
    quat_to_rotation_matrix,
    so3_hat,
)


class Preintegrated(NamedTuple):
    delta_p: torch.Tensor  # (3,)
    delta_q: torch.Tensor  # (4,) wxyz
    delta_v: torch.Tensor  # (3,)
    jacobian: torch.Tensor  # (15, 15)
    covariance: torch.Tensor  # (15, 15)
    dt: torch.Tensor  # ()
    ba: torch.Tensor  # (3,) linearization accel bias
    bg: torch.Tensor  # (3,)
    acc0: torch.Tensor  # (3,) midpoint partner
    gyr0: torch.Tensor  # (3,)
    count: torch.Tensor  # () int32


def make_preintegrated(ba, bg, acc0, gyr0) -> Preintegrated:
    dev = ba.device
    f32 = dict(dtype=torch.float32, device=dev)
    return Preintegrated(
        delta_p=torch.zeros(3, **f32),
        delta_q=quat_identity(device=dev),  # a state leaf: its own tensor, not the shared constant
        delta_v=torch.zeros(3, **f32),
        jacobian=torch.eye(15, **f32),
        covariance=torch.zeros(15, 15, **f32),
        dt=torch.zeros((), **f32),
        ba=ba.to(torch.float32),
        bg=bg.to(torch.float32),
        acc0=acc0.to(torch.float32),
        gyr0=gyr0.to(torch.float32),
        count=torch.zeros((), dtype=torch.int32, device=dev),
    )


def noise_matrix(cfg: ImuConfig, device=None) -> torch.Tensor:
    """18x18 process noise: [acc_n, gyr_n, acc_n, gyr_n, ba_w, bg_w]^2."""
    d = constant(
        [cfg.acc_noise] * 3 + [cfg.gyr_noise] * 3 + [cfg.acc_noise] * 3
        + [cfg.gyr_noise] * 3 + [cfg.acc_bias_noise] * 3 + [cfg.gyr_bias_noise] * 3,
        device=device,
    )
    return torch.diag(d * d)


def _step_matrices(r0, r1, un_gyr, a0_b, a1_b, dt):
    """Batched (..., 15, 15) F and (..., 15, 18) V of midPointIntegration
    (integration_base.h:191-240) from per-step rotations and inputs."""
    rwx = so3_hat(un_gyr)
    ra0 = so3_hat(a0_b)
    ra1 = so3_hat(a1_b)
    eye3 = torch.eye(3, dtype=r0.dtype, device=r0.device)
    dtc = dt[..., None, None]
    ii = eye3.expand(r0.shape)
    zz = torch.zeros_like(r0)

    def brow(*blocks):
        return torch.cat(blocks, dim=-1)

    f01 = -0.25 * r0 @ ra0 * dtc * dtc + -0.25 * r1 @ ra1 @ (eye3 - rwx * dtc) * dtc * dtc
    f21 = -0.5 * r0 @ ra0 * dtc + -0.5 * r1 @ ra1 @ (eye3 - rwx * dtc) * dtc
    f = torch.cat(
        [
            brow(ii, f01, ii * dtc, -0.25 * (r0 + r1) * dtc * dtc, 0.25 * r1 @ ra1 * dtc * dtc * dtc),
            brow(zz, ii - rwx * dtc, zz, zz, -ii * dtc),
            brow(zz, f21, ii, -0.5 * (r0 + r1) * dtc, 0.5 * r1 @ ra1 * dtc * dtc),
            brow(zz, zz, zz, ii, zz),
            brow(zz, zz, zz, zz, ii),
        ],
        dim=-2,
    )
    v03 = -0.125 * r1 @ ra1 * dtc * dtc * dtc
    v63 = -0.25 * r1 @ ra1 * dtc * dtc
    v = torch.cat(
        [
            brow(0.25 * r0 * dtc * dtc, v03, 0.25 * r1 * dtc * dtc, v03, zz, zz),
            brow(zz, 0.5 * ii * dtc, zz, 0.5 * ii * dtc, zz, zz),
            brow(0.5 * r0 * dtc, v63, 0.5 * r1 * dtc, v63, zz, zz),
            brow(zz, zz, zz, zz, ii * dtc, zz),
            brow(zz, zz, zz, zz, zz, ii * dtc),
        ],
        dim=-2,
    )
    return f, v


def _midpoint_step(pre: Preintegrated, dt, acc1, gyr1, noise) -> Preintegrated:
    """One midPointIntegration step (integration_base.h:173-265)."""
    ba, bg = pre.ba, pre.bg
    un_gyr = 0.5 * (pre.gyr0 + gyr1) - bg
    new_dq = quat_normalize(quat_multiply(pre.delta_q, quat_from_axis_angle(un_gyr * dt)))
    un_acc = 0.5 * (quat_rotate(pre.delta_q, pre.acc0 - ba) + quat_rotate(new_dq, acc1 - ba))
    new_dp = pre.delta_p + pre.delta_v * dt + 0.5 * un_acc * dt * dt
    new_dv = pre.delta_v + un_acc * dt
    f, v = _step_matrices(
        quat_to_rotation_matrix(pre.delta_q), quat_to_rotation_matrix(new_dq),
        un_gyr, pre.acc0 - ba, acc1 - ba, dt,
    )
    return pre._replace(
        delta_p=new_dp,
        delta_q=new_dq,
        delta_v=new_dv,
        jacobian=f @ pre.jacobian,
        covariance=f @ pre.covariance @ f.T + v @ noise @ v.T,
        dt=pre.dt + dt,
        acc0=acc1,
        gyr0=gyr1,
        count=pre.count + 1,
    )


def integrate_sequential(pre: Preintegrated, dts, accs, gyrs, mask, noise) -> Preintegrated:
    """Reference-shaped sequential integration (propagate, :266-292)."""
    for i in range(dts.shape[0]):
        new = _midpoint_step(pre, dts[i], accs[i], gyrs[i], noise)
        ok = mask[i]
        pre = Preintegrated(*(torch.where(ok, a, b) for a, b in zip(new, pre)))
    return pre


def _prefix_quat_product(steps: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix Hamilton product over axis 0 in log2(M) doubling
    rounds; each combine renormalizes, as the sequential chain does."""
    prefix = steps
    shift = 1
    m = steps.shape[0]
    while shift < m:
        combined = quat_normalize(quat_multiply(prefix[:-shift], prefix[shift:]))
        prefix = torch.cat([prefix[:shift], combined], dim=0)
        shift *= 2
    return prefix


def integrate(pre: Preintegrated, dts, accs, gyrs, mask, noise) -> Preintegrated:
    """Batched integration, numerically equivalent to the sequential path.
    `mask` must be a prefix mask (valid samples first). Over a leading lane
    axis (B lanes: `pre`'s fields (B, ·), samples (B, M, ·)) the steps and
    the close are vmapped and K2 composes all B chains in one call."""
    if dts.dim() == 2:
        f, q_noise, partial = vmap(functools.partial(_chain_inputs, noise=noise))(
            pre, dts, accs, gyrs, mask)
        f_total, q_total = affine_chain(f, q_noise)
        return vmap(_chain_close)(pre, partial, f_total, q_total)
    f, q_noise, partial = _chain_inputs(pre, dts, accs, gyrs, mask, noise)
    f_total, q_total = affine_chain(f, q_noise)
    return _chain_close(pre, partial, f_total, q_total)


def _chain_inputs(pre: Preintegrated, dts, accs, gyrs, mask, noise):
    """The rotation, velocity and position chains of one bridge, and its
    (M, 15, 15) F and Q for K2 (masked samples as (I, 0))."""
    okf = mask.to(torch.float32)[:, None]
    dt = torch.where(mask, dts, 0.0)
    ba, bg = pre.ba, pre.bg
    acc_prev = torch.cat([pre.acc0[None], accs[:-1]], dim=0)
    gyr_prev = torch.cat([pre.gyr0[None], gyrs[:-1]], dim=0)

    # 1. quaternion chain: prefix product of the per-step increments
    un_gyr = 0.5 * (gyr_prev + gyrs) - bg
    dq_steps = quat_from_axis_angle(un_gyr * dt[:, None])
    ident = constant([1.0, 0.0, 0.0, 0.0], dq_steps.dtype, dq_steps.device)
    steps = torch.where(mask[:, None], dq_steps, ident)
    q_all = quat_normalize(quat_multiply(pre.delta_q[None], _prefix_quat_product(steps)))
    q_final = q_all[-1]
    q_prev = torch.cat([pre.delta_q[None], q_all[:-1]], dim=0)

    # 2. translation / velocity chains as cumulative sums
    un_acc = 0.5 * (quat_rotate(q_prev, acc_prev - ba) + quat_rotate(q_all, accs - ba)) * okf
    v_all = pre.delta_v + torch.cumsum(un_acc * dt[:, None], dim=0)
    v_prev = torch.cat([pre.delta_v[None], v_all[:-1]], dim=0)
    dp_steps = v_prev * dt[:, None] + 0.5 * un_acc * (dt * dt)[:, None]
    p_final = pre.delta_p + torch.sum(dp_steps, dim=0)
    v_final = v_all[-1]

    # 3. batched F / V, then the affine chain (kernel K2 on CUDA)
    f, v = _step_matrices(
        quat_to_rotation_matrix(q_prev), quat_to_rotation_matrix(q_all),
        un_gyr, acc_prev - ba, accs - ba, dt,
    )
    q_noise = v @ noise @ v.transpose(1, 2)
    eye15 = torch.eye(15, dtype=torch.float32, device=f.device)
    f = torch.where(mask[:, None, None], f, eye15)
    q_noise = torch.where(mask[:, None, None], q_noise, 0.0)
    n_valid = torch.sum(mask, dtype=torch.int32)
    last = torch.clamp(n_valid - 1, min=0).reshape(1)
    has = n_valid > 0
    partial = pre._replace(
        delta_p=p_final,
        delta_q=q_final,
        delta_v=v_final,
        dt=pre.dt + torch.sum(dt),
        acc0=torch.where(has, accs.index_select(0, last)[0], pre.acc0),
        gyr0=torch.where(has, gyrs.index_select(0, last)[0], pre.gyr0),
        count=pre.count + n_valid,
    )
    return f, q_noise, partial


def _chain_close(pre: Preintegrated, partial: Preintegrated, f_total, q_total) -> Preintegrated:
    """`partial` with the jacobian and covariance carried through K2's
    (A, P) of the bridge."""
    return partial._replace(
        jacobian=f_total @ pre.jacobian,
        covariance=f_total @ pre.covariance @ f_total.T + q_total,
    )


class NavState(NamedTuple):
    """World-frame navigation state (gtsam::NavState analog)."""

    rotation: torch.Tensor  # (4,) wxyz, body->world
    position: torch.Tensor  # (3,)
    velocity: torch.Tensor  # (3,)

    @property
    def pose(self) -> Rigid3:
        return Rigid3(self.rotation, self.position)

    @staticmethod
    def identity(device=None) -> "NavState":
        return NavState(
            torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float32, device=device),
            torch.zeros(3, dtype=torch.float32, device=device),
            torch.zeros(3, dtype=torch.float32, device=device),
        )


def predict(state: NavState, pre: Preintegrated, gravity: float) -> NavState:
    """Forward prediction with world gravity (0, 0, -gravity)."""
    g = constant([0.0, 0.0, -gravity], device=pre.dt.device)
    dt = pre.dt
    rot = state.rotation
    return NavState(
        rotation=quat_normalize(quat_multiply(rot, pre.delta_q)),
        position=state.position + state.velocity * dt + 0.5 * g * dt * dt
        + quat_rotate(rot, pre.delta_p),
        velocity=state.velocity + g * dt + quat_rotate(rot, pre.delta_v),
    )


def bias_corrected_deltas(pre: Preintegrated, ba, bg) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """First-order bias-corrected (delta_p, delta_q, delta_v)
    (integration_base.h evaluate())."""
    dba = ba - pre.ba
    dbg = bg - pre.bg
    jac = pre.jacobian

    def mv(block, x):
        return torch.sum(block * x[..., None, :], dim=-1)

    corrected_p = pre.delta_p + mv(jac[..., 0:3, 9:12], dba) + mv(jac[..., 0:3, 12:15], dbg)
    corrected_v = pre.delta_v + mv(jac[..., 6:9, 9:12], dba) + mv(jac[..., 6:9, 12:15], dbg)
    corrected_q = quat_normalize(
        quat_multiply(pre.delta_q, quat_from_axis_angle(mv(jac[..., 3:6, 12:15], dbg)))
    )
    return corrected_p, corrected_q, corrected_v
