"""Tightly-coupled sliding-window factor-graph optimizer (port of
dliom_tpu/imu/window_optimizer.py; reference
LocalTrajectoryBuilder3D::WindowOptimize, local_trajectory_builder_3d.cc:693-863).

A dense window of W keys (q, p, v, ba, bg) with, per key, an IMU factor to
its predecessor (15-dim, VINS evaluate() form + bias random walk), a
scan-match pose prior, an optional gravity attitude factor, and an
information-form prior on the head. Gauss-Newton with a fixed iteration
count. `optimize_plain` takes the Jacobian with `torch.func.jacfwd` over the
15W tangent and evaluates the per-key factors as one batch each; on the
card `optimize` runs all iterations as one launch of K3
(`csrc/window_gn.cu`), one block per lane, for a window with or without a
leading lane axis.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch
from torch.func import jacfwd, vmap

from dliom_tpu_torch import kernels
from dliom_tpu_torch.common import launches
from dliom_tpu_torch.common.config import ImuConfig
from dliom_tpu_torch.common.device import constant
from dliom_tpu_torch.imu.preintegration import NavState, Preintegrated, bias_corrected_deltas
from dliom_tpu_torch.mapping.brick_grid import _take
from dliom_tpu_torch.transform.rigid import (
    Rigid3,
    _cross,
    _norm,
    quat_conjugate,
    quat_from_axis_angle,
    quat_inverse_rotate,
    quat_multiply,
    quat_normalize,
    quat_remove_yaw,
    quat_rotate,
    quat_to_axis_angle,
)

KEY_DIM = 15

# K3 launches through `optimize` (plain-version calls not counted).
LAUNCHES = 0


class WindowState(NamedTuple):
    """Dense sliding window; index 0 = oldest key."""

    q: torch.Tensor  # (W, 4)
    p: torch.Tensor  # (W, 3)
    v: torch.Tensor  # (W, 3)
    ba: torch.Tensor  # (W, 3)
    bg: torch.Tensor  # (W, 3)
    obs_q: torch.Tensor  # (W, 4)
    obs_t: torch.Tensor  # (W, 3)
    obs_drift: torch.Tensor  # (W,) bool
    obs_valid: torch.Tensor  # (W,) bool
    pre_p: torch.Tensor  # (W, 3)
    pre_q: torch.Tensor  # (W, 4)
    pre_v: torch.Tensor  # (W, 3)
    pre_jac: torch.Tensor  # (W, 15, 15)
    pre_sqrt_info: torch.Tensor  # (W, 9, 9)
    pre_ba: torch.Tensor  # (W, 3)
    pre_bg: torch.Tensor  # (W, 3)
    pre_dt: torch.Tensor  # (W,)
    grav_dir: torch.Tensor  # (W, 3)
    grav_valid: torch.Tensor  # (W,) bool
    prior_sqrt_info: torch.Tensor  # (15, 15)
    prior_q: torch.Tensor  # (4,)
    prior_p: torch.Tensor  # (3,)
    prior_v: torch.Tensor  # (3,)
    prior_ba: torch.Tensor  # (3,)
    prior_bg: torch.Tensor  # (3,)
    num_keys: torch.Tensor  # () int32

    @property
    def window(self) -> int:
        return self.q.shape[0]


def tree_where(cond: torch.Tensor, a, b):
    """Field-wise torch.where over two NamedTuples of one type."""
    return type(a)(*(torch.where(cond, x, y) for x, y in zip(a, b)))


def make_window(w: int, initial: NavState, ba, bg, cfg: ImuConfig) -> WindowState:
    """Key 0 = the initializer's state under the initial priors (:712-746)."""
    dev = initial.rotation.device
    f32 = dict(dtype=torch.float32, device=dev)
    ba = ba.to(torch.float32)
    bg = bg.to(torch.float32)
    qs = initial.rotation.repeat(w, 1)
    prior_sigmas = constant(
        [cfg.prior_pose_noise] * 6 + [cfg.prior_vel_noise] * 3 + [cfg.prior_bias_noise] * 6, device=dev)
    return WindowState(
        q=qs,
        p=initial.position.repeat(w, 1),
        v=initial.velocity.repeat(w, 1),
        ba=ba.repeat(w, 1),
        bg=bg.repeat(w, 1),
        obs_q=qs.clone(),
        obs_t=initial.position.repeat(w, 1),
        obs_drift=torch.zeros(w, dtype=torch.bool, device=dev),
        obs_valid=torch.zeros(w, dtype=torch.bool, device=dev),
        pre_p=torch.zeros(w, 3, **f32),
        pre_q=constant([1.0, 0.0, 0.0, 0.0], device=dev).repeat(w, 1),
        pre_v=torch.zeros(w, 3, **f32),
        pre_jac=torch.eye(15, **f32).repeat(w, 1, 1),
        pre_sqrt_info=torch.eye(9, **f32).repeat(w, 1, 1),
        pre_ba=ba.repeat(w, 1),
        pre_bg=bg.repeat(w, 1),
        pre_dt=torch.zeros(w, **f32),
        grav_dir=constant([0.0, 0.0, 1.0], device=dev).repeat(w, 1),
        grav_valid=torch.zeros(w, dtype=torch.bool, device=dev),
        prior_sqrt_info=torch.diag(1.0 / prior_sigmas),
        prior_q=initial.rotation.clone(),
        prior_p=initial.position.clone(),
        prior_v=initial.velocity.clone(),
        prior_ba=ba.clone(),
        prior_bg=bg.clone(),
        num_keys=torch.ones((), dtype=torch.int32, device=dev),
    )


def sqrt_information(cov: torch.Tensor) -> torch.Tensor:
    """Whitener L^-1 (cov = L L^T) with relative jitter."""
    n = cov.shape[0]
    eye = torch.eye(n, dtype=cov.dtype, device=cov.device)
    jitter = 1e-6 * torch.clamp(torch.max(torch.diagonal(cov)), min=1e-12)
    l = torch.linalg.cholesky_ex(cov + jitter * eye, check_errors=False).L
    return torch.linalg.solve_triangular(l, eye, upper=False)


def _states_apply_delta(state: WindowState, delta: torch.Tensor) -> WindowState:
    """delta (W*15,) -> perturbed window (left-multiplicative rotation)."""
    d = delta.reshape(state.window, KEY_DIM)
    dq = quat_from_axis_angle(d[:, 3:6])
    return state._replace(
        q=quat_normalize(quat_multiply(dq, state.q)),
        p=state.p + d[:, 0:3],
        v=state.v + d[:, 6:9],
        ba=state.ba + d[:, 9:12],
        bg=state.bg + d[:, 12:15],
    )


def _imu_residuals(state: WindowState, gravity: float, bias_sigmas) -> torch.Tensor:
    """(W-1, 15) IMU residuals between keys i-1 and i, i = 1..W-1."""
    g = constant([0.0, 0.0, -gravity], device=state.q.device)
    qi, pi, vi, bai, bgi = state.q[:-1], state.p[:-1], state.v[:-1], state.ba[:-1], state.bg[:-1]
    qj, pj, vj, baj, bgj = state.q[1:], state.p[1:], state.v[1:], state.ba[1:], state.bg[1:]
    dt = state.pre_dt[1:]
    pre = Preintegrated(
        delta_p=state.pre_p[1:], delta_q=state.pre_q[1:], delta_v=state.pre_v[1:],
        jacobian=state.pre_jac[1:], covariance=None, dt=dt,
        ba=state.pre_ba[1:], bg=state.pre_bg[1:], acc0=None, gyr0=None, count=None,
    )
    cp, cq, cv = bias_corrected_deltas(pre, bai, bgi)
    dtc = dt[:, None]
    r_p = quat_inverse_rotate(qi, pj - pi - vi * dtc - 0.5 * g * dtc * dtc) - cp
    dq_meas = quat_multiply(quat_conjugate(cq), quat_multiply(quat_conjugate(qi), qj))
    r_q = 2.0 * torch.where(dq_meas[:, 0:1] < 0, -dq_meas, dq_meas)[:, 1:4]
    r_v = quat_inverse_rotate(qi, vj - vi - g * dtc) - cv
    r_pqv = (state.pre_sqrt_info[1:] @ torch.cat([r_p, r_q, r_v], dim=-1)[:, :, None])[:, :, 0]
    sdt = torch.sqrt(torch.clamp(dt, min=1e-3))[:, None]
    r_ba = (baj - bai) / (sdt * bias_sigmas[0])
    r_bg = (bgj - bgi) / (sdt * bias_sigmas[1])
    return torch.cat([r_pqv, r_ba, r_bg], dim=-1)


def _pose_prior_residuals(state: WindowState, cfg: ImuConfig) -> torch.Tensor:
    """(W, 6) scan-match pose priors (PriorFactor<Pose3>, correction noise)."""
    sig_t = torch.where(state.obs_drift, cfg.ceres_pose_noise_t_drift, cfg.ceres_pose_noise_t)
    sig_r = torch.where(state.obs_drift, cfg.ceres_pose_noise_r_drift, cfg.ceres_pose_noise_r)
    r_t = (state.p - state.obs_t) / sig_t[:, None]
    r_r = quat_to_axis_angle(quat_multiply(quat_conjugate(state.obs_q), state.q)) / sig_r[:, None]
    return torch.where(state.obs_valid[:, None], torch.cat([r_t, r_r], dim=-1), 0.0)


def _gravity_residuals(state: WindowState, cfg: ImuConfig) -> torch.Tensor:
    """(W, 3) gravity attitude factors (gravity_factor.cc:10-31)."""
    b_ref = constant([0.0, 0.0, -1.0], device=state.q.device)
    predicted = quat_rotate(quat_remove_yaw(state.q), b_ref)
    err = _cross(predicted, state.grav_dir)
    return torch.where(state.grav_valid[:, None], err / cfg.prior_gravity_noise, 0.0)


def _prior_residual(state: WindowState) -> torch.Tensor:
    raw = torch.cat([
        state.p[0] - state.prior_p,
        quat_to_axis_angle(quat_multiply(quat_conjugate(state.prior_q), state.q[0])),
        state.v[0] - state.prior_v,
        state.ba[0] - state.prior_ba,
        state.bg[0] - state.prior_bg,
    ])
    return state.prior_sqrt_info @ raw


def _all_residuals(state: WindowState, cfg: ImuConfig, gravity: float) -> torch.Tensor:
    w = state.window
    active = torch.arange(w, device=state.q.device) < state.num_keys
    bias_sigmas = (cfg.acc_bias_noise, cfg.gyr_bias_noise)
    r_imu = torch.where(active[1:, None], _imu_residuals(state, gravity, bias_sigmas), 0.0)
    r_pose = torch.where(active[:, None], _pose_prior_residuals(state, cfg), 0.0)
    r_grav = torch.where(active[:, None], _gravity_residuals(state, cfg), 0.0)
    return torch.cat([_prior_residual(state), r_imu.reshape(-1), r_pose.reshape(-1),
                      r_grav.reshape(-1)])


def _jacobian(res, n: int, device):
    """(r, J) of a residual function of an n-vector, linearized at zero."""
    zero = torch.zeros(n, dtype=torch.float32, device=device)
    jac, r = jacfwd(lambda d: (res(d),) * 2, has_aux=True)(zero)
    return r, jac


def optimize_plain(state: WindowState, cfg: ImuConfig, gravity: float, iterations: int = 8) -> WindowState:
    """Fixed-count Gauss-Newton over the whole window, in plain PyTorch."""
    w = state.window
    n = w * KEY_DIM
    dev = state.q.device
    eye = torch.eye(n, dtype=torch.float32, device=dev)
    active_mask = torch.repeat_interleave(torch.arange(w, device=dev) < state.num_keys, KEY_DIM)
    for _ in range(iterations):
        s = state
        r, jac = _jacobian(lambda d: _all_residuals(_states_apply_delta(s, d), cfg, gravity), n, dev)
        jac = jac * active_mask[None, :]
        h = jac.T @ jac
        g = jac.T @ r
        # Jacobi preconditioning: meters vs bias rad/s in one f32 solve
        d = torch.sqrt(torch.clamp(torch.diagonal(h), min=1e-12))
        hs = h / d[:, None] / d[None, :] + 1e-5 * eye
        gs = g / d
        chol = torch.linalg.cholesky_ex(hs, check_errors=False).L
        delta = -torch.cholesky_solve(gs[:, None], chol)[:, 0] / d
        delta = torch.where(active_mask, delta, 0.0)
        delta = torch.where(torch.isfinite(delta), delta, 0.0)
        delta = torch.clamp(delta, -1.0, 1.0)
        state = _states_apply_delta(state, delta)
    return state


_BOOL_FIELDS = ("obs_drift", "obs_valid", "grav_valid")


def optimize(state: WindowState, cfg: ImuConfig, gravity: float, iterations: int = 8) -> WindowState:
    """`optimize_plain` over a window, or over a window with a leading lane
    axis (B, W, ...) and `num_keys` (B,). CPU tensors take the plain version
    (vmapped over the lanes); CUDA tensors launch K3 once for all lanes,
    and raise where a window of W keys needs more shared memory than one
    block may have. The inputs are not written: q, p, v, ba and bg come
    back new."""
    batched = state.num_keys.dim() == 1
    dev = state.q.device
    if dev.type == "cpu":
        if not batched:
            return optimize_plain(state, cfg, gravity, iterations)
        return vmap(lambda s: optimize_plain(s, cfg, gravity, iterations))(state)
    if dev.type != "cuda":
        raise ValueError(f"optimize: unsupported device {dev}")
    lanes = state if batched else WindowState(*(x[None] for x in state))
    b, w = lanes.q.shape[0], lanes.q.shape[1]
    for name, x in zip(WindowState._fields, lanes):
        dtype = (torch.bool if name in _BOOL_FIELDS else torch.int32 if name == "num_keys"
                 else torch.float32)
        if x.dtype != dtype or x.device != dev or x.shape[0] != b:
            raise ValueError(f"optimize: {name} must be {dtype} on {dev} with {b} lanes, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    lib = kernels.library()
    inputs = [x.contiguous() for x in lanes]
    outputs = [torch.empty(b, w, x.shape[-1], dtype=torch.float32, device=dev)
               for x in (lanes.q, lanes.p, lanes.v, lanes.ba, lanes.bg)]
    params = (ctypes.c_float * 8)(
        gravity, cfg.acc_bias_noise, cfg.gyr_bias_noise, cfg.ceres_pose_noise_t,
        cfg.ceres_pose_noise_t_drift, cfg.ceres_pose_noise_r, cfg.ceres_pose_noise_r_drift,
        cfg.prior_gravity_noise)
    with torch.cuda.device(dev):  # the launch goes to the inputs' card
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dliom_window_gn(
            (ctypes.c_void_p * len(inputs))(*(x.data_ptr() for x in inputs)),
            (ctypes.c_void_p * len(outputs))(*(x.data_ptr() for x in outputs)),
            params, b, w, iterations, stream)
    kernels.check(err, "window_gn")
    launches.count(__name__, "LAUNCHES")
    q, p, v, ba, bg = outputs if batched else (x[0] for x in outputs)
    return state._replace(q=q, p=p, v=v, ba=ba, bg=bg)


# Exact Schur marginalization of slid-out keys was measured (in the JAX
# package) to drift; the default anchors the new head softly instead.
EXACT_MARGINALIZATION = False

ANCHOR_POSE_SIGMA = 1.0  # m / rad
ANCHOR_VEL_SIGMA = 1.0  # m/s


def _shift_window(state: WindowState) -> WindowState:
    """Drop key 0; shift every per-key array left by one."""
    per_key = {f: torch.roll(getattr(state, f), -1, 0) for f in WindowState._fields[:19]}
    return state._replace(**per_key, num_keys=state.num_keys - 1)


def _drop_oldest(state: WindowState, cfg: ImuConfig) -> WindowState:
    """Slide the window, anchoring the new head at its current estimate."""
    state = _shift_window(state)
    sig = constant(
        [ANCHOR_POSE_SIGMA] * 6 + [ANCHOR_VEL_SIGMA] * 3 + [cfg.prior_bias_noise] * 6,
        device=state.q.device)
    return state._replace(
        prior_sqrt_info=torch.diag(1.0 / sig),
        prior_q=state.q[0], prior_p=state.p[0], prior_v=state.v[0],
        prior_ba=state.ba[0], prior_bg=state.bg[0],
    )


def _marginalize_oldest(state: WindowState, cfg: ImuConfig, gravity: float) -> WindowState:
    """Exact Schur marginalization of key 0 onto key 1 (the reference's
    marginal-covariance carry-over, :750-765, done per slide)."""
    dev = state.q.device
    rest = torch.zeros((state.window - 2) * KEY_DIM, dtype=torch.float32, device=dev)
    bias_sigmas = (cfg.acc_bias_noise, cfg.gyr_bias_noise)

    def res(d):
        pert = _states_apply_delta(state, torch.cat([d, rest]))
        return torch.cat([
            _prior_residual(pert),
            _imu_residuals(pert, gravity, bias_sigmas)[0],
            _pose_prior_residuals(pert, cfg)[0],
            _gravity_residuals(pert, cfg)[0],
        ])

    r, jac = _jacobian(res, 2 * KEY_DIM, dev)
    h = jac.T @ jac
    g = jac.T @ r
    d = torch.sqrt(torch.clamp(torch.diagonal(h), min=1e-8))
    hs = h / d[:, None] / d[None, :]
    gs = g / d
    eye = torch.eye(KEY_DIM, dtype=torch.float32, device=dev)
    h00 = hs[:KEY_DIM, :KEY_DIM] + 1e-5 * eye
    h01 = hs[:KEY_DIM, KEY_DIM:]
    h11 = hs[KEY_DIM:, KEY_DIM:]
    h00_inv = torch.linalg.inv_ex(h00, check_errors=False).inverse
    d1 = d[KEY_DIM:]
    h_marg = (h11 - h01.T @ h00_inv @ h01) * d1[:, None] * d1[None, :]
    g_marg = (gs[KEY_DIM:] - h01.T @ h00_inv @ gs[:KEY_DIM]) * d1
    h_marg = 0.5 * (h_marg + h_marg.T)
    h_marg = h_marg + 1e-6 * torch.clamp(torch.max(torch.diagonal(h_marg)), min=1e-6) * eye
    mean_shift = -torch.linalg.solve_ex(h_marg, g_marg[:, None], check_errors=False).result[:, 0]
    mean_shift = torch.clamp(torch.where(torch.isfinite(mean_shift), mean_shift, 0.0), -1.0, 1.0)
    sqrt_info = torch.linalg.cholesky_ex(h_marg, check_errors=False).L.T
    sqrt_info = torch.where(torch.isfinite(sqrt_info), sqrt_info, 0.0)
    new_prior_q = quat_normalize(quat_multiply(quat_from_axis_angle(mean_shift[3:6]), state.q[1]))
    new_prior = dict(
        prior_q=new_prior_q,
        prior_p=state.p[1] + mean_shift[0:3],
        prior_v=state.v[1] + mean_shift[6:9],
        prior_ba=state.ba[1] + mean_shift[9:12],
        prior_bg=state.bg[1] + mean_shift[12:15],
    )
    return _shift_window(state)._replace(prior_sqrt_info=sqrt_info, **new_prior)


def push_key(state: WindowState, pre: Preintegrated, predicted: NavState, obs_pose: Rigid3,
             obs_drift, grav_dir, grav_valid, cfg: ImuConfig, gravity: float) -> WindowState:
    """Append a key (WindowOptimize per-scan block :800-840), sliding the
    oldest key out first when the window is full."""
    w = state.window
    full = state.num_keys >= w
    slid = (_marginalize_oldest(state, cfg, gravity) if EXACT_MARGINALIZATION
            else _drop_oldest(state, cfg))
    state = tree_where(full, slid, state)
    idx = torch.clamp(state.num_keys, max=w - 1)
    row = torch.arange(w, device=idx.device) == idx

    # IMU-dropout guard: an empty preintegration zero-weights its factor
    sqrt_info = torch.where(
        pre.dt > 0.0, sqrt_information(pre.covariance[0:9, 0:9]),
        torch.zeros(9, 9, dtype=torch.float32, device=idx.device))

    def set_row(arr, value):
        mask = row.reshape((w,) + (1,) * (arr.dim() - 1))
        return torch.where(mask, value, arr)

    prev = torch.remainder(idx - 1, w)
    return state._replace(
        q=set_row(state.q, predicted.rotation),
        p=set_row(state.p, predicted.position),
        v=set_row(state.v, predicted.velocity),
        ba=set_row(state.ba, _take(state.ba, prev)),
        bg=set_row(state.bg, _take(state.bg, prev)),
        obs_q=set_row(state.obs_q, obs_pose.rotation),
        obs_t=set_row(state.obs_t, obs_pose.translation),
        obs_drift=set_row(state.obs_drift, obs_drift),
        obs_valid=set_row(state.obs_valid, True),
        pre_p=set_row(state.pre_p, pre.delta_p),
        pre_q=set_row(state.pre_q, pre.delta_q),
        pre_v=set_row(state.pre_v, pre.delta_v),
        pre_jac=set_row(state.pre_jac, pre.jacobian),
        pre_sqrt_info=set_row(state.pre_sqrt_info, sqrt_info),
        pre_ba=set_row(state.pre_ba, pre.ba),
        pre_bg=set_row(state.pre_bg, pre.bg),
        pre_dt=set_row(state.pre_dt, pre.dt),
        grav_dir=set_row(state.grav_dir, grav_dir),
        grav_valid=set_row(state.grav_valid, grav_valid),
        num_keys=torch.clamp(state.num_keys + 1, max=w),
    )


def latest_state(state: WindowState) -> Tuple[NavState, torch.Tensor, torch.Tensor]:
    """(NavState, ba, bg) of the newest key."""
    i = state.num_keys - 1
    return NavState(_take(state.q, i), _take(state.p, i), _take(state.v, i)), \
        _take(state.ba, i), _take(state.bg, i)


def failure_detected(state: WindowState) -> torch.Tensor:
    """FailureDetection (:896-913): ||v|| > 30 m/s or ||ba||/||bg|| > 1."""
    i = state.num_keys - 1
    return (
        (_norm(_take(state.v, i)) > 30.0)
        | (_norm(_take(state.ba, i)) > 1.0)
        | (_norm(_take(state.bg, i)) > 1.0)
    )
