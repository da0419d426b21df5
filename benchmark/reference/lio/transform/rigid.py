"""Rigid-body transforms on torch tensors (port of dliom_tpu/transform/rigid.py).

A `Rigid3` NamedTuple of a unit quaternion ``(w, x, y, z)`` and a
translation; every operation broadcasts over leading batch dimensions.
float32 throughout, constants made once per device (`common/device.py::constant`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as _np
import torch

from benchmark.reference.lio.common.device import constant

_EPS = 1e-12


def _const(values, like: torch.Tensor) -> torch.Tensor:
    return constant(values, like.dtype, like.device)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis, broadcasting. Written out:
    torch.linalg.cross's forward-mode rule fails under torch.func.jacfwd
    when some input components carry no tangent (the yaw-only matcher)."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def _norm(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Euclidean norm over the last axis as sqrt(sum(x*x)), the form
    jnp.linalg.norm lowers to."""
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=keepdim))


def quat_identity(batch_shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    q = torch.zeros(tuple(batch_shape) + (4,), dtype=dtype, device=device)
    q.select(-1, 0).fill_(1.0)  # a device fill: no host data, so a CUDA graph captures it
    return q


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a * b; (..., 4) x (..., 4) -> (..., 4)."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return q * _const([1.0, -1.0, -1.0, -1.0], q)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.clamp(_norm(q, keepdim=True), min=_EPS)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by quaternion(s) q (two-cross-product form)."""
    w = q[..., 0:1]
    u = q[..., 1:4]
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def quat_inverse_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return quat_rotate(quat_conjugate(q), v)


def quat_from_axis_angle(axis_angle: torch.Tensor) -> torch.Tensor:
    """Exponential map: rotation vector (..., 3) -> quaternion (..., 4)."""
    angle_sq = torch.sum(axis_angle * axis_angle, dim=-1, keepdim=True)
    angle = torch.sqrt(torch.clamp(angle_sq, min=_EPS))
    half = 0.5 * angle
    small = angle_sq < 1e-10
    k = torch.where(small, 0.5 - angle_sq / 48.0, torch.sin(half) / angle)
    w = torch.where(small, 1.0 - angle_sq / 8.0, torch.cos(half))
    return torch.cat([w, k * axis_angle], dim=-1)


def quat_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    """Log map: quaternion (..., 4) -> rotation vector (..., 3)."""
    q = quat_normalize(q)
    sign = torch.where(q[..., 0:1] < 0.0, -1.0, 1.0)
    q = q * sign
    w = torch.clamp(q[..., 0:1], -1.0, 1.0)
    v = q[..., 1:4]
    vn_sq = torch.sum(v * v, dim=-1, keepdim=True)
    vn = torch.sqrt(torch.clamp(vn_sq, min=_EPS))
    angle = 2.0 * torch.atan2(vn, w)
    small = vn_sq < 1e-12
    k = torch.where(small, 2.0 / torch.clamp(w, min=_EPS), angle / vn)
    return k * v


def quat_angle(q: torch.Tensor) -> torch.Tensor:
    """Absolute rotation angle (transform.h GetAngle)."""
    q = quat_normalize(q)
    w = torch.abs(q[..., 0])
    vn = _norm(q[..., 1:4])
    return 2.0 * torch.atan2(vn, w)


def quat_to_rotation_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (..., 4) -> rotation matrix (..., 3, 3)."""
    q = quat_normalize(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def quat_from_rotation_matrix(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> quaternion (..., 4), Shepperd's
    method on all four branches, selected with `where`."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)
    cs = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], dim=-1)
    best = torch.argmax(cs, dim=-1)[..., None]
    q = torch.where(best == 0, qw, torch.where(best == 1, qx, torch.where(best == 2, qy, qz)))
    return quat_normalize(q)


def quat_slerp(a: torch.Tensor, b: torch.Tensor, t) -> torch.Tensor:
    """Spherical linear interpolation from a (t=0) to b (t=1); nlerp for
    nearly parallel quaternions. `t` broadcasts."""
    t = torch.as_tensor(t, dtype=a.dtype, device=a.device)
    if t.dim() == a.dim() - 1:
        t = t[..., None]
    dot = torch.sum(a * b, dim=-1, keepdim=True)
    b = torch.where(dot < 0.0, -b, b)
    dot = torch.abs(dot)
    dot = torch.clamp(dot, -1.0, 1.0)
    theta = torch.arccos(torch.clamp(dot, 0.0, 1.0 - 1e-7))
    sin_theta = torch.sin(theta)
    near = dot > 1.0 - 1e-6
    wa = torch.where(near, 1.0 - t, torch.sin((1.0 - t) * theta) / torch.clamp(sin_theta, min=_EPS))
    wb = torch.where(near, t, torch.sin(t * theta) / torch.clamp(sin_theta, min=_EPS))
    return quat_normalize(wa * a + wb * b)


def quat_yaw(q: torch.Tensor) -> torch.Tensor:
    """Yaw angle (transform.h GetYaw)."""
    d = quat_rotate(q, _const([1.0, 0.0, 0.0], q))
    return torch.atan2(d[..., 1], d[..., 0])


def quat_from_yaw(yaw: torch.Tensor) -> torch.Tensor:
    half = 0.5 * yaw
    zero = torch.zeros_like(half)
    return torch.stack([torch.cos(half), zero, zero, torch.sin(half)], dim=-1)


def quat_remove_yaw(q: torch.Tensor) -> torch.Tensor:
    """Rz(-yaw(q)) * q, the gravity-aligned residual rotation."""
    return quat_multiply(quat_from_yaw(-quat_yaw(q)), q)


def quat_from_two_vectors(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Shortest-arc rotation taking direction a to direction b."""
    a = a / torch.clamp(_norm(a, keepdim=True), min=_EPS)
    b = b / torch.clamp(_norm(b, keepdim=True), min=_EPS)
    c = _cross(a, b)
    d = torch.sum(a * b, dim=-1, keepdim=True)
    q = torch.cat([1.0 + d, c], dim=-1)
    ortho = _cross(a, _const([1.0, 0.0, 0.0], a))
    ortho2 = _cross(a, _const([0.0, 1.0, 0.0], a))
    ortho = torch.where(_norm(ortho, keepdim=True) < 1e-6, ortho2, ortho)
    ortho = ortho / torch.clamp(_norm(ortho, keepdim=True), min=_EPS)
    flip = torch.cat([torch.zeros_like(d), ortho], dim=-1)
    q = torch.where(d < -(1.0 - 1e-6), flip, q)
    return quat_normalize(q)


def so3_hat(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix (..., 3) -> (..., 3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def so3_exp(v: torch.Tensor) -> torch.Tensor:
    """Rotation-vector exponential to a rotation matrix."""
    return quat_to_rotation_matrix(quat_from_axis_angle(v))


def so3_log(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix log to a rotation vector."""
    return quat_to_axis_angle(quat_from_rotation_matrix(m))


class Rigid3(NamedTuple):
    """Rotation quaternion (..., 4) wxyz + translation (..., 3)."""

    rotation: torch.Tensor
    translation: torch.Tensor

    @staticmethod
    def identity(batch_shape=(), dtype=torch.float32, device=None) -> "Rigid3":
        return Rigid3(
            rotation=quat_identity(batch_shape, dtype, device),
            translation=torch.zeros(tuple(batch_shape) + (3,), dtype=dtype, device=device),
        )

    @staticmethod
    def from_parts(rotation, translation) -> "Rigid3":
        return Rigid3(torch.as_tensor(rotation, dtype=torch.float32),
                      torch.as_tensor(translation, dtype=torch.float32))

    @staticmethod
    def translation_only(translation) -> "Rigid3":
        t = torch.as_tensor(translation, dtype=torch.float32)
        return Rigid3(quat_identity(t.shape[:-1], t.dtype, t.device), t)

    @staticmethod
    def rotation_only(rotation: torch.Tensor) -> "Rigid3":
        return Rigid3(rotation, rotation.new_zeros(rotation.shape[:-1] + (3,)))

    def compose(self, other: "Rigid3") -> "Rigid3":
        """self ∘ other (apply other first)."""
        return Rigid3(
            rotation=quat_normalize(quat_multiply(self.rotation, other.rotation)),
            translation=quat_rotate(self.rotation, other.translation) + self.translation,
        )

    def __matmul__(self, other: "Rigid3") -> "Rigid3":
        return self.compose(other)

    def inverse(self) -> "Rigid3":
        rot_inv = quat_conjugate(self.rotation)
        return Rigid3(rotation=rot_inv, translation=-quat_rotate(rot_inv, self.translation))

    def apply(self, points: torch.Tensor) -> torch.Tensor:
        """Transform point(s) (..., 3); the rotation broadcasts over points."""
        return quat_rotate(self.rotation, points) + self.translation

    def interpolate(self, other: "Rigid3", t) -> "Rigid3":
        """Lerp the translation, slerp the rotation (transform.h
        Interpolate); `t` is a scalar or one value per pose."""
        t = torch.as_tensor(t, dtype=self.translation.dtype, device=self.translation.device)
        w = t[..., None] if t.dim() == self.translation.dim() - 1 else t
        return Rigid3(quat_slerp(self.rotation, other.rotation, t),
                      self.translation + w * (other.translation - self.translation))


# ---------------------------------------------------------------------------
# Host-side float64 numpy mirrors, for host bookkeeping and host-made data.
# ---------------------------------------------------------------------------


def np_rigid(p: Rigid3, dtype=_np.float64) -> Rigid3:
    """Rigid3 re-backed by numpy arrays (one device-to-host copy if its
    parts are tensors)."""
    def host(x):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        return _np.asarray(x, dtype)

    return Rigid3(host(p.rotation), host(p.translation))


def np_quat_multiply(a: _np.ndarray, b: _np.ndarray) -> _np.ndarray:
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return _np.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def np_quat_conjugate(q: _np.ndarray) -> _np.ndarray:
    return q * _np.asarray([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def np_quat_rotate(q: _np.ndarray, v: _np.ndarray) -> _np.ndarray:
    w = q[..., 0:1]
    u = q[..., 1:4]
    uv = _np.cross(u, v)
    return v + 2.0 * (w * uv + _np.cross(u, uv))


def np_quat_from_axis_angle(axis_angle: _np.ndarray) -> _np.ndarray:
    """Exponential map for a single rotation vector, float64."""
    v = _np.asarray(axis_angle, _np.float64)
    angle = float(_np.linalg.norm(v))
    if angle < 1e-5:
        return _np.concatenate([[1.0 - angle * angle / 8.0], (0.5 - angle * angle / 48.0) * v])
    return _np.concatenate([[math.cos(0.5 * angle)], math.sin(0.5 * angle) / angle * v])


def np_quat_yaw(q: _np.ndarray) -> float:
    d = np_quat_rotate(q, _np.asarray([1.0, 0.0, 0.0], dtype=q.dtype))
    return float(_np.arctan2(d[..., 1], d[..., 0]))


def np_compose(a: Rigid3, b: Rigid3) -> Rigid3:
    """a ∘ b on numpy-backed Rigid3 (see Rigid3.compose)."""
    q = np_quat_multiply(_np.asarray(a.rotation), _np.asarray(b.rotation))
    q = q / max(float(_np.linalg.norm(q)), 1e-12)
    return Rigid3(
        rotation=q,
        translation=np_quat_rotate(_np.asarray(a.rotation), _np.asarray(b.translation))
        + _np.asarray(a.translation),
    )


def np_inverse(a: Rigid3) -> Rigid3:
    rot_inv = np_quat_conjugate(_np.asarray(a.rotation))
    return Rigid3(rotation=rot_inv, translation=-np_quat_rotate(rot_inv, _np.asarray(a.translation)))


def np_quat_slerp(a: _np.ndarray, b: _np.ndarray, t: float) -> _np.ndarray:
    """Host numpy mirror of quat_slerp for scalar t (bookkeeping paths)."""
    a = _np.asarray(a, _np.float64)
    b = _np.asarray(b, _np.float64)
    dot = float(_np.dot(a, b))
    if dot < 0.0:
        b, dot = -b, -dot
    dot = min(dot, 1.0)
    if dot > 1.0 - 1e-6:
        out = (1.0 - t) * a + t * b
    else:
        theta = _np.arccos(min(dot, 1.0 - 1e-7))
        sin_theta = max(_np.sin(theta), 1e-12)
        out = _np.sin((1.0 - t) * theta) / sin_theta * a + _np.sin(t * theta) / sin_theta * b
    return out / max(float(_np.linalg.norm(out)), 1e-12)
