"""Parity of dliom_tpu_torch/transform/rigid.py with dliom_tpu/transform/rigid.py:
the same seeded numpy inputs through both, float32, atol 1e-6 (a few ulp
of unit-scale values; the two frameworks order a handful of ops apart)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dliom_tpu.transform import rigid as J
from dliom_tpu_torch.transform import rigid as T

ATOL = 1e-6


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _vecs(rng, n, scale=1.0):
    return (scale * rng.normal(size=(n, 3))).astype(np.float32)


def _cmp(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=atol, rtol=0)


UNARY = {
    "quat_conjugate": lambda r: _quats(r, 64),
    "quat_normalize": lambda r: 3.0 * _quats(r, 64),
    "quat_to_axis_angle": lambda r: _quats(r, 64),
    "quat_angle": lambda r: _quats(r, 64),
    "quat_to_rotation_matrix": lambda r: _quats(r, 64),
    "quat_yaw": lambda r: _quats(r, 64),
    "quat_remove_yaw": lambda r: _quats(r, 64),
    "quat_from_axis_angle": lambda r: np.concatenate(
        [_vecs(r, 60), np.zeros((2, 3), np.float32), 1e-7 * np.ones((2, 3), np.float32)]),
    "so3_hat": lambda r: _vecs(r, 64),
}


@pytest.mark.parametrize("name", sorted(UNARY))
def test_unary(name):
    x = UNARY[name](np.random.default_rng(0))
    _cmp(getattr(J, name)(jnp.asarray(x)), getattr(T, name)(torch.from_numpy(x)))


def test_quat_from_yaw():
    y = np.random.default_rng(1).uniform(-4, 4, 64).astype(np.float32)
    _cmp(J.quat_from_yaw(jnp.asarray(y)), T.quat_from_yaw(torch.from_numpy(y)))


@pytest.mark.parametrize("name", ["quat_multiply", "quat_rotate", "quat_inverse_rotate",
                                  "quat_from_two_vectors"])
def test_binary(name):
    rng = np.random.default_rng(2)
    a = _quats(rng, 64)
    b = _vecs(rng, 64, 5.0) if name in ("quat_rotate", "quat_inverse_rotate") else _quats(rng, 64)
    if name == "quat_from_two_vectors":
        a, b = _vecs(rng, 64), _vecs(rng, 64)
        b[0] = -a[0]  # antiparallel branch
    _cmp(getattr(J, name)(jnp.asarray(a), jnp.asarray(b)),
         getattr(T, name)(torch.from_numpy(a), torch.from_numpy(b)), atol=5e-6)


def test_slerp():
    rng = np.random.default_rng(3)
    a, b = _quats(rng, 64), _quats(rng, 64)
    b[:4] = a[:4]  # nearly-parallel (nlerp) branch
    t = rng.uniform(0, 1, 64).astype(np.float32)
    _cmp(J.quat_slerp(jnp.asarray(a), jnp.asarray(b), jnp.asarray(t)),
         T.quat_slerp(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(t)))


def test_rigid3_ops():
    rng = np.random.default_rng(4)
    qa, qb = _quats(rng, 16), _quats(rng, 16)
    ta, tb = _vecs(rng, 16, 3.0), _vecs(rng, 16, 3.0)
    pts = _vecs(rng, 16, 10.0)
    ja, jb = J.Rigid3(jnp.asarray(qa), jnp.asarray(ta)), J.Rigid3(jnp.asarray(qb), jnp.asarray(tb))
    ta_, tb_ = (T.Rigid3(torch.from_numpy(qa), torch.from_numpy(ta)),
                T.Rigid3(torch.from_numpy(qb), torch.from_numpy(tb)))
    for jr, tr in ((ja.compose(jb), ta_.compose(tb_)), (ja.inverse(), ta_.inverse())):
        _cmp(jr.rotation, tr.rotation)
        _cmp(jr.translation, tr.translation, atol=5e-6)
    _cmp(ja.apply(jnp.asarray(pts)), ta_.apply(torch.from_numpy(pts)), atol=1e-5)
    ident = T.Rigid3.identity((2,))
    assert ident.rotation.shape == (2, 4) and ident.translation.shape == (2, 3)


def test_np_mirrors():
    rng = np.random.default_rng(5)
    a = T.Rigid3(_quats(rng, 1)[0].astype(np.float64), _vecs(rng, 1)[0].astype(np.float64))
    b = T.Rigid3(_quats(rng, 1)[0].astype(np.float64), _vecs(rng, 1)[0].astype(np.float64))
    ja, jb = J.Rigid3(*a), J.Rigid3(*b)
    for jr, tr in ((J.np_compose(ja, jb), T.np_compose(a, b)), (J.np_inverse(ja), T.np_inverse(a))):
        np.testing.assert_allclose(jr.rotation, tr.rotation, atol=1e-12)
        np.testing.assert_allclose(jr.translation, tr.translation, atol=1e-12)
    v = np.asarray([0.3, -0.2, 0.5])
    np.testing.assert_allclose(np.asarray(J.quat_from_axis_angle(jnp.asarray(v, jnp.float32))),
                               T.np_quat_from_axis_angle(v), atol=1e-6)
