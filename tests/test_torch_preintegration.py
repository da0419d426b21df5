"""Parity of dliom_tpu_torch/imu/preintegration.py and the K2 affine chain
with the JAX package, at rtol 1e-5 / atol 1e-6 (the tolerance of
tests/test_imu.py's chain test: one f32 15x15 recurrence summed in two
orders). The on-card kernel test is in tests/test_torch_cuda_kernels.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dliom_tpu.common.config import load_config
from dliom_tpu.imu import preintegration as J
from dliom_tpu_torch.imu import affine_chain as K2
from dliom_tpu_torch.imu import preintegration as T

RTOL, ATOL = 1e-5, 1e-6
_IMU = load_config("basic").trajectory_builder.imu


def _samples(seed, m=48, n_valid=40):
    rng = np.random.default_rng(seed)
    dts = np.full(m, 0.0025, np.float32)
    accs = (np.array([0.3, -0.2, 9.8], np.float32) + rng.normal(0, 0.5, (m, 3))).astype(np.float32)
    gyrs = rng.normal(0, 0.3, (m, 3)).astype(np.float32)
    mask = np.arange(m) < n_valid
    ba = rng.normal(0, 0.05, 3).astype(np.float32)
    bg = rng.normal(0, 0.01, 3).astype(np.float32)
    acc0 = accs[0] + 0.01
    gyr0 = gyrs[0] - 0.01
    return dts, accs, gyrs, mask, ba, bg, acc0, gyr0


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=rtol, atol=atol)


@pytest.mark.parametrize("n_valid", [40, 0, 48])
def test_integrate_matches_jax_sequential(n_valid):
    dts, accs, gyrs, mask, ba, bg, acc0, gyr0 = _samples(0, n_valid=n_valid)
    jp = J.integrate_sequential(
        J.make_preintegrated(*(jnp.asarray(x) for x in (ba, bg, acc0, gyr0))),
        jnp.asarray(dts), jnp.asarray(accs), jnp.asarray(gyrs), jnp.asarray(mask),
        J.noise_matrix(_IMU))
    tin = [torch.from_numpy(x) for x in (dts, accs, gyrs, mask)]
    p0 = T.make_preintegrated(*(torch.from_numpy(x) for x in (ba, bg, acc0, gyr0)))
    noise = T.noise_matrix(_IMU)
    np.testing.assert_array_equal(np.asarray(J.noise_matrix(_IMU)), noise.numpy())
    for tp in (T.integrate(p0, *tin, noise), T.integrate_sequential(p0, *tin, noise)):
        for f in ("delta_p", "delta_q", "delta_v", "jacobian", "covariance", "dt", "acc0", "gyr0"):
            _close(getattr(jp, f), getattr(tp, f))
        assert int(tp.count) == int(jp.count) == n_valid


def test_affine_chain_plain_matches_jax_recurrence():
    rng = np.random.default_rng(1)
    f = (np.eye(15) + 0.01 * rng.normal(size=(48, 15, 15))).astype(np.float32)
    q = rng.normal(size=(48, 15, 15)).astype(np.float32) * 1e-3
    q = q @ np.swapaxes(q, 1, 2)
    a_ref, p_ref = jnp.eye(15), jnp.zeros((15, 15))
    for i in range(48):
        p_ref = jnp.asarray(f[i]) @ p_ref @ jnp.asarray(f[i]).T + jnp.asarray(q[i])
        a_ref = jnp.asarray(f[i]) @ a_ref
    a, p = K2.affine_chain(torch.from_numpy(f), torch.from_numpy(q))
    _close(a_ref, a)
    _close(p_ref, p)
    ab, pb = K2.affine_chain(torch.from_numpy(np.stack([f, f])), torch.from_numpy(np.stack([q, q])))
    assert ab.shape == (2, 15, 15)
    np.testing.assert_array_equal(ab[1].numpy(), a.numpy())
    assert K2.LAUNCHES == 0  # CPU tensors never launch the kernel


def test_predict_and_bias_correction():
    dts, accs, gyrs, mask, ba, bg, acc0, gyr0 = _samples(2)
    jp = J.integrate_sequential(
        J.make_preintegrated(*(jnp.asarray(x) for x in (ba, bg, acc0, gyr0))),
        jnp.asarray(dts), jnp.asarray(accs), jnp.asarray(gyrs), jnp.asarray(mask),
        J.noise_matrix(_IMU))
    tp = T.Preintegrated(*(torch.from_numpy(np.array(x)) for x in jp))
    rng = np.random.default_rng(3)
    q = rng.normal(size=4).astype(np.float32)
    q /= np.linalg.norm(q)
    pos, vel = rng.normal(size=3).astype(np.float32), rng.normal(size=3).astype(np.float32)
    jn = J.predict(J.NavState(jnp.asarray(q), jnp.asarray(pos), jnp.asarray(vel)), jp, 9.80511)
    tn = T.predict(T.NavState(torch.from_numpy(q), torch.from_numpy(pos), torch.from_numpy(vel)),
                   tp, 9.80511)
    for a, b in zip(jn, tn):
        _close(a, b)
    dba, dbg = rng.normal(0, 0.02, 3).astype(np.float32), rng.normal(0, 0.01, 3).astype(np.float32)
    for a, b in zip(J.bias_corrected_deltas(jp, jnp.asarray(ba + dba), jnp.asarray(bg + dbg)),
                    T.bias_corrected_deltas(tp, torch.from_numpy(ba + dba), torch.from_numpy(bg + dbg))):
        _close(a, b)

