"""Parity of NDT scan-to-scan matching (dliom_tpu_torch/ops/ndt.py) with
the JAX package on synthetic scans voxel-filtered at 0.3 m to 4096 points,
as the dynamic initializer prepares them.

Tolerances: `build_field`'s `valid` and `slot_table` exactly; means within
1e-5 m and whitening within 1e-4 relative / 1e-3 absolute (segment sums
in f32); `match` from one field (JAX's, carried over) and one start pose
within 1e-4 m and 1e-4 in quaternion components (20 LM iterations of f32
solves); the JAX test's three translations recovered within 0.03 m.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dliom_tpu.mapping.grid import GridSpec as JGridSpec
from dliom_tpu.ops import ndt as JN
from dliom_tpu.ops.voxel_filter import truncate_cloud, voxel_filter
from dliom_tpu.transform.rigid import Rigid3 as JRigid3
from dliom_tpu_torch.interop import to_torch
from dliom_tpu_torch.io.synthetic import SyntheticWorld
from dliom_tpu_torch.mapping.grid import GridSpec as TGridSpec
from dliom_tpu_torch.ops import ndt as TN
from dliom_tpu_torch.transform.rigid import Rigid3 as TRigid3
import torch_threads  # noqa: F401  (one torch thread per test process)

SPEC_J, SPEC_T = JGridSpec(1.0, 128), TGridSpec(1.0, 128)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def scans():
    """Filtered scans (points, mask) as numpy, at the origin and at the
    JAX test's three offsets."""
    world = SyntheticWorld.create()
    out = {}
    for t in ((0.0, 0.0, 0.0), (0.1, 0.0, 0.0), (0.2, 0.08, 0.0), (-0.15, 0.1, 0.05)):
        pose = TRigid3(np.asarray([1.0, 0, 0, 0], np.float32), np.asarray(t, np.float32))
        pts = jnp.asarray(world.cast_scan(pose)[0])
        n = pts.shape[0]
        f = truncate_cloud(voxel_filter(pts, jnp.zeros(n), jnp.ones(n, bool), 0.3), 4096)
        out[t] = (np.asarray(f.points), np.asarray(f.mask))
    return out


def _t(x):
    return torch.from_numpy(np.array(x))


def test_build_field_matches(scans):
    pts, mask = scans[(0.0, 0.0, 0.0)]
    jf = JN.build_field(jnp.asarray(pts), jnp.asarray(mask), SPEC_J)
    tf = TN.build_field(_t(pts), _t(mask), SPEC_T)
    np.testing.assert_array_equal(tf.valid.numpy(), np.asarray(jf.valid))
    np.testing.assert_array_equal(tf.slot_table.numpy(), np.asarray(jf.slot_table))
    assert int(tf.valid.sum()) > 100
    np.testing.assert_allclose(tf.means.numpy(), np.asarray(jf.means), atol=1e-5)
    np.testing.assert_allclose(tf.sqrt_inv_cov.numpy(), np.asarray(jf.sqrt_inv_cov), rtol=1e-4, atol=1e-3)


def test_whitening_zeroes_a_non_pd_voxel():
    """The covariance step of build_field with one voxel forced non-PD:
    JAX's factor is NaN there and its whitening zero; the port's
    cholesky_ex path gives the same zeros and the same other voxels."""
    rng = np.random.default_rng(3)
    a = rng.normal(size=(5, 3, 3)).astype(np.float32)
    cov = a @ np.swapaxes(a, 1, 2) + 0.01 * np.eye(3, dtype=np.float32)
    cov[2] = np.diag([1.0, -0.5, 0.2]).astype(np.float32)  # not positive definite
    l = jnp.linalg.cholesky(jnp.asarray(cov))  # JAX ops/ndt.py build_field, :96-100
    inv_l = jax.vmap(lambda m: jax.scipy.linalg.solve_triangular(m, jnp.eye(3), lower=True))(l)
    want = np.asarray(jnp.where(jnp.isfinite(inv_l), inv_l, 0.0))
    got = TN._whitening(_t(cov)).numpy()
    assert not want[2].any() and not got[2].any()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_match_from_one_field(scans):
    pts, mask = scans[(0.0, 0.0, 0.0)]
    jf = JN.build_field(jnp.asarray(pts), jnp.asarray(mask), SPEC_J)
    tf = to_torch(jax.tree.map(np.asarray, jf), CPU)
    bp, bm = scans[(0.2, 0.08, 0.0)]
    q0 = np.asarray([np.cos(0.01), 0.0, 0.0, np.sin(0.01)], np.float32)
    t0 = np.asarray([0.05, 0.0, 0.01], np.float32)
    jp = JN.match(jf, SPEC_J, jnp.asarray(bp), jnp.asarray(bm), JRigid3(jnp.asarray(q0), jnp.asarray(t0)))
    tp = TN.match(tf, SPEC_T, _t(bp), _t(bm), TRigid3(_t(q0), _t(t0)))
    np.testing.assert_allclose(tp.translation.numpy(), np.asarray(jp.translation), atol=1e-4)
    np.testing.assert_allclose(tp.rotation.numpy(), np.asarray(jp.rotation), atol=1e-4)


@pytest.mark.parametrize("true_t", [(0.1, 0.0, 0.0), (0.2, 0.08, 0.0), (-0.15, 0.1, 0.05)])
def test_ndt_matcher_accuracy(scans, true_t):
    """tests/test_dynamic_init.py::test_ndt_matcher_accuracy on the port."""
    pts, mask = scans[(0.0, 0.0, 0.0)]
    field = TN.build_field(_t(pts), _t(mask), SPEC_T)
    bp, bm = scans[true_t]
    pose = TN.match(field, SPEC_T, _t(bp), _t(bm), TRigid3.identity())
    np.testing.assert_allclose(pose.translation.numpy(), true_t, atol=0.03)
