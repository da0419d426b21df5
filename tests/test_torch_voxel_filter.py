"""Parity of dliom_tpu_torch/ops/voxel_filter.py with the JAX package: the
survivor sets (and their order and coordinates) are identical, since every
sort key is unique once the input index breaks ties."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dliom_tpu.ops import voxel_filter as J
from dliom_tpu_torch.ops import voxel_filter as T
import torch_threads  # noqa: F401  (one torch thread per test process)


def _cloud(seed, n=3000):
    rng = np.random.default_rng(seed)
    pts = rng.normal(0, 6.0, (n, 3)).astype(np.float32)
    pts[: n // 5] = pts[n // 5 : 2 * (n // 5)] + 0.01  # near-duplicates share voxels
    times = rng.uniform(-0.1, 0, n).astype(np.float32)
    mask = rng.random(n) < 0.9
    return pts, times, mask


def _assert_same(cj, ct):
    np.testing.assert_array_equal(np.asarray(cj.mask), ct.mask.numpy())
    np.testing.assert_array_equal(np.asarray(cj.points), ct.points.numpy())
    np.testing.assert_array_equal(np.asarray(cj.times), ct.times.numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_voxel_filter_mask(seed):
    pts, _, mask = _cloud(seed)
    for edge in (0.15, 0.5):
        kj = J.voxel_filter_mask(jnp.asarray(pts), jnp.asarray(mask), edge)
        kt = T.voxel_filter_mask(torch.from_numpy(pts), torch.from_numpy(mask), edge)
        np.testing.assert_array_equal(np.asarray(kj), kt.numpy())


@pytest.mark.parametrize("capacity", [None, 4096, 700])
def test_voxel_filter(capacity):
    pts, times, mask = _cloud(2)
    args_j = (jnp.asarray(pts), jnp.asarray(times), jnp.asarray(mask))
    args_t = (torch.from_numpy(pts), torch.from_numpy(times), torch.from_numpy(mask))
    cj = J.voxel_filter(*args_j, 0.3, out_capacity=capacity)
    ct = T.voxel_filter(*args_t, 0.3, out_capacity=capacity)
    _assert_same(cj, ct)
    assert int(ct.mask.sum()) > 0


@pytest.mark.parametrize("min_points,capacity", [(150, 256), (200, 1024), (5000, 256)])
def test_adaptive_voxel_filter(min_points, capacity):
    pts, times, mask = _cloud(3)
    kw = dict(max_length=2.0, min_num_points=min_points, max_range=15.0, out_capacity=capacity)
    cj = J.adaptive_voxel_filter(jnp.asarray(pts), jnp.asarray(times), jnp.asarray(mask), **kw)
    ct = T.adaptive_voxel_filter(torch.from_numpy(pts), torch.from_numpy(times),
                                 torch.from_numpy(mask), **kw)
    _assert_same(cj, ct)
