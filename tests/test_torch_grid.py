"""Parity of the port's grid foundations with the JAX package: cell and
linear indices, Morton codes and truncating division are integer-exact;
corner weights and interpolated probabilities agree to f32 (atol 1e-6)."""

import numpy as np
import jax.numpy as jnp
import torch

from dliom_tpu.mapping import grid as JG
from dliom_tpu.ops import morton as JM
from dliom_tpu.ops.grid_update import _trunc_div as j_trunc_div
from dliom_tpu_torch.mapping import grid as TG
from dliom_tpu_torch.ops import morton as TM
from dliom_tpu_torch.ops.grid_update import _trunc_div as t_trunc_div
import torch_threads  # noqa: F401  (one torch thread per test process)


def test_cell_and_linear_index_exact():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-4, 4, (4096, 3)).astype(np.float32)
    pts[:8] = np.asarray([[0.25, -0.25, 0.75]] * 8, np.float32)  # exact halves: round-half-even
    spec_j, spec_t = JG.GridSpec(0.5, 12), TG.GridSpec(0.5, 12)
    cj = JG.cell_index(jnp.asarray(pts), 0.5)
    ct = TG.cell_index(torch.from_numpy(pts), 0.5)
    np.testing.assert_array_equal(np.asarray(cj), ct.numpy())
    lj, oj = JG.linear_index(cj, spec_j)
    lt, ot = TG.linear_index(ct, spec_t)
    np.testing.assert_array_equal(np.asarray(lj), lt.numpy())
    np.testing.assert_array_equal(np.asarray(oj), ot.numpy())
    assert not ot.all() and ot.any()


def test_morton_and_trunc_div_exact():
    rng = np.random.default_rng(1)
    cells = rng.integers(-600, 600, (4096, 3)).astype(np.int32)
    np.testing.assert_array_equal(np.asarray(JM.encode(jnp.asarray(cells))),
                                  TM.encode(torch.from_numpy(cells)).numpy())
    codes = rng.integers(0, 2**30, 4096).astype(np.int32)
    np.testing.assert_array_equal(np.asarray(JM.compact1by2(jnp.asarray(codes))),
                                  TM.compact1by2(torch.from_numpy(codes)).numpy())
    a = rng.integers(-1000, 1000, 4096).astype(np.int32)
    b = rng.integers(1, 50, 4096).astype(np.int32)
    np.testing.assert_array_equal(np.asarray(j_trunc_div(jnp.asarray(a), jnp.asarray(b))),
                                  t_trunc_div(torch.from_numpy(a), torch.from_numpy(b)).numpy())


def test_corner_weights_and_interpolation():
    rng = np.random.default_rng(2)
    s = rng.uniform(0, 1, (512, 3)).astype(np.float32)
    np.testing.assert_allclose(np.asarray(JG._corner_weights(jnp.asarray(s))),
                               TG._corner_weights(torch.from_numpy(s)).numpy(), atol=1e-6)
    np.testing.assert_array_equal(JG._CORNERS, TG._CORNERS)
    spec_j, spec_t = JG.GridSpec(0.3, 16), TG.GridSpec(0.3, 16)
    values = rng.integers(0, 32768, 2 * spec_j.num_cells).astype(np.int16)
    pts = rng.uniform(-2.6, 2.6, (1024, 3)).astype(np.float32)
    for base in (0, spec_j.num_cells):
        pj = JG.interpolated_probability(jnp.asarray(values), jnp.asarray(pts), spec_j, base)
        pt = TG.interpolated_probability(torch.from_numpy(values), torch.from_numpy(pts), spec_t, base)
        np.testing.assert_allclose(np.asarray(pj), pt.numpy(), atol=1e-6)
    assert TG.make_grid(spec_t).shape == (spec_t.num_cells,)
