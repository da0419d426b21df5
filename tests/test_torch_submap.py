"""Parity of the two-slot active submaps (dliom_tpu_torch/mapping/submap.py)
on dense and mixed brick/dense grids with the JAX package: insert and
spawn sequences that cross two spawns, every ActiveSubmaps field compared
after every step. Integer state (banks, counts, `dense_dropped`, brick
directory and pool) must match bit for bit; the f32 slot poses (pure
copies of the inputs) too. Also the grid helpers of mapping/grid.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dliom_tpu.common.config import load_config as j_load_config
from dliom_tpu.mapping import grid as JGrid
from dliom_tpu.mapping import submap as JS
from dliom_tpu_torch.common.config import load_config as t_load_config
from dliom_tpu_torch.interop import to_numpy, to_torch
from dliom_tpu_torch.mapping import grid as TGrid
from dliom_tpu_torch.mapping import submap as TS
import torch_threads  # noqa: F401  (one torch thread per test process)

DENSE = {"high_resolution": 0.1, "low_resolution": 0.4, "high_resolution_extent": 32,
         "low_resolution_extent": 32, "num_range_data": 2, "high_resolution_max_range": 1.5}
CASES = {
    "dense_sort": dict(DENSE, dense_apply_groups=0),
    "dense_grouped": dict(DENSE, dense_apply_groups=4),
    # capacity 1 drops groups: dense_dropped counts for real
    "dense_grouped_overflow": dict(DENSE, dense_apply_groups=1),
    "mixed_brick_high": dict(DENSE, use_brick_grid=True, brick_dir_extent=8, brick_max_bricks=256,
                             brick_apply_groups=16, brick_apply_group_bricks=8,
                             dense_apply_groups=4),
    "mixed_brick_low": dict(DENSE, use_brick_grid_low=True, low_brick_dir_extent=8,
                            low_brick_max_bricks=256, low_brick_apply_groups=16,
                            low_brick_apply_group_bricks=8),
}


def _assert_state_equal(js, ts, step):
    jn = jax.tree.map(np.asarray, js)
    tn = to_numpy(ts)
    for f in JS.ActiveSubmaps._fields:
        a, b = getattr(jn, f), getattr(tn, f)
        if a is None or b is None:
            assert a is None and b is None, (f, step)
            continue
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            np.testing.assert_array_equal(np.asarray(y), np.asarray(x), err_msg=f"{f} step {step}")


@pytest.mark.parametrize("case", list(CASES))
def test_insert_spawn_sequence_bit_identical(case):
    sub = CASES[case]
    jcfg = j_load_config("basic", {"trajectory_builder": {"submaps": sub}}).trajectory_builder.submaps
    tcfg = t_load_config("basic", {"trajectory_builder": {"submaps": sub}}).trajectory_builder.submaps
    js = JS.make_active_submaps(jcfg)
    ts = to_torch(jax.tree.map(np.asarray, js), torch.device("cpu"))
    rng = np.random.default_rng(len(case))
    finished = []
    for step in range(6):
        js = JS.apply_pending_spawn(js, jcfg)
        ts = TS.apply_pending_spawn(ts, tcfg)
        origin = rng.normal(0, 0.2, 3).astype(np.float32)
        pts = (origin + rng.normal(0, 0.8, (300, 3))).astype(np.float32)
        mask = rng.random(300) < 0.9
        grav = np.asarray([np.cos(0.1 * step), 0, 0, np.sin(0.1 * step)], np.float32)
        enabled = step != 3  # a motion-filtered scan
        js, jf = JS.insert_range_data_into_submaps(
            js, jnp.asarray(origin), jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(grav), jcfg,
            jnp.asarray(enabled))
        ts, tf = TS.insert_range_data_into_submaps(
            ts, torch.from_numpy(origin), torch.from_numpy(pts), torch.from_numpy(mask),
            torch.from_numpy(grav), tcfg, torch.tensor(enabled))
        assert int(jf) == int(tf), step
        finished.append(int(tf))
        _assert_state_equal(js, ts, step)
    assert max(finished) >= 0 and int(ts.num_created) >= 3
    assert (int(ts.dense_dropped[0]) > 0) == (case == "dense_grouped_overflow")


def test_grid_helpers_match():
    spec_j, spec_t = JGrid.GridSpec(0.5, 16), TGrid.GridSpec(0.5, 16)
    rng = np.random.default_rng(0)
    cells = rng.integers(-10, 10, (50, 3)).astype(np.int32)
    cells = cells[np.unique(np.asarray(JGrid.linear_index(jnp.asarray(cells), spec_j)[0]),
                            return_index=True)[1]]  # distinct cells: assignment order free
    vals = rng.integers(1, 32768, len(cells)).astype(np.int32)
    gj = JGrid.set_cells(JGrid.make_grid(spec_j), jnp.asarray(cells), jnp.asarray(vals), spec_j)
    gt = TGrid.set_cells(TGrid.make_grid(spec_t), torch.from_numpy(cells), torch.from_numpy(vals), spec_t)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    np.testing.assert_array_equal(
        TGrid.lookup_probability(gt, torch.from_numpy(cells), spec_t).numpy(),
        np.asarray(JGrid.lookup_probability(gj, jnp.asarray(cells), spec_j)))
    np.testing.assert_array_equal(TGrid.occupied_cells(gt, spec_t).numpy(),
                                  np.asarray(JGrid.occupied_cells(gj, spec_j)))
    np.testing.assert_array_equal(TGrid.center_of_cell(torch.from_numpy(cells), 0.5).numpy(),
                                  np.asarray(JGrid.center_of_cell(jnp.asarray(cells), 0.5)))
