"""Parity of the per-record brick insert (`apply_groups == 0`,
dliom_tpu_torch/mapping/brick_grid.py::_insert_records) and its slot reset
with the JAX package's XLA fallback: a sequence of two-slot inserts with
`reset_slot` between them (pending and not), held after every call bit for
bit on the directory, pool, counts, group_of_slot, dropped and epochs. The
small pool fills up, so groups drop for real. Also `compress_brick` and
`lookup_value_brick` on the filled banks, which the backend and the
correlative matcher read."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dliom_tpu.mapping import brick_grid as JB
from dliom_tpu.mapping import grid as JGrid
from dliom_tpu_torch.mapping import brick_grid as TB
from dliom_tpu_torch.mapping import grid as TGrid
import torch_threads  # noqa: F401  (one torch thread per test process)

INSERT = dict(hit_probability=0.55, miss_probability=0.49)
# (dir_extent, max_bricks, apply_group_bricks, free-space voxels, spread m)
CASES = {
    "roomy": (8, 512, 8, 2, 0.8),  # the pool holds every brick
    "pool_full": (8, 32, 8, 1, 1.5),  # 4 pool groups per slot: drops
    "single_brick_groups": (4, 64, 1, 2, 0.6),
}


def _assert_bank_equal(jbank, tbank, what):
    for f in JB.BrickBank._fields:
        np.testing.assert_array_equal(getattr(tbank, f).numpy(), np.asarray(getattr(jbank, f)),
                                      err_msg=f"{f} after {what}")


@pytest.mark.parametrize("case", list(CASES))
def test_insert_reset_sequence_bit_identical(case):
    dir_extent, max_bricks, group_bricks, k, spread = CASES[case]
    kw_j = dict(resolution=0.1, dir_extent=dir_extent, max_bricks=max_bricks,
                apply_groups=0, apply_group_bricks=group_bricks)
    jspec, tspec = JB.BrickGridSpec(**kw_j), TB.BrickGridSpec(**kw_j)
    jbank = JB.make_brick_bank(jspec)
    tbank = TB.make_brick_bank(tspec)
    rng = np.random.default_rng(len(case))
    # (slot to reset before the insert or None, the reset pending?)
    plan = [(None, True), (None, True), (1, True), (None, True), (0, False), (0, True), (None, True)]
    for step, (reset, pending) in enumerate(plan):
        if reset is not None:
            jbank = JB.reset_slot(jbank, jspec, reset, jnp.asarray(pending))
            tbank = TB.reset_slot(tbank, tspec, reset, torch.tensor(pending))
            _assert_bank_equal(jbank, tbank, f"reset {step}")
        origins = rng.normal(0, 0.1, (2, 3)).astype(np.float32)
        hits = (origins[:, None, :] + rng.normal(0, spread, (2, 200, 3))).astype(np.float32)
        hits[:, :20] = hits[:, 20:40]  # repeated cells: update once
        masks = rng.random((2, 200)) < 0.9
        masks[1, : 50 * step] = False
        kw = dict(INSERT, num_free_space_voxels=k)
        jbank = JB._insert_brick_slots(jbank, jnp.asarray(origins), jnp.asarray(hits),
                                       jnp.asarray(masks), spec=jspec, **kw)
        tbank = TB._insert_brick_slots(tbank, torch.from_numpy(origins), torch.from_numpy(hits),
                                       torch.from_numpy(masks), spec=tspec, **kw)
        _assert_bank_equal(jbank, tbank, f"insert {step}")
    assert int(tbank.counts.sum()) > 0
    assert (int(tbank.dropped[0]) > 0) == (case == "pool_full")
    if case == "pool_full":
        assert int(tbank.counts.max()) == tspec.num_pool_groups  # no parking row on this path

    dense_j, dense_t = JGrid.GridSpec(0.1, 2 * dir_extent * 8), TGrid.GridSpec(0.1, 2 * dir_extent * 8)
    cells = rng.integers(-dir_extent * 4, dir_extent * 4, (500, 3)).astype(np.int32)
    for slot in (0, 1):
        jc = JB.compress_brick(jbank, jspec, slot, dense_j, 256)
        tc = TB.compress_brick(tbank, tspec, slot, dense_t, 256)
        assert int(tc.count) == int(jc.count)
        np.testing.assert_array_equal(tc.indices.numpy(), np.asarray(jc.indices))
        np.testing.assert_array_equal(tc.values.numpy(), np.asarray(jc.values))
        np.testing.assert_array_equal(
            TB.lookup_value_brick(tbank, torch.from_numpy(cells), tspec, slot).numpy(),
            np.asarray(JB.lookup_value_brick(jbank, jnp.asarray(cells), jspec, slot)))
