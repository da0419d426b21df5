"""Parity of kernel K1 (dliom_tpu_torch/ops/grouped_apply.py) and the brick
grid (dliom_tpu_torch/mapping/brick_grid.py) with the JAX package. All map
state is integer and must match exactly: the bank after
`apply_grouped_rows` (JAX's Pallas kernel runs in interpret mode here), and
pool, directory, counts, group_of_slot, epochs and dropped after
`_insert_brick_slots`, through duplicates, fresh and parking steps,
pool-full and apply-capacity drops, slot recycling and the epoch wrap.
The on-card kernel test is in tests/test_torch_cuda_kernels.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dliom_tpu.mapping import brick_grid as JB
from dliom_tpu.ops import pallas_apply as JP
from dliom_tpu_torch.mapping import brick_grid as TB
from dliom_tpu_torch.ops import grouped_apply as TP

HIT_ODDS = 0.55 / 0.45
MISS_ODDS = 0.49 / 0.51


def _grouped_case(seed, groups=12, cpg=1024):
    """Bank, per-step tables and sorted records with duplicate cells, mixed
    hit/miss, fresh steps, and empty-range steps (parking and a mid-sequence
    pool-full drop) that all share the parking row groups-1."""
    rng = np.random.default_rng(seed)
    bank = rng.integers(0, 32768, groups * cpg).astype(np.int16)
    park = groups - 1
    rows = np.asarray([3, 7, park, 1, 9, 0, 5, park, park, park], np.int32)
    fresh = np.asarray([0, 1, 0, 0, 0, 1, 0, 0, 0, 0], np.int32)
    keys, starts, ends = [], [], []
    for r in rows:
        starts.append(len(keys))
        if r != park:
            n = int(rng.integers(1, 300))
            cells = rng.integers(0, 64, n) * (cpg // 64)
            keys.extend(sorted((cells << 1) | rng.integers(0, 2, n)))
        ends.append(len(keys))
    keys = np.asarray(keys + [2**31 - 1] * 5, np.int32)  # sentinel tail
    return bank, rows, np.asarray(starts, np.int32), np.asarray(ends, np.int32), keys, fresh, cpg


@pytest.mark.parametrize("seed", [0, 1])
def test_apply_grouped_rows_plain_matches_pallas(seed):
    bank, rows, starts, ends, keys, fresh, cpg = _grouped_case(seed)
    kw = dict(cells_per_group=cpg, hit_odds=HIT_ODDS, miss_odds=MISS_ODDS)
    out_j = np.asarray(JP.apply_grouped_rows(
        jnp.asarray(bank), jnp.asarray(rows), jnp.asarray(starts), jnp.asarray(ends),
        jnp.asarray(keys), fresh=jnp.asarray(fresh), **kw))
    bank_t = torch.from_numpy(bank.copy())
    out_t = TP.apply_grouped_rows(
        bank_t, *(torch.from_numpy(x) for x in (rows, starts, ends, keys)),
        fresh=torch.from_numpy(fresh), **kw)
    assert out_t is bank_t  # in place
    np.testing.assert_array_equal(out_j, out_t.numpy())
    assert (out_j != bank).any()
    assert TP.LAUNCHES == 0


def test_group_tables_and_keys():
    rng = np.random.default_rng(5)
    group_of = np.sort(rng.integers(0, 40, 500)).astype(np.int32)
    valid = np.ones(500, bool)
    valid[-37:] = False
    for num_groups in (8, 64):
        tj = JP.build_group_tables(jnp.asarray(group_of), jnp.asarray(valid), num_groups)
        tt = TP.build_group_tables(torch.from_numpy(group_of), torch.from_numpy(valid), num_groups)
        for a, b in zip(tj, tt):
            assert b.dtype == torch.int32
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    cell = rng.integers(0, 4096, 500).astype(np.int32)
    hit = rng.random(500) < 0.5
    np.testing.assert_array_equal(
        np.asarray(JP.pack_keys(*(jnp.asarray(x) for x in (group_of, cell, hit, valid)), 4096)),
        TP.pack_keys(*(torch.from_numpy(x) for x in (group_of, cell, hit, valid)), 4096).numpy())
    assert TP.cell_bits(16384) == JP.cell_bits(16384)
    assert TP.dense_bank_size(32**3, 2, 8) == JP.dense_bank_size(32**3, 2, 8)


def _to_torch(bank):
    return TB.BrickBank(*(torch.from_numpy(np.array(x)) for x in bank))


def _assert_bank_equal(jbank, tbank):
    for f in JB.BrickBank._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jbank, f)), getattr(tbank, f).numpy(),
                                      err_msg=f)


def _insert_both(spec_kw, jbank, tbank, origins, hits, masks):
    kw = dict(hit_probability=0.55, miss_probability=0.49, num_free_space_voxels=2)
    jbank = JB._insert_brick_slots(jbank, jnp.asarray(origins), jnp.asarray(hits),
                                   jnp.asarray(masks), spec=JB.BrickGridSpec(**spec_kw), **kw)
    tbank = TB._insert_brick_slots(tbank, torch.from_numpy(origins), torch.from_numpy(hits),
                                   torch.from_numpy(masks), spec=TB.BrickGridSpec(**spec_kw), **kw)
    return jbank, tbank


CASES = {
    # clustered points: duplicate records, mixed hit/miss
    "duplicates": (dict(resolution=0.1, dir_extent=16, max_bricks=768, apply_groups=128), 0.8),
    # spread points into a small pool: pool-full drops
    "pool_full": (dict(resolution=0.1, dir_extent=16, max_bricks=256, apply_groups=128), 3.0),
    # more touched groups than apply capacity: whole-group drops
    "apply_capacity": (dict(resolution=0.1, dir_extent=16, max_bricks=256, apply_groups=2), 3.0),
    # 8-brick groups (the low grid's layout)
    "small_groups": (dict(resolution=0.45, dir_extent=8, max_bricks=512, apply_groups=48,
                          apply_group_bricks=8), 4.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_insert_brick_slots_exact(case):
    spec_kw, spread = CASES[case]
    rng = np.random.default_rng(7)
    n = 384
    hits = rng.normal(0, spread, (2, n, 3)).astype(np.float32)
    hits[:, : n // 4] = hits[:, n // 4 : n // 2]
    masks = rng.random((2, n)) < 0.9
    origins = rng.normal(0, 0.3, (2, 3)).astype(np.float32)
    jbank = JB.make_brick_bank(JB.BrickGridSpec(**spec_kw))
    tbank = TB.make_brick_bank(TB.BrickGridSpec(**spec_kw))
    _assert_bank_equal(jbank, tbank)
    for _ in range(2):
        jbank, tbank = _insert_both(spec_kw, jbank, tbank, origins, hits, masks)
        hits = hits + np.float32(0.3)
    _assert_bank_equal(jbank, tbank)
    assert int(tbank.counts.sum()) > 0
    if case in ("pool_full", "apply_capacity"):
        assert int(tbank.dropped[0]) > 0


def test_reset_slot_recycling_and_epoch_wrap():
    spec_kw = dict(resolution=0.1, dir_extent=16, max_bricks=768, apply_groups=128)
    jspec, tspec = JB.BrickGridSpec(**spec_kw), TB.BrickGridSpec(**spec_kw)
    rng = np.random.default_rng(11)
    masks = np.ones((2, 256), bool)
    origins = np.zeros((2, 3), np.float32)
    jbank = JB.make_brick_bank(jspec)
    # start slot 0 one reset short of the epoch wrap
    jbank = jbank._replace(epochs=jnp.asarray([jspec.epoch_mask - 1, 0], jnp.int32))
    tbank = _to_torch(jbank)
    for epoch in range(3):
        hits = rng.normal(0.1 * epoch, 0.8, (2, 256, 3)).astype(np.float32)
        jbank, tbank = _insert_both(spec_kw, jbank, tbank, origins, hits, masks)
        pending = epoch != 1  # one gated-off reset
        jbank = JB.reset_slot(jbank, jspec, 0, jnp.bool_(pending))
        tbank = TB.reset_slot(tbank, tspec, torch.tensor(0), torch.tensor(pending))
        _assert_bank_equal(jbank, tbank)
    assert int(tbank.epochs[0]) == 0  # wrapped through epoch_mask


def test_brick_lookups():
    spec_kw = dict(resolution=0.1, dir_extent=16, max_bricks=768, apply_groups=128)
    rng = np.random.default_rng(13)
    hits = rng.normal(0, 0.8, (2, 384, 3)).astype(np.float32)
    jbank, tbank = _insert_both(spec_kw, JB.make_brick_bank(JB.BrickGridSpec(**spec_kw)),
                                TB.make_brick_bank(TB.BrickGridSpec(**spec_kw)),
                                np.zeros((2, 3), np.float32), hits, np.ones((2, 384), bool))
    pts = rng.normal(0, 1.0, (2000, 3)).astype(np.float32)
    cells = rng.integers(-70, 70, (2000, 3)).astype(np.int32)
    for slot in (0, 1):
        np.testing.assert_array_equal(
            np.asarray(JB.lookup_value_brick(jbank, jnp.asarray(cells), JB.BrickGridSpec(**spec_kw), slot)),
            TB.lookup_value_brick(tbank, torch.from_numpy(cells), TB.BrickGridSpec(**spec_kw), slot).numpy())
        pj = JB.interpolated_probability_brick(jbank, jnp.asarray(pts), JB.BrickGridSpec(**spec_kw), slot)
        pt = TB.interpolated_probability_brick(tbank, torch.from_numpy(pts), TB.BrickGridSpec(**spec_kw), slot)
        np.testing.assert_allclose(np.asarray(pj), pt.numpy(), atol=1e-6)


def test_xla_fallback_not_ported():
    spec = TB.BrickGridSpec(resolution=0.1, dir_extent=16, max_bricks=768, apply_groups=0)
    with pytest.raises(NotImplementedError):
        TB._insert_brick_slots(TB.make_brick_bank(spec), torch.zeros(2, 3), torch.zeros(2, 4, 3),
                               torch.ones(2, 4, dtype=torch.bool), spec=spec, hit_probability=0.55,
                               miss_probability=0.49, num_free_space_voxels=2)

