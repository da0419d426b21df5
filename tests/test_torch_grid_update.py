"""Parity of dense-bank insertion (dliom_tpu_torch/ops/grid_update.py) and
K1's dense entry (ops/grouped_apply.py::apply_grouped_updates) with the JAX
package. All state is integer and must match exactly: the banks and
`dropped` after `_insert_slots` on the sort/scatter branch and on the
grouped branch (JAX's Pallas kernel runs in interpret mode on the CPU, as
in tests/test_pallas_apply.py), including a capacity overflow; the
single-slot `insert_range_data`; and the padding group, on which several
unused steps park, coming back unchanged."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dliom_tpu.mapping.grid import GridSpec as JGridSpec
from dliom_tpu.ops import grid_update as JG
from dliom_tpu.ops import pallas_apply as JP
from dliom_tpu_torch.mapping.grid import GridSpec as TGridSpec
from dliom_tpu_torch.ops import grid_update as TG
from dliom_tpu_torch.ops import grouped_apply as TP
import torch_threads  # noqa: F401  (one torch thread per test process)

KW = dict(hit_probability=0.55, miss_probability=0.49, num_free_space_voxels=2)


def _scan(seed, n=700, spread=1.2):
    """Two slots of clustered hits (duplicate cells, mixed hit/miss) with
    some points outside the grid and some masked out."""
    rng = np.random.default_rng(seed)
    hits = rng.normal(0, spread, (2, n, 3)).astype(np.float32)
    hits[:, : n // 4] = hits[:, n // 4: n // 2]
    hits[:, -20:] *= 20.0  # out of bounds
    masks = rng.random((2, n)) < 0.9
    origins = rng.normal(0, 0.3, (2, 3)).astype(np.float32)
    return origins, hits, masks


def _both(fn_j, fn_t, bank, origins, hits, masks, spec_args):
    jb, jd = fn_j(jnp.asarray(bank), jnp.asarray(origins), jnp.asarray(hits), jnp.asarray(masks),
                  spec=JGridSpec(*spec_args), **KW)
    tbank = torch.from_numpy(bank.copy())
    tb, td = fn_t(tbank, torch.from_numpy(origins), torch.from_numpy(hits),
                  torch.from_numpy(masks), spec=TGridSpec(*spec_args), **KW)
    assert tb.data_ptr() == tbank.data_ptr(), "the port inserts in place"
    return (np.asarray(jb), int(jd)), (tb.numpy(), int(td))


@pytest.mark.parametrize("seed", [0, 1])
def test_insert_slots_sort_branch_bit_identical(seed):
    """apply_groups == 0: the sort/scatter branch, three inserts."""
    spec_args = (0.1, 32, 0)
    bank = np.zeros(2 * 32 ** 3, np.int16)
    for k in range(3):
        (jb, jd), (tb, td) = _both(JG._insert_slots, TG._insert_slots, bank,
                                   *_scan(seed * 10 + k), spec_args)
        np.testing.assert_array_equal(tb, jb)
        assert jd == td == 0
        bank = jb
    assert np.count_nonzero(bank) > 500


@pytest.mark.parametrize("apply_groups", [4, 2])
def test_insert_slots_grouped_branch_bit_identical(apply_groups):
    """apply_groups > 0: K1's dense entry (plain K1 on the CPU) against
    JAX's interpret-mode kernel; 2 groups overflow (4 touched)."""
    spec_args = (0.1, 32, apply_groups)
    n = JP.dense_bank_size(32 ** 3, 2, apply_groups)
    assert n == TP.dense_bank_size(32 ** 3, 2, apply_groups) == 2 * 32 ** 3 + 16384
    bank = np.zeros(n, np.int16)
    drops = []
    for k in range(3):
        (jb, jd), (tb, td) = _both(JG._insert_slots, TG._insert_slots, bank, *_scan(5 + k),
                                   spec_args)
        np.testing.assert_array_equal(tb, jb)
        assert jd == td
        drops.append(td)
        bank = jb
        assert not np.any(bank[2 * 32 ** 3:]), "padding group written"
    assert (sum(drops) > 0) == (apply_groups == 2)


def test_grouped_equals_sort_branch_when_nothing_drops():
    """At a capacity that holds every touched group the grouped branch
    inserts the same map as the sort/scatter branch."""
    origins, hits, masks = (torch.from_numpy(x) for x in _scan(3))
    plain = torch.zeros(2 * 32 ** 3, dtype=torch.int16)
    grouped = torch.zeros(2 * 32 ** 3 + 16384, dtype=torch.int16)
    TG._insert_slots(plain, origins, hits, masks, spec=TGridSpec(0.1, 32, 0), **KW)
    _, d = TG._insert_slots(grouped, origins, hits, masks, spec=TGridSpec(0.1, 32, 4), **KW)
    assert int(d) == 0
    assert torch.equal(grouped[: 2 * 32 ** 3], plain)


def test_insert_range_data_single_slot_bit_identical():
    spec_args = (0.2, 32, 0)
    origins, hits, masks = _scan(7)
    bank = np.zeros(2 * 32 ** 3, np.int16)
    for slot in (1, 0, 1):
        jb = JG.insert_range_data(jnp.asarray(bank), jnp.asarray(origins[slot]),
                                  jnp.asarray(hits[slot]), jnp.asarray(masks[slot]),
                                  spec=JGridSpec(*spec_args), slot=slot, **KW)
        tb = TG.insert_range_data(torch.from_numpy(bank.copy()), torch.from_numpy(origins[slot]),
                                  torch.from_numpy(hits[slot]), torch.from_numpy(masks[slot]),
                                  spec=TGridSpec(*spec_args), slot=slot, **KW)
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        bank = np.asarray(jb)


def test_insert_range_data_dual_bit_identical():
    spec_args = (0.1, 32, 4)
    bank = np.zeros(2 * 32 ** 3 + 16384, np.int16)
    (jb, jd), (tb, td) = _both(JG.insert_range_data_dual, TG.insert_range_data_dual, bank,
                               *_scan(11), spec_args)
    np.testing.assert_array_equal(tb, jb)
    assert jd == td


def test_apply_grouped_updates_parks_on_the_padding_group():
    """Many unused steps park on the padding group: it comes back as it
    was (here: non-zero garbage), and `dropped` counts heads beyond the
    capacity, both as the JAX entry computes them."""
    rng = np.random.default_rng(0)
    cpg, groups = 16384, 5
    bank = rng.integers(0, 32768, groups * cpg).astype(np.int16)
    group = rng.integers(0, 3, 900).astype(np.int32)
    cell = rng.integers(0, 300, 900).astype(np.int32) * 16
    is_hit = rng.integers(0, 2, 900).astype(np.int32)
    valid = rng.random(900) < 0.95
    keys = np.sort(np.asarray(JP.pack_keys(jnp.asarray(group), jnp.asarray(cell),
                                           jnp.asarray(is_hit), jnp.asarray(valid), cpg)))
    for cap in (16, 2):
        kw = dict(num_groups=cap, cells_per_group=cpg, hit_odds=0.55 / 0.45,
                  miss_odds=0.49 / 0.51, dummy_group=groups - 1)
        jb, jd = JP.apply_grouped_updates(jnp.asarray(bank), jnp.asarray(keys), **kw)
        tb, td = TP.apply_grouped_updates(torch.from_numpy(bank.copy()), torch.from_numpy(keys), **kw)
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        assert int(td) == int(jd) == (1 if cap == 2 else 0)
        np.testing.assert_array_equal(tb.numpy()[(groups - 1) * cpg:], bank[(groups - 1) * cpg:])
        np.testing.assert_array_equal(tb.numpy()[3 * cpg:(groups - 1) * cpg],
                                      bank[3 * cpg:(groups - 1) * cpg])
