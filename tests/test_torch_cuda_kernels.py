"""On-card tests of the port's CUDA kernels against their plain PyTorch
versions (marked `cuda`; they skip where torch.cuda.is_available() is
false). This file imports no jax, so it runs on a CUDA host without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py

(`--noconftest`: tests/conftest.py configures JAX for the rest of the suite.)
K1 must be bit-identical; K2 agrees to rtol 1e-5 / atol 1e-6, the
tolerance of the CPU parity tests.
"""

import numpy as np
import pytest
import torch

from dliom_tpu_torch.common.config import load_config
from dliom_tpu_torch.imu import affine_chain as K2
from dliom_tpu_torch.mapping import brick_grid as TB
from dliom_tpu_torch.ops import grouped_apply as K1

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _grouped_case(rng, groups, cpg, steps):
    """Bank and tables with duplicate cells, mixed hit/miss, fresh steps and
    empty-range steps that share the parking row groups-1."""
    bank = rng.integers(0, 32768, groups * cpg).astype(np.int16)
    park = groups - 1
    rows = np.full(steps, park, np.int32)
    real = steps * 3 // 4
    rows[:real] = rng.choice(park, real, replace=False)
    rows[1] = park  # a mid-sequence drop
    fresh = (rng.random(steps) < 0.2).astype(np.int32) * (rows != park)
    keys, starts, ends = [], [], []
    for r in rows:
        starts.append(len(keys))
        if r != park:
            n = int(rng.integers(1, 400))
            keys.extend(sorted((rng.integers(0, cpg // 8, n) * 8 << 1) | rng.integers(0, 2, n)))
        ends.append(len(keys))
    keys = np.asarray(keys + [2**31 - 1] * 3, np.int32)
    return [torch.from_numpy(x) for x in
            (bank, rows, np.asarray(starts, np.int32), np.asarray(ends, np.int32), keys, fresh)]


@pytest.mark.parametrize("cpg,groups,steps", [(16384, 64, 48), (4096, 96, 64), (256, 40, 30)])
def test_grouped_apply_kernel_matches_plain(cuda_device, cpg, groups, steps):
    bank, rows, starts, ends, keys, fresh = (
        x.to(cuda_device) for x in _grouped_case(np.random.default_rng(cpg), groups, cpg, steps))
    kw = dict(cells_per_group=cpg, hit_odds=0.55 / 0.45, miss_odds=0.49 / 0.51, fresh=fresh)
    launches = K1.LAUNCHES
    k = K1.apply_grouped_rows(bank.clone(), rows, starts, ends, keys, **kw)
    p = K1.apply_grouped_rows_plain(bank.clone(), rows, starts, ends, keys, **kw)
    torch.cuda.synchronize()
    assert K1.LAUNCHES == launches + 1
    assert torch.equal(k, p)
    assert not torch.equal(k, bank)


def test_grouped_apply_rejects_bad_input(cuda_device):
    bank, rows, starts, ends, keys, fresh = (
        x.to(cuda_device) for x in _grouped_case(np.random.default_rng(0), 8, 1024, 6))
    with pytest.raises(ValueError):
        K1.apply_grouped_rows(bank, rows.long(), starts, ends, keys, cells_per_group=1024,
                              hit_odds=1.2, miss_odds=0.9, fresh=fresh)


def test_brick_insert_cuda_matches_cpu(cuda_device):
    """The whole grouped insert (tables, allocation, K1) on the card against
    the CPU run of the same code, where K1 runs plain."""
    spec = TB.BrickGridSpec(resolution=0.1, dir_extent=16, max_bricks=768, apply_groups=128)
    rng = np.random.default_rng(1)
    hits = torch.from_numpy(rng.normal(0, 1.5, (2, 512, 3)).astype(np.float32))
    masks = torch.from_numpy(rng.random((2, 512)) < 0.9)
    origins = torch.from_numpy(rng.normal(0, 0.3, (2, 3)).astype(np.float32))
    kw = dict(spec=spec, hit_probability=0.55, miss_probability=0.49, num_free_space_voxels=2)
    cpu = TB.make_brick_bank(spec)
    gpu = TB.make_brick_bank(spec, cuda_device)
    for slot in (0, 1, 0):
        cpu = TB._insert_brick_slots(cpu, origins, hits, masks, **kw)
        gpu = TB._insert_brick_slots(gpu, origins.to(cuda_device), hits.to(cuda_device),
                                     masks.to(cuda_device), **kw)
        cpu = TB.reset_slot(cpu, spec, slot)
        gpu = TB.reset_slot(gpu, spec, torch.tensor(slot, device=cuda_device))
        hits = hits + 0.2
    for f in TB.BrickBank._fields:
        assert torch.equal(getattr(gpu, f).cpu(), getattr(cpu, f)), f


def test_brick_records_insert_cuda_matches_cpu(cuda_device):
    """The per-record insert (`apply_groups` 0, plain PyTorch on both
    devices) and its slot reset, pending or not, on the card against the
    CPU run of the same code, bit for bit."""
    spec = TB.BrickGridSpec(resolution=0.1, dir_extent=16, max_bricks=768, apply_groups=0)
    rng = np.random.default_rng(2)
    hits = torch.from_numpy(rng.normal(0, 1.5, (2, 512, 3)).astype(np.float32))
    masks = torch.from_numpy(rng.random((2, 512)) < 0.9)
    origins = torch.from_numpy(rng.normal(0, 0.3, (2, 3)).astype(np.float32))
    kw = dict(spec=spec, hit_probability=0.55, miss_probability=0.49, num_free_space_voxels=2)
    cpu = TB.make_brick_bank(spec)
    gpu = TB.make_brick_bank(spec, cuda_device)
    for slot, pending in ((0, True), (1, False), (1, True)):
        cpu = TB._insert_brick_slots(cpu, origins, hits, masks, **kw)
        gpu = TB._insert_brick_slots(gpu, origins.to(cuda_device), hits.to(cuda_device),
                                     masks.to(cuda_device), **kw)
        cpu = TB.reset_slot(cpu, spec, slot, torch.tensor(pending))
        gpu = TB.reset_slot(gpu, spec, torch.tensor(slot, device=cuda_device),
                            torch.tensor(pending, device=cuda_device))
        hits = hits + 0.2
    for f in TB.BrickBank._fields:
        assert torch.equal(getattr(gpu, f).cpu(), getattr(cpu, f)), f


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("m", [1, 7, 32, 48, 64, 200])
def test_affine_chain_scan_lengths(cuda_device, m, batch):
    """The scan at chain lengths below, at and above one sample per warp,
    at the dynamic initializer's padded segment of 32, the bench config's
    48, the default 64, and 200 (more samples per warp than its ring
    holds), with a masked tail of (I, 0) samples."""
    rng = np.random.default_rng(m * 10 + batch)
    f = np.eye(15) + 0.01 * rng.normal(size=(batch, m, 15, 15))
    q = rng.normal(size=(batch, m, 15, 15)) * 1e-3
    tail = m // 4
    if tail:
        f[:, -tail:] = np.eye(15)
        q[:, -tail:] = 0.0
    f, q = (torch.from_numpy(x.astype(np.float32)).to(cuda_device) for x in (f, q))
    launches = K2.LAUNCHES
    a_k, p_k = K2.affine_chain(f, q)
    a_p, p_p = K2.affine_chain_plain(f, q)
    torch.cuda.synchronize()
    assert K2.LAUNCHES == launches + 1
    torch.testing.assert_close(a_k, a_p, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(p_k, p_p, rtol=1e-5, atol=1e-6)


def test_affine_chain_kernel_matches_plain(cuda_device):
    rng = np.random.default_rng(4)
    f = torch.from_numpy((np.eye(15) + 0.01 * rng.normal(size=(3, 48, 15, 15))).astype(np.float32))
    q = torch.from_numpy(rng.normal(size=(3, 48, 15, 15)).astype(np.float32) * 1e-3)
    f, q = f.to(cuda_device), q.to(cuda_device)
    launches = K2.LAUNCHES
    a_k, p_k = K2.affine_chain(f, q)
    a_p, p_p = K2.affine_chain_plain(f, q)
    a_1, p_1 = K2.affine_chain(f[1], q[1])  # unbatched entry
    torch.cuda.synchronize()
    assert K2.LAUNCHES == launches + 2
    torch.testing.assert_close(a_k, a_p, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(p_k, p_p, rtol=1e-5, atol=1e-6)
    assert torch.equal(a_1, a_k[1]) and torch.equal(p_1, p_k[1])


def _dense_keys(rng, groups_touched, num_records, cpg=16384, cells=None):
    """Sorted packed keys over `groups_touched` groups of a dense bank, with
    duplicate cells (4 apart, or `cells` distinct ones), mixed hit/miss and
    sentinel padding; every group has a valid record."""
    group = rng.integers(0, groups_touched, num_records).astype(np.int32)
    group[:groups_touched] = np.arange(groups_touched)
    cell = rng.integers(0, cells, num_records) if cells else rng.integers(0, cpg // 4, num_records) * 4
    cell = cell.astype(np.int32)
    hit = rng.integers(0, 2, num_records).astype(np.int32)
    valid = rng.random(num_records) < 0.95
    valid[:groups_touched] = True
    valid = torch.from_numpy(valid)
    keys = K1.pack_keys(torch.from_numpy(group), torch.from_numpy(cell), torch.from_numpy(hit),
                        valid, cpg)
    return torch.sort(keys).values


@pytest.mark.parametrize("extent,capacity,touched", [(128, 256, 256), (128, 64, 200),
                                                     (128, 256, 100), (64, 256, 32)])
def test_dense_grouped_updates_kernel_matches_plain(cuda_device, extent, capacity, touched):
    """K1's dense entry at bench_e2e's 2 x 128^3 and 2 x 64^3 banks with
    their padding group: bank and `dropped` bit-identical to the plain
    version (64 of 200 touched groups overflow in the second case; the last
    two park 156 and 224 steps on the padding group), and the padding group
    comes back unchanged."""
    rng = np.random.default_rng(capacity + touched)
    cpg, groups = 16384, 2 * extent ** 3 // 16384 + 1
    bank = torch.from_numpy(rng.integers(0, 32768, groups * cpg).astype(np.int16)).to(cuda_device)
    keys = _dense_keys(rng, touched, 49152).to(cuda_device)
    kw = dict(num_groups=capacity, cells_per_group=cpg, hit_odds=0.55 / 0.45,
              miss_odds=0.49 / 0.51, dummy_group=groups - 1)
    launches, dense = K1.LAUNCHES, K1.DENSE_LAUNCHES
    k, kd = K1.apply_grouped_updates(bank.clone(), keys, **kw)
    p, pd = K1.apply_grouped_updates_plain(bank.clone(), keys, **kw)
    torch.cuda.synchronize()
    assert K1.LAUNCHES == launches + 1 and K1.DENSE_LAUNCHES == dense + 1
    assert torch.equal(k, p)
    assert int(kd) == int(pd) == max(0, touched - capacity)
    assert torch.equal(k[-cpg:], bank[-cpg:])
    assert not torch.equal(k, bank)


# The table kernel's edge cases on bench_e2e's 2 x 128^3 bank (256 groups
# and the padding group 256): (capacity, touched groups, records, distinct
# cells per group or None).
DENSE_EDGE_CASES = {
    "all_sentinel": (256, [], 49152, None),
    "one_group": (256, [17], 49152, None),
    "exact_capacity": (64, list(range(0, 256, 4)), 49152, None),
    "capacity_plus_one": (64, list(range(0, 260, 4)), 49152, None),
    "last_real_group": (256, [3, 254, 255], 49152, None),
    "duplicate_heavy": (256, [9, 10], 3000, 12),
}


@pytest.mark.parametrize("name", sorted(DENSE_EDGE_CASES))
def test_dense_table_edge_cases_match_plain(cuda_device, name):
    """The dense entry (table kernel, then K1) against its plain version:
    bank and `dropped` bit-identical, the padding group unchanged, one
    launch counted."""
    capacity, touched, records, cells = DENSE_EDGE_CASES[name]
    rng = np.random.default_rng(len(name))
    cpg, groups = 16384, 257
    bank = torch.from_numpy(rng.integers(0, 32768, groups * cpg).astype(np.int16)).to(cuda_device)
    if touched:
        keys = _dense_keys(rng, len(touched), records, cpg, cells)
        # map group ids 0..len-1 onto the touched groups, keeping the order
        cb = K1.cell_bits(cpg)
        valid = keys != 2**31 - 1
        remap = torch.tensor(touched, dtype=torch.int32)[torch.clamp(keys >> cb, max=len(touched) - 1).long()]
        keys = torch.where(valid, (remap << cb) | (keys & ((1 << cb) - 1)), keys)
    else:
        keys = torch.full((records,), 2**31 - 1, dtype=torch.int32)
    keys = keys.to(cuda_device)
    kw = dict(num_groups=capacity, cells_per_group=cpg, hit_odds=0.55 / 0.45,
              miss_odds=0.49 / 0.51, dummy_group=groups - 1)
    launches, dense = K1.LAUNCHES, K1.DENSE_LAUNCHES
    k, kd = K1.apply_grouped_updates(bank.clone(), keys, **kw)
    p, pd = K1.apply_grouped_updates_plain(bank.clone(), keys, **kw)
    torch.cuda.synchronize()
    assert K1.LAUNCHES == launches + 1 and K1.DENSE_LAUNCHES == dense + 1
    assert torch.equal(k, p)
    assert int(kd) == int(pd) == max(0, len(touched) - capacity)
    assert torch.equal(k[-cpg:], bank[-cpg:])
    assert torch.equal(k, bank) == (not touched)


def test_dense_insert_cuda_matches_cpu(cuda_device):
    """The dense grouped insert (`_insert_slots`: records, sort, tables, K1)
    on the card against the CPU run of the same code, where K1 runs plain."""
    from dliom_tpu_torch.mapping.grid import GridSpec
    from dliom_tpu_torch.ops.grid_update import _insert_slots

    spec = GridSpec(0.2, 64, 32)
    rng = np.random.default_rng(2)
    kw = dict(spec=spec, hit_probability=0.55, miss_probability=0.49, num_free_space_voxels=2)
    cpu = torch.zeros(K1.dense_bank_size(spec.num_cells, 2, 32), dtype=torch.int16)
    gpu = cpu.to(cuda_device)
    for _ in range(3):
        hits = torch.from_numpy(rng.normal(0, 3.0, (2, 2048, 3)).astype(np.float32))
        masks = torch.from_numpy(rng.random((2, 2048)) < 0.9)
        origins = torch.from_numpy(rng.normal(0, 0.3, (2, 3)).astype(np.float32))
        _, dc = _insert_slots(cpu, origins, hits, masks, **kw)
        _, dg = _insert_slots(gpu, origins.to(cuda_device), hits.to(cuda_device),
                              masks.to(cuda_device), **kw)
        assert int(dc) == int(dg)
    assert torch.equal(gpu.cpu(), cpu)


def test_map_builder_defaults_to_the_card(cuda_device):
    """Without `device`, MapBuilder and its PoseGraph run on the card."""
    from dliom_tpu_torch.map_builder import MapBuilder

    builder = MapBuilder(load_config("basic"))
    assert builder.device.type == "cuda" and builder.pose_graph.device.type == "cuda"
