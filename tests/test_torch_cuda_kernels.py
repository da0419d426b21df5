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
