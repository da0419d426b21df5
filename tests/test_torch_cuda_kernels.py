"""On-card tests of the port's CUDA kernels against their plain PyTorch
versions (marked `cuda`; they skip where torch.cuda.is_available() is
false). This file imports no jax, so it runs on a CUDA host without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py

(`--noconftest`: tests/conftest.py configures JAX for the rest of the suite.)
K1 must be bit-identical; K2 agrees to rtol 1e-5 / atol 1e-6, the
tolerance of the CPU parity tests. The float segment sums
(ops/segment.py) give the same bits on every run on the card, at each of
their sites, and the CPU's bits; the batched step (parallel/batch.py)
launches K1 once per brick grid and K2 once per step, whatever B is.
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


@pytest.mark.parametrize("batch", [1, 2, 4, 8])
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


def test_brick_insert_16_slots_cuda_matches_cpu(cuda_device):
    """K1's brick entry over the 16 slots of a batched step at B = 8, with
    8 x the capacity, on the card against the CPU run, where K1 runs plain."""
    spec = TB.BrickGridSpec(resolution=0.1, dir_extent=16, max_bricks=768, apply_groups=8 * 128)
    rng = np.random.default_rng(4)
    lanes = 8
    kw = dict(spec=spec, hit_probability=0.55, miss_probability=0.49, num_free_space_voxels=2)
    cpu = TB.make_brick_bank(spec, lanes=lanes)
    gpu = TB.make_brick_bank(spec, cuda_device, lanes=lanes)
    hits = torch.from_numpy(rng.normal(0, 1.5, (2 * lanes, 512, 3)).astype(np.float32))
    masks = torch.from_numpy(rng.random((2 * lanes, 512)) < 0.9)
    origins = torch.from_numpy(rng.normal(0, 0.3, (2 * lanes, 3)).astype(np.float32))
    for r in range(3):
        launches = K1.LAUNCHES
        cpu = TB._insert_brick_slots(cpu, origins, hits, masks, **kw)
        gpu = TB._insert_brick_slots(gpu, origins.to(cuda_device), hits.to(cuda_device),
                                     masks.to(cuda_device), **kw)
        assert K1.LAUNCHES == launches + 1
        slots = torch.arange(lanes, dtype=torch.int32) * 2 + r % 2
        pending = torch.arange(lanes) % 2 == r % 2
        cpu = TB.reset_slot(cpu, spec, slots, pending)
        gpu = TB.reset_slot(gpu, spec, slots.to(cuda_device), pending.to(cuda_device))
        hits = hits + 0.2
    for f in TB.BrickBank._fields:
        assert torch.equal(getattr(gpu, f).cpu(), getattr(cpu, f)), f
    assert int(cpu.counts.sum()) > 0 and int(cpu.epochs.sum()) > 0


def _twice(fn, *args):
    """fn(*args) twice on the card, flattened to tensors."""
    outs = []
    for _ in range(2):
        out = fn(*args)
        torch.cuda.synchronize()
        outs.append([x.cpu() for x in torch.utils._pytree.tree_leaves(out) if isinstance(x, torch.Tensor)])
    return outs


@pytest.mark.parametrize("shape", [(), (3,), (3, 3)])
def test_segment_sum_deterministic(cuda_device, shape):
    """Many values into few segments, twice on the card: equal bits, and
    the CPU's bits (the same order of addition)."""
    from dliom_tpu_torch.ops.segment import segment_sum

    rng = np.random.default_rng(5)
    values = torch.from_numpy((rng.normal(size=(200000,) + shape) * 100).astype(np.float32))
    ids = torch.from_numpy(rng.integers(-5, 130, 200000))
    a, b = _twice(segment_sum, values.to(cuda_device), ids.to(cuda_device), 121)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(a[0], segment_sum(values, ids, 121))


def test_histogram_deterministic(cuda_device):
    """compute_histogram (slice centroids and buckets), one lane and a
    batch of lanes, twice on the card: equal bits, and the CPU's."""
    from dliom_tpu_torch.ops.rotational_histogram import compute_histogram

    rng = np.random.default_rng(6)
    pts = torch.from_numpy(rng.normal(0, 8.0, (4, 8192, 3)).astype(np.float32))
    mask = torch.from_numpy(rng.random((4, 8192)) < 0.95)
    for p, m in ((pts[0], mask[0]), (pts, mask)):
        a, b = _twice(compute_histogram, p.to(cuda_device), m.to(cuda_device))
        assert torch.equal(a[0], b[0])
        torch.testing.assert_close(a[0], compute_histogram(p, m), rtol=1e-5, atol=1e-5)
    one = compute_histogram(pts[1].to(cuda_device), mask[1].to(cuda_device))
    assert torch.equal(compute_histogram(pts.to(cuda_device), mask.to(cuda_device))[1], one)


def test_ndt_field_deterministic(cuda_device):
    from dliom_tpu_torch.mapping.grid import GridSpec
    from dliom_tpu_torch.ops.ndt import build_field

    rng = np.random.default_rng(7)
    pts = torch.from_numpy(rng.normal(0, 5.0, (16384, 3)).astype(np.float32)).to(cuda_device)
    mask = torch.ones(16384, dtype=torch.bool, device=cuda_device)
    a, b = _twice(build_field, pts, mask, GridSpec(1.0, 64))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_initialization_normal_equations_deterministic(cuda_device):
    from dliom_tpu_torch.imu.initialization import _normal_equations

    rng = np.random.default_rng(8)
    blk = torch.from_numpy(rng.normal(size=(9, 6, 9)).astype(np.float32)).to(cuda_device)
    rhs = torch.from_numpy(rng.normal(size=(9, 6)).astype(np.float32)).to(cuda_device)
    m = torch.ones(9, device=cuda_device)
    a, b = _twice(_normal_equations, blk, rhs, m)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_spa_solve_deterministic(cuda_device):
    """The SPA's segment sums (J^T u per submap and node, the Jacobi
    diagonal, fixed-frame weights): the solve twice on the card, equal bits."""
    from dliom_tpu_torch.backend import optimization as opt

    rng = np.random.default_rng(9)
    d = opt.make_pose_graph_data(8, 64, 512, device=cuda_device)
    c = 400
    sub = torch.from_numpy(rng.integers(0, 8, c).astype(np.int32))
    node = torch.from_numpy(rng.integers(0, 64, c).astype(np.int32))
    st = torch.from_numpy(rng.normal(0, 3.0, (8, 3)).astype(np.float32))
    nt = torch.from_numpy(rng.normal(0, 3.0, (64, 3)).astype(np.float32))
    rel = nt[node.long()] - st[sub.long()] + torch.from_numpy(rng.normal(0, 0.05, (c, 3)).astype(np.float32))

    def put(x, v):
        x = x.clone()
        x[: v.shape[0]] = v.to(x.device)
        return x

    d = d._replace(
        submap_t=st.to(cuda_device) + 0.1, submap_valid=torch.ones(8, dtype=torch.bool, device=cuda_device),
        node_t=nt.to(cuda_device) - 0.1, node_valid=torch.ones(64, dtype=torch.bool, device=cuda_device),
        c_submap=put(d.c_submap, sub), c_node=put(d.c_node, node), c_t=put(d.c_t, rel),
        c_trans_weight=put(d.c_trans_weight, torch.ones(c)), c_rot_weight=put(d.c_rot_weight, torch.ones(c)),
        c_valid=put(d.c_valid, torch.ones(c, dtype=torch.bool)),
        ff_node=put(d.ff_node, torch.arange(8, dtype=torch.int32)), ff_t=put(d.ff_t, nt[:8]),
        ff_weight=put(d.ff_weight, torch.ones(8)), ff_valid=put(d.ff_valid, torch.ones(8, dtype=torch.bool)))
    a, b = _twice(lambda x: opt.solve(x, iterations=3, cg_iterations=16), d)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_batched_step_launches(cuda_device):
    """One batched LIO step at B = 1 and B = 4: one K2 call and one K1 call
    per brick grid, whatever B is; lane 0 of B = 4 takes the B = 1 pose."""
    from dliom_tpu_torch.frontend.lio import LioScanInput
    from dliom_tpu_torch.io.synthetic import SyntheticWorld, corkscrew_trajectory
    from dliom_tpu_torch.parallel.batch import make_batched_lio_state, make_batched_lio_step
    from dliom_tpu_torch.sensor.types import pad_point_cloud

    cfg = load_config("basic", {"trajectory_builder": {
        "scan_period": 0.1, "voxel_filter_size": 0.3, "enable_gravity_factor": False,
        "submaps": {"high_resolution": 0.2, "low_resolution": 0.5, "num_range_data": 2,
                    "use_brick_grid": True, "brick_dir_extent": 16, "brick_max_bricks": 4096,
                    "brick_apply_groups": 2048, "use_brick_grid_low": True, "low_brick_dir_extent": 8,
                    "low_brick_max_bricks": 512, "low_brick_apply_groups": 1024,
                    "low_brick_apply_group_bricks": 8},
        "max_filtered_points": 1024, "max_high_res_points": 256, "max_low_res_points": 256,
        "max_imu_per_scan": 16, "window_size": 3, "gn_iterations": 2}}).trajectory_builder
    world = SyntheticWorld.create(num_beams=8, num_azimuths=200)
    cloud = pad_point_cloud(*world.cast_scan(corkscrew_trajectory()[3][1]), 2048)
    poses = {}
    for lanes in (1, 4):
        def stack(x, dtype=None):
            return torch.from_numpy(np.stack([np.asarray(x)] * lanes)).to(cuda_device, dtype)

        inp = LioScanInput(
            time=torch.full((lanes,), 0.1, device=cuda_device), points=stack(cloud.points),
            times=stack(cloud.times), mask=stack(cloud.mask),
            imu_dts=torch.full((lanes, 16), 0.00625, device=cuda_device),
            imu_acc=torch.tensor([0.0, 0.0, 9.80511], device=cuda_device).repeat(lanes, 16, 1),
            imu_gyr=torch.zeros(lanes, 16, 3, device=cuda_device),
            imu_mask=torch.ones(lanes, 16, dtype=torch.bool, device=cuda_device))
        state = make_batched_lio_state(cfg, lanes, cuda_device)
        step = make_batched_lio_step(cfg, lanes)
        k1, k2 = K1.LAUNCHES, K2.LAUNCHES
        for _ in range(2):
            state, res = step(state, inp)
        torch.cuda.synchronize()
        assert (K1.LAUNCHES - k1, K2.LAUNCHES - k2) == (4, 2)
        poses[lanes] = res.scan.local_pose.translation.cpu()
    torch.testing.assert_close(poses[4][0], poses[1][0], atol=2e-4, rtol=0)
