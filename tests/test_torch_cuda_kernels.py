"""On-card tests of the port's CUDA kernels against their plain PyTorch
versions (marked `cuda`; they skip where torch.cuda.is_available() is
false). This file imports no jax, so it runs on a CUDA host without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py

(`--noconftest`: tests/conftest.py configures JAX for the rest of the suite.)
K1 must be bit-identical; K2 agrees to rtol 1e-5 / atol 1e-6, the
tolerance of the CPU parity tests; K3 (the window Gauss-Newton) agrees
with `optimize_plain` on the card field by field, within the bounds of
tests/window_cases.py (none above 1e-3, the bound
tests/test_torch_window.py argues for this solve). The float segment sums
(ops/segment.py) give the same bits on every run on the card, at each of
their sites, and the CPU's bits; the batched step (parallel/batch.py)
launches K1 once per brick grid and K2 and K3 once per step, whatever B
is.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from dliom_tpu_torch.common.config import load_config
from dliom_tpu_torch.imu import affine_chain as K2
from dliom_tpu_torch.imu import window_optimizer as K3
from dliom_tpu_torch.mapping import brick_grid as TB
from dliom_tpu_torch.ops import grouped_apply as K1
from window_cases import FIELDS, field_gaps, out_of_bounds, pushed_windows

pytestmark = pytest.mark.cuda
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


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


@pytest.mark.parametrize("cpg", [16384, 4096])
@pytest.mark.parametrize("name", sorted(chip_smoke.K1_EDGE_CASES))
def test_grouped_apply_edge_cases_match_plain(cuda_device, name, cpg):
    """K1's edge cases (runs across 32-, 128- and 1024-record boundaries,
    hits before and after misses, fresh steps with and without records,
    every step parked, dropped ranges, one group) at the brick shapes'
    group sizes, bit for bit."""
    bank, rows, starts, ends, keys, fresh = (
        torch.from_numpy(x).to(cuda_device)
        for x in chip_smoke.k1_edge_case(name, np.random.default_rng(cpg), cpg, 64))
    kw = dict(cells_per_group=cpg, hit_odds=0.55 / 0.45, miss_odds=0.49 / 0.51, fresh=fresh)
    launches = K1.LAUNCHES
    k = K1.apply_grouped_rows(bank.clone(), rows, starts, ends, keys, **kw)
    p = K1.apply_grouped_rows_plain(bank.clone(), rows, starts, ends, keys, **kw)
    torch.cuda.synchronize()
    assert K1.LAUNCHES == launches + 1
    assert torch.equal(k, p)
    assert torch.equal(k, bank) == (name == "all_parked")


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


def _to(win, dev):
    return K3.WindowState(*(x.to(dev) for x in win))


def _assert_k3_close(got, want, start, iterations, what):
    for f in K3.WindowState._fields:
        if f not in FIELDS:
            assert torch.equal(getattr(got, f), getattr(want, f)), f"{what}: {f}"
    bad = out_of_bounds({f"iterations_{iterations}": field_gaps(got, want, start)})
    assert not bad, f"{what}: {bad}"


@pytest.mark.parametrize("preset,w,gravity,empty_at", [
    ("viral", 4, False, None), ("viral", 4, True, None), ("campus", 4, True, None),
    ("campus", 4, False, 1), ("viral", 6, True, 2), ("campus", 6, False, None)])
def test_window_gn_kernel_matches_plain(cuda_device, preset, w, gravity, empty_at):
    """K3 against `optimize_plain` on the card, after every push of
    tests/window_cases.py's `pushed_windows` (num_keys 2..W, then full and
    slid; an empty preintegration where given), at 8 Gauss-Newton
    iterations and at 1: each of q, p, v, ba, bg within its own bound
    (`out_of_bounds`; the biases' are 1e-7 and 2e-7, below what a wrong
    bias column of the Jacobian moves them), every other field untouched
    and the inputs unwritten; one launch a call."""
    from dliom_tpu_torch.common import graph as cg

    imu, wins = pushed_windows(preset, w, gravity, empty_at)
    for k, win in enumerate(wins):
        card = _to(win, cuda_device)
        kept = _to(win, cuda_device)
        for iterations in (8, 1):
            with cg.cusolver():
                want = K3.optimize_plain(card, imu, imu.gravity, iterations)
            launches = K3.LAUNCHES
            got = K3.optimize(card, imu, imu.gravity, iterations)
            torch.cuda.synchronize()
            assert K3.LAUNCHES == launches + 1
            _assert_k3_close(got, want, card, iterations, f"{preset} push {k} iterations {iterations}")
        assert all(torch.equal(x, y) for x, y in zip(card, kept))


def test_window_gn_kernel_over_lanes(cuda_device):
    """K3 over 18 lanes in one launch (windows full and not, with and
    without gravity rows, an empty preintegration among them): each lane
    bit for bit its own single-lane launch, and within the bounds of
    `optimize_plain`; then a window too large for one block's shared
    memory raises."""
    from torch.utils._pytree import tree_map

    from dliom_tpu_torch.common import graph as cg

    imu, wins = pushed_windows("viral", 4, True, empty_at=3, seed=1)
    _, more = pushed_windows("viral", 4, False, seed=2)
    lanes = [_to(x, cuda_device) for x in (wins + more + wins)[:18]]
    stacked = tree_map(lambda *xs: torch.stack(xs), *lanes)
    launches = K3.LAUNCHES
    got = K3.optimize(stacked, imu, imu.gravity, 8)
    torch.cuda.synchronize()
    assert K3.LAUNCHES == launches + 1
    for b, lane in enumerate(lanes):
        one = K3.optimize(lane, imu, imu.gravity, 8)
        for f in ("q", "p", "v", "ba", "bg"):
            assert torch.equal(getattr(got, f)[b], getattr(one, f)), (b, f)
        with cg.cusolver():
            want = K3.optimize_plain(lane, imu, imu.gravity, 8)
        _assert_k3_close(K3.WindowState(*(x[b] for x in got)), want, lane, 8, f"lane {b}")
    big = _to(K3.make_window(16, K3.NavState.identity(), torch.zeros(3), torch.zeros(3), imu), cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        K3.optimize(big, imu, imu.gravity, 8)


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


# The dense entry's edge cases on bench_e2e's 2 x 128^3 bank (256 groups
# and the padding group 256): (capacity, touched groups, records, distinct
# cells per group or None).
DENSE_EDGE_CASES = {
    "all_sentinel": (256, [], 49152, None),
    "one_group": (256, [17], 49152, None),
    "exact_capacity": (64, list(range(0, 256, 4)), 49152, None),
    "capacity_plus_one": (64, list(range(0, 260, 4)), 49152, None),
    "last_real_group": (256, [3, 254, 255], 49152, None),
    "duplicate_heavy": (256, [9, 10], 3000, 12),
    "long_runs": (256, [5, 6], 3000, 2),  # runs of ~750 across the kernel's tiles
}


def _hits_first(keys):
    """The keys with each run of equal (group, cell) reordered hits first:
    every cell's records still contiguous, no longer sorted."""
    k = keys.cpu().numpy().astype(np.int64)
    order = np.lexsort((-(k & 1), k >> 1))
    return torch.from_numpy(k[order].astype(np.int32)).to(keys.device)


@pytest.mark.parametrize("name", [*sorted(DENSE_EDGE_CASES), "long_runs_hits_first"])
def test_dense_table_edge_cases_match_plain(cuda_device, name):
    """The dense entry against its plain version: bank and `dropped`
    bit-identical, the padding group unchanged, one launch counted. The
    kernel needs each cell's records contiguous, not sorted by kind:
    `long_runs_hits_first` puts every run's hits first, so a run's last
    record is a miss and the run's hits lie in earlier tiles."""
    capacity, touched, records, cells = DENSE_EDGE_CASES[name.removesuffix("_hits_first")]
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
    if name.endswith("_hits_first"):
        keys = _hits_first(keys)
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


def test_dense_lookback_scratch_across_calls(cuda_device):
    """The dense kernel's look-back scratch lives on per stream, its epoch
    advanced by each call: calls of different tile counts, on the current
    stream and on a side stream, and replays of one CUDA graph (whose calls
    take scratch the graph owns, made by eager calls before the capture)
    each match the plain version."""
    rng = np.random.default_rng(9)
    cpg, groups = 16384, 257
    kw = dict(num_groups=64, cells_per_group=cpg, hit_odds=0.55 / 0.45, miss_odds=0.49 / 0.51,
              dummy_group=groups - 1)
    bank = torch.from_numpy(rng.integers(0, 32768, groups * cpg).astype(np.int16)).to(cuda_device)
    cases = [_dense_keys(rng, t, n).to(cuda_device) for t, n in ((200, 49152), (3, 700), (90, 20000))]
    side = torch.cuda.Stream(cuda_device)
    for i, keys in enumerate(cases * 2):
        with torch.cuda.stream(side if i % 2 else torch.cuda.current_stream(cuda_device)):
            k, kd = K1.apply_grouped_updates(bank.clone(), keys, **kw)
            p, pd = K1.apply_grouped_updates_plain(bank.clone(), keys, **kw)
        torch.cuda.synchronize()
        assert torch.equal(k, p) and int(kd) == int(pd)
    works = [bank.clone() for _ in cases]
    graph = torch.cuda.CUDAGraph()
    owner = K1.LookbackScratch()  # lives as long as the graph
    with K1.lookback_owner(owner):
        for w, keys in zip(works, cases):
            K1.apply_grouped_updates(w.clone(), keys, **kw)
        with torch.cuda.graph(graph):
            outs = [K1.apply_grouped_updates(w, keys, **kw)[1] for w, keys in zip(works, cases)]
    for replay in range(3):
        for w in works:
            w.copy_(bank)
        graph.replay()
        torch.cuda.synchronize()
        for w, keys, d in zip(works, cases, outs):
            p, pd = K1.apply_grouped_updates_plain(bank.clone(), keys, **kw)
            assert torch.equal(w, p) and int(d) == int(pd), replay


def test_dense_captured_call_owns_its_scratch(cuda_device):
    """A captured dense call takes look-back scratch its graph owns: its
    replays on the current stream, with eager dense calls (per-stream
    scratch) before and after each on the capture stream, running
    alongside, all equal plain bit for bit; a capture without an owner
    raises."""
    rng = np.random.default_rng(10)
    cpg, groups = 16384, 257
    kw = dict(num_groups=64, cells_per_group=cpg, hit_odds=0.55 / 0.45, miss_odds=0.49 / 0.51,
              dummy_group=groups - 1)
    bank = torch.from_numpy(rng.integers(0, 32768, groups * cpg).astype(np.int16)).to(cuda_device)
    captured, before, after = (_dense_keys(rng, t, n).to(cuda_device)
                               for t, n in ((200, 49152), (90, 20000), (150, 30000)))
    want = {name: K1.apply_grouped_updates_plain(bank.clone(), keys, **kw)
            for name, keys in (("captured", captured), ("before", before), ("after", after))}
    capture_stream = torch.cuda.Stream(cuda_device)
    owner = K1.LookbackScratch()
    work = bank.clone()
    with K1.lookback_owner(owner):
        K1.apply_grouped_updates(bank.clone(), captured, **kw)  # the scratch, before the capture
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=capture_stream):
            dropped = K1.apply_grouped_updates(work, captured, **kw)[1]
    results = []
    for _ in range(3):
        banks = {name: bank.clone() for name in ("before", "after")}
        work.copy_(bank)
        torch.cuda.synchronize()
        with torch.cuda.stream(capture_stream):
            d_before = K1.apply_grouped_updates(banks["before"], before, **kw)[1]
        graph.replay()
        with torch.cuda.stream(capture_stream):
            d_after = K1.apply_grouped_updates(banks["after"], after, **kw)[1]
        torch.cuda.synchronize()
        results += [(work, dropped, "captured"), (banks["before"], d_before, "before"),
                    (banks["after"], d_after, "after")]
        for got, d, name in results[-3:]:
            assert torch.equal(got, want[name][0]) and int(d) == int(want[name][1]), name
    stream_scratch = K1._LOOKBACK[(torch.device("cuda", torch.cuda.current_device()),
                                   capture_stream.cuda_stream)]
    assert owner.buf.data_ptr() != stream_scratch.data_ptr()
    with pytest.raises(RuntimeError, match="look-back scratch"):
        with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=capture_stream):
            K1.apply_grouped_updates(bank.clone(), captured, **kw)


def test_captured_call_keeps_its_cached_tables(cuda_device):
    """A captured K1 call reads the update tables of `update_tables`' cache
    at their address on every replay. With more than 8 other keys made
    between replays and freed memory written over, each replay still
    equals plain bit for bit: the cache never evicts, and neither does the
    correlative lattice's, which the compiled step reads the same way."""
    from dliom_tpu_torch.ops import real_time_correlative as rtc

    bank, rows, starts, ends, keys, fresh = (
        x.to(cuda_device) for x in _grouped_case(np.random.default_rng(5), 64, 4096, 48))
    kw = dict(cells_per_group=4096, hit_odds=0.57 / 0.43, miss_odds=0.47 / 0.53, fresh=fresh)
    want = K1.apply_grouped_rows_plain(bank.clone(), rows, starts, ends, keys, **kw)
    work = bank.clone()
    K1.apply_grouped_rows(work.clone(), rows, starts, ends, keys, **kw)  # the tables, before the capture
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        K1.apply_grouped_rows(work, rows, starts, ends, keys, **kw)
    for replay in range(3):
        for i in range(10):
            K1.update_tables(1.1 + 0.01 * (10 * replay + i), 0.9, work.device)
        scrub = [torch.full((32768,), -7, dtype=torch.int16, device=cuda_device) for _ in range(64)]
        del scrub
        work.copy_(bank)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(work, want), replay
    assert K1.update_tables.cache_info().maxsize is None
    assert rtc._candidates.cache_info().maxsize is None


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
    """One batched LIO step at B = 1 and B = 4: one K2 call, one K3 call and
    one K1 call per brick grid, whatever B is (the capture records one K3
    launch a step); lane 0 of B = 4 takes the B = 1 pose."""
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
        k1, k2, k3 = K1.LAUNCHES, K2.LAUNCHES, K3.LAUNCHES
        for _ in range(2):
            state, res = step(state, inp)
        torch.cuda.synchronize()
        assert (K1.LAUNCHES - k1, K2.LAUNCHES - k2, K3.LAUNCHES - k3) == (4, 2, 2)
        assert step.launches["dliom_tpu_torch.imu.window_optimizer.LAUNCHES"] == 1
        poses[lanes] = res.scan.local_pose.translation.cpu()
    torch.testing.assert_close(poses[4][0], poses[1][0], atol=2e-4, rtol=0)


def _small_step_case(cuda_device):
    """A small brick config and its scans on the card: (cfg, scan(i), a
    fresh state)."""
    from dliom_tpu_torch.frontend.lio import LioScanInput, make_lio_state
    from dliom_tpu_torch.imu.preintegration import NavState
    from dliom_tpu_torch.io.synthetic import SyntheticWorld, corkscrew_trajectory
    from dliom_tpu_torch.sensor.types import pad_point_cloud

    cfg = load_config("basic", {"trajectory_builder": {
        "scan_period": 0.1, "voxel_filter_size": 0.3, "enable_gravity_factor": False,
        "submaps": {"high_resolution": 0.2, "low_resolution": 0.5, "num_range_data": 2,
                    "use_brick_grid": True, "brick_dir_extent": 16, "brick_max_bricks": 4096,
                    "brick_apply_groups": 512, "use_brick_grid_low": True, "low_brick_dir_extent": 8,
                    "low_brick_max_bricks": 512, "low_brick_apply_groups": 256,
                    "low_brick_apply_group_bricks": 8},
        "max_filtered_points": 1024, "max_high_res_points": 256, "max_low_res_points": 256,
        "max_imu_per_scan": 16, "window_size": 3, "gn_iterations": 2,
        "ceres_scan_matcher": {"max_num_iterations": 4, "function_tolerance": 1e-3}}}).trajectory_builder
    world = SyntheticWorld.create(num_beams=8, num_azimuths=200)
    course = corkscrew_trajectory()
    rng = np.random.default_rng(0)

    def scan(i):
        cloud = pad_point_cloud(*world.cast_scan(course[3 + i][1]), 2048)
        acc = np.tile(np.array([0, 0, 9.80511], np.float32), (16, 1)) + rng.normal(0, 0.01, (16, 3))
        return LioScanInput(
            time=torch.tensor(0.1 * (i + 1), device=cuda_device),
            **{k: torch.from_numpy(np.asarray(v)).to(cuda_device) for k, v in dict(
                points=cloud.points, times=cloud.times, mask=cloud.mask,
                imu_dts=np.full(16, 0.00625, np.float32), imu_acc=acc.astype(np.float32),
                imu_gyr=rng.normal(0, 0.002, (16, 3)).astype(np.float32),
                imu_mask=np.arange(16) < 14).items()})

    zero = torch.zeros(3, device=cuda_device)
    return cfg, scan, make_lio_state(cfg, NavState.identity(cuda_device), zero, zero)


def _clone(tree):
    from torch.utils._pytree import tree_map

    return tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x, tree)


def _held_step(cfg, pre, inp, state, res):
    """A replay's state and result against the eager `lio_step` from the
    same pre-step state: integer state and flags bit for bit, pose within
    2e-3."""
    from dliom_tpu_torch.common import graph as cg
    from dliom_tpu_torch.frontend.lio import lio_step

    with cg.cusolver():
        eager_state, eager = lio_step(_clone(pre), inp, cfg)
    for x, y in zip(torch.utils._pytree.tree_leaves(state), torch.utils._pytree.tree_leaves(eager_state)):
        assert x.dtype.is_floating_point or torch.equal(x, y)
    for f in ("inserted", "finished_submap", "matcher_iterations", "num_hits", "insertion_submap_ids"):
        assert torch.equal(getattr(res.scan, f), getattr(eager.scan, f)), f
    torch.testing.assert_close(res.scan.local_pose.translation, eager.scan.local_pose.translation,
                               atol=2e-3, rtol=0)


def test_compiled_step_replays_the_eager_step(cuda_device):
    """`make_jit_lio_step` on the card at a small brick config: the first
    call warms up and captures, each later call replays; every replay
    equals the eager `lio_step` from the same pre-step state (integer state
    and flags bit for bit, pose within 2e-3), and the launch counters count
    the replays' K1, K2 and K3 launches as the eager step's: the capture
    records one K3 launch a step."""
    from dliom_tpu_torch.common import graph as cg
    from dliom_tpu_torch.frontend.lio import make_jit_lio_step

    cfg, scan, state = _small_step_case(cuda_device)
    step = make_jit_lio_step(cfg)
    for i in range(6):
        inp = scan(i)
        pre = _clone(state)
        before = cg.launch_counts()
        state, res = step(state, inp)
        torch.cuda.synchronize()
        replayed = {k: v - before[k] for k, v in cg.launch_counts().items()}
        assert replayed == {"dliom_tpu_torch.ops.grouped_apply.LAUNCHES": 2, "dliom_tpu_torch.ops.grouped_apply.DENSE_LAUNCHES": 0,
                            "dliom_tpu_torch.imu.affine_chain.LAUNCHES": 1,
                            "dliom_tpu_torch.imu.window_optimizer.LAUNCHES": 1}, (i, replayed)
        _held_step(cfg, pre, inp, state, res)
    assert step.launches["dliom_tpu_torch.imu.window_optimizer.LAUNCHES"] == 1
    assert _tallies(step.counts()) == {"steps": 6, "warmups": 1, "captures": 1, "replays": 5}
    assert int(state.failures) == 0


def _tallies(counts):
    """A StepGraph's counts without the summary of its stage marks."""
    return {k: v for k, v in counts.items() if k != "marks"}


def _kernels_in_one_replay(step, inp):
    """Kernels (not copies or sets) the card ran for one replay of `step`
    on `inp`, in torch.profiler's device trace."""
    from torch.profiler import ProfilerActivity, profile

    step.load_input(inp)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step.step()
        torch.cuda.synchronize()
    names = [e.name() for e in prof.profiler.kineto_results.events() if e.device_type() != DeviceType.CPU]
    return sum(1 for n in names if not n.lower().startswith(("memcpy", "memset")))


def _without_marks(body):
    """`body` with its stages hidden from the graph that captures it, so
    that the graph marks none."""
    from dliom_tpu_torch.common import stages

    def run(state, inp):
        with stages.owner(None):
            return body(state, inp)
    return run


def test_compiled_step_marks_its_stages(cuda_device):
    """The marked `make_jit_lio_step` against the same body captured without
    marks: every replay's state and result bit for bit. Its summary: the
    six stages and `rest` hold the graph's kernels less its marks, and the
    graph's kernels are what one replay runs (the profiler's count); each
    stage takes more than 0 ms, `rest` 0 ms or more; the clock's bracket
    within 50 us."""
    import functools

    from torch.utils._pytree import tree_leaves

    from dliom_tpu_torch.common.graph import StepGraph
    from dliom_tpu_torch.frontend.lio import bank_leaves, lio_step, make_jit_lio_step

    cfg, scan, state = _small_step_case(cuda_device)
    marked = make_jit_lio_step(cfg)
    plain = StepGraph(_without_marks(functools.partial(lio_step, cfg=cfg)), adopt=bank_leaves)
    a, b = state, _clone(state)
    for i in range(6):
        inp = scan(i)
        a, ra = marked(a, inp)
        b, rb = plain(b, inp)
        torch.cuda.synchronize()
        for x, y in zip(tree_leaves((a, ra)), tree_leaves((b, rb))):
            assert (x is None and y is None) or torch.equal(x, y), i
    m = marked.counts()["marks"]
    assert plain.counts() == _tallies(marked.counts())
    stages_ = m["stages"]
    assert list(stages_) == ["lio.preintegrate", "frontend.filter", "frontend.match", "lio.window",
                             "frontend.insert", "frontend.histogram", "rest"]
    assert m["replays"] == 5 and m["slots"] == 14
    assert sum(v["kernels"] for v in stages_.values()) == m["kernels"] - m["slots"]
    assert all(v["kernels"] > 0 for v in stages_.values())
    assert all(v["ms"] > 0 for k, v in stages_.items() if k != "rest") and stages_["rest"]["ms"] >= 0
    assert 0 < m["device_ms"] and 0 < m["launch_ms"] and 0 <= m["idle_share"] < 1
    assert m["clock"]["error_ns"] < 50_000
    assert _kernels_in_one_replay(marked, scan(6)) == m["kernels"]


def _spa_case(device):
    """A small SPA problem on `device`: 4 submaps, 16 nodes, 2 constraints
    per node, poses perturbed."""
    from dliom_tpu_torch.backend import optimization as opt

    rng = np.random.default_rng(3)
    d = opt.make_pose_graph_data(8, 32, 64, device=device)
    c = torch.arange(32, device=device)
    sub = torch.from_numpy(np.arange(4)).to(device)
    return d._replace(
        submap_t=d.submap_t.index_copy(0, sub, torch.from_numpy(
            (rng.normal(0, 0.1, (4, 3)) + np.arange(4)[:, None] * [2.0, 0, 0]).astype(np.float32)).to(device)),
        submap_valid=d.submap_valid.index_fill(0, sub, True),
        node_t=torch.from_numpy(rng.normal(0, 0.5, (32, 3)).astype(np.float32)).to(device)
        + (torch.arange(32, device=device) // 8)[:, None] * torch.tensor([2.0, 0, 0], device=device),
        node_valid=torch.arange(32, device=device) < 16,
        c_submap=torch.cat([c // 8, (c // 8 + 1) % 4]).to(torch.int32),
        c_node=torch.cat([c, c]).to(torch.int32),
        c_t=torch.from_numpy(rng.normal(0, 0.5, (64, 3)).astype(np.float32)).to(device),
        c_trans_weight=torch.full((64,), 10.0, device=device),
        c_rot_weight=torch.full((64,), 10.0, device=device),
        c_valid=torch.cat([c, c]) < 16)


def test_worker_capture_beside_frontend_replays(cuda_device):
    """common/graph.py off the frontend thread: a worker thread, on its own
    stream, warms up, captures and replays one SPA GN step (reverse-mode
    autograd inside the capture) into a pool of its own, while the main
    thread replays the compiled LIO step. The K1/K2 launch counters end at
    the main thread's launches alone (the worker's capture recorded
    none of the replays made meanwhile), the two graphs' pools differ, and
    both graphs' results equal their eager runs."""
    import threading

    from dliom_tpu_torch.backend import optimization as opt
    from dliom_tpu_torch.common import graph as cg
    from dliom_tpu_torch.common.graph import StepGraph
    from dliom_tpu_torch.frontend.lio import make_jit_lio_step

    cfg, scan, state = _small_step_case(cuda_device)
    step = make_jit_lio_step(cfg)
    inputs = [scan(i) for i in range(8)]
    for i in range(2):  # the warm-up and the capture, then one replay
        state, _ = step(state, inputs[i])
    torch.cuda.synchronize()

    problem = _spa_case(cuda_device)
    torch.cuda.synchronize()  # the worker's stream reads it
    fields = ("submap_q", "submap_t", "node_q", "node_t", "lm_positions", "lm_q")
    kw = dict(cg_iterations=16, fix_first_submap=True, blocks=(False, False, False))

    def body(poses, d):
        out = opt.gn_step(d._replace(**dict(zip(fields, poses))), **kw)
        return tuple(getattr(out, f) for f in fields), None

    worker_graph = StepGraph(body, pool=cg.SharedPool(), name="spa")
    replays = [0]
    worker = {"done": threading.Event()}

    def run_worker():
        try:
            stream = torch.cuda.Stream(cuda_device)
            with torch.cuda.device(cuda_device), torch.cuda.stream(stream):
                worker_graph.bind(tuple(getattr(problem, f) for f in fields), problem)
                worker_graph.load_input(problem)
                held = []
                for k in range(4):
                    pre = tuple(x.clone() for x in worker_graph.state)
                    before = replays[0]
                    worker_graph.step()  # the warm-up and the capture, then replays
                    if k == 0:
                        worker["overlap"] = replays[0] - before
                    with cg.cusolver():
                        want = opt.gn_step(problem._replace(**dict(zip(fields, pre))), **kw)
                    held.append(all(torch.equal(x, getattr(want, f)) for f, x in zip(fields, worker_graph.state)))
                stream.synchronize()
                worker["held"] = held
        except BaseException as e:  # reported on the main thread
            worker["error"] = e
        finally:
            worker["done"].set()

    start = cg.launch_counts()
    t = threading.Thread(target=run_worker)
    t.start()
    kept, i = [], 2
    while not worker["done"].is_set() or i < 6:
        inp = inputs[i % len(inputs)]
        pre = _clone(state)
        state, res = step(state, inp)
        replays[0] += 1
        if len(kept) < 3:
            kept.append((pre, inp, _clone((state, res))))
        i += 1
    t.join()
    torch.cuda.synchronize()
    assert "error" not in worker, worker.get("error")
    assert worker["overlap"] > 0, "the main thread replayed during the worker's warm-up and capture"
    assert worker_graph.counts() == {"steps": 4, "warmups": 1, "captures": 1, "replays": 3}
    assert not any(worker_graph.launches.values()), worker_graph.launches
    launched = {k: v - start[k] for k, v in cg.launch_counts().items()}
    assert launched == {k: replays[0] * v for k, v in step.launches.items()}, (launched, replays[0])
    assert worker_graph.graph.pool() != step.graph.pool()
    assert worker["held"] == [True] * 4, worker["held"]
    for pre, inp, (st, res) in kept:
        _held_step(cfg, pre, inp, st, res)


def test_zero_launch_replays_beside_frontend_replays(cuda_device):
    """Many replays of a graph that launches no kernel of the port, on a
    worker thread and its own stream, while the main thread replays the
    compiled LIO step: the K1/K2 launch counters end exactly at the main
    thread's launches (a worker's replay adds nothing, and none of the
    main thread's additions is lost)."""
    import threading

    from dliom_tpu_torch.common import graph as cg
    from dliom_tpu_torch.common.graph import StepGraph
    from dliom_tpu_torch.frontend.lio import make_jit_lio_step

    cfg, scan, state = _small_step_case(cuda_device)
    step = make_jit_lio_step(cfg)
    inputs = [scan(i) for i in range(8)]
    for i in range(2):  # the warm-up and the capture, then one replay
        state, _ = step(state, inputs[i])
    torch.cuda.synchronize()

    worker_graph = StepGraph(lambda s, x: (s + x, None), pool=cg.SharedPool(), name="add")
    ready, done, errors = threading.Event(), threading.Event(), []

    def run_worker():
        try:
            stream = torch.cuda.Stream(cuda_device)
            with torch.cuda.device(cuda_device), torch.cuda.stream(stream):
                one = torch.ones(16, device=cuda_device)
                worker_graph(torch.zeros(16, device=cuda_device), one)  # the warm-up and the capture
                ready.set()
                for _ in range(3000):
                    worker_graph.step()
                stream.synchronize()
        except BaseException as e:  # reported on the main thread
            errors.append(e)
        finally:
            ready.set()
            done.set()

    t = threading.Thread(target=run_worker)
    t.start()
    ready.wait()
    start = cg.launch_counts()
    replays = 0
    while not done.is_set() or replays < 8:
        state, _ = step(state, inputs[replays % len(inputs)])
        replays += 1
    t.join()
    torch.cuda.synchronize()
    assert not errors, errors
    assert worker_graph.counts() == {"steps": 3001, "warmups": 1, "captures": 1, "replays": 3000}
    assert torch.equal(worker_graph.state, torch.full((16,), 3001.0, device=cuda_device))
    launched = {k: v - start[k] for k, v in cg.launch_counts().items()}
    assert launched == {k: replays * v for k, v in step.launches.items()}, (launched, replays)


def test_capture_beside_a_dead_graph_in_garbage(cuda_device):
    """common/graph.py::capture pauses Python's garbage collector: a dead
    graph that becomes cyclic garbage during a capture, with enough
    allocations after it for a collection, is not destroyed inside the
    capture (CUDA refuses that while the thread's stream captures, and the
    capture would be lost). The capture holds, replays, and the dead graph
    goes with the next collection."""
    import gc
    import weakref

    from dliom_tpu_torch.common import graph as cg
    from dliom_tpu_torch.common.graph import StepGraph

    class Cycle:
        def __init__(self, obj):
            self.obj, self.me = obj, self

    one = torch.ones(16, device=cuda_device)
    dead = StepGraph(lambda s, x: (s + x, None), pool="own", name="dead")
    for _ in range(3):  # the warm-up, the capture and a replay
        dead(torch.zeros(16, device=cuda_device), one)
    torch.cuda.synchronize()
    gone = weakref.ref(dead.graph)
    box = [dead]
    del dead
    x = torch.arange(16, dtype=torch.float32, device=cuda_device)

    def fn():
        Cycle(box.pop())  # the dead graph's last reference, in a garbage cycle
        junk = [[] for _ in range(20 * gc.get_threshold()[0])]  # allocations enough for a collection
        del junk
        out.append(x * 2.0 + 1.0)

    out = []
    enabled = gc.isenabled()
    graph = torch.cuda.CUDAGraph()
    cg.capture(graph, (), cuda_device, fn)
    assert gc.isenabled() == enabled
    assert gone() is not None, "the dead graph was collected inside the capture"
    x.copy_(torch.full((16,), 3.0, device=cuda_device))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out[0], torch.full((16,), 7.0, device=cuda_device))
    gc.collect()
    assert gone() is None


# ----- the mesh (common/mesh.py): the kernels and graphs off cuda:0 -----


@pytest.fixture
def second_card():
    """cuda:1, with cuda:0 left current: a launch that follows the current
    device instead of its tensors' would go to the wrong card."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs a second CUDA device")
    torch.cuda.set_device(0)
    return torch.device("cuda", 1)


def test_kernels_on_a_second_card_match_plain(second_card):
    """K1 (rows and dense entries) and K2 on cuda:1 against their plain
    versions, while cuda:0 is current."""
    bank, rows, starts, ends, keys, fresh = (
        x.to(second_card) for x in _grouped_case(np.random.default_rng(1), 64, 4096, 48))
    kw = dict(cells_per_group=4096, hit_odds=0.55 / 0.45, miss_odds=0.49 / 0.51, fresh=fresh)
    k = K1.apply_grouped_rows(bank.clone(), rows, starts, ends, keys, **kw)
    p = K1.apply_grouped_rows_plain(bank.clone(), rows, starts, ends, keys, **kw)
    dense_bank = torch.zeros(4 * 16384 + 16384, dtype=torch.int16, device=second_card)
    dkeys = torch.sort(torch.from_numpy(
        (np.random.default_rng(2).integers(0, 4 * 16384, 5000) << 1).astype(np.int32))).values.to(second_card)
    dkw = dict(num_groups=3, cells_per_group=16384, hit_odds=0.55 / 0.45, miss_odds=0.49 / 0.51, dummy_group=4)
    dk, ddrop = K1.apply_grouped_updates(dense_bank.clone(), dkeys, **dkw)
    dp, pdrop = K1.apply_grouped_updates_plain(dense_bank.clone(), dkeys, **dkw)
    rng = np.random.default_rng(3)
    f = torch.from_numpy(np.eye(15, dtype=np.float32) + rng.normal(0, 0.01, (2, 48, 15, 15)).astype(np.float32))
    q = torch.from_numpy(rng.normal(0, 1e-3, (2, 48, 15, 15)).astype(np.float32))
    a, pp = K2.affine_chain(f.to(second_card), q.to(second_card))
    a0, p0 = K2.affine_chain_plain(f.to(second_card), q.to(second_card))
    torch.cuda.synchronize(second_card)
    assert k.device == dk.device == a.device == second_card
    assert torch.equal(k, p) and not torch.equal(k, bank)
    assert torch.equal(dk, dp) and int(ddrop) == int(pdrop) == 1
    torch.testing.assert_close(a, a0, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(pp, p0, rtol=1e-5, atol=1e-6)
    assert torch.cuda.current_device() == 0


def test_compiled_step_on_a_second_card(second_card):
    """`make_jit_lio_step` on cuda:1 with cuda:0 current: its warm-up,
    capture and replays go to cuda:1, each replay held against the eager
    step from the same pre-step state."""
    from dliom_tpu_torch.frontend.lio import make_jit_lio_step

    cfg, scan, state = _small_step_case(second_card)
    step = make_jit_lio_step(cfg)
    for i in range(4):
        inp = scan(i)
        pre = _clone(state)
        state, res = step(state, inp)
        torch.cuda.synchronize(second_card)
        with torch.cuda.device(second_card):
            _held_step(cfg, pre, inp, state, res)
    assert _tallies(step.counts()) == {"steps": 4, "warmups": 1, "captures": 1, "replays": 3}
    assert res.scan.local_pose.translation.device == second_card
    assert torch.cuda.current_device() == 0


def test_sharded_lio_step_holds_each_shard(cuda_device):
    """`sharded_lio_step` over the cards present (up to 4; two shards on
    cuda:0 where there is one card), 2 lanes a shard: every shard's replay
    against the eager batched body from the same pre-step state (integer
    state bit for bit, poses within 2e-3), and the replays' K1 / K2
    launches D times one shard's."""
    from torch.utils._pytree import tree_leaves

    from dliom_tpu_torch.common import graph as cg
    from dliom_tpu_torch.common.mesh import Mesh, make_mesh
    from dliom_tpu_torch.parallel import batch as TBatch

    n = torch.cuda.device_count()
    mesh = make_mesh(min(4, n)) if n > 1 else Mesh((cuda_device,) * 2)
    cfg, scan, _ = _small_step_case(cuda_device)
    batch = 2 * mesh.size
    states = TBatch.make_sharded_lio_state(cfg, batch, mesh)
    step = TBatch.sharded_lio_step(cfg, batch, mesh)
    body = TBatch.batched_lio_body(cfg, 2)

    def lanes(i, dev):
        one = scan(i)
        return type(one)(*(x.to(dev).expand((2,) + x.shape).clone() for x in one))

    for i in range(4):
        inputs = [lanes(i, dev) for dev in mesh.devices]
        pre = [_clone(s) for s in states]
        before = cg.launch_counts()
        states, results = step(states, inputs)
        for dev in mesh.distinct_devices:
            torch.cuda.synchronize(dev)
        launched = {k: v - before[k] for k, v in cg.launch_counts().items()}
        assert launched == {"dliom_tpu_torch.ops.grouped_apply.LAUNCHES": 2 * mesh.size,
                            "dliom_tpu_torch.ops.grouped_apply.DENSE_LAUNCHES": 0,
                            "dliom_tpu_torch.imu.affine_chain.LAUNCHES": mesh.size,
                            "dliom_tpu_torch.imu.window_optimizer.LAUNCHES": mesh.size}, (i, launched)
        for k, dev in enumerate(mesh.devices):
            with cg.cusolver(), torch.cuda.device(dev):
                want_state, want = body(pre[k], inputs[k])
            for x, y in zip(tree_leaves(states[k]), tree_leaves(want_state)):
                assert x.device == dev and (x.dtype.is_floating_point or torch.equal(x, y)), (i, k)
            torch.testing.assert_close(results[k].scan.local_pose.translation,
                                       want.scan.local_pose.translation, atol=2e-3, rtol=0)
    assert step.counts() == {"steps": 4 * mesh.size, "warmups": mesh.size, "captures": mesh.size,
                             "replays": 3 * mesh.size}


# ----- the SPA's programs and the frontend's sharded step over a mesh -----


def _spa_programs_case(device, mesh):
    """A pose graph over `mesh` on `device` and `_spa_case`'s problem, on the
    card and as the host arrays `PoseGraph._solve` takes."""
    from dliom_tpu_torch.backend import optimization as opt
    from dliom_tpu_torch.backend.pose_graph import PoseGraph

    cfg = load_config("basic")
    d = _spa_case(device)
    problem = {k: v.cpu().numpy() for k, v in d._asdict().items()}
    return PoseGraph(cfg.pose_graph, cfg.trajectory_builder, device=device, mesh=mesh), d, problem, opt.blocks_of(d)


def _compiled_solves_equal_eager(pg, d, problem, blocks, mesh, iterations=3):
    """Two solves through `PoseGraph._solve` (the first warms up and
    captures every SPA program, the second replays them) against the eager
    solve over the same mesh, bit for bit."""
    from dliom_tpu_torch.backend.pose_graph import spa_solve_eager
    from dliom_tpu_torch.common import graph as cg

    with cg.cusolver():
        want = pg._read_poses(spa_solve_eager(pg.cfg.optimization_problem, d, iterations, blocks, mesh))
    for k in range(2):
        got = pg._solve(problem, iterations, blocks)
        assert np.array_equal(got, want), (k, float(np.abs(got - want).max()))
    counts = pg.graph_counts()
    shards = 1 if mesh is None else mesh.size
    assert counts["spa"] == {"steps": 2 * iterations, "warmups": 1, "captures": 1, "replays": 2 * iterations - 1}
    assert counts["spa_jtj"]["captures"] == shards and counts["spa_jtj"]["steps"] == 2 * iterations * 64 * shards
    assert not np.array_equal(want, pg._read_poses(d))  # the solve moved the poses


def test_compiled_sharded_solve_equals_eager(cuda_device):
    """The SPA's programs (backend/pose_graph.py::_SpaPrograms) over 4
    shards on one card, and as a single shard without a mesh: each equal
    to the eager solve of the same mesh bit for bit."""
    from dliom_tpu_torch.common.mesh import Mesh, indexed

    dev = indexed(cuda_device)
    for mesh in (Mesh((dev,) * 4), None):
        _compiled_solves_equal_eager(*_spa_programs_case(dev, mesh), mesh)


def test_compiled_sharded_solve_on_two_cards(second_card):
    """The SPA's programs over cuda:0 and cuda:1 (the copies between the
    cards ordered by stream events) equal the eager solve over them."""
    from dliom_tpu_torch.common.mesh import Mesh

    mesh = Mesh((torch.device("cuda", 0), second_card))
    pg, d, problem, blocks = _spa_programs_case(torch.device("cuda", 0), mesh)
    _compiled_solves_equal_eager(pg, d, problem, blocks, mesh)
    assert {g.device for gs in pg.programs().values() for _, g in gs} == set(mesh.devices)


def test_sharded_solve_on_a_pool_thread_beside_captures(cuda_device):
    """A sharded SPA solve (2 shards on one card) runs as a pose-graph pool
    task (`PoseGraph._device_task`: its thread's own streams), its
    programs' warm-ups and captures and then their replays, while the main
    thread captures tools/torch_capture_hazards.py's body again and again
    through `common/graph.py::capture`: no capture is lost, every main
    thread graph replays to the eager body's result, and both solves
    equal the eager solve."""
    import sys
    import threading

    from dliom_tpu_torch.backend.pose_graph import spa_solve_eager
    from dliom_tpu_torch.common import graph as cg
    from dliom_tpu_torch.common.mesh import Mesh, indexed

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    import torch_capture_hazards as hazards

    dev = indexed(cuda_device)
    mesh = Mesh((dev,) * 2)
    pg, d, problem, blocks = _spa_programs_case(dev, mesh)
    out, done = {}, threading.Event()

    def solves():
        out["poses"] = [pg._solve(problem, 2, blocks) for _ in range(2)]

    task = pg._device_task(solves)

    def run():
        try:
            task()
        except BaseException as e:  # reported on the main thread
            out["error"] = e
        finally:
            done.set()

    x = torch.ones(1024, device=dev)
    want_body = hazards._body(x)
    torch.cuda.current_stream(dev).synchronize()
    worker = threading.Thread(target=run)
    worker.start()
    graphs, overlap = [], 0
    while not done.is_set() or len(graphs) < 3:
        overlap += not done.is_set()
        g, box = torch.cuda.CUDAGraph(), {}
        cg.capture(g, (), dev, lambda: box.setdefault("y", hazards._body(x)))
        graphs.append((g, box["y"]))
    worker.join()
    assert "error" not in out, out.get("error")
    assert overlap > 0
    for g, y in graphs:
        g.replay()
        torch.cuda.current_stream(dev).synchronize()
        assert torch.equal(y, want_body)
    with cg.cusolver():
        want = pg._read_poses(spa_solve_eager(pg.cfg.optimization_problem, d, 2, blocks, mesh))
    for poses in out["poses"]:
        assert np.array_equal(poses, want)
    assert pg.graph_counts()["spa"]["captures"] == 1


def test_compiled_sharded_frontend_step_holds_each_shard(cuda_device):
    """The frontend's compiled `sharded_step` over the cards present (up to
    4; two shards on cuda:0 where there is one card), 2 lanes a shard, 4
    steps: every shard's step (the warm-up and capture, then replays)
    against the eager `batched_step` from the same pre-step state (integer
    state and flags bit for bit, poses within 2e-3); K1 2 launches a shard
    a step, counted through the replays, and no K2."""
    from torch.utils._pytree import tree_leaves

    from dliom_tpu_torch.common import graph as cg
    from dliom_tpu_torch.common.mesh import Mesh, make_mesh
    from dliom_tpu_torch.frontend.local_trajectory_builder import ScanInput
    from dliom_tpu_torch.parallel import batch as TBatch
    from dliom_tpu_torch.transform.rigid import Rigid3

    n = torch.cuda.device_count()
    mesh = make_mesh(min(4, n)) if n > 1 else Mesh((cuda_device,) * 2)
    cfg, scan, _ = _small_step_case(cuda_device)
    states = [TBatch.make_batched_state(cfg, 2, dev) for dev in mesh.devices]
    step = TBatch.sharded_step(cfg, mesh)
    body = TBatch.batched_step(cfg)

    def lanes(i, dev):
        one = scan(i)
        two = lambda x: x.to(dev).expand((2,) + x.shape).clone()  # noqa: E731
        return ScanInput(time=two(one.time), points=two(one.points), times=two(one.times), mask=two(one.mask),
                         relative_prediction=Rigid3.identity((2,), device=dev))

    for i in range(4):
        inputs = [lanes(i, dev) for dev in mesh.devices]
        pre = [_clone(s) for s in states]
        before = cg.launch_counts()
        states, results = step(states, inputs)
        for dev in mesh.distinct_devices:
            torch.cuda.current_stream(dev).synchronize()
        launched = {k: v - before[k] for k, v in cg.launch_counts().items()}
        assert launched == {"dliom_tpu_torch.ops.grouped_apply.LAUNCHES": 2 * mesh.size,
                            "dliom_tpu_torch.ops.grouped_apply.DENSE_LAUNCHES": 0,
                            "dliom_tpu_torch.imu.affine_chain.LAUNCHES": 0,
                            "dliom_tpu_torch.imu.window_optimizer.LAUNCHES": 0}, (i, launched)
        for k, dev in enumerate(mesh.devices):
            with cg.cusolver(), torch.cuda.device(dev):
                want_state, want = body(pre[k], inputs[k])
            for x, y in zip(tree_leaves((states[k], results[k])), tree_leaves((want_state, want))):
                assert x is None or (x.device == dev and (x.dtype.is_floating_point or torch.equal(x, y))), (i, k)
            torch.testing.assert_close(results[k].local_pose.translation, want.local_pose.translation,
                                       atol=2e-3, rtol=0)
    assert step.counts() == {"steps": 4 * mesh.size, "warmups": mesh.size, "captures": mesh.size,
                             "replays": 3 * mesh.size}
