"""Parity of the loop-closure backend's modules (dliom_tpu_torch/backend/)
and their helpers with the JAX package.

Bit-identical: `compress` / `decompress` (over capacity too),
`compress_brick` on one brick bank, `build_pyramid`, the range
synchronizer's merges, the interpolation buffer, `np_rotate_histogram`.
Equal best candidate with the score within 1e-5: `fast_correlative.match`
on the tests/test_fast_correlative.py scenes, and `match_full_submap`.
Equal best (yaw, shift) with the score within 1e-4: the image proposals
(pocketfft rounds differently from XLA's FFT). SPA poses within 5e-5 on
the tests/test_optimization.py problem (f32 conjugate gradients; the port
sums J^T J v from explicit 6x6 Jacobian blocks, JAX through jvp and vjp),
2e-5 with the optional blocks. f32 helpers within 1e-6.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dliom_tpu.backend import compression as JC
from dliom_tpu.backend import fast_correlative as JF
from dliom_tpu.backend import optimization as JO
from dliom_tpu.backend import precomputation as JPre
from dliom_tpu.backend import submap_projection as JProj
from dliom_tpu.common.config import FastCorrelativeConfig as JFCfg
from dliom_tpu.imu.initialization import static_initialize as j_static_initialize
from dliom_tpu.io.synthetic import ImuNoise as JImuNoise
from dliom_tpu.io.synthetic import ImuSimulator as JImuSimulator
from dliom_tpu.mapping import brick_grid as JB
from dliom_tpu.mapping import grid as JGrid
from dliom_tpu.mapping import probability as jpv
from dliom_tpu.ops import rotational_histogram as JH
from dliom_tpu.sensor.range_synchronizer import RangeDataSynchronizer as JSync
from dliom_tpu.transform import rigid as JR
from dliom_tpu.transform.interpolation import TransformInterpolationBuffer as JBuf
from dliom_tpu_torch.backend import compression as TC
from dliom_tpu_torch.backend import fast_correlative as TF
from dliom_tpu_torch.backend import optimization as TO
from dliom_tpu_torch.backend import precomputation as TPre
from dliom_tpu_torch.backend import submap_projection as TProj
from dliom_tpu_torch.common.config import FastCorrelativeConfig as TFCfg
from dliom_tpu_torch.imu.initialization import static_initialize as t_static_initialize
from dliom_tpu_torch.interop import to_numpy, to_torch
from dliom_tpu_torch.io.synthetic import ImuNoise as TImuNoise
from dliom_tpu_torch.io.synthetic import ImuSimulator as TImuSimulator
from dliom_tpu_torch.mapping import brick_grid as TB
from dliom_tpu_torch.mapping import grid as TGrid
from dliom_tpu_torch.ops import rotational_histogram as TH
from dliom_tpu_torch.sensor.range_synchronizer import RangeDataSynchronizer as TSync
from dliom_tpu_torch.transform import rigid as TR
from dliom_tpu_torch.transform.interpolation import TransformInterpolationBuffer as TBuf
from test_fast_correlative import _world_cloud
from test_optimization import _build_problem
import torch_threads  # noqa: F401  (one torch thread per test process)

CPU = torch.device("cpu")
HIGH = (0.2, 64)
LOW = (0.8, 32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _grid_pair(spec_args, seed=0, n=300, lo=-14, hi=14):
    rng = np.random.default_rng(seed)
    spec = JGrid.GridSpec(*spec_args)
    cells = jnp.asarray(rng.integers(lo, hi, size=(n, 3)), jnp.int32)
    vals = jnp.asarray(rng.integers(1, 32768, size=(n,)), jnp.int32)
    return np.asarray(JGrid.set_cells(JGrid.make_grid(spec), cells, vals, spec))


@pytest.mark.parametrize("capacity", [4096, 64])
def test_compress_decompress_bit_identical(capacity):
    g = _grid_pair((0.5, 32))
    jc = JC.compress(jnp.asarray(g), JGrid.GridSpec(0.5, 32), capacity)
    tc = TC.compress(_t(g), TGrid.GridSpec(0.5, 32), capacity)
    for a, b in zip(jax.tree.map(np.asarray, jc), to_numpy(tc)):
        np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(TC.decompress(tc, TGrid.GridSpec(0.5, 32)).numpy(),
                                  np.asarray(JC.decompress(jc, JGrid.GridSpec(0.5, 32))))


def test_compress_brick_bit_identical():
    """One brick bank (the port's inserts, whose parity
    tests/test_torch_grouped_apply.py holds; a recycled slot with stale
    pool cells), compressed by both packages into a dense crop."""
    spec_kw = dict(resolution=0.1, dir_extent=16, max_bricks=512, apply_groups=64,
                   apply_group_bricks=8)
    jspec = JB.BrickGridSpec(**spec_kw)
    tspec = TB.BrickGridSpec(**spec_kw)
    tbank = TB.make_brick_bank(tspec)
    rng = np.random.default_rng(3)
    kw = dict(hit_probability=0.55, miss_probability=0.49, num_free_space_voxels=2)
    for k in range(3):
        hits = rng.normal(0, 1.0, (2, 400, 3)).astype(np.float32)
        tbank = TB._insert_brick_slots(tbank, torch.zeros(2, 3), _t(hits),
                                       torch.ones(2, 400, dtype=torch.bool), spec=tspec, **kw)
        if k == 1:  # recycle slot 0: its pool keeps stale cells
            tbank = TB.reset_slot(tbank, tspec, 0)
    bank = JB.BrickBank(*(jnp.asarray(x) for x in to_numpy(tbank)))
    for slot in (0, 1):
        for crop, cap in ((JGrid.GridSpec(0.1, 64), 8192), (JGrid.GridSpec(0.1, 32), 1024)):
            jc = JB.compress_brick(bank, jspec, slot, crop, cap)
            tc = TB.compress_brick(tbank, tspec, slot,
                                   TGrid.GridSpec(crop.resolution, crop.extent), cap)
            for a, b in zip(jax.tree.map(np.asarray, jc), to_numpy(tc)):
                np.testing.assert_array_equal(b, a)
            assert int(tc.count) > 0


def test_build_pyramid_bit_identical():
    g = _grid_pair(HIGH, seed=1, n=2000, lo=-30, hi=30)
    jp = JPre.build_pyramid(jnp.asarray(g), JGrid.GridSpec(*HIGH), depth=6, full_resolution_depth=3)
    tp = TPre.build_pyramid(_t(g), TGrid.GridSpec(*HIGH), depth=6, full_resolution_depth=3)
    assert len(tp.levels) == len(jp.levels) == 6
    for a, b in zip(jp.levels, tp.levels):
        assert b.dtype == torch.uint8
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    cells = np.random.default_rng(2).integers(-40, 40, (100, 3)).astype(np.int32)
    np.testing.assert_array_equal(TPre.lookup(tp.levels[3], _t(cells), 16).numpy(),
                                  np.asarray(JPre.lookup(jp.levels[3], jnp.asarray(cells), 16)))


def _scene(expected_j, points):
    """The tests/test_fast_correlative.py scene on both packages."""
    world = expected_j.apply(jnp.asarray(points))
    vals = jnp.full((points.shape[0],), jpv.probability_to_value(jnp.float32(0.9)))
    hi, lo = JGrid.GridSpec(0.2, 128), JGrid.GridSpec(0.8, 64)
    g_hi = JGrid.set_cells(JGrid.make_grid(hi), JGrid.cell_index(world, 0.2), vals, hi)
    g_lo = JGrid.set_cells(JGrid.make_grid(lo), JGrid.cell_index(world, 0.8), vals, lo)
    return g_hi, g_lo


_FC = dict(branch_and_bound_depth=6, full_resolution_depth=3, min_rotational_score=0.3,
           min_low_resolution_score=0.4, linear_xy_search_window=4.0, linear_z_search_window=2.0,
           angular_search_window=math.radians(30.0))


@pytest.mark.parametrize("case", ["translation", "yaw_translation", "with_initial"])
def test_fast_correlative_match_same_best(case):
    if case == "translation":
        expected = JR.Rigid3.translation_only(jnp.asarray([1.0, -0.6, 0.4]))
        kw, fc = dict(num_angles=31, beam_width=256), _FC
    elif case == "yaw_translation":
        expected = JR.Rigid3(JR.quat_from_yaw(jnp.float32(math.radians(30.0) / 15 * 9)),
                             jnp.asarray([2.0, 1.5, -0.5]))
        kw, fc = dict(num_angles=31, beam_width=256), _FC
    else:
        expected = JR.Rigid3.translation_only(jnp.asarray([0.8, 0.4, 0.2]))
        kw = dict(num_angles=7, use_rotational_gate=False, beam_width=160, coarse_point_stride=2)
        fc = dict(_FC, angular_search_window=0.15)
    points = _world_cloud(np.random.default_rng(1))
    g_hi, g_lo = _scene(expected, points)
    jpyr = JPre.build_pyramid(g_hi, JGrid.GridSpec(0.2, 128), depth=6, full_resolution_depth=3)
    tpyr = to_torch(jax.tree.map(np.asarray, jpyr), CPU)
    pts = jnp.asarray(points)
    mask = jnp.ones(pts.shape[0], bool)
    hist = np.asarray(JH.compute_histogram(pts, mask, 120))
    shist = np.asarray(JH.compute_histogram(expected.apply(pts), mask, 120))
    jr = jax.jit(lambda pyr, g, p, m, h, sh: JF.match(
        pyr, JGrid.GridSpec(0.2, 128), g, JGrid.GridSpec(0.8, 64), p, m, p, m,
        JR.Rigid3.identity(), h, sh, jnp.float32(0.0), JFCfg(**fc), 0.3, **kw))(
        jpyr, g_lo, pts, mask, jnp.asarray(hist), jnp.asarray(shist))
    tr = TF.match(tpyr, TGrid.GridSpec(0.2, 128), _t(g_lo), TGrid.GridSpec(0.8, 64), _t(points),
                  torch.ones(len(points), dtype=torch.bool), _t(points),
                  torch.ones(len(points), dtype=torch.bool), TR.Rigid3.identity(), _t(hist),
                  _t(shist), torch.tensor(0.0), TFCfg(**fc), 0.3, **kw)
    assert bool(jr.found) and bool(tr.found)
    np.testing.assert_array_equal(tr.pose.translation.numpy(), np.asarray(jr.pose.translation))
    np.testing.assert_allclose(tr.pose.rotation.numpy(), np.asarray(jr.pose.rotation), atol=1e-6)
    np.testing.assert_allclose(float(tr.score), float(jr.score), atol=1e-5)
    np.testing.assert_allclose(float(tr.low_resolution_score), float(jr.low_resolution_score),
                               atol=1e-5)


def test_match_full_submap_same_best():
    expected = JR.Rigid3(JR.quat_from_yaw(jnp.float32(2 * math.pi / 32 * 5)),
                         jnp.asarray([1.2, -0.8, 0.2]))
    points = _world_cloud(np.random.default_rng(1))
    g_hi, g_lo = _scene(expected, points)
    jpyr = JPre.build_pyramid(g_hi, JGrid.GridSpec(0.2, 128), depth=6, full_resolution_depth=3)
    tpyr = to_torch(jax.tree.map(np.asarray, jpyr), CPU)
    pts = jnp.asarray(points)
    mask = jnp.ones(pts.shape[0], bool)
    hist = np.asarray(JH.compute_histogram(pts, mask, 120))
    shist = np.asarray(JH.compute_histogram(expected.apply(pts), mask, 120))
    fc = dict(_FC, min_rotational_score=0.5)
    jr = jax.jit(lambda pyr, g, p, m, h, sh: JF.match_full_submap(
        pyr, JGrid.GridSpec(0.2, 128), g, JGrid.GridSpec(0.8, 64), p, m, p, m,
        jnp.asarray([1.0, 0, 0, 0]), h, sh, JFCfg(**fc), 0.3, beam_width=512))(
        jpyr, g_lo, pts, mask, jnp.asarray(hist), jnp.asarray(shist))
    tm = torch.ones(len(points), dtype=torch.bool)
    tr = TF.match_full_submap(tpyr, TGrid.GridSpec(0.2, 128), _t(g_lo), TGrid.GridSpec(0.8, 64),
                              _t(points), tm, _t(points), tm, torch.tensor([1.0, 0, 0, 0]),
                              _t(hist), _t(shist), TFCfg(**fc), 0.3, beam_width=512)
    assert bool(jr.found) == bool(tr.found)
    np.testing.assert_array_equal(tr.pose.translation.numpy(), np.asarray(jr.pose.translation))
    np.testing.assert_allclose(float(tr.score), float(jr.score), atol=1e-5)


def test_image_proposal_same_best():
    points = _world_cloud(np.random.default_rng(4))
    anchor, _ = _scene(JR.Rigid3.identity(), points)
    other, _ = _scene(JR.Rigid3(JR.quat_from_yaw(jnp.float32(0.5)), jnp.asarray([2.0, -1.0, 0.0])),
                      points)
    spec_j, spec_t = JGrid.GridSpec(0.2, 128), TGrid.GridSpec(0.2, 128)
    ja, jo = (JProj.project_to_image(g, spec_j, 64) for g in (anchor, other))
    ta, to = (TProj.project_to_image(_t(g), spec_t, 64) for g in (anchor, other))
    np.testing.assert_array_equal(ta.image.numpy(), np.asarray(ja.image))
    assert ta.meters_per_pixel == ja.meters_per_pixel
    jp = JProj.propose_2d_transform(ja, jo, num_yaw=24)
    tp = TProj.propose_2d_transform(ta, to, num_yaw=24)
    np.testing.assert_allclose(float(tp.yaw), float(jp.yaw), atol=1e-6)
    np.testing.assert_array_equal(tp.shift_xy.numpy(), np.asarray(jp.shift_xy))
    np.testing.assert_allclose(float(tp.score), float(jp.score), atol=1e-4)
    node = TR.Rigid3(np.asarray([1.0, 0, 0, 0]), np.asarray([0.3, 0.2, 0.1]))
    jg = JProj.proposal_to_initial_guess(jax.tree.map(np.asarray, jp), JR.Rigid3(*node))
    tg = TProj.proposal_to_initial_guess(jax.tree.map(np.asarray, jp), node)
    np.testing.assert_array_equal(tg.translation, jg.translation)


def test_spa_solve_matches():
    data, _, _ = _build_problem(np.random.default_rng(0))
    jo = jax.jit(lambda d: JO.solve(d, iterations=3, cg_iterations=32))(data)
    to = TO.solve(to_torch(jax.tree.map(np.asarray, data), CPU), iterations=3, cg_iterations=32)
    for f in ("submap_q", "submap_t", "node_q", "node_t"):
        np.testing.assert_allclose(getattr(to, f).numpy(), np.asarray(getattr(jo, f)), atol=5e-5,
                                   err_msg=f)


def test_spa_with_node_links_fixed_frame_and_landmarks():
    """The optional residual blocks: node-node links, a Huber-weighted
    fixed-frame observation and a landmark, 3 GN steps."""
    data, _, _ = _build_problem(np.random.default_rng(1), num_submaps=2, nodes_per_submap=4)
    nn = np.zeros(1024, bool)
    nn[:3] = True
    ff = np.zeros(256, bool)
    ff[0] = True
    lm = np.zeros(256, bool)
    lm[:2] = True
    lmp = np.zeros(64, bool)
    lmp[0] = True
    data = data._replace(
        nn_first=jnp.asarray(np.arange(1024) % 4, jnp.int32),
        nn_second=jnp.asarray(np.arange(1024) % 4 + 1, jnp.int32),
        nn_trans_weight=jnp.full(1024, 10.0), nn_rot_weight=jnp.full(1024, 10.0),
        nn_valid=jnp.asarray(nn),
        ff_node=jnp.zeros(256, jnp.int32), ff_t=jnp.ones((256, 3)), ff_weight=jnp.full(256, 10.0),
        ff_valid=jnp.asarray(ff),
        lm_node=jnp.zeros(256, jnp.int32), lm_node2=jnp.ones(256, jnp.int32),
        lm_alpha=jnp.full(256, 0.3), lm_rel_t=jnp.ones((256, 3)),
        lm_trans_weight=jnp.full(256, 5.0), lm_rot_weight=jnp.full(256, 1.0),
        lm_valid=jnp.asarray(lm), lm_pos_valid=jnp.asarray(lmp),
        lm_positions=jnp.zeros((64, 3)).at[0].set(jnp.asarray([1.0, 2.0, 0.5])),
    )
    kw = dict(iterations=3, cg_iterations=32, ff_huber_scale=1.0)
    jo = jax.jit(lambda d: JO.solve(d, **kw))(data)
    to = TO.solve(to_torch(jax.tree.map(np.asarray, data), CPU), **kw)
    for f in ("submap_t", "node_q", "node_t", "lm_positions", "lm_q"):
        np.testing.assert_allclose(getattr(to, f).numpy(), np.asarray(getattr(jo, f)), atol=2e-5,
                                   err_msg=f)


def test_histogram_rotation_and_match():
    rng = np.random.default_rng(5)
    h = rng.random(120).astype(np.float32)
    ref = rng.random(120).astype(np.float32)
    angles = np.linspace(-1.0, 1.0, 41).astype(np.float32)
    for a in (0.0, 0.6, -2.3):
        np.testing.assert_allclose(TH.rotate_histogram(_t(h), a).numpy(),
                                   np.asarray(JH.rotate_histogram(jnp.asarray(h), jnp.float32(a))),
                                   atol=1e-6)
        np.testing.assert_array_equal(TH.np_rotate_histogram(h, a), JH.np_rotate_histogram(h, a))
    np.testing.assert_allclose(TH.match_histograms(_t(h), _t(ref), _t(angles)).numpy(),
                               np.asarray(JH.match_histograms(jnp.asarray(h), jnp.asarray(ref),
                                                              jnp.asarray(angles))), atol=1e-6)
    assert float(TH.match_histograms(torch.zeros(120), _t(ref), _t(angles))[0]) == 1.0


def test_range_synchronizer_merges_bit_identical():
    rng = np.random.default_rng(0)
    j, t = JSync(["a", "b", "c"], 0.1), TSync(["a", "b", "c"], 0.1)
    for k in range(6):
        stamp = 0.1 * (k + 1)
        for sid in ("b", "c"):
            if (k + (sid == "c")) % 2 == 0:
                pts = rng.normal(size=(50, 3)).astype(np.float32)
                tms = -rng.random(50).astype(np.float32) * 0.15
                assert j.add_range_data(sid, stamp + 0.02, pts, tms) is None
                assert t.add_range_data(sid, stamp + 0.02, pts, tms) is None
        pts = rng.normal(size=(80, 3)).astype(np.float32)
        outs = [s.add_range_data("a", stamp, pts, None, synthesize_times=True) for s in (j, t)]
        assert outs[0][0] == outs[1][0]
        np.testing.assert_array_equal(outs[1][1], outs[0][1])
        np.testing.assert_array_equal(outs[1][2], outs[0][2])


def test_interpolation_buffer_bit_identical():
    rng = np.random.default_rng(1)
    jb, tb = JBuf(buffer_size_limit=20), TBuf(buffer_size_limit=20)
    for k in range(30):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        p = rng.normal(size=3)
        jb.push(0.1 * k, JR.Rigid3(q, p))
        tb.push(0.1 * k, TR.Rigid3(q, p))
    tb.trim_before(1.25)
    jb.trim_before(1.25)
    for t in np.linspace(1.3, 2.9, 23):
        a, b = jb.lookup(float(t)), tb.lookup(float(t))
        np.testing.assert_array_equal(b.rotation, a.rotation)
        np.testing.assert_array_equal(b.translation, a.translation)
    assert len(jb) == len(tb) and jb.has(2.0) == tb.has(2.0)


def test_rigid_helpers_static_init_and_imu_simulator():
    rng = np.random.default_rng(2)
    v = rng.normal(0, 1.0, (10, 3)).astype(np.float32)
    np.testing.assert_allclose(TR.so3_exp(_t(v)).numpy(), np.asarray(JR.so3_exp(jnp.asarray(v))),
                               atol=1e-6)
    m = np.asarray(JR.so3_exp(jnp.asarray(v)))
    np.testing.assert_allclose(TR.so3_log(_t(m)).numpy(), np.asarray(JR.so3_log(jnp.asarray(m))),
                               atol=1e-5)
    np.testing.assert_allclose(TR.quat_from_rotation_matrix(_t(m)).numpy(),
                               np.asarray(JR.quat_from_rotation_matrix(jnp.asarray(m))), atol=1e-6)
    q = np.asarray(JR.quat_from_axis_angle(jnp.asarray(v[0])), np.float64)
    q2 = np.asarray(JR.quat_from_axis_angle(jnp.asarray(v[1])), np.float64)
    assert TR.np_quat_yaw(q) == JR.np_quat_yaw(q)
    np.testing.assert_array_equal(TR.np_quat_slerp(q, q2, 0.3), JR.np_quat_slerp(q, q2, 0.3))
    pose = JR.Rigid3(jnp.asarray(q, jnp.float32), jnp.asarray(v[2]))
    np.testing.assert_array_equal(TR.np_rigid(TR.Rigid3(_t(q).float(), _t(v[2]))).translation,
                                  JR.np_rigid(pose).translation)
    accs = (np.asarray([0.3, -0.2, 9.7]) + rng.normal(0, 0.05, (40, 3))).astype(np.float32)
    gyrs = rng.normal(0, 0.01, (40, 3)).astype(np.float32)
    mask = np.arange(40) < 35
    for a, b in zip(j_static_initialize(jnp.asarray(accs), jnp.asarray(gyrs), jnp.asarray(mask), 9.80511),
                    t_static_initialize(_t(accs), _t(gyrs), _t(mask), 9.80511)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)
    noise = dict(acc_noise=0.02, gyr_noise=0.002, gyr_bias0=(0.0, 0.0, 0.004))
    js, ts = JImuSimulator(noise=JImuNoise(**noise), seed=4), TImuSimulator(noise=TImuNoise(**noise), seed=4)
    pa = JR.Rigid3(np.asarray([1.0, 0, 0, 0], np.float32), np.zeros(3, np.float32))
    pb = JR.Rigid3(np.asarray([math.cos(0.015), 0, 0, math.sin(0.015)], np.float32),
                   np.asarray([0.15, 0.002, 0.0], np.float32))
    for a, b in zip(js.between(pa, pb, np.zeros(3), np.asarray([1.5, 0.04, 0]), 0.1, 64),
                    ts.between(TR.Rigid3(*pa), TR.Rigid3(*pb), np.zeros(3), np.asarray([1.5, 0.04, 0]),
                               0.1, 64)):
        np.testing.assert_array_equal(b, a)
