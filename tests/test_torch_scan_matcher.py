"""Parity of the port's scan matcher, rotational histogram, motion filter and
online gravity estimate with the JAX package, on a brick map built from
the synthetic world. The matcher's pose must agree within 1e-4 (m and
quaternion components: two f32 LM solves whose sums are ordered apart)
with an equal iteration count."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dliom_tpu.imu import initialization as JI
from dliom_tpu.io.synthetic import SyntheticWorld, corkscrew_trajectory
from dliom_tpu.mapping import brick_grid as JB
from dliom_tpu.mapping import motion_filter as JMF
from dliom_tpu.ops import rotational_histogram as JH
from dliom_tpu.ops import scan_matcher as JS
from dliom_tpu.transform.rigid import Rigid3 as JRigid3
from dliom_tpu_torch.imu import initialization as TI
from dliom_tpu_torch.mapping import brick_grid as TB
from dliom_tpu_torch.mapping import motion_filter as TMF
from dliom_tpu_torch.ops import rotational_histogram as TH
from dliom_tpu_torch.ops import scan_matcher as TS
from dliom_tpu_torch.transform.rigid import Rigid3 as TRigid3
import torch_threads  # noqa: F401  (one torch thread per test process)

POSE_ATOL = 1e-4
HIGH = dict(resolution=0.1, dir_extent=64, max_bricks=16384, apply_groups=1024)
LOW = dict(resolution=0.45, dir_extent=16, max_bricks=2048, apply_groups=256, apply_group_bricks=8)


@pytest.fixture(scope="module")
def scene():
    world = SyntheticWorld.create(num_beams=8, num_azimuths=200)
    pts, _ = world.cast_scan(corkscrew_trajectory()[0][1])
    pts = pts[np.linalg.norm(pts, axis=-1) < 20.0].astype(np.float32)
    hits = np.broadcast_to(pts, (2,) + pts.shape).copy()
    masks = np.ones(hits.shape[:2], bool)
    kw = dict(hit_probability=0.55, miss_probability=0.49, num_free_space_voxels=2)
    banks = []
    for spec_kw in (HIGH, LOW):
        bank = JB.make_brick_bank(JB.BrickGridSpec(**spec_kw))
        for _ in range(2):
            bank = JB._insert_brick_slots(bank, jnp.zeros((2, 3)), jnp.asarray(hits),
                                          jnp.asarray(masks), spec=JB.BrickGridSpec(**spec_kw), **kw)
        assert int(bank.dropped[0]) == 0
        banks.append(bank)
    rng = np.random.default_rng(0)
    hi = pts[rng.choice(len(pts), 200, replace=False)]
    lo = pts[rng.choice(len(pts), 200, replace=False)]
    return banks, hi, lo


@pytest.mark.parametrize("tol,yaw", [(1e-3, False), (0.0, False), (1e-6, True)])
def test_match_parity(scene, tol, yaw):
    banks, hi, lo = scene
    q0 = np.asarray([0.999, 0.02, -0.015, 0.03], np.float32)
    q0 /= np.linalg.norm(q0)
    t0 = np.asarray([0.08, -0.05, 0.03], np.float32)
    mask = np.ones(200, bool)
    mask[-10:] = False
    common = dict(occupied_space_weights=[1.0, 6.0], translation_weight=6.0, rotation_weight=45.0,
                  only_optimize_yaw=yaw, max_iterations=6, function_tolerance=tol)
    rj = JS.match(JRigid3(jnp.asarray(q0), jnp.asarray(t0)),
                  clouds=[(jnp.asarray(hi), jnp.asarray(mask)), (jnp.asarray(lo), jnp.asarray(mask))],
                  grids=banks, specs=[JB.BrickGridSpec(**HIGH), JB.BrickGridSpec(**LOW)],
                  grid_bases=[1, 1], **common)
    tbanks = [TB.BrickBank(*(torch.from_numpy(np.array(x)) for x in b)) for b in banks]
    rt = TS.match(TRigid3(torch.from_numpy(q0), torch.from_numpy(t0)),
                  clouds=[(torch.from_numpy(hi), torch.from_numpy(mask)),
                          (torch.from_numpy(lo), torch.from_numpy(mask))],
                  grids=tbanks, specs=[TB.BrickGridSpec(**HIGH), TB.BrickGridSpec(**LOW)],
                  grid_bases=[torch.tensor(1), torch.tensor(1)], **common)
    assert int(rt.iterations) == int(rj.iterations)
    np.testing.assert_allclose(rt.pose.translation.numpy(), np.asarray(rj.pose.translation), atol=POSE_ATOL)
    np.testing.assert_allclose(rt.pose.rotation.numpy(), np.asarray(rj.pose.rotation), atol=POSE_ATOL)
    np.testing.assert_allclose(float(rt.cost), float(rj.cost), rtol=1e-3)
    np.testing.assert_allclose(float(rt.initial_cost), float(rj.initial_cost), rtol=1e-5)
    assert float(rt.cost) < float(rt.initial_cost)


def test_rotational_histogram(scene):
    _, hi, _ = scene
    rng = np.random.default_rng(1)
    pts = np.concatenate([hi, rng.uniform(-8, 8, (600, 3)).astype(np.float32)])
    mask = rng.random(len(pts)) < 0.95
    hj = np.asarray(JH.compute_histogram(jnp.asarray(pts), jnp.asarray(mask), 120))
    ht = TH.compute_histogram(torch.from_numpy(pts), torch.from_numpy(mask), 120).numpy()
    # index_add_ and the one-hot matmul sum in other orders
    np.testing.assert_allclose(ht, hj, rtol=1e-4, atol=1e-4)
    assert hj.sum() > 0


def test_motion_filter():
    js, ts = JMF.MotionFilterState.initial(), TMF.MotionFilterState.initial()
    poses = [([1, 0, 0, 0], [0, 0, 0]), ([1, 0, 0, 0], [0.1, 0, 0]), ([1, 0, 0, 0], [0.3, 0, 0]),
             ([0.998, 0, 0, 0.0628], [0.3, 0, 0]), ([0.998, 0, 0, 0.0628], [0.3, 0, 0])]
    for k, (q, t) in enumerate(poses):
        q = np.asarray(q, np.float32) / np.linalg.norm(q)
        t = np.asarray(t, np.float32)
        time = np.float32(0.1 * k if k < 4 else 2.0)
        sj, js = JMF.is_similar(js, jnp.asarray(time), JRigid3(jnp.asarray(q), jnp.asarray(t)),
                                max_time_seconds=0.5, max_distance_meters=0.2,
                                max_angle_radians=np.radians(5.0))
        st, ts = TMF.is_similar(ts, torch.tensor(time), TRigid3(torch.from_numpy(q), torch.from_numpy(t)),
                                max_time_seconds=0.5, max_distance_meters=0.2,
                                max_angle_radians=np.radians(5.0))
        assert bool(sj) == bool(st), k
    assert int(ts.num_different) == int(js.num_different) == 4


def test_estimate_gravity():
    rng = np.random.default_rng(2)
    w = 6
    q = rng.normal(0, 0.1, (w, 4)).astype(np.float32)
    q[:, 0] = 1.0
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    fields = dict(rotations=q, translations=rng.normal(0, 1, (w, 3)).astype(np.float32),
                  delta_p=rng.normal(0, 0.1, (w, 3)).astype(np.float32),
                  delta_v=rng.normal(0, 1.0, (w, 3)).astype(np.float32),
                  dts=np.full(w, 0.1, np.float32), pair_mask=np.arange(w) > 0)
    vel = rng.normal(0, 1, (w, 3)).astype(np.float32)
    gj, okj = JI.estimate_gravity(JI.AlignmentInput(**{k: jnp.asarray(v) for k, v in fields.items()}),
                                  jnp.asarray(vel), JRigid3.identity(), 9.80511)
    gt, okt = TI.estimate_gravity(TI.AlignmentInput(**{k: torch.from_numpy(v) for k, v in fields.items()}),
                                  torch.from_numpy(vel), TRigid3.identity(), 9.80511)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-4, atol=1e-4)
    assert bool(okt) == bool(okj)
