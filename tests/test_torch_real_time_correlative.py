"""Parity of the online correlative matcher
(dliom_tpu_torch/ops/real_time_correlative.py) with the JAX package: the
candidate lattice exactly (its truncation warning included), `match` on a
dense grid and on a brick bank (slot 1) picking the same candidate, and the
frontend step with the pre-search on against JAX's.

Tolerances: the best candidate is the same lattice index; its score within
1e-6 and its pose within 1e-6 (the same f32 arithmetic on the same
offsets); frontend poses within 2e-3 (m, and quaternion components), as
tests/test_torch_lio.py.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_local_trajectory_builder as tltb
from dliom_tpu.common.config import load_config as j_load_config
from dliom_tpu.frontend import local_trajectory_builder as JF
from dliom_tpu.mapping import brick_grid as JB
from dliom_tpu.mapping import grid as JGrid
from dliom_tpu.mapping import probability as jpv
from dliom_tpu.ops import real_time_correlative as JR
from dliom_tpu.transform.rigid import Rigid3 as JRigid3
from dliom_tpu_torch.common.config import load_config as t_load_config
from dliom_tpu_torch.frontend import local_trajectory_builder as TF
from dliom_tpu_torch.interop import to_numpy, to_torch
from dliom_tpu_torch.io.synthetic import SyntheticWorld, corkscrew_trajectory
from dliom_tpu_torch.mapping import brick_grid as TB
from dliom_tpu_torch.mapping import grid as TGrid
from dliom_tpu_torch.ops import real_time_correlative as TR
from dliom_tpu_torch.sensor.types import pad_point_cloud
from dliom_tpu_torch.transform.rigid import Rigid3 as TRigid3
from dliom_tpu_torch.transform.rigid import (
    np_compose,
    np_inverse,
    quat_from_axis_angle,
    quat_multiply,
    quat_normalize,
    quat_rotate,
)
import torch_threads  # noqa: F401  (one torch thread per test process)

CPU = torch.device("cpu")
SEARCH = dict(linear_search_window=0.45, angular_search_window=0.05, max_scan_range=10.0,
              max_angular_steps=2)


@pytest.mark.parametrize("args", [
    (0.2, 0.15, 0.0174533, 100.0, 4),  # campus: 27 x 729, truncated from 9 steps
    (0.1, 0.3, 0.0, 60.0, 4),
    (0.2, 0.45, 0.05, 10.0, 2),
])
def test_lattice_identical(args):
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        jt, ja = JR._lattice(*args)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        tt, ta = TR._lattice(*args)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(ta, ja)
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
    if args[0] == 0.2 and args[1] == 0.15:
        assert len(tt) == 27 * 729 and len(tw) == 1


def _box_world(rng, n=600):
    """tests/test_real_time_correlative.py's box walls."""
    axis = rng.integers(0, 3, n)
    pts = rng.uniform(-4, 4, (n, 3))
    pts[np.arange(n), axis] = rng.choice([-1.0, 1.0], n) * 4.0
    return pts.astype(np.float32)


def _jax_index(jres, initial, off_t, off_aa):
    """The lattice index of JAX's answer: the candidate whose pose it is."""
    q0 = torch.from_numpy(initial[0])
    dq = quat_from_axis_angle(torch.from_numpy(off_aa))
    cand_q = quat_normalize(quat_multiply(q0, dq)).numpy()
    cand_t = (torch.from_numpy(initial[1]) + quat_rotate(q0, torch.from_numpy(off_t))).numpy()
    d = (np.abs(cand_q - np.asarray(jres.pose.rotation)).max(1)
         + np.abs(cand_t - np.asarray(jres.pose.translation)).max(1))
    return int(np.argmin(d))


@pytest.mark.parametrize("kind", ["dense", "brick"])
def test_match_picks_the_same_candidate(kind):
    rng = np.random.default_rng(0)
    pts = _box_world(rng)
    initial = (np.asarray([np.cos(0.02), 0.0, 0.01, np.sin(0.02)], np.float32),
               np.asarray([0.1, -0.05, 0.02], np.float32))
    initial = (initial[0] / np.linalg.norm(initial[0]), initial[1])
    offset = np.asarray([0.4, -0.2, 0.2], np.float32)
    cloud = pts - offset
    mask = np.ones(len(cloud), bool)
    mask[::7] = False
    if kind == "dense":
        spec_j, spec_t = JGrid.GridSpec(0.2, 64), TGrid.GridSpec(0.2, 64)
        vals = jnp.full((len(pts),), jpv.probability_to_value(jnp.float32(0.9)))
        grid = JGrid.set_cells(JGrid.make_grid(spec_j), JGrid.cell_index(jnp.asarray(pts), 0.2), vals, spec_j)
        bank_n = np.concatenate([np.zeros_like(np.asarray(grid)), np.asarray(grid)])  # slot 1
        jvals, tvals = jnp.asarray(bank_n), torch.from_numpy(bank_n)
        jbase, tbase = spec_j.num_cells, torch.tensor(spec_t.num_cells)
    else:
        kw = dict(resolution=0.2, dir_extent=8, max_bricks=512, apply_groups=0, apply_group_bricks=8)
        spec_j, spec_t = JB.BrickGridSpec(**kw), TB.BrickGridSpec(**kw)
        tbank = TB.make_brick_bank(spec_t)
        hits = torch.from_numpy(np.stack([pts, pts]))
        for _ in range(3):
            tbank = TB._insert_brick_slots(
                tbank, torch.zeros(2, 3), hits, torch.tensor([[False], [True]]).expand(2, len(pts)),
                spec=spec_t, hit_probability=0.7, miss_probability=0.4, num_free_space_voxels=1)
        jvals, tvals = JB.BrickBank(*map(jnp.asarray, to_numpy(tbank))), tbank
        jbase, tbase = 1, torch.tensor(1)
    jres = JR.match(JRigid3(*map(jnp.asarray, initial)), jnp.asarray(cloud), jnp.asarray(mask), jvals,
                    spec_j, base=jbase, **SEARCH)
    tres = TR.match(TRigid3(*map(torch.from_numpy, initial)), torch.from_numpy(cloud),
                    torch.from_numpy(mask), tvals, spec_t, base=tbase, **SEARCH)
    off_t, off_aa = TR._lattice(spec_t.resolution, SEARCH["linear_search_window"],
                                SEARCH["angular_search_window"], SEARCH["max_scan_range"],
                                SEARCH["max_angular_steps"])
    assert int(tres.index) == _jax_index(jres, initial, off_t, off_aa)
    assert float(tres.score) > 0.5
    np.testing.assert_allclose(float(tres.score), float(jres.score), atol=1e-6)
    np.testing.assert_allclose(tres.pose.translation.numpy(), np.asarray(jres.pose.translation), atol=1e-6)
    np.testing.assert_allclose(tres.pose.rotation.numpy(), np.asarray(jres.pose.rotation), atol=1e-6)


def test_frontend_step_with_presearch_matches_jax():
    """tests/test_real_time_correlative.py::test_online_correlative_in_frontend
    on both packages from one state, at a smaller lattice and cloud."""
    tb = dataclasses.asdict(tltb._config())
    tb.update(use_online_correlative_scan_matching=True, max_high_res_points=512)
    tb["real_time_correlative_scan_matcher"].update(
        linear_search_window=0.2, angular_search_window=0.008, max_angular_steps=2)
    jcfg = j_load_config("basic", {"trajectory_builder": tb}).trajectory_builder
    tcfg = t_load_config("basic", {"trajectory_builder": tb}).trajectory_builder
    jstate = JF.make_initial_state(jcfg)
    tstate = to_torch(jax.tree.map(np.asarray, jstate), CPU)
    world = SyntheticWorld.create()
    prev = TRigid3(np.asarray([1.0, 0, 0, 0], np.float32), np.zeros(3, np.float32))
    jstep = jax.jit(lambda s, x: JF.step(s, x, jcfg))
    for t, pose in corkscrew_trajectory()[:4]:
        pts, times = world.cast_scan(pose)
        cloud = pad_point_cloud(pts, times, tltb.CAPACITY)
        rel = tuple(np.asarray(x, np.float32) for x in np_compose(np_inverse(prev), pose))
        jstate, jres = jstep(jstate, JF.ScanInput(
            time=jnp.float32(t), points=jnp.asarray(cloud.points), times=jnp.asarray(cloud.times),
            mask=jnp.asarray(cloud.mask), relative_prediction=JRigid3(*map(jnp.asarray, rel))))
        tstate, tres = TF.step(tstate, TF.ScanInput(
            time=torch.tensor(t, dtype=torch.float32), points=torch.from_numpy(cloud.points),
            times=torch.from_numpy(cloud.times), mask=torch.from_numpy(cloud.mask),
            relative_prediction=TRigid3(*map(torch.from_numpy, rel))), tcfg)
        np.testing.assert_allclose(tres.local_pose.translation.numpy(),
                                   np.asarray(jres.local_pose.translation), atol=2e-3)
        np.testing.assert_allclose(tres.local_pose.rotation.numpy(),
                                   np.asarray(jres.local_pose.rotation), atol=2e-3)
        assert float(np.linalg.norm(tres.local_pose.translation.numpy() - np.asarray(pose.translation))) < 0.1
        prev = pose
