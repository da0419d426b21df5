"""Parity of dliom_tpu_torch/imu/window_optimizer.py with the JAX package:
the same keys pushed into both windows and optimized. Residuals and
Jacobians agree to f32 rounding, but the Gauss-Newton normal equations
carry entries up to ~8e9 here: a float32 solve of one and the same system
(numpy's) lands ~2e-4 from the float64 step in the weakly held velocities,
and the two packages' solves differ by up to ~5e-4. Float state is held to
atol 1e-3; flags and counts exactly.

The off-by-default exact marginalization forms its prior by an f32 Schur
complement of those same equations. Compounded over several slides it is
too ill-conditioned to compare (jitted and eager JAX already disagree), so
one slide is compared: the prior's information to 1% of its largest entry
and its mean to atol 5e-3."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dliom_tpu.common.config import load_config
from dliom_tpu.imu import preintegration as JP
from dliom_tpu.imu import window_optimizer as JW
from dliom_tpu.transform.rigid import Rigid3 as JRigid3
from dliom_tpu_torch.imu import preintegration as TP
from dliom_tpu_torch.imu import window_optimizer as TW
from dliom_tpu_torch.transform.rigid import Rigid3 as TRigid3
import torch_threads  # noqa: F401  (one torch thread per test process)

ATOL = 1e-3
_IMU = load_config("basic").trajectory_builder.imu
G = 9.80511


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_window_close(jw, tw):
    for f in JW.WindowState._fields:
        a, b = np.asarray(getattr(jw, f)), getattr(tw, f).numpy()
        if a.dtype == bool or a.dtype.kind == "i":
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(b, a, atol=ATOL, rtol=1e-4, err_msg=f)


@pytest.fixture(scope="module")
def filled():
    """Both windows after w + 2 keys (filled, then slid twice), compared
    after every push and every optimize."""
    j_push = jax.jit(JW.push_key, static_argnums=(7, 8))
    j_optimize = jax.jit(JW.optimize, static_argnums=(1, 2, 3))
    rng = np.random.default_rng(0)
    w = 4
    nav = JP.NavState.identity()
    ba = bg = jnp.zeros(3)
    jwin = JW.make_window(w, nav, ba, bg, _IMU)
    twin = TW.make_window(w, TP.NavState(*(_t(x) for x in nav)), _t(ba), _t(bg), _IMU)
    _assert_window_close(jwin, twin)
    jnav, tnav = nav, TP.NavState(*(_t(x) for x in nav))
    for k in range(w + 2):  # fills the window, then slides twice
        accs = np.tile(np.array([0.2, 0.0, G], np.float32), (48, 1)) + rng.normal(0, 0.05, (48, 3)).astype(np.float32)
        gyrs = rng.normal(0, 0.01, (48, 3)).astype(np.float32)
        dts = np.full(48, 0.0025, np.float32)
        mask = np.arange(48) < 40
        jpre = JP.integrate_sequential(JP.make_preintegrated(ba, bg, jnp.asarray(accs[0]), jnp.asarray(gyrs[0])),
                                       jnp.asarray(dts), jnp.asarray(accs), jnp.asarray(gyrs),
                                       jnp.asarray(mask), JP.noise_matrix(_IMU))
        tpre = TP.Preintegrated(*(_t(x) for x in jpre))
        jpred = JP.predict(jnav, jpre, G)
        tpred = TP.NavState(*(_t(x) for x in jpred))
        obs_q = np.asarray(jpred.rotation) + rng.normal(0, 0.01, 4).astype(np.float32)
        obs_q /= np.linalg.norm(obs_q)
        obs_t = np.asarray(jpred.position) + rng.normal(0, 0.02, 3).astype(np.float32)
        gdir = np.asarray([0.01, -0.02, -1.0], np.float32)
        gvalid = k % 2 == 0
        jwin = j_push(jwin, jpre, jpred, JRigid3(jnp.asarray(obs_q), jnp.asarray(obs_t)),
                           jnp.bool_(k == 3), jnp.asarray(gdir), jnp.bool_(gvalid), _IMU, G)
        twin = TW.push_key(twin, tpre, tpred, TRigid3(_t(obs_q), _t(obs_t)), torch.tensor(k == 3),
                           _t(gdir), torch.tensor(gvalid), _IMU, G)
        _assert_window_close(jwin, twin)
        jwin = j_optimize(jwin, _IMU, G, 3)
        twin = TW.optimize(twin, _IMU, G, iterations=3)
        _assert_window_close(jwin, twin)
        (jnav, jba, jbg), (tnav, tba, tbg) = JW.latest_state(jwin), TW.latest_state(twin)
        for a, b in zip((*jnav, jba, jbg), (*tnav, tba, tbg)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL)
        assert bool(JW.failure_detected(jwin)) == bool(TW.failure_detected(twin))
        jnav = JP.NavState(*(jnp.asarray(np.asarray(x)) for x in jnav))
    assert int(twin.num_keys) == w
    return jwin, twin


def test_push_and_optimize(filled):
    jwin, twin = filled
    assert int(twin.num_keys) == int(jwin.num_keys) == twin.window


def test_marginalize_oldest_one_slide(filled):
    jwin, _ = filled
    jm = JW._marginalize_oldest(jwin, _IMU, G)
    tm = TW._marginalize_oldest(TW.WindowState(*(_t(x) for x in jwin)), _IMU, G)
    hj = np.asarray(jm.prior_sqrt_info).T @ np.asarray(jm.prior_sqrt_info)
    ht = tm.prior_sqrt_info.numpy().T @ tm.prior_sqrt_info.numpy()
    np.testing.assert_allclose(ht, hj, atol=1e-2 * np.abs(hj).max())
    for f in ("prior_q", "prior_p", "prior_v", "prior_ba", "prior_bg", "q", "p", "v"):
        np.testing.assert_allclose(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)), atol=5e-3, err_msg=f)
    assert int(tm.num_keys) == int(jm.num_keys)


def test_sqrt_information():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(9, 9)).astype(np.float32)
    cov = (a @ a.T * 1e-4).astype(np.float32)
    np.testing.assert_allclose(TW.sqrt_information(_t(cov)).numpy(),
                               np.asarray(JW.sqrt_information(jnp.asarray(cov))), rtol=1e-3, atol=1e-3)


def _lane_inputs(lanes: int, w: int):
    """`fuse_window`'s inputs for `lanes` different lanes, each a window of
    w keys with w - 1 - b pushed already (lane 0 full, the others not) and
    its own IMU bridge, scan-match pose and gravity flag."""
    from dliom_tpu_torch.common.config import load_config as t_load_config

    cfg = t_load_config("basic", {"trajectory_builder": {"window_size": w, "gn_iterations": 2}}).trajectory_builder
    rng = np.random.default_rng(7)
    out = []
    for b in range(lanes):
        nav, ba, bg = TP.NavState.identity(), torch.zeros(3), torch.zeros(3)
        win = TW.make_window(w, nav, ba, bg, _IMU)
        for k in range(w - b):
            accs = torch.from_numpy((np.array([0.2, 0.1, G]) + rng.normal(0, 0.05, (24, 3))).astype(np.float32))
            gyrs = torch.from_numpy((np.array([0.0, 0.0, 0.2]) + rng.normal(0, 0.01, (24, 3))).astype(np.float32))
            preint = TP.integrate(TP.make_preintegrated(ba, bg, accs[0], gyrs[0]), torch.full((24,), 0.004),
                                  accs, gyrs, torch.arange(24) < 20, TP.noise_matrix(_IMU))
            predicted = TP.predict(nav, preint, G)
            noise = torch.from_numpy(rng.normal(0, 0.01, 7).astype(np.float32))
            pose = TRigid3(TW.quat_normalize(predicted.rotation + noise[:4]), predicted.position + noise[4:])
            grav_dir = torch.tensor([0.01, -0.02, -1.0]) / np.sqrt(1.0005)
            grav_ok = torch.tensor((b + k) % 2 == 0)
            if k == w - b - 1:
                out.append((win, preint, predicted, pose, grav_dir, grav_ok, ba, bg))
                break
            win = TW.push_key(win, preint, predicted, pose, torch.tensor(False), grav_dir, grav_ok, _IMU, G)
            nav = predicted
    return cfg, out


def test_window_lanes_equal_fuse_window_per_lane():
    """The batched window stage split in three (the pushes under vmap, one
    `optimize` over the (B, W, ...) window, the finish under vmap) against
    `fuse_window` lane by lane, at B = 3, W = 4, with windows full and not."""
    from torch.utils._pytree import tree_map

    from dliom_tpu_torch.frontend.lio import fuse_window
    from dliom_tpu_torch.parallel.batch import window_lanes

    cfg, lanes = _lane_inputs(3, 4)
    stacked = tree_map(lambda *xs: torch.stack(xs), *lanes)
    pose, (win, nav, ba, bg, failed) = window_lanes(*stacked, cfg)
    assert win.num_keys.tolist() == [4, 4, 3]
    for b, args in enumerate(lanes):
        l_pose, (l_win, l_nav, l_ba, l_bg, l_failed) = fuse_window(*args, cfg)
        for f in TW.WindowState._fields:
            x, y = getattr(win, f)[b], getattr(l_win, f)
            if y.is_floating_point():
                torch.testing.assert_close(x, y, atol=ATOL, rtol=1e-4, msg=f)
            else:
                assert torch.equal(x, y), f
        for x, y in zip((*pose, *nav, ba, bg), (*l_pose, *l_nav, l_ba, l_bg)):
            torch.testing.assert_close(x[b], y, atol=ATOL, rtol=1e-4)
        assert bool(failed[b]) == bool(l_failed)
