"""Parity of dynamic (in-motion) initialization with the JAX package:
the linear-alignment solves (dliom_tpu_torch/imu/initialization.py) on one
window that the JAX initializer assembled, and `DynamicInitializer`
(dliom_tpu_torch/imu/dynamic_initializer.py) on
tests/test_dynamic_init.py's sequence (bubbles world, time-varying
acceleration, 100 Hz IMU, a scan every 0.25 s), fed the same scans and
samples as the JAX initializer.

Tolerances: gravity within 1e-3 m/s^2 and velocities within 1e-3 m/s on
one window (dense f32 solves of the 1000x-scaled systems); the
initializer triggers on the same scan with the nav state within 2e-3
(quaternion components, m, m/s): six chained NDT matches of f32 LM.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dliom_tpu.imu.dynamic_initializer as JDI
from dliom_tpu.common.config import load_config as j_load_config
from dliom_tpu.imu import initialization as JI
from dliom_tpu.transform.rigid import Rigid3 as JRigid3
from dliom_tpu_torch.common.config import load_config as t_load_config
from dliom_tpu_torch.imu import dynamic_initializer as TDI
from dliom_tpu_torch.imu import initialization as TI
from dliom_tpu_torch.interop import to_torch
from dliom_tpu_torch.io.synthetic import SyntheticWorld
from dliom_tpu_torch.transform.rigid import Rigid3 as TRigid3
import torch_threads  # noqa: F401  (one torch thread per test process)

G = 9.80511
CPU = torch.device("cpu")
OVERRIDES = {"trajectory_builder": {"enable_ndt_initialization": True,
                                    "frames_for_dynamic_initialization": 6}}
NAV_ATOL = 2e-3


def _sequence(accel_scale):
    """tests/test_dynamic_init.py::_run_sequence's feed: per scan (stamp,
    points, the IMU samples that follow it, true velocity at the scan)."""
    world = SyntheticWorld.create()
    dt, imu_rate = 0.25, 100
    g_w = np.array([0.0, 0.0, -G])
    p, v, t = np.zeros(3), np.zeros(3), 0.0
    out = []
    for _ in range(9):
        pose = TRigid3(np.asarray([1.0, 0, 0, 0], np.float32), np.asarray(p, np.float32))
        pts, _ = world.cast_scan(pose)
        v_scan = v.copy()
        n = int(dt * imu_rate)
        sub = dt / n
        imu = []
        for i in range(n):
            tau = t + (i + 0.5) * sub
            a_w = accel_scale * np.array([1.4 * np.cos(1.8 * tau), 1.0 * np.sin(1.8 * tau), 0.0])
            imu.append((t + (i + 1) * sub, (a_w - g_w).astype(np.float32), np.zeros(3, np.float32)))
            p = p + v * sub + 0.5 * a_w * sub * sub
            v = v + a_w * sub
        out.append((t, pts, imu, v_scan))
        t += dt
    return out


def _run(init, seq):
    """Feed until the initializer answers; returns (scan index, result)."""
    for k, (t, pts, imu, _) in enumerate(seq):
        result = init.add_scan(t, pts)
        if result is not None:
            return k, result
        for ti, acc, gyr in imu:
            init.add_imu(ti, acc, gyr)
    return None, None


@pytest.fixture(scope="module")
def moving():
    return _sequence(1.0)


@pytest.fixture(scope="module")
def jax_run(moving):
    """The JAX initializer on the moving sequence: (trigger scan, result,
    the last alignment window it solved, as numpy)."""
    windows = []
    real = JDI.initialize_dynamic

    def recording(inp, tlb, g_norm):
        windows.append(jax.tree.map(np.asarray, inp))
        return real(inp, tlb, g_norm)

    JDI.initialize_dynamic = recording
    try:
        k, res = _run(JDI.DynamicInitializer(j_load_config("basic", OVERRIDES).trajectory_builder), moving)
    finally:
        JDI.initialize_dynamic = real
    assert k is not None and windows
    return k, res, windows[-1]


def test_alignment_solves_match(jax_run):
    inp_n = jax_run[2]
    jinp = JI.AlignmentInput(*map(jnp.asarray, inp_n))
    tinp = to_torch(inp_n, CPU)
    jid, tid = JRigid3.identity(), TRigid3.identity()

    jg, jv, jok = JI.approximate_gravity(jinp, jid, G)
    tg, tv, tok = TI.approximate_gravity(tinp, tid, G)
    assert bool(tok) == bool(jok)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-3)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-3)

    jg2, jv2 = JI.refine_gravity(jinp, jid, G, jg)
    tg2, tv2 = TI.refine_gravity(tinp, tid, G, torch.from_numpy(np.array(jg)))
    np.testing.assert_allclose(tg2.numpy(), np.asarray(jg2), atol=1e-3)
    np.testing.assert_allclose(tv2.numpy(), np.asarray(jv2), atol=1e-3)

    jg3, jv3, jok3 = JI.initialize_dynamic(jinp, jid, G)
    tg3, tv3, tok3 = TI.initialize_dynamic(tinp, tid, G)
    assert bool(tok3) == bool(jok3) is True
    np.testing.assert_allclose(tg3.numpy(), np.asarray(jg3), atol=1e-3)
    np.testing.assert_allclose(tv3.numpy(), np.asarray(jv3), atol=1e-3)


def test_initializer_triggers_like_jax(moving, jax_run):
    jk, jres, _ = jax_run
    tk, tres = _run(TDI.DynamicInitializer(t_load_config("basic", OVERRIDES).trajectory_builder, CPU),
                    moving)
    assert tk == jk
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, jres)), tres.nav + (tres.ba, tres.bg)):
        np.testing.assert_allclose(b.numpy(), a, atol=NAV_ATOL)
    # tests/test_dynamic_init.py's accuracy bounds, on the port
    up = TRigid3(tres.nav.rotation, torch.zeros(3)).apply(torch.tensor([0.0, 0.0, 1.0]))
    assert float(up[2]) > 0.99
    v_est = tres.nav.velocity.numpy()
    assert np.linalg.norm(v_est) > 0.3
    assert np.linalg.norm(v_est - moving[tk][3]) < 0.4


def test_initializer_rejects_without_excitation():
    tk, _ = _run(TDI.DynamicInitializer(t_load_config("basic", OVERRIDES).trajectory_builder, CPU),
                 _sequence(0.0))
    assert tk is None


def test_initializer_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tb = t_load_config("campus").trajectory_builder
    with pytest.raises(RuntimeError, match="CUDA"):
        TDI.DynamicInitializer(tb, "cuda")
    assert TDI.DynamicInitializer(tb, "cpu").device.type == "cpu"
