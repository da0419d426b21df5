"""Windows for holding K3 (csrc/window_gn.cu) against `optimize_plain`,
and the comparison both the card tests and tools/torch_window_gn_times.py
make. No test lives here."""

from __future__ import annotations

import numpy as np
import torch

from dliom_tpu_torch.common.config import load_config
from dliom_tpu_torch.imu import preintegration as TP
from dliom_tpu_torch.imu import window_optimizer as wo
from dliom_tpu_torch.transform.rigid import Rigid3

ITERATIONS = 8
FIELDS = ("q", "p", "v", "ba", "bg")


def pushed_windows(preset: str, w: int, gravity: bool, empty_at=None, seed=0):
    """Windows of `preset`'s IMU settings after each of w + 2 pushes (the
    first ones not full, the last two slid), optimized on the CPU between
    pushes as the LIO step does; an empty preintegration (its factor's
    sqrt-information zero) at push `empty_at`; gravity rows at every other
    key where `gravity`. Returns (ImuConfig, [WindowState]) on the CPU."""
    imu = load_config(preset).trajectory_builder.imu
    rng = np.random.default_rng(seed)
    nav, ba, bg = TP.NavState.identity(), torch.zeros(3), torch.zeros(3)
    win = wo.make_window(w, nav, ba, bg, imu)
    out = []
    for k in range(w + 2):
        accs = torch.from_numpy((np.array([0.2, 0.1, imu.gravity]) + rng.normal(0, 0.05, (48, 3))).astype(np.float32))
        gyrs = torch.from_numpy((np.array([0.0, 0.0, 0.3]) + rng.normal(0, 0.01, (48, 3))).astype(np.float32))
        mask = torch.arange(48) < (0 if k == empty_at else 40)
        pre = TP.integrate(TP.make_preintegrated(ba, bg, accs[0], gyrs[0]), torch.full((48,), 0.0025),
                           accs, gyrs, mask, TP.noise_matrix(imu))
        pred = TP.predict(nav, pre, imu.gravity)
        noise = torch.from_numpy(rng.normal(0, 0.01, 7).astype(np.float32))
        pose = Rigid3(wo.quat_normalize(pred.rotation + noise[:4]), pred.position + 2 * noise[4:])
        gdir = torch.tensor([0.01, -0.02, -1.0]) / np.sqrt(1.0005)
        win = wo.push_key(win, pre, pred, pose, torch.tensor(k == 3), gdir,
                          torch.tensor(gravity and k % 2 == 0), imu, imu.gravity)
        out.append(win)
        win = wo.optimize_plain(win, imu, imu.gravity, ITERATIONS)
        i = win.num_keys - 1
        nav = TP.NavState(win.q[i], win.p[i], win.v[i])
    return imu, out


def field_gaps(got: wo.WindowState, want: wo.WindowState, start: wo.WindowState) -> dict:
    """Per float field: the largest difference of K3's result from the plain
    version's (`gap`), and the largest move the plain version made from
    the window it started from (`step`)."""
    return {f: {"gap": float((getattr(got, f) - getattr(want, f)).abs().max()),
                "step": float((getattr(want, f) - getattr(start, f)).abs().max())} for f in FIELDS}


# K3's bound against the plain version, per field, at 8 iterations and at
# 1: 2.3-14 times the largest difference over the card tests' windows
# (1.8e-5, 9.9e-5, 4.4e-4, 7.3e-9, 1.5e-8, at 1 iteration), none above
# tests/test_torch_window.py's 1e-3. The biases move by 1e-7 to 7e-6 an
# iteration, so a bias column of the Jacobian zeroed or halved shows there
# as a difference of 4.5e-7 to 7.2e-6, which a bound as wide as the pose's
# would pass.
ATOL = {"q": 1e-4, "p": 5e-4, "v": 1e-3, "ba": 1e-7, "bg": 2e-7}


def out_of_bounds(gaps: dict) -> list:
    """The fields of `{"iterations_<n>": field_gaps(...)}` outside their
    bounds, as strings; empty where every field is within them."""
    return [f"{key} {f}: gap {g['gap']:.3e} > {ATOL[f]:.1e}"
            for key, by_field in gaps.items() for f, g in by_field.items() if g["gap"] > ATOL[f]]
