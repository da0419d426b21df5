"""The LM traces that settle the card's early-exit departure (PERF.md §6):
tools/torch_lm_trace.py's `lm_trace` on the port and
tests/torch_lm_parity.py's `jax_lm_trace` on the JAX package, each against
its own package's `match` (pose, cost and iterations bit for bit), and the
two traces against each other from the same inputs within the tool's
f32 rounding bounds, with the same accept decisions and iterations, on a
small brick map (tests/test_torch_scan_matcher.py's scene, built by the
port, whose insert equals JAX's bit for bit)."""

import numpy as np
import pytest
import torch

import torch_lm_parity as lp
import torch_threads  # noqa: F401  (one torch thread per test process)
from dliom_tpu.io.synthetic import SyntheticWorld, corkscrew_trajectory
from dliom_tpu_torch.mapping import brick_grid as TB
from dliom_tpu_torch.transform.rigid import Rigid3 as TRigid3

HIGH = dict(resolution=0.1, dir_extent=64, max_bricks=16384, apply_groups=1024)
LOW = dict(resolution=0.45, dir_extent=16, max_bricks=2048, apply_groups=256, apply_group_bricks=8)


@pytest.fixture(scope="module")
def match_args():
    """One port `match` call's (args, kwargs) on a two-slot brick map."""
    world = SyntheticWorld.create(num_beams=8, num_azimuths=200)
    pts, _ = world.cast_scan(corkscrew_trajectory()[0][1])
    pts = pts[np.linalg.norm(pts, axis=-1) < 20.0].astype(np.float32)
    hits = np.broadcast_to(pts, (2,) + pts.shape).copy()
    kw = dict(hit_probability=0.55, miss_probability=0.49, num_free_space_voxels=2)
    banks = []
    for spec in (TB.BrickGridSpec(**HIGH), TB.BrickGridSpec(**LOW)):
        bank = TB.make_brick_bank(spec)
        for _ in range(2):
            bank = TB._insert_brick_slots(bank, torch.zeros(2, 3), torch.from_numpy(hits),
                                          torch.ones(hits.shape[:2], dtype=torch.bool), spec=spec, **kw)
        banks.append(bank)
    rng = np.random.default_rng(0)
    mask = torch.from_numpy(np.arange(200) < 190)
    clouds = [(torch.from_numpy(pts[rng.choice(len(pts), 200, replace=False)]), mask) for _ in range(2)]
    q0 = np.asarray([0.999, 0.02, -0.015, 0.03], np.float32)
    pose = TRigid3(torch.from_numpy(q0 / np.linalg.norm(q0)), torch.tensor([0.08, -0.05, 0.03]))
    return (pose,), dict(clouds=clouds, grids=banks, specs=[TB.BrickGridSpec(**HIGH), TB.BrickGridSpec(**LOW)],
                         grid_bases=[torch.tensor(1), torch.tensor(1)], occupied_space_weights=[1.0, 6.0],
                         translation_weight=6.0, rotation_weight=45.0, only_optimize_yaw=False,
                         max_iterations=6)


def test_traces_match_their_packages_and_each_other(match_args):
    """At function_tolerance 1e-2 this scene's LM accepts steps and exits
    early, at its third iteration (at 1e-3 it does not within 12)."""
    tol = 1e-2
    args, kwargs = match_args
    traces = lp.trace_both(args, dict(kwargs, function_tolerance=tol))
    assert traces["cpu"]["equal_to_match"] and traces["cpu"]["replayed"]
    # XLA fuses one jitted step apart from match's jitted loop: a few ulp
    assert traces["jax"]["match_iterations_equal"] and traces["jax"]["match_pose_diff"] < 1e-6
    rows = traces["cpu"]["rows"]
    assert any(r["accept"] for r in rows) and len(rows) == traces["jax"]["iterations"]
    assert len(rows) == next(k + 1 for k, r in enumerate(rows) if r["converged"]) == 3
    out = lp.tl.compare([traces], "jax", "cpu", tol)
    assert out["first_departure"] is None, out["first_departure"]
    assert out["iteration_flips"] == []


def test_tool_imports_no_jax():
    """tools/torch_lm_trace.py and chip_smoke.py, which phase 14 runs it
    from, import nothing of JAX or the JAX package (the card has no JAX)."""
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    code = ("import sys; sys.path[:0] = ['tools', '.']; import torch_lm_trace, chip_smoke; "
            "print(sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'dliom_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True, cwd=root)
    assert out.stdout.strip() == "[]"


# The late lane of tests/test_torch_mesh.py::test_batched_presearch_with_a_late_lane
# (ROADMAP §3): at its first scan, which has no points,
# the port's step and JAX's step, each from JAX's fresh state, part by
# 4.4e-4 m. Every stage before the sliding window's Gauss-Newton agrees to
# f32 rounding (the pre-search takes the lattice's corner candidate in both,
# the match leaves it, the window's inputs agree field by field); the GN,
# whose Jacobi-scaled normal equations have a condition number ~3.3e5 at
# that scan (the observation 0.35 m from the IMU prediction), then rounds
# apart in each package's f32 solve.
PRE_GN_RTOL = 1e-6  # each float field of the window before its GN, over the larger of its largest magnitude and 1
# (m, m/s, rad): the key's predicted position is ~1e-5 m, left by terms of ~4e-2 m that cancel
F32_SOLVE_SLACK = 2.0  # an f32 GN's departure from the f64 GN, in units of its solve error times the movement


def test_late_lane_parts_in_the_window_solve():
    """At the late lane's empty first scan, from one state
    (tests/torch_lm_parity.py::late_lane_window): (1) the window the GN
    starts from is the port's and JAX's alike, integer fields equal and
    float fields within PRE_GN_RTOL; (2) from that window the port's f32
    GN and JAX's f32 GN each land within F32_SOLVE_SLACK x (the f32
    solve's relative error against a float64 solve of the same system) x
    (the movement) of a float64 GN, positions compared, the system's
    condition number over 1e5; so the two f32 results part by no more
    than both bounds, and their gap (over 1e-4 m) is that rounding: the
    packages part in an ill-conditioned f32 solve, not in a stage of the
    port."""
    out = lp.late_lane_window()
    assert out["pre_gn_ints_equal"] and out["trace_equals_optimize"]
    assert max(out["pre_gn"].values()) <= PRE_GN_RTOL, out["pre_gn"]
    bound = F32_SOLVE_SLACK * max(out["solve_err"]) * out["moved"]
    assert min(out["cond"]) > 1e5, out["cond"]
    assert max(out["error"].values()) <= bound, (out, bound)
    assert 1e-4 < out["gap"] <= 2 * bound, (out, bound)
