"""The full tightly-coupled LIO step (port of dliom_tpu/frontend/lio.py):
IMU preintegration + prediction + deskew + scan matching + sliding-window
fusion + failure reset + insertion, the per-scan flow of
local_trajectory_builder_3d.cc with WindowOptimize in the loop.

The submap banks inside the state are updated in place by each step (the
JAX package donates them to the same effect); every other field is new.
The IMU bridge and the window stage run under `common/stages.py::stage`
spans (lio.preintegrate, lio.window) beside the frontend's.

`lio_step` runs eagerly, as the JAX `lio_step` is not jitted either. Its
compiled forms are `make_jit_lio_step` (one CUDA graph replay per scan) and
`make_jit_lio_chunk` (one replay per chunk of scans), `common/graph.py`'s
`StepGraph` over the same step (it has no host read: the LM runs its fixed
trip); `run_lio_chunk` is the eager loop.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Sequence, Tuple

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from dliom_tpu_torch.common.config import TrajectoryBuilderConfig
from dliom_tpu_torch.common.device import constant
from dliom_tpu_torch.common.graph import StepGraph
from dliom_tpu_torch.common.stages import stage
from dliom_tpu_torch.frontend.local_trajectory_builder import (
    FrontendState,
    ScanInput,
    ScanResult,
    make_initial_state,
    step,
)
from dliom_tpu_torch.imu import preintegration as pre
from dliom_tpu_torch.imu import window_optimizer as wo
from dliom_tpu_torch.imu.initialization import AlignmentInput, estimate_gravity
from dliom_tpu_torch.imu.window_optimizer import tree_where
from dliom_tpu_torch.mapping.brick_grid import _take
from dliom_tpu_torch.transform.rigid import Rigid3, _norm, quat_inverse_rotate, quat_rotate


class LioState(NamedTuple):
    frontend: FrontendState
    window: wo.WindowState
    nav: pre.NavState
    ba: torch.Tensor
    bg: torch.Tensor
    last_acc: torch.Tensor  # midpoint partner carried across scans
    last_gyr: torch.Tensor
    failures: torch.Tensor  # () int32 count of FailureDetection resets


class LioScanInput(NamedTuple):
    time: torch.Tensor
    points: torch.Tensor  # (N, 3)
    times: torch.Tensor  # (N,)
    mask: torch.Tensor  # (N,)
    imu_dts: torch.Tensor  # (M,)
    imu_acc: torch.Tensor  # (M, 3)
    imu_gyr: torch.Tensor  # (M, 3)
    imu_mask: torch.Tensor  # (M,) prefix mask


class LioResult(NamedTuple):
    scan: ScanResult
    velocity: torch.Tensor
    ba: torch.Tensor
    bg: torch.Tensor
    failed: torch.Tensor
    gravity_valid: torch.Tensor


def make_lio_state(cfg: TrajectoryBuilderConfig, initial: pre.NavState, ba, bg) -> LioState:
    """State after initialization (InitializeIMU, :332-357), on the device
    of `initial`."""
    dev = initial.rotation.device
    frontend = make_initial_state(cfg, dev)._replace(pose=initial.pose)
    g_body = quat_inverse_rotate(
        initial.rotation, torch.tensor([0.0, 0.0, cfg.imu.gravity], dtype=torch.float32, device=dev))
    ba = ba.to(torch.float32)
    bg = bg.to(torch.float32)
    return LioState(
        frontend=frontend,
        window=wo.make_window(cfg.window_size, initial, ba, bg, cfg.imu),
        nav=initial,
        ba=ba,
        bg=bg,
        last_acc=g_body + ba,
        last_gyr=bg.clone(),
        failures=torch.zeros((), dtype=torch.int32, device=dev),
    )


def _window_gravity(win: wo.WindowState, cfg: TrajectoryBuilderConfig):
    """Gravity direction from the optimizer window (EstimateGravity,
    :1106-1154); returns (direction_in_world, valid)."""
    w = win.window
    t0 = Rigid3(win.q[0], win.p[0])
    t0_inv = t0.inverse()
    rel_q = t0_inv.compose(Rigid3(win.q, torch.zeros_like(win.p))).rotation
    rel_p = t0_inv.apply(win.p)
    v_body = quat_inverse_rotate(win.q, win.v)
    ar = torch.arange(w, device=win.q.device)
    inp = AlignmentInput(rotations=rel_q, translations=rel_p, delta_p=win.pre_p,
                         delta_v=win.pre_v, dts=win.pre_dt,
                         pair_mask=(ar < win.num_keys) & (ar > 0))
    g_b, ok = estimate_gravity(inp, v_body, Rigid3.identity(device=win.q.device), cfg.imu.gravity)
    g_world = quat_rotate(t0.rotation, -g_b)
    ok = ok & (g_world[2] + cfg.imu.gravity < 0.5)
    ok = ok & (win.num_keys >= min(w, cfg.frames_for_online_gravity_estimate))
    return g_world / torch.clamp(_norm(g_world), min=1e-9), ok


def push_window(window: wo.WindowState, preint: pre.Preintegrated, predicted: pre.NavState,
                pose_estimate: Rigid3, grav_dir, grav_ok, cfg: TrajectoryBuilderConfig) -> wo.WindowState:
    """The window stage's first part: the scan's key pushed."""
    return wo.push_key(window, preint, predicted, pose_estimate,
                       torch.zeros((), dtype=torch.bool, device=grav_dir.device), grav_dir, grav_ok,
                       cfg.imu, cfg.imu.gravity)


def finish_window(win: wo.WindowState, predicted: pre.NavState, ba, bg,
                  cfg: TrajectoryBuilderConfig):
    """The window stage's last part: the newest state, and FailureDetection
    -> ResetParams (:896-913). Returns (fused pose, (window, nav, ba, bg,
    failed))."""
    nav2, ba2, bg2 = wo.latest_state(win)
    failed = wo.failure_detected(win)
    reset_win = wo.make_window(cfg.window_size, predicted, ba, bg, cfg.imu)
    win = tree_where(failed, reset_win, win)
    nav2 = tree_where(failed, predicted, nav2)
    ba2 = torch.where(failed, ba, ba2)
    bg2 = torch.where(failed, bg, bg2)
    return nav2.pose, (win, nav2, ba2, bg2, failed)


def fuse_window(window: wo.WindowState, preint: pre.Preintegrated, predicted: pre.NavState,
                pose_estimate: Rigid3, grav_dir, grav_ok, ba, bg, cfg: TrajectoryBuilderConfig):
    """The window stage: push the scan's key, Gauss-Newton, the newest
    state, and FailureDetection -> ResetParams. Returns (fused pose,
    (window, nav, ba, bg, failed))."""
    win = push_window(window, preint, predicted, pose_estimate, grav_dir, grav_ok, cfg)
    win = wo.optimize(win, cfg.imu, cfg.imu.gravity, iterations=cfg.gn_iterations)
    return finish_window(win, predicted, ba, bg, cfg)


def imu_carry(imu_acc, imu_gyr, imu_mask, last_acc, last_gyr):
    """The last valid IMU sample, the next scan's midpoint partner."""
    n_imu = torch.sum(imu_mask, dtype=torch.int32)
    last_idx = torch.clamp(n_imu - 1, min=0)
    has_imu = n_imu > 0
    return (torch.where(has_imu, _take(imu_acc, last_idx), last_acc),
            torch.where(has_imu, _take(imu_gyr, last_idx), last_gyr))


def lio_step(state: LioState, inp: LioScanInput, cfg: TrajectoryBuilderConfig) -> Tuple[LioState, LioResult]:
    dev = inp.points.device
    noise = pre.noise_matrix(cfg.imu, dev)
    g_norm = cfg.imu.gravity

    # 1. preintegrate the IMU bridge (kernel K2 on CUDA)
    with stage("lio.preintegrate"):
        p0 = pre.make_preintegrated(state.ba, state.bg, state.last_acc, state.last_gyr)
        preint = pre.integrate(p0, inp.imu_dts, inp.imu_acc, inp.imu_gyr, inp.imu_mask, noise)
        predicted = pre.predict(state.nav, preint, g_norm)
    rel = state.nav.pose.inverse().compose(predicted.pose)

    if cfg.enable_gravity_factor:
        grav_dir, grav_ok = _window_gravity(state.window, cfg)
    else:
        grav_dir = constant([0.0, 0.0, -1.0], device=dev)
        grav_ok = torch.zeros((), dtype=torch.bool, device=dev)

    def fuse(pose_estimate: Rigid3):
        with stage("lio.window"):
            return fuse_window(state.window, preint, predicted, pose_estimate, grav_dir, grav_ok,
                               state.ba, state.bg, cfg)

    scan = ScanInput(time=inp.time, points=inp.points, times=inp.times, mask=inp.mask,
                     relative_prediction=rel)
    new_frontend, (result, (win, nav2, ba2, bg2, failed)) = step(state.frontend, scan, cfg,
                                                                 fuse_fn=fuse)

    last_acc, last_gyr = imu_carry(inp.imu_acc, inp.imu_gyr, inp.imu_mask, state.last_acc,
                                   state.last_gyr)
    new_state = LioState(
        frontend=new_frontend,
        window=win,
        nav=nav2,
        ba=ba2,
        bg=bg2,
        last_acc=last_acc,
        last_gyr=last_gyr,
        failures=state.failures + failed.to(torch.int32),
    )
    return new_state, LioResult(scan=result, velocity=nav2.velocity, ba=ba2, bg=bg2,
                                failed=failed, gravity_valid=grav_ok)


def run_lio_chunk(state: LioState, scans: Sequence[LioScanInput],
                  cfg: TrajectoryBuilderConfig) -> Tuple[LioState, List[LioResult]]:
    """Run the eager `lio_step` over consecutive scans, one call each (the
    compiled chunk is `make_jit_lio_chunk`)."""
    results = []
    for scan in scans:
        state, res = lio_step(state, scan, cfg)
        results.append(res)
    return state, results


def frontend_bank_leaves(state: FrontendState) -> List[torch.Tensor]:
    """The grid banks of a (one- or B-lane) frontend state: the tensors a
    step updates in place, which a compiled step keeps rather than copies."""
    sm = state.submaps
    leaves = tree_flatten([sm.high_values, sm.low_values, sm.high_brick, sm.low_brick])[0]
    return [x for x in leaves if x is not None]


def bank_leaves(state: LioState) -> List[torch.Tensor]:
    """`frontend_bank_leaves` of a LIO state's frontend."""
    return frontend_bank_leaves(state.frontend)


def stack_results(results: Sequence):
    """Results of consecutive steps stacked on a new leading axis."""
    flat = [tree_flatten(r) for r in results]
    spec = flat[0][1]
    return tree_unflatten([None if xs[0] is None else torch.stack(xs)
                           for xs in zip(*(leaves for leaves, _ in flat))], spec)


def chunk_body(step, chunk: int):
    """`step(state, scan)` over `chunk` scans stacked on a leading axis:
    (state, scans) -> (state, stacked results)."""

    def run(state, scans):
        n = tree_flatten(scans)[0][0].shape[0]
        if n != chunk:
            raise ValueError(f"chunk of {chunk} steps given {n} scans")
        results = []
        for i in range(chunk):
            state, res = step(state, type(scans)(*(x[i] for x in scans)))
            results.append(res)
        return state, stack_results(results)

    return run


def make_jit_lio_step(cfg: TrajectoryBuilderConfig) -> StepGraph:
    """Compiled LIO step: `fn(state, inp) -> (state, result)`, `lio_step`
    captured into one CUDA graph and replayed per scan
    on a CUDA state (eager through the same buffers on a CPU state). The
    banks update in place and the returned state and result are the
    graph's buffers (`common/graph.py`), so the JAX package's split/join
    donation plumbing has no counterpart."""
    return StepGraph(functools.partial(lio_step, cfg=cfg), adopt=bank_leaves)


def make_jit_lio_chunk(cfg: TrajectoryBuilderConfig, chunk: int) -> StepGraph:
    """Compiled multi-scan step: `fn(state, scans) -> (state, results)`
    over a LioScanInput whose leaves carry a leading (chunk, ...) axis,
    with the LioResults stacked the same way; one graph of `chunk` step
    bodies, so one replay per chunk (the JAX `lax.scan` in one dispatch)."""
    return StepGraph(chunk_body(functools.partial(lio_step, cfg=cfg), chunk), adopt=bank_leaves)
