"""Levenberg-Marquardt scan-to-grid matcher (port of
dliom_tpu/ops/scan_matcher.py; reference CeresScanMatcher3D,
ceres_scan_matcher_3d.cc).

Objective, per grid g and point i: w_g / sqrt(N_g) * (1 - p_g(T * p_i))
(OccupiedSpaceCostFunction3D), plus a translation prior w_t * (t - t0) and
a rotation prior w_r * imag(q0^-1 * q). The pose moves by a 6-dof tangent
step (dt, dw) with q' = exp(dw) * q, or yaw only. The residual Jacobian is
`torch.func.jacfwd` through the smoothed trilinear interpolation, one
forward pass carrying all 6 tangents; the primal comes back with it.

The trust-region LM (Ceres-style rho acceptance, non-monotonic reference
cost, best-pose tracking) is one Python loop over a batch of lanes,
`_lm_iterate`. `match` runs it at one lane, or at B lanes (the batched
frontend, parallel/batch.py: one pose, cloud and bank slot per lane, the
banks shared); with function_tolerance > 0 it reads `converged` on the
host after each iteration and stops once every lane has converged,
freezing each converged lane meanwhile, so each lane's `iterations` equals
the JAX while loop's (under vmap, for B lanes). The B lanes' Jacobians
come from one forward pass: every lane moves by the same 6 tangents, and a
lane's residuals depend on its own pose only.

`match_batch` refines B poses at once (the loop-closure refinement, which
the JAX package vmaps): all `max_iterations` steps run with each lane
frozen once it has converged — the result of the JAX while loop under
vmap, with no host read. It takes its Jacobian in reverse mode: it runs on
background threads, and forward-mode AD keeps its level in process-global
state (torch.autograd.forward_ad), so a second thread in `jacfwd` would
pull the level out from under the frontend's. Each residual row reads its
own copy of the tangent, so one backward pass gives every row's Jacobian
(a `jacrev` would run one backward pass per row).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch
from torch.func import jacfwd

from dliom_tpu_torch.mapping.brick_grid import BrickBank, interpolated_probability_brick
from dliom_tpu_torch.mapping.grid import interpolated_probability
from dliom_tpu_torch.transform.rigid import (
    Rigid3,
    quat_conjugate,
    quat_from_axis_angle,
    quat_from_yaw,
    quat_multiply,
    quat_normalize,
)


class ScanMatcherResult(NamedTuple):
    pose: Rigid3
    cost: torch.Tensor  # final summed squared residual
    initial_cost: torch.Tensor
    iterations: torch.Tensor  # () int32 LM iterations run


def _residuals(pose: Rigid3, clouds, grids, specs, weights, target_translation,
               target_rotation, translation_weight, rotation_weight, bases) -> torch.Tensor:
    """(M,) residuals of one lane, or (B, M) of B lanes: poses (B, ·),
    clouds (B, N, ·) and bases (B, 1, 1)."""
    parts = []
    for (points, mask), values, spec, w, base in zip(clouds, grids, specs, weights, bases):
        n = torch.clamp(torch.sum(mask.to(torch.float32), dim=-1), min=1.0)
        world = Rigid3(pose.rotation[..., None, :], pose.translation[..., None, :]).apply(points)
        if isinstance(values, BrickBank):
            prob = interpolated_probability_brick(values, world, spec, base)
        else:
            prob = interpolated_probability(values, world, spec, base)
        r = (w / torch.sqrt(n))[..., None] * (1.0 - prob)
        parts.append(torch.where(mask, r, 0.0))
    parts.append(translation_weight * (pose.translation - target_translation))
    dq = quat_multiply(quat_conjugate(target_rotation), pose.rotation)
    dq = torch.where(dq[..., 0:1] < 0.0, -dq, dq)
    parts.append(rotation_weight * dq[..., 1:4])
    return torch.cat(parts, dim=-1)


def _apply_delta(pose: Rigid3, delta: torch.Tensor, only_yaw: bool) -> Rigid3:
    """World-frame (left-multiplied) rotation perturbation
    (rotation_parameterization.h:27-39)."""
    # delta[3:4], not delta[3]: under jacfwd a Python float times a 0-dim
    # tensor gets a float64 tangent
    dq = quat_from_yaw(delta[3:4])[0] if only_yaw else quat_from_axis_angle(delta[3:6])
    return Rigid3(
        rotation=quat_normalize(quat_multiply(dq, pose.rotation)),
        translation=pose.translation + delta[0:3],
    )


def _apply_delta_rows(q: torch.Tensor, t: torch.Tensor, delta: torch.Tensor, only_yaw: bool):
    """`_apply_delta` over leading axes: delta (..., ndelta) moves q (..., 4)
    and t (..., 3); returns (rotation, translation)."""
    dq = quat_from_yaw(delta[..., 3]) if only_yaw else quat_from_axis_angle(delta[..., 3:6])
    return quat_normalize(quat_multiply(dq, q)), t + delta[..., 0:3]


def match(
    initial_pose: Rigid3,
    clouds: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    grids: Sequence,
    specs: Sequence,
    *,
    occupied_space_weights: Sequence[float],
    translation_weight: float,
    rotation_weight: float,
    target_translation: torch.Tensor | None = None,
    only_optimize_yaw: bool = False,
    max_iterations: int = 12,
    grid_bases: Sequence | None = None,
    function_tolerance: float = 0.0,
) -> ScanMatcherResult:
    """Refine `initial_pose` so the clouds (tracking frame) match the grids
    (submap frame); CeresScanMatcher3D::Match. `grid_bases`: per grid, the
    bank slot (brick grids) or flat offset (dense grids). For B lanes the
    pose is (B, ·), the clouds (B, N, ·), each base a (B,) tensor, and the
    result's fields carry the lane axis."""
    batched = initial_pose.rotation.dim() == 2
    if target_translation is None:
        target_translation = initial_pose.translation
    if grid_bases is None:
        grid_bases = [0] * len(grids)
    if batched:
        grid_bases = [torch.as_tensor(b).reshape(-1, 1, 1) for b in grid_bases]
    target_rotation = initial_pose.rotation
    dev = initial_pose.translation.device
    zero = torch.zeros(4 if only_optimize_yaw else 6, dtype=torch.float32, device=dev)

    def residual_at(delta, pose):
        return _residuals(
            _apply_delta(pose, delta, only_optimize_yaw), clouds, grids, specs,
            occupied_space_weights, target_translation, target_rotation,
            translation_weight, rotation_weight, grid_bases,
        )

    def r_and_jac(pose):
        """Residual and ((B,) M, ndelta) Jacobian from one forward-mode pass."""
        jac, r = jacfwd(lambda d: (residual_at(d, pose),) * 2, has_aux=True)(zero)
        return r, jac

    def lane(cand):
        """`r_and_jac` for the one-lane batch of `_lm_iterate`."""
        r, jac = r_and_jac(Rigid3(cand.rotation[0], cand.translation[0]))
        return r[None], jac[None]

    r0, jac0 = r_and_jac(initial_pose)
    initial_cost = torch.sum(r0 * r0, dim=-1)
    carry = _initial_carry(initial_pose, r0, jac0, initial_cost)
    if batched:
        carry, iterations = _lm_iterate(carry, r_and_jac, only_optimize_yaw, max_iterations,
                                        function_tolerance, host_exit=True)
        return ScanMatcherResult(pose=carry[6], cost=carry[7], initial_cost=initial_cost,
                                 iterations=iterations)
    carry, iterations = _lm_iterate(_lanes(lambda x: x[None], carry), lane, only_optimize_yaw,
                                    max_iterations, function_tolerance, host_exit=True)
    best = carry[6]
    return ScanMatcherResult(pose=Rigid3(best.rotation[0], best.translation[0]), cost=carry[7][0],
                             initial_cost=initial_cost, iterations=iterations[0])


def _lanes(fn, *carries):
    """`fn` over the matching tensors of carries (poses field by field)."""
    return tuple(Rigid3(fn(*(x.rotation for x in xs)), fn(*(x.translation for x in xs)))
                 if isinstance(xs[0], Rigid3) else fn(*xs) for xs in zip(*carries))


def _initial_carry(pose: Rigid3, r, jac, cost):
    """(pose, r, jac, cost, radius, ref_cost, best_pose, best_cost)."""
    return (pose, r, jac, cost, torch.full_like(cost, 1e4), cost, pose, cost)


def _lm_iterate(carry, r_and_jac, only_yaw: bool, max_iterations: int,
                function_tolerance: float, host_exit: bool):
    """The trust-region LM over a batch of lanes (leading axis) from the
    carry of `_initial_carry`; `r_and_jac(poses)` gives the (B, M)
    residuals and (B, M, ndelta) Jacobians. Ceres-style rho acceptance,
    non-monotonic reference cost, best-pose tracking. With function_tolerance
    > 0 a lane stops once it has converged and is frozen from then on (the
    JAX while loop under vmap): `host_exit` reads that on the host after
    each iteration and stops the loop when every lane has (the JAX while
    loop's trip count, the most any lane needs); otherwise all
    `max_iterations` run, with no host read. Returns (carry, iterations
    (B,) int32)."""
    b = carry[3].shape[0]
    dev = carry[3].device
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    iterations = torch.zeros(b, dtype=torch.int32, device=dev)
    for _ in range(max_iterations):
        pose, r, jac, cost, radius, ref_cost, best_pose, best_cost = carry
        grad = (jac.transpose(-1, -2) @ r[..., None])[..., 0]
        hess = jac.transpose(-1, -2) @ jac
        d2 = torch.clamp(torch.diagonal(hess, dim1=-2, dim2=-1), 1e-12, 1e32)
        damped = hess + (1.0 / radius)[:, None, None] * torch.diag_embed(d2)
        chol = torch.linalg.cholesky_ex(damped, check_errors=False).L
        step = -torch.cholesky_solve(grad[..., None], chol)[..., 0]
        cand = Rigid3(*_apply_delta_rows(pose.rotation, pose.translation, step, only_yaw))
        cand_r, cand_jac = r_and_jac(cand)
        new_cost = torch.sum(cand_r * cand_r, dim=-1)
        model_reduction = -(2.0 * torch.sum(step * grad, -1)
                            + torch.einsum("bi,bij,bj->b", step, hess, step))
        rho = (ref_cost - new_cost) / torch.clamp(model_reduction, min=1e-12)
        accept = rho > 1e-3
        a1, a2 = accept[:, None], accept[:, None, None]
        # FunctionToleranceReached, checked for every evaluated candidate
        converged = torch.abs(cost - new_cost) <= function_tolerance * cost
        shrink = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
        is_best = accept & (new_cost < best_cost)
        b1 = is_best[:, None]
        new = (Rigid3(torch.where(a1, cand.rotation, pose.rotation),
                      torch.where(a1, cand.translation, pose.translation)),
               torch.where(a1, cand_r, r),
               torch.where(a2, cand_jac, jac),
               torch.where(accept, new_cost, cost),
               torch.where(accept, torch.clamp(radius / shrink, max=1e6),
                           torch.clamp(radius * 0.25, min=1e-6)),
               torch.where(accept, 0.5 * ref_cost + 0.5 * new_cost, ref_cost),
               Rigid3(torch.where(b1, cand.rotation, best_pose.rotation),
                      torch.where(b1, cand.translation, best_pose.translation)),
               torch.where(is_best, new_cost, best_cost))
        live = ~done
        if host_exit and b == 1:
            carry = new  # the loop stops before its one lane could be frozen
        else:
            carry = _lanes(lambda n, o: torch.where(
                live.reshape((-1,) + (1,) * (n.dim() - 1)), n, o), new, carry)
        iterations = iterations + live.to(torch.int32)
        if function_tolerance > 0.0:
            done = done | converged
            if host_exit and bool(done.all()):
                break
    return carry, iterations


def match_batch(
    initial_poses: Rigid3,  # (B, 4), (B, 3)
    clouds: Sequence[Tuple[torch.Tensor, torch.Tensor]],  # per grid (B, N, 3), (B, N)
    grids: Sequence,
    specs: Sequence,
    *,
    occupied_space_weights: Sequence[float],
    translation_weight: float,
    rotation_weight: float,
    only_optimize_yaw: bool = False,
    max_iterations: int = 12,
    function_tolerance: float = 0.0,
) -> ScanMatcherResult:
    """`match` for B initial poses against shared grids (flat offset 0),
    each with its own clouds; every lane equals its own `match` result."""
    b = initial_poses.rotation.shape[0]
    dev = initial_poses.rotation.device
    ndelta = 4 if only_optimize_yaw else 6
    target_q, target_t = initial_poses.rotation, initial_poses.translation
    rows = sum(c[0].shape[1] for c in clouds) + 6

    def residual_rows(d, q, t):
        """(B, rows) residuals of `_residuals`, row i at the pose moved by
        its own tangent copy d[:, i] (B, rows, ndelta)."""
        rq, rt = _apply_delta_rows(q[:, None], t[:, None], d, only_optimize_yaw)
        parts, o = [], 0
        for (points, mask), values, spec, w in zip(clouds, grids, specs, occupied_space_weights):
            n = points.shape[1]
            world = Rigid3(rq[:, o:o + n], rt[:, o:o + n]).apply(points)
            prob = interpolated_probability(values, world, spec)
            count = torch.clamp(torch.sum(mask.to(torch.float32), -1, keepdim=True), min=1.0)
            parts.append(torch.where(mask, (w / torch.sqrt(count)) * (1.0 - prob), 0.0))
            o += n
        parts.append(translation_weight * (torch.diagonal(rt[:, o:o + 3], dim1=1, dim2=2) - target_t))
        dq = quat_multiply(quat_conjugate(target_q)[:, None], rq[:, o + 3:o + 6])
        dq = torch.where(dq[..., 0:1] < 0.0, -dq, dq)
        parts.append(rotation_weight * torch.diagonal(dq[..., 1:4], dim1=1, dim2=2))
        return torch.cat(parts, dim=1)

    def r_and_jac(pose: Rigid3):
        """Every row reads only its own tangent copy, so one backward pass
        of the rows' sum is the whole (B, rows, ndelta) Jacobian."""
        d = torch.zeros(b, rows, ndelta, dtype=torch.float32, device=dev, requires_grad=True)
        with torch.enable_grad():
            r = residual_rows(d, pose.rotation, pose.translation)
            (jac,) = torch.autograd.grad(r.sum(), d)
        return r.detach(), jac

    r0, jac0 = r_and_jac(initial_poses)
    initial_cost = torch.sum(r0 * r0, dim=-1)
    carry, iterations = _lm_iterate(_initial_carry(initial_poses, r0, jac0, initial_cost), r_and_jac,
                                    only_optimize_yaw, max_iterations, function_tolerance,
                                    host_exit=False)
    return ScanMatcherResult(pose=carry[6], cost=carry[7], initial_cost=initial_cost,
                             iterations=iterations)
