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
cost, best-pose tracking) runs as a Python loop; with function_tolerance >
0 it reads `converged` on the host after each iteration and stops, so the
returned `iterations` equals the JAX while-loop's.
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
    parts = []
    for (points, mask), values, spec, w, base in zip(clouds, grids, specs, weights, bases):
        n = torch.clamp(torch.sum(mask.to(torch.float32)), min=1.0)
        world = pose.apply(points)
        if isinstance(values, BrickBank):
            prob = interpolated_probability_brick(values, world, spec, base)
        else:
            prob = interpolated_probability(values, world, spec, base)
        r = (w / torch.sqrt(n)) * (1.0 - prob)
        parts.append(torch.where(mask, r, 0.0))
    parts.append(translation_weight * (pose.translation - target_translation))
    dq = quat_multiply(quat_conjugate(target_rotation), pose.rotation)
    dq = torch.where(dq[0] < 0.0, -dq, dq)
    parts.append(rotation_weight * dq[1:4])
    return torch.cat(parts)


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
    bank slot (brick grids) or flat offset (dense grids)."""
    if target_translation is None:
        target_translation = initial_pose.translation
    if grid_bases is None:
        grid_bases = [0] * len(grids)
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
        """Residual and (M, ndelta) Jacobian from one forward-mode pass."""
        jac, r = jacfwd(lambda d: (residual_at(d, pose),) * 2, has_aux=True)(zero)
        return r, jac

    def lm_step(carry):
        pose, r, jac, cost, radius, ref_cost, best_pose, best_cost = carry
        grad = jac.T @ r
        hess = jac.T @ jac
        d2 = torch.clamp(torch.diagonal(hess), 1e-12, 1e32)
        chol = torch.linalg.cholesky_ex(hess + (1.0 / radius) * torch.diag(d2), check_errors=False).L
        step = -torch.cholesky_solve(grad[:, None], chol)[:, 0]
        cand = _apply_delta(pose, step, only_optimize_yaw)
        cand_r, cand_jac = r_and_jac(cand)
        new_cost = torch.sum(cand_r * cand_r)
        model_reduction = -(2.0 * step @ grad + step @ (hess @ step))
        rho = (ref_cost - new_cost) / torch.clamp(model_reduction, min=1e-12)
        accept = rho > 1e-3

        def sel(a, b):
            return torch.where(accept, a, b)

        pose = Rigid3(sel(cand.rotation, pose.rotation), sel(cand.translation, pose.translation))
        r = sel(cand_r, r)
        jac = sel(cand_jac, jac)
        # FunctionToleranceReached, checked for every evaluated candidate
        converged = torch.abs(cost - new_cost) <= function_tolerance * cost
        cost = sel(new_cost, cost)
        shrink = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
        radius = torch.where(accept, torch.clamp(radius / shrink, max=1e6),
                             torch.clamp(radius * 0.25, min=1e-6))
        is_best = accept & (new_cost < best_cost)
        best_pose = Rigid3(torch.where(is_best, cand.rotation, best_pose.rotation),
                           torch.where(is_best, cand.translation, best_pose.translation))
        best_cost = torch.where(is_best, new_cost, best_cost)
        ref_cost = torch.where(accept, 0.5 * ref_cost + 0.5 * new_cost, ref_cost)
        return (pose, r, jac, cost, radius, ref_cost, best_pose, best_cost), converged

    r0, jac0 = r_and_jac(initial_pose)
    initial_cost = torch.sum(r0 * r0)
    carry = (initial_pose, r0, jac0, initial_cost,
             torch.tensor(1e4, dtype=torch.float32, device=dev),
             initial_cost, initial_pose, initial_cost)
    iterations = 0
    for _ in range(max_iterations):
        carry, converged = lm_step(carry)
        iterations += 1
        if function_tolerance > 0.0 and bool(converged):
            break
    return ScanMatcherResult(
        pose=carry[6], cost=carry[7], initial_cost=initial_cost,
        iterations=torch.tensor(iterations, dtype=torch.int32, device=dev),
    )
