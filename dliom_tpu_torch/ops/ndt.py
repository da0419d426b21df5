"""Normal Distributions Transform scan-to-scan matching (port of
dliom_tpu/ops/ndt.py; reference MatchByNDT, local_trajectory_builder_3d.cc:
969-1008, which uses PCL's NDT).

`build_field` voxelizes the target scan into per-voxel Gaussians: one
stable sort of the voxel keys, segment sums (`ops/segment.py`: a fixed
order of addition, so the card gives the same bits on every run), and a dense
voxel -> slot table so the per-point lookup is a gather. `match` runs a
fixed 20-iteration trust-region LM of the point-to-distribution residuals
with masked accepts and no host read. Its Jacobian is `torch.func.jacfwd`
(forward mode, as the JAX package's `jax.linearize`): the initializer runs
on the ingest thread, the one thread that may use forward-mode AD.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd

from dliom_tpu_torch.mapping.grid import GridSpec, cell_index, linear_index
from dliom_tpu_torch.ops.segment import segment_plan, segment_sum
from dliom_tpu_torch.transform.rigid import Rigid3, _norm, quat_from_axis_angle, quat_multiply, quat_normalize


class NdtField(NamedTuple):
    """Per-voxel Gaussians and the dense slot table."""

    means: torch.Tensor  # (K, 3)
    sqrt_inv_cov: torch.Tensor  # (K, 3, 3) whitening transforms
    valid: torch.Tensor  # (K,)
    slot_table: torch.Tensor  # (num_cells,) int32 -> slot, or K


def _whitening(cov: torch.Tensor) -> torch.Tensor:
    """(K, 3, 3) covariances -> L^-1 with cov = L L^T. A covariance whose
    Cholesky factorization fails (the JAX package's NaN factor) gets a zero
    whitening, so its voxel adds no residual and never stops the match."""
    chol, info = torch.linalg.cholesky_ex(cov)
    eye = torch.eye(3, dtype=cov.dtype, device=cov.device).expand(cov.shape)
    inv_l = torch.linalg.solve_triangular(chol, eye, upper=False)
    return torch.where((info == 0)[:, None, None] & torch.isfinite(inv_l), inv_l, 0.0)


def build_field(points: torch.Tensor, mask: torch.Tensor, spec: GridSpec, max_voxels: int = 4096,
                min_points: int = 4) -> NdtField:
    cells = cell_index(points, spec.resolution)
    lin, ok = linear_index(cells, spec)
    key = torch.where(mask & ok, lin, spec.num_cells)
    s_key, order = torch.sort(key, stable=True)
    s_pts = points[order]
    inside = s_key < spec.num_cells
    first = torch.ones_like(inside)
    first[1:] = s_key[1:] != s_key[:-1]
    first &= inside
    # slot per sorted element: the rank of its voxel's head
    slot_of_elem = torch.cumsum(first, 0, dtype=torch.int32) - 1
    slot_of_elem = torch.clamp(torch.where(inside, slot_of_elem, max_voxels), max=max_voxels)
    seg = segment_plan(slot_of_elem, max_voxels + 1)

    w = inside.to(torch.float32)
    counts = segment_sum(w, seg)[:max_voxels]
    # moments about each point's cell center: absolute f32 coordinates would
    # cancel catastrophically in E[pp^T] - mu mu^T far from the origin
    s_centers = cells[order].to(torch.float32) * spec.resolution
    s_rel = s_pts - s_centers
    sums = segment_sum(s_rel * w[:, None], seg)[:max_voxels]
    center_sums = segment_sum(s_centers * w[:, None], seg)[:max_voxels]
    sq = segment_sum(s_rel[:, :, None] * s_rel[:, None, :] * w[:, None, None], seg)[:max_voxels]

    n = torch.clamp(counts, min=1.0)
    rel_means = sums / n[:, None]
    means = rel_means + center_sums / n[:, None]
    cov = sq / n[:, None, None] - rel_means[:, :, None] * rel_means[:, None, :]
    # NDT regularization: floor the eigenvalues at a fraction of the voxel
    cov = cov + (0.05 * spec.resolution) ** 2 * torch.eye(3, dtype=cov.dtype, device=cov.device)

    table = torch.full((spec.num_cells + 1,), max_voxels, dtype=torch.int32, device=points.device)
    table[torch.where(first, s_key, spec.num_cells)] = torch.where(first, slot_of_elem, max_voxels)
    return NdtField(means=means, sqrt_inv_cov=_whitening(cov), valid=counts >= min_points,
                    slot_table=table[: spec.num_cells])


def _apply_delta(pose: Rigid3, d: torch.Tensor) -> Rigid3:
    return Rigid3(quat_normalize(quat_multiply(quat_from_axis_angle(d[3:6]), pose.rotation)),
                  pose.translation + d[0:3])


def match(field: NdtField, spec: GridSpec, points: torch.Tensor, mask: torch.Tensor, initial: Rigid3,
          *, max_iterations: int = 20, huber_delta: float = 1.0) -> Rigid3:
    """Point-to-distribution LM (trust region, Huber-weighted); returns
    the best accepted pose."""
    k = field.means.shape[0]
    dev = points.device

    def residuals(pose: Rigid3) -> torch.Tensor:
        world = pose.apply(points)
        lin, ok = linear_index(cell_index(world, spec.resolution), spec)
        slot = field.slot_table[torch.clamp(lin, 0, spec.num_cells - 1)]
        has = ok & mask & (slot < k) & field.valid[torch.clamp(slot, 0, k - 1)]
        slot = torch.clamp(slot, 0, k - 1)
        d = world - field.means[slot]
        r = torch.sum(field.sqrt_inv_cov[slot] * d[:, None, :], dim=-1)
        nrm = _norm(r)
        scale = torch.where(nrm > huber_delta, torch.sqrt(huber_delta / torch.clamp(nrm, min=1e-9)), 1.0)
        r = r * scale[:, None]
        n_valid = torch.clamp(torch.sum(has.to(torch.float32)), min=1.0)
        return torch.where(has[:, None], r, 0.0).reshape(-1) / torch.sqrt(n_valid)

    zero = torch.zeros(6, dtype=torch.float32, device=dev)
    eye = torch.eye(6, dtype=torch.float32, device=dev)
    pose = best = initial
    best_cost = torch.sum(residuals(initial) ** 2)
    radius = torch.full((), 100.0, dtype=torch.float32, device=dev)
    for _ in range(max_iterations):
        jac, r = jacfwd(lambda d: (residuals(_apply_delta(pose, d)),) * 2, has_aux=True)(zero)
        cost = torch.sum(r * r)
        grad = jac.T @ r
        hess = jac.T @ jac
        d2 = torch.clamp(torch.diagonal(hess), min=1e-12)
        # a singular system gives a NaN step, whose cost is never accepted
        step = -torch.linalg.solve_ex(hess + (1.0 / radius) * d2 * eye, grad[:, None],
                                      check_errors=False).result[:, 0]
        cand = _apply_delta(pose, step)
        new_cost = torch.sum(residuals(cand) ** 2)
        accept = new_cost < cost
        pose = Rigid3(torch.where(accept, cand.rotation, pose.rotation),
                      torch.where(accept, cand.translation, pose.translation))
        radius = torch.clamp(torch.where(accept, radius * 2.0, radius * 0.25), 1e-3, 1e5)
        is_best = accept & (new_cost < best_cost)
        best = Rigid3(torch.where(is_best, cand.rotation, best.rotation),
                      torch.where(is_best, cand.translation, best.translation))
        best_cost = torch.where(is_best, new_cost, best_cost)
    return best
