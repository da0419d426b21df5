"""Global pose-graph optimization, sparse pose adjustment (port of
dliom_tpu/backend/optimization.py; reference OptimizationProblem3D::Solve,
optimization_problem_3d.cc:259-360, and spa_cost_function_3d.h).

6-dof relative-pose residuals between submap and node poses (INTRA and
INTER constraints), node-node links, fixed-frame positions and landmark
poses. Preconditioned conjugate gradients with an exact Jacobi diagonal
solve each Gauss-Newton step's normal equations, and the Hessian is never
formed: H v = J^T (J v). Every SPA row touches one submap and one node, so
its Jacobian is two (C, 6, 6) block columns, taken once per GN step in
reverse mode (six backward passes over per-constraint tangent copies);
each CG step is then a few batched products and index-adds. The node-node,
fixed-frame and landmark rows stay matrix-free through `torch.func.vjp`:
J^T u is their residuals' vjp and J v the vjp of that linear map u ->
J^T u (the double-vjp form of a jvp). Blocks with no valid entry are left
out: their rows and Jacobians are exact zeros.

No forward-mode AD here: the SPA runs on background threads, and
forward-mode AD keeps its level in process-global state.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import vjp

from dliom_tpu_torch.ops.segment import segment_plan, segment_sum
from dliom_tpu_torch.transform.rigid import (
    quat_conjugate,
    quat_from_axis_angle,
    quat_inverse_rotate,
    quat_multiply,
    quat_normalize,
)


class PoseGraphData(NamedTuple):
    """Dense fixed-capacity pose-graph state (field meanings as in the JAX
    package's PoseGraphData)."""

    submap_q: torch.Tensor  # (S, 4)
    submap_t: torch.Tensor  # (S, 3)
    submap_valid: torch.Tensor  # (S,)
    node_q: torch.Tensor  # (N, 4)
    node_t: torch.Tensor  # (N, 3)
    node_valid: torch.Tensor  # (N,)
    c_submap: torch.Tensor  # (C,) int32
    c_node: torch.Tensor  # (C,) int32
    c_q: torch.Tensor  # (C, 4) node rotation expected in the submap frame
    c_t: torch.Tensor  # (C, 3)
    c_trans_weight: torch.Tensor  # (C,)
    c_rot_weight: torch.Tensor  # (C,)
    c_valid: torch.Tensor  # (C,)
    c_is_inter: torch.Tensor  # (C,)
    submap_fixed: torch.Tensor  # (S,)
    node_fixed: torch.Tensor  # (N,)
    ff_node: torch.Tensor  # (F,) int32
    ff_t: torch.Tensor  # (F, 3)
    ff_weight: torch.Tensor  # (F,)
    ff_valid: torch.Tensor  # (F,)
    lm_node: torch.Tensor  # (L,) int32
    lm_node2: torch.Tensor  # (L,) int32
    lm_alpha: torch.Tensor  # (L,)
    lm_id: torch.Tensor  # (L,) int32
    lm_rel_q: torch.Tensor  # (L, 4)
    lm_rel_t: torch.Tensor  # (L, 3)
    lm_trans_weight: torch.Tensor  # (L,)
    lm_rot_weight: torch.Tensor  # (L,)
    lm_valid: torch.Tensor  # (L,)
    lm_q: torch.Tensor  # (K, 4)
    lm_positions: torch.Tensor  # (K, 3)
    lm_pos_valid: torch.Tensor  # (K,)
    nn_first: torch.Tensor  # (Q,) int32
    nn_second: torch.Tensor  # (Q,) int32
    nn_q: torch.Tensor  # (Q, 4)
    nn_t: torch.Tensor  # (Q, 3)
    nn_trans_weight: torch.Tensor  # (Q,)
    nn_rot_weight: torch.Tensor  # (Q,)
    nn_valid: torch.Tensor  # (Q,)


def make_pose_graph_data(max_submaps: int, max_nodes: int, max_constraints: int,
                         max_fixed_frame: int = 256, max_landmark_obs: int = 256,
                         max_landmarks: int = 64, max_node_links: int = 1024,
                         device=None) -> PoseGraphData:
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    b = dict(dtype=torch.bool, device=device)

    def quats(n):
        q = torch.zeros(n, 4, **f32)
        q[:, 0] = 1.0
        return q

    S, N, C = max_submaps, max_nodes, max_constraints
    F, L, K, Q = max_fixed_frame, max_landmark_obs, max_landmarks, max_node_links
    return PoseGraphData(
        submap_q=quats(S), submap_t=torch.zeros(S, 3, **f32), submap_valid=torch.zeros(S, **b),
        node_q=quats(N), node_t=torch.zeros(N, 3, **f32), node_valid=torch.zeros(N, **b),
        c_submap=torch.zeros(C, **i32), c_node=torch.zeros(C, **i32), c_q=quats(C),
        c_t=torch.zeros(C, 3, **f32), c_trans_weight=torch.zeros(C, **f32),
        c_rot_weight=torch.zeros(C, **f32), c_valid=torch.zeros(C, **b),
        c_is_inter=torch.zeros(C, **b),
        submap_fixed=torch.zeros(S, **b), node_fixed=torch.zeros(N, **b),
        ff_node=torch.zeros(F, **i32), ff_t=torch.zeros(F, 3, **f32),
        ff_weight=torch.zeros(F, **f32), ff_valid=torch.zeros(F, **b),
        lm_node=torch.zeros(L, **i32), lm_node2=torch.zeros(L, **i32),
        lm_alpha=torch.zeros(L, **f32), lm_id=torch.zeros(L, **i32), lm_rel_q=quats(L),
        lm_rel_t=torch.zeros(L, 3, **f32), lm_trans_weight=torch.zeros(L, **f32),
        lm_rot_weight=torch.zeros(L, **f32), lm_valid=torch.zeros(L, **b),
        lm_q=quats(K), lm_positions=torch.zeros(K, 3, **f32), lm_pos_valid=torch.zeros(K, **b),
        nn_first=torch.zeros(Q, **i32), nn_second=torch.zeros(Q, **i32), nn_q=quats(Q),
        nn_t=torch.zeros(Q, 3, **f32), nn_trans_weight=torch.zeros(Q, **f32),
        nn_rot_weight=torch.zeros(Q, **f32), nn_valid=torch.zeros(Q, **b),
    )


def _relative_pose_error(iq, it, jq, jt, zq, zt, tw, rw):
    """SpaCostFunction3D residual: h = T_i^-1 * T_j against measurement z."""
    h_q = quat_multiply(quat_conjugate(iq), jq)
    h_t = quat_inverse_rotate(iq, jt - it)
    e_t = (h_t - zt) * tw[:, None]
    dq = quat_multiply(quat_conjugate(zq), h_q)
    dq = torch.where(dq[:, 0:1] < 0, -dq, dq)
    e_r = 2.0 * dq[:, 1:4] * rw[:, None]
    return torch.cat([e_t, e_r], dim=-1)


def _huber_weight(r: torch.Tensor, scale: float) -> torch.Tensor:
    """sqrt(rho'(|r|^2)) of a Huber loss per residual block, on the current
    residual (held constant: the IRLS reweighting)."""
    s = torch.sum(r * r, dim=-1).detach()
    return torch.where(s <= scale * scale, 1.0,
                       torch.sqrt(scale / torch.sqrt(torch.clamp(s, min=1e-12))))


def _perturb(q, t, delta):
    """Poses moved by delta [dt (3), dtheta (3)], left-multiplicative rotation."""
    return quat_normalize(quat_multiply(quat_from_axis_angle(delta[..., 3:6]), q)), t + delta[..., 0:3]


def _spa_residuals(data: PoseGraphData, ds_rows, dn_rows, inter_huber_scale: float = 0.0) -> torch.Tensor:
    """(C, 6) weighted SPA residuals, constraint c at its submap moved by
    ds_rows[c] and its node by dn_rows[c]."""
    cs, cn = data.c_submap.long(), data.c_node.long()
    sq, st = _perturb(data.submap_q[cs], data.submap_t[cs], ds_rows)
    nq, nt = _perturb(data.node_q[cn], data.node_t[cn], dn_rows)
    r = _relative_pose_error(sq, st, nq, nt, data.c_q, data.c_t, data.c_trans_weight, data.c_rot_weight)
    r = torch.where(data.c_valid[:, None], r, 0.0)
    if inter_huber_scale > 0.0:
        r = torch.where(data.c_is_inter[:, None], r * _huber_weight(r, inter_huber_scale)[:, None], r)
    return r


def _extra_residuals(data: PoseGraphData, d_node, d_extra, ff_huber_scale: float = 0.0,
                     blocks=(True, True, True)) -> torch.Tensor:
    """Weighted residuals of the node-node, fixed-frame and landmark blocks
    (those `blocks` switches on) at perturbed poses. `d_extra` holds
    [fixed-frame origin dt (3); landmark dt (K, 3); landmark dtheta (K, 3)]."""
    nq, nt = _perturb(data.node_q, data.node_t, d_node)
    use_nn, use_ff, use_lm = blocks
    out = []
    if use_nn:
        out.append(_node_link_residuals(data, nq, nt))
    if use_ff:
        r_ff = (nt[data.ff_node.long()] - (data.ff_t + d_extra[0:3])) * data.ff_weight[:, None]
        r_ff = torch.where(data.ff_valid[:, None], r_ff, 0.0)
        if ff_huber_scale > 0.0:
            r_ff = r_ff * _huber_weight(r_ff, ff_huber_scale)[:, None]
        out.append(r_ff.reshape(-1))
    if use_lm:
        out.append(_landmark_residuals(data, nq, nt, d_extra))
    return torch.cat(out)


def _node_link_residuals(data: PoseGraphData, nq, nt) -> torch.Tensor:
    f, s2 = data.nn_first.long(), data.nn_second.long()
    r_nn = _relative_pose_error(nq[f], nt[f], nq[s2], nt[s2], data.nn_q, data.nn_t,
                                data.nn_trans_weight, data.nn_rot_weight)
    return torch.where(data.nn_valid[:, None], r_nn, 0.0).reshape(-1)


def _landmark_residuals(data: PoseGraphData, nq, nt, d_extra) -> torch.Tensor:
    k = data.lm_positions.shape[0]
    lm_t = data.lm_positions + d_extra[3:3 + 3 * k].reshape(-1, 3)
    lm_q = quat_normalize(quat_multiply(quat_from_axis_angle(d_extra[3 + 3 * k:].reshape(-1, 3)),
                                        data.lm_q))
    a_ = data.lm_alpha[:, None]
    n1, n2 = data.lm_node.long(), data.lm_node2.long()
    q1, q2 = nq[n1], nq[n2]
    q2 = torch.where(torch.sum(q1 * q2, -1, keepdim=True) < 0, -q2, q2)
    iq = quat_normalize(q1 * (1.0 - a_) + q2 * a_)
    it = nt[n1] * (1.0 - a_) + nt[n2] * a_
    lid = data.lm_id.long()
    r_lm = _relative_pose_error(iq, it, lm_q[lid], lm_t[lid], data.lm_rel_q, data.lm_rel_t,
                                data.lm_trans_weight, data.lm_rot_weight)
    return torch.where(data.lm_valid[:, None], r_lm, 0.0).reshape(-1)


def _diag_add_(diag: torch.Tensor, index: torch.Tensor, cols: slice, values: torch.Tensor) -> None:
    """diag[index, cols] += values[:, None] in place, duplicates summed."""
    diag[:, cols] += segment_sum(values, index, diag.shape[0])[:, None]


def solve(data: PoseGraphData, *, iterations: int = 10, cg_iterations: int = 64,
          fix_first_submap: bool = True, ff_huber_scale: float = 0.0,
          inter_huber_scale: float = 0.0) -> PoseGraphData:
    """Gauss-Newton with matrix-free PCG on the normal equations
    (`iterations` outer steps of `cg_iterations` CG steps each)."""
    s = data.submap_q.shape[0]
    n = data.node_q.shape[0]
    dev = data.submap_q.device
    free_submap = data.submap_valid & ~data.submap_fixed
    if fix_first_submap:
        free_submap = free_submap & (torch.arange(s, device=dev) != 0)
    submap_mask = free_submap[:, None].to(torch.float32)
    node_mask = (data.node_valid & ~data.node_fixed)[:, None].to(torch.float32)
    k_lm = data.lm_positions.shape[0]
    extra_dim = 3 + 6 * k_lm
    has_ff = torch.any(data.ff_valid)
    lm_free = torch.cat([has_ff.repeat(3), data.lm_pos_valid.repeat_interleave(3),
                         data.lm_pos_valid.repeat_interleave(3)]).to(torch.float32)
    zeros = lambda *shape: torch.zeros(*shape, dtype=torch.float32, device=dev)  # noqa: E731

    def dot(a, b):
        return sum(torch.sum(ai * bi) for ai, bi in zip(a, b))

    blocks = tuple(bool(torch.any(v)) for v in (data.nn_valid, data.ff_valid, data.lm_valid))
    num_c = data.c_valid.shape[0]
    cs, cn = data.c_submap.long(), data.c_node.long()
    by_submap, by_node = segment_plan(cs, s), segment_plan(cn, n)
    d = data
    for _ in range(iterations):
        # SPA rows: each touches one submap and one node, so J is two (C,
        # 6, 6) block columns. With per-constraint tangent copies, row k of
        # every block is one backward pass of the k-th residuals' sum.
        ds_rows = zeros(num_c, 6).requires_grad_()
        dn_rows = zeros(num_c, 6).requires_grad_()
        with torch.enable_grad():
            r_spa = _spa_residuals(d, ds_rows * submap_mask[cs], dn_rows * node_mask[cn],
                                   inter_huber_scale)
            rows = [torch.autograd.grad(r_spa[:, k].sum(), (ds_rows, dn_rows), retain_graph=k < 5)
                    for k in range(6)]
        r_spa = r_spa.detach()
        j_s = torch.stack([g[0] for g in rows], 1)
        j_n = torch.stack([g[1] for g in rows], 1)

        def spa_jt(u):
            """J^T u of the SPA rows for row values u (C, 6)."""
            return (segment_sum(torch.einsum("cij,ci->cj", j_s, u), by_submap),
                    segment_sum(torch.einsum("cij,ci->cj", j_n, u), by_node),
                    zeros(extra_dim))

        def hv(v):
            u = torch.einsum("cij,cj->ci", j_s, v[0][cs]) + torch.einsum("cij,cj->ci", j_n, v[1][cn])
            return spa_jt(u)

        grad = spa_jt(r_spa)
        if any(blocks):
            # the other blocks matrix-free: J^T u is the vjp of their
            # residuals, and u -> J^T u is linear, so its vjp applied to v
            # is J v
            def res_extra(ds, dn, de, d=d):
                return _extra_residuals(d, dn * node_mask, de * lm_free, ff_huber_scale, blocks)

            r0, vjp_fn = vjp(res_extra, zeros(s, 6), zeros(n, 6), zeros(extra_dim))
            _, jt_vjp = vjp(vjp_fn, torch.zeros_like(r0))
            grad = tuple(a + b for a, b in zip(grad, vjp_fn(r0)))
            hv_spa = hv

            def hv(v, hv_spa=hv_spa, vjp_fn=vjp_fn, jt_vjp=jt_vjp):
                return tuple(a + b for a, b in zip(hv_spa(v), vjp_fn(jt_vjp(tuple(v))[0])))

        # Exact Jacobi preconditioner diag(J^T J): the SPA blocks' column
        # sums of squares; the node-node, fixed-frame and landmark rows add
        # closed-form weights^2.
        diag_s = segment_sum((j_s ** 2).sum(1), by_submap)
        diag_n = segment_sum((j_n ** 2).sum(1), by_node)
        tw2 = torch.where(d.nn_valid, d.nn_trans_weight ** 2, 0.0)
        rw2 = torch.where(d.nn_valid, d.nn_rot_weight ** 2, 0.0)
        for idx in (d.nn_first, d.nn_second):
            _diag_add_(diag_n, idx, slice(0, 3), tw2)
            _diag_add_(diag_n, idx, slice(3, 6), rw2)
        _diag_add_(diag_n, d.ff_node, slice(0, 3), torch.where(d.ff_valid, d.ff_weight ** 2, 0.0))
        a_lm = d.lm_alpha
        ltw2 = torch.where(d.lm_valid, d.lm_trans_weight ** 2, 0.0)
        lrw2 = torch.where(d.lm_valid, d.lm_rot_weight ** 2, 0.0)
        _diag_add_(diag_n, d.lm_node, slice(0, 3), ltw2 * (1.0 - a_lm) ** 2)
        _diag_add_(diag_n, d.lm_node2, slice(0, 3), ltw2 * a_lm ** 2)
        _diag_add_(diag_n, d.lm_node, slice(3, 6), lrw2 * (1.0 - a_lm) ** 2)
        _diag_add_(diag_n, d.lm_node2, slice(3, 6), lrw2 * a_lm ** 2)
        precond = (1.0 / torch.clamp(diag_s, min=1e-6), 1.0 / torch.clamp(diag_n, min=1e-6),
                   torch.ones(extra_dim, dtype=torch.float32, device=dev))

        x = (zeros(s, 6), zeros(n, 6), zeros(extra_dim))
        r = tuple(-g for g in grad)
        z = tuple(ri * pi for ri, pi in zip(r, precond))
        p = z
        rz = dot(r, z)
        for _ in range(cg_iterations):
            hp = tuple(h + 1e-8 * pi for h, pi in zip(hv(p), p))
            alpha = rz / torch.clamp(dot(p, hp), min=1e-12)
            x = tuple(xi + alpha * pi for xi, pi in zip(x, p))
            r = tuple(ri - alpha * hi for ri, hi in zip(r, hp))
            z = tuple(ri * pi for ri, pi in zip(r, precond))
            rz_new = dot(r, z)
            beta = rz_new / torch.clamp(rz, min=1e-12)
            p = tuple(zi + beta * pi for zi, pi in zip(z, p))
            rz = rz_new
        ds = x[0] * submap_mask
        dn = x[1] * node_mask
        de = x[2] * lm_free
        d = d._replace(
            submap_q=quat_normalize(quat_multiply(quat_from_axis_angle(ds[:, 3:6]), d.submap_q)),
            submap_t=d.submap_t + ds[:, 0:3],
            node_q=quat_normalize(quat_multiply(quat_from_axis_angle(dn[:, 3:6]), d.node_q)),
            node_t=d.node_t + dn[:, 0:3],
            # landmark poses persist; the fixed-frame origin is re-solved
            lm_positions=d.lm_positions + de[3:3 + 3 * k_lm].reshape(-1, 3),
            lm_q=quat_normalize(quat_multiply(quat_from_axis_angle(de[3 + 3 * k_lm:].reshape(-1, 3)),
                                              d.lm_q)),
        )
    return d
