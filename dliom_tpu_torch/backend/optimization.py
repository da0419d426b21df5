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
J^T u (the double-vjp form of a jvp), taken again in each CG step (each
CG step is one compiled program, and nothing but tensors passes between
programs). Blocks with no valid entry are left out: their rows and
Jacobians are exact zeros. The solve runs in the float type of the data:
float32 in the port, float64 for a reference that bounds its rounding.

No forward-mode AD here: the SPA runs on background threads, and
forward-mode AD keeps its level in process-global state.
"""

from __future__ import annotations

import functools
from types import SimpleNamespace
from typing import NamedTuple

import torch
from torch.func import vjp

from dliom_tpu_torch.common import mesh as _mesh
from dliom_tpu_torch.common.mesh import Mesh, shard_over_mesh
from dliom_tpu_torch.ops.segment import SegmentPlan, segment_plan, segment_sum
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


def blocks_of(data: PoseGraphData):
    """(node-node, fixed-frame, landmark): whether each block has a valid
    row, read on the host. `_build_problem` knows them without a read."""
    return tuple(bool(torch.any(v)) for v in (data.nn_valid, data.ff_valid, data.lm_valid))


_C_FIELDS = ("c_submap", "c_node", "c_q", "c_t", "c_trans_weight", "c_rot_weight", "c_valid", "c_is_inter")
_POSES = ("submap_q", "submap_t", "node_q", "node_t")
# what a shard's SPA rows read besides its own rows: the poses, and the flags of what a step may move
_REPLICATED = _POSES + ("submap_valid", "submap_fixed", "node_valid", "node_fixed")
SHARD_FIELDS = _C_FIELDS + _REPLICATED  # `spa_rows`' input, in this order


def shard_constraints(data: PoseGraphData, mesh: Mesh) -> list:
    """The SPA constraint rows split over the mesh's shards: per shard, the
    `c_*` fields of its contiguous piece on its device (a dict), the count
    padded to a multiple of D with invalid rows at the end."""
    c = data.c_valid.shape[0]
    pad = -c % mesh.size
    fields = {f: getattr(data, f) for f in _C_FIELDS}
    if pad:
        fill = make_pose_graph_data(1, 1, pad, 1, 1, 1, 1, device=data.c_valid.device)
        fields = {f: torch.cat([x, getattr(fill, f)]) for f, x in fields.items()}
    names = list(fields)
    return [dict(zip(names, piece)) for piece in shard_over_mesh(tuple(fields.values()), mesh)]


def solve(data: PoseGraphData, *, iterations: int = 10, cg_iterations: int = 64,
          fix_first_submap: bool = True, ff_huber_scale: float = 0.0,
          inter_huber_scale: float = 0.0, blocks=None, mesh: Mesh | None = None) -> PoseGraphData:
    """Gauss-Newton with matrix-free PCG on the normal equations
    (`iterations` outer steps of `cg_iterations` CG steps each, each one
    `gn_step`). `blocks` as `blocks_of` gives them (read from `data` when
    None). `mesh`: the constraint rows split over its shards once
    (`shard_constraints`), each GN step as `gn_step(mesh=)` describes;
    `data` lives on the mesh's first device, as does the result. Eager:
    the pose graph replays the same bodies as compiled programs
    (`backend/pose_graph.py`)."""
    if blocks is None:
        blocks = blocks_of(data)
    shards = None if mesh is None else shard_constraints(data, mesh)
    for _ in range(iterations):
        data = _gn_step(data, cg_iterations=cg_iterations, fix_first_submap=fix_first_submap,
                        ff_huber_scale=ff_huber_scale, inter_huber_scale=inter_huber_scale,
                        blocks=blocks, mesh=mesh, shards=shards)
    return data


def gn_step(d: PoseGraphData, *, cg_iterations: int = 64, fix_first_submap: bool = True,
            ff_huber_scale: float = 0.0, inter_huber_scale: float = 0.0,
            blocks=(True, True, True), mesh: Mesh | None = None) -> PoseGraphData:
    """One Gauss-Newton step of `solve`: the new submap, node and landmark
    poses. It reads nothing on the host; the rows of the blocks `blocks`
    switches off must all be invalid.

    `mesh`: the SPA constraint rows split over its shards (the JAX
    package's sharded constraint arrays, dliom_tpu/backend/optimization.py
    :275-300). Without a mesh the same code runs as one shard on d's
    device. The step is four bodies, which the pose graph compiles one
    program each:
      (a) `spa_rows`, per shard on its device: from the replicated poses,
          the shard's residuals and Jacobian blocks, with its partial
          gradient and partial Jacobi diagonal;
      (b) `spa_jtj`, per shard, per CG step: its partial J^T J p;
      (c) `cg_start` once, then `cg_update` per CG step, on the first
          device: the partial sums, each copied there, added in shard order
          (a mesh that repeats one device adds in the order of distinct
          cards), the node-node, fixed-frame and landmark blocks, and the
          CG's start or one CG step;
      (d) `pose_update`, on the first device.
    Each CG direction goes back out to the shards."""
    shards = None if mesh is None else shard_constraints(d, mesh)
    return _gn_step(d, cg_iterations=cg_iterations, fix_first_submap=fix_first_submap,
                    ff_huber_scale=ff_huber_scale, inter_huber_scale=inter_huber_scale, blocks=blocks,
                    mesh=mesh, shards=shards)


def _gn_step(d: PoseGraphData, *, cg_iterations: int, fix_first_submap: bool, ff_huber_scale: float,
             inter_huber_scale: float, blocks, mesh: Mesh | None, shards) -> PoseGraphData:
    """`gn_step` eagerly, the constraint rows given already split
    (`shards`, with `mesh`) or not (both None)."""
    if mesh is None:  # one shard: every row, on d's device
        mesh, shards = Mesh((d.submap_q.device,)), [{f: getattr(d, f) for f in _C_FIELDS}]
    reps = _mesh.to_each({f: getattr(d, f) for f in _REPLICATED}, mesh)
    out = [spa_rows({**rows, **rep}, fix_first_submap, inter_huber_scale) for rows, rep in zip(shards, reps)]
    kw = dict(ff_huber_scale=ff_huber_scale, blocks=blocks)
    carry = cg_start(d, _mesh.to_first([part for _, part in out], mesh), fix_first_submap=fix_first_submap, **kw)
    for _ in range(cg_iterations):
        directions = _mesh.to_each(carry.p[:2], mesh)
        partials = [spa_jtj(rows, *v) for (rows, _), v in zip(out, directions)]
        carry = cg_update(d, carry, _mesh.to_first(partials, mesh), **kw)
    return pose_update(d, carry)


def _free_masks(d, fix_first_submap: bool):
    """(S, 1) and (N, 1) masks, in d's float type, of the submaps and nodes
    a step may move."""
    free_submap = d.submap_valid & ~d.submap_fixed
    if fix_first_submap:
        free_submap = free_submap & (torch.arange(free_submap.shape[0], device=free_submap.device) != 0)
    dtype = d.submap_q.dtype
    return free_submap[:, None].to(dtype), (d.node_valid & ~d.node_fixed)[:, None].to(dtype)


class SpaRows(NamedTuple):
    """One shard's SPA rows at the current poses: the two Jacobian block
    columns j_s, j_n (C, 6, 6), the rows' submap and node ids, and the
    segment plans of those ids (`ops/segment.py`). Every row touches one
    submap and one node."""

    j_s: torch.Tensor
    j_n: torch.Tensor
    cs: torch.Tensor
    cn: torch.Tensor
    submap_order: torch.Tensor
    submap_lengths: torch.Tensor
    node_order: torch.Tensor
    node_lengths: torch.Tensor

    def _plans(self):
        return (SegmentPlan(self.submap_order, self.submap_lengths, self.submap_lengths.shape[0] - 1),
                SegmentPlan(self.node_order, self.node_lengths, self.node_lengths.shape[0] - 1))

    def jt(self, u):
        """J^T u of the rows for row values u (C, 6): (submap, node) sums."""
        by_submap, by_node = self._plans()
        return (segment_sum(torch.einsum("cij,ci->cj", self.j_s, u), by_submap),
                segment_sum(torch.einsum("cij,ci->cj", self.j_n, u), by_node))

    def jtj(self, v_s, v_n):
        """J^T J v for the submap and node parts of v."""
        return self.jt(torch.einsum("cij,cj->ci", self.j_s, v_s[self.cs])
                       + torch.einsum("cij,cj->ci", self.j_n, v_n[self.cn]))

    def diag(self):
        """The rows' share of diag(J^T J): column sums of squares."""
        by_submap, by_node = self._plans()
        return (segment_sum((self.j_s ** 2).sum(1), by_submap), segment_sum((self.j_n ** 2).sum(1), by_node))


def spa_rows(shard, fix_first_submap: bool, inter_huber_scale: float):
    """Body (a) of `gn_step`, one per shard on its device, from `shard` (a
    mapping of the `SHARD_FIELDS`: the shard's constraint rows, the
    replicated poses and the flags of what the step may move): the shard's
    `SpaRows` and its partial sums (gradient J^T r and Jacobi diagonal,
    each submap then node). With per-constraint tangent copies, row k of
    every Jacobian block is one backward pass of the k-th residuals' sum."""
    d = SimpleNamespace(**shard)
    submap_mask, node_mask = _free_masks(d, fix_first_submap)
    cs, cn = d.c_submap.long(), d.c_node.long()
    by_submap, by_node = segment_plan(cs, d.submap_q.shape[0]), segment_plan(cn, d.node_q.shape[0])
    tangent = dict(dtype=d.submap_q.dtype, device=d.c_valid.device)
    ds_rows = torch.zeros(cs.shape[0], 6, **tangent).requires_grad_()
    dn_rows = torch.zeros(cs.shape[0], 6, **tangent).requires_grad_()
    with torch.enable_grad():
        r_spa = _spa_residuals(d, ds_rows * submap_mask[cs], dn_rows * node_mask[cn], inter_huber_scale)
        grads = [torch.autograd.grad(r_spa[:, k].sum(), (ds_rows, dn_rows), retain_graph=k < 5)
                 for k in range(6)]
    rows = SpaRows(torch.stack([g[0] for g in grads], 1), torch.stack([g[1] for g in grads], 1), cs, cn,
                   by_submap.order, by_submap.lengths, by_node.order, by_node.lengths)
    return rows, rows.jt(r_spa.detach()) + rows.diag()


def spa_jtj(rows: SpaRows, v_s, v_n):
    """Body (b) of `gn_step`, one per shard on its device: the shard's
    partial J^T J v for the direction (v_s, v_n)."""
    return rows.jtj(v_s, v_n)


class CgCarry(NamedTuple):
    """The preconditioned CG between its steps, on the first device: the
    iterate x, the residual r and the direction p (each a (submap (S, 6),
    node (N, 6), extra (3 + 6K,)) triple, the extra part the fixed-frame
    origin and the landmark poses), r.z, the Jacobi preconditioner (a
    triple), and the masks (submap, node, extra) of what the step moves."""

    x: tuple
    r: tuple
    p: tuple
    rz: torch.Tensor
    precond: tuple
    masks: tuple


def _dot(a, b):
    return sum(torch.sum(ai * bi) for ai, bi in zip(a, b))


def _sum_in_order(parts):
    """Per-shard partial sums (tuples) added in shard order."""
    total = tuple(parts[0])
    for part in parts[1:]:
        total = tuple(a + b for a, b in zip(total, part))
    return total


def _extra_linear(d: PoseGraphData, masks, ff_huber_scale: float, blocks):
    """The node-node, fixed-frame and landmark blocks matrix-free at d's
    poses: their residuals r0, u -> J^T u (their vjp) and the vjp of that
    linear map, which applied to v gives J v."""
    _, node_mask, lm_free = masks
    zeros = functools.partial(torch.zeros, dtype=d.submap_q.dtype, device=d.submap_q.device)

    def res_extra(ds, dn, de):
        return _extra_residuals(d, dn * node_mask, de * lm_free, ff_huber_scale, blocks)

    r0, vjp_fn = vjp(res_extra, zeros(d.submap_q.shape[0], 6), zeros(d.node_q.shape[0], 6),
                     zeros(lm_free.shape[0]))
    _, jt_vjp = vjp(vjp_fn, torch.zeros_like(r0))
    return r0, vjp_fn, jt_vjp


def cg_start(d: PoseGraphData, partials, *, fix_first_submap: bool, ff_huber_scale: float,
             blocks) -> CgCarry:
    """Body of `gn_step` on the first device that opens the CG: the shards'
    `spa_rows` partial sums (on d's device) added in shard order, the other
    blocks' gradient, their closed-form shares of the exact Jacobi
    diagonal diag(J^T J) (weights^2), and the CG's start: x = 0, r = -grad,
    p = z = M r."""
    dtype, dev = d.submap_q.dtype, d.submap_q.device
    k_lm = d.lm_positions.shape[0]
    lm_pos3 = d.lm_pos_valid[:, None].expand(-1, 3).reshape(-1)
    lm_free = torch.cat([torch.any(d.ff_valid).expand(3), lm_pos3, lm_pos3]).to(dtype)
    masks = (*_free_masks(d, fix_first_submap), lm_free)
    g_s, g_n, diag_s, diag_n = _sum_in_order(partials)
    zeros = functools.partial(torch.zeros, dtype=dtype, device=dev)
    grad = (g_s, g_n, zeros(3 + 6 * k_lm))
    if any(blocks):
        r0, vjp_fn, _ = _extra_linear(d, masks, ff_huber_scale, blocks)
        grad = tuple(a + b for a, b in zip(grad, vjp_fn(r0)))
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
               torch.ones(3 + 6 * k_lm, dtype=dtype, device=dev))
    r = tuple(-g for g in grad)
    z = tuple(ri * pi for ri, pi in zip(r, precond))
    return CgCarry(x=tuple(torch.zeros_like(g) for g in grad), r=r, p=z, rz=_dot(r, z), precond=precond,
                   masks=masks)


def cg_update(d: PoseGraphData, carry: CgCarry, partials, *, ff_huber_scale: float, blocks) -> CgCarry:
    """Body (c) of `gn_step`, on the first device: one CG step. The shards'
    `spa_jtj` partials (on d's device) added in shard order, the other
    blocks' J^T J p, then the step's x, r, p and r.z."""
    hv = _sum_in_order(partials) + (torch.zeros_like(carry.x[2]),)
    p = carry.p
    if any(blocks):
        _, vjp_fn, jt_vjp = _extra_linear(d, carry.masks, ff_huber_scale, blocks)
        hv = tuple(a + b for a, b in zip(hv, vjp_fn(jt_vjp(tuple(p))[0])))
    hp = tuple(h + 1e-8 * pi for h, pi in zip(hv, p))
    alpha = carry.rz / torch.clamp(_dot(p, hp), min=1e-12)
    x = tuple(xi + alpha * pi for xi, pi in zip(carry.x, p))
    r = tuple(ri - alpha * hi for ri, hi in zip(carry.r, hp))
    z = tuple(ri * pi for ri, pi in zip(r, carry.precond))
    rz = _dot(r, z)
    beta = rz / torch.clamp(carry.rz, min=1e-12)
    return carry._replace(x=x, r=r, p=tuple(zi + beta * pi for zi, pi in zip(z, p)), rz=rz)


def pose_update(d: PoseGraphData, carry: CgCarry) -> PoseGraphData:
    """Body (d) of `gn_step`, on the first device: d's submap, node and
    landmark poses moved by the CG's iterate where the masks let them."""
    submap_mask, node_mask, lm_free = carry.masks
    k_lm = d.lm_positions.shape[0]
    ds = carry.x[0] * submap_mask
    dn = carry.x[1] * node_mask
    de = carry.x[2] * lm_free
    return d._replace(
        submap_q=quat_normalize(quat_multiply(quat_from_axis_angle(ds[:, 3:6]), d.submap_q)),
        submap_t=d.submap_t + ds[:, 0:3],
        node_q=quat_normalize(quat_multiply(quat_from_axis_angle(dn[:, 3:6]), d.node_q)),
        node_t=d.node_t + dn[:, 0:3],
        # landmark poses persist; the fixed-frame origin is re-solved
        lm_positions=d.lm_positions + de[3:3 + 3 * k_lm].reshape(-1, 3),
        lm_q=quat_normalize(quat_multiply(quat_from_axis_angle(de[3 + 3 * k_lm:].reshape(-1, 3)),
                                          d.lm_q)),
    )
