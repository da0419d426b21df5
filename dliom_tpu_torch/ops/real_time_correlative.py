"""Real-time correlative scan matcher, the exhaustive local pre-search
(port of dliom_tpu/ops/real_time_correlative.py; reference
RealTimeCorrelativeScanMatcher3D, real_time_correlative_scan_matcher_3d.cc:
34-117).

Every pose of a static (x, y, z, rx, ry, rz) lattice around the initial
estimate scores the mean cell probability of the transformed cloud, damped
by exp(-(|t| w_t + angle w_r)^2); the best candidate wins, the first of
equals as `jnp.argmax` picks it. The angular step comes from the
configured max range rather than the measured one, and the rotational
lattice is capped at `max_angular_steps` per axis with a warning (the JAX
package's two documented deviations).

The lattice and its damping are made once on the CPU and copied to the
scoring device, so a CPU run and a card run score the same candidates.
Candidates score in chunks of `_PAIRS_PER_CHUNK // N` (4096 at the
presets' 1024 matching points): a chunk's (candidates, N, 3) points and
lookups stay near 0.5 GB, and the argmax does not depend on the chunking.
"""

from __future__ import annotations

import functools
import math
import warnings
from typing import NamedTuple, Tuple

import numpy as np
import torch

from dliom_tpu_torch.mapping import probability as pv
from dliom_tpu_torch.mapping.brick_grid import BrickBank, lookup_value_brick
from dliom_tpu_torch.mapping.grid import GridSpec, cell_index, linear_index
from dliom_tpu_torch.transform.rigid import (
    Rigid3,
    _norm,
    quat_from_axis_angle,
    quat_multiply,
    quat_normalize,
    quat_rotate,
)

_PAIRS_PER_CHUNK = 1 << 22  # (candidate, point) pairs scored at once


class RealTimeMatchResult(NamedTuple):
    pose: Rigid3
    score: torch.Tensor
    index: torch.Tensor  # () int64, the best candidate of the lattice


def _lattice(resolution: float, linear_search_window: float, angular_search_window: float,
             max_scan_range: float, max_angular_steps: int = 4) -> Tuple[np.ndarray, np.ndarray]:
    """Static candidate offsets: translations (C, 3) and angle-axis (C, 3)
    (GenerateExhaustiveSearchTransforms :56-97)."""
    lin = int(round(linear_search_window / resolution))
    safety = 1.0 - 1e-3
    rng = max(max_scan_range, 3.0 * resolution)
    step = safety * math.acos(max(-1.0, 1.0 - resolution**2 / (2.0 * rng**2)))
    ang = int(round(angular_search_window / step)) if step > 0 else 0
    if ang > max_angular_steps:
        warnings.warn(
            f"real-time correlative: angular_search_window requests {ang} "
            f"steps/axis; truncating the lattice to max_angular_steps="
            f"{max_angular_steps} (raise the config knob for a wider sweep)",
            stacklevel=2,
        )
        ang = max_angular_steps
    ts, aas = [], []
    for z in range(-lin, lin + 1):
        for y in range(-lin, lin + 1):
            for x in range(-lin, lin + 1):
                for rz in range(-ang, ang + 1):
                    for ry in range(-ang, ang + 1):
                        for rx in range(-ang, ang + 1):
                            ts.append((x * resolution, y * resolution, z * resolution))
                            aas.append((rx * step, ry * step, rz * step))
    return np.asarray(ts, np.float32), np.asarray(aas, np.float32)


@functools.cache
def _candidates(resolution, linear_search_window, angular_search_window, max_scan_range,
                max_angular_steps, translation_delta_cost_weight, rotation_delta_cost_weight,
                device=torch.device("cpu")):
    """The lattice on `device`: offsets (C, 3), rotations (C, 4) and each
    candidate's damping (C,), made on the CPU and copied once per device
    (a step that reads them copies no host data after its first call).
    Never evicted: a captured CUDA graph reads them at their address on
    every replay."""
    off_t, off_aa = _lattice(resolution, linear_search_window, angular_search_window,
                             max_scan_range, max_angular_steps)
    off_t, off_q = torch.from_numpy(off_t), quat_from_axis_angle(torch.from_numpy(off_aa))
    angle = 2.0 * torch.arcsin(torch.clamp(_norm(off_q[:, 1:4]), 0.0, 1.0))
    damp = torch.exp(-(_norm(off_t) * translation_delta_cost_weight
                       + angle * rotation_delta_cost_weight) ** 2)
    return tuple(x.to(device) for x in (off_t, off_q, damp))


def match(
    initial_pose: Rigid3,
    points: torch.Tensor,
    mask: torch.Tensor,
    values,
    spec,
    *,
    linear_search_window: float = 0.15,
    angular_search_window: float = 0.035,
    translation_delta_cost_weight: float = 1e-1,
    rotation_delta_cost_weight: float = 1e-1,
    max_scan_range: float = 60.0,
    max_angular_steps: int = 4,
    base=0,
) -> RealTimeMatchResult:
    """Exhaustive local search (Match :34-53 + ScoreCandidate :99-117).
    `values`/`base`: a dense flat bank and its slot offset, or a BrickBank
    and its slot, as in the Ceres matcher. For B lanes the pose is (B, ·),
    the cloud (B, N, ·) and `base` a (B,) tensor: each lane scores the
    lattice against its own slot of the shared bank, and the result carries
    the lane axis (the JAX package vmaps the single search)."""
    dev = points.device
    off_t, off_q, damp = _candidates(
        spec.resolution, linear_search_window, angular_search_window, max_scan_range,
        max_angular_steps, translation_delta_cost_weight, rotation_delta_cost_weight, dev)
    if points.dim() == 3:  # lanes: each lane's slot against its (C, N) lookups
        base = torch.as_tensor(base, device=dev).reshape(-1, 1, 1)
    n_valid = torch.clamp(torch.sum(mask.to(torch.float32), dim=-1), min=1.0)[..., None]
    rot = initial_pose.rotation[..., None, :]
    trans = initial_pose.translation[..., None, :]

    def candidates(dt, dq):
        # candidate = initial * offset (:43-45); (…, C, ·)
        return quat_normalize(quat_multiply(rot, dq)), trans + quat_rotate(rot, dt)

    def mean_probability(dt, dq):
        cand_q, cand_t = candidates(dt, dq)
        world = quat_rotate(cand_q[..., :, None, :], points[..., None, :, :]) + cand_t[..., :, None, :]
        cells = cell_index(world, spec.resolution)
        m = mask[..., None, :]
        if isinstance(values, BrickBank):
            v = torch.where(m, lookup_value_brick(values, cells, spec, base), 0)
        else:
            lin, ok = linear_index(cells, spec)
            v = torch.where(ok & m, values[(base + lin).long()].to(torch.int32), 0)
        prob = pv.value_to_probability(v)
        return torch.sum(torch.where(m, prob, 0.0), dim=-1) / n_valid

    # the chunk follows from the shapes alone: no host read, so a CUDA
    # graph captures the batched step's search
    chunk = max(1, _PAIRS_PER_CHUNK // max(1, points[..., 0].numel()))
    scores = torch.cat([mean_probability(off_t[i:i + chunk], off_q[i:i + chunk])
                        for i in range(0, off_t.shape[0], chunk)], dim=-1) * damp
    best = torch.argmax(scores, dim=-1, keepdim=True)
    best_q, best_t = candidates(off_t[best], off_q[best])
    return RealTimeMatchResult(pose=Rigid3(best_q[..., 0, :], best_t[..., 0, :]),
                               score=torch.take_along_dim(scores, best, dim=-1)[..., 0], index=best[..., 0])
