"""Submap-image loop-closure proposals (port of
dliom_tpu/backend/submap_projection.py; reference Submap3D::ProjectToCvMat,
submap_3d.cc:381-463, and ExtractFeaturesForSubmap,
constraint_builder_3d.cc:436-532).

Each finished submap projects to a top-down image (max probability over z,
downsampled); a pair of images is aligned by normalized FFT
cross-correlation over candidate yaws (`torch.fft`), and the best (yaw,
shift) seeds the correlative matcher that verifies it."""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from dliom_tpu_torch.common.device import constant
from dliom_tpu_torch.mapping import probability as pv
from dliom_tpu_torch.mapping.grid import GridSpec
from dliom_tpu_torch.transform.rigid import Rigid3, np_compose, np_rigid


class SubmapImage(NamedTuple):
    image: torch.Tensor  # (S, S) float32 in [0, 1]
    meters_per_pixel: float


def _factor(spec: GridSpec, out_size: int) -> int:
    return max(1, spec.extent // out_size)


def meters_per_pixel(spec: GridSpec, out_size: int = 128) -> float:
    """The pixel size of `project_to_image`'s image."""
    return spec.resolution * _factor(spec, out_size)


def keep_fft_plans(device: torch.device) -> None:
    """Keep every cuFFT plan of `device` for the life of the process: a CUDA
    graph that captured an FFT reads its plan's memory at every replay, and
    PyTorch's plan cache would evict the plan once it held `max_size` plans.
    The port makes a handful."""
    cache = torch.backends.cuda.cufft_plan_cache[torch.device(device).index or 0]
    cache.max_size = max(cache.max_size, 2**31 - 1)


def project_to_image(values: torch.Tensor, spec: GridSpec, out_size: int = 128) -> SubmapImage:
    """Top-down projection: max probability over z, max-downsampled."""
    e = spec.extent
    g = pv.value_to_probability(values.reshape(e, e, e).to(torch.int32))
    img = torch.amax(g, dim=2)
    img = (img - pv.MIN_PROBABILITY) / (pv.MAX_PROBABILITY - pv.MIN_PROBABILITY)
    factor = _factor(spec, out_size)
    if factor > 1:
        s = (e // factor) * factor
        img = img[:s, :s].reshape(s // factor, factor, s // factor, factor).amax(dim=(1, 3))
    return SubmapImage(image=img.to(torch.float32), meters_per_pixel=meters_per_pixel(spec, out_size))


def _rotate_image(img: torch.Tensor, yaw: torch.Tensor) -> torch.Tensor:
    """Rotate about the image center by each of `yaw` (A,) (bilinear
    gather); returns (A, S, S)."""
    s = img.shape[0]
    c = (s - 1) / 2.0
    ar = torch.arange(s, device=img.device)
    ys, xs = torch.meshgrid(ar, ar, indexing="ij")
    dx = (xs - c)[None]
    dy = (ys - c)[None]
    cos, sin = torch.cos(yaw)[:, None, None], torch.sin(yaw)[:, None, None]
    # inverse mapping: source coordinates of each destination pixel
    sx = cos * dx + sin * dy + c
    sy = -sin * dx + cos * dy + c
    x0 = torch.clamp(torch.floor(sx).to(torch.int64), 0, s - 2)
    y0 = torch.clamp(torch.floor(sy).to(torch.int64), 0, s - 2)
    fx = torch.clamp(sx - x0, 0.0, 1.0)
    fy = torch.clamp(sy - y0, 0.0, 1.0)
    inside = (sx >= 0) & (sx <= s - 1) & (sy >= 0) & (sy <= s - 1)
    v = (img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x0 + 1] * fx * (1 - fy)
         + img[y0 + 1, x0] * (1 - fx) * fy + img[y0 + 1, x0 + 1] * fx * fy)
    return torch.where(inside, v, 0.0)


class Proposal(NamedTuple):
    yaw: torch.Tensor  # relative yaw (rotates `other` into `anchor`)
    shift_xy: torch.Tensor  # (2,) meters: translation of other's center
    score: torch.Tensor  # normalized correlation


def propose_2d_transform(anchor: SubmapImage, other: SubmapImage, num_yaw: int = 24,
                         yaw_window: float = math.pi) -> Proposal:
    """Best (yaw, shift) aligning `other` onto `anchor` by FFT
    cross-correlation over `num_yaw` candidate yaws (all in one batch)."""
    a = anchor.image - torch.mean(anchor.image)
    fa = torch.fft.rfft2(a)
    s = a.shape[0]
    dev = a.device
    # jnp.linspace(-w, w, n, endpoint=False) in float32
    yaws = (-yaw_window + torch.arange(num_yaw, dtype=torch.float32, device=dev)
            * constant(2.0 * yaw_window / num_yaw, torch.float32, dev))
    # image (row, col) = grid (x, y): a +yaw frame rotation is -yaw in pixels
    b = _rotate_image(other.image, -yaws)
    b = b - torch.mean(b, dim=(1, 2), keepdim=True)
    fb = torch.fft.rfft2(b)
    xc = torch.fft.irfft2(fa[None] * torch.conj(fb), s=(s, s))
    denom = torch.clamp(torch.sqrt(torch.sum(a * a)) * torch.sqrt(torch.sum(b * b, dim=(1, 2))),
                        min=1e-6)
    xc = xc / denom[:, None, None]
    scores, idxs = torch.max(xc.reshape(num_yaw, -1), dim=1)
    best = torch.argmax(scores).reshape(1)  # (1,): a 0-dim index is read on the host
    idx = idxs[best][0]
    dy = torch.div(idx, s, rounding_mode="floor")
    dx = idx - dy * s
    dy = torch.where(dy > s // 2, dy - s, dy)
    dx = torch.where(dx > s // 2, dx - s, dx)
    shift = torch.stack([dy, dx]).to(torch.float32) * anchor.meters_per_pixel
    return Proposal(yaw=yaws[best][0], shift_xy=shift, score=scores[best][0])


def proposal_to_initial_guess(proposal: Proposal, node_pose_in_other: Rigid3) -> Rigid3:
    """The node-in-anchor initial guess from a proposal (ComputeConstraint,
    constraint_builder_3d.cc:240-259), float64 numpy on the host; the
    proposal's fields are host values."""
    yaw = float(proposal.yaw)
    t2d = Rigid3(
        rotation=np.array([np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)], np.float64),
        translation=np.array([float(proposal.shift_xy[0]), float(proposal.shift_xy[1]), 0.0],
                             np.float64),
    )
    return np_compose(t2d, np_rigid(node_pose_in_other))
