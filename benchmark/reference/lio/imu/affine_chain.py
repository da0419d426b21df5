"""K2's plain version, the IMU error-state affine chain (a frozen copy of
dliom_tpu_torch/imu/affine_chain.py::affine_chain_plain): the reference runs
it on every device, never the CUDA kernel."""

from __future__ import annotations

import torch


def affine_chain_plain(f: torch.Tensor, q: torch.Tensor):
    """Sequential recurrence in plain PyTorch; (..., M, 15, 15) -> (A, P)."""
    n = f.shape[-1]
    a = torch.eye(n, dtype=f.dtype, device=f.device).expand(f.shape[:-3] + (n, n))
    p = torch.zeros_like(a)
    for i in range(f.shape[-3]):
        fi = f[..., i, :, :]
        p = fi @ p @ fi.transpose(-1, -2) + q[..., i, :, :]
        a = fi @ a
    return a, p


def affine_chain(f: torch.Tensor, q: torch.Tensor):
    """(A, P) of the chain over (M, 15, 15) or (B, M, 15, 15) inputs, plain."""
    return affine_chain_plain(f, q)
