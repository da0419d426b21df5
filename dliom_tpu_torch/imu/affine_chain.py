"""K2: the IMU error-state affine chain, CUDA kernel and plain version.

Port of the TPU Pallas kernel dliom_tpu/imu/preintegration.py::
_pallas_affine_chain: from A = I and P = 0, for i = 1..M in order,
A <- F_i A and P <- F_i P F_i^T + Q_i over (M, 15, 15) float32 inputs
(masked samples arrive as (I, 0)). The kernel, csrc/affine_chain.cu, is a
scan over time: warps compose contiguous chunks of samples, then the chunk
results combine in a tree. That sums in another order than the sequential
plain version, so the two agree to rtol 1e-5 / atol 1e-6, not bit for bit.
"""

from __future__ import annotations

import torch

from dliom_tpu_torch import kernels
from dliom_tpu_torch.common import launches

# Kernel launches through `affine_chain` (plain-version calls not counted).
LAUNCHES = 0


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
    """(A, P) of the chain over (M, 15, 15) or (B, M, 15, 15) inputs. CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    if f.device.type == "cpu":
        return affine_chain_plain(f, q)
    if f.device.type != "cuda":
        raise ValueError(f"affine_chain: unsupported device {f.device}")
    if f.shape != q.shape or f.dim() not in (3, 4) or f.shape[-2:] != (15, 15):
        raise ValueError(f"affine_chain: bad shapes {tuple(f.shape)} / {tuple(q.shape)}")
    if f.dtype != torch.float32 or q.dtype != torch.float32 or q.device != f.device:
        raise ValueError("affine_chain: F and Q must be float32 on one device")
    batched = f.dim() == 4
    fb = (f if batched else f[None]).contiguous()
    qb = (q if batched else q[None]).contiguous()
    a = torch.empty(fb.shape[0], 15, 15, dtype=torch.float32, device=f.device)
    p = torch.empty_like(a)
    lib = kernels.library()
    with torch.cuda.device(f.device):  # the launch goes to the inputs' card
        stream = torch.cuda.current_stream(f.device).cuda_stream
        err = lib.dliom_affine_chain(
            fb.data_ptr(), qb.data_ptr(), a.data_ptr(), p.data_ptr(),
            fb.shape[0], fb.shape[1], stream,
        )
    kernels.check(err, "affine_chain")
    launches.count(__name__, "LAUNCHES")
    return (a, p) if batched else (a[0], p[0])
