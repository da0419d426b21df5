"""dliom_tpu_torch — the PyTorch/CUDA port of `dliom_tpu`.

The port runs the per-scan tightly-coupled LIO step
(`frontend/lio.py::lio_step`) on PyTorch tensors. Module paths and names
follow `dliom_tpu` so each port module sits beside its reference; the JAX
package stays the oracle the parity tests hold this one against.

The two TPU Pallas kernels of that step are CUDA C++ kernels here
(`csrc/`), built at first use with nvcc into a plain-C shared library:

  ops/grouped_apply.py     K1, grouped grid-update apply
                           (dliom_tpu/ops/pallas_apply.py::apply_grouped_rows)
  imu/affine_chain.py      K2, IMU error-state affine chain
                           (dliom_tpu/imu/preintegration.py::_pallas_affine_chain)

Each kernel wrapper launches its kernel for CUDA tensors and runs its plain
PyTorch version, in the same module, only for CPU tensors.

This package imports torch and numpy and never jax.
"""

__version__ = "0.1.0"

import torch as _torch

# The reference solves in float64; every matmul here is small dense algebra
# (15x15 preintegration blocks, the 90-variable window GN, 6-column matcher
# Jacobians), so full-f32 products cost nothing measurable while TF32 costs
# solver precision. Same pin as dliom_tpu/__init__.py.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
