"""The benchmark of the PyTorch/CUDA port, dliom_tpu_torch: see run.py."""
