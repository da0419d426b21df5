#!/usr/bin/env python3
"""Time the CUDA kernels of one checkout's dliom_tpu_torch on one GPU.

    python3 tools/torch_kernel_times.py --root DIR [--out FILE]

Runs chip_smoke.py's kernel phases (3: K1 at the brick shapes, 4: K2 at
M = 48, 64, 200, 7: K1's dense entry) of THIS checkout against the
dliom_tpu_torch package found under DIR, which builds its kernels into
DIR/build/torch_kernels. Each phase holds the kernel against its plain
version on the same inputs (the same seed for every DIR) and times both:
host clock, CUDA events over 200 calls, CUDA-graph replay, and the bound;
phase 3 adds a PyTorch read-modify-write probe of the same cells and, where
DIR has csrc/empty.cu, one empty launch; phase 7 the dense entry's device
time per kernel (torch.profiler).
So two checkouts (a parent and a change) compare in one call on one card:
run the script once per checkout, in turns. Prints the card's name and
power limit and one JSON line of the times, which --out appends to FILE.
Needs one card; imports nothing of JAX.
"""

import argparse
import importlib.util
import json
import sys
from pathlib import Path


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, help="checkout whose dliom_tpu_torch is timed")
    ap.add_argument("--out", help="append the JSON line to this file")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_phases", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    phases = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(phases)

    card = phases.environment()
    import numpy as np

    import dliom_tpu_torch
    from dliom_tpu_torch import kernels
    from dliom_tpu_torch.imu import affine_chain as ac
    from dliom_tpu_torch.ops import grouped_apply as ga

    package = Path(dliom_tpu_torch.__file__).resolve()
    phases.check(package.is_relative_to(root), f"dliom_tpu_torch from {package}, not under {root}")
    kernels.library()
    rng = np.random.default_rng(0)
    k1, launch_floor = phases.check_grouped_apply(ga, rng)
    k2 = phases.check_affine_chain(ac, rng)
    k1d, dense_kernels = phases.check_dense_grouped_apply(ga, rng)
    line = json.dumps({"root": args.root, "card": card, "k1": k1, "k2": k2, "k1_dense": k1d,
                       "dense_kernels_per_call": dense_kernels, "empty_launch_graph_ms": launch_floor})
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
