#!/usr/bin/env python3
"""The benchmark of dliom_tpu_torch, the PyTorch/CUDA port, on NVIDIA cards.

    python3 benchmark/run.py --workload viral.replay --seed 7 --seconds 10 --trace 0

runs one cell of BENCHMARK.json once from the root of a checkout: it makes
the cell's inputs from the seed on the card, warms the port's compiled step
up (set-up), measures for `--seconds`, checks what the window produced
against the plain reference (benchmark/reference/), and prints one JSON
line as the last line of its standard output: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer ones), `device` (and `breakdown` when tracing), and last
`checks`, each number compared beside its limit, which also close its
standard error.

It exits with another code than 0, printing no result, where there is no
CUDA card (or fewer than the cell asks for), and where the process holds
JAX or the JAX package once the window has closed. Build and kernel caches
stay inside the checkout (build/).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / "benchmark" / sub)
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark import harness

    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), T_START)
    if result is None:
        return 2
    held = harness.forbidden_modules()
    if held:
        print(f"the run holds {held}, which the port's run may not load", file=sys.stderr)
        return 3
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
