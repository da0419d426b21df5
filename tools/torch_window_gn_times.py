"""K3 (csrc/window_gn.cu, the window Gauss-Newton) timed on the card beside
its plain version, at the window sizes and lane counts the main paths use,
and the bound of its dependent chain.

    python3 tools/torch_window_gn_times.py [--out k3_times.json]

For each (window, lanes): K3's graph ms (20 launches captured in one CUDA
graph, replayed, CUDA events over the replays, per launch), the plain
version's graph ms (`optimize_plain`, vmapped over the lanes where B > 1,
captured as the compiled step captures it) and its kernels, per field
(q, p, v, ba, bg) the largest difference of the two and the plain
version's largest move, at 8 iterations and at 1 (tests/window_cases.py),
the bytes a launch reads and writes, and the chain bound. The bound: the
Cholesky's columns and both triangular solves' run one after the other
in one warp, every iteration, so a launch takes at least `iterations` x
(n Cholesky columns + 2n solve columns + 2 x 15 (W - 1) off-diagonal
FMAs) dependent steps, n = 15 W, each at the latency that
tools/window_gn_chain.cu measures on the card for its kind (a chain of
2^20 steps in one warp, CUDA events). The Jacobian, J^T J and the
scaling are left out: the bound is a floor, not an estimate. One JSON
line, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))  # window_cases, by its path: a `tests` package may be installed

from dliom_tpu_torch import kernels  # noqa: E402
from dliom_tpu_torch.imu import window_optimizer as wo  # noqa: E402
from window_cases import ITERATIONS, field_gaps, pushed_windows  # noqa: E402

SHAPES = ((4, 1), (4, 18), (6, 1))  # (window, lanes): replay cells, the batched cell, the runner
CHAIN_SOURCE = Path(__file__).resolve().parent / "window_gn_chain.cu"
CHAIN_KINDS = ("cholesky", "solve", "fma")  # tools/window_gn_chain.cu's kinds 0, 1, 2
CHAIN_STEPS = 1 << 20


def chain_latency_ns() -> dict:
    """ns a dependent step of each kind takes on the card (window_gn_chain.cu)."""
    digest = hashlib.sha256(CHAIN_SOURCE.read_bytes() + " ".join(kernels.NVCC_FLAGS).encode())
    lib_path = kernels.BUILD_DIR / f"libwindow_gn_chain_{digest.hexdigest()[:16]}.so"
    if not lib_path.exists():
        kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", str(lib_path), str(CHAIN_SOURCE)],
                       check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.dliom_chain_latency.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.dliom_chain_latency.restype = ctypes.c_int
    out = torch.empty(32, device="cuda")
    stream = torch.cuda.current_stream()
    ns = {}
    for kind, name in enumerate(CHAIN_KINDS):
        kernels.check(lib.dliom_chain_latency(kind, 1024, out.data_ptr(), stream.cuda_stream), "chain latency")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record(stream)
        kernels.check(lib.dliom_chain_latency(kind, CHAIN_STEPS, out.data_ptr(), stream.cuda_stream),
                      "chain latency")
        end.record(stream)
        stream.synchronize()
        ns[name] = start.elapsed_time(end) * 1e6 / CHAIN_STEPS
    return ns


def chain_bound(w: int, ns: dict) -> dict:
    """The dependent steps of one launch at window w, and their time in ms."""
    n = 15 * w
    steps = {"cholesky": ITERATIONS * n, "solve": ITERATIONS * 2 * n, "fma": ITERATIONS * 2 * 15 * (w - 1)}
    return {"chain_steps": steps, "chain_bound_ms": sum(steps[k] * ns[k] for k in steps) / 1e6}


def graph_ms(fn, calls: int, replays: int = 20) -> float:
    """Device ms of one `fn()`: `calls` of it captured in one graph, the
    graph replayed, CUDA events around the replays."""
    from dliom_tpu_torch.common import graph as cg

    stream = torch.cuda.Stream()
    with cg.cusolver(), torch.cuda.stream(stream):
        for _ in range(2):
            fn()  # warm-up: libraries, handles, constants
        stream.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=stream):
            for _ in range(calls):
                fn()
        g.replay()
        stream.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record(stream)
        for _ in range(replays):
            g.replay()
        end.record(stream)
        stream.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def kernels_of(fn) -> int:
    """Device kernels one `fn()` runs (torch.profiler, the card's activity)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dliom_tpu_torch.common import graph as cg

    with cg.cusolver():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    names = [e.name() for e in prof.profiler.kineto_results.events() if e.device_type() != DeviceType.CPU]
    return sum(1 for n in names if not n.lower().startswith(("memcpy", "memset")))


def measure(w: int, lanes: int, dev: torch.device, ns: dict) -> dict:
    from torch.utils._pytree import tree_map

    from dliom_tpu_torch.common import graph as cg

    imu, wins = pushed_windows("viral", w, True)
    picked = [wins[(w + 1) - (b % 3)] for b in range(lanes)]  # full windows, slid and not
    win = tree_map(lambda *xs: torch.stack(xs).to(dev), *picked)
    if lanes == 1:
        win = wo.WindowState(*(x[0] for x in win))

    def plain(iterations=ITERATIONS):
        if lanes == 1:
            return wo.optimize_plain(win, imu, imu.gravity, iterations)
        return torch.func.vmap(lambda s: wo.optimize_plain(s, imu, imu.gravity, iterations))(win)

    k3 = lambda iterations=ITERATIONS: wo.optimize(win, imu, imu.gravity, iterations)  # noqa: E731
    gaps = {}
    for iterations in (ITERATIONS, 1):
        got = k3(iterations)
        with cg.cusolver():
            want = plain(iterations)
        torch.cuda.synchronize()
        gaps[f"iterations_{iterations}"] = field_gaps(got, want, win)
    return {"window": w, "lanes": lanes, "k3_graph_ms": graph_ms(k3, 20),
            "plain_graph_ms": graph_ms(plain, 1, replays=5), "plain_kernels": kernels_of(plain),
            "gaps": gaps, "bytes": sum(x.numel() * x.element_size() for x in win) + 4 * lanes * 16 * w,
            **chain_bound(w, ns)}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None, help="also write the JSON line here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device: K3 runs only on the card")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()
    ns = chain_latency_ns()
    out = {"device": torch.cuda.get_device_name(dev), "nvidia_smi": card, "chain_latency_ns": ns,
           "shapes": [measure(w, b, dev, ns) for w, b in SHAPES]}
    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return out


if __name__ == "__main__":
    main()
