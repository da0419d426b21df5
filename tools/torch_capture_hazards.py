#!/usr/bin/env python3
"""Which actions lose a CUDA graph capture of the kind the port makes.

    python3 tools/torch_capture_hazards.py [--cases a,b,...]

`common/graph.py::capture` records a step on the capturing thread's own
side stream with `capture_error_mode="thread_local"`, while other threads
(the pose graph's pool workers, the frontend) go on using the card. This
script captures a small body that way, and in the middle of the capture
one action is taken, either on the capturing thread or on a second thread
(its case name starts with `thread_`). Each case runs in a process of its
own and prints one JSON line: `case`, `held` (the capture ended and its
replay gave the eager result), `error` (the capturing thread's) and
`thread_error` (the second thread's). The last case, `collected_paused`,
is `collected` taken through `common/graph.py::capture`, which pauses
Python's garbage collector: it holds where `collected` does not. Needs
the card; prints its name and power limit first.
"""

import argparse
import gc
import json
import subprocess
import sys
import threading
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# on the capturing thread, inside the capture
OWN = {
    "none": "nothing",
    "graph_dropped": "the last reference to a replayed CUDA graph is dropped",
    "collected": "a replayed CUDA graph left in a garbage cycle, then allocations enough for a collection",
    "event_dropped": "the last reference to a recorded CUDA event is dropped",
    "pinned_freed": "a pinned host tensor read by a non-blocking copy is freed",
    "record_stream_freed": "a device tensor marked with record_stream on another stream is freed",
}
# on a second thread, while the first one captures
OTHER = {
    "thread_device_sync": "torch.cuda.synchronize()",
    "thread_empty_cache": "a 1 GiB tensor freed, then torch.cuda.empty_cache()",
    "thread_malloc": "20 new device tensors of 64 MiB",
    "thread_pinned": "20 new pinned host tensors of 4 MiB",
    "thread_graph_dropped": "the last reference to a replayed CUDA graph is dropped",
    "thread_default_stream_reads": "ops on the default stream read on the host (.item(), .cpu())",
    "thread_stream_sync": "ops on its own stream, which it synchronizes",
    "thread_event_sync": "events recorded on the default stream, synchronized and queried",
    "thread_new_libraries": "its first cuBLAS, cuSOLVER and cuFFT calls, on its own stream",
    "thread_replays": "200 replays of another graph on its own stream",
    "thread_rng": "torch.rand on its own stream (the default generator)",
}
CASES = [*OWN, *OTHER, "collected_paused"]


def _body(x):
    y = x
    for _ in range(200):
        y = torch.sin(y) * 1.0001 + 0.5
    return y


def _replayed_graph(dev):
    x = torch.ones(1024, device=dev)
    g = torch.cuda.CUDAGraph()
    s = torch.cuda.Stream(dev)
    s.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(s):
        _body(x)
        g.capture_begin(capture_error_mode="thread_local")
        _body(x)
        g.capture_end()
    s.synchronize()
    g.replay()
    torch.cuda.synchronize()
    return g


class _Cycle:
    def __init__(self, obj):
        self.obj, self.me = obj, self


def _prepare(case, dev, other):
    box = {}
    if case in ("graph_dropped", "collected", "collected_paused", "thread_graph_dropped", "thread_replays"):
        box["graph"] = _replayed_graph(dev)
    elif case == "event_dropped":
        box["event"] = torch.cuda.Event()
        box["event"].record()
    elif case == "pinned_freed":
        box["pinned"] = torch.ones(1 << 20, pin_memory=True)
        torch.empty(1 << 20, device=dev).copy_(box["pinned"], non_blocking=True)
    elif case == "record_stream_freed":
        box["tensor"] = torch.ones(1 << 20, device=dev)
        with torch.cuda.stream(other):
            box["tensor"].add_(1)
        box["tensor"].record_stream(other)
    torch.cuda.synchronize()
    return box


def _own_action(case, box):
    if case in ("graph_dropped", "event_dropped", "pinned_freed", "record_stream_freed"):
        box.clear()
    elif case in ("collected", "collected_paused"):
        _Cycle(box.pop("graph"))
        junk = [[] for _ in range(20 * gc.get_threshold()[0])]  # allocations enough for a collection
        del junk


def _other_action(case, box, dev, other):
    if case == "thread_device_sync":
        torch.cuda.synchronize()
    elif case == "thread_empty_cache":
        big = torch.empty(1 << 28, device=dev)
        del big
        torch.cuda.empty_cache()
    elif case == "thread_malloc":
        box["kept"] = [torch.empty((1 << 24) + i * 4096, device=dev) for i in range(20)]
    elif case == "thread_pinned":
        box["kept"] = [torch.empty((1 << 20) + i * 4096, pin_memory=True) for i in range(20)]
    elif case == "thread_graph_dropped":
        box.clear()
    elif case == "thread_default_stream_reads":
        for i in range(50):
            (torch.arange(1000 + i, device=dev, dtype=torch.float32) * 2).sum().item()
            torch.arange(4096 + i, device=dev).cpu()
    elif case == "thread_event_sync":
        for i in range(50):
            e = torch.cuda.Event()
            torch.arange(100, device=dev).add_(i)
            e.record()
            e.synchronize()
            e.query()
    else:
        with torch.cuda.stream(other):
            if case == "thread_stream_sync":
                for i in range(50):
                    torch.arange(1000 + i, device=dev, dtype=torch.float32).cos()
                    other.synchronize()
            elif case == "thread_new_libraries":
                a = torch.arange(96 * 96, device=dev, dtype=torch.float32).reshape(96, 96).cos()
                spd = a @ a.T + 96 * torch.eye(96, device=dev)
                torch.cholesky_solve(a, torch.linalg.cholesky_ex(spd).L)
                torch.fft.irfft2(torch.fft.rfft2(a[None].repeat(3, 1, 1)), s=(96, 96))
            elif case == "thread_replays":
                for _ in range(200):
                    box["graph"].replay()
            elif case == "thread_rng":
                torch.rand(1024, device=dev)
            other.synchronize()


def run_case(case):
    """One case in this process; returns its JSON record."""
    from dliom_tpu_torch.common import graph as cg

    dev = torch.device("cuda")
    x = torch.ones(1024, device=dev)
    want = _body(x)
    other = torch.cuda.Stream(dev)
    box = _prepare(case, dev, other)
    go, done, rec = threading.Event(), threading.Event(), {"case": case, "error": None, "thread_error": None}

    def second():
        go.wait()
        try:
            if case in OTHER:
                _other_action(case, box, dev, other)
        except Exception as e:  # noqa: BLE001 - reported in the record
            rec["thread_error"] = f"{type(e).__name__}: {str(e).splitlines()[0]}"
        done.set()

    th = threading.Thread(target=second)
    th.start()
    out = []

    def fn():
        _own_action(case, box)
        if case in OTHER:
            go.set()
            done.wait()
        out.append(_body(x))

    graph = torch.cuda.CUDAGraph()
    try:
        if case == "collected_paused":
            cg.capture(graph, (), dev, fn)
        else:
            s = torch.cuda.Stream(dev)
            s.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(s):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    fn()
                finally:
                    graph.capture_end()
            s.synchronize()
        graph.replay()
        torch.cuda.synchronize()
        rec["held"] = bool(torch.equal(out[0], want))
    except Exception as e:  # noqa: BLE001 - reported in the record
        rec["held"] = False
        rec["error"] = f"{type(e).__name__}: {str(e).splitlines()[0]}"
    go.set()
    th.join()
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("torch_capture_hazards: needs a CUDA card")
    if args.one:
        print(json.dumps(run_case(args.one)), flush=True)
        return
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    for case in args.cases.split(","):
        if case not in CASES:
            sys.exit(f"torch_capture_hazards: no case {case!r}; cases: {', '.join(CASES)}")
        r = subprocess.run([sys.executable, __file__, "--one", case], capture_output=True, text=True,
                           timeout=300)
        lines = r.stdout.strip().splitlines()
        rec = json.loads(lines[-1]) if r.returncode == 0 and lines else {
            "case": case, "held": False, "error": f"exit {r.returncode}: {r.stderr.strip()[-300:]}"}
        rec["action"] = OWN.get(case) or OTHER.get(case) or "collected, inside common/graph.py::capture"
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
