"""Stage marks: the LIO step's stages timed and counted inside every replay
of its CUDA graph, where no Python runs.

`stage(name)` opens a `record_function` span of `name`, which eager
profiles read (torch.profiler). While a `StepGraph` (`common/graph.py`)
whose warm-up met stages captures on the calling thread, it also captures a
device mark at the stage's start and at its end: a one-thread kernel
(`csrc/stage_mark.cu`) that writes the card's global timer (ns) into
`ring[replay % RING][slot]`, the slot fixed at capture. The graph adds a
mark before its body and one after its write-back, which closes the
replay (it advances the ring's counter). At each mark the capture counts
the kernel nodes captured so far, so each stage's kernels are known
exactly and cost nothing at replay. The graph finds its marks through a
thread-local owner (`owner`), as the dense K1 finds its look-back
scratch; eager steps and CPU states have none, so `stage` is the span
alone there.

The graph's eager warm-up runs the body under the same owner before the
ring is made: it records the stages' order, which sizes the ring, and the
capture must mark the same stages in the same order.

A summary (`StageMarks.summary`) reads the ring back: medians over the
replays it holds of each replay's device time (first mark to last), its
launch delay (the host's entry into the step, `time.perf_counter_ns()`,
to its first mark), the device's idle share between replays, and each
stage's time and kernels (a stage that runs more than once a replay, as
in a chunk, summed), with `rest` the step's time and kernels outside the
stages. One clock: the card's timer is put on the host's monotonic clock
by the narrowest of BRACKETS host brackets around one standalone mark
(launch to its stream's synchronize); half its width is the error.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

RING = 512  # replays the ring keeps
BRACKETS = 5  # clock brackets a summary takes; the narrowest counts
REST = "rest"  # the step outside its marked stages

_OWNER = threading.local()  # the marks of the graph this thread warms up or captures


@contextlib.contextmanager
def owner(marks: Optional["StageMarks"]):
    """`stage` calls this thread makes inside mark into `marks` (none where
    it is None)."""
    prev = getattr(_OWNER, "marks", None)
    _OWNER.marks = marks
    try:
        yield
    finally:
        _OWNER.marks = prev


@contextlib.contextmanager
def stage(name: str):
    """A stage of the step: a `record_function` span, and a device mark at
    each end while a graph captures its stages on this thread."""
    marks = getattr(_OWNER, "marks", None)
    with record_function(name):
        if marks is not None:
            marks.mark(name)
        yield
        if marks is not None:
            marks.mark(name)


def _launch(ring: torch.Tensor, rows: int, slots: int, slot: int, close: bool) -> None:
    from dliom_tpu_torch import kernels

    stream = torch.cuda.current_stream(ring.device).cuda_stream
    kernels.check(kernels.library().dliom_stage_mark(ring.data_ptr(), rows, slots, slot, int(close), stream),
                  "stage_mark")


def _captured_kernels(device: torch.device) -> int:
    """Kernel nodes of the graph the current stream is capturing."""
    from dliom_tpu_torch import kernels

    out = ctypes.c_longlong(0)
    stream = torch.cuda.current_stream(device).cuda_stream
    kernels.check(kernels.library().dliom_capture_kernels(stream, ctypes.byref(out)), "capture_kernels")
    return out.value


def clock(device: torch.device) -> Dict[str, int]:
    """The card's timer less the host's `perf_counter_ns` (`offset_ns`), and
    half the narrowest bracket (`error_ns`)."""
    buf = torch.zeros(2, dtype=torch.int64, device=device)
    stream = torch.cuda.current_stream(device)
    stream.synchronize()
    best = None
    for _ in range(BRACKETS):
        t0 = time.perf_counter_ns()
        _launch(buf, 1, 1, 0, False)
        stream.synchronize()
        t1 = time.perf_counter_ns()
        half = (t1 - t0) // 2
        if best is None or half < best[1]:
            best = (int(buf[0]) - (t0 + half), half)
    return {"offset_ns": best[0], "error_ns": best[1]}


def _median(values) -> Optional[float]:
    return float(np.median(values)) if len(values) else None


def pairs(names: Sequence[str]):
    """(name, begin, end) of each stage from the names of the body's marks,
    slots 1.. in order (a stage's begin and end carry its name)."""
    open_: Dict[str, int] = {}
    out = []
    for slot, name in enumerate(names, start=1):
        if name in open_:
            out.append((name, open_.pop(name), slot))
        else:
            open_[name] = slot
    if open_:
        raise ValueError(f"stages not closed: {sorted(open_)}")
    return out


def summarize(ring: np.ndarray, done: int, host_ns: np.ndarray, launched: int, names: Sequence[str],
              kernels: Sequence[int], total: int, clk: Dict[str, int]) -> dict:
    """The summary of a ring read back: `ring` (rows, slots) stamps, `done`
    replays closed, `host_ns` (rows,) the host's entry times of the
    `launched` replays, `names` the body's marks (slots 1 .. slots - 2),
    `kernels` the kernel nodes before each mark at capture and `total`
    after the last, `clk` the clock (`clock`)."""
    rows, slots = ring.shape
    stages = pairs(names)
    order = list(dict.fromkeys(n for n, _, _ in stages))
    stage_kernels = dict.fromkeys(order, 0)
    for name, b, e in stages:
        stage_kernels[name] += kernels[e] - kernels[b] - (e - b)
    rest_kernels = total - slots - sum(stage_kernels.values())

    first = max(0, done - rows)
    kept = []  # (replay, row) of the complete replays the ring holds
    for k in range(first, done):
        row = ring[k % rows]
        if row[0] > 0 and np.all(np.diff(row) >= 0):
            kept.append((k, row))
    device, launch, idle = [], [], []
    by_stage = {n: [] for n in order}
    prev = None
    for k, row in kept:
        device.append((row[-1] - row[0]) / 1e6)
        for n in order:
            by_stage[n].append(sum(row[e] - row[b] for m, b, e in stages if m == n) / 1e6)
        if k >= launched - rows:
            launch.append((row[0] - clk["offset_ns"] - host_ns[k % rows]) / 1e6)
        if prev is not None and prev[0] == k - 1:
            idle.append((row[0] - prev[1][-1]) / (row[-1] - prev[1][-1]))
        prev = (k, row)
    rest = [d - sum(by_stage[n][i] for n in order) for i, d in enumerate(device)]
    out_stages = {n: {"ms": _median(by_stage[n]), "kernels": stage_kernels[n]} for n in order}
    out_stages[REST] = {"ms": _median(rest), "kernels": rest_kernels}
    return {"replays": len(kept), "slots": slots, "kernels": total, "device_ms": _median(device),
            "launch_ms": _median(launch), "idle_share": _median(idle), "stages": out_stages,
            "clock": {"offset_ns": int(clk["offset_ns"]), "error_ns": int(clk["error_ns"])}}


class StageMarks:
    """One compiled step's marks: the stages' order (from the warm-up), the
    ring (made before the capture), the kernel nodes at each mark (counted
    at capture) and the host's entry time of each replay (`host_ns`,
    written by the graph)."""

    def __init__(self):
        self.rehearsed: List[str] = []
        self.names: List[str] = []
        self.kernels: List[int] = []
        self.total: Optional[int] = None
        self.ring: Optional[torch.Tensor] = None
        self.slots = 0
        self.host_ns = np.zeros(RING, dtype=np.int64)

    def mark(self, name: str) -> None:
        """A stage's begin or end: recorded in the warm-up, a device mark at
        capture."""
        if self.ring is None:
            self.rehearsed.append(name)
            return
        if len(self.names) >= len(self.rehearsed) or self.rehearsed[len(self.names)] != name:
            raise RuntimeError(f"stage {name!r} marked at capture after {self.names}, where the warm-up "
                               f"marked {self.rehearsed}")
        self.names.append(name)
        self._mark(len(self.names), close=False)

    def _mark(self, slot: int, close: bool) -> None:
        self.kernels.append(_captured_kernels(self.ring.device))
        _launch(self.ring, RING, self.slots, slot, close)

    @property
    def armed(self) -> bool:
        """Whether a capture marks the stages (the warm-up met some)."""
        return self.ring is not None

    def arm(self, device: torch.device) -> None:
        """Before the capture: the ring, sized by the warm-up's marks."""
        self.slots = len(self.rehearsed) + 2
        self.ring = torch.zeros(RING * self.slots + 1, dtype=torch.int64, device=device)

    def begin(self) -> None:
        """Before the captured body: the replay's first mark."""
        self.names, self.kernels = [], []
        self._mark(0, close=False)

    def end(self) -> None:
        """After the captured write-back: the mark that closes the replay."""
        if self.names != self.rehearsed:
            raise RuntimeError(f"capture marked {self.names}, the warm-up {self.rehearsed}")
        self._mark(self.slots - 1, close=True)
        self.total = _captured_kernels(self.ring.device)

    def summary(self, launched: int) -> dict:
        """`summarize` of the ring as it stands, after the calling thread's
        stream (which the replays should have run on) has finished."""
        dev = self.ring.device
        with torch.cuda.device(dev):
            torch.cuda.current_stream(dev).synchronize()
            flat = self.ring.cpu().numpy()
            clk = clock(dev)
        ring = flat[:-1].reshape(RING, self.slots)
        return summarize(ring, int(flat[-1]), self.host_ns, launched, self.names, self.kernels,
                         self.total, clk)
