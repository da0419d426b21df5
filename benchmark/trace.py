"""The traced stretch of a `--trace 1` run: torch.profiler over a bounded
run of steps in the window's middle, recording the card's activity
(kernels inside CUDA graph replays included) and the harness's own host
spans (`bench.stage`, `bench.step`, `bench.read`, ...), reduced here to
what the per-layer metrics and the `breakdown` read.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict
from typing import Dict, List, Tuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

SPAN_PREFIX = "bench."
STABLE = 1e-3  # steps of a stable stretch count kernels within this share of the median step


def span(name: str, on: bool):
    """A harness span around a call into the program, recorded when tracing."""
    return record_function(SPAN_PREFIX + name) if on else contextlib.nullcontext()


def profiler() -> profile:
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    return profile(activities=acts)


def warm_up() -> None:
    """Start and stop the profiler once, so that its first start (the
    tracing library's set-up) falls in the run's set-up, not in its window."""
    with profiler():
        torch.zeros(1, device="cuda" if torch.cuda.is_available() else "cpu").add_(1)


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _is_kernel(name: str) -> bool:
    """A kernel, not a copy or a set (CUPTI names those "Memcpy ..." and "Memset ...")."""
    low = name.lower()
    return not (low.startswith("memcpy") or low.startswith("memset"))


def reduce(prof: profile, steps: int) -> Dict:
    """What the traced stretch of `steps` steps shows: the window (the
    harness's spans, first start to last end), the device's busy time (the
    union of its activities inside the window), its kernels by name and by
    step (a kernel belongs to the step in whose spans the host launched it,
    found by its correlation id), and
    the idle gaps by the harness span open on the host. The stretch is
    `stable` where its steps count the same kernels to within STABLE: a
    replayed graph launches a fixed set (the batched step adds a few eager
    ones on some steps), so a step that counts fewer lost events (the
    profiler drops records when a stretch holds many steps)."""
    spans, device, launched = [], [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            if e.is_user_annotation():
                if e.name().startswith(SPAN_PREFIX):
                    spans.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
            elif e.correlation_id():
                launched[e.correlation_id()] = e.start_ns()  # the launch call on the host
        elif not e.is_user_annotation():
            device.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name(), e.correlation_id()))
    if not spans:
        return {}
    w0, w1 = min(s for s, _, _ in spans), max(e for _, e, _ in spans)
    # a device activity belongs to the stretch when the host launched it in
    # the stretch: the device's clock is aligned to the host's only roughly,
    # so clipping by the host's window would cut activities short
    inside = [(s, e, n, at) for s, e, n, at in ((s, e, n, launched.get(c, s)) for s, e, n, c in device)
              if w0 <= at < w1]
    # no activity starts before its launch: where one seems to, the device's
    # clock runs behind the host's by that much, which the idle gaps undo
    lag = max(0, max((at - s for s, _, _, at in inside), default=0))
    busy = _merge([(s + lag, e + lag) for s, e, _, _ in inside])
    starts = sorted(s for s, _, n in spans if n == SPAN_PREFIX + "stage") or [w0]
    by_step = [0] * len(starts)
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for s, e, n, at in inside:
        by_name[n][0] += 1
        by_name[n][1] += (e - s) * 1e-9
        if _is_kernel(n):
            by_step[max(0, bisect.bisect_right(starts, at) - 1)] += 1
    gaps: Dict[str, float] = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    by_length = sorted(spans, key=lambda x: x[1] - x[0])
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        mid = (g0 + g1) // 2
        owner = next((n for s, e, n in by_length if s <= mid < e), SPAN_PREFIX + "between_spans")
        gaps[owner] += (g1 - g0) * 1e-9
    return {
        "steps": steps,
        "window_s": (w1 - w0) * 1e-9,
        "busy_s": sum(e - s for s, e in busy) * 1e-9,
        "kernels": sum(by_step),
        "kernels_by_step": by_step,
        "stable": max(by_step) - min(by_step) <= STABLE * sorted(by_step)[len(by_step) // 2],
        "by_name": dict(by_name),
        "gaps": dict(gaps),
    }
