"""Stage marks of the compiled LIO step (dliom_tpu_torch/common/stages.py)
on the CPU: the summary's arithmetic on a ring written by hand, the stages'
order that a warm-up records (which the capture must mark again), a CPU
step graph's counts without marks, and the `stage` span in an eager
profile. The marks on the card are tests/test_torch_cuda_kernels.py's
(`-m cuda`). This file imports no jax."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dliom_tpu_torch.common import stages
from dliom_tpu_torch.frontend.lio import LioScanInput, lio_step, make_jit_lio_step
from dliom_tpu_torch.parallel import batch as TBatch
from test_torch_cuda_kernels import _small_step_case

CPU = torch.device("cpu")
SINGLE = ["lio.preintegrate", "frontend.filter", "frontend.match", "lio.window", "frontend.insert",
          "frontend.histogram"]


def _ring(rows, replays, body, gap, start=10**9):
    """Stamps of `replays` replays into a ring of `rows` rows: each replay's
    marks `body` ns apart (slots 0 .. len(body)), replays `gap` ns apart
    end to begin; returns (ring, the replays' begin stamps)."""
    slots = len(body) + 1
    ring = np.zeros((rows, slots), dtype=np.int64)
    begins, t = [], start
    for k in range(replays):
        row = t + np.concatenate([[0], np.cumsum(body)])
        ring[k % rows] = row
        begins.append(t)
        t = row[-1] + gap
    return ring, begins


@pytest.mark.parametrize("replays", [3, 700], ids=["filling", "wrapped"])
def test_summary_arithmetic(replays):
    """Medians over the replays the ring holds (the last `rows` once it
    wraps), `rest` the step outside its stages, the idle share between
    consecutive replays, launch delay on the host's clock, and a stage
    marked twice a replay (a chunk's) summed."""
    rows = stages.RING
    names = ["a", "a", "b", "b", "a", "a"]  # a, b, then a again
    body = [100, 1000, 50, 2000, 10, 3000, 40]  # ns between consecutive marks
    ring, begins = _ring(rows, replays, body, gap=600)
    offset = 5000
    host = np.zeros(rows, dtype=np.int64)
    for k, b in enumerate(begins):
        host[k % rows] = b - offset - 250_000  # entered 0.25 ms before its first mark
    kernels = [0, 1, 12, 13, 40, 41, 47, 48]  # before each mark: slots 0 .. 7
    out = stages.summarize(ring, replays, host, replays, names, kernels, 60, {"offset_ns": offset,
                                                                               "error_ns": 7})
    assert out["replays"] == min(replays, rows) and out["slots"] == 8 and out["kernels"] == 60
    assert out["device_ms"] == pytest.approx(sum(body) / 1e6)
    assert out["stages"]["a"] == {"ms": pytest.approx((1000 + 3000) / 1e6), "kernels": (12 - 1 - 1) + (47 - 41 - 1)}
    assert out["stages"]["b"] == {"ms": pytest.approx(2000 / 1e6), "kernels": 40 - 13 - 1}
    assert out["stages"]["rest"]["ms"] == pytest.approx((100 + 50 + 10 + 40) / 1e6)
    assert out["stages"]["rest"]["kernels"] == 60 - 8 - 15 - 26
    assert list(out["stages"]) == ["a", "b", "rest"]
    assert out["idle_share"] == pytest.approx(600 / (600 + sum(body)))
    assert out["launch_ms"] == pytest.approx(0.25)
    assert out["clock"] == {"offset_ns": 5000, "error_ns": 7}


def test_summary_skips_unfinished_rows_and_overwritten_entries():
    """A row whose stamps do not rise (a replay being written as the ring
    was read) is left out, and so is the launch delay of a replay whose
    host entry a later one has overwritten."""
    rows = stages.RING
    ring, begins = _ring(rows, 4, [10, 20], gap=5)
    ring[2, 2] = ring[2, 0] - 1
    host = np.zeros(rows, dtype=np.int64)
    out = stages.summarize(ring, 4, host, 4 + rows, ["s", "s"], [0, 1, 2], 3, {"offset_ns": 0, "error_ns": 0})
    assert out["replays"] == 3 and out["launch_ms"] is None
    assert out["idle_share"] == pytest.approx(5 / 35)  # replays 0-1 only: 2 is out, so 1-2 and 2-3 are


def test_warm_up_records_the_stages_in_order():
    """The eager body under a graph's marks records each stage's begin and
    end in the order the capture must mark them: the single step's six
    stages, and the batched step's with its flat insert as a second
    `frontend.insert`."""
    torch.manual_seed(0)
    cfg, scan, state = _small_step_case(CPU)
    marks = stages.StageMarks()
    with stages.owner(marks):
        lio_step(state, scan(0), cfg)
    assert marks.rehearsed == [n for n in SINGLE for _ in range(2)]
    assert [p[0] for p in stages.pairs(marks.rehearsed)] == SINGLE

    lanes = 2
    one = scan(0)
    inp = LioScanInput(*(x.expand((lanes,) + x.shape).clone() for x in one))
    marks = stages.StageMarks()
    with stages.owner(marks):
        TBatch.batched_lio_body(cfg, lanes)(TBatch.make_batched_lio_state(cfg, lanes, CPU), inp)
    assert [p[0] for p in stages.pairs(marks.rehearsed)] == SINGLE + ["frontend.insert"]


def test_cpu_graph_counts_have_no_marks():
    """A compiled step on a CPU state runs eagerly, records no stages and
    counts as before."""
    cfg, scan, state = _small_step_case(CPU)
    step = make_jit_lio_step(cfg)
    step(state, scan(0))
    assert step.marks.rehearsed == [] and not step.marks.armed
    assert step.counts() == {"steps": 1, "warmups": 0, "captures": 0, "replays": 0}


def test_stage_opens_its_span_eagerly():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with stages.stage("frontend.match"):
            torch.ones(4).add_(1)
    assert "frontend.match" in {e.key for e in prof.key_averages()}
