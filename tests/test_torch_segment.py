"""The deterministic float segment sum (dliom_tpu_torch/ops/segment.py) on
the CPU: the same bits as `index_add_` (the sum the port used before; the
order of addition is the same), out-of-range ids dropped, a reused plan
equal to a fresh one, and the batched rotational histogram (one pass over
B lanes, lane-offset segments) equal to each lane's own, bit for bit. The
card's side (the same bits on every run) is in test_torch_cuda_kernels.py."""

import numpy as np
import pytest
import torch

from dliom_tpu_torch.ops.rotational_histogram import compute_histogram
from dliom_tpu_torch.ops.segment import segment_plan, segment_sum
import torch_threads  # noqa: F401  (one torch thread per test process)


@pytest.mark.parametrize("shape", [(), (3,), (6, 6)])
def test_segment_sum_equals_index_add(shape):
    rng = np.random.default_rng(0)
    values = torch.from_numpy((rng.normal(size=(5000,) + shape) * 100).astype(np.float32))
    ids = torch.from_numpy(rng.integers(-3, 44, 5000))
    keep = (ids >= 0) & (ids < 40)
    want = torch.zeros((40,) + shape).index_add_(0, ids[keep], values[keep])
    assert torch.equal(segment_sum(values, ids, 40), want)
    plan = segment_plan(ids.to(torch.int32), 40)
    assert torch.equal(segment_sum(values, plan), want)
    assert torch.equal(segment_sum(values[:0], ids[:0], 40), torch.zeros((40,) + shape))


def test_batched_histogram_equals_each_lane():
    rng = np.random.default_rng(1)
    pts = torch.from_numpy(rng.normal(0, 6.0, (3, 4096, 3)).astype(np.float32))
    mask = torch.from_numpy(rng.random((3, 4096)) < 0.9)
    mask[2] = False  # an empty lane
    hist = compute_histogram(pts, mask, num_buckets=90)
    assert hist.shape == (3, 90)
    for b in range(3):
        assert torch.equal(hist[b], compute_histogram(pts[b], mask[b], num_buckets=90))
    assert float(hist[0].sum()) > 0 and float(hist[2].abs().sum()) == 0
