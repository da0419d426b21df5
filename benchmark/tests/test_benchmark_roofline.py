"""The roofline arithmetic (benchmark/metrics/roofline.py) on known shapes."""

import numpy as np
import pytest

from benchmark.metrics import roofline


def test_k1_bytes_counts_tables_records_and_cells():
    cpg = 512
    # step 0: 3 records on 2 distinct cells; step 1: fresh; step 2: empty
    keys = np.array([(5 << 1) | 1, 5 << 1, 9 << 1, 0], np.int32)
    starts, ends = np.array([0, 3, 3]), np.array([3, 4, 3])
    fresh = np.array([0, 1, 0])
    want = 16 * 3 + 4 * 3 + 4 * 2 + 4 * 1 + 2 * cpg
    assert roofline.k1_bytes(starts, ends, keys, fresh, cpg) == want


def test_k1_dense_bytes_keeps_the_first_groups():
    cpg, cb = 16384, 15
    sentinel = 2**31 - 1
    keys = np.array([(0 << cb) | (3 << 1), (0 << cb) | (3 << 1) | 1, (1 << cb) | (4 << 1),
                     (2 << cb) | (4 << 1), sentinel], np.int64)
    # two groups kept: cells 3 of group 0 and 4 of group 1
    assert roofline.k1_dense_bytes(keys, 2, cpg) == 4 * 5 + 4 * 2 + 4


def test_k2_work_and_bound():
    nbytes, flops = roofline.k2_work(2, 40)
    assert nbytes == 2 * 2 * 41 * 225 * 4
    assert flops == 2 * 40 * (6 * 15 ** 3 + 225)
    s, by = roofline.bound(nbytes, flops)
    assert by == "bytes" and s == pytest.approx(nbytes / roofline.HBM_BYTES_PER_S)
    assert roofline.bound(0, flops) == (pytest.approx(flops / roofline.F32_FLOP_PER_S), "operations")
    assert roofline.bound(3.35e12)[0] == pytest.approx(1.0)
