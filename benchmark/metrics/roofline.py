"""The yardstick of the kernels' rooflines: the least time the card could
take for a call, from the bytes and operations its inputs need (copies of
chip_smoke.py's `bound`, `k1_bytes`, `k1_dense_bytes` and `k2_work`), over
the published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at 700 W)."""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12  # float32 outside the tensor cores


def bound(nbytes: float, flops: float = 0.0):
    """(bound_s, bound_by): the larger of bytes over the memory rate and
    float32 operations over the peak rate."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def k1_bytes(starts, ends, keys, fresh, cpg: int) -> int:
    """Bytes K1 must move for these tables: 16 per step (rows, starts, ends,
    fresh), each record read once (4), and per step each distinct touched
    cell read and written (2 + 2), or its whole group written once (2 per
    cell) when the step is fresh."""
    s, e, k, f = (np.asarray(x) for x in (starts, ends, keys, fresh))
    total = 16 * len(s)
    for a, b, fr in zip(s, e, f):
        total += 4 * max(0, b - a)
        if fr:
            total += 2 * cpg
        elif b > a:
            total += 4 * len(np.unique((k[a:b] >> 1) & (cpg - 1)))
    return int(total)


def k1_dense_bytes(keys, num_groups: int, cpg: int) -> int:
    """Bytes K1's dense entry must move: every key read once (4), each
    distinct touched cell of the kept groups read and written (2 + 2),
    `dropped` written (4)."""
    cb = int(cpg).bit_length()
    k = np.asarray(keys)
    n = k.size
    k = k[k != 2**31 - 1]
    kept = np.unique(k >> cb)[:num_groups]
    k = k[np.isin(k >> cb, kept)]
    return int(4 * n + 4 * len(np.unique(k >> 1)) + 4)


def k1_record_bytes(record) -> int:
    """k1_bytes or k1_dense_bytes of one call the reference's plain K1
    recorded (benchmark/reference/lio/ops/grouped_apply.py::RECORD)."""
    if record[0] == "rows":
        _, starts, ends, keys, fresh, cpg = record
        return k1_bytes(*(x.cpu().numpy() for x in (starts, ends, keys, fresh)), cpg)
    _, keys, num_groups, cpg = record
    return k1_dense_bytes(keys.cpu().numpy(), num_groups, cpg)


def k2_work(batch: int, m: int):
    """(bytes, float32 operations) of the chain: F and Q read, A and P
    written; per sample three 15x15 products (2 x 15^3 each) and Q's add."""
    return 2 * batch * (m + 1) * 225 * 4, batch * m * (6 * 15 ** 3 + 225)
