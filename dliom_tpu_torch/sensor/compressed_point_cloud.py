"""Bit-packed point-cloud compression.

Counterpart of the reference's `sensor::CompressedPointCloud`
(sensor/compressed_point_cloud.cc:28-34, :97-160): points quantize to a 1 mm
grid (`kPrecision = 0.001`); each point packs its 10 low bits per coordinate
(`kBitsPerCoordinate`) into one int32 relative to its 1.024 m block, plus one
block-origin record per occupied block. ~4.4 bytes/point vs 12 raw.

Host-side serde type (the reference iterates sequentially; here compression is
one vectorized numpy sort over block ids, and decompression one gather), used
to retain per-node clouds in serialized state at a fraction of the size.

A copy of dliom_tpu/sensor/compressed_point_cloud.py (numpy only): both
packages produce the same arrays, so their saved states load into each other.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

PRECISION = 0.001  # meters (kPrecision)
BITS = 10  # kBitsPerCoordinate
MASK = (1 << BITS) - 1


class CompressedPointCloud(NamedTuple):
    block_origins: np.ndarray  # (B, 3) int32, block coordinate << BITS in mm
    block_counts: np.ndarray  # (B,) int32 points per block
    packed: np.ndarray  # (N,) int32, 3 x 10-bit offsets, block-sorted
    num_points: int

    @property
    def nbytes(self) -> int:
        return self.block_origins.nbytes + self.block_counts.nbytes + self.packed.nbytes


def compress(points: np.ndarray) -> CompressedPointCloud:
    """Quantize + block + pack (CompressedPointCloud ctor :97-160)."""
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    mm = np.round(pts / PRECISION).astype(np.int64)  # lround(:92-95)
    block = mm >> BITS
    rel = (mm & MASK).astype(np.int32)
    # group by block: single lexsort over block coords
    order = np.lexsort((block[:, 2], block[:, 1], block[:, 0]))
    block = block[order]
    rel = rel[order]
    first = np.ones(len(block), bool)
    if len(block) > 1:
        first[1:] = np.any(block[1:] != block[:-1], axis=1)
    starts = np.flatnonzero(first)
    counts = np.diff(np.append(starts, len(block))).astype(np.int32)
    origins = (block[starts] << BITS).astype(np.int32)
    packed = rel[:, 0] | (rel[:, 1] << BITS) | (rel[:, 2] << (2 * BITS))
    return CompressedPointCloud(
        block_origins=origins,
        block_counts=counts,
        packed=packed.astype(np.int32),
        num_points=len(pts),
    )


def decompress(c: CompressedPointCloud) -> np.ndarray:
    """Unpack to (N, 3) float32 (ConstIterator::ReadNextPoint :78-95)."""
    block_of_point = np.repeat(
        np.arange(len(c.block_counts)), c.block_counts.astype(np.int64)
    )
    origins = c.block_origins[block_of_point].astype(np.int64)
    p = c.packed.astype(np.int64)
    rel = np.stack([p & MASK, (p >> BITS) & MASK, p >> (2 * BITS)], axis=-1)
    return ((origins + rel) * PRECISION).astype(np.float32)
