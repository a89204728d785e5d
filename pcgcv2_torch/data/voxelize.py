"""Host-side batching and helpers on integer point sets (own copy of
pcgcv2_tpu/data/voxelize.py)."""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np


def bucket_capacity(n: int, round_to: int = 65536, slack: float = 1.0) -> int:
    """Round a row count up to a bucket of `round_to` rows."""
    return int(math.ceil(max(n * slack, 1) / round_to)) * round_to


def collate(coords_list: Sequence[np.ndarray],
            capacity: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Batch [N_i, 3] integer coord arrays into padded voxel rows: (coords
    int32 [cap, 4] with a leading batch column, valid bool [cap]).  The
    feature of every voxel is an implicit 1, derived from `valid`."""
    total = sum(len(c) for c in coords_list)
    cap = capacity or bucket_capacity(total)
    if total > cap:
        raise ValueError(f"batch of {total} voxels exceeds capacity {cap}")
    rows = np.zeros((cap, 4), dtype=np.int32)
    valid = np.zeros((cap,), dtype=bool)
    ofs = 0
    for b, c in enumerate(coords_list):
        n = len(c)
        rows[ofs:ofs + n, 0] = b
        rows[ofs:ofs + n, 1:] = c
        ofs += n
    valid[:ofs] = True
    return rows, valid


def unique_rows(coords: np.ndarray) -> np.ndarray:
    """Sorted-unique [N, 3] int rows via a raveled int64 key (coordinates
    non-negative and < 2^21).  Already sorted-unique input is returned
    without the O(n log n) sort."""
    c = np.asarray(coords, dtype=np.int64)
    key = (c[:, 0] << 42) | (c[:, 1] << 21) | c[:, 2]
    if len(key) and np.all(key[1:] > key[:-1]):
        return np.ascontiguousarray(np.asarray(coords, np.int32))
    ku = np.unique(key)
    out = np.empty((len(ku), 3), np.int32)
    out[:, 0] = ku >> 42
    out[:, 1] = (ku >> 21) & 0x1FFFFF
    out[:, 2] = ku & 0x1FFFFF
    return out


def scale_coords(coords: np.ndarray, factor: float) -> np.ndarray:
    """Lossy pre-scaling: round(coords * factor), deduplicated."""
    scaled = np.round(coords.astype(np.float64) * factor).astype(np.int32)
    return unique_rows(scaled)
