"""Host-side helpers on integer point sets (the parts of
pcgcv2_tpu/data/voxelize.py the codec needs)."""

from __future__ import annotations

import numpy as np


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
