"""Raveled coordinate keys: the canonical ordering of the per-voxel oracle
(own copy of pcgcv2_tpu/ops/keys.py).

Every `ops.sparse.SparseVoxels` keeps its rows sorted by the int64 ravel of
(batch, x, y, z); padding rows carry the maximal PAD_KEY so they sort to the
end, and every neighbourhood or set operation is a `searchsorted` over that
sorted key vector.  The radix is fixed (R = 2**COORD_BITS per axis), so keys
are stable across calls, strides and scales.

Test-oracle support only: the codec and the trainer run on the block
backend (ops/blocks.py), which needs no int64 keys.
"""

from __future__ import annotations

import torch

# Per-axis coordinate budget: vox12 content spans [0, 4096) and strides
# reach 8; 2**14 leaves headroom for any supported resolution.
COORD_BITS = 14
R = 1 << COORD_BITS  # 16384

# Padding rows use this batch index; its key ravels above every real key.
PAD_BATCH = (1 << 17) - 1
# Padding coordinate row (batch, x, y, z).
PAD_COORD = (PAD_BATCH, R - 1, R - 1, R - 1)
# Key of a padding row; every real key is strictly smaller.
PAD_KEY = ((PAD_BATCH * R + (R - 1)) * R + (R - 1)) * R + (R - 1)


def ravel(coords: torch.Tensor) -> torch.Tensor:
    """[..., 4] int coords (batch, x, y, z) -> [...] int64 keys,
    ((b * R + x) * R + y) * R + z: lexicographic in (b, x, y, z)."""
    c = coords.long()
    return ((c[..., 0] * R + c[..., 1]) * R + c[..., 2]) * R + c[..., 3]


def unravel(keys: torch.Tensor) -> torch.Tensor:
    """[N] int64 keys -> [N, 4] int32 coords.  Inverse of `ravel`."""
    z = keys % R
    rem = keys // R
    y = rem % R
    rem = rem // R
    x = rem % R
    b = rem // R
    return torch.stack([b, x, y, z], dim=-1).to(torch.int32)


def sort_by_key(keys: torch.Tensor, *payloads: torch.Tensor):
    """Sort rows by key (stable); returns (sorted_keys, *gathered
    payloads)."""
    perm = torch.argsort(keys, stable=True)
    return (keys[perm],) + tuple(p[perm] for p in payloads)


def searchsorted(sorted_keys: torch.Tensor,
                 queries: torch.Tensor) -> torch.Tensor:
    """Index of the first element >= query in `sorted_keys`, int32, any
    query shape."""
    return torch.searchsorted(sorted_keys, queries).to(torch.int32)


def lookup(sorted_keys: torch.Tensor, queries: torch.Tensor):
    """(idx, hit) for each query key against a sorted key vector: `idx`
    clamped into range, `hit` True iff the exact key is present and is not
    the PAD_KEY sentinel."""
    n = sorted_keys.shape[0]
    idx = searchsorted(sorted_keys, queries).clamp_max(n - 1)
    hit = (sorted_keys[idx.long()] == queries) & (queries < PAD_KEY)
    return idx, hit


def isin(sorted_keys: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Boolean membership of `queries` in sorted `sorted_keys` (PAD
    excluded)."""
    return lookup(sorted_keys, queries)[1]
