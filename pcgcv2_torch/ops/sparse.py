"""Per-voxel sparse tensor and convolution ops: the test oracle of the block
backend (own copy of pcgcv2_tpu/ops/sparse.py, in plain PyTorch).

This backend is the semantic ground truth that the dense-block backend
(`ops/blocks.py`) is held against in the tests; nothing on the codec's or
the trainer's path calls it, and it has no kernel.  It keeps the JAX
package's design:

* **Static shapes.** A `SparseVoxels` has a fixed row capacity; `count`
  rows are valid, the rest are padding with coords = PAD_COORD, feats = 0
  and key = PAD_KEY.
* **Sorted-key invariant.** Rows are always sorted by the int64 ravel of
  (batch, x, y, z) (`ops/keys.py`).  PAD_KEY is maximal, so valid rows are
  compact at the front, and every neighbourhood query is a
  `searchsorted`.
* **Explicit kernel maps.** A kernel map of a stencil is (neighbour index,
  hit mask) of shape [N, K]; all stride-1 convs at one scale can share it.
* A sparse conv is gather -> one [N, g*Cin] x [g*Cin, Cout] matmul per
  group of offsets -> accumulate in f32; the generative transposed conv is
  one [N, Cin] x [Cin, 8*Cout] matmul followed by a key sort.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Tuple

import torch

from pcgcv2_torch.ops import keys as K

PAD_COORD = torch.tensor(K.PAD_COORD, dtype=torch.int32)
# added to the keys of the rows `prune` drops, so they sort past the kept
# ones (PAD_KEY + this still fits in int64)
_COMPACT_OFFSET = 1 << 61


@dataclasses.dataclass
class SparseVoxels:
    """A batch of sparse voxel sets as one padded, key-sorted COO tensor.

    coords : int32 [capacity, 4] (batch, x, y, z); padding rows PAD_COORD
    feats  : float [capacity, C]; padding rows all zero
    keys   : int64 [capacity] ravel(coords), ascending; padding PAD_KEY
    count  : int32 [] number of valid rows (<= capacity)
    stride : static voxel stride (1 at full resolution)
    """

    coords: torch.Tensor
    feats: torch.Tensor
    keys: torch.Tensor
    count: torch.Tensor
    stride: int = 1

    @property
    def capacity(self) -> int:
        return self.coords.shape[0]

    @property
    def channels(self) -> int:
        return self.feats.shape[1]

    @property
    def valid(self) -> torch.Tensor:
        """bool [capacity]: True for real rows (compact at the front)."""
        return torch.arange(self.capacity, device=self.coords.device) < \
            self.count

    def replace(self, **changes) -> "SparseVoxels":
        return dataclasses.replace(self, **changes)

    def with_feats(self, feats: torch.Tensor) -> "SparseVoxels":
        """Same coordinate set, new features (zeroed on padding rows)."""
        return self.replace(feats=torch.where(self.valid[:, None], feats, 0))

    def num_per_batch(self, num_batches: int) -> torch.Tensor:
        """int32 [num_batches]: valid rows per batch item (rows are
        batch-major sorted; PAD_BATCH sorts after every real batch)."""
        b = self.coords[:, 0].long()
        bounds = torch.searchsorted(
            b, torch.arange(num_batches + 1, device=b.device))
        return torch.diff(bounds).to(torch.int32)


def _pad_rows(coords, feats, keys, valid):
    coords = torch.where(valid[:, None], coords, PAD_COORD.to(coords.device))
    feats = torch.where(valid[:, None], feats, 0)
    keys = torch.where(valid, keys, K.PAD_KEY)
    return coords, feats, keys


def build(
    coords: torch.Tensor,
    feats: torch.Tensor,
    count: Optional[torch.Tensor] = None,
    stride: int = 1,
    dedupe: bool = False,
    capacity: Optional[int] = None,
    valid_mask: Optional[torch.Tensor] = None,
) -> SparseVoxels:
    """A SparseVoxels from (possibly unsorted) padded rows.

    `coords` [N, 4] int32 with valid rows at arbitrary positions is sorted
    into the canonical key order.  Validity is the first `count` rows or an
    explicit bool `valid_mask`.  With `dedupe=True` duplicate coordinates
    are merged (the first feature row in key order wins)."""
    n = coords.shape[0]
    cap = capacity or n
    ar = torch.arange(n, device=coords.device)
    if valid_mask is not None:
        valid = valid_mask
        count = valid.sum(dtype=torch.int32)
    else:
        assert count is not None
        count = torch.as_tensor(count, dtype=torch.int32)
        valid = ar < count
    raw = torch.where(valid, K.ravel(coords), K.PAD_KEY)
    skeys, scoords, sfeats = K.sort_by_key(raw, coords, feats)
    if dedupe:
        keysv, coords, feats, count = _unique_compact(skeys, sfeats, cap)
    else:
        coords, feats, keysv = _resize_rows(scoords, sfeats, skeys, cap)
    valid = torch.arange(cap, device=coords.device) < count
    coords, feats, keysv = _pad_rows(coords, feats, keysv, valid)
    return SparseVoxels(coords=coords, feats=feats, keys=keysv,
                        count=count.to(torch.int32), stride=stride)


def _resize_rows(coords, feats, keys, cap):
    n = keys.shape[0]
    if cap == n:
        return coords, feats, keys
    if cap < n:
        return coords[:cap], feats[:cap], keys[:cap]
    pc = PAD_COORD.to(coords.device).expand(cap - n, 4)
    coords = torch.cat([coords, pc], dim=0)
    feats = torch.cat([feats, feats.new_zeros(cap - n, feats.shape[1])],
                      dim=0)
    keys = torch.cat([keys, keys.new_full((cap - n,), K.PAD_KEY)], dim=0)
    return coords, feats, keys


def _unique_compact(sorted_keys, sorted_feats, cap):
    """Deduplicate a sorted key vector, compacting into `cap` rows: (keys,
    coords, feats, count)."""
    valid = sorted_keys < K.PAD_KEY
    first = torch.ones_like(valid)
    first[1:] = sorted_keys[1:] != sorted_keys[:-1]
    first &= valid
    pos = torch.cumsum(first.long(), 0) - 1
    count = first.sum(dtype=torch.int32)
    sel = first & (pos < cap)  # the rest are dropped, as `mode="drop"`
    out_keys = sorted_keys.new_full((cap,), K.PAD_KEY)
    out_keys[pos[sel]] = sorted_keys[sel]
    out_feats = sorted_feats.new_zeros(cap, sorted_feats.shape[1])
    out_feats[pos[sel]] = sorted_feats[sel]
    return (out_keys, K.unravel(out_keys), out_feats,
            count.clamp_max(cap))


# ---------------------------------------------------------------------------
# Stencils and kernel maps
# ---------------------------------------------------------------------------


def stencil_offsets(kernel_size: int, stride_units: int) -> torch.Tensor:
    """Integer coordinate offsets of a cubic stencil, x-major: kernel_size
    3 -> the 27 offsets in {-s, 0, s}^3 (stride-1 conv neighbourhoods);
    kernel_size 2 -> the 8 offsets in {0, s}^3 (down-conv and generative
    up-conv child positions)."""
    if kernel_size == 3:
        rng = (-stride_units, 0, stride_units)
    elif kernel_size == 2:
        rng = (0, stride_units)
    else:
        raise ValueError(f"unsupported kernel_size {kernel_size}")
    return torch.tensor(list(itertools.product(rng, rng, rng)),
                        dtype=torch.int32)


def build_kernel_map(
    sv: SparseVoxels,
    offsets: torch.Tensor,
    query_coords: Optional[torch.Tensor] = None,
    query_valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(neighbour idx [Nq, K] int32, hit [Nq, K] bool) of a stencil: for
    each query coordinate q and offset d, the input row at q + d, found by
    searchsorted over the sorted keys.  Queries default to the tensor's own
    coordinates (stride-1 convs)."""
    if query_coords is None:
        query_coords, query_valid = sv.coords, sv.valid
    offsets = offsets.to(query_coords.device)
    nq, k = query_coords.shape[0], offsets.shape[0]
    q_xyz = query_coords[:, None, 1:] + offsets[None]  # [Nq, K, 3]
    q_b = query_coords[:, None, :1].expand(nq, k, 1)
    in_range = ((q_xyz >= 0) & (q_xyz < K.R)).all(dim=-1)
    if query_valid is not None:
        in_range = in_range & query_valid[:, None]
    q = torch.cat([q_b, q_xyz], dim=-1)
    qkeys = torch.where(in_range, K.ravel(q), K.PAD_KEY)
    return K.lookup(sv.keys, qkeys)


def apply_kernel_map(
    feats: torch.Tensor,
    nbr_idx: torch.Tensor,
    hit: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    group_size: int = 9,
) -> torch.Tensor:
    """Gather-GEMM sparse convolution given a prebuilt kernel map; weight
    [K, Cin, Cout].  Offsets are processed in groups, each one [N, g*Cin] x
    [g*Cin, Cout] matmul, accumulated in f32."""
    n, kk = nbr_idx.shape
    cin, cout = feats.shape[1], weight.shape[-1]
    acc = torch.zeros(n, cout, dtype=torch.float32, device=feats.device)
    for g0 in range(0, kk, group_size):
        g1 = min(g0 + group_size, kk)
        g = feats[nbr_idx[:, g0:g1].long()]  # [N, g, Cin]
        g = torch.where(hit[:, g0:g1, None], g, 0)
        w = weight[g0:g1].reshape((g1 - g0) * cin, cout)
        acc = acc + g.reshape(n, -1).float() @ w.to(feats.dtype).float()
    if bias is not None:
        acc = acc + bias
    return acc.to(feats.dtype)


def conv(
    sv: SparseVoxels,
    kmap: Tuple[torch.Tensor, torch.Tensor],
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    group_size: int = 9,
) -> SparseVoxels:
    """Stride-1 sparse convolution: output coords == input coords."""
    out = apply_kernel_map(sv.feats, kmap[0], kmap[1], weight, bias,
                           group_size)
    return sv.with_feats(out)


# ---------------------------------------------------------------------------
# Resolution-changing convolutions
# ---------------------------------------------------------------------------


def downsample_coords(sv: SparseVoxels, out_capacity: int):
    """Unique parent coordinates at stride 2s (the kernel 2, stride 2
    down-conv's output set): (parent coords [cap, 4], parent keys, parent
    valid, count), key-sorted."""
    s2 = 2 * sv.stride
    parent = torch.cat([sv.coords[:, :1], sv.coords[:, 1:] // s2 * s2],
                       dim=-1)
    pad = PAD_COORD.to(parent.device)
    parent = torch.where(sv.valid[:, None], parent, pad)
    pkeys = torch.where(sv.valid, K.ravel(parent), K.PAD_KEY)
    skeys = torch.sort(pkeys).values
    dummy = sv.feats.new_zeros(skeys.shape[0], 1)
    out_keys, out_coords, _, count = _unique_compact(skeys, dummy,
                                                     out_capacity)
    out_valid = torch.arange(out_capacity, device=parent.device) < count
    return out_coords, out_keys, out_valid, count


def conv_down(
    sv: SparseVoxels,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor],
    out_capacity: int,
    group_size: int = 8,
) -> SparseVoxels:
    """Strided down-convolution (kernel 2, stride 2): stride s -> 2s;
    weight [8, Cin, Cout] over the {0, s}^3 child offsets."""
    out_coords, out_keys, out_valid, count = downsample_coords(
        sv, out_capacity)
    offsets = stencil_offsets(2, sv.stride)
    nbr, hit = build_kernel_map(sv, offsets, out_coords, out_valid)
    feats = apply_kernel_map(sv.feats, nbr, hit, weight, bias, group_size)
    feats = torch.where(out_valid[:, None], feats, 0)
    return SparseVoxels(coords=out_coords, feats=feats, keys=out_keys,
                        count=count.to(torch.int32), stride=2 * sv.stride)


def conv_up_generative(
    sv: SparseVoxels,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor],
) -> SparseVoxels:
    """Generative transposed convolution (kernel 2, stride 2): stride 2s ->
    s.  Every valid parent emits its 8 children at parent + {0, s}^3
    (unique by construction); the output capacity is 8x the input's.  The
    child features are one [N, Cin] x [Cin, 8*Cout] matmul."""
    assert sv.stride % 2 == 0, "generative up-conv needs even stride"
    s_out = sv.stride // 2
    n, cin, cout = sv.capacity, sv.channels, weight.shape[-1]
    deltas = stencil_offsets(2, s_out).to(sv.coords.device)  # [8, 3]
    child_xyz = sv.coords[:, None, 1:] + deltas[None]  # [N, 8, 3]
    child_b = sv.coords[:, None, :1].expand(n, 8, 1)
    child = torch.cat([child_b, child_xyz], dim=-1)
    child = torch.where(sv.valid[:, None, None], child,
                        PAD_COORD.to(child.device))
    w = weight.permute(1, 0, 2).reshape(cin, 8 * cout)  # [Cin, 8*Cout]
    cf = (sv.feats.float() @ w.to(sv.feats.dtype).float()).reshape(
        n, 8, cout)
    if bias is not None:
        cf = cf + bias
    cf = torch.where(sv.valid[:, None, None], cf, 0).to(sv.feats.dtype)
    flat_keys = torch.where(sv.valid[:, None], K.ravel(child),
                            K.PAD_KEY).reshape(8 * n)
    skeys, scoords, sfeats = K.sort_by_key(
        flat_keys, child.reshape(8 * n, 4), cf.reshape(8 * n, cout))
    return SparseVoxels(coords=scoords, feats=sfeats, keys=skeys,
                        count=(8 * sv.count).to(torch.int32), stride=s_out)


# ---------------------------------------------------------------------------
# Pruning (top-k occupancy selection)
# ---------------------------------------------------------------------------


def topk_mask(
    sv: SparseVoxels,
    scores: torch.Tensor,
    nums: torch.Tensor,
    num_batches: int,
) -> torch.Tensor:
    """bool [capacity]: per batch item, its top nums[b] rows by score (k is
    at most the rows the item has), over the valid rows."""
    n = sv.capacity
    b = torch.where(sv.valid, sv.coords[:, 0].long(), num_batches)
    neg = torch.where(sv.valid, -scores.reshape(n).float(), float("inf"))
    # lexicographic (b, -score): sort by score, then stably by batch
    order = torch.argsort(neg, stable=True)
    order = order[torch.argsort(b[order], stable=True)]
    sb = b[order]
    starts = torch.searchsorted(sb, torch.arange(num_batches,
                                                 device=sb.device))
    sb_c = sb.clamp(0, num_batches - 1)
    rank = torch.arange(n, device=sb.device) - starts[sb_c]
    k_row = torch.where(sb < num_batches, nums.long()[sb_c], 0)
    keep = torch.zeros(n, dtype=torch.bool, device=sb.device)
    keep[order] = rank < k_row
    return keep & sv.valid


def prune(sv: SparseVoxels, keep: torch.Tensor,
          out_capacity: int) -> SparseVoxels:
    """Compact the rows where `keep` holds into a (possibly smaller)
    tensor.  Kept rows stay key-sorted; dropped and padding rows sort past
    them through one combined-key sort, then are cut at `out_capacity`."""
    keep = keep & sv.valid
    ckey = sv.keys + torch.where(keep, 0, _COMPACT_OFFSET)
    skeys, scoords, sfeats = K.sort_by_key(ckey, sv.coords, sv.feats)
    count = keep.sum(dtype=torch.int32).clamp_max(out_capacity)
    coords, feats, keysv = _resize_rows(scoords, sfeats, skeys, out_capacity)
    valid = torch.arange(out_capacity, device=coords.device) < count
    coords, feats, keysv = _pad_rows(coords, feats, keysv, valid)
    return SparseVoxels(coords=coords, feats=feats, keys=keysv, count=count,
                        stride=sv.stride)


def cat_feats(a: SparseVoxels, b: SparseVoxels) -> SparseVoxels:
    """Channel-concatenate two tensors over the same coordinate set."""
    return a.replace(feats=torch.cat([a.feats, b.feats], dim=-1))
