"""Dense-block sparse voxel backend (twin of pcgcv2_tpu/ops/blocks.py).

Space is cut into BS^3 dense blocks.  A `BlockGrid` holds the occupied
blocks' features as one dense tensor [nb_cap, BS^3, C] plus a per-slot
occupancy mask; a dense lookup table (one int32 per block-space cell) maps
block coordinates to block rows.  Invariants shared with the JAX package:

* block rows are sorted by flat block key (batch-major), so extraction
  yields a canonical block-scan order;
* row nb_cap - 1 is an all-zero sentinel (features and mask) that every
  table miss points at, so out-of-set reads contribute zeros;
* a capacity overflow increments `dropped` and never writes the sentinel.

Everything here is plain PyTorch: the JAX package computed these ops
outside Pallas.  The 3^3 convolution lives in ops/conv3.py (CUDA kernels +
plain version).  Scatters with JAX's `mode="drop"` semantics route each
dropped element to a private slot past the end of the buffer (as the JAX
code does with out-of-range positions), so no element is lost silently
and nothing synchronises with the host.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed

from pcgcv2_torch.ops import collectives

BS = int(os.environ.get("PCGC_BLOCK_SIZE", "16"))
VOL = BS ** 3

# Dtype of conv/matmul inputs and outputs.  float32 by default; the
# production codec opts into bfloat16 (f32 accumulation inside the kernels,
# outputs and bias adds rounded to bf16 like the JAX package).
COMPUTE_DTYPE = torch.float32

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# Dense lookup-table budget: B * G^3 int32 cells (as in the JAX package).
MAX_TABLE_CELLS = 1 << 27


def set_compute_dtype(dtype) -> None:
    """Set the global conv compute dtype ('float32' or 'bfloat16')."""
    global COMPUTE_DTYPE
    COMPUTE_DTYPE = _DTYPES[dtype] if isinstance(dtype, str) else dtype


def resolve_device(device) -> torch.device:
    """torch.device for an entry point; a CUDA request without a card
    raises instead of running elsewhere."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run on the CPU"
        )
    return dev


def grid_dim(res: int) -> int:
    """Blocks per axis for a coordinate space of size `res` (grid coords)."""
    return max(1, -(-res // BS))


def check_table_size(res: int, num_batches: int) -> None:
    """Static guard on the dense block-lookup table (MAX_TABLE_CELLS)."""
    g = grid_dim(res)
    cells = num_batches * g ** 3
    if cells > MAX_TABLE_CELLS:
        raise ValueError(
            f"dense block table needs {cells} cells "
            f"({num_batches} x {g}^3) > {MAX_TABLE_CELLS} budget at res "
            f"{res}; pre-scale coordinates or reduce the batch size"
        )


@dataclasses.dataclass
class BlockGrid:
    """Occupied BS^3 blocks of a sparse voxel set at one scale.

    coords : int32 [nb_cap, 4] (batch, bx, by, bz); invalid rows are 0.
    feats  : [nb_cap, VOL, C]; zeros at unoccupied slots and invalid rows.
    mask   : bool [nb_cap, VOL] per-slot occupancy.
    table  : int32 [B * G^3] flat block coord -> row; misses hold nb_cap-1.
    count  : int32 [] number of valid (sorted-prefix) rows, < nb_cap.
    dropped: int32 [] occupied blocks lost to capacity overflow upstream.
    stride, res, num_batches : static voxel stride, grid resolution and
             batch bound.
    """

    coords: torch.Tensor
    feats: torch.Tensor
    mask: torch.Tensor
    table: torch.Tensor
    count: torch.Tensor
    dropped: torch.Tensor
    stride: int = 1
    res: int = 1024
    num_batches: int = 1

    @property
    def nb_cap(self) -> int:
        return self.coords.shape[0]

    @property
    def channels(self) -> int:
        return self.feats.shape[-1]

    @property
    def G(self) -> int:
        return grid_dim(self.res)

    @property
    def device(self) -> torch.device:
        return self.coords.device

    @property
    def valid(self) -> torch.Tensor:
        return _arange(self.nb_cap, self.device) < self.count

    @property
    def blocks(self) -> torch.Tensor:
        """feats viewed as [nb_cap, BS, BS, BS, C]."""
        return self.feats.reshape(self.nb_cap, BS, BS, BS, self.channels)

    def replace(self, **changes) -> "BlockGrid":
        return dataclasses.replace(self, **changes)

    def with_feats(self, feats: torch.Tensor) -> "BlockGrid":
        """Same structure, new features (zeroed outside the mask)."""
        feats = feats.reshape(self.nb_cap, VOL, -1)
        return self.replace(feats=torch.where(self.mask[:, :, None], feats, 0))

    def voxel_count(self) -> torch.Tensor:
        return (self.mask & self.valid[:, None]).sum(dtype=torch.int32)

    def voxels_per_batch(self) -> torch.Tensor:
        """int32 [num_batches] valid-voxel count per batch item."""
        per_block = self.mask.sum(dim=1)
        b = torch.where(self.valid, self.coords[:, 0].long(),
                        self.num_batches)
        seg = torch.zeros(self.num_batches + 1, dtype=torch.int64,
                          device=self.device)
        seg.index_add_(0, b, per_block)
        return seg[: self.num_batches].to(torch.int32)


def _arange(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


def _scatter_drop(size: int, pos: torch.Tensor, ok: torch.Tensor, values,
                  fill, dtype) -> torch.Tensor:
    """`full(size, fill).at[where(ok, pos, OOR)].set(values, mode="drop")`.

    Elements with `ok` False, or a position outside [0, size), land in a
    private slot past the end of a buffer that is sliced off afterwards.
    """
    n = pos.shape[0]
    device = pos.device
    ok = ok & (pos >= 0) & (pos < size)
    idx = torch.where(ok, pos, size + _arange(n, device))
    if not torch.is_tensor(values):
        # made on the device: a Python scalar would be copied from the
        # host, which a CUDA graph's capture refuses
        values = torch.full((), values, dtype=dtype, device=device)
    out = torch.full((size + n, *values.shape[1:]), fill, dtype=dtype,
                     device=device)
    out[idx] = values
    return out[:size]


def _flat_block_key(coords: torch.Tensor, g: int) -> torch.Tensor:
    """(b, bx, by, bz) -> flat int64 key in [0, B*G^3)."""
    c = coords.long()
    return ((c[..., 0] * g + c[..., 1]) * g + c[..., 2]) * g + c[..., 3]


def _unflatten_key(key: torch.Tensor, g: int) -> torch.Tensor:
    bz = key % g
    r = key // g
    by = r % g
    r = r // g
    bx = r % g
    b = r // g
    return torch.stack([b, bx, by, bz], dim=-1).to(torch.int32)


def _occupancy(cells: int, key: torch.Tensor, ok: torch.Tensor):
    """bool [cells] with True at key[ok]."""
    return _scatter_drop(cells, key, ok, True, False, torch.bool)


def _compact_from_occupancy(occ: torch.Tensor, g: int, nb_cap: int):
    """occupancy [B*G^3] bool -> (coords [nb_cap,4] sorted, table, count,
    n_over).  Ranks follow flat-key order; row nb_cap-1 is reserved as the
    miss target, so capacity is nb_cap-1 and overflow blocks are dropped
    (counted in n_over) rather than aliasing the sentinel."""
    device = occ.device
    rank = torch.cumsum(occ, 0, dtype=torch.int64) - 1
    true_count = (rank[-1] + 1).clamp_min(0)
    fits = occ & (rank < nb_cap - 1)
    count = true_count.clamp_max(nb_cap - 1)
    n_over = true_count - count
    table = torch.where(fits, rank, nb_cap - 1).to(torch.int32)
    flat = _arange(occ.shape[0], device)
    keys = _scatter_drop(nb_cap, rank, fits, flat, 0, torch.int64)
    coords = _unflatten_key(keys, g)
    valid = _arange(nb_cap, device) < count
    coords = torch.where(valid[:, None], coords, 0)
    return coords, table, count.to(torch.int32), n_over.to(torch.int32)


def blockify(
    coords: torch.Tensor,
    feats: torch.Tensor,
    valid: torch.Tensor,
    nb_cap: int,
    stride: int,
    res: int,
    num_batches: int,
) -> BlockGrid:
    """Scatter voxel rows into a BlockGrid (the per-voxel entry point).

    coords: int [N, 4] (batch, x, y, z) voxel coords (multiples of stride);
    feats: [N, C]; valid: [N] bool.
    """
    check_table_size(res, num_batches)
    g = grid_dim(res)
    c = coords.long()
    gxyz = c[:, 1:] // stride
    bxyz = gxyz // BS
    slot = gxyz % BS
    slot_id = (slot[:, 0] * BS + slot[:, 1]) * BS + slot[:, 2]
    in_rng = ((bxyz >= 0) & (bxyz < g)).all(dim=1)
    valid = valid & in_rng
    bkey = _flat_block_key(torch.cat([c[:, :1], bxyz], dim=1), g)
    bkey = torch.where(valid, bkey, 0)

    occ = _occupancy(num_batches * g ** 3, bkey, valid)
    bcoords, table, count, n_over = _compact_from_occupancy(occ, g, nb_cap)

    # voxels of overflowed blocks map to the sentinel row: drop them
    bidx = table.long()[bkey]
    ok = valid & (bidx < nb_cap - 1)
    pos = bidx * VOL + slot_id
    bf = _scatter_drop(nb_cap * VOL, pos, ok, feats, 0, feats.dtype)
    bm = _scatter_drop(nb_cap * VOL, pos, ok, True, False, torch.bool)
    return BlockGrid(
        coords=bcoords,
        feats=bf.reshape(nb_cap, VOL, feats.shape[-1]),
        mask=bm.reshape(nb_cap, VOL),
        table=table,
        count=count,
        dropped=n_over,
        stride=stride,
        res=res,
        num_batches=num_batches,
    )


def slot_coords(bg: BlockGrid) -> torch.Tensor:
    """Voxel coords of every slot: int32 [nb_cap, VOL, 4] (batch, x, y, z)."""
    local = _local_xyz(_arange(VOL, bg.device))  # [VOL, 3]
    xyz = (bg.coords[:, None, 1:].long() * BS + local[None]) * bg.stride
    b = bg.coords[:, None, :1].long().expand(bg.nb_cap, VOL, 1)
    return torch.cat([b, xyz], dim=-1).to(torch.int32)


def _local_xyz(slot: torch.Tensor) -> torch.Tensor:
    return torch.stack([slot // (BS * BS), (slot // BS) % BS, slot % BS],
                       dim=-1)


def extract(
    bg: BlockGrid, out_cap: int, with_feats: bool = True
) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """Compact occupied slots to rows: (coords int32 [out_cap, 4], feats
    [out_cap, C] or None, count).  Rows come out in block-scan order;
    unused rows read the sentinel row (zero coords and feats)."""
    flat_mask = (bg.mask & bg.valid[:, None]).reshape(-1)
    n_all = flat_mask.shape[0]
    pos = torch.cumsum(flat_mask, 0, dtype=torch.int64) - 1
    count = (pos[-1] + 1).clamp_min(0)
    sentinel = (bg.nb_cap - 1) * VOL
    idx = _scatter_drop(out_cap, pos, flat_mask, _arange(n_all, bg.device),
                        sentinel, torch.int64)
    row = idx // VOL
    bc = bg.coords[row].long()
    xyz = (bc[:, 1:] * BS + _local_xyz(idx % VOL)) * bg.stride
    out_c = torch.cat([bc[:, :1], xyz], dim=1).to(torch.int32)
    out_f = bg.feats.reshape(-1, bg.channels)[idx] if with_feats else None
    return out_c, out_f, count.clamp_max(out_cap).to(torch.int32)


def pack_occupancy(bg: BlockGrid) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bit-pack the valid occupancy for host-side extraction: (block xyz
    int32 [nb_cap, 3], slot bits uint8 [nb_cap, VOL // 8]).  Bit order is
    np.unpackbits(bitorder='big'), so `host_extract` reproduces
    `extract`'s block-scan order."""
    m = (bg.mask & bg.valid[:, None]).reshape(bg.nb_cap, VOL // 8, 8)
    w = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32,
                     device=bg.device)
    bits = (m.to(torch.int32) * w).sum(dim=-1).to(torch.uint8)
    return bg.coords[:, 1:].contiguous(), bits


_LOG_BS = int(BS).bit_length() - 1


def host_extract(bcoords: np.ndarray, bits: np.ndarray,
                 stride: int = 1) -> np.ndarray:
    """Host twin of `extract` (coords only): expand `pack_occupancy`
    output to int32 [n, 3] voxel coords in block-scan order, with the
    native bit-scan (native/coding.cpp::extract_coords)."""
    from pcgcv2_torch.codec import native

    return native.extract_coords(bcoords, np.asarray(bits), _LOG_BS, stride)


# ---------------------------------------------------------------------------
# Neighbourhood structure
# ---------------------------------------------------------------------------


def _offsets(lo: int, hi: int, device) -> torch.Tensor:
    """[n, n, n, 3] int64 offsets in [lo, hi) per axis, x-major."""
    d = torch.arange(lo, hi, dtype=torch.int64, device=device)
    return torch.stack(torch.meshgrid(d, d, d, indexing="ij"), dim=-1)


def _rows_at(bg: BlockGrid, base: torch.Tensor, xyz: torch.Tensor,
             ok: torch.Tensor) -> torch.Tensor:
    """Table rows of blocks (batch of `base`, xyz) where `ok`, else the
    sentinel row; xyz outside the grid counts as a miss."""
    g = bg.G
    ok = ok & ((xyz >= 0) & (xyz < g)).all(dim=-1)
    b = base[..., :1].long().expand(*xyz.shape[:-1], 1)
    key = _flat_block_key(torch.cat([b, xyz.clamp(0, g - 1)], dim=-1), g)
    rows = bg.table.long()[key]
    return torch.where(ok, rows, bg.nb_cap - 1).to(torch.int32)


def neighbor_rows(bg: BlockGrid) -> torch.Tensor:
    """int32 [nb_cap, 3, 3, 3] block row of each neighbour block; misses
    point at the all-zero sentinel row nb_cap - 1."""
    off = _offsets(-1, 2, bg.device)
    c = bg.coords[:, None, None, None, :]
    nxyz = c[..., 1:].long() + off[None]
    return _rows_at(bg, c, nxyz, bg.valid[:, None, None, None])


def _child_rows(bg: BlockGrid, parent_coords: torch.Tensor,
                parent_valid: torch.Tensor) -> torch.Tensor:
    """int32 [npb, 2, 2, 2] rows (in the finer grid `bg`) of the 8 child
    blocks of each parent block; misses -> bg.nb_cap - 1."""
    off = _offsets(0, 2, bg.device)
    c = parent_coords[:, None, None, None, :]
    cxyz = c[..., 1:].long() * 2 + off[None]
    return _rows_at(bg, c, cxyz, parent_valid[:, None, None, None])


# ---------------------------------------------------------------------------
# Scale changes (stride-2 down-conv / generative up-conv)
# ---------------------------------------------------------------------------


def _octants(x: torch.Tensor, nb: int) -> torch.Tensor:
    """[nb, BS, BS, BS, ...] -> [nb, 8, h, h, h, ...]: the 8 half-size
    octants of each block, x-major octant order (ox*4 + oy*2 + oz)."""
    h = BS // 2
    rest = x.shape[4:]
    y = x.reshape(nb, 2, h, 2, h, 2, h, *rest)
    perm = (0, 1, 3, 5, 2, 4, 6) + tuple(range(7, 7 + len(rest)))
    return y.permute(*perm).reshape(nb, 8, h, h, h, *rest)


def _from_octants(x: torch.Tensor, nb: int) -> torch.Tensor:
    """Inverse of `_octants`: [nb, 8, h, h, h, ...] -> [nb, VOL, ...]."""
    h = BS // 2
    rest = x.shape[5:]
    y = x.reshape(nb, 2, 2, 2, h, h, h, *rest)
    perm = (0, 1, 4, 2, 5, 3, 6) + tuple(range(7, 7 + len(rest)))
    return y.permute(*perm).reshape(nb, VOL, *rest)


def conv_down(
    bg: BlockGrid,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor],
    nb_cap_out: int,
    compute_dtype=None,
) -> BlockGrid:
    """Strided down-convolution (kernel 2, stride 2): stride s -> 2s.

    weight: [8, Cin, Cout] in x-major child-offset order.  The 2x2x2
    windows never straddle a block, so each block's [BS/2]^3 output is one
    reshape + matmul; the 8 child blocks of a parent then fill its octants.
    """
    cd = compute_dtype or COMPUTE_DTYPE
    nb, ch = bg.nb_cap, bg.channels
    cout = weight.shape[-1]
    check_table_size(bg.res // 2, bg.num_batches)
    gp = grid_dim(bg.res // 2)
    h = BS // 2

    # [nb, h, 2, h, 2, h, 2, ch] -> rows of 8*ch window values (dx, dy, dz, c)
    x = bg.feats.to(cd).reshape(nb, h, 2, h, 2, h, 2, ch)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(nb * h ** 3, 8 * ch)
    y = x @ weight.to(cd).reshape(8 * ch, cout)
    if bias is not None:
        y = y + bias.to(cd)
    y = y.to(bg.feats.dtype).reshape(nb, h ** 3, cout)
    m_down = bg.mask.reshape(nb, h, 2, h, 2, h, 2).any(6).any(4).any(2)

    pkey = _flat_block_key(
        torch.cat([bg.coords[:, :1], bg.coords[:, 1:] // 2], dim=1), gp)
    occ = _occupancy(bg.num_batches * gp ** 3, pkey, bg.valid)
    pcoords, ptable, pcount, p_over = _compact_from_occupancy(
        occ, gp, nb_cap_out)
    pvalid = _arange(nb_cap_out, bg.device) < pcount

    # each parent's 8 children (misses read the sentinel row, whose mask is
    # empty, so bias values there are zeroed by the mask below)
    rows = _child_rows(bg, pcoords, pvalid).reshape(-1).long()
    pf = _from_octants(y[rows].reshape(nb_cap_out, 8, h, h, h, cout),
                       nb_cap_out)
    pm = _from_octants(m_down.reshape(nb, h ** 3)[rows].reshape(
        nb_cap_out, 8, h, h, h), nb_cap_out)
    pm = pm & pvalid[:, None]
    pf = torch.where(pm[:, :, None], pf, 0)
    return BlockGrid(
        coords=pcoords, feats=pf, mask=pm, table=ptable, count=pcount,
        dropped=bg.dropped + p_over,
        stride=bg.stride * 2, res=bg.res // 2, num_batches=bg.num_batches,
    )


def _up_structure(bg: BlockGrid, nb_cap_out: int):
    """Output structure of the generative up-conv (stride 2s -> s).

    Parent octant o of block r becomes child block 2*coords + o (x-major
    octant order); only child blocks with an occupied slot become output
    blocks.  Returns (coords, table, count, overflow, src, mask): src
    [nb_cap_out] is the source (parent row * 8 + octant) of each output
    row, nb * 8 for rows without one (an appended all-empty octant), and
    mask is the output slot occupancy, re-masked to the valid rows.
    """
    nb = bg.nb_cap
    res_out = bg.res * 2
    check_table_size(res_out, bg.num_batches)
    g_out = grid_dim(res_out)
    h = BS // 2
    device = bg.device

    m_oct = _octants(bg.mask.reshape(nb, BS, BS, BS), nb).reshape(
        nb * 8, h ** 3)
    off = _offsets(0, 2, device).reshape(1, 8, 3)
    cxyz = bg.coords[:, None, 1:].long() * 2 + off  # [nb, 8, 3]
    in_rng = (cxyz < g_out).all(dim=-1).reshape(-1)
    cvalid = bg.valid.repeat_interleave(8) & m_oct.any(dim=1) & in_rng
    cb = bg.coords[:, None, :1].long().expand(nb, 8, 1)
    ckey = _flat_block_key(
        torch.cat([cb, cxyz.clamp_max(g_out - 1)], dim=-1), g_out
    ).reshape(-1)
    occ = _occupancy(bg.num_batches * g_out ** 3, ckey, cvalid)
    ocoords, otable, ocount, o_over = _compact_from_occupancy(
        occ, g_out, nb_cap_out)

    # overflowed children map to the sentinel row: they have no output row
    crow = otable.long()[ckey]
    ok = cvalid & (crow < nb_cap_out - 1)
    n_src = nb * 8
    src = _scatter_drop(nb_cap_out, crow, ok, _arange(n_src, device),
                        n_src, torch.int64)
    m_oct = torch.cat([m_oct, m_oct.new_zeros(1, h ** 3)])
    om = m_oct[src].reshape(nb_cap_out, h, 1, h, 1, h, 1)
    om = om.expand(nb_cap_out, h, 2, h, 2, h, 2).reshape(nb_cap_out, VOL)
    ovalid = _arange(nb_cap_out, device) < ocount
    return ocoords, otable, ocount, o_over, src, om & ovalid[:, None]


def conv_up_generative(
    bg: BlockGrid,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor],
    nb_cap_out: int,
    compute_dtype=None,
) -> BlockGrid:
    """Generative transposed conv (kernel 2, stride 2): stride 2s -> s.

    Every occupied voxel p emits its 8 children 2p + (dx, dy, dz), child
    (dx, dy, dz) getting weight[dx*4 + dy*2 + dz] (no kernel flip in this
    matmul form).  The output structure is `_up_structure`'s.  The child
    features are computed per OUTPUT row from its source octant (a gather,
    then one matmul), so nothing of the 8x-size candidate tensor exists
    beyond the output rows.
    """
    cd = compute_dtype or COMPUTE_DTYPE
    nb, ch = bg.nb_cap, bg.channels
    cout = weight.shape[-1]
    h = BS // 2
    ocoords, otable, ocount, o_over, src, om = _up_structure(bg, nb_cap_out)

    # rows without a source read an appended all-zero octant
    x_oct = _octants(bg.blocks, nb).reshape(nb * 8, h ** 3, ch)
    x_oct = torch.cat([x_oct, x_oct.new_zeros(1, h ** 3, ch)])
    w = weight.to(cd).permute(1, 0, 2).reshape(ch, 8 * cout)
    y = x_oct[src].to(cd).reshape(-1, ch) @ w  # [(row, voxel), (child, c)]
    y = y.reshape(nb_cap_out, h ** 3, 8, cout)
    if bias is not None:
        y = y + bias.to(cd)
    # (row, pu, pv, pw, dx, dy, dz, c) -> slot (2pu+dx, 2pv+dy, 2pw+dz)
    y = y.to(bg.feats.dtype).reshape(nb_cap_out, h, h, h, 2, 2, 2, cout)
    of = y.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(nb_cap_out, VOL, cout)
    of = torch.where(om[:, :, None], of, 0)
    return BlockGrid(
        coords=ocoords, feats=of, mask=om, table=otable, count=ocount,
        dropped=bg.dropped + o_over,
        stride=bg.stride // 2, res=bg.res * 2, num_batches=bg.num_batches,
    )


def conv_up_structure(bg: BlockGrid, nb_cap_out: int) -> BlockGrid:
    """Structure-only generative up-conv: the coords, mask, table, count
    and `dropped` of `conv_up_generative`, with 1-channel zero features
    (no conv, no weight).

    Lets the streamed decoder hold the whole candidate grid's structure
    (needed for the global top-k) without its features, which are the
    memory hog of a large frame.
    """
    ocoords, otable, ocount, o_over, _, om = _up_structure(bg, nb_cap_out)
    return BlockGrid(
        coords=ocoords,
        feats=torch.zeros(nb_cap_out, VOL, 1, dtype=torch.float32,
                          device=bg.device),
        mask=om, table=otable, count=ocount,
        dropped=bg.dropped + o_over,
        stride=bg.stride // 2, res=bg.res * 2, num_batches=bg.num_batches,
    )


# ---------------------------------------------------------------------------
# Top-k occupancy pruning
# ---------------------------------------------------------------------------


def _monotone_bits(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int64 in [0, 2^32) with the same total order (-0.0 sorts
    below +0.0), as the JAX package's uint32 radix keys."""
    b = x.to(torch.float32).contiguous().view(torch.int32).long() & 0xFFFFFFFF
    neg = (b >> 31) == 1
    return torch.where(neg, b ^ 0xFFFFFFFF, b | 0x80000000)


def topk_mask(
    bg: BlockGrid,
    scores: torch.Tensor,
    nums: torch.Tensor,
    live_mask: Optional[torch.Tensor] = None,
    group=None,
) -> torch.Tensor:
    """bool [nb_cap, VOL] — per-batch-item top-k over occupied slots.

    The same radix threshold search as the JAX package: 32 rounds of
    masked counts find the k-th largest score bit pattern per batch item;
    ties at the threshold are admitted in block-scan order.  k is clamped
    to the live slots, and k = 0 keeps nothing.  Counts are exact integers.

    `group` (a process group; JAX's `psum_axis`) makes the top-k global
    over its ranks: every round's counts and the count above the threshold
    are summed over the group, and the ties of lower ranks are ranked
    first, so the ranks must hold consecutive pieces of the block-scan
    order in rank order (x-slabs of one grid, as the spatial decode cuts
    them)."""
    nbatch = bg.num_batches
    device = bg.device
    live = bg.mask & bg.valid[:, None]
    if live_mask is not None:
        live = live & live_mask
    u = torch.where(live, _monotone_bits(scores.reshape(bg.nb_cap, VOL)), 0)
    brow = torch.where(bg.valid, bg.coords[:, 0].long(), nbatch)
    brow_c = brow.clamp(0, nbatch - 1)
    k = torch.as_tensor(nums, device=device).long().reshape(nbatch)

    def local_count(x):  # [nb, VOL] bool -> int64 [B] counts on this rank
        seg = torch.zeros(nbatch + 1, dtype=torch.int64, device=device)
        seg.index_add_(0, brow, x.sum(dim=1))
        return seg[:nbatch]

    def per_batch(x):  # ... over the group
        c = local_count(x)
        return c if group is None else collectives.all_reduce_sum(c, group)

    t = torch.zeros(nbatch, dtype=torch.int64, device=device)
    for i in range(32):
        cand = t | (1 << (31 - i))
        c = per_batch((u >= cand[brow_c][:, None]) & live)
        t = torch.where(c >= k, cand, t)
    t_row = t[brow_c][:, None]
    gt = (u > t_row) & live
    eq = (u == t_row) & live
    quota = (k - per_batch(gt)).clamp_min(0)
    # running rank of ties within each batch item (rows are batch-sorted)
    csum = torch.cumsum(eq.reshape(-1), 0, dtype=torch.int64)
    starts = torch.searchsorted(brow, _arange(nbatch, device)) * VOL
    base = torch.cat([csum.new_zeros(1), csum])[starts]
    rank = (csum - 1).reshape(bg.nb_cap, VOL) - base[brow_c][:, None]
    if group is not None:  # the ties of lower ranks come first
        all_eq = collectives.all_gather(local_count(eq), group)  # [n, B]
        me = torch.distributed.get_rank(group)
        rank = rank + all_eq[:me].sum(dim=0)[brow_c][:, None]
    admit = eq & (rank < quota[brow_c][:, None])
    return (gt | admit) & live


def prune(bg: BlockGrid, keep: torch.Tensor) -> BlockGrid:
    """Restrict occupancy to `keep` (mask update only)."""
    m = bg.mask & keep
    return bg.replace(mask=m, feats=torch.where(m[:, :, None], bg.feats, 0))


def compact(bg: BlockGrid, nb_cap_out: int) -> BlockGrid:
    """Drop empty blocks, re-rank the survivors (block-level, sorted)."""
    g = bg.G
    occ_block = bg.mask.any(dim=1) & bg.valid
    key = _flat_block_key(bg.coords, g)
    occ = _occupancy(bg.num_batches * g ** 3, key, occ_block)
    coords, table, count, c_over = _compact_from_occupancy(occ, g, nb_cap_out)
    valid = _arange(nb_cap_out, bg.device) < count
    rows = torch.where(valid, bg.table.long()[_flat_block_key(coords, g)],
                       bg.nb_cap - 1)
    mask = bg.mask[rows] & valid[:, None]
    feats = torch.where(mask[:, :, None], bg.feats[rows], 0)
    return BlockGrid(
        coords=coords, feats=feats, mask=mask, table=table, count=count,
        dropped=bg.dropped + c_over,
        stride=bg.stride, res=bg.res, num_batches=bg.num_batches,
    )


def compact_where(bg: BlockGrid, block_keep: torch.Tensor,
                  nb_cap_out: int) -> BlockGrid:
    """Restrict to the blocks where `block_keep` [nb_cap] holds, then
    compact.  The sub-grid keeps the full grid's coordinate space (res and
    table unchanged); only the kept blocks' features are carried.  The
    streamed decode cuts its x-slabs (plus a 1-block halo) this way."""
    m = bg.mask & (block_keep & bg.valid)[:, None]
    return compact(bg.replace(mask=m), nb_cap_out)


# ---------------------------------------------------------------------------
# Set membership (ground-truth occupancy lookups)
# ---------------------------------------------------------------------------


def isin(bg: BlockGrid, gt: BlockGrid) -> torch.Tensor:
    """bool [nb_cap, VOL]: slot-wise membership of bg's voxels in gt.

    Both grids must be at the same stride and res.  One block-level table
    gather per query block; a table miss reads gt's sentinel row, and the
    coords check keeps a miss from aliasing a real block."""
    if bg.res != gt.res or bg.stride != gt.stride:
        raise ValueError(
            f"isin needs grids at one scale: res {bg.res} / {gt.res}, "
            f"stride {bg.stride} / {gt.stride}")
    key = _flat_block_key(bg.coords, bg.G)
    rows = torch.where(bg.valid, gt.table.long()[key], gt.nb_cap - 1)
    same = (gt.coords[rows] == bg.coords).all(dim=-1) & (rows < gt.count)
    return bg.mask & gt.mask[rows] & (same & bg.valid)[:, None]
