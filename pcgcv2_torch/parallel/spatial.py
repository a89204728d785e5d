"""Spatially sharded decode over a process group (twin of
pcgcv2_tpu/parallel/spatial.py).

Overlap decomposition, as in the JAX package: the final decoder stage's
receptive field is 8 voxels, within one block at either block side (16^3,
or exactly one at 8^3), so each rank decodes its x-slab of the stride-2
blocks with a 1-block halo and no communication inside the conv stack.  Stages 0-1 (small grids) are decoded whole on every
rank.  Communication happens three times per frame:

  1. none for the replicated bottleneck and coarse stages;
  2. the global top-k: each of the 32 radix rounds' per-batch counts and the
     count above the threshold are all-reduced, and the per-rank tie counts
     all-gathered (ops/blocks.py::topk_mask(group=...));
  3. each rank extracts its interior survivors into `local_cap` rows, and
     the rows and counts are all-gathered (shard_map's out_specs P(axis)).

Rank r owns the stride-2 x-blocks [r * g_in // n, (r + 1) * g_in // n):
equal x ranges, as the JAX package cuts them (the single-card streamed
decode, codec/coder.py::Coder._decode_streamed, cuts equal block counts).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from pcgcv2_torch.config import BlockPlan
from pcgcv2_torch.ops import blocks as B
from pcgcv2_torch.ops import collectives as C
from pcgcv2_torch.ops.blocks import resolve_device


def spatial_caps(plan: BlockPlan, n: int, out_cap: int):
    """(local_cap, sub_in_cap, sub_cand_cap) of an n-rank decode: the JAX
    package's formulas (spatial.py:71-73), each clamped to the whole
    frame's cap (out_cap, the stage-1 cap dec_nb[1], the candidate cap
    up_cap(2)) as `_decode_streamed` clamps its slab caps.  A slab's blocks
    are a subset of the whole grid's, so the clamp changes no result while
    nothing is dropped; at n = 2 on a vox11 plan JAX's caps are 2x and 4x
    the whole grid's."""
    sub_in = max(32, plan.dec_nb[1] * 4 // n)
    return (min(out_cap, max(256, -(-out_cap // n) * 4)),
            min(plan.dec_nb[1], sub_in),
            min(plan.up_cap(2), plan.up_factors[2] * sub_in))


def make_spatial_decode_fn(model, plan: BlockPlan, group, out_cap: int,
                           device="cuda"):
    """Build this rank's part of the sharded decode.

    model/plan: as in the single-frame codec (num_batches 1).  Returns
    fn(rows, feats, valid, nums) -> (coords int32 [n * local_cap, 4],
    counts int32 [n], dropped), the same on every rank: rows / feats /
    valid are the whole padded bottleneck (stride-8 voxel rows, features,
    validity), nums the 3 per-scale point counts (rho already applied to
    nums[2]).  Rank r's interior survivors fill segment r in block-scan
    order.  Runs on the card unless `device` asks for the CPU."""
    dev = resolve_device(device)
    rank, n = dist.get_rank(group), dist.get_world_size(group)
    local_cap, sub_in_cap, sub_cand_cap = spatial_caps(plan, n, out_cap)
    res_y = max(1, plan.res // 8)

    def fn(rows, feats, valid, nums):
        nums = torch.as_tensor(nums, device=dev).to(torch.int32)
        y = B.blockify(rows.to(dev), feats.to(dev, B.COMPUTE_DTYPE),
                       valid.to(dev), plan.nb[3], stride=8, res=res_y,
                       num_batches=1)
        out = model.decode_coarse_fn(y, [nums[0:1], nums[1:2]], plan)
        g_in = B.grid_dim(out.res)
        ia, ib = rank * g_in // n, (rank + 1) * g_in // n
        bx = out.coords[:, 1]
        sub = B.compact_where(out, (bx >= ia - 1) & (bx < ib + 1),
                              sub_in_cap)
        cls = model.decode_stage2_fn(sub, sub_cand_cap)
        del sub
        cx = cls.coords[:, 1]
        interior = ((cx >= 2 * ia) & (cx < 2 * ib) & cls.valid)[:, None]
        keep = B.topk_mask(cls, cls.feats[:, :, 0].to(torch.float32),
                           nums[2:3], live_mask=interior, group=group)
        oc, _, cnt = B.extract(B.prune(cls, keep & interior), local_cap,
                               with_feats=False)
        # every sub-grid inherits out.dropped; sum only the slabs' own
        own = (cls.dropped - out.dropped).reshape(1).to(torch.int64)
        dropped = out.dropped + C.all_reduce_sum(own, group)[0]
        return (C.all_gather(oc, group).reshape(n * local_cap, 4),
                C.all_gather(cnt.reshape(1), group).reshape(n),
                dropped)

    return fn


def assemble_decoded(coords, counts, n: int) -> np.ndarray:
    """Host side: the stacked per-rank rows -> one [N, 3] xyz array, the
    segments concatenated in slab order (global block-scan order)."""
    coords = np.asarray(coords)
    counts = np.asarray(counts).reshape(-1)
    local_cap = coords.shape[0] // n
    return np.concatenate([coords[r * local_cap:r * local_cap
                                  + int(counts[r]), 1:] for r in range(n)])
