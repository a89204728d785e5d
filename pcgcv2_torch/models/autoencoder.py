"""Three-scale sparse autoencoder (twin of
pcgcv2_tpu/models/autoencoder.py).

Encoder: per scale [3^3 conv -> 2x down-conv -> IRN blocks], channels
(1,16,32,64,32,8); returns the bottleneck plus the two intermediate grids
whose voxel counts are the decoder's top-k targets.

Decoder: per stage [generative 2x up-conv -> 3^3 conv -> IRN blocks ->
1-channel occupancy head -> top-k prune -> drop empty blocks], channels
(8,64,32,16).  In training the prune keeps top-k union ground truth, so
gradients reach both false positives and false negatives.  Capacities come
from the BlockPlan passed at call time.

With `remat` (ModelConfig.remat_training), training runs each encoder
scale and each decoder stage under torch.utils.checkpoint: only the grids
between them are kept for the backward, the rest is recomputed.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from pcgcv2_torch.config import BlockPlan
from pcgcv2_torch.models.layers import (
    BConv3,
    BConvDown,
    BGenUp,
    BInceptionResNet,
    relu,
)
from pcgcv2_torch.ops import blocks as B
from pcgcv2_torch.ops.blocks import BlockGrid


def _remat(fn, *args):
    """fn(*args) with its interior activations recomputed in the backward
    (non-reentrant: the arguments and results are BlockGrids).  The scales
    and stages draw no random numbers (the training noise is drawn after
    the encoder), so the RNG state is not stashed: exact, and a CUDA graph
    may capture the step, which reading the CUDA RNG state would refuse."""
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


class Encoder(nn.Module):
    def __init__(self, channels: Sequence[int] = (1, 16, 32, 64, 32, 8),
                 blocks: int = 3, remat: bool = True):
        super().__init__()
        ch = tuple(channels)
        self.blocks = blocks
        self.remat = remat
        for s in range(3):
            # scale s reads the input (s = 0) or the previous IRN stack
            ci = ch[0] if s == 0 else ch[s + 1]
            setattr(self, f"conv{s}", BConv3(ci, ch[s + 1]))
            setattr(self, f"down{s}", BConvDown(ch[s + 1], ch[s + 2]))
            for i in range(blocks):
                setattr(self, f"block{s}_{i}", BInceptionResNet(ch[s + 2]))
        self.conv3 = BConv3(ch[4], ch[5])

    def _scale(self, s: int, out: BlockGrid, plan: BlockPlan) -> BlockGrid:
        """One encoder scale: 3^3 conv -> 2x down -> IRN stack."""
        out = getattr(self, f"conv{s}")(out, B.neighbor_rows(out))
        out = relu(getattr(self, f"down{s}")(relu(out), plan.nb[s + 1]))
        nbrs = B.neighbor_rows(out)
        for i in range(self.blocks):
            out = getattr(self, f"block{s}_{i}")(out, nbrs)
        return out

    def forward(self, x: BlockGrid, plan: BlockPlan, training: bool = False):
        outs: List[BlockGrid] = []
        out = x
        for s in range(3):
            if training and self.remat:
                out = _remat(self._scale, s, out, plan)
            else:
                out = self._scale(s, out, plan)
            outs.append(out)
        out2 = self.conv3(outs[2], B.neighbor_rows(outs[2]))
        # coarse -> fine, like the reference's [out2, out1, out0]
        return out2, outs[1], outs[0]


class Decoder(nn.Module):
    def __init__(self, channels: Sequence[int] = (8, 64, 32, 16),
                 blocks: int = 3, remat: bool = True):
        super().__init__()
        ch = tuple(channels)
        self.blocks = blocks
        self.remat = remat
        for s in range(3):
            setattr(self, f"up{s}", BGenUp(ch[s], ch[s + 1]))
            setattr(self, f"conv{s}", BConv3(ch[s + 1], ch[s + 1]))
            for i in range(blocks):
                setattr(self, f"block{s}_{i}", BInceptionResNet(ch[s + 1]))
            setattr(self, f"conv{s}_cls", BConv3(ch[s + 1], 1))

    def stage(self, s: int, bg: BlockGrid,
              up_cap: int) -> Tuple[BlockGrid, BlockGrid]:
        """One decoder stage: generative up-conv -> 3^3 conv -> IRN stack
        -> occupancy head.  Returns (features, cls logits) on the pre-prune
        candidate grid."""
        out = relu(getattr(self, f"up{s}")(bg, up_cap))
        nbrs = B.neighbor_rows(out)
        out = relu(getattr(self, f"conv{s}")(out, nbrs))
        for i in range(self.blocks):
            out = getattr(self, f"block{s}_{i}")(out, nbrs)
        cls = getattr(self, f"conv{s}_cls")(out, nbrs)
        return out, cls

    def forward(self, y: BlockGrid, nums_list: Sequence[torch.Tensor],
                plan: BlockPlan,
                gt_list: Optional[Sequence[BlockGrid]] = None,
                training: bool = False):
        """Returns (pre-prune cls-logit grids per stage, final pruned grid).
        In training `gt_list` holds the ground-truth grids (coarse to fine)
        whose voxels the prune keeps beside the top-k."""
        if training and gt_list is None:
            raise ValueError("the training prune needs the ground truth")
        out = y
        out_cls_list: List[BlockGrid] = []
        for s in range(3):
            cls, out = self.pruned_stage(
                s, out, nums_list[s], plan,
                gt_list[s] if training else None, training)
            out_cls_list.append(cls)
        return out_cls_list, out

    def pruned_stage(self, s: int, bg: BlockGrid, nums: torch.Tensor,
                     plan: BlockPlan, gt: Optional[BlockGrid] = None,
                     training: bool = False) -> Tuple[BlockGrid, BlockGrid]:
        """`stage`, then keep the top `nums` logits (in training also the
        voxels of `gt`) and drop the blocks left empty: (cls logits,
        pruned grid at cap plan.dec_nb[s])."""
        if training and self.remat:
            out, cls = _remat(self.stage, s, bg, plan.up_cap(s))
        else:
            out, cls = self.stage(s, bg, plan.up_cap(s))
        keep = B.topk_mask(out, cls.feats[:, :, 0], nums)
        if gt is not None:
            keep = keep | B.isin(out, gt)
        return cls, B.compact(B.prune(out, keep), plan.dec_nb[s])
