"""Rate-distortion loss and occupancy classification metrics (twin of
pcgcv2_tpu/train/loss.py), mask-aware dense math on the block grids."""

from __future__ import annotations

from typing import Dict, List

import torch

from pcgcv2_torch.ops import blocks as B
from pcgcv2_torch.ops.blocks import BlockGrid

_LN2 = 0.6931471805599453


def bce_bits(cls_bg: BlockGrid, gt: BlockGrid) -> torch.Tensor:
    """Summed binary cross-entropy, in bits, of the occupancy logits of
    `cls_bg` against membership in `gt`, over the live slots."""
    live = cls_bg.mask & cls_bg.valid[:, None]
    target = B.isin(cls_bg, gt).to(torch.float32)
    logits = cls_bg.feats[:, :, 0].to(torch.float32)
    per = (torch.clamp_min(logits, 0) - logits * target
           + torch.log1p(torch.exp(-torch.abs(logits))))
    return torch.where(live, per, 0.0).sum() / _LN2


def rate_bits(likelihood: torch.Tensor) -> torch.Tensor:
    """Total rate in bits; unoccupied slots carry likelihood 1 (0 bits)."""
    return -torch.log2(likelihood).sum()


def rd_loss(out_set: Dict, alpha: float, beta: float,
            normalize: str = "train") -> Dict[str, torch.Tensor]:
    """alpha * sum over scales of BCE + beta * bpp.

    normalize='train' divides each scale's BCE by that scale's candidate
    voxel count, 'test' by the input voxel count (the reference's
    asymmetry, kept)."""
    x = out_set["ground_truth_list"][-1]
    n_in = torch.clamp_min(x.voxel_count().to(torch.float32), 1.0)
    bces: List[torch.Tensor] = []
    for cls_bg, gt in zip(out_set["out_cls_list"],
                          out_set["ground_truth_list"]):
        denom = (torch.clamp_min(cls_bg.voxel_count().to(torch.float32), 1.0)
                 if normalize == "train" else n_in)
        bces.append(bce_bits(cls_bg, gt) / denom)
    bce = sum(bces)
    bpp = rate_bits(out_set["likelihood"]) / n_in
    return {
        "loss": alpha * bce + beta * bpp,
        "bce": bce,
        "bces": torch.stack(bces),
        "bpp": bpp,
    }


def cls_metrics(cls_bg: BlockGrid, gt: BlockGrid) -> torch.Tensor:
    """[precision, recall, IoU] of the top-k predicted occupancy against
    the ground truth, k the ground truth's voxel count per batch item."""
    live = cls_bg.mask & cls_bg.valid[:, None]
    real = B.isin(cls_bg, gt)
    pred = B.topk_mask(cls_bg, cls_bg.feats[:, :, 0], gt.voxels_per_batch())
    tp = (pred & real).sum().to(torch.float32)
    fp = (pred & ~real).sum().to(torch.float32)
    fn = (~pred & real & live).sum().to(torch.float32)
    precision = tp / (tp + fp + 1e-7)
    recall = tp / (tp + fn + 1e-7)
    iou = tp / (tp + fp + fn + 1e-7)
    return torch.stack([precision, recall, iou])
