"""PCCModel — encoder + entropy bottleneck + decoder: the training forward
and the codec's entry points (twin of pcgcv2_tpu/models/pcc.py).

The module holds the weights only; block capacities come from the
BlockPlan each call receives (the JAX module baked it in as a static
attribute because jit needs static shapes).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn

from pcgcv2_torch.config import BlockPlan, ModelConfig
from pcgcv2_torch.models.autoencoder import Decoder, Encoder
from pcgcv2_torch.models.entropy import EntropyBottleneck
from pcgcv2_torch.ops import blocks as B
from pcgcv2_torch.ops.blocks import BlockGrid


class PCCModel(nn.Module):
    def __init__(self, config: ModelConfig = ModelConfig(),
                 num_batches: int = 1):
        super().__init__()
        self.config = config
        self.num_batches = num_batches
        self.encoder = Encoder(config.enc_channels, config.blocks_per_scale,
                               remat=config.remat_training)
        self.decoder = Decoder(config.dec_channels, config.blocks_per_scale,
                               remat=config.remat_training)
        self.entropy_bottleneck = EntropyBottleneck(
            config.enc_channels[-1], config.entropy_filters,
            config.entropy_init_scale)

    def init_weights(self, generator: torch.Generator) -> None:
        """Random initialization for training from scratch, with the JAX
        package's initializers (layers.py, entropy.py), drawn from
        `generator` layer by layer in module order."""
        for m in self.modules():
            if m is not self and hasattr(m, "init_weights"):
                m.init_weights(generator)

    def blockify(self, coords: torch.Tensor, valid: torch.Tensor,
                 plan: BlockPlan, dtype=torch.float32) -> BlockGrid:
        """Voxel rows -> full-resolution BlockGrid with feats = mask, stored
        in `dtype` (the activation storage dtype of the whole pyramid)."""
        return B.blockify(
            coords, valid[:, None].to(dtype), valid, plan.nb[0], stride=1,
            res=plan.res, num_batches=self.num_batches,
        )

    def forward(self, coords: torch.Tensor, valid: torch.Tensor,
                plan: BlockPlan, training: bool = True,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        """The training / evaluation forward: blockify (f32 storage) ->
        encoder -> noise quantization (training; from `generator`, or the
        given `noise` [nb_cap * VOL, C]) or rounding (evaluation) ->
        decoder.  Unoccupied bottleneck slots get likelihood 1 (0 bits).
        Returns the keys of the JAX package's __call__: out, out_cls_list,
        prior, likelihood, ground_truth_list, nums_list."""
        x = self.blockify(coords, valid, plan)
        y, out1, out0 = self.encoder(x, plan, training)
        ground_truth_list = [out1, out0, x]
        nums_list = [gt.voxels_per_batch() for gt in ground_truth_list]
        y_f, likelihood = self.entropy_bottleneck(
            y.feats.reshape(-1, y.channels),
            "noise" if training else "symbols", generator, noise)
        likelihood = torch.where(y.mask.reshape(-1, 1), likelihood, 1.0)
        y_q = y.with_feats(y_f.reshape(y.nb_cap, B.VOL, y.channels))
        out_cls_list, out = self.decoder(
            y_q, nums_list, plan,
            ground_truth_list if training else None, training)
        return {
            "out": out,
            "out_cls_list": out_cls_list,
            "prior": y_q,
            "likelihood": likelihood.reshape(y.nb_cap, B.VOL, y.channels),
            "ground_truth_list": ground_truth_list,
            "nums_list": nums_list,
        }

    def encode_fn(self, coords: torch.Tensor, valid: torch.Tensor,
                  plan: BlockPlan):
        """Analysis transform: (bottleneck grid, per-scale ground-truth
        voxel counts, input voxel count).  `y.dropped` accumulates any
        capacity overflow; the codec checks it before writing a stream."""
        x = self.blockify(coords, valid, plan, dtype=B.COMPUTE_DTYPE)
        y, out1, out0 = self.encoder(x, plan)
        nums = [gt.voxels_per_batch() for gt in (out1, out0, x)]
        return y, nums, x.voxel_count()

    def decode_fn(self, y_q: BlockGrid, nums_list: Sequence[torch.Tensor],
                  plan: BlockPlan) -> BlockGrid:
        """Synthesis transform from a decoded bottleneck."""
        return self.decoder(y_q, nums_list, plan)[1]

    def decode_coarse_fn(self, y_q: BlockGrid,
                         nums_list: Sequence[torch.Tensor],
                         plan: BlockPlan) -> BlockGrid:
        """Decoder stages 0-1 only (strides 8 -> 4 -> 2): the small grids.
        The streamed decode runs these whole and cuts only the final
        stage, whose candidate features are the memory hog."""
        out = y_q
        for s in range(2):
            _, out = self.decoder.pruned_stage(s, out, nums_list[s], plan)
        return out

    def decode_stage2_fn(self, bg: BlockGrid, up_cap: int) -> BlockGrid:
        """Final decoder stage on a (sub-)grid: the cls-logit grid on the
        pre-prune candidate blocks.  The stage's receptive field is 8
        voxels, so a 1-block input halo makes the interior logits exact."""
        return self.decoder.stage(2, bg, up_cap)[1]
