"""Layers over BlockGrid (twin of pcgcv2_tpu/models/layers.py).

Each layer holds the checkpoint's parameters under the flax names
(`kernel`, `bias`) and layouts, and calls an op of ops/: 3^3 convs go
through the conv3 kernel wrapper, scale changes through the reshape +
matmul block ops, 1^3 convs are a plain per-slot matmul.
"""

from __future__ import annotations

import torch
from torch import nn

from pcgcv2_torch.ops import blocks as B
from pcgcv2_torch.ops.blocks import BlockGrid
from pcgcv2_torch.ops.conv3 import conv3, pack_weight, route


def relu(bg: BlockGrid) -> BlockGrid:
    return bg.with_feats(torch.relu(bg.feats))


class _Weighted(nn.Module):
    """A layer with `kernel` and `bias`, which it hands to its op in the
    compute dtype: cast once per dtype (and again only when a parameter is
    replaced or written in place), not on every call.  `_prepare` makes the
    op's other form of the cast kernel under the same key."""

    def __init__(self, kernel_shape, co: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(*kernel_shape))
        self.bias = nn.Parameter(torch.zeros(co))
        self._cast_key = None
        self._cast = None
        self._prepared = None

    def weights(self):
        cd = B.COMPUTE_DTYPE
        k, b = self.kernel, self.bias
        key = (cd, k.data_ptr(), k._version, b.data_ptr(), b._version)
        if key != self._cast_key:
            kc = k.detach().to(cd).contiguous()
            self._cast = (kc, b.detach().to(cd).contiguous())
            self._prepared = self._prepare(kc)
            self._cast_key = key
        return self._cast

    def _prepare(self, kernel: torch.Tensor):
        return None


class BConv3(_Weighted):
    """3^3 stride-1 sparse conv with a prebuilt block-neighbour map."""

    def __init__(self, ci: int, co: int):
        super().__init__((3, 3, 3, ci, co), co)

    def _prepare(self, kernel: torch.Tensor):
        ci, co = kernel.shape[3], kernel.shape[4]
        if route(ci, co, kernel.dtype) == "tc":
            return pack_weight(kernel)
        return None

    def packed(self):
        """The cast kernel in mma fragment order (in f32, split into its
        TF32 hi and lo parts) where the tensor-core conv3 takes it (ci and
        co in {1, 4, 8, 16, 32, 64}), else None."""
        self.weights()
        return self._prepared

    def forward(self, bg: BlockGrid, nbrs: torch.Tensor) -> BlockGrid:
        k, b = self.weights()
        return conv3(bg, nbrs, k, b, packed=self._prepared)


class BConv1(_Weighted):
    """1^3 conv: per-slot dense projection."""

    def __init__(self, ci: int, co: int):
        super().__init__((1, ci, co), co)

    def forward(self, bg: BlockGrid) -> BlockGrid:
        k, b = self.weights()
        out = (bg.feats.reshape(-1, bg.channels).to(k.dtype) @ k[0]) + b
        return bg.with_feats(
            out.to(bg.feats.dtype).reshape(bg.nb_cap, B.VOL, -1))


class BConvDown(_Weighted):
    """2^3 stride-2 down-convolution; weight [8, ci, co]."""

    def __init__(self, ci: int, co: int):
        super().__init__((8, ci, co), co)

    def forward(self, bg: BlockGrid, out_cap: int) -> BlockGrid:
        return B.conv_down(bg, *self.weights(), out_cap)


class BGenUp(_Weighted):
    """Generative transposed conv, kernel 2 stride 2 (all 8 children)."""

    def __init__(self, ci: int, co: int):
        super().__init__((8, ci, co), co)

    def forward(self, bg: BlockGrid, out_cap: int) -> BlockGrid:
        return B.conv_up_generative(bg, *self.weights(), out_cap)


class BInceptionResNet(nn.Module):
    """Two-branch inception residual block.

    branch0: 3^3 (ch -> ch/4) -> relu -> 3^3 (-> ch/2)
    branch1: 1^3 (ch -> ch/4) -> relu -> 3^3 (-> ch/4) -> relu -> 1^3 (-> ch/2)
    output : concat(branch0, branch1) + residual
    """

    def __init__(self, ch: int):
        super().__init__()
        self.conv0_0 = BConv3(ch, ch // 4)
        self.conv0_1 = BConv3(ch // 4, ch // 2)
        self.conv1_0 = BConv1(ch, ch // 4)
        self.conv1_1 = BConv3(ch // 4, ch // 4)
        self.conv1_2 = BConv1(ch // 4, ch // 2)

    def forward(self, bg: BlockGrid, nbrs: torch.Tensor) -> BlockGrid:
        out0 = self.conv0_1(relu(self.conv0_0(bg, nbrs)), nbrs)
        out1 = self.conv1_1(relu(self.conv1_0(bg)), nbrs)
        out1 = self.conv1_2(relu(out1))
        merged = torch.cat([out0.feats, out1.feats], dim=-1)
        return bg.with_feats(merged + bg.feats)
