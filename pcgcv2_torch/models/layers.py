"""Layers over BlockGrid (twin of pcgcv2_tpu/models/layers.py).

Each layer holds the checkpoint's parameters under the flax names
(`kernel`, `bias`) and layouts, and calls an op of ops/: 3^3 convs go
through the conv3 kernel wrapper, scale changes through the reshape +
matmul block ops, 1^3 convs are a plain per-slot matmul.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from pcgcv2_torch.ops import blocks as B
from pcgcv2_torch.ops.blocks import BlockGrid
from pcgcv2_torch.ops.conv3 import conv3, flip_weight, pack_weight, route


def relu(bg: BlockGrid) -> BlockGrid:
    return bg.with_feats(torch.relu(bg.feats))


class _Weighted(nn.Module):
    """A layer with `kernel` and `bias`, which it hands to its op in the
    compute dtype, cast once per dtype and again only when a parameter is
    replaced or written in place (an optimizer step), not on every call.
    Where a gradient is wanted (grad enabled, parameters requiring it) the
    cast is live and carries the gradient back to the parameters; under
    `torch.inference_mode` or `torch.no_grad` it is detached.  `_prepare`
    makes the op's other forms of the cast kernel under the same key.

    The key is read by Python, so a CUDA graph that replays the layer
    never sees it change: `forget_casts` before a capture makes the graph
    record the cast (and the packs) and redo them from the current
    parameters at every replay."""

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
        live = torch.is_grad_enabled() and (k.requires_grad
                                            or b.requires_grad)
        key = (cd, live, k.data_ptr(), k._version, b.data_ptr(), b._version)
        if key != self._cast_key:
            if not live:
                k, b = k.detach(), b.detach()
            kc = k.to(cd).contiguous()
            self._cast = (kc, b.to(cd).contiguous())
            self._prepared = self._prepare(kc.detach())
            self._cast_key = key
        return self._cast

    def _prepare(self, kernel: torch.Tensor):
        return None

    def forget_cast(self) -> None:
        """Drop the cached cast: the next `weights()` makes it anew."""
        self._cast_key = self._cast = self._prepared = None

    def init_weights(self, generator: torch.Generator) -> None:
        """Training from scratch, with the JAX package's initializers: the
        kernel uniform in +-sqrt(6 / fan_in) (flax variance_scaling(2.0,
        "fan_in", "uniform"), fan_in the product of all but the last
        dimension), the bias zero."""
        fan_in = math.prod(self.kernel.shape[:-1])
        limit = math.sqrt(6.0 / fan_in)
        with torch.no_grad():
            u = torch.rand(self.kernel.shape, generator=generator,
                           device=self.kernel.device)
            self.kernel.copy_((2 * u - 1) * limit)
            self.bias.zero_()


class BConv3(_Weighted):
    """3^3 stride-1 sparse conv with a prebuilt block-neighbour map."""

    def __init__(self, ci: int, co: int):
        super().__init__((3, 3, 3, ci, co), co)
        self._flip = None

    def _prepare(self, kernel: torch.Tensor):
        self._flip = None  # packed again when a backward first needs it
        ci, co = kernel.shape[3], kernel.shape[4]
        if route(ci, co, kernel.dtype) == "tc":
            return pack_weight(kernel)
        return None

    def packed(self):
        """The cast kernel as the tensor-core conv3 takes it (`pack_weight`:
        the kernel's shared-memory layout, f32 split into its TF32 hi and
        lo parts) where it runs there (ci and co in {1, 4, 8, 16, 32, 64}),
        else None."""
        self.weights()
        return self._prepared

    def packed_flip(self):
        """`pack_weight(flip_weight(kernel))` of the cast kernel, the
        weight of the input gradient, where the tensor cores take it (else
        None): packed once per cast, so once per optimizer step."""
        kc = self.weights()[0].detach()
        ci, co = kc.shape[3], kc.shape[4]
        if self._flip is None and route(co, ci, kc.dtype) == "tc":
            self._flip = pack_weight(flip_weight(kc))
        return self._flip

    def forget_cast(self) -> None:
        super().forget_cast()
        self._flip = None

    def forward(self, bg: BlockGrid, nbrs: torch.Tensor) -> BlockGrid:
        k, b = self.weights()
        flip = self.packed_flip() if torch.is_grad_enabled() else None
        return conv3(bg, nbrs, k, b, packed=self._prepared, packed_flip=flip)


def forget_casts(model: nn.Module) -> None:
    """`forget_cast` on every weighted layer of `model`."""
    for m in model.modules():
        if isinstance(m, _Weighted):
            m.forget_cast()


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
