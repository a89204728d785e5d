"""Fully-factorized entropy bottleneck (twin of
pcgcv2_tpu/models/entropy.py; Balle et al. 2018, arXiv:1802.01436).

A per-channel monotone MLP models the cumulative density; the likelihood
of an integer bin is the CDF difference at x +- 0.5 with the sign trick.
Training quantizes by additive U(-0.5, 0.5) noise, evaluation by rounding
with a straight-through gradient; the likelihood is clamped to a lower
bound whose gradient passes where the input is above the bound or the
gradient pushes it up.  The codec itself uses `pmf_host`, a float64 numpy
twin that both codec sides evaluate identically, so the quantized CDF is
bitstream-consistent across the two packages.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LIKELIHOOD_BOUND = 1e-9


class _RoundSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _LowerBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.clamp_min(x, LIKELIHOOD_BOUND)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where((x >= LIKELIHOOD_BOUND) | (g < 0), g, 0)


def round_ste(x: torch.Tensor) -> torch.Tensor:
    """Round half to even with a straight-through gradient."""
    return _RoundSTE.apply(x)


def lower_bound(x: torch.Tensor) -> torch.Tensor:
    """max(x, LIKELIHOOD_BOUND); the gradient passes where x is at least
    the bound or the gradient is negative (pushes x back up), else 0."""
    return _LowerBound.apply(x)


class EntropyBottleneck(nn.Module):
    """Parameters matrix_i [C, out, in], bias_i / factor_i [C, out, 1].

    At construction matrix_i holds the JAX package's constant initial value
    log(expm1(1 / scale / dims[i+1])), scale = init_scale ** (1 / layers),
    and factor_i zero; `init_weights` draws bias_i uniform in (-0.5, 0.5)
    for training from scratch (a checkpoint load replaces all three)."""

    def __init__(self, channels: int, filters: Sequence[int] = (3, 3, 3),
                 init_scale: float = 8.0):
        super().__init__()
        self.channels = channels
        dims = (1,) + tuple(filters) + (1,)
        self.n_layers = len(filters) + 1
        scale = init_scale ** (1.0 / self.n_layers)
        for i in range(self.n_layers):
            shape_m = (channels, dims[i + 1], dims[i])
            shape_b = (channels, dims[i + 1], 1)
            init_m = float(np.log(np.expm1(1.0 / scale / dims[i + 1])))
            setattr(self, f"matrix_{i}",
                    nn.Parameter(torch.full(shape_m, init_m)))
            setattr(self, f"bias_{i}", nn.Parameter(torch.zeros(shape_b)))
            setattr(self, f"factor_{i}", nn.Parameter(torch.zeros(shape_b)))

    def init_weights(self, generator: torch.Generator) -> None:
        """bias_i uniform in (-0.5, 0.5) from `generator`."""
        with torch.no_grad():
            for i in range(self.n_layers):
                b = getattr(self, f"bias_{i}")
                u = torch.rand(b.shape, generator=generator, device=b.device)
                b.copy_(u - 0.5)

    def _logits_cumulative(self, inputs: torch.Tensor) -> torch.Tensor:
        """inputs [C, 1, N] -> logits of the cumulative density."""
        logits = inputs
        for i in range(self.n_layers):
            m = getattr(self, f"matrix_{i}")
            b = getattr(self, f"bias_{i}")
            f = getattr(self, f"factor_{i}")
            logits = torch.matmul(F.softplus(m), logits) + b
            logits = logits + torch.tanh(f) * torch.tanh(logits)
        return logits

    def likelihood(self, x: torch.Tensor) -> torch.Tensor:
        """P(round(x) = bin): x [N, C] -> [N, C] (float32)."""
        v = x.to(torch.float32).T[:, None, :]
        lo = self._logits_cumulative(v - 0.5)
        hi = self._logits_cumulative(v + 0.5)
        sign = -torch.sign(lo + hi).detach()
        lh = torch.abs(torch.sigmoid(sign * hi) - torch.sigmoid(sign * lo))
        return lh[:, 0, :].T

    def quantize(self, x: torch.Tensor, mode: str = "symbols",
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """'noise' (training): x + U(-0.5, 0.5), drawn from `generator` or
        given as `noise` (same shape as x); 'symbols': round half to even
        with a straight-through gradient (the codec's quantizer)."""
        if mode == "noise":
            if noise is None:
                if generator is None:
                    raise ValueError("noise quantization needs a generator "
                                     "or the noise")
                noise = torch.rand(x.shape, generator=generator,
                                   device=x.device, dtype=x.dtype) - 0.5
            return x + noise
        if mode == "symbols":
            return round_ste(x)
        raise ValueError(f"unknown quantize mode {mode!r}")

    def forward(self, x: torch.Tensor, mode: str = "noise",
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None):
        """(quantized x, lower-bounded likelihood [N, C])."""
        y = self.quantize(x, mode, generator, noise)
        return y, lower_bound(self.likelihood(y))

    def pmf(self, min_v: float, max_v: int) -> torch.Tensor:
        """[C, max_v + 1] likelihoods over the grid min_v + [0 .. max_v],
        clamped to the likelihood bound."""
        dev = self.matrix_0.device
        grid = float(min_v) + torch.arange(
            max_v + 1, dtype=torch.float32, device=dev)
        x = grid[:, None].expand(max_v + 1, self.channels)
        return self.likelihood(x).clamp_min(LIKELIHOOD_BOUND).T


def pmf_host(eb_params, min_v: float, num_symbols: int) -> np.ndarray:
    """Host float64 symbol-grid PMF for the codec: [C, S] >= the bound.

    eb_params: {matrix_i, bias_i, factor_i} numpy leaves."""
    mats = sorted(k for k in eb_params if k.startswith("matrix_"))
    channels = np.asarray(eb_params["bias_0"]).shape[0]
    grid = min_v + np.arange(num_symbols, dtype=np.float64)  # [S]
    x = np.broadcast_to(grid, (channels, 1, num_symbols))  # [C, 1, S]

    def logits_cumulative(v):
        logits = v
        for i in range(len(mats)):
            m = np.asarray(eb_params[f"matrix_{i}"], dtype=np.float64)
            b = np.asarray(eb_params[f"bias_{i}"], dtype=np.float64)
            f = np.asarray(eb_params[f"factor_{i}"], dtype=np.float64)
            logits = np.einsum("cij,cjn->cin", np.logaddexp(0.0, m), logits)
            logits = logits + b
            logits = logits + np.tanh(f) * np.tanh(logits)
        return logits

    lo = logits_cumulative(x - 0.5)
    hi = logits_cumulative(x + 0.5)
    sign = -np.sign(lo + hi)

    def sigmoid(z):
        return 0.5 * (1.0 + np.tanh(0.5 * z))

    p = np.abs(sigmoid(sign * hi) - sigmoid(sign * lo))[:, 0, :]  # [C, S]
    return np.clip(p, LIKELIHOOD_BOUND, None)
