"""Fully-factorized entropy bottleneck, inference parts (twin of
pcgcv2_tpu/models/entropy.py; Balle et al. 2018, arXiv:1802.01436).

A per-channel monotone MLP models the cumulative density; the likelihood
of an integer bin is the CDF difference at x +- 0.5 with the sign trick.
The codec itself uses `pmf_host`, a float64 numpy twin that both codec
sides evaluate identically, so the quantized CDF is bitstream-consistent
across the two packages.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LIKELIHOOD_BOUND = 1e-9


class EntropyBottleneck(nn.Module):
    """Parameters matrix_i [C, out, in], bias_i / factor_i [C, out, 1]."""

    def __init__(self, channels: int, filters: Sequence[int] = (3, 3, 3)):
        super().__init__()
        self.channels = channels
        dims = (1,) + tuple(filters) + (1,)
        self.n_layers = len(filters) + 1
        for i in range(self.n_layers):
            shape_m = (channels, dims[i + 1], dims[i])
            shape_b = (channels, dims[i + 1], 1)
            setattr(self, f"matrix_{i}", nn.Parameter(torch.zeros(shape_m)))
            setattr(self, f"bias_{i}", nn.Parameter(torch.zeros(shape_b)))
            setattr(self, f"factor_{i}", nn.Parameter(torch.zeros(shape_b)))

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
        sign = -torch.sign(lo + hi)
        lh = torch.abs(torch.sigmoid(sign * hi) - torch.sigmoid(sign * lo))
        return lh[:, 0, :].T

    def quantize(self, x: torch.Tensor, mode: str = "symbols") -> torch.Tensor:
        """'symbols': round half to even (the codec's quantizer).  Training
        noise waits for the training slice."""
        if mode != "symbols":
            raise NotImplementedError(f"quantize mode {mode!r}")
        return torch.round(x)

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
