"""Ideal size of the rANS feature stream, from the reference's own prior.

The codec codes each latent channel with the factorized prior's PMF over
the integer grid [min, max] of the frame's rounded latents, evaluated in
float64 and quantized to a 16-bit CDF in which every symbol keeps a
frequency of at least 1 (the largest takes the remainder).  The ideal
length of the stream is the sum of -log2(frequency / 2^16) over the coded
symbols; a range coder adds a few bytes of state to it.  The PMF and the
quantization are written here again from those rules, in numpy.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

LIKELIHOOD_BOUND = 1e-9


def pmf(eb: Dict[str, np.ndarray], min_v: int, num_symbols: int
        ) -> np.ndarray:
    """[C, S] float64 bin likelihoods of min_v + [0, S), at least the
    bound.  eb: {matrix_i, bias_i, factor_i} of the entropy bottleneck."""
    layers = len([k for k in eb if k.startswith("matrix_")])
    channels = eb["bias_0"].shape[0]
    grid = min_v + np.arange(num_symbols, dtype=np.float64)
    x = np.broadcast_to(grid, (channels, 1, num_symbols))

    def cumulative(v):
        for i in range(layers):
            m = eb[f"matrix_{i}"].astype(np.float64)
            b = eb[f"bias_{i}"].astype(np.float64)
            f = eb[f"factor_{i}"].astype(np.float64)
            v = np.einsum("cij,cjn->cin", np.logaddexp(0.0, m), v) + b
            v = v + np.tanh(f) * np.tanh(v)
        return v

    lo, hi = cumulative(x - 0.5), cumulative(x + 0.5)
    sign = -np.sign(lo + hi)
    sig = lambda z: 0.5 * (1.0 + np.tanh(0.5 * z))  # noqa: E731
    p = np.abs(sig(sign * hi) - sig(sign * lo))[:, 0, :]
    return np.clip(p, LIKELIHOOD_BOUND, None)


def frequencies(p: np.ndarray, precision: int = 16) -> np.ndarray:
    """[C, S] integer frequencies summing to 2^precision, each >= 1."""
    c, s = p.shape
    total = 1 << precision
    norm = p / p.sum(axis=1, keepdims=True)
    freqs = np.floor(norm * (total - s)).astype(np.int64) + 1
    top = np.argmax(freqs, axis=1)
    freqs[np.arange(c), top] += total - freqs.sum(axis=1)
    return freqs


def feature_bits(eb: Dict[str, np.ndarray], symbols: np.ndarray) -> float:
    """Ideal bits of the integer latents symbols [N, C]."""
    v = np.asarray(symbols, dtype=np.int64)
    min_v, max_v = int(v.min()), int(v.max())
    freqs = frequencies(pmf(eb, min_v, max_v - min_v + 1))
    f = freqs[np.arange(v.shape[1])[None, :], v - min_v]
    return float(-np.log2(f / float(1 << 16)).sum())


def entropy_params(weights: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    pre = "entropy_bottleneck."
    return {k[len(pre):]: v for k, v in weights.items() if k.startswith(pre)}
