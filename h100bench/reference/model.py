"""Plain PyTorch reference of PCGCv2 (Wang et al., DCC 2021,
arXiv:2011.03799; github.com/NJUVISION/PCGCv2 `pcc_model.py`), written
from the paper's equations and the checkpoint's layout, on the per-voxel
lists of `sparse.py`, float32 throughout.

Encoder, per scale s = 0, 1, 2: 3^3 conv -> relu -> 2^3 stride-2 conv ->
relu -> 3 InceptionResNet blocks; then a 3^3 conv to the 8 latent
channels.  Decoder, per stage: generative 2^3 transposed conv -> relu ->
3^3 conv -> relu -> 3 InceptionResNet blocks -> 3^3 conv to one occupancy
logit -> keep the k most likely children (k the ground-truth count of that
scale; in training also every ground-truth voxel).  InceptionResNet:
cat(3^3 (c -> c/4) -> relu -> 3^3 (-> c/2),
    1^3 (c -> c/4) -> relu -> 3^3 (-> c/4) -> relu -> 1^3 (-> c/2)) + x.
Factorized entropy bottleneck (Balle et al. 2018, arXiv:1802.01436):
the likelihood of an integer bin is the difference of a per-channel
monotone cumulative at x +- 0.5.

Weights are {dotted name: tensor} as `ckpt.load` reads them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from h100bench.reference import sparse as S

LIKELIHOOD_BOUND = 1e-9
_LN2 = math.log(2.0)


def relu(x):
    return torch.relu(x)


class _LowerBound(torch.autograd.Function):
    """max(x, bound); the gradient passes where x is at least the bound or
    the gradient pushes x up."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.clamp_min(x, LIKELIHOOD_BOUND)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where((x >= LIKELIHOOD_BOUND) | (g < 0), g, 0)


class PCGCv2:
    """The reference network over `weights` in one precision."""

    def __init__(self, weights: Dict[str, torch.Tensor], model_cfg: Dict,
                 precision: str = "f32"):
        if precision not in S.PRECISIONS:
            raise ValueError(f"unknown precision {precision!r}")
        self.w = weights
        self.enc = list(model_cfg["enc_channels"])
        self.dec = list(model_cfg["dec_channels"])
        self.blocks = int(model_cfg["blocks_per_scale"])
        self.p = precision

    # --- layers -------------------------------------------------------------

    def _c3(self, name, x, nbr):
        return S.conv3(x, nbr, self.w[name + ".kernel"],
                       self.w[name + ".bias"], self.p)

    def _c1(self, name, x):
        return S.conv1(x, self.w[name + ".kernel"], self.w[name + ".bias"],
                       self.p)

    def _irn(self, name, x, nbr):
        a = self._c3(name + ".conv0_1", relu(self._c3(name + ".conv0_0", x,
                                                      nbr)), nbr)
        b = relu(self._c1(name + ".conv1_0", x))
        b = self._c1(name + ".conv1_2", relu(self._c3(name + ".conv1_1", b,
                                                      nbr)))
        return torch.cat([a, b], dim=1) + x

    # --- encoder ------------------------------------------------------------

    def encode(self, s0: torch.Tensor):
        """s0: sorted keys of the input voxels.  Returns (latents [|S3|, C]
        on S3, the sets [S0, S1, S2, S3])."""
        sets = [s0]
        for _ in range(3):
            sets.append(S.coarser(sets[-1]))
        x = torch.ones(s0.shape[0], 1, device=s0.device)
        for s in range(3):
            x = relu(self._c3(f"encoder.conv{s}", x, S.neighbors(sets[s])))
            x = relu(S.down(x, sets[s], sets[s + 1],
                            self.w[f"encoder.down{s}.kernel"],
                            self.w[f"encoder.down{s}.bias"], self.p))
            nbr = S.neighbors(sets[s + 1])
            for i in range(self.blocks):
                x = self._irn(f"encoder.block{s}_{i}", x, nbr)
        y = self._c3("encoder.conv3", x, S.neighbors(sets[3]))
        return y, sets

    # --- decoder ------------------------------------------------------------

    def stage(self, s: int, keys: torch.Tensor, x: torch.Tensor):
        """One decoder stage on the voxels `keys` with features x: (the
        candidate keys, their features, their occupancy logits)."""
        cand, f = S.up(x, keys, self.w[f"decoder.up{s}.kernel"],
                       self.w[f"decoder.up{s}.bias"], self.p)
        f = relu(f)
        nbr = S.neighbors(cand)
        f = relu(self._c3(f"decoder.conv{s}", f, nbr))
        for i in range(self.blocks):
            f = self._irn(f"decoder.block{s}_{i}", f, nbr)
        logits = self._c3(f"decoder.conv{s}_cls", f, nbr)[:, 0]
        return cand, f, logits

    def decode(self, keys: torch.Tensor, y: torch.Tensor,
               nums: Sequence[Sequence[int]], gt: Sequence = None):
        """Three stages from the latent voxels `keys` with features y.
        nums[s][b]: voxels to keep per batch item at stage s; gt[s], in
        training, the ground-truth keys whose voxels are kept as well.
        Returns (the kept keys of the last stage, per stage (candidates,
        logits))."""
        per_stage = []
        x = y
        for s in range(3):
            cand, f, logits = self.stage(s, keys, x)
            per_stage.append((cand, logits))
            keep = S.topk_keep(logits.detach(), cand, nums[s])
            if gt is not None:
                keep = keep | S.isin(gt[s], cand)
            idx = torch.nonzero(keep).reshape(-1)
            keys, x = cand[idx], f[idx]
        return keys, per_stage

    # --- entropy bottleneck -------------------------------------------------

    def likelihood(self, v: torch.Tensor) -> torch.Tensor:
        """P(bin of v) per entry: v [N, C] -> [N, C]."""
        def cumulative(t):  # [C, 1, N]
            for i in range(4):
                m = self.w[f"entropy_bottleneck.matrix_{i}"]
                b = self.w[f"entropy_bottleneck.bias_{i}"]
                f = self.w[f"entropy_bottleneck.factor_{i}"]
                t = torch.matmul(F.softplus(m), t) + b
                t = t + torch.tanh(f) * torch.tanh(t)
            return t

        t = v.T[:, None, :]
        lo, hi = cumulative(t - 0.5), cumulative(t + 0.5)
        sign = -torch.sign(lo + hi).detach()
        lh = torch.abs(torch.sigmoid(sign * hi) - torch.sigmoid(sign * lo))
        return lh[:, 0, :].T

    # --- training -----------------------------------------------------------

    def train_loss(self, s0: torch.Tensor, noise_fn, alpha: float,
                   beta: float) -> torch.Tensor:
        """alpha * sum over stages of the per-candidate BCE (bits) +
        beta * bits per input voxel, with the latents quantized by additive
        noise: noise_fn(latent keys) -> [|S3|, C] uniform in (-0.5, 0.5)."""
        y, sets = self.encode(s0)
        v = y + noise_fn(sets[3])
        lik = _LowerBound.apply(self.likelihood(v))
        n_in = float(s0.shape[0])
        bpp = -torch.log2(lik).sum() / n_in
        batches = int(S.batch_of(s0).max()) + 1
        nums = [counts_per_batch(sets[2 - s], batches) for s in range(3)]
        gt = [sets[2], sets[1], sets[0]]
        _, per_stage = self.decode(sets[3], v, nums, gt)
        bce = 0.0
        for (cand, logits), g in zip(per_stage, gt):
            target = S.isin(g, cand).float()
            per = (torch.clamp_min(logits, 0) - logits * target
                   + torch.log1p(torch.exp(-torch.abs(logits))))
            bce = bce + per.sum() / _LN2 / max(cand.shape[0], 1)
        return alpha * bce + beta * bpp


def counts_per_batch(keys: torch.Tensor, batches: int) -> List[int]:
    return torch.bincount(S.batch_of(keys), minlength=batches).tolist()


def weights_on(arrays: Dict[str, np.ndarray], device,
               requires_grad: bool = False) -> Dict[str, torch.Tensor]:
    return {k: torch.tensor(v, dtype=torch.float32, device=device,
                            requires_grad=requires_grad)
            for k, v in arrays.items()}
