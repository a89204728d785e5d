"""The reference's run of one frame through the codec: encode, round,
decode with the ground-truth counts, and the ideal feature-stream size."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from h100bench.reference import bits as BITS
from h100bench.reference import sparse as S
from h100bench.reference.model import PCGCv2


def frame_keys(coords: np.ndarray, device) -> torch.Tensor:
    """Sorted keys of one frame's [N, 3] voxels (batch 0)."""
    c = torch.zeros(len(coords), 4, dtype=torch.int64, device=device)
    c[:, 1:] = torch.as_tensor(np.asarray(coords), device=device).long()
    return S.make_set(c)


@torch.no_grad()
def run_frame(net: PCGCv2, eb: Dict[str, np.ndarray], coords: np.ndarray,
              rho: float = 1.0) -> Dict[str, np.ndarray]:
    """latent_xyz [M, 3] and latents [M, C] (unrounded) on the stride-8
    voxels in (x, y, z) order, decoded [K, 3], feature_bits, n_points."""
    dev = net.w["encoder.conv0.kernel"].device
    with S.exact_f32():
        s0 = frame_keys(coords, dev)
        y, sets = net.encode(s0)
        q = torch.round(y)
        nums = [[sets[2].shape[0]], [sets[1].shape[0]],
                [int(rho * sets[0].shape[0])]]
        keys, _ = net.decode(sets[3], q, nums)
    y_np = y.cpu().numpy()
    return {
        "latent_xyz": S.unpack(sets[3])[:, 1:].cpu().numpy(),
        "latents": y_np,
        "decoded": S.unpack(keys)[:, 1:].cpu().numpy(),
        "feature_bits": BITS.feature_bits(eb, np.round(y_np)),
        "n_points": int(s0.shape[0]),
    }
