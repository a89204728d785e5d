"""Data-parallel training step over a process group (twin of
pcgcv2_tpu/parallel/train.py).

Point clouds in a batch are independent, so the batch is sharded: rank r
takes items [r * local, (r + 1) * local) of the global [B, P, 3] batch
(shard_map's `P(DP_AXIS)` in_spec), collates them into padded voxel rows,
runs the full forward and backward, and the gradients and the loss are
averaged over the group (`pmean`) as one flat all-reduce.  Parameters and
optimizer state stay replicated: they start equal (a broadcast from rank
0 when the step is built) and every rank applies the same update.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from pcgcv2_torch.config import BlockPlan
from pcgcv2_torch.ops.blocks import resolve_device
from pcgcv2_torch.ops.collectives import all_reduce_sum
from pcgcv2_torch.parallel import mesh
from pcgcv2_torch.train.loss import rd_loss


def collate_on_device(coords: torch.Tensor, counts: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, P, 3] + [B] -> padded voxel rows (int32 [B*P, 4] (batch, x, y,
    z), bool [B*P] valid), on the tensors' device."""
    b, p, _ = coords.shape
    batch_ids = torch.arange(b, dtype=torch.int32, device=coords.device)
    rows = torch.cat([batch_ids.view(b, 1, 1).expand(b, p, 1),
                      coords.to(torch.int32)], dim=-1).reshape(b * p, 4)
    valid = (torch.arange(p, device=coords.device)[None, :]
             < counts.to(coords.device)[:, None]).reshape(b * p)
    return rows, valid


def pad_batch(coords_list, item_capacity: int
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Host side: a list of [N_i, 3] -> ([B, P, 3], [B]) padded int32
    arrays, each item cut at `item_capacity` points."""
    b = len(coords_list)
    out = np.zeros((b, item_capacity, 3), dtype=np.int32)
    counts = np.zeros((b,), dtype=np.int32)
    for i, c in enumerate(coords_list):
        n = min(len(c), item_capacity)
        out[i, :n] = c[:n]
        counts[i] = n
    return out, counts


def make_dp_train_step(model, optimizer, group, alpha: float, beta: float,
                       plan: BlockPlan, device="cuda", seed: int = 0):
    """Build this rank's DP step.

    model: a PCCModel on this rank's device whose num_batches is the
    per-rank item count; optimizer: over model.parameters() (the port's
    Adam, train/trainer.py::make_optimizer).  The parameters are
    broadcast from rank 0 here.  Returns step(coords [B, P, 3], counts
    [B], noise=None) -> (mean loss, dropped blocks summed over the group),
    with B = world_size * num_batches; the averaged gradients stay in
    `.grad`.

    Noise: rank r draws from its own generator, seeded with seed + r (rank
    0 as Trainer seeds its generator, so a one-rank step is Trainer.step);
    `noise` [nb[3] * VOL, C] hands in the rank's draw for one call (JAX
    draws fold_in(rng, r)).  Runs on the card unless `device` asks for the
    CPU."""
    dev = resolve_device(device)
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    params = list(model.parameters())
    with torch.no_grad():
        mesh.broadcast_(params, group)
    own = torch.Generator(device=dev)
    own.manual_seed(seed + rank)

    def step(coords, counts, noise: Optional[torch.Tensor] = None):
        local = model.num_batches
        if coords.shape[0] != local * world:
            raise ValueError(
                f"global batch {coords.shape[0]} is not {world} ranks x "
                f"{local} items (model.num_batches)")
        shard = slice(rank * local, (rank + 1) * local)
        rows, valid = collate_on_device(
            torch.as_tensor(coords[shard]).to(dev),
            torch.as_tensor(counts[shard]).to(dev))
        out = model(rows, valid, plan, training=True,
                    generator=own, noise=noise)
        loss = rd_loss(out, alpha, beta, "train")["loss"]
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        loss = loss.detach().reshape(1).clone()
        mesh.all_reduce_mean_([p.grad for p in params] + [loss], group)
        optimizer.step()
        dropped = all_reduce_sum(
            out["out"].dropped.reshape(1).to(torch.int64), group)
        return loss[0], dropped[0]

    return step
