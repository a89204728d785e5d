"""The small collectives of the structure ops (JAX's `psum` / `all_gather`
over a mesh axis), for a torch.distributed process group.

gloo implements only some collectives on CUDA tensors (no all_gather), so
under gloo a CUDA tensor goes to the host, the collective runs there and
the result is copied back: explicitly, by backend, for every call.  NCCL
(CUDA) and gloo on CPU tensors work in place.  parallel/mesh.py builds the
groups and the gradient collectives on these.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def via_host(t: torch.Tensor, group) -> bool:
    """Whether `group`'s backend needs `t` on the host (gloo, CUDA t)."""
    return t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """SUM over the group, in place where the backend works on t; returns
    the sum on t's device."""
    if via_host(t, group):
        h = t.cpu()
        dist.all_reduce(h, group=group)
        return h.to(t.device)
    dist.all_reduce(t, group=group)
    return t


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """SUM over the group (`psum`), returned as a new tensor on t's
    device."""
    return all_reduce_(t.clone(), group)


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """[world_size, *t.shape]: every rank's t, in rank order
    (`all_gather`)."""
    src = t.cpu() if via_host(t, group) else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.stack(parts).to(t.device)
