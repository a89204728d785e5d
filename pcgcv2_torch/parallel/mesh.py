"""Process groups and collectives (twin of pcgcv2_tpu/parallel/mesh.py).

The JAX package builds a 1-D device mesh and runs one program over it under
shard_map.  In PyTorch a rank is a process and a mesh axis is a process
group: `init_group` joins (or, at rank 0, creates) the group of
`world_size` ranks, `spawn` starts the ranks on one host, and the helpers
below move whole parameter sets (pmean of the gradients -> one flat
all-reduce; the broadcast of the start state).  psum and all_gather of
small tensors live in ops/collectives.py, which the structure ops use too.

Backends follow the device: NCCL for CUDA tensors, gloo for CPU ones.  A
caller may name gloo for CUDA ranks (two ranks on one card, which NCCL
refuses).  gloo implements only some collectives on CUDA tensors (no
all_gather), so under gloo every helper moves a CUDA tensor to the host,
runs the collective there and copies the result back: explicitly, by
backend, for every call.
"""

from __future__ import annotations

import datetime
import os
import tempfile
from typing import Callable, List, Sequence

import torch
import torch.distributed as dist

from pcgcv2_torch.ops.blocks import resolve_device
from pcgcv2_torch.ops.collectives import all_reduce_, via_host

# how long a rank waits in a collective for the others before it raises
_TIMEOUT = datetime.timedelta(seconds=600)


def rank_device(rank: int, device="cuda") -> torch.device:
    """The device of `rank`: the CPU, or card `rank % device_count` when
    `device` names no index (so ranks share a card when there are fewer
    cards than ranks).  Raises for "cuda" without a card."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def init_group(rank: int, world_size: int, init_method: str,
               device="cuda", backend=None):
    """Join the default process group of `world_size` ranks as `rank`, on
    `rank_device(rank, device)`; returns (group, device).  The backend is
    NCCL for a CUDA device and gloo for the CPU unless `backend` names
    one.  `init_method` is a store URL every rank can reach: "file://<path>"
    (no port to collide) or "tcp://localhost:<port>"."""
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=_TIMEOUT)
    return dist.group.WORLD, dev


def all_reduce_mean_(tensors: Sequence[torch.Tensor], group) -> None:
    """In place: each tensor becomes its mean over the group (`pmean`),
    through one flat buffer of their dtype (one all-reduce)."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    _copy_back(all_reduce_(flat, group).div_(dist.get_world_size(group)),
               tensors)


def broadcast_(tensors: Sequence[torch.Tensor], group, src: int = 0) -> None:
    """In place: every rank's tensors become rank `src`'s, through one flat
    buffer (the replicated start state of `P()`)."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    buf = flat.cpu() if via_host(flat, group) else flat
    dist.broadcast(buf, src=src, group=group)
    _copy_back(buf.to(flat.device), tensors)


def _copy_back(flat: torch.Tensor, tensors: Sequence[torch.Tensor]) -> None:
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def _run_rank(rank: int, fn: Callable, world_size: int, init_method: str,
              args: tuple, outdir: str) -> None:
    out = fn(rank, world_size, init_method, *args)
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))


def spawn(fn: Callable, world_size: int, *args) -> List:
    """Run `fn(rank, world_size, init_method, *args)` in `world_size` fresh
    processes (start method spawn) and return their results in rank order.

    `fn` must be importable by module and name (a top-level function), and
    its arguments and result picklable; `init_method` is a file store in a
    private temporary directory, which also carries the results back.  A
    rank that raises or dies fails the call: the other ranks are stopped
    and the error is raised here."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as d:
        mp.start_processes(
            _run_rank, args=(fn, world_size, f"file://{d}/store", args, d),
            nprocs=world_size, join=True, start_method="spawn")
        return [torch.load(os.path.join(d, f"rank{r}.pt"),
                           weights_only=False) for r in range(world_size)]
