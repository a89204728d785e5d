"""Multi-process paths of the port (twin of pcgcv2_tpu/parallel/).

`mesh`: process groups, collectives and `spawn`; `train`: the data-parallel
training step; `spatial`: the spatially sharded decode of one frame with a
global top-k.  Ranks are processes joined through torch.distributed (NCCL
for CUDA, gloo for the CPU), where the JAX package ran one program over a
device mesh under shard_map.
"""

from pcgcv2_torch.parallel.mesh import init_group, spawn

__all__ = ["init_group", "spawn"]
