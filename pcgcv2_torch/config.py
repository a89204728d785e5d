"""Capacity plans, model and training configuration (own copy of
pcgcv2_tpu/config.py).

`BlockPlan` sizes the block capacity of every scale of the dense-block
backend; `CapacityPlan` the row capacities of the per-voxel backend
(`ops/sparse.py`, the test oracle); `ModelConfig` holds the architecture
knobs; `TrainConfig` the training recipe.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Tuple

# Mirrors ops.blocks.BS without importing torch at config time.
_BS = int(os.environ.get("PCGC_BLOCK_SIZE", "16"))


def _round_up(n: int, m: int) -> int:
    return int(math.ceil(n / m)) * m


@dataclasses.dataclass(frozen=True)
class CapacityPlan:
    """Static row capacities for each scale of the 3-level sparse pyramid.

    input  : capacity at full resolution (the collated batch's voxel count)
    scale1 : after the first stride-2 down-conv
    scale2 : after the second
    scale3 : bottleneck (stride 8)
    train_slack : during training, pruning keeps top-k union ground truth,
        which can approach 2x the true count.
    """

    input: int
    scale1: int
    scale2: int
    scale3: int
    train_slack: int = 2

    @classmethod
    def for_points(
        cls,
        n_points: int,
        ratios: Tuple[float, float, float] = (0.65, 0.4, 0.22),
        round_to: int = 1024,
        slack: float = 1.15,
    ) -> "CapacityPlan":
        """Plan for a batch totalling ~n_points voxels.  The default ratios
        are conservative upper bounds on the per-downsample survival rate
        of dense surface scans (each 2x downsample of a 2-D surface in 3-D
        keeps ~25-60% of the voxels, by local density)."""
        c0 = _round_up(int(n_points * slack), round_to)
        c1 = _round_up(int(n_points * ratios[0] * slack), round_to)
        c2 = _round_up(int(n_points * ratios[1] * slack), round_to)
        c3 = _round_up(int(n_points * ratios[2] * slack), round_to)
        return cls(input=c0, scale1=c1, scale2=c2, scale3=c3)

    @property
    def encoder_caps(self) -> Tuple[int, int, int]:
        return (self.scale1, self.scale2, self.scale3)

    def decoder_caps(self, training: bool) -> Tuple[int, int, int]:
        """Post-prune capacities of the three decoder stages (coarse ->
        fine)."""
        f = self.train_slack if training else 1
        k2 = min(8 * self.scale3, f * self.scale2)
        k1 = min(8 * k2, f * self.scale1)
        k0 = min(8 * k1, f * self.input)
        return (k2, k1, k0)


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    """Block capacities of the dense-block backend (ops/blocks.py).

    res    : full-resolution coordinate bound (voxel coords in [0, res)).
    nb     : block caps at strides (1, 2, 4, 8).
    dec_nb : post-compaction block caps of the three decoder stages
             (coarse -> fine: strides 4, 2, 1).  Defaults to 2x the
             encoder caps.
    up_factors / up_caps : pre-prune candidate caps per decoder stage,
             either factor x the coarser cap or absolute.
    """

    res: int
    nb: Tuple[int, int, int, int]
    dec_nb: Tuple[int, int, int] = ()
    up_factors: Tuple[int, int, int] = (8, 8, 8)
    up_caps: Tuple[int, int, int] = ()

    def __post_init__(self):
        if not self.dec_nb:
            object.__setattr__(
                self, "dec_nb",
                (2 * self.nb[2], 2 * self.nb[1], 2 * self.nb[0]),
            )

    @classmethod
    def for_cloud(
        cls,
        n_points: int,
        res: int,
        blocks_per_point: float = (8 / _BS) ** 2 / 40,
        round_to: int = 512,
        slack: float = 1.3,
    ) -> "BlockPlan":
        """Density-prior plan for a frame of ~n_points voxels at `res`
        (the codec's conservative retry tier)."""
        nb0 = max(round_to, _round_up(
            int(n_points * blocks_per_point * slack), round_to))
        # per-stride occupied-block ratios of surface content at BS 16
        ratios = (1.0, 0.28, 0.09, 0.035)

        def cells(s):  # worst-case occupied blocks at scale s (batch 1)
            g = max(1, -(-max(1, res >> s) // _BS))
            return g ** 3 + 1

        nb = tuple(
            min(cells(s),
                max(round_to, _round_up(int(nb0 * r), round_to)))
            for s, r in enumerate(ratios)
        )
        dec_nb = tuple(
            min(cells(i),
                _round_up(int(1.3 * nb[i]) + 1, round_to)) for i in (2, 1, 0)
        )
        up_caps = tuple(
            min(cells(i),
                _round_up(int(1.35 * nb[i]) + 1, round_to)) for i in (2, 1, 0)
        )
        return cls(res=res, nb=nb, dec_nb=dec_nb, up_factors=(5, 4, 3),
                   up_caps=up_caps)

    @classmethod
    def for_training(
        cls,
        capacity: int,
        res: int,
        batch_size: int,
        voxels_per_block: int = 20 * _BS * _BS // 64,
        round_to: int = 256,
    ) -> "BlockPlan":
        """Plan for a training batch: `capacity` padded voxel rows across
        `batch_size` items in a res^3 space.  Each scale's block cap is the
        lesser of the worst-case cell count of its grid and the batch's
        expected occupied blocks (capacity / voxels_per_block, decaying per
        scale); the decoder caps are twice the encoder's (the training
        prune keeps top-k union ground truth), clamped the same way."""

        def g(s):  # blocks per axis at scale s
            return max(1, -(-max(1, res >> s) // _BS))

        per_item = max(256, capacity // max(batch_size, 1) // voxels_per_block)
        ratios = (1.0, 0.4, 0.2, 0.125)
        nb = []
        for s, r in enumerate(ratios):
            cells = batch_size * g(s) ** 3 + 1
            want = _round_up(int(batch_size * per_item * r), round_to) + 1
            nb.append(min(cells, want))
        dec_nb = tuple(
            min(2 * nb[i], batch_size * g(i) ** 3 + 1) for i in (2, 1, 0)
        )
        return cls(res=res, nb=tuple(nb), dec_nb=dec_nb)

    @classmethod
    def for_frame(
        cls,
        res: int,
        blocks: Tuple[int, int, int, int],
        slack: float = 1.2,
        round_to: int = 512,
    ) -> "BlockPlan":
        """Exact-fit plan from measured occupied-block counts at strides
        (1, 2, 4, 8).  A decoder stage's candidate blocks equal the finer
        scale's ground-truth blocks, so the decode caps derive from the
        same counts; `slack` covers top-k drift, and overflow is detected
        at run time (BlockGrid.dropped)."""
        def cells(s):  # worst-case occupied blocks at scale s (batch 1)
            g = max(1, -(-max(1, res >> s) // _BS))
            return g ** 3 + 1

        def pad(s, n):
            return min(cells(s), max(
                round_to, _round_up(int(n * slack) + 1, round_to)))

        nb = tuple(pad(s, b) for s, b in enumerate(blocks))
        dec_nb = (nb[2], nb[1], nb[0])
        return cls(res=res, nb=nb, dec_nb=dec_nb, up_factors=(8, 8, 8),
                   up_caps=dec_nb)

    def up_cap(self, stage: int) -> int:
        """Pre-prune cap for decoder stage `stage` (0 = stride 8 -> 4)."""
        if self.up_caps:
            return self.up_caps[stage]
        prev = self.nb[3] if stage == 0 else self.dec_nb[stage - 1]
        return self.up_factors[stage] * prev


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture knobs (the shipped model's widths are the defaults)."""

    enc_channels: Tuple[int, ...] = (1, 16, 32, 64, 32, 8)
    dec_channels: Tuple[int, ...] = (8, 64, 32, 16)
    blocks_per_scale: int = 3
    entropy_filters: Tuple[int, ...] = (3, 3, 3)
    entropy_init_scale: float = 8.0
    # Recompute whole encoder scales and decoder stages in the training
    # backward (torch.utils.checkpoint) instead of keeping their interior
    # activations; training only, the codec paths never checkpoint.
    remat_training: bool = True


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training recipe."""

    alpha: float = 1.0          # distortion weight
    beta: float = 1.0           # rate weight
    lr: float = 8e-4
    weight_decay: float = 1e-4  # L2 added to the gradients (Adam, not AdamW)
    batch_size: int = 8
    epochs: int = 50
    lr_min: float = 1e-5        # floor of the per-epoch lr halving
    lr_halve_every: int = 1     # epochs between lr halvings
    check_time: float = 10.0    # minutes between mid-epoch snapshots
    reset_optimizer_each_epoch: bool = True
