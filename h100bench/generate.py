"""The one generator of the benchmark's load: it reads a traffic mix
(`traffic/<mix>.json`) and makes, from the run's seed, the frames of a
codec cell or the batches of a training cell.

Frames are voxelized torus surfaces, drawn on the device from a
`torch.Generator` (a 1 M-voxel frame in milliseconds), at the sizes the
mix lists: every seed codes the same sizes, in its own order, with its
own samples and placements.  Rows come sorted, as a voxelizer writes
them.  Training clouds are the
synthetic surfaces of the port's training recipe, from a fixed pool that
every seed shares; the seed permutes them into batches.

`torus_cloud`, `random_surface_cloud` and `unique_rows` are frozen numpy
copies of the port's `data/synthetic.py` and `data/voxelize.py`
generators, so that no change to the port moves the load.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Frozen copies of the port's generators (numpy)
# ---------------------------------------------------------------------------


def unique_rows(coords: np.ndarray) -> np.ndarray:
    """Sorted-unique [N, 3] int32 rows (coordinates in [0, 2^21))."""
    c = np.asarray(coords, dtype=np.int64)
    ku = np.unique((c[:, 0] << 42) | (c[:, 1] << 21) | c[:, 2])
    out = np.empty((len(ku), 3), np.int32)
    out[:, 0] = ku >> 42
    out[:, 1] = (ku >> 21) & 0x1FFFFF
    out[:, 2] = ku & 0x1FFFFF
    return out


def torus_cloud(resolution: int = 1024, density: float = 4.0,
                seed: int = 0) -> np.ndarray:
    """Voxelized torus surface in a resolution^3 box."""
    rng = np.random.RandomState(seed)
    big_r = resolution * 0.30
    small_r = resolution * 0.14
    n = int(density * 4 * np.pi * np.pi * big_r * small_r)
    theta = rng.uniform(0, 2 * np.pi, n)
    phi = rng.uniform(0, 2 * np.pi, n)
    x = (big_r + small_r * np.cos(phi)) * np.cos(theta)
    y = (big_r + small_r * np.cos(phi)) * np.sin(theta)
    z = small_r * np.sin(phi)
    pts = np.stack([x, y, z], axis=1) + resolution / 2
    pts = np.clip(np.round(pts), 0, resolution - 1).astype(np.int32)
    return unique_rows(pts)


def random_surface_cloud(resolution: int = 128, seed: int = 0,
                         density: float = 3.0) -> np.ndarray:
    """Random smooth closed surface of 1-4 primitives (deformed spheres,
    tori, boxes, capsules, bumpy sheets) under random rotations."""
    rng = np.random.RandomState(seed)
    clouds = []
    for _ in range(rng.randint(1, 5)):
        kind = rng.randint(0, 5)
        r = resolution * rng.uniform(0.15, 0.42)
        n = int(density * 4 * np.pi * r * r)
        if kind == 0:  # harmonically deformed sphere
            u = rng.randn(n, 3)
            u /= np.linalg.norm(u, axis=1, keepdims=True)
            theta = np.arccos(np.clip(u[:, 2], -1, 1))
            phi = np.arctan2(u[:, 1], u[:, 0])
            bump = np.zeros(n)
            for _ in range(rng.randint(1, 4)):
                lf, mf = rng.randint(1, 5), rng.randint(1, 5)
                bump += rng.uniform(-0.25, 0.25) * np.cos(
                    lf * theta + rng.uniform(0, np.pi)
                ) * np.cos(mf * phi + rng.uniform(0, np.pi))
            pts = u * (r * (1.0 + bump))[:, None]
        elif kind == 1:  # torus
            small = r * rng.uniform(0.2, 0.6)
            th = rng.uniform(0, 2 * np.pi, n)
            ph = rng.uniform(0, 2 * np.pi, n)
            pts = np.stack([
                (r + small * np.cos(ph)) * np.cos(th),
                (r + small * np.cos(ph)) * np.sin(th),
                small * np.sin(ph),
            ], axis=1)
        elif kind == 2:  # box surface
            half = r * rng.uniform(0.4, 1.0, size=3)
            face = rng.randint(0, 6, n)
            pts = rng.uniform(-1, 1, (n, 3)) * half
            axis, sign = face // 2, (face % 2) * 2 - 1
            pts[np.arange(n), axis] = sign * half[axis]
        elif kind == 3:  # capsule
            length = r * rng.uniform(1.2, 3.0)
            rad = r * rng.uniform(0.15, 0.45)
            n_side = int(n * length / (length + 2 * rad))
            th = rng.uniform(0, 2 * np.pi, n_side)
            zz = rng.uniform(-length / 2, length / 2, n_side)
            side = np.stack([rad * np.cos(th), rad * np.sin(th), zz], axis=1)
            u = rng.randn(n - n_side, 3)
            u /= np.linalg.norm(u, axis=1, keepdims=True)
            caps = u * rad
            caps[:, 2] += np.sign(caps[:, 2]) * (length / 2)
            pts = np.concatenate([side, caps], axis=0)
        else:  # open bumpy sheet
            half = r * rng.uniform(0.7, 1.4, size=2)
            xy = rng.uniform(-1, 1, (n, 2)) * half
            hgt = np.zeros(n)
            for _ in range(rng.randint(1, 4)):
                fx, fy = rng.uniform(0.5, 3.0, 2)
                hgt += rng.uniform(-0.2, 0.2) * r * np.cos(
                    fx * np.pi * xy[:, 0] / half[0] + rng.uniform(0, np.pi)
                ) * np.cos(
                    fy * np.pi * xy[:, 1] / half[1] + rng.uniform(0, np.pi))
            pts = np.stack([xy[:, 0], xy[:, 1], hgt], axis=1)
        rot = np.linalg.qr(rng.randn(3, 3))[0]
        center = resolution * (0.5 + rng.uniform(-0.12, 0.12, 3))
        clouds.append(pts @ rot + center)
    pts = np.concatenate(clouds, axis=0)
    pts = np.clip(np.round(pts), 0, resolution - 1).astype(np.int32)
    return unique_rows(pts)


# ---------------------------------------------------------------------------
# Codec load
# ---------------------------------------------------------------------------


def torus_frame(size: int, density: float, gen: torch.Generator,
                device) -> np.ndarray:
    """A torus_cloud-class frame in a size^3 box drawn on `device` from
    `gen`: unique int32 [N, 3], sorted by (x, y, z) as a voxelizer writes
    them."""
    big_r, small_r = size * 0.30, size * 0.14
    n = int(density * 4 * math.pi * math.pi * big_r * small_r)
    ang = torch.rand(2, n, generator=gen, device=device,
                     dtype=torch.float64) * (2 * math.pi)
    theta, phi = ang[0], ang[1]
    ring = big_r + small_r * torch.cos(phi)
    pts = torch.stack([ring * torch.cos(theta), ring * torch.sin(theta),
                       small_r * torch.sin(phi)], dim=1) + size / 2
    pts = torch.round(pts).clamp_(0, size - 1).long()
    keys = torch.unique((pts[:, 0] << 42) | (pts[:, 1] << 21) | pts[:, 2])
    out = torch.stack([keys >> 42, (keys >> 21) & 0x1FFFFF,
                       keys & 0x1FFFFF], dim=1)
    return out.to(torch.int32).cpu().numpy()


class CodecLoad:
    """A pool of frames at the mix's sizes and, for frame i of a run, the
    pool frame it codes and the integer shift that places it in the box
    (`frame(i)`)."""

    def __init__(self, mix: Dict, seed: int, device):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        self.res = int(mix["res"])
        self.pool = [torus_frame(int(s), float(mix["density"]), gen, device)
                     for s in mix["sizes"]]
        # the shifts that keep each pool frame inside the box, [lo, hi]
        self._room = [(-f.min(axis=0), self.res - 1 - f.max(axis=0))
                      for f in self.pool]
        self._out = [np.empty_like(f) for f in self.pool]
        self.rng = np.random.default_rng(seed)
        self._plan: List = []

    def frame(self, i: int) -> np.ndarray:
        """Frame i, in a buffer that the next frame of its pool frame
        overwrites."""
        while len(self._plan) <= i:  # one seeded pass over the pool at a time
            for j in self.rng.permutation(len(self.pool)):
                lo, hi = self._room[j]
                shift = self.rng.integers(lo, hi + 1).astype(np.int32)
                self._plan.append((int(j), shift))
        j, shift = self._plan[i]
        src, out = self.pool[j], self._out[j]
        for a in range(3):  # by column: numpy is slow over a last axis of 3
            np.add(src[:, a], shift[a], out=out[:, a])
        return out


# ---------------------------------------------------------------------------
# Training load
# ---------------------------------------------------------------------------


class TrainLoad:
    """The mix's pool of training clouds (the same for every seed: the
    first `pool` cloud seeds whose clouds fit capacity / batch_size), and
    per call a seeded permutation of the pool, repeated to fill the call's
    batches: every call trains on the same voxels in another order."""

    def __init__(self, mix: Dict, seed: int):
        c = mix["cloud"]
        self.batch = int(mix["batch_size"])
        self.steps = int(mix["batches_per_call"])
        per_item = int(mix["capacity"]) // self.batch
        self.pool: List[np.ndarray] = []
        s = 0
        while len(self.pool) < int(c["pool"]):
            cloud = random_surface_cloud(int(c["resolution"]), seed=s,
                                         density=float(c["density"]))
            s += 1
            if len(cloud) <= per_item:
                self.pool.append(cloud)
        need = self.steps * self.batch
        if need % len(self.pool):
            raise ValueError("a call's clouds must be whole passes of the "
                             "pool")
        self.rng = np.random.default_rng(seed)

    def call(self) -> List[List[np.ndarray]]:
        """The next call's batches (lists of batch_size clouds)."""
        n = self.steps * self.batch
        order = np.concatenate([self.rng.permutation(len(self.pool))
                                for _ in range(n // len(self.pool))])
        return [[self.pool[k] for k in order[i:i + self.batch]]
                for i in range(0, n, self.batch)]


def voxels(batches: Sequence[Sequence[np.ndarray]]) -> int:
    return int(sum(len(c) for b in batches for c in b))
