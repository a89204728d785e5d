"""Synthetic voxelized surfaces for tests and benchmarks.

The reference benchmarks on 8iVFB scans (not redistributable); these
generators produce surface-like voxel sets with comparable occupancy
statistics (a 2-D manifold embedded in a 3-D grid) at any resolution.
"""

from __future__ import annotations

import numpy as np

from pcgcv2_torch.data.voxelize import unique_rows


def sphere_cloud(
    resolution: int = 128, density: float = 4.0, seed: int = 0
) -> np.ndarray:
    """Voxelized sphere surface; returns unique int32 [N, 3] coords."""
    rng = np.random.RandomState(seed)
    r = resolution * 0.45
    n = int(density * 4 * np.pi * r * r)
    u = rng.randn(n, 3)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pts = np.round(u * r + resolution / 2).astype(np.int32)
    pts = np.clip(pts, 0, resolution - 1)
    return unique_rows(pts)


def random_surface_cloud(
    resolution: int = 128, seed: int = 0, density: float = 3.0
) -> np.ndarray:
    """Random smooth closed surface, voxelized — a self-contained substitute
    for the reference's ModelNet40 training crops (generate_dataset.py:75,
    res 127 meshes).  Each draw composes 1-3 primitives (deformed spheres
    with low-order angular harmonics, tori, boxes) under a random rotation,
    giving varied curvature/thickness statistics comparable to mesh scans.
    """
    rng = np.random.RandomState(seed)
    n_parts = rng.randint(1, 5)
    clouds = []
    for _ in range(n_parts):
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
        elif kind == 3:  # capsule / cylinder (limb-like elongated shapes)
            length = r * rng.uniform(1.2, 3.0)
            rad = r * rng.uniform(0.15, 0.45)
            n_side = int(n * length / (length + 2 * rad))
            th = rng.uniform(0, 2 * np.pi, n_side)
            zz = rng.uniform(-length / 2, length / 2, n_side)
            side = np.stack(
                [rad * np.cos(th), rad * np.sin(th), zz], axis=1
            )
            n_cap = n - n_side
            u = rng.randn(n_cap, 3)
            u /= np.linalg.norm(u, axis=1, keepdims=True)
            caps = u * rad
            caps[:, 2] += np.sign(caps[:, 2]) * (length / 2)
            pts = np.concatenate([side, caps], axis=0)
        else:  # open bumpy sheet (partial-scan-like boundary surface)
            half = r * rng.uniform(0.7, 1.4, size=2)
            xy = rng.uniform(-1, 1, (n, 2)) * half
            hgt = np.zeros(n)
            for _ in range(rng.randint(1, 4)):
                fx, fy = rng.uniform(0.5, 3.0, 2)
                hgt += rng.uniform(-0.2, 0.2) * r * np.cos(
                    fx * np.pi * xy[:, 0] / half[0]
                    + rng.uniform(0, np.pi)
                ) * np.cos(
                    fy * np.pi * xy[:, 1] / half[1]
                    + rng.uniform(0, np.pi)
                )
            pts = np.stack([xy[:, 0], xy[:, 1], hgt], axis=1)
        rot = np.linalg.qr(rng.randn(3, 3))[0]
        center = resolution * (0.5 + rng.uniform(-0.12, 0.12, 3))
        clouds.append(pts @ rot + center)
    pts = np.concatenate(clouds, axis=0)
    pts = np.clip(np.round(pts), 0, resolution - 1).astype(np.int32)
    return unique_rows(pts)


def torus_cloud(
    resolution: int = 1024, density: float = 4.0, seed: int = 0
) -> np.ndarray:
    """Voxelized torus surface — at resolution 1024 and density 4 this yields
    ~0.8-1M voxels, the size class of an 8iVFB vox10 frame
    (ref BASELINE.md: longdress 857,966 points @ 1024)."""
    rng = np.random.RandomState(seed)
    big_r = resolution * 0.30
    small_r = resolution * 0.14
    area = 4 * np.pi * np.pi * big_r * small_r
    n = int(density * area)
    theta = rng.uniform(0, 2 * np.pi, n)
    phi = rng.uniform(0, 2 * np.pi, n)
    x = (big_r + small_r * np.cos(phi)) * np.cos(theta)
    y = (big_r + small_r * np.cos(phi)) * np.sin(theta)
    z = small_r * np.sin(phi)
    pts = np.stack([x, y, z], axis=1) + resolution / 2
    pts = np.clip(np.round(pts), 0, resolution - 1).astype(np.int32)
    return unique_rows(pts)
