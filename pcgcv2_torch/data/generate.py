"""Training-set generation: mesh -> voxelized point cloud (own copy of
pcgcv2_tpu/data/generate.py; the same RandomState draws give the same
points).

The reference samples meshes with Open3D; here the uniform surface sampling
is a self-contained numpy implementation (area-weighted triangle choice +
barycentric sampling), so the pipeline has zero extra dependencies.  The
random rotation / normalize / quantize / unique chain matches the reference
(generate_dataset.py:18-37) including the QR-based rotation draw."""

from __future__ import annotations

import os
import time
from typing import List, Optional, Tuple

import numpy as np

from pcgcv2_torch.data.io import write_h5_geo, write_ply_ascii_geo


def read_off(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Minimal OFF mesh reader (ModelNet40 format, incl. header quirks)."""
    with open(path) as f:
        first = f.readline().strip()
        if first == "OFF":
            counts = f.readline().split()
        elif first.startswith("OFF"):
            counts = first[3:].split()  # 'OFF123 456 0' glued header variant
        else:
            raise ValueError(f"not an OFF file: {path}")
        nv, nf = int(counts[0]), int(counts[1])
        verts = np.loadtxt(f, dtype=np.float64, max_rows=nv, ndmin=2)[:, :3]
        faces_raw = np.loadtxt(f, dtype=np.int64, max_rows=nf, ndmin=2)
    # faces lines are "k i0 i1 ... ik-1"; triangulate fans for k > 3
    tris: List[List[int]] = []
    for row in faces_raw:
        k = int(row[0])
        idx = row[1 : 1 + k]
        for j in range(1, k - 1):
            tris.append([idx[0], idx[j], idx[j + 1]])
    return verts, np.array(tris, dtype=np.int64)


def read_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    verts, tris = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(t) for t in line.split()[1:4]])
            elif line.startswith("f "):
                idx = [int(t.split("/")[0]) - 1 for t in line.split()[1:]]
                for j in range(1, len(idx) - 1):
                    tris.append([idx[0], idx[j], idx[j + 1]])
    return np.array(verts, dtype=np.float64), np.array(tris, dtype=np.int64)


def sample_mesh_uniform(
    verts: np.ndarray, faces: np.ndarray, n_points: int,
    rng: Optional[np.random.RandomState] = None,
) -> np.ndarray:
    """Uniform area-weighted surface sampling (Open3D
    sample_points_uniformly equivalent, ref generate_dataset.py:7-16)."""
    rng = rng or np.random.RandomState()
    v0, v1, v2 = (verts[faces[:, i]] for i in range(3))
    areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    total = areas.sum()
    if total <= 0:
        raise ValueError("degenerate mesh (zero surface area)")
    probs = areas / total
    tri = rng.choice(len(faces), size=n_points, p=probs)
    r1 = np.sqrt(rng.rand(n_points, 1))
    r2 = rng.rand(n_points, 1)
    return (
        (1 - r1) * v0[tri] + r1 * (1 - r2) * v1[tri] + r1 * r2 * v2[tri]
    )


def random_rotation(rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """Random rotation with a random axis flip (ref generate_dataset.py:18-23)."""
    rng = rng or np.random.RandomState()
    m = np.eye(3, dtype="float32")
    m[0, 0] *= rng.randint(0, 2) * 2 - 1
    return np.dot(m, np.linalg.qr(rng.randn(3, 3))[0])


def mesh_to_points(
    mesh_path: str, n_points: int = 400_000, resolution: int = 127,
    rng: Optional[np.random.RandomState] = None,
) -> np.ndarray:
    """mesh -> rotated, normalized, quantized unique voxels
    (ref mesh2pc, generate_dataset.py:25-37)."""
    rng = rng or np.random.RandomState()
    if mesh_path.endswith(".off"):
        verts, faces = read_off(mesh_path)
    elif mesh_path.endswith(".obj"):
        verts, faces = read_obj(mesh_path)
    else:
        raise ValueError(f"unsupported mesh format: {mesh_path}")
    points = sample_mesh_uniform(verts, faces, n_points, rng)
    points = np.dot(points, random_rotation(rng))
    points = points - np.min(points)
    points = points / np.max(points)
    points = points * resolution
    return np.unique(np.round(points).astype("int"), axis=0)


def traverse_meshes(rootdir: str) -> List[str]:
    out = []
    for dirpath, _, files in os.walk(rootdir):
        for f in files:
            if os.path.splitext(f)[1] in (".off", ".obj"):
                out.append(os.path.join(dirpath, f))
    return sorted(out)


def generate_dataset(
    mesh_files: List[str],
    out_dir: str,
    out_filetype: str = "h5",
    n_points: int = 400_000,
    resolution: int = 127,
    seed: int = 0,
    log_every: int = 100,
) -> int:
    """Write one voxelized cloud per mesh (ref generate_dataset.py:39-57);
    returns the number written."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    start, written = time.time(), 0
    for idx, path in enumerate(mesh_files):
        try:
            points = mesh_to_points(path, n_points, resolution, rng)
        except Exception as e:  # skip broken meshes, like the reference
            print(f"ERROR generate_dataset {idx}: {e}")
            continue
        stem = f"{idx}_{os.path.splitext(os.path.basename(path))[0]}"
        if out_filetype == "ply":
            write_ply_ascii_geo(os.path.join(out_dir, stem + ".ply"), points)
        else:
            write_h5_geo(os.path.join(out_dir, stem + ".h5"), points)
        written += 1
        if idx % log_every == 0:
            mins = round((time.time() - start) / 60.0)
            print("=" * 20, idx, mins, "mins", "=" * 20)
    return written
