"""Native D1/D2 geometry distortion metrics (MPEG pc_error equivalents).

The reference shells out to the vendored `pc_error_d` ELF and scrapes stdout
(reference pc_error.py:27-74).  That binary remains the ground-truth
oracle (see eval/pc_error.py), but CI and the training loop need a
dependency-free implementation:

  D1 (point-to-point): symmetric nearest-neighbor MSE,
      PSNR = 10 log10(3 * peak^2 / mse) with peak = resolution - 1
      (the factor 3 is the MPEG convention for 3-D geometry).
  D2 (point-to-plane): same, with the error vector projected onto the
      reference point's normal.  The reference relies on normals stored in
      the input PLY; here normals are estimated by local PCA when absent.

Nearest neighbors use scipy's cKDTree on the host — million-point queries
take ~1 s, comparable to the binary.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
from scipy.spatial import cKDTree


def estimate_normals(points: np.ndarray, k: int = 12) -> np.ndarray:
    """Unit normals by PCA over k nearest neighbors."""
    pts = points.astype(np.float64)
    tree = cKDTree(pts)
    _, idx = tree.query(pts, k=k)
    nbrs = pts[idx]  # [N, k, 3]
    centered = nbrs - nbrs.mean(axis=1, keepdims=True)
    cov = np.einsum("nki,nkj->nij", centered, centered)
    # eigenvector of the smallest eigenvalue = surface normal
    w, v = np.linalg.eigh(cov)
    return v[:, :, 0]


def _directional(
    a: np.ndarray,
    b: np.ndarray,
    b_tree: cKDTree,
    b_normals: Optional[np.ndarray],
):
    """A->B nearest-neighbor distances; returns (mse_d1, hausdorff_d1, mse_d2)."""
    dist, idx = b_tree.query(a)
    sq = dist**2
    mse_d1 = float(sq.mean())
    haus_d1 = float(sq.max())
    mse_d2 = None
    if b_normals is not None:
        diff = a - b[idx]
        proj = np.einsum("ni,ni->n", diff, b_normals[idx])
        mse_d2 = float((proj**2).mean())
    return mse_d1, haus_d1, mse_d2


def _psnr(mse: float, peak: float) -> float:
    if mse <= 0:
        return float("inf")
    return float(10.0 * np.log10(3.0 * peak * peak / mse))


def pc_metrics(
    reference: np.ndarray,
    decoded: np.ndarray,
    resolution: int,
    with_d2: bool = True,
    normals: Optional[np.ndarray] = None,
) -> Dict[str, float]:
    """Symmetric D1/D2 metrics; keys match the reference CSV headers
    (pc_error.py:28-42) so results tables are drop-in comparable."""
    a = reference.astype(np.float64)
    b = decoded.astype(np.float64)
    peak = float(resolution - 1)
    na = normals if normals is not None else (
        estimate_normals(a) if with_d2 else None
    )
    nb = estimate_normals(b) if with_d2 else None
    tree_a = cKDTree(a)
    tree_b = cKDTree(b)

    mse1, h1, mse1_p = _directional(a, b, tree_b, nb)   # ref -> dec
    mse2, h2, mse2_p = _directional(b, a, tree_a, na)   # dec -> ref
    msef = max(mse1, mse2)
    hf = max(h1, h2)
    out = {
        "mse1      (p2point)": mse1,
        "mse1,PSNR (p2point)": _psnr(mse1, peak),
        "mse2      (p2point)": mse2,
        "mse2,PSNR (p2point)": _psnr(mse2, peak),
        "mseF      (p2point)": msef,
        "mseF,PSNR (p2point)": _psnr(msef, peak),
        "h.       1(p2point)": h1,
        "h.       2(p2point)": h2,
        "h.        (p2point)": hf,
        "h.,PSNR   (p2point)": _psnr(hf, peak),
    }
    if with_d2:
        msefp = max(mse1_p, mse2_p)
        out.update(
            {
                "mse1      (p2plane)": mse1_p,
                "mse1,PSNR (p2plane)": _psnr(mse1_p, peak),
                "mse2      (p2plane)": mse2_p,
                "mse2,PSNR (p2plane)": _psnr(mse2_p, peak),
                "mseF      (p2plane)": msefp,
                "mseF,PSNR (p2plane)": _psnr(msefp, peak),
            }
        )
    return out
