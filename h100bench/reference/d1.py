"""D1 (point-to-point) geometry PSNR, the MPEG pc_error convention: the
symmetric nearest-neighbour mean squared error, the larger of the two
directions, and PSNR = 10 log10(3 peak^2 / mse) with peak = resolution
- 1.  A frozen copy of the arithmetic of the port's `eval/metrics.py`
(its D1 part), so that no change to the port moves this yardstick.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


def d1_psnr(reference: np.ndarray, decoded: np.ndarray,
            resolution: int) -> float:
    a = np.asarray(reference, dtype=np.float64)
    b = np.asarray(decoded, dtype=np.float64)
    if len(a) == 0 or len(b) == 0:
        return float("nan")
    mse_ab = float((cKDTree(b).query(a)[0] ** 2).mean())
    mse_ba = float((cKDTree(a).query(b)[0] ** 2).mean())
    mse = max(mse_ab, mse_ba)
    if mse <= 0:
        return float("inf")
    peak = float(resolution - 1)
    return float(10.0 * np.log10(3.0 * peak * peak / mse))
