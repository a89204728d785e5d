"""Bridge to the MPEG pc_error binary, the distortion ground-truth oracle
(own copy of pcgcv2_tpu/eval/pc_error.py).

The binary is found through the PCGC_PC_ERROR environment variable or on
PATH.  When it is absent, callers use the native metrics of
eval/metrics.py, which give the same result keys.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Dict, Optional

_HEADERS = [
    "mse1      (p2point)", "mse1,PSNR (p2point)",
    "h.       1(p2point)", "h.,PSNR  1(p2point)",
    "mse2      (p2point)", "mse2,PSNR (p2point)",
    "h.       2(p2point)", "h.,PSNR  2(p2point)",
    "mseF      (p2point)", "mseF,PSNR (p2point)",
    "h.        (p2point)", "h.,PSNR   (p2point)",
    "mse1      (p2plane)", "mse1,PSNR (p2plane)",
    "mse2      (p2plane)", "mse2,PSNR (p2plane)",
    "mseF      (p2plane)", "mseF,PSNR (p2plane)",
]


def find_pc_error() -> Optional[str]:
    """Path of the pc_error binary, or None."""
    path = os.environ.get("PCGC_PC_ERROR")
    if path and os.path.exists(path):
        return path
    return shutil.which("pc_error_d") or shutil.which("pc_error")


def pc_error(
    infile1: str,
    infile2: str,
    res: int,
    normal: bool = False,
    show: bool = False,
) -> Dict[str, float]:
    """Run pc_error on two PLY files and scrape the metric lines."""
    binary = find_pc_error()
    if binary is None:
        raise FileNotFoundError("pc_error binary not found (set PCGC_PC_ERROR)")
    cmd = [
        binary, "-a", infile1, "-b", infile2,
        "--hausdorff=1", f"--resolution={res - 1}",
    ]
    if normal:
        cmd += ["-n", infile1]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    results: Dict[str, float] = {}
    for line in proc.stdout.splitlines():
        if show:
            print(line)
        for key in _HEADERS:
            if key in line:
                # the value is the first numeric token after the header
                # (the last float mis-parses lines with several numbers)
                tail = line.split(key, 1)[1]
                for tok in tail.replace(":", " ").split():
                    try:
                        results[key] = float(tok)
                        break
                    except ValueError:
                        continue
                break
    return results
