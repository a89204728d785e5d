"""MPEG G-PCC (tmc3) subprocess bridge — optional external base layer.

Same CLI contract as the reference (reference gpcc.py:6-42): lossless
octree coding of coordinates with the exact flag set.  The binary is located
via the PCGC_TMC3 env var or PATH; when absent, the built-in octree codec
(codec/octree.py) is used instead — the reference snapshot itself ships
without the tmc3 blob.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Optional

_ENC_FLAGS = [
    "--mode=0",
    "--positionQuantizationScale=1",
    "--trisoupNodeSizeLog2=0",
    "--neighbourAvailBoundaryLog2=8",
    "--intra_pred_max_node_size_log2=6",
    "--inferredDirectCodingMode=0",
    "--maxNumQtBtBeforeOt=4",
]


def find_tmc3() -> Optional[str]:
    path = os.environ.get("PCGC_TMC3")
    if path and os.path.exists(path):
        return path
    return shutil.which("tmc3")


def gpcc_encode(ply_path: str, bin_path: str, show: bool = False) -> None:
    tmc3 = find_tmc3()
    if tmc3 is None:
        raise FileNotFoundError("tmc3 binary not found (set PCGC_TMC3)")
    cmd = [tmc3, *_ENC_FLAGS,
           f"--uncompressedDataPath={ply_path}",
           f"--compressedStreamPath={bin_path}"]
    out = subprocess.run(cmd, capture_output=True, text=True, check=True)
    if show:
        print(out.stdout)


def gpcc_decode(bin_path: str, ply_path: str, show: bool = False) -> None:
    tmc3 = find_tmc3()
    if tmc3 is None:
        raise FileNotFoundError("tmc3 binary not found (set PCGC_TMC3)")
    cmd = [tmc3, "--mode=1",
           f"--compressedStreamPath={bin_path}",
           f"--reconstructedDataPath={ply_path}",
           "--outputBinaryPly=0"]
    out = subprocess.run(cmd, capture_output=True, text=True, check=True)
    if show:
        print(out.stdout)
