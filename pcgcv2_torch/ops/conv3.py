"""3^3 stride-1 sparse convolution: the hand-written CUDA kernel and its
plain PyTorch version.

`conv3` replaces the TPU kernel pcgcv2_tpu/ops/pallas_conv.py::conv3_pallas
(:119), the fused halo-assembly + 3^3 conv, and the XLA path it mirrors,
pcgcv2_tpu/ops/blocks.py::conv3 (:656).  On a CUDA tensor it launches
csrc/conv3.cu (built with nvcc for sm_90a at first use, loaded with
ctypes) or raises; on a CPU tensor it runs `conv3_plain`.

What bounds it on the H100: at the checkpoint's channel pairs the dense
block conv does 13-120 FLOP per byte moved, so it is bound by arithmetic
except for the co = 1 occupancy heads.  The kernel gathers each 18x18 input
plane from the 9 neighbour rows into shared memory (the TPU's 27 slab DMAs
become ordinary global loads), keeps every output channel of one voxel in
registers, and fuses bias, bf16 rounding and the occupancy mask into the
epilogue; rows >= count are written as zeros without arithmetic.  It runs
on the CUDA cores in f32; tensor cores are later work.

`conv3_plain` assembles the (BS+2)^3 halo with one gather and runs the 27
tap matmuls with float32 accumulation.  The TPU lane devices (ci -> 16
padding, banded z-fold weights, chunking) are dropped: none of them changes
the result.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from pcgcv2_torch.ops import blocks as B

HS = B.BS + 2  # halo side

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_SRC = _CSRC / "conv3.cu"
_BUILD_DIR = _CSRC / "build"
_CO_SUPPORTED = (1, 4, 8, 16, 32, 64)
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    """nvcc of the CUDA toolkit (CUDA_HOME, default /usr/local/cuda), else
    the one on PATH."""
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    return cand if os.path.exists(cand) else "nvcc"


def build(verbose: bool = False) -> Path:
    """Compile csrc/conv3.cu into a plain C-interface shared library.

    The library name carries a hash of the source and flags, so a changed
    source is rebuilt and parallel builds never clobber each other's
    half-written file (each writes a private temp file, then renames)."""
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()
    lib = _BUILD_DIR / f"libpcgc_conv3_{tag[:16]}.so"
    if lib.exists():
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SRC)]
    if verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({r.returncode}) building {_SRC}:\n{r.stderr}")
    if verbose:
        print(r.stderr, flush=True)
    os.replace(tmp, lib)
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp = ctypes.c_void_p
            ci = ctypes.c_int
            lib.pcgc_conv3.restype = ci
            lib.pcgc_conv3.argtypes = [vp, vp, vp, vp, vp, vp, vp,
                                       ci, ci, ci, ci, vp]
            _lib = lib
        return _lib


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

_HALO_TABLES = {}


def _halo_tables(device) -> tuple:
    """(neighbour index in 0..26, source slot) of each of the (BS+2)^3 halo
    cells, x-major: halo cell h reads slot `slot[h]` of neighbour block
    nbrs[:, nbr[h] // 9, (nbr[h] // 3) % 3, nbr[h] % 3]."""
    key = str(device)
    if key not in _HALO_TABLES:
        h = np.arange(HS)
        d = np.where(h == 0, 0, np.where(h == HS - 1, 2, 1))
        cell = np.where(h == 0, B.BS - 1, np.where(h == HS - 1, 0, h - 1))
        nbr = (d[:, None, None] * 9 + d[None, :, None] * 3
               + d[None, None, :]).reshape(-1)
        slot = ((cell[:, None, None] * B.BS + cell[None, :, None]) * B.BS
                + cell[None, None, :]).reshape(-1)
        _HALO_TABLES[key] = (torch.from_numpy(nbr).to(device),
                             torch.from_numpy(slot).to(device))
    return _HALO_TABLES[key]


def halo(feats: torch.Tensor, nbrs: torch.Tensor) -> torch.Tensor:
    """[nb, VOL, C] feats + [nb, 3, 3, 3] neighbour rows -> the
    [nb, BS+2, BS+2, BS+2, C] halos (misses read the zero sentinel row)."""
    nb, _, ch = feats.shape
    nbr, slot = _halo_tables(feats.device)
    rows = nbrs.reshape(nb, 27).long()[:, nbr]  # [nb, HS^3]
    flat = rows * B.VOL + slot
    return feats.reshape(nb * B.VOL, ch)[flat].reshape(nb, HS, HS, HS, ch)


def conv3_dense(h: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor], compute_dtype) -> torch.Tensor:
    """Dense 3^3 VALID conv of halos [nb, BS+2, BS+2, BS+2, ci] with
    weight [3, 3, 3, ci, co] -> [nb, VOL, co] in `compute_dtype`: 27 tap
    matmuls accumulated in float32, output (then bias add) rounded to the
    compute dtype."""
    nb, ci = h.shape[0], h.shape[-1]
    w = weight.to(compute_dtype).float()
    hf = h.to(compute_dtype).float()
    acc = torch.zeros(nb * B.VOL, w.shape[-1], dtype=torch.float32,
                      device=h.device)
    for dx in range(3):
        for dy in range(3):
            for dz in range(3):
                win = hf[:, dx:dx + B.BS, dy:dy + B.BS, dz:dz + B.BS]
                acc += win.reshape(-1, ci) @ w[dx, dy, dz]
    out = acc.to(compute_dtype)
    if bias is not None:
        out = (out.float() + bias.to(compute_dtype).float()).to(compute_dtype)
    return out.reshape(nb, B.VOL, -1)


def conv3_plain(
    bg: B.BlockGrid,
    nbrs: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    compute_dtype=None,
) -> B.BlockGrid:
    """Plain PyTorch conv3: halo gather + 27 tap matmuls, f32 accumulation,
    bias, then `with_feats`.  The CPU path and the kernel's reference."""
    cd = compute_dtype or B.COMPUTE_DTYPE
    out = conv3_dense(halo(bg.feats, nbrs), weight, bias, cd)
    return bg.with_feats(out.to(bg.feats.dtype))


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------


def _check(bg: B.BlockGrid, nbrs, weight, bias, cd) -> None:
    nb, ci = bg.nb_cap, bg.channels
    dev = bg.feats.device
    if B.BS != 16:
        raise NotImplementedError(
            f"the conv3 kernel is written for 16^3 blocks, not BS={B.BS}")
    if cd not in (torch.float32, torch.bfloat16):
        raise ValueError(f"conv3 kernel takes float32 or bfloat16, not {cd}")
    if tuple(weight.shape[:4]) != (3, 3, 3, ci):
        raise ValueError(
            f"weight {tuple(weight.shape)} does not match ci={ci}")
    co = weight.shape[4]
    if co not in _CO_SUPPORTED:
        raise NotImplementedError(
            f"conv3 kernel has no instance for co={co}; "
            f"supported: {_CO_SUPPORTED}")
    if bias is not None and tuple(bias.shape) != (co,):
        raise ValueError(f"bias {tuple(bias.shape)} does not match co={co}")
    for name, t in (("weight", weight), ("bias", bias)):
        if t is not None and (t.dtype != cd or not t.is_contiguous()):
            raise ValueError(
                f"{name} must be contiguous {cd} (the layers cast it once), "
                f"got {t.dtype}")
    if tuple(nbrs.shape) != (nb, 3, 3, 3) or nbrs.dtype != torch.int32:
        raise ValueError(
            f"nbrs must be int32 [{nb}, 3, 3, 3], got {nbrs.dtype} "
            f"{tuple(nbrs.shape)}")
    if tuple(bg.mask.shape) != (nb, B.VOL) or bg.mask.dtype != torch.bool:
        raise ValueError("mask must be bool [nb, VOL]")
    if bg.count.dtype != torch.int32 or bg.count.numel() != 1:
        raise ValueError("count must be an int32 scalar tensor")
    for name, t in (("nbrs", nbrs), ("mask", bg.mask), ("count", bg.count),
                    ("weight", weight), ("bias", bias)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, feats on {dev}")


def conv3(
    bg: B.BlockGrid,
    nbrs: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    compute_dtype=None,
) -> B.BlockGrid:
    """3^3 stride-1 sparse convolution of `bg` with weight [3,3,3,ci,co].

    CPU tensors take `conv3_plain`; CUDA tensors launch the CUDA kernel
    (counted in `conv3.launches`) or raise.  On CUDA, weight and bias must
    already be contiguous in the compute dtype."""
    cd = compute_dtype or B.COMPUTE_DTYPE
    dev = bg.feats.device
    if dev.type == "cpu":
        return conv3_plain(bg, nbrs, weight, bias, cd)
    if dev.type != "cuda":
        raise ValueError(f"conv3 runs on cpu or cuda tensors, not {dev}")
    _check(bg, nbrs, weight, bias, cd)
    nb, ci, co = bg.nb_cap, bg.channels, weight.shape[4]
    x = bg.feats.to(cd).contiguous()
    nbrs = nbrs.contiguous()
    mask = bg.mask.contiguous()
    out = torch.empty((nb, B.VOL, co), dtype=cd, device=dev)
    lib = _load()
    rc = lib.pcgc_conv3(
        x.data_ptr(), nbrs.data_ptr(), mask.data_ptr(), bg.count.data_ptr(),
        weight.data_ptr(), bias.data_ptr() if bias is not None else None,
        out.data_ptr(), nb, ci, co, int(cd == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"conv3 kernel launch failed (code {rc}) at "
                           f"nb={nb} ci={ci} co={co} dtype={cd}")
    conv3.launches += 1
    # the kernel applied the mask and zeroed rows >= count (with_feats)
    return bg.replace(feats=out.to(bg.feats.dtype))


conv3.launches = 0
