"""3^3 stride-1 sparse convolution: the hand-written CUDA kernels and their
plain PyTorch version.

`conv3` replaces the TPU kernel pcgcv2_tpu/ops/pallas_conv.py::conv3_pallas
(:119), the fused halo-assembly + 3^3 conv, and the XLA path it mirrors,
pcgcv2_tpu/ops/blocks.py::conv3 (:656).  On a CUDA tensor it launches one
of two kernels (built with nvcc for sm_90a at first use, loaded with
ctypes) or raises; on a CPU tensor it runs `conv3_plain`.  Both block
sides of the JAX package (PCGC_BLOCK_SIZE 16, the default, and 8) have
their own instances of conv3_tc.cu and conv3_wgrad.cu, all in one library
(`build`); the process's block side (blocks.BS) picks them.  `route`
picks the kernel by shape:

* "tc", csrc/conv3_tc.cu: at BS = 16 ci and co in {1, 4, 8, 16, 32, 64};
  at BS = 8 the (ci, co) pairs of the full-width model and of its input
  gradients (`TC_PAIRS`).  That is every call of the main path, in bf16
  and in f32.  An implicit GEMM on
  the tensor cores: each CTA stages the input planes of one block row
  with cp.async and feeds ldmatrix from them; the weights come pre-packed
  (`pack_weight`, done once per layer by models/layers.py) and sit in
  shared memory, copied there by a producer warp with TMA bulk copies,
  whole or step by step (`tc_plan`).  bf16: wgmma m64nNk16 where max(co,
  8) reaches `TC_WGMMA_MIN_N` (64) and ci >= 16, else mma.sync m16n8k16
  (m16n8k8 at ci <= 8).  f32: three TF32 products of split operands
  (3xTF32, which keeps f32 accuracy) on wgmma m64nNk8 where max(co, 8)
  reaches `TC_WGMMA_MIN_N` (32), else on mma.sync m16n8k8.  Output tiles
  without an occupied slot skip the arithmetic.
* "simt", csrc/conv3.cu: any other ci (co must still be one of the six).
  f32 FMA on the CUDA cores, one CTA per (block row, output x-plane).  It
  is no longer on the main path and stays as the comparison kernel, for
  16^3 blocks only: at BS = 8 a call it would take raises.

What bounds it on the H100: at the checkpoint's channel pairs the dense
block conv does 6-860 FLOP per byte moved, so it is bound by arithmetic
except for the co = 1 occupancy heads.  Both kernels fuse bias, bf16
rounding and the occupancy mask into the epilogue and write rows >= count
as zeros without arithmetic.  `conv3.launches` counts every forward
launch, `conv3.tc_launches` those of the tensor-core kernel.

`conv3_plain` assembles the (BS+2)^3 halo with one gather and runs the 27
tap matmuls with float32 accumulation.  The TPU lane devices (ci -> 16
padding, banded z-fold weights, chunking) are dropped: none of them changes
the result.

The backward (`Conv3Fn`, which `conv3` runs through whenever a gradient is
wanted) replaces XLA's VJP of pcgcv2_tpu/ops/blocks.py::conv3; the JAX
package has no backward kernel.  With dy the output gradient taken at the
live slots (occupied slots of rows < count, where the forward wrote):

* dX is a forward conv3 of dy with `flip_weight(W)` (`conv3_dgrad`): the
  same kernels, so on the card it runs on conv3_tc.cu.  Like the forward
  it writes only live slots: every producer of a conv3 input in the model
  masks its output (`BlockGrid.with_feats`), so the gradient at the other
  slots would be discarded upstream anyway;
* dW is csrc/conv3_wgrad.cu (`conv3_wgrad`; at BS = 8 the model's forward
  pairs, `WGRAD_PAIRS`): G persistent CTAs per channel split
  (`wgrad_plan`) walk the live rows, read each once for all 27 taps over
  staged input planes, and sum in a fixed order; x is read as the grid
  stores it.  The sums run on the tensor cores with the listed voxels as
  K: bf16 dy on mma.sync m16n8k16 over bf16 planes, each lane's ldmatrix
  row the staged voxel v + tap of its own list entry; f32 dy in 3xTF32 on
  mma.sync m16n8k8, both operands split into tf32 hi and lo in the
  registers, each lane's shared load the staged voxel v + tap of its own
  list entry.  ci below 8 stays on the CUDA cores, f32 FMAs.  Its plain
  version is `conv3_wgrad_plain`;
* dbias is one masked sum.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

from pcgcv2_torch.obs import span
from pcgcv2_torch.ops import blocks as B

HS = B.BS + 2  # halo side

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_SRCS = (_CSRC / "conv3.cu", _CSRC / "conv3_tc.cu", _CSRC / "conv3_wgrad.cu")
_BUILD_DIR = _CSRC / "build"
_CHANNELS = (1, 4, 8, 16, 32, 64)  # co of the kernels; ci of "tc", wgrad
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xcompiler", "-fPIC"]
BLOCK_SIDES = (16, 8)  # the block sides the kernels are built for

# (ci, co) of every conv3 of the full-width model (ModelConfig()): encoder
# scales 1->16, 32->32, 64->64, its final 32->8; decoder stages 64->64,
# 32->32, 16->16; the IRN blocks of widths 64, 32, 16 (ch -> ch/4,
# ch/4 -> ch/2, ch/4 -> ch/4); the occupancy heads 64, 32, 16 -> 1.
MODEL_PAIRS = ((1, 16), (32, 32), (64, 64), (32, 8), (16, 16), (64, 16),
               (16, 32), (8, 16), (8, 8), (16, 4), (4, 8), (4, 4), (64, 1),
               (32, 1), (16, 1))
_ALL_PAIRS = tuple((ci, co) for ci in _CHANNELS for co in _CHANNELS)
# The instances each block side is built with.  16^3: every pair.  8^3:
# the model's pairs, and for conv3_tc.cu also their flips (the input
# gradient is a forward conv co -> ci), so that the second block side does
# not double the build.
TC_PAIRS = {16: _ALL_PAIRS, 8: tuple(dict.fromkeys(
    MODEL_PAIRS + tuple((co, ci) for ci, co in MODEL_PAIRS)))}
WGRAD_PAIRS = {16: _ALL_PAIRS, 8: MODEL_PAIRS}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    """nvcc of the CUDA toolkit (CUDA_HOME, default /usr/local/cuda), else
    the one on PATH."""
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    return cand if os.path.exists(cand) else "nvcc"


def units() -> list:
    """(name, text) of the library's translation units: conv3.cu as it is
    (16^3 only), and conv3_tc.cu and conv3_wgrad.cu once per block side,
    with PCGC_BS and the (ci, co) pairs to instantiate (PCGC_PAIRS)
    defined.  The same for every process, whatever its block side."""
    out = [("conv3", '#include "conv3.cu"\n')]
    for bs in BLOCK_SIDES:
        for src, pairs in (("conv3_tc", TC_PAIRS[bs]),
                           ("conv3_wgrad", WGRAD_PAIRS[bs])):
            xs = " ".join(f"X({ci}, {co})" for ci, co in pairs)
            out.append((f"{src}_bs{bs}",
                        f"#define PCGC_BS {bs}\n#define PCGC_PAIRS(X) {xs}\n"
                        f'#include "{src}.cu"\n'))
    return out


def build(verbose: bool = False) -> Path:
    """Compile the translation units of `units` (one nvcc each, all run
    together: conv3_tc.cu and conv3_wgrad.cu once per block side) and link
    them into one plain C-interface shared library.

    The library name carries a hash of the sources, the units and the
    flags, so a changed source is rebuilt and parallel builds never
    clobber each other's half-written files (each writes private temp
    files, then renames).  Neither depends on PCGC_BLOCK_SIZE: a process
    of either block side loads the library the other built.  `verbose`
    prints each unit's seconds and nvcc's `-Xptxas -v` report."""
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for src in _SRCS:
        h.update(src.read_bytes())
    todo = units()
    for _, text in todo:
        h.update(text.encode())
    tag = h.hexdigest()[:16]
    lib = _BUILD_DIR / f"libpcgc_conv3_{tag}.so"
    if lib.exists():
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pid = os.getpid()
    srcs, objs = [], []
    for name, text in todo:
        src = _BUILD_DIR / f"{name}_{tag}.{pid}.cu"
        src.write_text(text)
        srcs.append(src)
        objs.append(src.with_suffix(".o"))
    ptxas = ["-Xptxas", "-v"] if verbose else []

    def compile_unit(src, obj):  # (process, seconds)
        t0 = time.perf_counter()
        r = subprocess.run([_nvcc(), *ptxas, *_NVCC_FLAGS, "-I", str(_CSRC),
                            "-c", "-o", str(obj), str(src)],
                           capture_output=True, text=True)
        return r, time.perf_counter() - t0

    with ThreadPoolExecutor(len(srcs)) as ex:  # one nvcc per unit, together
        done = list(ex.map(compile_unit, srcs, objs))
    for src in srcs:
        src.unlink(missing_ok=True)
    for (name, _), (r, sec) in zip(todo, done):
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed building {name}:\n{r.stderr}")
        if verbose:
            print(f"nvcc {name} ({sec:.1f} s):\n{r.stderr}", flush=True)
    tmp = lib.with_suffix(f".{pid}.tmp")
    r = subprocess.run([_nvcc(), "-shared", "-o", str(tmp),
                        *map(str, objs)], capture_output=True, text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed linking {lib.name}:\n{r.stderr}")
    os.replace(tmp, lib)
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            with span("pcgc.conv3.build"):
                lib = ctypes.CDLL(str(build()))
            vp = ctypes.c_void_p
            ci = ctypes.c_int
            lib.pcgc_conv3.restype = ci
            lib.pcgc_conv3.argtypes = [vp] * 7 + [ci] * 4 + [vp]
            for bs in BLOCK_SIDES:
                fn = getattr(lib, f"pcgc_conv3_tc_bs{bs}")
                fn.restype = ci
                fn.argtypes = [vp] * 8 + [ci] * 4 + [vp]
                fn = getattr(lib, f"pcgc_conv3_wgrad_bs{bs}")
                fn.restype = ci
                fn.argtypes = [vp] * 8 + [ci] * 4 + [vp]
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
    """[nb, VOL, C] feats + [n, 3, 3, 3] neighbour rows -> the
    [n, BS+2, BS+2, BS+2, C] halos (misses read the zero sentinel row)."""
    nb, _, ch = feats.shape
    n = nbrs.shape[0]
    nbr, slot = _halo_tables(feats.device)
    rows = nbrs.reshape(n, 27).long()[:, nbr]  # [n, HS^3]
    flat = rows * B.VOL + slot
    return feats.reshape(nb * B.VOL, ch)[flat].reshape(n, HS, HS, HS, ch)


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
    return out.reshape(nb, B.VOL, w.shape[-1])


def conv3_plain(
    bg: B.BlockGrid,
    nbrs: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    compute_dtype=None,
) -> B.BlockGrid:
    """Plain PyTorch conv3: halo gather + 27 tap matmuls, f32 accumulation,
    bias, then `with_feats`.  The CPU path and the kernel's reference.
    Only the `count` valid rows are computed: `with_feats` zeroes the rest
    (their mask is empty), and the streamed decode's slab grids hold far
    fewer rows than their capacity."""
    cd = compute_dtype or B.COMPUTE_DTYPE
    n = int(bg.count)
    out = bg.feats.new_zeros(bg.nb_cap, B.VOL, weight.shape[-1])
    out[:n] = conv3_dense(halo(bg.feats, nbrs[:n]), weight, bias, cd)
    return bg.with_feats(out)


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------


def route(ci: int, co: int, dtype, bs: Optional[int] = None) -> str:
    """The kernel a CUDA call takes, by shape: "tc" (csrc/conv3_tc.cu,
    tensor cores) for the pairs block side `bs` (default blocks.BS) has
    instances of (`TC_PAIRS`: at 16 ci and co in {1, 4, 8, 16, 32, 64}), in
    bf16 and f32; "simt" (csrc/conv3.cu, 16^3 only) for any other."""
    del dtype  # both dtypes have the same instances
    return "tc" if (ci, co) in TC_PAIRS.get(bs or B.BS, ()) else "simt"


class TcPlan(NamedTuple):
    """How csrc/conv3_tc.cu tiles one (ci, co, dtype, block side) instance
    (its `Cfg` computes the same; the launch checks xp, rows, smem, ps and
    wslots)."""

    xp: int       # output x-planes per CTA
    rows: int     # output y rows per CTA
    threads: int  # the consumers: one per (y, z) voxel of `ps` planes of
    #               those rows (a producer warp runs beside them)
    smem: int     # dynamic shared memory: the plane ring, weights, bars
    grid: tuple   # CTAs per block row: (x slabs, y-halves)
    ps: int       # output planes per step (8^3: 2)
    wslots: int   # weights in shared memory: 1 = the whole packed kernel
    #               once per CTA, k >= 2 = a ring of k one-step slices
    #               refilled per step
    kg: int       # k chunks per step (a step: one (dx, dz) and kg chunks)
    mma: str      # the product instruction: "wgmma" or "mma.sync"
    weight_reads: int  # times a live row's CTAs read the packed weight
    #                    from L2: per CTA (whole) or per CTA and step
    #                    (streamed)

    def l2_weight_bytes(self, live_rows: int, ci: int, co: int,
                        dtype) -> int:
        """Weight bytes a launch over `live_rows` rows reads from L2."""
        return live_rows * self.weight_reads * packed_bytes(ci, co, dtype)


TC_SMEM_MAX = 232448 - 256  # dynamic shared memory a CTA may use
_TC_STEP_MAX = 12288  # weight bytes of a step, at most
# the least N (co padded to 8) at which conv3_tc.cu's products run on
# wgmma rather than mma.sync, by compute dtype (its WG_MIN_N_*; measured
# on the H100)
TC_WGMMA_MIN_N = {torch.float32: 32, torch.bfloat16: 64}


def _tc_fit(smem: int, threads: int) -> int:
    """CTAs per SM that `smem` bytes of dynamic shared memory (plus the 1
    KB reserved per CTA and rows[]) and `threads` threads admit."""
    return min(233472 // (smem + 1024 + 27 * 4), 2048 // threads)


def _tc_keep_slots(ring: int, sb: int, nstep: int, threads: int,
                   keep: int) -> int:
    """conv3_tc.cu's `tc_keep_slots`: one-step weight slots (sb bytes and
    two 8-byte mbarriers each), the most from 2 up to min(8, nstep) that
    keep `keep` CTAs per SM beside the plane ring, or 0."""
    ks = [k for k in range(2, min(8, nstep) + 1)
          if ring + k * (sb + 16) <= TC_SMEM_MAX
          and _tc_fit(ring + k * (sb + 16), threads) >= keep]
    return max(ks, default=0)


def _tc_kmax(kc: int, kb: int) -> int:
    """The most k chunks of a tap (kb weight bytes each) within a step."""
    g = kc
    while g > 1 and g * kb > _TC_STEP_MAX:
        g //= 2
    return g


def tc_plan(ci: int, co: int, dtype, bs: Optional[int] = None) -> TcPlan:
    """conv3_tc.cu's tiling of one instance at block side `bs` (default
    blocks.BS); see `_tc_plan`.  Cached: every launch reads it."""
    return _tc_plan(ci, co, dtype, bs or B.BS)


@functools.lru_cache(maxsize=None)
def _tc_plan(ci: int, co: int, dtype, bs: int) -> TcPlan:
    """conv3_tc.cu's tiling, the same rule in both dtypes.  Staged voxels
    of max(ci, 8) channels, padded by 16 bytes where a voxel is an even
    number of 16-byte groups; a ring of planes of (rows + 2) x (bs + 2)
    voxels; 16^3 blocks in slabs of 4 x-planes, split into y-halves where
    a full-plane ring does not fit, 8^3 blocks whole.

    The CTA is whole warpgroups and a producer warp; one step covers one
    output plane at 16^3 and two at 8^3 (a ring of 6 planes), so that
    every pass over the weights serves 128 output voxels or more; the
    packed weight sits in shared memory, whole where it fits without
    costing CTAs per SM (up to 2), else streamed through a ring of
    one-step slices, a step one (dx, dz) and `kg` k chunks (finer where
    two slots would cost CTAs per SM); the products on wgmma where
    max(co, 8) reaches `TC_WGMMA_MIN_N` and a chunk is 32 bytes deep (not
    bf16 at ci <= 8, which runs k8), else on mma.sync."""
    with span("pcgc.conv3.plan"):  # a cache miss: one plan search
        sz = dtype.itemsize
        cip, cop, ks = _tc_dims(ci, co, dtype)
        parts = 2 if dtype == torch.float32 else 1
        rs = cip + (16 // sz if (cip * sz // 16) % 2 == 0 else 0)
        hs = bs + 2
        ps = 2 if bs == 8 else 1
        nbuf = 2 * ps + 2
        ys = 2 if nbuf * hs * hs * rs * sz > TC_SMEM_MAX else 1
        rows = bs // ys
        xp = 4 if bs == 16 else 8
        threads = ps * rows * bs
        ring = nbuf * (rows + 2) * hs * rs * sz
        grid = (bs // xp, ys)
        wg = ks * sz == 32 and cop >= TC_WGMMA_MIN_N[dtype]
        mma = "wgmma" if wg else "mma.sync"
        kc, kb = cip // ks, 3 * parts * ks * cop * sz
        cta = threads + 32  # and the producer warp
        keep = min(_tc_fit(ring, cta), 2)
        wb = packed_bytes(ci, co, dtype)
        if (ring + wb + 8 <= TC_SMEM_MAX
                and _tc_fit(ring + wb + 8, cta) >= keep):
            return TcPlan(xp, rows, threads, ring + wb + 8, grid, ps, 1,
                          _tc_kmax(kc, kb), mma, grid[0] * grid[1])
        kg = _tc_kmax(kc, kb)
        while kg > 1 and not _tc_keep_slots(ring, kg * kb, 9 * kc // kg, cta,
                                            keep):
            kg //= 2
        if not _tc_keep_slots(ring, kg * kb, 9 * kc // kg, cta, keep):
            kg = _tc_kmax(kc, kb)  # no step keeps them: fewer CTAs per SM
        sb, nstep = kg * kb, 9 * kc // kg
        ns = (_tc_keep_slots(ring, sb, nstep, cta, keep)
              or _tc_keep_slots(ring, sb, nstep, cta, 1))
        return TcPlan(xp, rows, threads, ring + ns * (sb + 16), grid, ps,
                      ns, kg, mma, grid[0] * grid[1] * xp // ps)


def _tc_dims(ci: int, co: int, dtype) -> tuple:
    """(ci padded, co padded, k chunk depth) of the tensor-core kernel: ci
    and co below 8 are zero-padded to 8; the depth is 8 in f32 (tf32 k8)
    and 16 in bf16 (8 for ci <= 8)."""
    cip, cop = max(ci, 8), max(co, 8)
    ks = 16 if dtype == torch.bfloat16 and cip >= 16 else 8
    return cip, cop, ks


def packed_shape(ci: int, co: int, dtype) -> tuple:
    """Shape of `pack_weight`'s result for a [3, 3, 3, ci, co] kernel."""
    cip, cop, ks = _tc_dims(ci, co, dtype)
    if dtype == torch.float32:
        return (3, 3, cip // 8, 3, 2, cop // 8, 2, 8, 4)
    return (3, 3, cip // ks, 3, cop // 8, ks // 8, 8, 8)


def packed_bytes(ci: int, co: int, dtype) -> int:
    """Bytes of `pack_weight`'s result: 27 max(ci, 8) max(co, 8) weights,
    in f32 each as two parts."""
    parts = 2 if dtype == torch.float32 else 1
    return (27 * max(ci, 8) * max(co, 8) * parts
            * torch.empty((), dtype=dtype).element_size())


def tf32_split(x: torch.Tensor) -> tuple:
    """f32 `x` -> (hi, lo): hi = x rounded to TF32 (10 mantissa bits,
    nearest, ties away from zero, as PTX cvt.rna.tf32.f32), lo = x - hi
    rounded the same way.  hi + lo is x within 2^-22 relative."""

    def rna(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    hi = rna(x)
    return hi, rna(x - hi)


def pack_weight(weight: torch.Tensor) -> torch.Tensor:
    """[3, 3, 3, ci, co] -> the B operand of conv3_tc.cu, the
    shared-memory image of the kernel's steps; ci and co below 8 are
    zero-padded to 8.

    A k chunk (dx, dz, kc) is one contiguous slice of 3 dy x (f32: 2
    parts) KS x co tiles, KS the chunk depth (`_tc_dims`), each the
    K-major layout of 8 x 16-byte core matrices (rows of one n, 16 bytes
    of k each) that wgmma's descriptor and ldmatrix read: a 32-byte-deep
    tile's n tiles 256 bytes apart, its k halves 128.  A step of the
    kernel (`tc_plan`'s kg chunks of one (dx, dz)) is one bulk copy.

    bf16: [3, 3, ci/KS, 3, co/8, KS/8, 8, 8] (dx, dz, k chunk, dy, n tile,
    k half, n, k) holds W[dx, dy, dz, KS kc + 8h + k, 8nt + n], KS 16 (8
    for ci <= 8: one core matrix per n tile).

    f32: [3, 3, ci/8, 3, 2, co/8, 2, 8, 4] (dx, dz, k chunk, dy, part, n
    tile, k half, n, k) holds part s (0 = hi, 1 = lo, `tf32_split`) of
    W[dx, dy, dz, 8kc + 4h + k, 8nt + n]."""
    ci, co = weight.shape[3], weight.shape[4]
    cip, cop, ks = _tc_dims(ci, co, weight.dtype)
    w = torch.nn.functional.pad(weight, (0, cop - co, 0, cip - ci))
    if weight.dtype == torch.float32:
        w = torch.stack(tf32_split(w))  # [s, dx, dy, dz, cip, cop]
        w = w.reshape(2, 3, 3, 3, cip // 8, 2, 4, cop // 8, 8)
        #     s  dx dy dz kc h  k  nt n -> dx dz kc dy s nt h n k
        return w.permute(1, 3, 4, 2, 0, 7, 5, 8, 6).contiguous()
    w = w.reshape(3, 3, 3, cip // ks, ks // 8, 8, cop // 8, 8)
    #     dx dy dz kc h  k  nt n -> dx dz kc dy nt h n k
    return w.permute(0, 2, 3, 1, 6, 4, 7, 5).contiguous()


def unpack_parts(packed: torch.Tensor, ci: int, co: int) -> tuple:
    """The f32 pack's parts (hi, lo), each [3, 3, 3, ci, co]."""
    cip, cop, _ = _tc_dims(ci, co, torch.float32)
    #        dx dz kc dy s nt h n k -> s dx dy dz kc h k nt n
    w = packed.permute(4, 0, 3, 1, 2, 6, 8, 5, 7)
    w = w.reshape(2, 3, 3, 3, cip, cop)[..., :ci, :co]
    return w[0], w[1]


def unpack_weight(packed: torch.Tensor, ci: int, co: int) -> torch.Tensor:
    """Inverse of `pack_weight`: the [3, 3, 3, ci, co] kernel (in f32, the
    sum hi + lo of its two parts)."""
    if packed.dtype == torch.float32:
        hi, lo = unpack_parts(packed, ci, co)
        return hi + lo
    cip, cop, _ = _tc_dims(ci, co, packed.dtype)
    #        dx dz kc dy nt h n k -> dx dy dz kc h k nt n
    w = packed.permute(0, 3, 1, 2, 5, 7, 4, 6)
    return w.reshape(3, 3, 3, cip, cop)[..., :ci, :co].contiguous()


def _check(bg: B.BlockGrid, nbrs, weight, bias, cd, packed, kernel) -> None:
    nb, ci = bg.nb_cap, bg.channels
    dev = bg.feats.device
    if B.BS not in BLOCK_SIDES:
        raise NotImplementedError(
            f"the conv3 kernels are written for 16^3 and 8^3 blocks, not "
            f"BS={B.BS}")
    if cd not in (torch.float32, torch.bfloat16):
        raise ValueError(f"conv3 kernel takes float32 or bfloat16, not {cd}")
    if tuple(weight.shape[:4]) != (3, 3, 3, ci):
        raise ValueError(
            f"weight {tuple(weight.shape)} does not match ci={ci}")
    co = weight.shape[4]
    if co not in _CHANNELS:
        raise NotImplementedError(
            f"conv3 kernel has no instance for co={co}; "
            f"supported: {_CHANNELS}")
    if kernel == "tc":
        if route(ci, co, cd) != "tc":
            raise NotImplementedError(
                f"the tensor-core conv3 has no instance for ci={ci} co={co}")
        if packed is None:
            raise ValueError("the tensor-core conv3 needs the weight packed "
                             "by pack_weight (the layers pack it once)")
        shape = packed_shape(ci, co, cd)
        if tuple(packed.shape) != shape:
            raise ValueError(f"packed weight {tuple(packed.shape)} is not "
                             f"pack_weight's {shape}")
    elif kernel != "simt":
        raise ValueError(f"no conv3 kernel {kernel!r}")
    elif B.BS != 16:
        raise NotImplementedError(
            f"conv3.cu is written for 16^3 blocks, and conv3_tc.cu has no "
            f"BS={B.BS} instance for ci={ci} co={co}")
    if bias is not None and tuple(bias.shape) != (co,):
        raise ValueError(f"bias {tuple(bias.shape)} does not match co={co}")
    for name, t in (("weight", weight), ("bias", bias), ("packed", packed)):
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
                    ("weight", weight), ("bias", bias), ("packed", packed)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, feats on {dev}")


def _aligned(t: torch.Tensor, nbytes: int) -> torch.Tensor:
    """`t` contiguous with its first byte on an `nbytes` boundary (cp.async
    and the kernels' vector loads need it)."""
    t = t.contiguous()
    return t if t.data_ptr() % nbytes == 0 else t.clone()


def _run(kernel: str, bg: B.BlockGrid, nbrs: torch.Tensor,
         weight: torch.Tensor, bias: Optional[torch.Tensor], cd,
         packed: Optional[torch.Tensor]) -> torch.Tensor:
    """Launch one conv3 kernel ("tc" or "simt") on CUDA tensors, or raise;
    returns the output feats [nb, VOL, co] in the compute dtype (masked,
    rows >= count zero).  Counts nothing: its callers do."""
    dev = bg.feats.device
    if dev.type != "cuda":
        raise ValueError(f"conv3 kernels run on cuda tensors, not {dev}")
    _check(bg, nbrs, weight, bias, cd, packed, kernel)
    nb, ci, co = bg.nb_cap, bg.channels, weight.shape[4]
    x = _aligned(bg.feats.to(cd), 16)
    nbrs = nbrs.contiguous()
    mask = _aligned(bg.mask, 4)
    # the weights go to shared memory by bulk copies of 16-byte pieces
    wt = _aligned(packed, 16) if kernel == "tc" else weight
    out = torch.empty((nb, B.VOL, co), dtype=cd, device=dev)
    lib = _load()
    args = (x.data_ptr(), nbrs.data_ptr(), mask.data_ptr(),
            bg.count.data_ptr(), wt.data_ptr(),
            bias.data_ptr() if bias is not None else None, out.data_ptr())
    tail = (nb, ci, co, int(cd == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    if kernel == "tc":
        p = tc_plan(ci, co, cd)
        sel = (ctypes.c_int * 5)(p.xp, p.rows, p.smem, p.ps, p.wslots)
        rc = getattr(lib, f"pcgc_conv3_tc_bs{B.BS}")(
            *args, ctypes.addressof(sel), *tail)
    else:
        rc = lib.pcgc_conv3(*args, *tail)
    if rc != 0:
        raise RuntimeError(f"conv3 {kernel} kernel launch failed (code {rc}) "
                           f"at nb={nb} ci={ci} co={co} dtype={cd}")
    return out


def launch(kernel: str, bg: B.BlockGrid, nbrs: torch.Tensor,
           weight: torch.Tensor, bias: Optional[torch.Tensor], cd,
           packed: Optional[torch.Tensor] = None) -> B.BlockGrid:
    """Launch one conv3 kernel ("tc" or "simt") on CUDA tensors, or raise.

    `conv3` calls it with `route`'s choice; it is public so that a check
    can time both kernels at one shape.  Counts every launch in
    `conv3.launches` and the tensor-core ones in `conv3.tc_launches`.
    The counts are Python, so a CUDA graph's capture counts its launches
    once and its replays count nothing (`Trainer.graph_replays` counts
    the replays)."""
    out = _run(kernel, bg, nbrs, weight, bias, cd, packed)
    conv3.launches += 1
    conv3.tc_launches += kernel == "tc"
    # the kernel applied the mask and zeroed rows >= count (with_feats)
    return bg.replace(feats=out.to(bg.feats.dtype))


def conv3(
    bg: B.BlockGrid,
    nbrs: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    compute_dtype=None,
    packed: Optional[torch.Tensor] = None,
    packed_flip: Optional[torch.Tensor] = None,
) -> B.BlockGrid:
    """3^3 stride-1 sparse convolution of `bg` with weight [3,3,3,ci,co].

    CPU tensors take `conv3_plain`; CUDA tensors launch the kernel that
    `route` picks, or raise.  On CUDA, weight and bias must already be
    contiguous in the compute dtype, and the "tc" route also needs
    `packed = pack_weight(weight)`.  Where a gradient is wanted (grad
    enabled, and feats, weight or bias requiring it) the call runs through
    `Conv3Fn`, whose backward takes `packed_flip =
    pack_weight(flip_weight(weight))` where it is given."""
    cd = compute_dtype or B.COMPUTE_DTYPE
    dev = bg.feats.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"conv3 runs on cpu or cuda tensors, not {dev}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (bg.feats, weight, bias)):
        feats = Conv3Fn.apply(bg.feats, weight, bias, bg, nbrs, cd, packed,
                              packed_flip)
        return bg.replace(feats=feats)
    return _conv3(bg, nbrs, weight, bias, cd, packed)


def _conv3(bg, nbrs, weight, bias, cd, packed) -> B.BlockGrid:
    if bg.feats.device.type == "cpu":
        return conv3_plain(bg, nbrs, weight, bias, cd)
    kernel = route(bg.channels, weight.shape[-1], cd)
    return launch(kernel, bg, nbrs, weight, bias, cd, packed)


conv3.launches = 0
conv3.tc_launches = 0


# ---------------------------------------------------------------------------
# Backward
# ---------------------------------------------------------------------------


def flip_weight(weight: torch.Tensor) -> torch.Tensor:
    """W'[dx, dy, dz] = W[2-dx, 2-dy, 2-dz]^T (ci and co swapped): the
    weight whose forward conv3 is conv3's input gradient."""
    return weight.flip(0, 1, 2).transpose(3, 4).contiguous()


def _live(bg: B.BlockGrid) -> torch.Tensor:
    """bool [nb_cap, VOL]: the occupied slots of the rows < count."""
    return bg.mask & bg.valid[:, None]


def conv3_dgrad(bg: B.BlockGrid, nbrs: torch.Tensor, weight: torch.Tensor,
                compute_dtype=None,
                packed_flip: Optional[torch.Tensor] = None) -> B.BlockGrid:
    """conv3's input gradient at the live slots: `bg.feats` holds dy (zero
    outside the live slots) and `weight` the forward's [3,3,3,ci,co]
    kernel; returns the grid with feats dX [nb_cap, VOL, ci].

    It is the forward conv3 of dy with `flip_weight(weight)`: CPU tensors
    take `conv3_plain`, CUDA tensors the routed kernel for (co, ci), the
    "tc" route with `packed_flip = pack_weight(flip_weight(weight))` (the
    layers pack it once per step).  Counts its launches in
    `conv3_dgrad.launches` (the tensor-core ones in
    `conv3_dgrad.tc_launches`), not in `conv3.launches`; like those, at
    a CUDA graph's capture and not at its replays."""
    cd = compute_dtype or B.COMPUTE_DTYPE
    wf = flip_weight(weight)
    if bg.feats.device.type == "cpu":
        return conv3_plain(bg, nbrs, wf, None, cd)
    kernel = route(bg.channels, wf.shape[-1], cd)
    out = _run(kernel, bg, nbrs, wf, None, cd, packed_flip)
    conv3_dgrad.launches += 1
    conv3_dgrad.tc_launches += kernel == "tc"
    return bg.replace(feats=out.to(bg.feats.dtype))


conv3_dgrad.launches = 0
conv3_dgrad.tc_launches = 0


def conv3_wgrad_plain(bg: B.BlockGrid, dy: torch.Tensor, nbrs: torch.Tensor,
                      compute_dtype=None) -> torch.Tensor:
    """Plain PyTorch weight gradient of conv3, f32 [3, 3, 3, ci, co]:
    dW[tap] = sum over the live slots v of halo[v + tap]^T dy[v], the halo
    gathered as `halo` does, both inputs rounded to the compute dtype, 27
    matmuls in f32.  Only the `count` valid rows are read."""
    cd = compute_dtype or B.COMPUTE_DTYPE
    n = int(bg.count)
    ci, co = bg.channels, dy.shape[-1]
    g = torch.where(_live(bg)[:n, :, None], dy[:n], 0)
    g = g.to(cd).float().reshape(n * B.VOL, co)
    h = halo(bg.feats, nbrs[:n]).to(cd).float()
    dw = torch.empty(3, 3, 3, ci, co, dtype=torch.float32,
                     device=bg.feats.device)
    for dx in range(3):
        for dy_ in range(3):
            for dz in range(3):
                win = h[:, dx:dx + B.BS, dy_:dy_ + B.BS, dz:dz + B.BS]
                dw[dx, dy_, dz] = win.reshape(-1, ci).T @ g
    return dw


class WgradPlan(NamedTuple):
    """How csrc/conv3_wgrad.cu splits one (ci, co, x dtype, compute dtype)
    instance (its `make_plan` computes the same; the launch checks that
    they agree).  Every CTA computes all 27 taps of one ci tile x co
    tile."""

    ci_tile: int
    co_tile: int
    tm: int      # a thread's accumulator tile, tm x tn floats (CUDA cores)
    tn: int
    tiles: int   # thread tiles per CTA (CUDA cores)
    ksplit: int  # voxel phases: threads per tile (CUDA cores)
    splits: int  # (ci tile, co tile) pairs
    g: int       # persistent CTAs per split; rows of the `part` workspace
    smem: int    # dynamic shared memory per CTA, bytes
    mma: bool    # the products on mma.sync (bf16 dy m16n8k16, f32 dy
                 # 3xTF32 m16n8k8), else the CUDA cores


WGRAD_THREADS = 256
WGRAD_WARPS = WGRAD_THREADS // 32
WGRAD_ACC_MAX = 64  # accumulators per thread
# dynamic shared memory a CTA may use beside its list of slots (8 KB at
# BS = 16); an mma.sync instance half of the SM's, so that two CTAs share it
WGRAD_SMEM_MAX = 232448 - 9216
WGRAD_SMEM_MMA = 232448 // 2 - 9216 - 1024
_WG_CTAS = 512  # G x splits, about
_WG_AHEAD = 1   # planes staged ahead of their use
# dy runs on mma.sync where ci >= WGRAD_MMA_MIN_CI (bf16 with a co below 8
# padded to 8), as the kernel's MMA_MIN_CI; below it on the CUDA cores
WGRAD_MMA_MIN_CI = 8
# f32 dy (3xTF32) also needs co >= WGRAD_TF32_MIN_CO, as the kernel's
# MMA_MIN_CO_F32: the narrower co were faster on the CUDA cores
WGRAD_TF32_MIN_CO = 16


def _wgrad_plan_for(ci, co, sx, sg, bs, cit, cot) -> WgradPlan:
    e = 27 * cit * cot
    f = max(1 << (-(-e // WGRAD_THREADS) - 1).bit_length(),
            min(16, cit * cot))
    side = 8 if f >= 64 else 4 if f >= 16 else 2 if f >= 4 else 1
    tm = min(cit, side)
    tn = f // tm
    if tn > cot:
        tn, tm = cot, f // cot
    tiles = e // f
    ksplit = WGRAD_THREADS // tiles
    splits = (ci // cit) * (co // cot)
    # staged y rows are padded by 16 bytes against bank conflicts; a dy
    # buffer holds the bs^2 slots of one plane
    hs = bs + 2
    ring = (3 + _WG_AHEAD) * hs * (hs * cit * sx + 16)
    smem = max(ring + (1 + _WG_AHEAD) * bs * bs * cot * sg,
               ksplit * e * 4)
    return WgradPlan(cit, cot, tm, tn, tiles, ksplit, splits,
                     max(8, _WG_CTAS // splits), smem, False)


def wgrad_mma_units(ci_tile: int) -> int:
    """(tap, m16 tile) units of an mma.sync CTA: ci padded to 8, an m16
    tile of ci 8 half zeros."""
    return 27 * -(-max(ci_tile, 8) // 16)


def wgrad_mma_acc(ci_tile: int, co_tile: int) -> int:
    """f32 accumulators per thread of an mma.sync CTA: each warp owns
    every WGRAD_WARPS-th unit with every n8 tile of the co tile (co padded
    to 8), 4 floats per m16 x n8 fragment and lane."""
    units = wgrad_mma_units(ci_tile)
    return -(-units // WGRAD_WARPS) * (max(co_tile, 8) // 8) * 4


def wgrad_mma_smem(bs: int, ci_tile: int, co_tile: int) -> int:
    """Dynamic shared memory of an mma.sync CTA: bf16 voxels of max(ci
    tile, 8) channels, bf16 dy rows of max(co tile, 8).  16^3: a ring of 4
    staged (bs+2)^2 planes and dy of 2 planes' bs^2 slots; 8^3: an item's
    whole (bs+2)^3 halo and the dy of its bs^3 slots."""
    hs, cip, cop = bs + 2, max(ci_tile, 8), max(co_tile, 8)
    if bs == 8:
        return hs ** 3 * cip * 2 + bs ** 3 * cop * 2
    return (3 + _WG_AHEAD) * hs * hs * cip * 2 + (1 + _WG_AHEAD) * bs * bs * cop * 2


def wgrad_tf32_units(ci_tile: int) -> int:
    """m16 tiles of a 3xTF32 CTA: the 27 x ci_tile (tap, ci) rows, row R
    channel R % ci_tile of tap R // ci_tile, so that a ci tile of 8 packs
    two taps into one tile (the last one padded)."""
    return -(-27 * ci_tile // 16)


def wgrad_tf32_acc(ci_tile: int, co_tile: int) -> int:
    """f32 accumulators per thread of a 3xTF32 CTA: each warp owns every
    WGRAD_WARPS-th m16 tile with every n8 tile of the co tile, 4 floats
    per fragment and lane."""
    return -(-wgrad_tf32_units(ci_tile) // WGRAD_WARPS) * (co_tile // 8) * 4


def wgrad_tf32_row(ci_tile: int, sx: int) -> int:
    """Bytes of a staged voxel of a 3xTF32 CTA: x's channels in its own
    dtype (`sx` bytes each), at least one 32-byte row."""
    return max(ci_tile * sx, 32)


def wgrad_tf32_smem(bs: int, ci_tile: int, co_tile: int, sx: int) -> int:
    """Dynamic shared memory of a 3xTF32 CTA: staged voxels of
    `wgrad_tf32_row` bytes, f32 dy rows of the co tile; 16^3 a ring of 4
    planes and dy of 2 planes' slots, 8^3 an item's whole halo and the dy
    of its slots."""
    hs, xb, db = bs + 2, wgrad_tf32_row(ci_tile, sx), co_tile * 4
    if bs == 8:
        return hs ** 3 * xb + bs ** 3 * db
    return (3 + _WG_AHEAD) * hs * hs * xb + (1 + _WG_AHEAD) * bs * bs * db


def wgrad_tf32_smem_max(bs: int) -> int:
    """The 3xTF32 CTA's shared-memory limit, two CTAs to an SM: half the
    SM's 233472 bytes, less the 1 KB a CTA reserves and its static arrays
    (the slot list, 2 bytes a slot, and 512 bytes)."""
    return 233472 // 2 - 1024 - (2 * bs ** 3 + 512)


@functools.lru_cache(maxsize=None)
def wgrad_plan(ci: int, co: int, x_dtype, compute_dtype,
               bs: Optional[int] = None,
               mma_min_ci: int = WGRAD_MMA_MIN_CI,
               tf32_min_co: int = WGRAD_TF32_MIN_CO) -> WgradPlan:
    """The split of conv3_wgrad.cu for ci, co in {1, 4, 8, 16, 32, 64}, x
    stored in `x_dtype` and dy in `compute_dtype`, at block side `bs`
    (default blocks.BS): the widest co tile, then the widest ci tile, that
    fits.  ci >= `mma_min_ci` runs on mma.sync: bf16 dy with at most
    WGRAD_ACC_MAX accumulators per thread (`wgrad_mma_acc`) and
    `wgrad_mma_smem` within WGRAD_SMEM_MMA; f32 dy (3xTF32) where also co
    >= `tf32_min_co`, with tiles of ci and co from 8, `wgrad_tf32_acc` and
    `wgrad_tf32_smem` within `wgrad_tf32_smem_max`.  The rest runs on the
    CUDA cores: at most WGRAD_ACC_MAX accumulators per thread and a ring
    of 4 staged x planes and two dy planes within WGRAD_SMEM_MAX."""
    with span("pcgc.conv3.plan"):  # a cache miss: one plan search
        bs = bs or B.BS
        sx, sg = x_dtype.itemsize, compute_dtype.itemsize
        tiles = [(cot, cit) for cot in (64, 32, 16, 8, 4, 2, 1) if cot <= co
                 for cit in (64, 32, 16, 8, 4, 2, 1) if cit <= ci]
        if ci >= mma_min_ci and (sg == 2 or co >= tf32_min_co):
            if sg == 4:
                tiles = [(cot, cit) for cot, cit in tiles
                         if min(cot, cit) >= 8]
            for cot, cit in tiles:
                if sg == 2:
                    smem = wgrad_mma_smem(bs, cit, cot)
                    fits = (wgrad_mma_acc(cit, cot) <= WGRAD_ACC_MAX
                            and smem <= WGRAD_SMEM_MMA)
                else:
                    smem = wgrad_tf32_smem(bs, cit, cot, sx)
                    fits = (wgrad_tf32_acc(cit, cot) <= WGRAD_ACC_MAX
                            and smem <= wgrad_tf32_smem_max(bs))
                if fits:
                    splits = (ci // cit) * (co // cot)
                    return WgradPlan(cit, cot, 0, 0, 0, 0, splits,
                                     max(8, _WG_CTAS // splits), smem, True)
        else:
            for cot, cit in tiles:
                p = _wgrad_plan_for(ci, co, sx, sg, bs, cit, cot)
                if p.tm * p.tn <= WGRAD_ACC_MAX and p.smem <= WGRAD_SMEM_MAX:
                    return p
        raise NotImplementedError(f"no conv3_wgrad plan for ci={ci} co={co}")


def _wgrad_inputs(bg: B.BlockGrid, dy: torch.Tensor, nbrs: torch.Tensor,
                  cd) -> tuple:
    """Check conv3_wgrad's arguments and return what the kernel reads:
    (x, dy, nbrs, mask) contiguous and aligned, x in the dtype the grid
    stores (f32 or bf16: no cast copy), dy in the compute dtype."""
    nb, ci, co = bg.nb_cap, bg.channels, dy.shape[-1]
    dev = bg.feats.device
    if B.BS not in BLOCK_SIDES:
        raise NotImplementedError(
            f"the conv3_wgrad kernel is written for 16^3 and 8^3 blocks, not "
            f"BS={B.BS}")
    if cd not in (torch.float32, torch.bfloat16):
        raise ValueError(f"conv3_wgrad takes float32 or bfloat16, not {cd}")
    if bg.feats.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"conv3_wgrad reads float32 or bfloat16 features, "
                         f"not {bg.feats.dtype}")
    if (ci, co) not in WGRAD_PAIRS[B.BS]:
        raise NotImplementedError(
            f"conv3_wgrad has no BS={B.BS} instance for ci={ci} co={co}; "
            f"supported: {WGRAD_PAIRS[B.BS]}")
    if tuple(dy.shape) != (nb, B.VOL, co):
        raise ValueError(f"dy {tuple(dy.shape)} does not match the grid's "
                         f"[{nb}, {B.VOL}, co]")
    if tuple(nbrs.shape) != (nb, 3, 3, 3) or nbrs.dtype != torch.int32:
        raise ValueError(
            f"nbrs must be int32 [{nb}, 3, 3, 3], got {nbrs.dtype} "
            f"{tuple(nbrs.shape)}")
    if tuple(bg.mask.shape) != (nb, B.VOL) or bg.mask.dtype != torch.bool:
        raise ValueError("mask must be bool [nb, VOL]")
    if bg.count.dtype != torch.int32 or bg.count.numel() != 1:
        raise ValueError("count must be an int32 scalar tensor")
    for name, t in (("dy", dy), ("nbrs", nbrs), ("mask", bg.mask),
                    ("count", bg.count)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, feats on {dev}")
    return (_aligned(bg.feats, 16), _aligned(dy.to(cd), 16),
            nbrs.contiguous(), _aligned(bg.mask, 16))


def conv3_wgrad(bg: B.BlockGrid, dy: torch.Tensor, nbrs: torch.Tensor,
                compute_dtype=None) -> torch.Tensor:
    """conv3's weight gradient, f32 [3, 3, 3, ci, co], from the input grid
    `bg` and the output gradient dy [nb_cap, VOL, co], read at the live
    slots only.  CPU tensors take `conv3_wgrad_plain`; CUDA tensors launch
    csrc/conv3_wgrad.cu (the pairs of `WGRAD_PAIRS`; x read as the grid
    stores it, rounded to bf16 in the kernel under bf16 compute) with
    `wgrad_plan`'s split, on mma.sync where the plan says `mma` (bf16
    m16n8k16, f32 3xTF32 m16n8k8) and on the CUDA cores otherwise, or
    raise.  Counts launches in
    `conv3_wgrad.launches`: like `conv3.launches`, at a CUDA graph's
    capture and not at its replays."""
    cd = compute_dtype or B.COMPUTE_DTYPE
    dev = bg.feats.device
    if dev.type == "cpu":
        return conv3_wgrad_plain(bg, dy, nbrs, cd)
    if dev.type != "cuda":
        raise ValueError(f"conv3_wgrad runs on cpu or cuda tensors, not {dev}")
    x, g, nbrs, mask = _wgrad_inputs(bg, dy, nbrs, cd)
    ci, co = bg.channels, dy.shape[-1]
    plan = wgrad_plan(ci, co, x.dtype, cd)
    part = torch.empty((plan.g, 27, ci, co), dtype=torch.float32, device=dev)
    out = torch.empty((3, 3, 3, ci, co), dtype=torch.float32, device=dev)
    sel = (ctypes.c_int * 4)(plan.ci_tile, plan.co_tile, plan.g,
                             int(plan.mma))
    rc = getattr(_load(), f"pcgc_conv3_wgrad_bs{B.BS}")(
        x.data_ptr(), g.data_ptr(), nbrs.data_ptr(), mask.data_ptr(),
        bg.count.data_ptr(), part.data_ptr(), out.data_ptr(),
        ctypes.addressof(sel), ci, co, int(x.dtype == torch.bfloat16),
        int(cd == torch.bfloat16), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"conv3_wgrad kernel launch failed (code {rc}) "
                           f"at nb={bg.nb_cap} ci={ci} co={co} x "
                           f"{x.dtype} compute {cd}")
    conv3_wgrad.launches += 1
    return out


conv3_wgrad.launches = 0


# the BlockGrid fields, feats aside, that Conv3Fn saves for its backward
_GRID_TENSORS = ("coords", "mask", "table", "count", "dropped")


class Conv3Fn(torch.autograd.Function):
    """conv3 with its backward: the forward of `_conv3`, then dX by
    `conv3_dgrad`, dW by `conv3_wgrad` and dbias by a masked sum, all from
    dy masked to the live slots (the forward zeroed every other output,
    but the gradient arriving there from concatenations, residual adds or
    `where`s downstream need not be zero).  dy is cast to the compute
    dtype as the forward cast its input; dX comes back in the input's
    dtype, dW and dbias in the dtypes of the weight and bias received."""

    @staticmethod
    def forward(ctx, feats, weight, bias, bg, nbrs, cd, packed, packed_flip):
        out = _conv3(bg.replace(feats=feats), nbrs, weight, bias, cd,
                     packed).feats
        # the grid's tensors go through save_for_backward too, so that a
        # checkpointed region (remat) frees and recomputes them
        ctx.save_for_backward(feats, weight, bias, nbrs,
                              *(getattr(bg, f) for f in _GRID_TENSORS))
        ctx.meta = (cd, packed_flip, bg.stride, bg.res, bg.num_batches)
        return out

    @staticmethod
    def backward(ctx, g):
        feats, weight, bias, nbrs, *tensors = ctx.saved_tensors
        cd, packed_flip, stride, res, num_batches = ctx.meta
        grid = B.BlockGrid(feats=feats, **dict(zip(_GRID_TENSORS, tensors)),
                           stride=stride, res=res, num_batches=num_batches)
        gm = torch.where(_live(grid)[:, :, None], g, 0).to(cd)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = conv3_dgrad(grid.replace(feats=gm), nbrs, weight, cd,
                             packed_flip).feats.to(feats.dtype)
        if ctx.needs_input_grad[1]:
            dw = conv3_wgrad(grid, gm, nbrs, cd).to(weight.dtype)
        if bias is not None and ctx.needs_input_grad[2]:
            db = gm.float().sum(dim=(0, 1)).to(bias.dtype)
        return dx, dw, db, None, None, None, None, None
