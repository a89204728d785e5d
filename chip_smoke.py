#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pcgcv2_torch) on one NVIDIA GPU.

    python3 chip_smoke.py              # every phase, as the check runs it
    python3 chip_smoke.py --phases 1,2 # card identity + kernel checks only

Phases (each prints its own lines; any failure exits non-zero):
  1. card identity (nvidia-smi name and power limit); TF32 off.
  2. conv3: the routed CUDA kernel (conv3_tc.cu on the tensor cores, at
     every shape of the main path) and the CUDA-core kernel conv3.cu, each
     against conv3_plain at every (nb_cap, ci, co) of the vox10 main path,
     f32 and bf16, with kernel / conv3.cu / plain / library (F.conv3d on
     the assembled halo) times and the bound.
  3. golden triple: tests/golden/golden.ckpt on the golden torus frame at
     full width in f32 -> points, bpp and D1 against expected.json.
  4. vox10 frame (torus_cloud(684, density=4, seed=0), 858,862 voxels)
     with ckpts/r4 in bf16 and f32: encode/decode seconds (best of 3 after
     a warm-up), conv3 launches per encode+decode (64, all on the tensor
     cores), peak device memory; bpp and D1 gates in both dtypes.
  5. torch.profiler breakdown of one encode+decode per dtype (written to
     OUT_DIR), and the share of empty output tiles of the tensor-core
     convs on this frame per dtype (CTA slabs counted as 4 x-planes of 16
     y rows; the f32 ci = 64 CTAs cover half of that).
  6. the streamed decode (phase 2 also checks conv3 at its vox11 slab
     shapes):
     a. the vox10 frame decoded in 8 slabs against the monolithic decode,
        bf16 and f32: same count, point sets within 0.01%, the vox10
        gates, and the decode times (best of 3, in turns) with their ratio;
     b. a vox11-class frame (torus_cloud(1390, density=4, seed=11),
        3,546,032 voxels at res 2048), whole: bf16 best of 3 after a
        warm-up, f32 one rep; decoded count, 141 conv3 launches all on the
        tensor cores, peak device memory of encode and of decode, bpp and
        D1 gates, and (bf16) the monolithic decode through model.decode_fn
        beside it;
     c. pcgcv2_torch.cli.test.run_sweep on the golden frame: the CSV row's
        count, bpp and D1 against the golden triple.
  7. training (a batch of 8 random_surface_cloud(127, seed=s, density=2)
     clouds, 327,003 voxels, BlockPlan.for_training(524288, 128, 8)):
     a. one full-width training step per dtype (f32, bf16) with every
        conv3 backward spied on: dX (conv3_tc.cu on the flipped weight)
        and dW (conv3_wgrad.cu) against autograd through conv3_plain on
        that call's own grid, dy and weight, a second dW launch on the
        same inputs giving the same bits, with kernel / plain / library
        (cuDNN through torch.nn.grad) times and the bound;
     b. the full-width trainer step as scripts/train_rd.py runs it (remat
        on, alpha 2, beta 1, lr 8e-4), bf16 then f32: 20 steps on the
        batch, the median of steps 1-5, peak memory, forward / dX / dW
        launches per step (127 / 63 / 64, every forward and dX on the
        tensor cores), finite losses, no dropped block, a falling loss;
     c. pcgcv2_torch.cli.train for one epoch on 20 such clouds written as
        .ply (f32), and its checkpoint through Coder on the golden frame.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
It exits non-zero without a CUDA device or without the pcgcv2_torch
package beside it.  Imports nothing of JAX or of pcgcv2_tpu.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# H100 SXM published peaks (dense): HBM bytes/s, f32 CUDA-core FLOP/s and
# bf16 tensor-core FLOP/s.
HBM_BPS = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

# conv3 shapes of one vox10 encode + decode: nb_cap -> (ci, co) pairs, and
# how many times each shape runs per frame (31 encode + 33 decode = 64).
PER_FRAME = {
    (5632, 1, 16): 1, (5632, 16, 16): 1, (5632, 16, 4): 3,
    (5632, 4, 8): 3, (5632, 4, 4): 3, (5632, 16, 1): 1,
    (1536, 32, 8): 6, (1536, 8, 16): 6, (1536, 8, 8): 6,
    (1536, 32, 32): 2, (1536, 32, 1): 1,
    (512, 64, 16): 6, (512, 16, 32): 6, (512, 16, 16): 6,
    (512, 64, 64): 2, (512, 64, 1): 1, (512, 32, 8): 4,
    (512, 8, 16): 3, (512, 8, 8): 3,
}
# conv3 shapes of the final decoder stage of a vox11 frame, run per x-slab
# by the streamed decode: torus_cloud(1390, density=4, seed=11) at res 2048
# gives the plan nb (21504, 5632, 1536, 512), so each of the 8 slabs runs
# stage 2 at max(256, up_cap(2) * 2 // 8) = 5376 candidate blocks (phase 6
# checks the number).  Per slab: conv2 16->16, 3 IRN blocks (16->4, 4->8,
# 4->4 each) and the cls head 16->1: 11 launches, 88 per frame.
VOX11_SLAB_CAP = 5376
PER_VOX11_SLABS = {
    (VOX11_SLAB_CAP, 16, 16): 8, (VOX11_SLAB_CAP, 16, 4): 24,
    (VOX11_SLAB_CAP, 4, 8): 24, (VOX11_SLAB_CAP, 4, 4): 24,
    (VOX11_SLAB_CAP, 16, 1): 8,
}
TOL_F32 = 1e-4      # max abs error, kernel vs plain, f32
TOL_BF16_REL = 2e-2  # max abs error / max |ref|, bf16 kernel vs f32 plain
# vox10 readings of the CUDA-core kernel (chip_smoke.py on an H100,
# 700 W), bf16 and f32: the tensor-core route must keep the codec's result
VOX10_GATES = {"bfloat16": (0.492671, 69.4159), "float32": (0.493043, 69.4005)}
# vox11-class frame (phase 6b), ckpts/r4: the first readings of the streamed
# decode (chip_smoke.py on an H100, 700 W), held with the vox10 tolerances
VOX11_GATES = {"bfloat16": (0.494696, 74.9098), "float32": (0.495046, 74.9102)}
# phase 7: the training batch and its plan
TRAIN_BATCH, TRAIN_RES, TRAIN_CAPACITY = 8, 128, 524288
TRAIN_STEPS = 20
# conv3 launches per training step with remat: (forward, of which tensor
# cores, dX, of which tensor cores, dW).  Remat runs each forward twice but
# the encoder's last conv, which lies outside the checkpointed scales; the
# first conv reads data, so it has no dX.
TRAIN_LAUNCHES = (127, 127, 63, 63, 64)
# backward kernels against f32 autograd through conv3_plain on the same
# (rounded) inputs, max abs error over max |ref|.  dW accumulates in f32
# and returns f32 in both dtypes: only the order of summation differs.  dX
# in f32 is 3xTF32 (f32 accuracy); in bf16 its output is rounded to bf16
# (2^-9 relative) after sums in another order.
TRAIN_TOL = {"dw": {"float32": 1e-4, "bfloat16": 1e-4},
             "dx": {"float32": 1e-4, "bfloat16": 2e-2}}
KERNEL_REPS = 10     # timed launches per kernel shape (median)
VOX10_REPS = 3       # timed vox10 encode+decode reps per dtype (best)


def log(*a):
    print(*a, flush=True)


def card_identity() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, n: int = 10) -> float:
    """Median device time of `fn` over n runs (CUDA events), after one
    warm-up run."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# Phase 2: conv3 kernel against its plain version
# ---------------------------------------------------------------------------


def random_grid(nb_cap: int, ch: int, seed: int, device):
    """A BlockGrid with ~77% of nb_cap live blocks (the vox10 frame's
    4342 / 5632 share) packed in a cube so most neighbours exist, 5% slot
    occupancy and N(0,1) features, built through blockify."""
    import torch

    from pcgcv2_torch.ops import blocks as B

    g = torch.Generator().manual_seed(seed)
    live = int(nb_cap * 0.77)
    side = math.ceil((2 * live) ** (1 / 3))
    keys = torch.randperm(side ** 3, generator=g)[:live]
    bxyz = torch.stack([keys // side ** 2, (keys // side) % side,
                        keys % side], dim=1)
    occ = torch.rand(live, B.VOL, generator=g) < 0.05
    blk, slot = occ.nonzero(as_tuple=True)
    local = torch.stack([slot // B.BS ** 2, (slot // B.BS) % B.BS,
                         slot % B.BS], dim=1)
    xyz = bxyz[blk] * B.BS + local
    coords = torch.cat([torch.zeros(len(xyz), 1, dtype=torch.int64), xyz],
                       dim=1).to(torch.int32)
    feats = torch.randn(len(xyz), ch, generator=g)
    valid = torch.ones(len(xyz), dtype=torch.bool)
    bg = B.blockify(coords.to(device), feats.to(device), valid.to(device),
                    nb_cap, stride=1, res=1024, num_batches=1)
    assert int(bg.dropped) == 0 and int(bg.count) == live
    return bg


def conv3_bound(bg, nbrs, ci: int, co: int, dtype: str):
    """(bytes ms, operations ms) of the bound: the bytes the call must move
    (live rows' feats in and out, mask, neighbour rows, weights) over HBM
    bandwidth, and the sparse work this data needs (2*ci*co per pair of an
    occupied output voxel and an occupied input voxel of its 3^3
    neighbourhood) over the peak rate of the dtype.  The bound is the
    larger of the two."""
    import torch
    import torch.nn.functional as F

    from pcgcv2_torch.ops import blocks as B
    from pcgcv2_torch.ops.conv3 import halo

    elt = 4 if dtype == "float32" else 2
    rows = int(bg.count)
    nbytes = (rows * B.VOL * ((ci + co) * elt + 1) + rows * 27 * 4
              + (27 * ci * co + co) * elt)
    m = bg.mask.float()
    hm = halo(m[:, :, None], nbrs).permute(0, 4, 1, 2, 3)
    nbr_cnt = F.conv3d(hm, torch.ones(1, 1, 3, 3, 3, device=m.device))
    pairs = float((nbr_cnt.reshape(bg.nb_cap, B.VOL) * m).sum())
    ops = 2.0 * ci * co * pairs
    return nbytes / HBM_BPS * 1e3, ops / PEAK_FLOPS[dtype] * 1e3


def phase_kernels(device):
    import torch
    import torch.nn.functional as F

    from pcgcv2_torch.ops import blocks as B
    from pcgcv2_torch.ops import conv3 as K

    log("== phase 2: conv3 CUDA kernels vs conv3_plain ==")
    rows = []
    shapes = [("vox10", k, n) for k, n in PER_FRAME.items()]
    shapes += [("vox11_slab", k, n) for k, n in PER_VOX11_SLABS.items()]
    gen = torch.Generator(device=device).manual_seed(0)
    grids = {}
    for path, (nb_cap, ci, co), per_frame in shapes:
        if nb_cap not in grids:
            grids.clear()
            torch.cuda.empty_cache()
            grids[nb_cap] = random_grid(nb_cap, 64, seed=nb_cap,
                                        device=device)
        base = grids[nb_cap]
        nbrs = B.neighbor_rows(base)
        feats32 = base.feats[:, :, :ci].contiguous()
        w = torch.randn(3, 3, 3, ci, co, device=device, generator=gen)
        w *= math.sqrt(2.0 / (27 * ci))
        b = 0.1 * torch.randn(co, device=device, generator=gen)
        row = {"path": path, "nb_cap": nb_cap, "live_rows": int(base.count),
               "ci": ci, "co": co, "per_frame": per_frame}
        for dtype in ("float32", "bfloat16"):
            cd = B._DTYPES[dtype]
            bg = base.replace(feats=feats32.to(cd))
            wc, bc = w.to(cd), b.to(cd)  # as the layers hand them over
            kernel = K.route(ci, co, cd)
            packed = K.pack_weight(wc) if kernel == "tc" else None
            # reference: plain f32 on the same (rounded) inputs
            ref = K.conv3_plain(
                bg.replace(feats=bg.feats.float()), nbrs,
                wc.float(), bc.float(), torch.float32).feats
            scale = float(ref.abs().max())
            tol = TOL_F32 if dtype == "float32" else TOL_BF16_REL * scale
            got = K.conv3(bg, nbrs, wc, bc, cd, packed=packed).feats
            # the CUDA-core kernel at the same shape, checked and timed
            got_simt = K.launch("simt", bg, nbrs, wc, bc, cd).feats
            torch.cuda.synchronize()
            err = float((got.float() - ref).abs().max())
            simt_err = float((got_simt.float() - ref).abs().max())
            ok = err <= tol and simt_err <= tol
            h = K.halo(bg.feats, nbrs).permute(0, 4, 1, 2, 3).contiguous()
            wl = wc.permute(4, 3, 0, 1, 2).contiguous()
            ms = cuda_ms(lambda: K.conv3(bg, nbrs, wc, bc, cd, packed=packed),
                         KERNEL_REPS)
            simt_ms = cuda_ms(
                lambda: K.launch("simt", bg, nbrs, wc, bc, cd), KERNEL_REPS)
            plain_ms = cuda_ms(lambda: K.conv3_plain(bg, nbrs, w, b, cd), 3)
            lib_ms = cuda_ms(lambda: F.conv3d(h, wl, bc), KERNEL_REPS)
            del h
            bytes_ms, ops_ms = conv3_bound(bg, nbrs, ci, co, dtype)
            bound = max(bytes_ms, ops_ms)
            bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
            dense_flop = 2.0 * 27 * ci * co * B.VOL * int(base.count)
            row[dtype] = {
                "route": kernel,
                "max_abs_err": err, "simt_max_abs_err": simt_err,
                "max_abs_ref": scale, "ok": ok,
                "ms": ms, "simt_ms": simt_ms, "plain_ms": plain_ms,
                "library_ms": lib_ms,
                "bound_ms": bound, "bound_by": bound_by,
                "bytes_ms": bytes_ms, "ops_ms": ops_ms,
                "dense_tflops": dense_flop / (ms * 1e-3) / 1e12,
            }
            log(f"conv3 {path:<10s} nb={nb_cap:<5d} ci={ci:<3d} co={co:<3d} "
                f"{dtype:<8s} x{per_frame}/frame  err={err:.3g} "
                f"(|ref|max {scale:.3g}) "
                f"{'OK' if ok else 'FAIL'}  {kernel} {ms:.4f} ms  "
                f"(conv3.cu {simt_ms:.4f} ms, err {simt_err:.3g})  "
                f"plain {plain_ms:.4f} ms  F.conv3d(halo) {lib_ms:.4f} ms  "
                f"bound {bound:.4f} ms ({bound_by})  "
                f"dense {row[dtype]['dense_tflops']:.2f} TFLOP/s")
            if not ok:
                raise AssertionError(
                    f"conv3 kernels disagree with conv3_plain at nb={nb_cap} "
                    f"ci={ci} co={co} {dtype}: max abs err {kernel} {err}, "
                    f"conv3.cu {simt_err} (tolerance {tol})")
        rows.append(row)
    grids.clear()
    torch.cuda.empty_cache()
    for path in ("vox10", "vox11_slab"):
        for dtype in ("float32", "bfloat16"):
            tot = {k: per_frame_sum(rows, path, dtype, k)
                   for k in ("ms", "simt_ms", "plain_ms", "library_ms",
                             "bound_ms")}
            log(f"conv3 per-frame totals {path} {dtype}: kernel "
                f"{tot['ms']:.3f} ms  (conv3.cu alone {tot['simt_ms']:.3f} "
                f"ms)  plain {tot['plain_ms']:.3f} ms  F.conv3d(halo) "
                f"{tot['library_ms']:.3f} ms  bound {tot['bound_ms']:.4f} ms")
    return rows


def per_frame_sum(rows, path: str, dtype: str, key: str) -> float:
    """A phase-2 column summed over one path's shapes, each weighted by its
    launches per frame (vox10: the 64 of an encode + decode; vox11_slab:
    the 88 of the 8 slabs of a vox11 frame's final decoder stage)."""
    return sum(r["per_frame"] * r[dtype][key] for r in rows
               if r["path"] == path)


# ---------------------------------------------------------------------------
# Phases 3-5: the codec's main path
# ---------------------------------------------------------------------------


def run_frame(coder, cloud, postfix: str):
    """One timed encode + decode; returns (enc s, dec s, decoded coords,
    conv3 launches in this run, of which on the tensor cores)."""
    import torch

    from pcgcv2_torch.ops import conv3 as K

    K.conv3.launches = K.conv3.tc_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    coder.encode(cloud, postfix=postfix)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    dec = coder.decode(postfix=postfix)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return t1 - t0, t2 - t1, dec, K.conv3.launches, K.conv3.tc_launches


def phase_golden(device, workdir: str):
    import numpy as np

    from pcgcv2_torch.checkpoint import load_params
    from pcgcv2_torch.codec.coder import Coder
    from pcgcv2_torch.data.synthetic import torus_cloud
    from pcgcv2_torch.eval.metrics import pc_metrics
    from pcgcv2_torch.ops import blocks as B

    log("== phase 3: golden triple, full width, float32 ==")
    B.set_compute_dtype("float32")
    exp = json.loads((ROOT / "tests/golden/expected.json").read_text())
    # the frame of scripts/make_golden.py: res 256, torus 170, density 2
    cloud = torus_cloud(170, density=2.0, seed=42)
    coder = Coder(load_params(str(ROOT / "tests/golden/golden.ckpt")),
                  os.path.join(workdir, "golden"), res=256, device=device)
    enc_s, dec_s, dec, launches, tc = run_frame(coder, cloud, "")
    bits = sum(8 * v for v in coder.bitstream_bytes().values())
    bpp = bits / len(cloud)
    d1 = pc_metrics(cloud, np.unique(dec, axis=0), 256,
                    with_d2=False)["mseF,PSNR (p2point)"]
    log(f"golden: n_points {len(cloud)} (expected {exp['n_points']})  "
        f"bpp {bpp:.6f} (expected {exp['bpp']})  D1 {d1:.4f} dB "
        f"(expected {exp['d1_psnr']})  decoded {len(dec)}  "
        f"conv3 launches {launches}  enc {enc_s:.3f} s  dec {dec_s:.3f} s")
    assert len(dec) == exp["n_points"], f"golden decoded {len(dec)} points"
    assert abs(bpp - exp["bpp"]) <= 0.005 * exp["bpp"], "golden bpp"
    assert abs(d1 - exp["d1_psnr"]) <= 0.05, "golden D1"
    assert launches == 64 and tc == 64, \
        f"{launches} conv3 launches ({tc} tc)"
    return {"bpp": bpp, "d1_psnr": d1, "n_points": len(cloud),
            "decoded": len(dec), "launches": launches}


def phase_vox10(device, workdir: str, card: str):
    import numpy as np
    import torch

    from pcgcv2_torch.checkpoint import load_params
    from pcgcv2_torch.codec.coder import Coder
    from pcgcv2_torch.data.synthetic import torus_cloud
    from pcgcv2_torch.eval.metrics import pc_metrics
    from pcgcv2_torch.ops import blocks as B

    log("== phase 4: vox10 frame, ckpts/r4, full width ==")
    cloud = torus_cloud(684, density=4.0, seed=0)
    n = len(cloud)
    params = load_params(str(ROOT / "ckpts/r4/r4_final.ckpt"))
    results = {}
    for dtype in ("bfloat16", "float32"):
        B.set_compute_dtype(dtype)
        coder = Coder(params, os.path.join(workdir, f"vox10_{dtype}"),
                      res=1024, device=device)
        run_frame(coder, cloud, "_w")  # warm-up
        torch.cuda.reset_peak_memory_stats()
        best_enc = best_dec = float("inf")
        for rep in range(VOX10_REPS):
            enc_s, dec_s, dec, launches, tc = run_frame(coder, cloud,
                                                        f"_{rep}")
            log(f"vox10 {dtype} rep {rep}: enc {enc_s:.4f} s  dec "
                f"{dec_s:.4f} s  decoded {len(dec)} / {n}  conv3 launches "
                f"{launches} ({tc} tensor-core)  [{card}]")
            assert len(dec) == n, f"decoded {len(dec)} points, input {n}"
            assert launches == 64 and tc == 64, \
                f"{launches} conv3 launches, {tc} tc (want 64, all tc)"
            best_enc, best_dec = min(best_enc, enc_s), min(best_dec, dec_s)
        peak = torch.cuda.max_memory_allocated()
        bits = sum(8 * v for v in coder.bitstream_bytes("_0").values())
        d1 = pc_metrics(cloud, np.unique(dec, axis=0), 1024,
                        with_d2=False)["mseF,PSNR (p2point)"]
        results[dtype] = {
            "enc_s": best_enc, "dec_s": best_dec, "total_s": best_enc + best_dec,
            "launches": launches, "tc_launches": tc, "peak_bytes": peak,
            "bpp": bits / n,
            "d1_psnr": d1, "n_points": n,
        }
        log(f"vox10 {dtype}: best enc {best_enc:.4f} s + dec {best_dec:.4f} s "
            f"= {best_enc + best_dec:.4f} s  peak device memory "
            f"{peak / 2**30:.2f} GiB  bpp {bits / n:.6f}  D1 {d1:.4f} dB  "
            f"[{card}]")
        want_bpp, want_d1 = VOX10_GATES[dtype]
        assert abs(bits / n - want_bpp) <= 0.005 * want_bpp, \
            f"vox10 {dtype} bpp {bits / n} vs {want_bpp}"
        assert abs(d1 - want_d1) <= 0.05, f"vox10 {dtype} D1 {d1} vs {want_d1}"
    return results


def empty_tiles(coder, cloud) -> dict:
    """Share of empty output tiles over the tensor-core conv3 calls of one
    encode + decode, from the masks with plain torch: per m16 tile (one
    (x, y) row of 16 z), per warp tile (2 rows: the kernel skips its MMAs)
    and per CTA slab (4 x-planes: the kernel skips staging too), over the
    live rows; each also weighted by the call's dense work 27*ci*co."""
    import torch

    from pcgcv2_torch.models import layers
    from pcgcv2_torch.ops import blocks as B
    from pcgcv2_torch.ops import conv3 as K

    real = layers.conv3
    tally = {k: [0, 0, 0.0, 0.0] for k in ("row16", "warp32", "slab4")}

    def spy(bg, nbrs, weight, bias=None, compute_dtype=None, packed=None,
            **kw):
        ci, co = bg.channels, weight.shape[-1]
        if K.route(ci, co, compute_dtype or B.COMPUTE_DTYPE) == "tc":
            n = int(bg.count)
            m = bg.mask[:n].reshape(n, B.BS, B.BS, B.BS)
            rows = m.any(-1)
            for name, occ in (("row16", rows),
                              ("warp32", rows.reshape(n, B.BS, 8, 2).any(-1)),
                              ("slab4", m.reshape(n, 4, -1).any(-1))):
                empty = occ.numel() - int(occ.sum())
                t = tally[name]
                t[0] += empty
                t[1] += occ.numel()
                t[2] += empty * 27 * ci * co
                t[3] += occ.numel() * 27 * ci * co
        return real(bg, nbrs, weight, bias, compute_dtype, packed, **kw)

    layers.conv3 = spy
    try:
        run_frame(coder, cloud, "_tiles")
    finally:
        layers.conv3 = real
    torch.cuda.synchronize()
    return {name: {"empty": t[0], "tiles": t[1], "share": t[0] / t[1],
                   "work_share": t[2] / t[3]} for name, t in tally.items()}


def phase_profile(device, workdir: str):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pcgcv2_torch.checkpoint import load_params
    from pcgcv2_torch.codec.coder import Coder
    from pcgcv2_torch.data.synthetic import torus_cloud
    from pcgcv2_torch.ops import blocks as B

    log("== phase 5: profiler breakdown, one vox10 encode + decode ==")
    cloud = torus_cloud(684, density=4.0, seed=0)
    params = load_params(str(ROOT / "ckpts/r4/r4_final.ckpt"))
    OUT_DIR.mkdir(exist_ok=True)
    summary = {}
    for dtype in ("bfloat16", "float32"):
        B.set_compute_dtype(dtype)
        coder = Coder(params, os.path.join(workdir, f"prof_{dtype}"),
                      res=1024, device=device)
        run_frame(coder, cloud, "_w")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            enc_s, dec_s, _, _, _ = run_frame(coder, cloud, "_p")
        ka = prof.key_averages()
        attr = ("device_time_total" if hasattr(ka[0], "device_time_total")
                else "cuda_time_total")
        kernels = sorted(
            (e for e in ka
             if e.device_type == torch.autograd.DeviceType.CUDA),
            key=lambda e: -getattr(e, attr))
        dev_ms = sum(getattr(e, attr) for e in kernels) / 1e3
        conv = [e for e in kernels
                if "conv3_kernel" in e.key or "conv3_tc_kernel" in e.key]
        conv_ms = sum(getattr(e, attr) for e in conv) / 1e3
        conv_n = sum(e.count for e in conv)
        tc_ms = sum(getattr(e, attr) for e in conv
                    if "conv3_tc_kernel" in e.key) / 1e3
        wall_ms = (enc_s + dec_s) * 1e3
        (OUT_DIR / f"profile_{dtype}.txt").write_text(
            ka.table(sort_by=attr, row_limit=60))
        summary[dtype] = {
            "wall_ms": wall_ms, "enc_ms": enc_s * 1e3, "dec_ms": dec_s * 1e3,
            "device_ms": dev_ms, "conv3_ms": conv_ms, "conv3_launches": conv_n,
            "conv3_tc_ms": tc_ms, "idle_share": 1.0 - dev_ms / wall_ms,
        }
        log(f"profile {dtype}: wall {wall_ms:.2f} ms (enc {enc_s * 1e3:.2f} "
            f"+ dec {dec_s * 1e3:.2f}); device kernels {dev_ms:.2f} ms, of "
            f"which conv3 {conv_ms:.2f} ms in {conv_n} launches (tensor-core "
            f"{tc_ms:.2f} ms); device idle "
            f"{100 * (1 - dev_ms / wall_ms):.1f}% of wall")
        for e in kernels[:12]:
            log(f"  {getattr(e, attr) / 1e3:9.3f} ms  x{e.count:<5d} "
                f"{e.key[:100]}")
        tiles = empty_tiles(coder, cloud)
        summary[f"empty_tiles_{dtype}_tc"] = tiles
        for name, t in tiles.items():
            log(f"empty output tiles of the {dtype} tc convs, {name}: "
                f"{t['empty']} / {t['tiles']} = {100 * t['share']:.2f}% "
                f"({100 * t['work_share']:.2f}% of the dense work)")
    return summary


# ---------------------------------------------------------------------------
# Phase 6: the streamed decode and the rate-sweep CLI
# ---------------------------------------------------------------------------


def point_keys(pts):
    """One int64 key per (x, y, z) row (coords < 2^21)."""
    import numpy as np

    c = np.asarray(pts, dtype=np.int64)
    return (c[:, 0] << 42) | (c[:, 1] << 21) | c[:, 2]


def sym_diff(a, b) -> int:
    """Points in exactly one of the two sets."""
    import numpy as np

    return len(np.setxor1d(point_keys(a), point_keys(b)))


def timed(fn):
    """(seconds, result) of fn(), the clock stopped after a device sync."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def peak_of(fn):
    """(seconds, peak device bytes, result) of fn(), the peak counted from
    a reset just before it."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sec, out = timed(fn)
    return sec, torch.cuda.max_memory_allocated(), out


def counted(fn):
    """(result, conv3 launches, tensor-core launches) of fn(), the counts
    set to 0 just before it and read just after."""
    from pcgcv2_torch.ops import conv3 as K

    K.conv3.launches = K.conv3.tc_launches = 0
    out = fn()
    return out, K.conv3.launches, K.conv3.tc_launches


def monolithic_decode(coder, postfix: str):
    """The decode of `coder`'s stream through model.decode_fn on the
    exact-fit plan, whatever the plan's res (Coder.decode streams at res
    >= 2048): the streamed decode's comparison."""
    import numpy as np
    import torch

    from pcgcv2_torch.codec.coder import canonical_order
    from pcgcv2_torch.ops import blocks as B

    coords = coder.coordinate_coder.decode(postfix)
    coords = coords[canonical_order(coords)]
    feats = coder.feature_coder.decode(postfix)
    with open(coder.filename + postfix + "_num_points.bin", "rb") as f:
        head = np.frombuffer(f.read(28), dtype=np.int32)
    plan = coder._plan_from_counts(head[3:7])
    dev = coder.device
    y = B.blockify(coder._rows(coords * 8),
                   torch.from_numpy(feats).to(dev, B.COMPUTE_DTYPE),
                   torch.ones(len(coords), dtype=torch.bool, device=dev),
                   plan.nb[3], stride=8, res=plan.res // 8, num_batches=1)
    nums = torch.tensor(head[:3].tolist(), dtype=torch.int32, device=dev)
    with torch.inference_mode():
        out = coder.model.decode_fn(y, [nums[0:1], nums[1:2], nums[2:3]],
                                    plan)
        assert int(out.dropped) == 0, "monolithic decode overflowed"
        bc, bits = B.pack_occupancy(out)
    return B.host_extract(bc.cpu().numpy(), bits.cpu().numpy())


def phase_streamed(device, workdir: str, card: str):
    import numpy as np
    import torch

    from pcgcv2_torch.checkpoint import load_params
    from pcgcv2_torch.cli.test import run_sweep
    from pcgcv2_torch.codec.coder import Coder, block_counts
    from pcgcv2_torch.config import BlockPlan
    from pcgcv2_torch.data.io import write_ply_ascii_geo
    from pcgcv2_torch.data.synthetic import torus_cloud
    from pcgcv2_torch.eval.metrics import pc_metrics
    from pcgcv2_torch.ops import blocks as B

    params = load_params(str(ROOT / "ckpts/r4/r4_final.ckpt"))
    result = {}

    # (a) vox10 frame, 8 slabs against the monolithic decode
    log("== phase 6a: vox10 streamed decode (8 slabs) vs monolithic ==")
    cloud = torus_cloud(684, density=4.0, seed=0)
    n = len(cloud)
    for dtype in ("bfloat16", "float32"):
        B.set_compute_dtype(dtype)
        coder = Coder(params, os.path.join(workdir, f"s10_{dtype}"),
                      res=1024, device=device)
        coder.encode(cloud)
        bits = sum(8 * v for v in coder.bitstream_bytes().values())
        times = {0: [], 8: []}
        runs = {}
        for rnd in range(4):  # round 0 warms both up; then best of 3
            for slabs in (0, 8):  # in turns: monolithic, streamed
                coder.streamed_slabs = slabs
                (sec, dec), launches, tc = counted(
                    lambda: timed(coder.decode))
                if rnd:
                    times[slabs].append(sec)
                runs[slabs] = (dec, launches, tc)
        best = {k: min(v) for k, v in times.items()}
        mono = runs[0][0]
        streamed, s_launches, s_tc = runs[8]
        diff = sym_diff(streamed, mono)
        d1 = pc_metrics(cloud, np.unique(streamed, axis=0), 1024,
                        with_d2=False)["mseF,PSNR (p2point)"]
        ratio = best[8] / best[0]
        log(f"vox10 {dtype}: streamed decoded {len(streamed)} / {n}, "
            f"monolithic {len(mono)}; symmetric difference {diff} points "
            f"({100 * diff / n:.4f}%)  bpp {bits / n:.6f}  D1 {d1:.4f} dB  "
            f"decode best of 3: monolithic {best[0]:.4f} s, streamed "
            f"{best[8]:.4f} s, ratio {ratio:.3f}  conv3 launches of the "
            f"streamed decode {s_launches} ({s_tc} tensor-core)  [{card}]")
        assert len(streamed) == len(mono) == n, "vox10 streamed count"
        assert diff <= 1e-4 * n, f"vox10 streamed differs by {diff} points"
        want_bpp, want_d1 = VOX10_GATES[dtype]
        assert abs(bits / n - want_bpp) <= 0.005 * want_bpp, "vox10 bpp"
        assert abs(d1 - want_d1) <= 0.05, f"vox10 streamed D1 {d1}"
        assert s_launches == s_tc == 22 + 8 * 11, \
            f"{s_launches} conv3 launches ({s_tc} tc), want 110, all tc"
        result[f"vox10_{dtype}"] = {
            "decoded": len(streamed), "sym_diff": diff, "bpp": bits / n,
            "d1_psnr": d1, "mono_dec_s": best[0], "streamed_dec_s": best[8],
            "ratio": ratio, "launches": s_launches, "tc_launches": s_tc,
        }
        del coder
        torch.cuda.empty_cache()

    # (b) vox11-class frame, whole (scaling factor 1), streamed by default
    log("== phase 6b: vox11-class frame (res 2048), streamed decode ==")
    cloud = torus_cloud(1390, density=4.0, seed=11)
    n = len(cloud)
    plan = BlockPlan.for_frame(2048, block_counts(cloud))
    slab_cap = max(256, plan.up_cap(2) * 2 // 8)
    log(f"vox11 frame: {n} voxels, plan nb {plan.nb}, slab candidate cap "
        f"{slab_cap}")
    assert slab_cap == VOX11_SLAB_CAP, "phase 2's slab shapes are stale"
    for dtype, reps in (("bfloat16", 3), ("float32", 1)):
        B.set_compute_dtype(dtype)
        coder = Coder(params, os.path.join(workdir, f"vox11_{dtype}"),
                      res=2048, device=device)
        if reps > 1:
            run_frame(coder, cloud, "_w")
        enc = []
        dec = []
        for rep in range(reps):
            (enc_s, enc_peak, _), launches_e, tc_e = counted(
                lambda: peak_of(lambda: coder.encode(cloud, f"_{rep}")))
            (dec_s, dec_peak, out), launches_d, tc_d = counted(
                lambda: peak_of(lambda: coder.decode(postfix=f"_{rep}")))
            launches, tc = launches_e + launches_d, tc_e + tc_d
            log(f"vox11 {dtype} rep {rep}: enc {enc_s:.4f} s (peak "
                f"{enc_peak / 2**30:.2f} GiB)  dec {dec_s:.4f} s (peak "
                f"{dec_peak / 2**30:.2f} GiB)  decoded {len(out)} / {n}  "
                f"conv3 launches {launches} ({tc} tensor-core)  [{card}]")
            assert len(out) == n, f"vox11 decoded {len(out)} of {n}"
            assert launches == tc == 141, \
                f"{launches} conv3 launches ({tc} tc), want 141, all tc"
            enc.append((enc_s, enc_peak))
            dec.append((dec_s, dec_peak))
        bits = sum(8 * v for v in coder.bitstream_bytes("_0").values())
        d1 = pc_metrics(cloud, np.unique(out, axis=0), 2048,
                        with_d2=False)["mseF,PSNR (p2point)"]
        row = {
            "n_points": n, "decoded": len(out), "reps": reps,
            "enc_s": min(e[0] for e in enc), "dec_s": min(d[0] for d in dec),
            "enc_peak_bytes": max(e[1] for e in enc),
            "dec_peak_bytes": max(d[1] for d in dec),
            "bpp": bits / n, "d1_psnr": d1, "launches": launches,
            "tc_launches": tc,
        }
        if dtype == "bfloat16":
            torch.cuda.empty_cache()
            mono_s, mono_peak, mono = peak_of(
                lambda: monolithic_decode(coder, f"_{reps - 1}"))
            diff = sym_diff(out, mono)
            row.update(mono_dec_s=mono_s, mono_dec_peak_bytes=mono_peak,
                       mono_decoded=len(mono), sym_diff=diff)
            log(f"vox11 {dtype} monolithic decode (model.decode_fn): "
                f"{mono_s:.4f} s, peak {mono_peak / 2**30:.2f} GiB, "
                f"decoded {len(mono)}; symmetric difference to the streamed "
                f"set {diff} points ({100 * diff / n:.4f}%)  [{card}]")
            assert len(mono) == n and diff <= 1e-4 * n, "vox11 monolithic"
        log(f"vox11 {dtype}: best enc {row['enc_s']:.4f} s + dec "
            f"{row['dec_s']:.4f} s (of {reps})  peak enc "
            f"{row['enc_peak_bytes'] / 2**30:.2f} GiB, dec "
            f"{row['dec_peak_bytes'] / 2**30:.2f} GiB  bpp {bits / n:.6f}  "
            f"D1 {d1:.4f} dB  [{card}]")
        want_bpp, want_d1 = VOX11_GATES[dtype]
        assert abs(bits / n - want_bpp) <= 0.005 * want_bpp, \
            f"vox11 {dtype} bpp {bits / n} vs {want_bpp}"
        assert abs(d1 - want_d1) <= 0.05, f"vox11 {dtype} D1 {d1} vs {want_d1}"
        result[f"vox11_{dtype}"] = row
        del coder
        torch.cuda.empty_cache()

    # (c) the rate-sweep CLI on the golden frame
    log("== phase 6c: pcgcv2_torch.cli.test.run_sweep, golden frame ==")
    B.set_compute_dtype("float32")
    exp = json.loads((ROOT / "tests/golden/expected.json").read_text())
    cloud = torus_cloud(170, density=2.0, seed=42)
    ply = os.path.join(workdir, "golden_torus.ply")
    write_ply_ascii_geo(ply, cloud)
    (rows, launches, tc) = counted(lambda: run_sweep(
        ply, [str(ROOT / "tests/golden/golden.ckpt")],
        os.path.join(workdir, "sweep_out"), os.path.join(workdir, "sweep"),
        res=256, device=device))
    (row,) = rows
    d1 = row["mseF,PSNR (p2point)"]
    log(f"cli.test golden row: output {row['num_points(output)']} points  "
        f"bpp {row['bpp']}  D1 {d1:.4f} dB  time(enc) {row['time(enc)']} s  "
        f"time(dec) {row['time(dec)']} s  conv3 launches {launches} ({tc} "
        f"tensor-core, warm-up included)")
    assert row["num_points(output)"] == exp["n_points"], "cli output count"
    assert abs(row["bpp"] - 0.534) <= 0.005 * 0.534, "cli bpp"
    assert abs(d1 - exp["d1_psnr"]) <= 0.05, "cli D1"
    assert launches == tc == 128, f"cli {launches} launches ({tc} tc)"
    result["cli"] = {k: row[k] for k in (
        "num_points(output)", "bpp", "mseF,PSNR (p2point)", "time(enc)",
        "time(dec)")}
    return result


# ---------------------------------------------------------------------------
# Phase 7: training
# ---------------------------------------------------------------------------


def train_batch():
    """The 8 clouds of one training batch, as scripts/train_rd.py draws
    them: random_surface_cloud(127, seed=s, density=2.0), s = 0..7."""
    from pcgcv2_torch.data.synthetic import random_surface_cloud

    return [random_surface_cloud(127, seed=s, density=2.0)
            for s in range(TRAIN_BATCH)]


def wgrad_bound(bg, nbrs, ci: int, co: int, dtype: str):
    """(bytes ms, operations ms) of conv3_wgrad's bound.  Bytes: the mask
    of the live rows (where the occupied slots are found), dy at the
    occupied slots only, x at the slots within the 3^3 neighbourhood of an
    occupied one, the neighbour rows, and the f32 [27, ci, co] result: no
    dense output, unlike the forward and dX.  Operations: 2*ci*co per pair
    of an occupied output voxel and an occupied input voxel of its 3^3
    neighbourhood, as `conv3_bound` counts them."""
    import torch
    import torch.nn.functional as F

    from pcgcv2_torch.ops import blocks as B
    from pcgcv2_torch.ops.conv3 import halo

    elt = 4 if dtype == "float32" else 2
    rows = int(bg.count)
    live = (bg.mask & bg.valid[:, None]).float()
    hm = halo(live[:, :, None], nbrs[:rows]).permute(0, 4, 1, 2, 3)
    cnt = F.conv3d(hm, torch.ones(1, 1, 3, 3, 3, device=live.device))
    cnt = cnt.reshape(rows, B.VOL)
    occupied = float(live.sum())
    reached = float((cnt > 0).sum())
    pairs = float((cnt * live[:rows]).sum())
    nbytes = (rows * B.VOL + occupied * co * elt + reached * ci * elt
              + rows * 27 * 4 + 27 * ci * co * 4)
    ops = 2.0 * ci * co * pairs
    return nbytes / HBM_BPS * 1e3, ops / PEAK_FLOPS[dtype] * 1e3


def lib_grads(bg, nbrs, w, dy, cd):
    """The library's conv3 input and weight gradients (cuDNN through
    torch.nn.grad) on the assembled halo of the live rows: two callables,
    dense part only."""
    import torch

    from pcgcv2_torch.ops import conv3 as K

    n = int(bg.count)
    h = K.halo(bg.feats.to(cd), nbrs[:n]).permute(0, 4, 1, 2, 3).contiguous()
    go = dy[:n].to(cd).reshape(n, 16, 16, 16, -1).permute(
        0, 4, 1, 2, 3).contiguous()
    wl = w.to(cd).permute(4, 3, 0, 1, 2).contiguous()
    gi = torch.nn.grad.conv3d_input
    gw = torch.nn.grad.conv3d_weight
    return (lambda: gi(h.shape, wl, go), lambda: gw(h, wl.shape, go))


def check_backward(bg, dy, nbrs, cd, dw, dx, real_dgrad, real_wgrad):
    """One conv3 backward of a training step, on its own inputs: the input
    grid `bg`, dy masked to the live slots, and the kernels' dW and (but
    for the first conv) (weight, packed flip, dX).  Holds them against f32
    autograd through conv3_plain on the same rounded inputs, checks that a
    second dW launch on the same inputs gives the same bits, and times the
    kernels, the plain versions and cuDNN there."""
    import torch

    from pcgcv2_torch.ops import blocks as B
    from pcgcv2_torch.ops import conv3 as K

    dtype = {torch.float32: "float32", torch.bfloat16: "bfloat16"}[cd]
    ci, co = bg.channels, dy.shape[-1]
    weight = dx[0] if dx is not None else torch.zeros(
        3, 3, 3, ci, co, dtype=cd, device=dy.device)  # dW does not read it
    with torch.enable_grad():
        x = bg.feats.detach().to(cd).float().requires_grad_(True)
        w = weight.detach().float().requires_grad_(True)
        out = K.conv3_plain(bg.replace(feats=x), nbrs, w, None,
                            torch.float32)
        rdx, rdw = torch.autograd.grad((out.feats * dy.float()).sum(),
                                       (x, w))
    del out
    live = bg.mask & bg.valid[:, None]
    r = {"nb_cap": bg.nb_cap, "stride": bg.stride,
         "live_rows": int(bg.count),
         "occupancy": float(live.sum()) / (int(bg.count) * B.VOL),
         "ci": ci, "co": co, "dx": dx is not None,
         "dw_max_abs_err": float((dw - rdw).abs().max()),
         "dw_max_abs_ref": float(rdw.abs().max())}
    r["dw_same_bits"] = torch.equal(dw, real_wgrad(bg, dy, nbrs, cd))
    ok = r["dw_same_bits"] and (
        r["dw_max_abs_err"] <= TRAIN_TOL["dw"][dtype] * r["dw_max_abs_ref"])
    lib_dx, lib_dw = lib_grads(bg, nbrs, weight, dy, cd)
    r["dw_ms"] = cuda_ms(lambda: real_wgrad(bg, dy, nbrs, cd), KERNEL_REPS)
    r["dw_plain_ms"] = cuda_ms(
        lambda: K.conv3_wgrad_plain(bg, dy, nbrs, cd), 3)
    r["dw_library_ms"] = cuda_ms(lib_dw, KERNEL_REPS)
    r["dw_bytes_ms"], r["dw_ops_ms"] = wgrad_bound(bg, nbrs, ci, co, dtype)
    if dx is not None:
        _, packed_flip, got = dx
        lv = live[:, :, None].expand_as(rdx)
        r["dx_max_abs_err"] = float((got.float() - rdx)[lv].abs().max())
        r["dx_max_abs_ref"] = float(rdx[lv].abs().max())
        r["dx_zero_off_live"] = float(got.float()[~lv].abs().max()) == 0.0
        ok = ok and r["dx_zero_off_live"] and (
            r["dx_max_abs_err"]
            <= TRAIN_TOL["dx"][dtype] * r["dx_max_abs_ref"])
        gbg = bg.replace(feats=dy)
        wf = K.flip_weight(weight)
        r["dx_route"] = K.route(co, ci, cd)
        r["dx_ms"] = cuda_ms(
            lambda: real_dgrad(gbg, nbrs, weight, cd, packed_flip),
            KERNEL_REPS)
        r["dx_plain_ms"] = cuda_ms(
            lambda: K.conv3_plain(gbg, nbrs, wf, None, cd), 3)
        r["dx_library_ms"] = cuda_ms(lib_dx, KERNEL_REPS)
        # dX moves and computes what the forward conv (co -> ci) does
        r["dx_bytes_ms"], r["dx_ops_ms"] = conv3_bound(gbg, nbrs, co, ci,
                                                       dtype)
    r["ok"] = ok
    return r


@contextlib.contextmanager
def spy_backward(rows: list):
    """While open, every conv3 backward (`Conv3Fn` calls conv3_dgrad, then
    conv3_wgrad) goes through the kernels as usual and is then checked
    and timed on its own inputs by `check_backward`, one row each."""
    import functools

    from pcgcv2_torch.ops import conv3 as K

    real_dgrad, real_wgrad = K.conv3_dgrad, K.conv3_wgrad
    pending = []

    @functools.wraps(real_dgrad)  # copies the launch counters too
    def dgrad(bg, nbrs, weight, compute_dtype=None, packed_flip=None):
        out = real_dgrad(bg, nbrs, weight, compute_dtype, packed_flip)
        pending.append((weight, packed_flip, out.feats))
        return out

    @functools.wraps(real_wgrad)
    def wgrad(bg, dy, nbrs, compute_dtype=None):
        dw = real_wgrad(bg, dy, nbrs, compute_dtype)
        assert len(pending) <= 1, "a dX without its dW"
        rows.append(check_backward(
            bg, dy, nbrs, compute_dtype, dw,
            pending.pop() if pending else None, real_dgrad, real_wgrad))
        return dw

    K.conv3_dgrad, K.conv3_wgrad = dgrad, wgrad
    try:
        yield
    finally:
        K.conv3_dgrad, K.conv3_wgrad = real_dgrad, real_wgrad


def make_trainer(dtype: str, workdir: str, device):
    """The trainer of scripts/train_rd.py at full width: `ModelConfig()`
    (remat on), alpha 2, beta 1, lr 8e-4, for_training(524288, 128, 8),
    in `dtype` compute."""
    from pcgcv2_torch.config import BlockPlan, ModelConfig, TrainConfig
    from pcgcv2_torch.ops import blocks as B
    from pcgcv2_torch.train.trainer import Trainer

    B.set_compute_dtype(dtype)
    plan = BlockPlan.for_training(TRAIN_CAPACITY, TRAIN_RES, TRAIN_BATCH)
    cfg = TrainConfig(alpha=2.0, beta=1.0, lr=8e-4, batch_size=TRAIN_BATCH)
    return Trainer(cfg, plan, TRAIN_CAPACITY, ModelConfig(),
                   logdir=os.path.join(workdir, f"tl_{dtype}"),
                   ckptdir=os.path.join(workdir, f"tc_{dtype}"),
                   seed=0, device=device)


def phase_train_kernels(device, workdir: str, clouds):
    """7a: one full-width training step per dtype (f32, bf16) with every
    conv3 backward spied on: conv3_dgrad (conv3_tc.cu on the flipped
    weight) and conv3_wgrad (conv3_wgrad.cu) held against autograd through
    conv3_plain and timed on the step's own inputs."""
    import torch

    log("== phase 7a: conv3 backward kernels of one training step vs "
        "autograd through conv3_plain, on the step's own inputs ==")
    result = {}
    for dtype in ("float32", "bfloat16"):
        tr = make_trainer(dtype, f"{workdir}/7a", device)
        coords, valid = tr._collate(clouds)
        rows = []
        with spy_backward(rows):
            tr.step(coords, valid)
        torch.cuda.synchronize()
        del tr
        torch.cuda.empty_cache()
        n_dx = sum(r["dx"] for r in rows)
        log_backward(rows, dtype)
        bad = [r for r in rows if not r["ok"]]
        if bad:
            raise AssertionError(
                f"conv3 backward kernels disagree in {len(bad)} of "
                f"{len(rows)} calls ({dtype}); first: {bad[0]} (tolerance "
                f"dX {TRAIN_TOL['dx'][dtype]}, dW {TRAIN_TOL['dw'][dtype]} "
                f"of max |ref|)")
        assert (n_dx, len(rows)) == TRAIN_LAUNCHES[2::2], \
            f"{n_dx} dX and {len(rows)} dW calls in a step ({dtype})"
        result[dtype] = rows
    return result


def log_backward(rows, dtype: str) -> None:
    """Phase 7a's rows by shape (calls summed), then the step's totals."""
    groups = {}
    for r in rows:
        groups.setdefault((r["nb_cap"], r["stride"], r["ci"], r["co"]),
                          []).append(r)
    for (nb_cap, stride, ci, co), rs in groups.items():
        dxs = [r for r in rs if r["dx"]]

        def tot(key, sel=rs):
            return sum(r[key] for r in sel)

        def worst(k, sel=rs):
            return max((r[f"{k}_max_abs_err"] / r[f"{k}_max_abs_ref"]
                        for r in sel), default=float("nan"))

        dx = (f"dX x{len(dxs)} {tot('dx_ms', dxs):.4f} ms plain "
              f"{tot('dx_plain_ms', dxs):.4f} cuDNN "
              f"{tot('dx_library_ms', dxs):.4f} bound "
              f"{tot('dx_bytes_ms', dxs):.4f}/{tot('dx_ops_ms', dxs):.4f} "
              f"err/|ref| {worst('dx', dxs):.3g}") if dxs else "no dX"
        log(f"conv3 bwd {dtype:<8s} nb={nb_cap:<5d} s={stride} ci={ci:<3d} "
            f"co={co:<3d} live {rs[0]['live_rows']} occ "
            f"{rs[0]['occupancy']:.3f} | {dx} | dW x{len(rs)} "
            f"{tot('dw_ms'):.4f} ms plain {tot('dw_plain_ms'):.4f} cuDNN "
            f"{tot('dw_library_ms'):.4f} bound {tot('dw_bytes_ms'):.4f}/"
            f"{tot('dw_ops_ms'):.4f} err/|ref| {worst('dw'):.3g} same bits "
            f"{all(r['dw_same_bits'] for r in rs)} "
            f"{'OK' if all(r['ok'] for r in rs) else 'FAIL'}")
    t = {k: per_step_sum(rows, k) for k in (
        "dx_ms", "dx_plain_ms", "dx_library_ms", "dx_bound_ms", "dw_ms",
        "dw_plain_ms", "dw_library_ms", "dw_bound_ms")}
    log(f"conv3 backward per training step, {dtype}: dX {t['dx_ms']:.3f} ms "
        f"(plain {t['dx_plain_ms']:.3f}, cuDNN {t['dx_library_ms']:.3f}, "
        f"bound {t['dx_bound_ms']:.4f}); dW {t['dw_ms']:.3f} ms (plain "
        f"{t['dw_plain_ms']:.3f}, cuDNN {t['dw_library_ms']:.3f}, bound "
        f"{t['dw_bound_ms']:.4f})")


def per_step_sum(rows, key: str) -> float:
    """A phase-7a column summed over the step's backward calls (dX columns
    over the calls with a dX); `*_bound_ms` is each call's bound, the
    larger of its bytes and operations times."""
    p = key[:2]
    sel = [r for r in rows if p == "dw" or r["dx"]]
    if key.endswith("_bound_ms"):
        return sum(max(r[f"{p}_bytes_ms"], r[f"{p}_ops_ms"]) for r in sel)
    return sum(r[key] for r in sel)


def backward_counts():
    """(forward, forward on the tensor cores, dX, dX on the tensor cores,
    dW) conv3 launches since the counts were last set to 0."""
    from pcgcv2_torch.ops import conv3 as K

    return (K.conv3.launches, K.conv3.tc_launches, K.conv3_dgrad.launches,
            K.conv3_dgrad.tc_launches, K.conv3_wgrad.launches)


def zero_counts() -> None:
    from pcgcv2_torch.ops import conv3 as K

    K.conv3.launches = K.conv3.tc_launches = 0
    K.conv3_dgrad.launches = K.conv3_dgrad.tc_launches = 0
    K.conv3_wgrad.launches = 0


def phase_train_steps(device, workdir: str, card: str, clouds):
    """7b: trainer steps at full width on one fixed batch, bf16 then f32:
    a warm-up step, 5 timed steps, then steps up to TRAIN_STEPS; launches
    per step, loss terms, peak memory."""
    import torch

    from pcgcv2_torch.config import BlockPlan

    from torch.profiler import ProfilerActivity, profile

    log("== phase 7b: full-width training steps (8 clouds, "
        "for_training(524288, 128, 8), remat on) ==")
    result = {}
    plan = BlockPlan.for_training(TRAIN_CAPACITY, TRAIN_RES, TRAIN_BATCH)
    log(f"plan nb {plan.nb} dec_nb {plan.dec_nb} up caps "
        f"{[plan.up_cap(s) for s in range(3)]}; "
        f"{sum(len(c) for c in clouds)} voxels")
    for dtype in ("bfloat16", "float32"):
        tr = make_trainer(dtype, workdir, device)
        coords, valid = tr._collate(clouds)
        steps = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for i in range(TRAIN_STEPS):
            zero_counts()
            last = i == TRAIN_STEPS - 1
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) \
                if last else contextlib.nullcontext()
            with prof:
                t0 = time.perf_counter()
                d, _, n_drop = tr.step(coords, valid)
                torch.cuda.synchronize()
                sec = time.perf_counter() - t0
            counts = backward_counts()
            if last:  # the last step runs under the profiler
                result[f"profile_{dtype}"] = train_profile(prof, sec, dtype)
            s = {"ms": sec * 1e3, "loss": d["loss"].item(),
                 "bce": d["bce"].item(), "bpp": d["bpp"].item(),
                 "dropped": int(n_drop), "launches": counts}
            steps.append(s)
            log(f"train {dtype} step {i}: {s['ms']:.2f} ms  loss "
                f"{s['loss']:.5f}  bce {s['bce']:.5f}  bpp {s['bpp']:.5f}  "
                f"dropped {s['dropped']}  conv3 fwd {counts[0]} ({counts[1]}"
                f" tc)  dX {counts[2]} ({counts[3]} tc)  dW {counts[4]}")
            if not all(math.isfinite(s[k]) for k in ("loss", "bce", "bpp")):
                raise AssertionError(f"train {dtype} step {i}: not finite")
            assert s["dropped"] == 0, f"train {dtype} step {i} dropped blocks"
            assert counts == TRAIN_LAUNCHES, \
                f"train {dtype} step {i}: launches {counts}, want " \
                f"{TRAIN_LAUNCHES} (fwd, fwd tc, dX, dX tc, dW)"
        peak = torch.cuda.max_memory_allocated()
        timed = [s["ms"] for s in steps[1:6]]
        first, last = steps[0]["loss"], steps[-1]["loss"]
        log(f"train {dtype}: step median {statistics.median(timed):.2f} ms "
            f"(steps 1-5: {', '.join(f'{t:.2f}' for t in timed)})  peak "
            f"device memory {peak / 2**30:.2f} GiB  loss step 0 {first:.5f} "
            f"-> step {TRAIN_STEPS - 1} {last:.5f}  [{card}]")
        assert last < first, f"train {dtype}: loss did not fall"
        result[dtype] = {
            "step_ms_median": statistics.median(timed), "step_ms": timed,
            "profiled_step_ms": steps[-1]["ms"],
            "warmup_ms": steps[0]["ms"], "peak_bytes": peak,
            "losses": [s["loss"] for s in steps],
            "bce": [s["bce"] for s in steps],
            "bpp": [s["bpp"] for s in steps],
            # the counts read after the last step (every step gated)
            "launches": dict(zip(("fwd", "fwd_tc", "dx", "dx_tc", "dw"),
                                 steps[-1]["launches"])),
            "dropped": 0,
        }
        del tr
        torch.cuda.empty_cache()
    return result


def train_profile(prof, sec: float, dtype: str) -> dict:
    """Device time of one profiled training step by kernel: the conv3
    kernels (forward and dX share conv3_tc_kernel; dW is the two
    conv3_wgrad kernels), everything else, and the device idle share of
    the step's wall.  The table goes to OUT_DIR."""
    import torch

    ka = prof.key_averages()
    attr = ("device_time_total" if hasattr(ka[0], "device_time_total")
            else "cuda_time_total")
    kernels = sorted(
        (e for e in ka if e.device_type == torch.autograd.DeviceType.CUDA),
        key=lambda e: -getattr(e, attr))

    def ms(pred):
        return sum(getattr(e, attr) for e in kernels if pred(e.key)) / 1e3

    dev_ms = ms(lambda k: True)
    tc_ms = ms(lambda k: "conv3_tc_kernel" in k)
    dw_ms = ms(lambda k: "wgrad_" in k)
    wall_ms = sec * 1e3
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / f"profile_train_{dtype}.txt").write_text(
        ka.table(sort_by=attr, row_limit=60))
    log(f"profile train {dtype}: wall {wall_ms:.2f} ms (under the "
        f"profiler); device kernels {dev_ms:.2f} ms, of which conv3_tc "
        f"(forward + dX) {tc_ms:.2f} ms and conv3_wgrad {dw_ms:.2f} ms; "
        f"device idle {100 * (1 - dev_ms / wall_ms):.1f}% of wall")
    for e in kernels[:12]:
        log(f"  {getattr(e, attr) / 1e3:9.3f} ms  x{e.count:<5d} "
            f"{e.key[:100]}")
    return {"wall_ms": wall_ms, "device_ms": dev_ms, "conv3_tc_ms": tc_ms,
            "conv3_wgrad_ms": dw_ms, "idle_share": 1.0 - dev_ms / wall_ms,
            "top": [(e.key[:100], getattr(e, attr) / 1e3, e.count)
                    for e in kernels[:12]]}


def phase_train_cli(device, workdir: str):
    """7c: pcgcv2_torch.cli.train on 20 clouds written as .ply, one epoch
    in f32 from a scratch working directory; its checkpoint through Coder
    on the golden frame decodes to the input count."""
    import numpy as np

    from pcgcv2_torch.checkpoint import load_params
    from pcgcv2_torch.cli import train as cli
    from pcgcv2_torch.codec.coder import Coder
    from pcgcv2_torch.data.io import write_ply_ascii_geo
    from pcgcv2_torch.data.synthetic import random_surface_cloud, torus_cloud
    from pcgcv2_torch.ops import blocks as B

    log("== phase 7c: pcgcv2_torch.cli.train, one epoch, f32; its "
        "checkpoint through Coder ==")
    B.set_compute_dtype("float32")
    data = os.path.join(workdir, "train_ply")
    os.makedirs(data)
    for s in range(20):
        write_ply_ascii_geo(os.path.join(data, f"c{s:02d}.ply"),
                            random_surface_cloud(127, seed=s, density=2.0))
    run_dir = os.path.join(workdir, "train_run")
    os.makedirs(run_dir)
    cwd = os.getcwd()
    os.chdir(run_dir)
    try:
        zero_counts()
        t0 = time.perf_counter()
        tr = cli.main(["--dataset", data, "--epoch", "1", "--device",
                       device.type, "--prefix", "smoke"])
        sec = time.perf_counter() - t0
        counts = backward_counts()
    finally:
        os.chdir(cwd)
    ckpts = sorted(Path(run_dir, "ckpts", "smoke").glob("*.ckpt"))
    log(f"cli.train: {sec:.1f} s, epoch {tr.epoch}, checkpoints "
        f"{[p.name for p in ckpts]}, conv3 fwd {counts[0]} dX {counts[2]} "
        f"dW {counts[4]} launches (3 steps and 1 test batch)")
    assert ckpts, "cli.train wrote no checkpoint"
    cloud = torus_cloud(170, density=2.0, seed=42)
    coder = Coder(load_params(str(ckpts[-1])), os.path.join(workdir, "tcli"),
                  res=256, device=device)
    coder.encode(cloud)
    dec = coder.decode()
    log(f"cli.train checkpoint through Coder: decoded {len(dec)} of "
        f"{len(cloud)} points")
    assert len(dec) == len(cloud), "trained checkpoint decoded another count"
    assert len(np.unique(dec, axis=0)) == len(dec)
    return {"seconds": sec, "checkpoint": ckpts[-1].name,
            "decoded": len(dec), "n_points": len(cloud),
            "launches": dict(zip(("fwd", "fwd_tc", "dx", "dx_tc", "dw"),
                                 counts))}


def phase_train(device, workdir: str, card: str):
    clouds = train_batch()
    return {"kernels": phase_train_kernels(device, workdir, clouds),
            "steps": phase_train_steps(device, workdir, card, clouds),
            "cli": phase_train_cli(device, workdir)}


def train_kernel_entries(train) -> list:
    """The kernels line's entries of conv3's backward: times summed over
    the backward calls of one training step (phase 7a), launches counted
    in the step runs (phase 7b), f32 with bf16 beside it."""
    def entry(prefix, dtype):
        rows = [r for r in train["kernels"][dtype]
                if prefix == "dw" or r["dx"]]
        by_bytes = (per_step_sum(rows, f"{prefix}_bytes_ms")
                    >= per_step_sum(rows, f"{prefix}_ops_ms"))
        return {
            "launches": train["steps"][dtype]["launches"][prefix],
            "max_abs_err": max(r[f"{prefix}_max_abs_err"] for r in rows),
            "max_rel_err": max(r[f"{prefix}_max_abs_err"]
                               / r[f"{prefix}_max_abs_ref"] for r in rows),
            **{k: per_step_sum(rows, f"{prefix}_{k}") for k in (
                "ms", "plain_ms", "bound_ms")},
            "bound_by": "bytes" if by_bytes else "operations",
            "library_ms": per_step_sum(rows, f"{prefix}_library_ms"),
        }

    out = []
    for name, prefix, source, how, lib in (
            ("conv3_dgrad", "dx", "pcgcv2_torch/csrc/conv3_tc.cu",
             "tc (conv3_tc.cu on flip_weight(W), mma.sync {})",
             "torch.nn.grad.conv3d_input (cuDNN) on the live rows' halo"),
            ("conv3_wgrad", "dw", "pcgcv2_torch/csrc/conv3_wgrad.cu",
             "conv3_wgrad.cu (CUDA cores, f32 FMA; one pass per live row "
             "for all 27 taps over cp.async-staged input planes, persistent "
             "CTAs, fixed-order sums; {} inputs)",
             "torch.nn.grad.conv3d_weight (cuDNN) on the live rows' halo")):
        out.append({
            "name": name, "route": "cuda", "source": source,
            # no Pallas original: XLA's VJP of blocks.conv3
            "replaces": "pcgcv2_tpu/ops/blocks.py:656",
            **entry(prefix, "float32"), "dtype": "float32",
            "kernel_route": how.format("3xTF32" if prefix == "dx" else "f32"),
            "bfloat16": {**entry(prefix, "bfloat16"), "source": source,
                         "kernel_route": how.format("bf16")},
            "library": lib, "per": "training step",
        })
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--phases", default="1,2,3,4,5,6,7")
    args = p.parse_args(argv)
    phases = {int(x) for x in args.phases.split(",")}

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "pcgcv2_torch").is_dir():
        print(f"chip_smoke: the pcgcv2_torch package is not beside "
              f"{Path(__file__).name}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from pcgcv2_torch.codec import native
    from pcgcv2_torch.ops import conv3 as K

    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as ex:  # one compiler per source, together
        builds = [ex.submit(K.build, True), ex.submit(native.build)]
        for f in builds:
            log(f"built {f.result()}")
    log(f"build: {time.perf_counter() - t0:.1f} s")

    log("== phase 1: card ==")
    card = card_identity()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda}  "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}  "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    report = {"card": card, "phase_s": {}}
    with tempfile.TemporaryDirectory() as workdir:
        for n, key, run in (
                (2, "conv3_shapes", lambda: phase_kernels(device)),
                (3, "golden", lambda: phase_golden(device, workdir)),
                (4, "vox10", lambda: phase_vox10(device, workdir, card)),
                (5, "profile", lambda: phase_profile(device, workdir)),
                (6, "streamed", lambda: phase_streamed(device, workdir,
                                                       card)),
                (7, "train", lambda: phase_train(device, workdir, card))):
            if n in phases:
                t = time.perf_counter()
                report[key] = run()
                report["phase_s"][n] = time.perf_counter() - t
                log(f"phase {n}: {report['phase_s'][n]:.1f} s")

    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    kernels = []
    if "conv3_shapes" in report:
        rows = report["conv3_shapes"]

        def per_frame(dtype, key, path="vox10"):
            return per_frame_sum(rows, path, dtype, key)

        def entry(dtype):
            vox = report.get("vox10", {}).get(dtype, {})
            vox11 = report.get("streamed", {}).get(f"vox11_{dtype}", {})
            by_bytes = per_frame(dtype, "bytes_ms") >= per_frame(dtype, "ops_ms")
            return {
                "launches": vox.get("launches"),
                "max_abs_err": max(r[dtype]["max_abs_err"] for r in rows),
                "ms": per_frame(dtype, "ms"),
                "plain_ms": per_frame(dtype, "plain_ms"),
                "bound_ms": per_frame(dtype, "bound_ms"),
                "bound_by": "bytes" if by_bytes else "operations",
                "library_ms": per_frame(dtype, "library_ms"),
                "tc_launches": vox.get("tc_launches"),
                # the streamed vox11 path: launches of one encode + decode,
                # and the 88 launches of its 8 slabs at the slab cap
                "vox11_streamed": {
                    "launches": vox11.get("launches"),
                    "tc_launches": vox11.get("tc_launches"),
                    "slab_cap": VOX11_SLAB_CAP,
                    **{k: per_frame(dtype, k, "vox11_slab") for k in (
                        "ms", "plain_ms", "bound_ms", "library_ms")},
                    "max_abs_err": max(r[dtype]["max_abs_err"] for r in rows
                                       if r["path"] == "vox11_slab"),
                },
                # the CUDA-core kernel at the same shapes, off the path
                "comparison": {
                    "source": "pcgcv2_torch/csrc/conv3.cu",
                    "ms": per_frame(dtype, "simt_ms"),
                    "max_abs_err": max(r[dtype]["simt_max_abs_err"]
                                       for r in rows),
                },
            }

        # one entry for conv3: times summed over the 64 conv3 calls of one
        # vox10 encode+decode (f32 headline, bf16 alongside), all of them on
        # conv3_tc.cu; the vox11 streamed path's beside them
        kernels.append({
            "name": "conv3",
            "route": "cuda",
            "source": "pcgcv2_torch/csrc/conv3_tc.cu",
            "replaces": "pcgcv2_tpu/ops/pallas_conv.py:119",
            **entry("float32"),
            "dtype": "float32",
            "kernel_route": "tc (conv3_tc.cu, mma.sync 3xTF32)",
            "bfloat16": {
                **entry("bfloat16"),
                "source": "pcgcv2_torch/csrc/conv3_tc.cu",
                "kernel_route": "tc (conv3_tc.cu, mma.sync bf16)",
            },
            "library": "F.conv3d on the assembled halo (dense part only)",
            "train_step_launches": report.get("train", {}).get(
                "steps", {}).get("float32", {}).get("launches", {}).get(
                    "fwd"),
        })
    if "train" in report:
        kernels += train_kernel_entries(report["train"])
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
