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
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
It exits non-zero without a CUDA device or without the pcgcv2_torch
package beside it.  Imports nothing of JAX or of pcgcv2_tpu.
"""

from __future__ import annotations

import argparse
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

    def spy(bg, nbrs, weight, bias=None, compute_dtype=None, packed=None):
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
        return real(bg, nbrs, weight, bias, compute_dtype, packed)

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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--phases", default="1,2,3,4,5,6")
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
                                                       card))):
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
        })
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
