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
TOL_F32 = 1e-4      # max abs error, kernel vs plain, f32
TOL_BF16_REL = 2e-2  # max abs error / max |ref|, bf16 kernel vs f32 plain
# vox10 readings of the CUDA-core kernel (chip_smoke.py on an H100,
# 700 W), bf16 and f32: the tensor-core route must keep the codec's result
VOX10_GATES = {"bfloat16": (0.492671, 69.4159), "float32": (0.493043, 69.4005)}
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
    grids = {}
    for nb_cap in sorted({k[0] for k in PER_FRAME}, reverse=True):
        grids[nb_cap] = random_grid(nb_cap, 64, seed=nb_cap, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    for (nb_cap, ci, co), per_frame in PER_FRAME.items():
        base = grids[nb_cap]
        nbrs = B.neighbor_rows(base)
        feats32 = base.feats[:, :, :ci].contiguous()
        w = torch.randn(3, 3, 3, ci, co, device=device, generator=gen)
        w *= math.sqrt(2.0 / (27 * ci))
        b = 0.1 * torch.randn(co, device=device, generator=gen)
        row = {"nb_cap": nb_cap, "live_rows": int(base.count), "ci": ci,
               "co": co, "per_frame": per_frame}
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
            log(f"conv3 nb={nb_cap:<5d} ci={ci:<3d} co={co:<3d} {dtype:<8s} "
                f"x{per_frame}/frame  err={err:.3g} (|ref|max {scale:.3g}) "
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
        torch.cuda.empty_cache()
    for dtype in ("float32", "bfloat16"):
        tot = {k: sum(r["per_frame"] * r[dtype][k] for r in rows)
               for k in ("ms", "simt_ms", "plain_ms", "library_ms",
                         "bound_ms")}
        log(f"conv3 per-frame totals {dtype}: kernel {tot['ms']:.3f} ms  "
            f"(conv3.cu alone {tot['simt_ms']:.3f} ms)  "
            f"plain {tot['plain_ms']:.3f} ms  F.conv3d(halo) "
            f"{tot['library_ms']:.3f} ms  bound {tot['bound_ms']:.4f} ms")
    return rows


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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--phases", default="1,2,3,4,5")
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

    report = {"card": card}
    with tempfile.TemporaryDirectory() as workdir:
        if 2 in phases:
            report["conv3_shapes"] = phase_kernels(device)
        if 3 in phases:
            report["golden"] = phase_golden(device, workdir)
        if 4 in phases:
            report["vox10"] = phase_vox10(device, workdir, card)
        if 5 in phases:
            report["profile"] = phase_profile(device, workdir)

    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    kernels = []
    if "conv3_shapes" in report:
        rows = report["conv3_shapes"]

        def per_frame(dtype, key):
            return sum(r["per_frame"] * r[dtype][key] for r in rows)

        def entry(dtype):
            vox = report.get("vox10", {}).get(dtype, {})
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
        # conv3_tc.cu
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
