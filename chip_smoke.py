#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pcgcv2_torch) on one NVIDIA GPU.

    python3 chip_smoke.py              # every phase, as the check runs it
    python3 chip_smoke.py --phases 1,2 # card identity + kernel checks only
    python3 chip_smoke.py --phases 1,8 # the parallel paths alone
    python3 chip_smoke.py --phases 1,9 # 8^3 blocks (PCGC_BLOCK_SIZE=8)

Phases (each prints its own lines; any failure exits non-zero):
  1. card identity (nvidia-smi name and power limit); TF32 off; beside
     the later phases, `cuobjdump -sass` of the built library: every
     conv3_tc.cu instance, f32 and bf16, holds the products its plan
     names (HGMMA for wgmma, HMMA for mma.sync) and bulk copies (UBLKCP);
     every conv3_wgrad.cu instance runs the kernel its plan names, HMMA
     in each instance on mma.sync (the tf32 form, and only it, for f32
     dy), none in those on the CUDA cores.
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
     OUT_DIR), with the device time under aten::where, and the share of
     empty output tiles of the tensor-core convs on this frame per dtype
     (m16 tiles, warp tiles, CTAs of 4 x-planes of 16 y rows; the f32
     ci = 64 CTAs cover half of that).
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
        conv3 spied on: the 127 forward launches against conv3_plain on
        their own inputs; dX (conv3_tc.cu on the flipped weight) and dW
        (conv3_wgrad.cu) against autograd through conv3_plain on that
        call's own grid, dy and weight, a second dW launch on the same
        inputs giving the same bits, with kernel / plain / library (cuDNN
        through torch.nn.grad) times and the bound; the trainer's Adam
        (capturable, tensor lr, in-place reset) against torch's plain
        Adam on the step's gradients over 5 steps, an lr halving and a
        reset (parameters and moments within 1e-7 of their max);
     b. the full-width trainer step as scripts/train_rd.py runs it (remat
        on, alpha 2, beta 1, lr 8e-4), bf16 then f32: 12 steps on the
        batch, the median of steps 1-5, peak memory, forward / dX / dW
        launches per step (127 / 63 / 64, every forward and dX on the
        tensor cores), finite losses, no dropped block, a falling loss;
     c. pcgcv2_torch.cli.train for one epoch (f32) on 20 synthetic clouds
        that pcgcv2_torch.cli.generate_dataset --synthetic writes as .ply,
        and its checkpoint through Coder on the golden frame;
     d. Trainer.train_scanned in mode="scan" (one CUDA graph captured
        per epoch, replayed per step) and mode="loop", bf16 and f32:
        from one seed, a scan epoch against a loop epoch of 5 batches
        that each leave out another cloud (the captured step holds 127 /
        63 / 64 launches, every forward and dX on the tensor cores; 4
        replays; per-step losses within 1e-5 relative, parameters within
        1e-5 of max |p|, the bits compared; the generator state equal),
        and test_scanned in both modes on 4 subsets (rows within 1e-5
        relative); then train, the loop and the scan in turns on calls
        of 27 batches of the 8 clouds (scripts/train_rd.py's call), and
        test_scanned's loop and scan in turns: ms per step, peak memory,
        the capture's ms and the replayed steps' ms, the steps a call
        from which the graph pays; the first scan turn of each passes no
        mode and must take the graph; one replay profiled.
  8. the parallel paths (pcgcv2_torch/parallel) on the one card, bf16:
     a. make_dp_train_step at world size 1 over NCCL: 3 steps on phase
        7b's batch against 3 Trainer.steps from the same weights and seed
        (two Trainer runs against each other first, for the spread):
        losses within 1e-5 relative, parameters within 1e-5 of max |p|,
        127 / 63 / 64 launches per step; step median, NCCL all-reduce ms;
     b. make_dp_train_step at world size 2 over gloo, two spawned ranks on
        the one card (4 clouds each, each rank's own plan): every conv3
        launch of rank 0's first step (127 / 63 / 64) against the plain
        versions on its own inputs, as 7a checks them (untimed); the
        averaged gradients and updated parameters after the first step
        against a single-process replica (within 1e-5 of max |g|, |p|);
        per-rank step ms and peak memory;
     c. make_spatial_decode_fn at world size 2 over gloo, the same two
        ranks: the vox11 torus of 6b and the vox10 frame from Coder.encode's
        bottleneck, each decoded twice per rank: first with every conv3
        launch checked against conv3_plain on its own inputs (at the
        clamped caps, vox11's stage 2 at the whole grid's 21504 candidate
        blocks), then timed, the same output; the assembled set equal to
        the monolithic and streamed decodes, dropped 0, the phase-6 bpp
        and D1 gates, 33 conv3 launches per rank on the tensor cores;
        per-rank wall, top-k and peak memory;
     d. the same at world size 1 over NCCL on the vox10 frame.
     The kernels are built before any rank starts; a rank that fails fails
     the phase.
  9. 8^3 blocks (PCGC_BLOCK_SIZE=8), in a child process (the block side
     is read at import; it loads the library this process built and
     writes its results to a JSON file that this process reads and
     prints); full width, ckpts/r4 and tests/golden/golden.ckpt:
     a. one vox10 encode + decode per dtype, every conv3 forward spied on:
        all 64 on the 8^3 tensor-core instance, each held against
        conv3_plain on its own inputs (f32 1e-4, bf16 2e-2 of max |ref|,
        as 7a and 8 hold real inputs; the 16^3 kernel's errors on the
        same frame beside them), each shape timed on its first launch
        (kernel, plain, F.conv3d on the halo) with its bound; per-frame
        sums;
     b. the golden triple in f32, phase 3's gates;
     c. the vox10 frame in bf16 and f32 (phase 4's timings and gates),
        its block caps and dense slots beside this process's 16^3 ones,
        a profile as phase 5's, and the frame in 8 slabs, 0 points from
        the monolithic decode;
     d. phase 7a's checks of one training step per dtype (127 / 63 / 64
        launches on the 8^3 instances) and 7 trainer steps per dtype.
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
from typing import Optional

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# H100 SXM published peaks (dense): HBM bytes/s, f32 CUDA-core FLOP/s and
# bf16 tensor-core FLOP/s.
HBM_BPS = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# TF32 tensor-core FLOP/s: an f32-accurate product in 3xTF32 is three of
# them (two where one operand is bf16, exact in tf32)
TF32_FLOPS = 495e12

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
TRAIN_STEPS = 12
# 7d: batches of one timed train_scanned / test_scanned / train call:
# scripts/train_rd.py's call at its defaults (216 training clouds of 240
# in batches of 8)
SCANNED_BATCHES = 27
# 7d: batches of the scan-against-loop epoch that the gates read
SCAN_GATE_BATCHES = 5
# 7d, scan against loop: losses relative, parameters over max |p|
# (phase 8a's tolerances), the test rows relative
SCAN_TOL = 1e-5
# 7a: the card's Adam against torch's plain Adam, parameters and moments
# over their max (tests/test_torch_train.py holds Adam to optax at 1e-7)
ADAM_TOL = 1e-7
BS8_TRAIN_STEPS = 7  # 9d: trainer steps per dtype at 8^3 blocks
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
# the design of conv3_tc.cu's f32 and bf16 instances, as the kernels line
# names it
F32_ROUTE = ("3xTF32, weights staged in shared memory by TMA bulk copies "
             "(producer warp, mbarrier ring); wgmma m64nNk8 at max(co, 8) "
             ">= 32, mma.sync m16n8k8 below")
BF16_ROUTE = ("bf16, weights staged in shared memory by TMA bulk copies "
              "(producer warp, mbarrier ring); wgmma m64nNk16 at co = 64 and "
              "ci >= 16, mma.sync m16n8k16 (m16n8k8 at ci <= 8) below")
# the design of conv3_wgrad.cu's f32 and bf16 instances (dy's dtype), as
# the kernels line names it
WGRAD_F32_ROUTE = ("3xTF32 at ci >= 8 and co >= 16 on the tensor cores: "
                   "mma.sync m16n8k8 with the live voxels as K, a_lo.b_hi + "
                   "a_hi.b_lo + a_hi.b_hi (a bf16 x has no lo) of each "
                   "chunk of 8 into a fresh fragment added to the f32 "
                   "sums, both operands split into tf32 hi and lo in the "
                   "registers; x staged by cp.async in its own dtype as "
                   "32-byte rows in sub-planes, each lane's 64-bit load the "
                   "staged voxel v + tap of its own list entry, rows 2g and "
                   "2g + 1 of an m16 tile of the (tap, ci) rows (two taps "
                   "a tile at ci 8); a ring of planes at 16^3, an item's "
                   "whole halo at 8^3; persistent CTAs, fixed-order sums; "
                   "ci < 8 (1->16, 4->4, 4->8) and co < 16 (8->8, 16->4, "
                   "32->8, ->1) on the CUDA cores, f32 FMAs")
WGRAD_BF16_ROUTE = ("bf16 at ci >= 8 on the tensor cores: mma.sync "
                    "m16n8k16 with the live voxels as K, X^T and dY by "
                    "ldmatrix.trans from bf16 planes (f32 x rounded on the "
                    "way in through registers) and dy rows in XOR-swizzled "
                    "shared memory, the gather in each lane's row address; "
                    "a ring of planes at 16^3, an item's whole halo at 8^3; "
                    "persistent CTAs, fixed-order sums; ci < 8 (1->16, "
                    "4->4, 4->8) on the CUDA cores, f32 FMAs over "
                    "bf16-rounded inputs")
# forward launches of a path checked on their own inputs (spy_forward)
# against f32 conv3_plain, max abs error over max |ref|: dX's tolerances,
# since dX is this kernel (the bf16 one is phase 2's TOL_BF16_REL)
FWD_TOL = TRAIN_TOL["dx"]
FWD_CHUNK = 512      # rows per piece of spy_forward's reference
KERNEL_REPS = 10     # timed launches per kernel shape (median)
VOX10_REPS = 3       # timed vox10 encode+decode reps per dtype (best)


def log(*a):
    """Print a line, and append it to OUT_DIR/chip_smoke.log (the whole
    run's lines, also those of phase 9's child, beyond the end of the
    output that a caller may keep)."""
    print(*a, flush=True)
    if OUT_DIR.is_dir():
        with open(OUT_DIR / "chip_smoke.log", "a") as f:
            print(*a, file=f)


def tc_sass(lib) -> dict:
    """The built library's conv3_tc.cu instances, by "dtype/ci/co/bs"
    (dtype f32 or bf16): how many HGMMA (wgmma), HMMA (mma.sync) and
    UBLKCP (bulk copy) instructions `cuobjdump -sass` finds in each (both
    __launch_bounds__ variants summed); conv3_wgrad.cu's instances by
    "x dtype/dy dtype/ci/co/bs" with the kernel that holds them (mma for
    wgrad_mma_kernel, cuda_cores for wgrad_partial_kernel), their HMMA
    and, of those, the tf32 ones (TF32); and the seconds it took."""
    import re

    t0 = time.perf_counter()
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    out, wgrad, key, cur = {}, {}, None, None
    dt = {"f": "f32", "13__nv_bfloat16": "bf16"}
    # grep keeps the few lines read here, in a process of its own
    with subprocess.Popen([tool, "-sass", str(lib)],
                          stdout=subprocess.PIPE) as p:
        lines = subprocess.run(
            ["grep", "-E", "Function :|HGMMA|HMMA|UBLKCP"], stdin=p.stdout,
            capture_output=True, text=True).stdout.splitlines()
        p.stdout.close()
    for line in lines:
        if "Function :" in line:
            cur = None
            m = re.search(r"conv3_tc_kernel_(f32|bf16)(?:_fit)?ILi(\d+)ELi"
                          r"(\d+)ELi(\d+)E", line)
            key = "/".join(m.groups()) if m else None
            if key:
                out.setdefault(key, {"HGMMA": 0, "HMMA": 0, "UBLKCP": 0})
                cur = out[key]
            # a repeated type is mangled as a substitution (S_, S0_, ...)
            w = re.search(r"wgrad_(mma|partial)_kernelI(f|13__nv_bfloat16)"
                          r"(f|13__nv_bfloat16|S\d*_)?Li(\d+)ELi(\d+)ELi"
                          r"(\d+)E", line)
            if w:
                kind, tx, tg, ci, co, bs = w.groups()
                tg = tx if tg and tg.startswith("S") else tg
                wk = "/".join((dt[tx], dt[tg] if tg else "bf16", ci, co, bs))
                cur = wgrad[wk] = {
                    "kernel": "mma" if kind == "mma" else "cuda_cores",
                    "HGMMA": 0, "HMMA": 0, "UBLKCP": 0, "TF32": 0}
        elif cur is not None:
            for op in ("HGMMA", "HMMA", "UBLKCP"):
                cur[op] += f" {op}." in line or f" {op} " in line
            if "TF32" in cur:  # the tf32 form, HMMA.1688.F32.TF32
                cur["TF32"] += " HMMA." in line and ".TF32" in line
    if p.returncode != 0:
        raise RuntimeError(f"cuobjdump -sass failed on {lib}")
    return {"instances": out, "wgrad": wgrad,
            "seconds": time.perf_counter() - t0}


def check_tc_sass(lib) -> None:
    """`tc_sass` of the built library against the plans: every instance
    of conv3_tc.cu, f32 and bf16, holds HGMMA and no HMMA where its plan
    says wgmma, HMMA where mma.sync, and UBLKCP; every instance of
    conv3_wgrad.cu runs the kernel its `wgrad_plan` names, with HMMA
    where that is mma.sync, all of them tf32 for f32 dy (3xTF32) and none
    for bf16 dy, and no HMMA where it is the CUDA cores; logs the counts per
    dtype, raises on a difference."""
    import torch

    from pcgcv2_torch.ops import conv3 as K

    sass = tc_sass(lib)
    ops = sass["instances"]
    bad = []
    for key, v in sorted(ops.items()):
        dt, ci, co, bs = key.split("/")
        cd = torch.float32 if dt == "f32" else torch.bfloat16
        want = K.tc_plan(int(ci), int(co), cd, bs=int(bs)).mma
        if (want == "wgmma") != (v["HGMMA"] > 0 and v["HMMA"] == 0) \
                or v["UBLKCP"] == 0:
            bad.append((key, want, v))
    for dt in ("f32", "bf16"):
        mine = {k: v for k, v in ops.items() if k.startswith(dt + "/")}
        log(f"phase 1, cuobjdump -sass: {len(mine)} {dt} conv3_tc.cu "
            f"instances, HGMMA (wgmma) in "
            f"{sum(v['HGMMA'] > 0 for v in mine.values())}, HMMA (mma.sync)"
            f" in {sum(v['HMMA'] > 0 for v in mine.values())}, UBLKCP (bulk"
            f" copy) in {sum(v['UBLKCP'] > 0 for v in mine.values())}, as "
            f"planned in {len(mine) - sum(b[0] in mine for b in bad)} "
            f"({sass['seconds']:.1f} s); HGMMA / HMMA per instance "
            "ci/co/bs: " + ", ".join(
                f"{k.split('/', 1)[1]} {v['HGMMA']}/{v['HMMA']}"
                for k, v in sorted(mine.items())))
    dts = {"f32": torch.float32, "bf16": torch.bfloat16}
    wbad = []
    for key, v in sorted(sass["wgrad"].items()):
        xd, gd, ci, co, bs = key.split("/")
        mma = K.wgrad_plan(int(ci), int(co), dts[xd], dts[gd],
                           bs=int(bs)).mma
        tf32 = v["HMMA"] if mma and gd == "f32" else 0
        if (v["kernel"] == "mma") != mma or (v["HMMA"] > 0) != mma \
                or v["TF32"] != tf32:
            wbad.append((key, mma, v))
    for gd in ("f32", "bf16"):
        mine = {k: v for k, v in sass["wgrad"].items()
                if k.split("/")[1] == gd}
        log(f"phase 1, cuobjdump -sass: {len(mine)} conv3_wgrad.cu "
            f"instances with {gd} dy, on mma.sync (wgrad_mma_kernel) "
            f"{sum(v['kernel'] == 'mma' for v in mine.values())}, HMMA in "
            f"{sum(v['HMMA'] > 0 for v in mine.values())}, tf32 HMMA in "
            f"{sum(v['TF32'] > 0 for v in mine.values())}, as planned in "
            f"{len(mine) - sum(b[0] in mine for b in wbad)}; HMMA per "
            "instance x/ci/co/bs: " + ", ".join(
                f"{k.split('/')[0]}/{'/'.join(k.split('/')[2:])} {v['HMMA']}"
                for k, v in sorted(mine.items())))
    n_tc = 2 * sum(len(K.TC_PAIRS[bs]) for bs in K.BLOCK_SIDES)
    n_wg = 4 * sum(len(K.WGRAD_PAIRS[bs]) for bs in K.BLOCK_SIDES)
    if bad or len(ops) != n_tc or wbad or len(sass["wgrad"]) != n_wg:
        raise AssertionError(
            f"conv3_tc.cu instances against their plans ({len(ops)} of "
            f"{n_tc} found): {bad}; conv3_wgrad.cu ({len(sass['wgrad'])} "
            f"of {n_wg} found): {wbad}")


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
            plan, note = (plan_note(ci, co, cd, int(base.count))
                          if kernel == "tc" else ({}, ""))
            row[dtype] = {
                **plan,
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
                f"dense {row[dtype]['dense_tflops']:.2f} TFLOP/s  {note}")
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


def plan_note(ci: int, co: int, cd, live_rows: int) -> tuple:
    """(dict, text) of the tensor-core plan of a shape: where the weights
    sit (whole or a ring of one-step slots), the k chunks of a step, the
    product instruction, the weight bytes a launch reads from L2 as
    `tc_plan` counts them (the CTA, once or per step of its planes), and
    the dynamic shared memory of a CTA (planes, weights, mbarriers)."""
    from pcgcv2_torch.ops import conv3 as K

    p = K.tc_plan(ci, co, cd)
    l2 = p.l2_weight_bytes(live_rows, ci, co, cd)
    where = "smem whole" if p.wslots == 1 else f"smem ring of {p.wslots}"
    return ({"l2_weight_bytes": l2, "smem": p.smem, "wslots": p.wslots,
             "kg": p.kg, "mma": p.mma},
            f"weights {where}, kg {p.kg}, {p.mma}: L2 {l2 / 1e9:.3f} GB, "
            f"smem {p.smem} B")


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


def phase_golden(device, workdir: str,
                 title: str = "phase 3: golden triple, full width, float32"):
    import numpy as np

    from pcgcv2_torch.checkpoint import load_params
    from pcgcv2_torch.codec.coder import Coder
    from pcgcv2_torch.data.synthetic import torus_cloud
    from pcgcv2_torch.eval.metrics import pc_metrics
    from pcgcv2_torch.ops import blocks as B

    log(f"== {title} ==")
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


def phase_vox10(device, workdir: str, card: str,
                title: str = "phase 4: vox10 frame, ckpts/r4, full width"):
    import numpy as np
    import torch

    from pcgcv2_torch.checkpoint import load_params
    from pcgcv2_torch.codec.coder import Coder
    from pcgcv2_torch.data.synthetic import torus_cloud
    from pcgcv2_torch.eval.metrics import pc_metrics
    from pcgcv2_torch.ops import blocks as B

    log(f"== {title} ==")
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
    encode + decode, from the masks with plain torch: per m16 tile (16
    consecutive (y, z) voxels of an x-plane: one row of 16 z at BS = 16,
    two rows of 8 at BS = 8), per warp tile (two m16 tiles: the kernel
    skips its MMAs), per warpgroup tile (128 consecutive voxels: an
    instance on wgmma, `tc_plan(...).mma`, skips its products only where
    all are empty) and per CTA (4 x-planes at BS = 16, the whole block at BS =
    8: the kernel skips staging too; the f32 ci = 64 CTAs of 16^3 blocks
    cover half of that), over the live rows; each also weighted by the
    call's dense work 27*ci*co."""
    import torch

    from pcgcv2_torch.models import layers
    from pcgcv2_torch.ops import blocks as B
    from pcgcv2_torch.ops import conv3 as K

    real = layers.conv3
    tally = {k: [0, 0, 0.0, 0.0]
             for k in ("m16", "warp32", "wg128", "cta")}

    def spy(bg, nbrs, weight, bias=None, compute_dtype=None, packed=None,
            **kw):
        ci, co = bg.channels, weight.shape[-1]
        cd = compute_dtype or B.COMPUTE_DTYPE
        if K.route(ci, co, cd) == "tc":
            n = int(bg.count)
            m = bg.mask[:n].reshape(n, B.BS, B.BS * B.BS)  # x, (y, z)
            xp = K.tc_plan(ci, co, cd).xp
            for name, occ in (("m16", m.reshape(n, B.BS, -1, 16).any(-1)),
                              ("warp32", m.reshape(n, B.BS, -1, 32).any(-1)),
                              ("wg128", m.reshape(n, -1, 128).any(-1)),
                              ("cta", m.reshape(n, B.BS // xp, -1).any(-1))):
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


def where_device_ms(ka) -> float:
    """Device time of the kernels aten::where launched, by self time: a
    where with a scalar operand dispatches to aten::where again, so the
    totals count its kernels twice."""
    attr = ("self_device_time_total"
            if hasattr(ka[0], "self_device_time_total")
            else "self_cuda_time_total")
    return sum(getattr(e, attr) for e in ka if e.key == "aten::where") / 1e3


def phase_profile(device, workdir: str,
                  title: str = "phase 5: profiler breakdown, one vox10 "
                  "encode + decode", tag: str = ""):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pcgcv2_torch.checkpoint import load_params
    from pcgcv2_torch.codec.coder import Coder
    from pcgcv2_torch.data.synthetic import torus_cloud
    from pcgcv2_torch.ops import blocks as B

    log(f"== {title} ==")
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
        where_ms = where_device_ms(ka)
        wall_ms = (enc_s + dec_s) * 1e3
        (OUT_DIR / f"profile{tag}_{dtype}.txt").write_text(
            ka.table(sort_by=attr, row_limit=60))
        summary[dtype] = {
            "wall_ms": wall_ms, "enc_ms": enc_s * 1e3, "dec_ms": dec_s * 1e3,
            "device_ms": dev_ms, "conv3_ms": conv_ms, "conv3_launches": conv_n,
            "conv3_tc_ms": tc_ms, "where_ms": where_ms,
            "idle_share": 1.0 - dev_ms / wall_ms,
        }
        log(f"profile{tag} {dtype}: wall {wall_ms:.2f} ms (enc "
            f"{enc_s * 1e3:.2f} + dec {dec_s * 1e3:.2f}); device kernels "
            f"{dev_ms:.2f} ms, of which conv3 {conv_ms:.2f} ms in {conv_n} "
            f"launches (tensor-core {tc_ms:.2f} ms), aten::where "
            f"{where_ms:.2f} ms ({100 * where_ms / dev_ms:.1f}%); device "
            f"idle {100 * (1 - dev_ms / wall_ms):.1f}% of wall")
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


def streamed_vox10(device, workdir: str, card: str, params,
                   rounds: int = 4) -> dict:
    """The vox10 frame decoded in 8 slabs against the monolithic decode,
    bf16 and f32, in turns: same count, the symmetric difference of the
    point sets, the vox10 gates, 110 launches on the tensor cores.  Round
    0 warms both up and the rest are timed (best of), or with one round
    that round is timed."""
    import numpy as np
    import torch

    from pcgcv2_torch.codec.coder import Coder
    from pcgcv2_torch.data.synthetic import torus_cloud
    from pcgcv2_torch.eval.metrics import pc_metrics
    from pcgcv2_torch.ops import blocks as B

    result = {}
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
        for rnd in range(rounds):
            for slabs in (0, 8):  # in turns: monolithic, streamed
                coder.streamed_slabs = slabs
                (sec, dec), launches, tc = counted(
                    lambda: timed(coder.decode))
                if rnd or rounds == 1:
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
            f"decode best of {len(times[0])}: monolithic {best[0]:.4f} s, "
            f"streamed {best[8]:.4f} s, ratio {ratio:.3f}  conv3 launches "
            f"of the streamed decode {s_launches} ({s_tc} tensor-core)  "
            f"[{card}]")
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
    return result


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

    # (a) vox10 frame, 8 slabs against the monolithic decode
    log("== phase 6a: vox10 streamed decode (8 slabs) vs monolithic ==")
    result = streamed_vox10(device, workdir, card, params)

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
    """(bytes ms, operations ms, operations ms on the CUDA cores) of
    conv3_wgrad's bound.  Bytes: the mask of the live rows (where the
    occupied slots are found), dy at the occupied slots only, x at the
    slots within the 3^3 neighbourhood of an occupied one, the neighbour
    rows, and the f32 [27, ci, co] result: no dense
    output, unlike the forward and dX.  Operations: 2*ci*co per pair of an
    occupied output voxel and an occupied input voxel of its 3^3
    neighbourhood, as `conv3_bound` counts them, at the dtype's peak; f32
    dy's least time is on the tensor cores, each f32-accurate product as
    3xTF32 (2x for a bf16 x), and its time at the CUDA cores' f32 peak is
    the third number."""
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
    ops_ms = ops / PEAK_FLOPS[dtype] * 1e3
    if dtype == "float32":
        split = 3 if bg.feats.dtype == torch.float32 else 2
        return (nbytes / HBM_BPS * 1e3, ops * split / TF32_FLOPS * 1e3,
                ops_ms)
    return nbytes / HBM_BPS * 1e3, ops_ms, ops_ms


def lib_grads(bg, nbrs, w, dy, cd):
    """The library's conv3 input and weight gradients (cuDNN through
    torch.nn.grad) on the assembled halo of the live rows: two callables,
    dense part only."""
    import torch

    from pcgcv2_torch.ops import blocks as B
    from pcgcv2_torch.ops import conv3 as K

    n = int(bg.count)
    h = K.halo(bg.feats.to(cd), nbrs[:n]).permute(0, 4, 1, 2, 3).contiguous()
    go = dy[:n].to(cd).reshape(n, B.BS, B.BS, B.BS, -1).permute(
        0, 4, 1, 2, 3).contiguous()
    wl = w.to(cd).permute(4, 3, 0, 1, 2).contiguous()
    gi = torch.nn.grad.conv3d_input
    gw = torch.nn.grad.conv3d_weight
    return (lambda: gi(h.shape, wl, go), lambda: gw(h, wl.shape, go))


def check_backward(bg, dy, nbrs, cd, dw, dx, real_dgrad, real_wgrad,
                   timing: bool = True):
    """One conv3 backward of a training step, on its own inputs: the input
    grid `bg`, dy masked to the live slots, and the kernels' dW and (but
    for the first conv) (weight, packed flip, dX).  Holds them against f32
    autograd through conv3_plain on the same rounded inputs, checks that a
    second dW launch on the same inputs gives the same bits, and (where
    `timing`) times the kernels, the plain versions and cuDNN there."""
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
    # beside it, the plain version in the compute dtype (bf16-rounded x and
    # dy, f32 matmuls): what the kernel's own sums are held to elsewhere
    r["dw_plain_rel_err"] = float(
        (dw - K.conv3_wgrad_plain(bg, dy, nbrs, cd)).abs().max()
        / max(r["dw_max_abs_ref"], 1e-30))
    ok = r["dw_same_bits"] and (
        r["dw_max_abs_err"] <= TRAIN_TOL["dw"][dtype] * r["dw_max_abs_ref"])
    if dx is not None:
        _, packed_flip, got = dx
        lv = live[:, :, None].expand_as(rdx)
        r["dx_max_abs_err"] = float((got.float() - rdx)[lv].abs().max())
        r["dx_max_abs_ref"] = float(rdx[lv].abs().max())
        r["dx_zero_off_live"] = float(got.float()[~lv].abs().max()) == 0.0
        ok = ok and r["dx_zero_off_live"] and (
            r["dx_max_abs_err"]
            <= TRAIN_TOL["dx"][dtype] * r["dx_max_abs_ref"])
    r["ok"] = ok
    del rdx, rdw
    if not timing:
        return r
    lib_dx, lib_dw = lib_grads(bg, nbrs, weight, dy, cd)
    r["dw_ms"] = cuda_ms(lambda: real_wgrad(bg, dy, nbrs, cd), KERNEL_REPS)
    r["dw_plain_ms"] = cuda_ms(
        lambda: K.conv3_wgrad_plain(bg, dy, nbrs, cd), 3)
    r["dw_library_ms"] = cuda_ms(lib_dw, KERNEL_REPS)
    r["dw_bytes_ms"], r["dw_ops_ms"], r["dw_ops_cuda_cores_ms"] = \
        wgrad_bound(bg, nbrs, ci, co, dtype)
    if dx is not None:
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
    return r


@contextlib.contextmanager
def spy_backward(rows: list, timing: bool = True):
    """While open, every conv3 backward (`Conv3Fn` calls conv3_dgrad, then
    conv3_wgrad) goes through the kernels as usual and is then checked
    (and, where `timing`, timed) on its own inputs by `check_backward`, one
    row each.  The check's own launches are taken out of the counts."""
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
        counts = launch_counts()
        rows.append(check_backward(
            bg, dy, nbrs, compute_dtype, dw,
            pending.pop() if pending else None, real_dgrad, real_wgrad,
            timing))
        set_counts(counts)
        return dw

    K.conv3_dgrad, K.conv3_wgrad = dgrad, wgrad
    try:
        yield
    finally:
        K.conv3_dgrad, K.conv3_wgrad = real_dgrad, real_wgrad
        # the wrapped functions counted on the spies' copies of the counts
        for real, spy in ((real_dgrad, dgrad), (real_wgrad, wgrad)):
            for k in ("launches", "tc_launches"):
                if hasattr(real, k):
                    setattr(real, k, getattr(spy, k))


def check_forward(kernel: str, bg, nbrs, weight, bias, cd, got) -> dict:
    """One forward conv3 launch of a path, on its own inputs: `got` (the
    kernel's output feats) against conv3_plain's arithmetic in f32 on the
    same rounded inputs, FWD_CHUNK rows at a time (so the reference fits
    beside two ranks' decodes), masked as with_feats masks; rows past the
    count must be zero."""
    import torch

    from pcgcv2_torch.ops import conv3 as K

    dtype = {torch.float32: "float32", torch.bfloat16: "bfloat16"}[cd]
    n = int(bg.count)
    w = weight.to(cd).float()
    b = None if bias is None else bias.to(cd).float()
    err = ref_max = 0.0
    with torch.no_grad():
        for a in range(0, n, FWD_CHUNK):
            e = min(n, a + FWD_CHUNK)
            h = K.halo(bg.feats, nbrs[a:e]).to(cd)
            ref = K.conv3_dense(h, w, b, torch.float32)
            ref = torch.where(bg.mask[a:e, :, None], ref, 0)
            err = max(err, float((got[a:e].float() - ref).abs().max()))
            ref_max = max(ref_max, float(ref.abs().max()))
            del h, ref
        zero_past = n == bg.nb_cap or float(got[n:].abs().max()) == 0.0
    return {"kernel": kernel, "nb_cap": bg.nb_cap, "live_rows": n,
            "ci": bg.channels, "co": weight.shape[-1], "dtype": dtype,
            "max_abs_err": err, "max_abs_ref": ref_max,
            "zero_past_count": zero_past,
            "ok": zero_past and err <= FWD_TOL[dtype] * ref_max}


@contextlib.contextmanager
def spy_forward(rows: list):
    """While open, every forward conv3 launch (`ops.conv3._conv3` calls
    `launch`, looked up at call time) runs as usual and is then checked on
    its own inputs by `check_forward`, one row each.  The check launches
    no kernel, so the counts are the path's own."""
    import functools

    from pcgcv2_torch.ops import conv3 as K

    real = K.launch

    @functools.wraps(real)
    def launch(kernel, bg, nbrs, weight, bias, cd, packed=None):
        out = real(kernel, bg, nbrs, weight, bias, cd, packed)
        rows.append(check_forward(kernel, bg, nbrs, weight, bias, cd,
                                  out.feats))
        return out

    K.launch = launch
    try:
        yield
    finally:
        K.launch = real


def forward_summary(rows: list, what: str, card: str = "") -> dict:
    """spy_forward's rows: logged by shape, summarised, and gated (every
    launch within FWD_TOL of max |ref|, zeros past the count)."""
    shapes = {}
    for r in rows:
        shapes.setdefault((r["nb_cap"], r["ci"], r["co"], r["dtype"]),
                          []).append(r)
    worst = max((r["max_abs_err"] / max(r["max_abs_ref"], 1e-30)
                 for r in rows), default=0.0)
    log(f"{what}: {len(rows)} forward conv3 launches checked against "
        f"conv3_plain on their own inputs, {len(shapes)} shapes "
        "(nb_cap, ci, co, dtype: launches) "
        + ", ".join(f"{k[0]}/{k[1]}/{k[2]}/{k[3][:4]}: {len(v)}"
                    for k, v in sorted(shapes.items()))
        + f"; worst err/|ref| {worst:.3g} (tolerance "
        f"{FWD_TOL}) {'OK' if all(r['ok'] for r in rows) else 'FAIL'}"
        + (f"  [{card}]" if card else ""))
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"{what}: conv3 disagrees with conv3_plain in "
                             f"{len(bad)} of {len(rows)} launches; first: "
                             f"{bad[0]}")
    return {"launches": len(rows), "worst_rel_err": worst,
            "shapes": [list(k) + [len(v)] for k, v in sorted(shapes.items())]}


def backward_summary(rows: list, what: str) -> dict:
    """spy_backward's untimed rows: summarised and gated with 7a's
    tolerances (TRAIN_TOL)."""
    worst = {p: max((r[f"{p}_max_abs_err"] / r[f"{p}_max_abs_ref"]
                     for r in rows if p == "dw" or r["dx"]), default=0.0)
             for p in ("dx", "dw")}
    n_dx = sum(r["dx"] for r in rows)
    ok = all(r["ok"] for r in rows)
    log(f"{what}: {n_dx} dX and {len(rows)} dW calls checked against "
        f"autograd through conv3_plain on their own inputs; worst err/|ref| "
        f"dX {worst['dx']:.3g}, dW {worst['dw']:.3g} (tolerance "
        f"{TRAIN_TOL}); every dW's second launch the same bits "
        f"{all(r['dw_same_bits'] for r in rows)} {'OK' if ok else 'FAIL'}")
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"{what}: conv3 backward kernels disagree in "
                             f"{len(bad)} of {len(rows)} calls; first: "
                             f"{bad[0]}")
    return {"dx": n_dx, "dw": len(rows), "worst_rel_err": worst}


def train_config():
    """scripts/train_rd.py's recipe: alpha 2, beta 1, lr 8e-4."""
    from pcgcv2_torch.config import TrainConfig

    return TrainConfig(alpha=2.0, beta=1.0, lr=8e-4, batch_size=TRAIN_BATCH)


def make_trainer(dtype: str, workdir: str, device):
    """The trainer of scripts/train_rd.py at full width: `ModelConfig()`
    (remat on), alpha 2, beta 1, lr 8e-4, for_training(524288, 128, 8),
    in `dtype` compute."""
    from pcgcv2_torch.config import BlockPlan, ModelConfig
    from pcgcv2_torch.ops import blocks as B
    from pcgcv2_torch.train.trainer import Trainer

    B.set_compute_dtype(dtype)
    plan = BlockPlan.for_training(TRAIN_CAPACITY, TRAIN_RES, TRAIN_BATCH)
    return Trainer(train_config(), plan, TRAIN_CAPACITY, ModelConfig(),
                   logdir=os.path.join(workdir, f"tl_{dtype}"),
                   ckptdir=os.path.join(workdir, f"tc_{dtype}"),
                   seed=0, device=device)


def phase_train_kernels(device, workdir: str, clouds,
                        title: str = "phase 7a"):
    """7a: one full-width training step per dtype (f32, bf16) with every
    conv3 spied on: the forward launches (conv3_tc.cu) held against
    conv3_plain, conv3_dgrad (conv3_tc.cu on the flipped weight) and
    conv3_wgrad (conv3_wgrad.cu) against autograd through conv3_plain and
    timed, all on the step's own inputs."""
    import torch

    log(f"== {title}: conv3 kernels of one training step vs conv3_plain "
        "(forward) and autograd through it (backward), on the step's own "
        "inputs ==")
    result = {}
    for dtype in ("float32", "bfloat16"):
        tr = make_trainer(dtype, f"{workdir}/7a", device)
        coords, valid = tr._collate(clouds)
        rows, fwd = [], []
        with spy_forward(fwd), spy_backward(rows):
            tr.step(coords, valid)
        torch.cuda.synchronize()
        result[f"adam_{dtype}"] = adam_against_plain(tr.model,
                                                     f"{title} {dtype}")
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
        result[f"forward_{dtype}"] = forward_summary(fwd, f"{title} {dtype}")
        assert len(fwd) == TRAIN_LAUNCHES[0], \
            f"{len(fwd)} forward launches in a step ({dtype})"
    return result


def adam_against_plain(model, title: str) -> list:
    """The trainer's Adam as it runs on the card (`make_optimizer`:
    capturable, the lr a device tensor that `set_lr` writes, the state
    zeroed in place by `reset_optimizer`) against torch's plain Adam (a
    float lr, not capturable, a new one at the reset), from the
    parameters and gradients of the real step `model` just took: two
    steps, the lr halved, a step, a reset, two steps.  Gate: after every
    step the parameters and both moments within ADAM_TOL of their max,
    while each step moves the parameters by over 100 x ADAM_TOL."""
    import torch
    from pcgcv2_torch.train.trainer import (make_optimizer, reset_optimizer,
                                            set_lr)

    cfg = train_config()
    live = [p for p in model.parameters() if p.grad is not None]
    grads = [p.grad.detach().clone() for p in live]
    ps = {m: [p.detach().clone().requires_grad_(True) for p in live]
          for m in ("card", "plain")}
    opt = make_optimizer(ps["card"], cfg.lr, cfg.weight_decay)
    group = opt.param_groups[0]
    assert group["capturable"] and group["lr"].device.type == "cuda", \
        f"{title}: the trainer's Adam is not capturable on the card"

    def plain(lr):
        return torch.optim.Adam(ps["plain"], lr=lr, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=cfg.weight_decay)

    def gap(a, b):
        return (max(float((x - y).abs().max()) for x, y in zip(a, b))
                / max(float(x.abs().max()) for x in a))

    ref, lr, rows = plain(cfg.lr), cfg.lr, []
    for op in ("step", "step", "halve", "step", "reset", "step", "step"):
        if op == "halve":
            lr /= 2
            set_lr(opt, lr)
            ref.param_groups[0]["lr"] = lr
            continue
        if op == "reset":
            reset_optimizer(opt)
            ref = plain(lr)
            continue
        before = [p.detach().clone() for p in ps["plain"]]
        for m in ps:
            for p, g in zip(ps[m], grads):
                p.grad = g.clone()
        opt.step()
        ref.step()
        row = {"lr": lr, "moved": gap(ps["plain"], before),
               "params": gap(ps["plain"], ps["card"]),
               "bits": all(torch.equal(a, b)
                           for a, b in zip(ps["plain"], ps["card"]))}
        for k in ("exp_avg", "exp_avg_sq"):
            row[k] = gap([ref.state[p][k] for p in ps["plain"]],
                         [opt.state[p][k] for p in ps["card"]])
        rows.append(row)
    steps = {(int(opt.state[a]["step"]), int(ref.state[b]["step"]))
             for a, b in zip(ps["card"], ps["plain"])}
    worst = max(r[k] for r in rows for k in ("params", "exp_avg",
                                             "exp_avg_sq"))
    log(f"{title}: Adam capturable (tensor lr, in-place reset) against "
        f"plain Adam (float lr, new at the reset) on the step's gradients, "
        f"5 steps over an lr halving and a reset: parameters and moments "
        f"differ by at most {worst:.3g} of their max (gate {ADAM_TOL}; "
        f"parameter bits equal per step "
        f"{[r['bits'] for r in rows]}), a step moves them by "
        f"{min(r['moved'] for r in rows):.3g}-"
        f"{max(r['moved'] for r in rows):.3g}")
    assert steps == {(2, 2)}, f"{title}: Adam step counts {steps}"
    assert worst <= ADAM_TOL, f"{title}: Adam differs by {worst}"
    assert min(r["moved"] for r in rows) > 100 * ADAM_TOL, \
        f"{title}: an Adam step moved the parameters too little to compare"
    return rows


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
            f"{tot('dw_ops_ms'):.4f} err/|ref| {worst('dw'):.3g} vs plain "
            f"{max(r['dw_plain_rel_err'] for r in rs):.3g} same bits "
            f"{all(r['dw_same_bits'] for r in rs)} "
            f"{'OK' if all(r['ok'] for r in rs) else 'FAIL'}")
    t = {k: per_step_sum(rows, k) for k in (
        "dx_ms", "dx_plain_ms", "dx_library_ms", "dx_bound_ms", "dw_ms",
        "dw_plain_ms", "dw_library_ms", "dw_bound_ms")}
    tf32 = ("" if dtype != "float32" else
            f" at 3xTF32 on the tensor cores, "
            f"{dw_cuda_core_bound(rows):.4f} at the CUDA cores' f32 peak")
    log(f"conv3 backward per training step, {dtype}: dX {t['dx_ms']:.3f} ms "
        f"(plain {t['dx_plain_ms']:.3f}, cuDNN {t['dx_library_ms']:.3f}, "
        f"bound {t['dx_bound_ms']:.4f}); dW {t['dw_ms']:.3f} ms (plain "
        f"{t['dw_plain_ms']:.3f}, cuDNN {t['dw_library_ms']:.3f}, bound "
        f"{t['dw_bound_ms']:.4f}{tf32}; worst error against "
        f"conv3_wgrad_plain in {dtype} "
        f"{max(r['dw_plain_rel_err'] for r in rows):.3g} of max |ref|)")


def dw_cuda_core_bound(rows) -> float:
    """f32 dW's bound per step with the operations at the CUDA cores' f32
    peak: each call's larger of bytes and those operations, summed."""
    return sum(max(r["dw_bytes_ms"], r["dw_ops_cuda_cores_ms"])
               for r in rows)


def per_step_sum(rows, key: str) -> float:
    """A phase-7a column summed over the step's backward calls (dX columns
    over the calls with a dX); `*_bound_ms` is each call's bound, the
    larger of its bytes and operations times."""
    p = key[:2]
    sel = [r for r in rows if p == "dw" or r["dx"]]
    if key.endswith("_bound_ms"):
        return sum(max(r[f"{p}_bytes_ms"], r[f"{p}_ops_ms"]) for r in sel)
    return sum(r[key] for r in sel)


def launch_counts():
    """(forward, forward on the tensor cores, dX, dX on the tensor cores,
    dW) conv3 launches since the counts were last set to 0."""
    from pcgcv2_torch.ops import conv3 as K

    return (K.conv3.launches, K.conv3.tc_launches, K.conv3_dgrad.launches,
            K.conv3_dgrad.tc_launches, K.conv3_wgrad.launches)


def set_counts(counts=(0, 0, 0, 0, 0)) -> None:
    from pcgcv2_torch.ops import conv3 as K

    (K.conv3.launches, K.conv3.tc_launches, K.conv3_dgrad.launches,
     K.conv3_dgrad.tc_launches, K.conv3_wgrad.launches) = counts


def phase_train_steps(device, workdir: str, card: str, clouds,
                      n_steps: int = TRAIN_STEPS, title: str = "phase 7b",
                      tag: str = ""):
    """7b: trainer steps at full width on one fixed batch, bf16 then f32:
    a warm-up step, 5 timed steps, then steps up to n_steps, the last
    under the profiler (its table to OUT_DIR/profile_train{tag}_*.txt);
    launches per step, loss terms, peak memory."""
    import torch

    from pcgcv2_torch.config import BlockPlan

    from torch.profiler import ProfilerActivity, profile

    log(f"== {title}: full-width training steps (8 clouds, "
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
        for i in range(n_steps):
            set_counts()
            last = i == n_steps - 1
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) \
                if last else contextlib.nullcontext()
            with prof:
                t0 = time.perf_counter()
                d, _, n_drop = tr.step(coords, valid)
                torch.cuda.synchronize()
                sec = time.perf_counter() - t0
            counts = launch_counts()
            if last:  # the last step runs under the profiler
                result[f"profile_{dtype}"] = train_profile(prof, sec, dtype,
                                                           tag)
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
            f"-> step {n_steps - 1} {last:.5f}  [{card}]")
        assert last < first, f"train {dtype}: loss did not fall"
        result[dtype] = {
            "step_ms_median": statistics.median(timed), "step_ms": timed,
            "last_step_ms": steps[-1]["ms"],
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


def train_profile(prof, sec: float, dtype: str, tag: str = "") -> dict:
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
    where_ms = where_device_ms(ka)
    (OUT_DIR / f"profile_train{tag}_{dtype}.txt").write_text(
        ka.table(sort_by=attr, row_limit=60))
    log(f"profile train{tag} {dtype}: wall {wall_ms:.2f} ms (under the "
        f"profiler); device kernels {dev_ms:.2f} ms, of which conv3_tc "
        f"(forward + dX) {tc_ms:.2f} ms, conv3_wgrad {dw_ms:.2f} ms, "
        f"aten::where {where_ms:.2f} ms; device idle "
        f"{100 * (1 - dev_ms / wall_ms):.1f}% of wall")
    for e in kernels[:12]:
        log(f"  {getattr(e, attr) / 1e3:9.3f} ms  x{e.count:<5d} "
            f"{e.key[:100]}")
    return {"wall_ms": wall_ms, "device_ms": dev_ms, "conv3_tc_ms": tc_ms,
            "conv3_wgrad_ms": dw_ms, "where_ms": where_ms,
            "idle_share": 1.0 - dev_ms / wall_ms,
            "top": [(e.key[:100], getattr(e, attr) / 1e3, e.count)
                    for e in kernels[:12]]}


def phase_train_cli(device, workdir: str):
    """7c: pcgcv2_torch.cli.generate_dataset writes 20 synthetic clouds as
    .ply, pcgcv2_torch.cli.train takes one epoch on them in f32 from a
    scratch working directory, and its checkpoint through Coder on the
    golden frame decodes to the input count."""
    import numpy as np

    from pcgcv2_torch.checkpoint import load_params
    from pcgcv2_torch.cli import generate_dataset
    from pcgcv2_torch.cli import train as cli
    from pcgcv2_torch.codec.coder import Coder
    from pcgcv2_torch.data.synthetic import torus_cloud
    from pcgcv2_torch.ops import blocks as B

    log("== phase 7c: pcgcv2_torch.cli.generate_dataset -> cli.train, one "
        "epoch, f32; its checkpoint through Coder ==")
    B.set_compute_dtype("float32")
    data = os.path.join(workdir, "train_ply")
    # random_surface_cloud(127, seed=s) for s = 0..19, at the CLI's density
    assert generate_dataset.main([
        "--synthetic", "20", "--resolution", "126", "--out_filetype", "ply",
        "--pc_rootdir", data]) == 20
    run_dir = os.path.join(workdir, "train_run")
    os.makedirs(run_dir)
    cwd = os.getcwd()
    os.chdir(run_dir)
    try:
        set_counts()
        t0 = time.perf_counter()
        tr = cli.main(["--dataset", data, "--epoch", "1", "--device",
                       device.type, "--prefix", "smoke"])
        sec = time.perf_counter() - t0
        counts = launch_counts()
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


class _ProfiledGraph:
    """A captured graph whose `at`-th replay (0-based) runs under the
    profiler: the replay alone, closed by a device sync."""

    def __init__(self, graph, at: int, out: dict):
        self.graph, self.at, self.out, self.n = graph, at, out, 0

    def replay(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        if self.n != self.at:
            self.n += 1
            return self.graph.replay()
        self.n += 1
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            self.graph.replay()
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
        self.out["prof"], self.out["sec"] = prof, sec


@contextlib.contextmanager
def spy_scan(tr, spans: list, profile_at: Optional[int] = None):
    """Spans of `tr`'s scanned runs (Trainer._run), one dict per call:
    mode, batches, host seconds of the whole run, and in mode="scan" on
    the card those of the eager first step (to the capture, device work
    included), of the capture (`captured`: the conv3 launches counted
    while it ran) and of the replays with their row copies and the fetch.
    With `profile_at`, that replay of each capture runs under the
    profiler (`profiled`)."""
    import torch

    real_run, real_capture = tr._run, tr._capture

    def capture(fn, static, stream):
        span = spans[-1]
        torch.cuda.synchronize()
        c0, t = launch_counts(), time.perf_counter()
        span["first_s"] = t - span["t0"]
        graph, row = real_capture(fn, static, stream)
        span["t1"] = time.perf_counter()
        span["capture_s"] = span["t1"] - t
        span["captured"] = tuple(b - a for a, b in zip(c0, launch_counts()))
        if profile_at is not None:
            span["profiled"] = {}
            graph = _ProfiledGraph(graph, profile_at, span["profiled"])
        return graph, row

    def run(fn, coords_all, valid_all, mode):
        torch.cuda.synchronize()
        span = {"mode": mode, "n": len(coords_all),
                "t0": time.perf_counter()}
        spans.append(span)
        rows = real_run(fn, coords_all, valid_all, mode)  # fetched: synced
        t = time.perf_counter()
        span["run_s"] = t - span["t0"]
        if "t1" in span:
            span["replays_s"] = t - span["t1"]
        return rows

    tr._run, tr._capture = run, capture
    try:
        yield spans
    finally:
        del tr._run, tr._capture


def record_spy(tr) -> list:
    """Every record() call of `tr`: (tag, copy of the record set)."""
    import numpy as np

    seen, real = [], tr.record

    def record(tag, step):
        seen.append((tag, {k: np.array(v) for k, v in tr.record_set.items()
                           if v}))
        real(tag, step)

    tr.record = record
    return seen


def max_rel(a, b) -> float:
    """max |a - b| / |a| elementwise (0 where both are 0)."""
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d = np.abs(a - b)
    return float(np.max(np.where(d == 0, 0.0, d / np.maximum(np.abs(a),
                                                             1e-30))))


def scan_against_loop(device, workdir: str, card: str, clouds, dtype: str,
                      n_batches: int, title: str) -> tuple:
    """From one seed: one epoch of train_scanned(mode="loop") on one
    trainer and of mode="scan" on another, on `n_batches` batches that
    each leave out another of the 8 clouds; then test_scanned in both
    modes on 4 other subsets.  Gates: the loop's launches n x
    TRAIN_LAUNCHES; the scan's eager first step and its capture
    TRAIN_LAUNCHES each, n - 1 replays; per-step losses within SCAN_TOL
    relative and parameters within SCAN_TOL of max |p|; the generator
    state equal; the test rows within SCAN_TOL relative.  Returns the
    numbers and the scan trainer, warmed up, for timing."""
    import numpy as np
    import torch

    cfg = train_config()
    batches = [[c for j, c in enumerate(clouds) if j != i % len(clouds)]
               for i in range(n_batches)]
    trs = {m: make_trainer(dtype, f"{workdir}/{title}_{m}", device)
           for m in ("loop", "scan")}
    p0 = {m: named_copy(tr.model) for m, tr in trs.items()}
    assert rel_spread(p0["loop"], p0["scan"]) == 0, f"{title}: init differs"
    seen = {m: record_spy(tr) for m, tr in trs.items()}
    counts, spans = {}, []
    with spy_scan(trs["scan"], spans):
        for m, tr in trs.items():
            set_counts()
            tr.train_scanned(batches, mode=m)
            counts[m] = launch_counts()
    (span,) = spans
    recs = {m: seen[m][-1][1] for m in trs}
    loss = {m: cfg.alpha * r["bce"] + cfg.beta * r["bpp"]
            for m, r in recs.items()}
    d_loss = max_rel(loss["loop"], loss["scan"])
    d_rec = {k: max_rel(recs["loop"][k], recs["scan"][k])
             for k in recs["loop"]}
    same_rec = all(np.array_equal(recs["loop"][k], recs["scan"][k])
                   for k in recs["loop"])
    p = {m: named_copy(tr.model) for m, tr in trs.items()}
    d_p = rel_spread(p["loop"], p["scan"])
    same_p = all(torch.equal(p["loop"][k], p["scan"][k]) for k in p["loop"])
    same_rng = torch.equal(trs["loop"].generator.get_state(),
                           trs["scan"].generator.get_state())
    replays = trs["scan"].graph_replays
    log(f"{title} {dtype}: loop epoch of {n_batches} batches: conv3 fwd / "
        f"dX / dW {counts['loop'][0]} / {counts['loop'][2]} / "
        f"{counts['loop'][4]}; scan epoch: eager first step + capture "
        f"{counts['scan'][0]} / {counts['scan'][2]} / {counts['scan'][4]}, "
        f"the capture alone {span['captured']}, {replays} replays")
    per_key = ", ".join(f"{k} {v:.3g}" for k, v in d_rec.items())
    log(f"{title} {dtype}: scan against loop: per-step losses differ by "
        f"{d_loss:.3g} (relative; records {per_key}; "
        f"all record bits equal {same_rec}), parameters by {d_p:.3g} of max "
        f"|p| (bits equal {same_p}), gate {SCAN_TOL}; generator state "
        f"equal {same_rng}; losses {np.round(loss['scan'], 5).tolist()}")
    assert counts["loop"] == tuple(n_batches * c for c in TRAIN_LAUNCHES), \
        f"{title} {dtype}: loop launches {counts['loop']}"
    assert span["captured"] == TRAIN_LAUNCHES, \
        f"{title} {dtype}: the captured step holds {span['captured']}, " \
        f"want {TRAIN_LAUNCHES} (fwd, fwd tc, dX, dX tc, dW)"
    assert counts["scan"] == tuple(2 * c for c in TRAIN_LAUNCHES), \
        f"{title} {dtype}: scan launches {counts['scan']}"
    assert replays == n_batches - 1, f"{title} {dtype}: {replays} replays"
    assert len(loss["scan"]) == n_batches and np.all(
        np.isfinite(loss["scan"])), f"{title} {dtype}: scan losses"
    assert d_loss <= SCAN_TOL, f"{title} {dtype}: losses differ by {d_loss}"
    assert d_p <= SCAN_TOL, f"{title} {dtype}: parameters differ by {d_p}"
    assert same_rng, f"{title} {dtype}: generator states differ"
    assert len(np.unique(recs["scan"]["bce"])) == n_batches, \
        f"{title} {dtype}: a replay repeated another step's loss"

    tests = [clouds, clouds[:4], clouds[4:], clouds[2:6]]
    tr, rows, tcounts = trs["loop"], {}, {}
    seen_t = record_spy(tr)
    with spy_scan(tr, spans):
        for m in ("loop", "scan"):
            set_counts()
            tr.test_scanned(tests, mode=m)
            tcounts[m] = launch_counts()
            rows[m] = np.concatenate(
                [seen_t[-1][1][k].reshape(len(tests), -1)
                 for k in ("bce", "bpp", "bces", "metrics")], axis=1)
    d_test = max_rel(rows["loop"], rows["scan"])
    log(f"{title} {dtype}: test_scanned on {len(tests)} batches, scan "
        f"against loop: rows differ by {d_test:.3g} (relative; bits equal "
        f"{np.array_equal(rows['loop'], rows['scan'])}), gate {SCAN_TOL}; "
        f"conv3 launches loop {tcounts['loop'][0]}, scan {tcounts['scan'][0]} "
        f"(capture {spans[-1]['captured'][0]}), {tr.graph_replays} replays")
    assert tr.graph_replays == len(tests) - 1
    assert spans[-1]["captured"][0] * len(tests) == tcounts["loop"][0] > 0
    assert d_test <= SCAN_TOL, f"{title} {dtype}: test rows differ {d_test}"
    assert len(np.unique(rows["scan"][:, 0])) == len(tests), \
        f"{title} {dtype}: test rows repeat"
    del trs["loop"], tr
    torch.cuda.empty_cache()
    return {"loop_launches": counts["loop"], "scan_launches": counts["scan"],
            "captured": span["captured"], "replays": replays,
            "diff_loss": d_loss, "diff_records": d_rec,
            "same_record_bits": same_rec, "diff_params": d_p,
            "same_param_bits": same_p, "same_generator": same_rng,
            "diff_test_rows": d_test,
            "capture_ms": span["capture_s"] * 1e3,
            "losses": loss["scan"].tolist()}, trs["scan"]


def phase_train_scanned(device, workdir: str, card: str, clouds):
    """7d: Trainer.train_scanned in mode="scan" (one captured CUDA graph
    replayed per step) and mode="loop" (one upload and one packed fetch
    per call) and Trainer.train (a copy and a fetch per step), bf16 and
    f32.  First `scan_against_loop`'s gates on SCAN_GATE_BATCHES batches,
    then the three in turns on calls of SCANNED_BATCHES batches of the 8
    clouds (scripts/train_rd.py's call): wall per step of each call (its
    checkpoint write included), peak memory, and for the scan its eager
    first step, its capture and its replayed steps; then test_scanned's
    loop and scan in turns on as many batches.  The first scan turn of
    each passes no mode: the card's default must take the graph there.
    The same launches per step in train and the loop, those of one eager
    step and one capture in the scan.  From the readings, the steps per
    call from which the graph pays (`SCAN_MIN_STEPS` of the trainer is
    set from it).  One replay per dtype is profiled."""
    import statistics

    import torch

    from pcgcv2_torch.train.trainer import SCAN_MIN_STEPS

    n = SCANNED_BATCHES
    log(f"== phase 7d: train_scanned scan / loop and train, calls of {n} "
        f"batches; test_scanned scan / loop ==")
    result = {}
    for dtype in ("bfloat16", "float32"):
        gates, tr = scan_against_loop(device, workdir, card, clouds, dtype,
                                      SCAN_GATE_BATCHES, "7d")
        batches = [clouds] * n
        runs = {"train": [], "loop": [], "scan": []}
        tests = {"loop": [], "scan": []}
        turns = [("train", m) for m in ("train", "loop", "scan", "scan",
                                        "loop", "train")] + \
            [("test", m) for m in ("loop", "scan", "scan", "loop")]
        for turn, (fn, mode) in enumerate(turns):
            default = mode == "scan" and turns[turn - 1][1] != "scan"
            asked = None if default else mode
            spans = []
            replays = tr.graph_replays
            with spy_scan(tr, spans):
                set_counts()
                sec, peak, _ = peak_of(
                    (lambda: tr.train(batches)) if mode == "train" else
                    (lambda: tr.train_scanned(batches, mode=asked))
                    if fn == "train" else
                    (lambda: tr.test_scanned(batches, mode=asked)))
                counts = launch_counts()
            r = {"ms_per_step": sec / n * 1e3, "peak_bytes": peak,
                 "launches": counts, "mode_asked": asked}
            if mode == "scan":
                (span,) = spans
                assert span["mode"] == "scan", \
                    f"7d {dtype} {fn}: no mode given, {span['mode']} taken"
                r.update(first_ms=span["first_s"] * 1e3,
                         capture_ms=span["capture_s"] * 1e3,
                         replay_ms=span["replays_s"] / (n - 1) * 1e3)
                assert tr.graph_replays - replays == n - 1
                if fn == "train":
                    assert span["captured"] == TRAIN_LAUNCHES
                r["captured"] = span["captured"]
            if fn == "train":
                want = tuple((2 if mode == "scan" else n) * c
                             for c in TRAIN_LAUNCHES)
                assert counts == want, f"7d {dtype} {mode}: launches {counts}"
                runs[mode].append(r)
            else:
                tests[mode].append(r)
            extra = (f"  first step {r['first_ms']:.2f} ms, capture "
                     f"{r['capture_ms']:.2f} ms, replayed steps "
                     f"{r['replay_ms']:.2f} ms each" if mode == "scan"
                     else "")
            what = ("train" if mode == "train" else
                    f"{fn}_scanned(mode={asked!r}) {mode}")
            log(f"7d {dtype} {what}: {n} steps in {sec:.3f} s, "
                f"{r['ms_per_step']:.2f} ms per step, peak "
                f"{peak / 2**30:.2f} GiB, conv3 fwd / dX / dW {counts[0]} / "
                f"{counts[2]} / {counts[4]}{extra}  [{card}]")
        # test_scanned: the loop's forwards n x those of one capture
        cap = tests["scan"][0]["captured"][0]
        assert cap > 0 and all(x["launches"][0] == n * cap
                               for x in tests["loop"])
        assert all(x["launches"][0] == 2 * cap for x in tests["scan"])
        spans = []
        with spy_scan(tr, spans, profile_at=1):
            tr.train_scanned(batches[:3], mode="scan")
        prof = spans[0]["profiled"]
        gates["profile_replay"] = train_profile(prof["prof"], prof["sec"],
                                                dtype, "_replay")
        best = {m: min(x["ms_per_step"] for x in v) for m, v in runs.items()}
        replay = min(x["replay_ms"] for x in runs["scan"])
        pays = {}
        for fn, rs in (("train", runs), ("test", tests)):
            # one call's eager first step + capture against n - 1 replays:
            # the graph pays from (first + capture - replay) / (loop -
            # replay) steps a call on
            sc, lo = rs["scan"], rs["loop"]
            rep = statistics.median(x["replay_ms"] for x in sc)
            over = statistics.median(x["first_ms"] + x["capture_ms"]
                                     for x in sc) - rep
            gain = statistics.median(x["ms_per_step"] for x in lo) - rep
            pays[fn] = over / gain if gain > 0 else float("inf")
        tbest = {m: min(x["ms_per_step"] for x in v)
                 for m, v in tests.items()}
        log(f"7d {dtype}: best ms per step, train {best['train']:.2f}, loop "
            f"{best['loop']:.2f}, scan {best['scan']:.2f} (replayed steps "
            f"{replay:.2f}; scan over train "
            f"{best['scan'] / best['train']:.3f}); test_scanned loop "
            f"{tbest['loop']:.2f}, scan {tbest['scan']:.2f} ms per batch; "
            f"the graph pays from {pays['train']:.2f} steps a call "
            f"(train_scanned) and {pays['test']:.2f} (test_scanned); "
            f"SCAN_MIN_STEPS {SCAN_MIN_STEPS}  [{card}]")
        result[dtype] = {**gates, "runs": runs, "tests": tests,
                         "best_ms_per_step": best, "best_test_ms": tbest,
                         "best_replay_ms": replay, "pays_from": pays,
                         "graph_replays": tr.graph_replays}
        del tr
        torch.cuda.empty_cache()
    result["batches"] = n
    return result


def phase_train(device, workdir: str, card: str):
    clouds = train_batch()
    return {"kernels": phase_train_kernels(device, workdir, clouds),
            "steps": phase_train_steps(device, workdir, card, clouds),
            "cli": phase_train_cli(device, workdir),
            "scanned": phase_train_scanned(device, workdir, card, clouds)}


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
            **({"bound_cuda_cores_ms": dw_cuda_core_bound(rows)}
               if prefix == "dw" and dtype == "float32" else {}),
        }

    out = []
    for name, prefix, source, how, lib in (
            ("conv3_dgrad", "dx", "pcgcv2_torch/csrc/conv3_tc.cu",
             "tc (conv3_tc.cu on flip_weight(W), {})",
             "torch.nn.grad.conv3d_input (cuDNN) on the live rows' halo"),
            ("conv3_wgrad", "dw", "pcgcv2_torch/csrc/conv3_wgrad.cu",
             "conv3_wgrad.cu ({})",
             "torch.nn.grad.conv3d_weight (cuDNN) on the live rows' halo")):
        out.append({
            "name": name, "route": "cuda", "source": source,
            # no Pallas original: XLA's VJP of blocks.conv3
            "replaces": "pcgcv2_tpu/ops/blocks.py:656",
            **entry(prefix, "float32"), "dtype": "float32",
            "kernel_route": how.format(F32_ROUTE if prefix == "dx"
                                       else WGRAD_F32_ROUTE),
            "bfloat16": {**entry(prefix, "bfloat16"), "source": source,
                         "kernel_route": how.format(
                             BF16_ROUTE if prefix == "dx"
                             else WGRAD_BF16_ROUTE)},
            "library": lib, "per": "training step",
        })
    return out


# ---------------------------------------------------------------------------
# Phase 8: the parallel paths (pcgcv2_torch/parallel) on the one card
# ---------------------------------------------------------------------------

DP_STEPS = 3         # steps of each DP run (8a: and of each Trainer run)
DP_RANKS = 2         # 8b and 8c: two ranks share the one card over gloo
# 8a and 8b against Trainer.step / the single-process replica: losses
# relative, parameters and gradients over each tensor's max |.|
DP_TOL = 1e-5
# rows per cloud of the padded [B, P, 3] batch: above the batch's largest
# cloud (66,203 voxels)
DP_ITEM_CAP = 1 << 17
# conv3 launches per rank per spatial decode: stages 0-1 whole (22), the
# rank's slab of stage 2 (11)
SPATIAL_LAUNCHES = 33


def dp_plan(world: int):
    """A rank's plan: for_training sized for its share of the batch (at
    world size 1, phase 7b's plan)."""
    from pcgcv2_torch.config import BlockPlan

    return BlockPlan.for_training(TRAIN_CAPACITY // world, TRAIN_RES,
                                  TRAIN_BATCH // world)


def dp_batch(clouds):
    """The training batch as pad_batch gives it: [8, DP_ITEM_CAP, 3] +
    [8], no cloud cut."""
    from pcgcv2_torch.parallel.train import pad_batch

    coords, counts = pad_batch(clouds, DP_ITEM_CAP)
    assert counts.tolist() == [len(c) for c in clouds], "a cloud was cut"
    return coords, counts


def rel_spread(a: dict, b: dict) -> float:
    """max over the tensors of max |a - b| / max |a|."""
    return max(float((a[k] - b[k]).abs().max()
                     / a[k].abs().max().clamp_min(1e-30)) for k in a)


def named_copy(model, grads: bool = False) -> dict:
    return {k: (p.grad if grads else p).detach().float().cpu().clone()
            for k, p in model.named_parameters()}


def dp_model(state, num_batches: int, device):
    """A full-width PCCModel from `state` and the trainer's Adam over it."""
    from pcgcv2_torch.config import ModelConfig
    from pcgcv2_torch.models.pcc import PCCModel
    from pcgcv2_torch.train.trainer import make_optimizer

    cfg = train_config()
    model = PCCModel(ModelConfig(), num_batches=num_batches).to(device)
    model.load_state_dict(state)
    return model, make_optimizer(model.parameters(), cfg.lr,
                                 cfg.weight_decay)


def dp_steps(step, model, coords, counts, device, world: int = 1,
             check: bool = False):
    """DP_STEPS steps of `step` on the global batch: per step its ms, mean
    loss, dropped blocks and conv3 launches; the gradients and parameters
    after the first step; where `check`, every conv3 launch of the first
    step checked on its own inputs (spy_forward, untimed spy_backward):
    the rows.  At world > 1 the peak memory counts from the second step."""
    import torch
    import torch.distributed as dist

    ct = torch.from_numpy(coords).to(device)
    nt = torch.from_numpy(counts).to(device)
    steps, first, fwd, bwd = [], None, [], []
    for i in range(DP_STEPS):
        if world > 1:
            dist.barrier()
        set_counts()
        with contextlib.ExitStack() as spies:
            if check and i == 0:
                spies.enter_context(spy_forward(fwd))
                spies.enter_context(spy_backward(bwd, timing=False))
            sec, (loss, dropped) = timed(lambda: step(ct, nt))
        steps.append({"ms": sec * 1e3, "loss": loss.item(),
                      "dropped": int(dropped), "launches": launch_counts()})
        if i == 0:
            first = (named_copy(model, grads=True), named_copy(model))
            if world > 1:
                torch.cuda.reset_peak_memory_stats()
    return steps, first, (fwd, bwd)


def dp_world1(device, workdir: str, card: str, group, clouds):
    """8a: DP_STEPS steps of make_dp_train_step at world size 1 (NCCL)
    against DP_STEPS Trainer.steps from the same weights and generator
    seed; first two Trainer runs against each other (the spread)."""
    import torch
    import torch.distributed as dist

    from pcgcv2_torch.parallel import mesh as M
    from pcgcv2_torch.parallel.train import make_dp_train_step

    log("== phase 8a: DP step at world size 1 over NCCL vs Trainer.step "
        "(bf16, 8 clouds, remat on) ==")
    plan = dp_plan(1)
    runs = []
    for tag in ("a", "b"):
        tr = make_trainer("bfloat16", f"{workdir}/8a_{tag}", device)
        state0 = {k: v.detach().clone()
                  for k, v in tr.model.state_dict().items()}
        tr.generator.manual_seed(0)  # init_weights drew from it
        coords, valid = tr._collate(clouds)
        losses, ms = [], []
        for _ in range(DP_STEPS):
            sec, (d, _, n_drop) = timed(lambda: tr.step(coords, valid))
            assert int(n_drop) == 0, "8a trainer step dropped blocks"
            losses.append(d["loss"].item())
            ms.append(sec * 1e3)
        runs.append((state0, losses, named_copy(tr.model), ms))
        del tr, coords, valid
        torch.cuda.empty_cache()
    (s_a, l_a, p_a, ms_a), (s_b, l_b, p_b, _) = runs
    assert all(torch.equal(s_a[k], s_b[k]) for k in s_a), "8a init differs"
    spread_loss = max(abs(x - y) / abs(x) for x, y in zip(l_a, l_b))
    spread_p = rel_spread(p_a, p_b)

    model, opt = dp_model(s_a, TRAIN_BATCH, device)
    cfg = train_config()
    step = make_dp_train_step(model, opt, group, cfg.alpha, cfg.beta, plan,
                              device=device, seed=0)
    coords, counts = dp_batch(clouds)
    steps, _, _ = dp_steps(step, model, coords, counts, device)
    p_dp = named_copy(model)
    grads = [p.grad for p in model.parameters()]
    ar_ms = cuda_ms(lambda: M.all_reduce_mean_(grads, group))
    flat = torch.cat([g.reshape(-1) for g in grads])
    nccl_ms = cuda_ms(lambda: dist.all_reduce(flat, group=group))
    flat_mb = flat.numel() * flat.element_size() / 2**20
    d_loss = max(abs(s["loss"] - x) / abs(x) for s, x in zip(steps, l_a))
    d_p = rel_spread(p_a, p_dp)
    med = statistics.median(s["ms"] for s in steps)
    for i, s in enumerate(steps):
        log(f"8a dp step {i}: {s['ms']:.2f} ms  loss {s['loss']:.6f} "
            f"(Trainer {l_a[i]:.6f})  dropped {s['dropped']}  conv3 fwd "
            f"{s['launches'][0]} ({s['launches'][1]} tc)  dX "
            f"{s['launches'][2]} ({s['launches'][3]} tc)  dW "
            f"{s['launches'][4]}")
    log(f"8a: two Trainer runs differ by {spread_loss:.3g} (loss, relative) "
        f"and {spread_p:.3g} (parameters, of max |p|); the DP step from "
        f"Trainer by {d_loss:.3g} and {d_p:.3g} (gate {DP_TOL}) after "
        f"{DP_STEPS} steps; step median {med:.2f} ms (Trainer "
        f"{statistics.median(ms_a):.2f}); the {flat_mb:.2f} MiB flat "
        f"gradient: NCCL all-reduce {nccl_ms:.4f} ms, the whole "
        f"all_reduce_mean_ (cat, all-reduce, divide, copy back to "
        f"{len(grads)} tensors) {ar_ms:.4f} ms  [{card}]")
    for s in steps:
        assert s["dropped"] == 0, "8a dp step dropped blocks"
        assert s["launches"] == TRAIN_LAUNCHES, \
            f"8a launches {s['launches']}, want {TRAIN_LAUNCHES}"
    assert d_loss <= DP_TOL, f"8a loss differs by {d_loss}"
    assert d_p <= DP_TOL, f"8a parameters differ by {d_p}"
    del model, opt, step, grads, flat
    torch.cuda.empty_cache()
    return {"steps": steps, "step_ms_median": med,
            "trainer_ms": ms_a, "trainer_losses": l_a,
            "spread_loss": spread_loss, "spread_params": spread_p,
            "diff_loss": d_loss, "diff_params": d_p,
            "allreduce_mean_ms": ar_ms, "nccl_allreduce_ms": nccl_ms,
            "flat_mib": flat_mb,
            "launches": dict(zip(("fwd", "fwd_tc", "dx", "dx_tc", "dw"),
                                 steps[-1]["launches"]))}, s_a


def spatial_frames(device, workdir: str, card: str):
    """The frames of 8c and 8d, ckpts/r4 in bf16: the vox11 torus of phase
    6b and the vox10 frame, each through Coder.encode (the bottleneck the
    ranks get, as arrays) and decoded here monolithic (model.decode_fn)
    and streamed (8 slabs): the references."""
    import numpy as np
    import torch

    from pcgcv2_torch.checkpoint import load_params
    from pcgcv2_torch.codec.coder import Coder
    from pcgcv2_torch.data.synthetic import torus_cloud
    from pcgcv2_torch.ops import blocks as B

    params = load_params(str(ROOT / "ckpts/r4/r4_final.ckpt"))
    B.set_compute_dtype("bfloat16")
    frames = {}
    for name, cloud, res in (
            ("vox11", torus_cloud(1390, density=4.0, seed=11), 2048),
            ("vox10", torus_cloud(684, density=4.0, seed=0), 1024)):
        coder = Coder(params, os.path.join(workdir, f"p8_{name}"), res=res,
                      device=device, streamed_slabs=8)
        ds, feats = coder.encode(cloud)
        with open(coder.filename + "_num_points.bin", "rb") as f:
            head = np.frombuffer(f.read(28), dtype=np.int32)
        streamed = coder.decode()
        mono = monolithic_decode(coder, "")
        rows = np.zeros((len(ds), 4), np.int32)
        rows[:, 1:] = ds * 8
        frames[name] = {
            "cloud": cloud, "res": res, "streamed": streamed, "mono": mono,
            "bits": sum(8 * v for v in coder.bitstream_bytes().values()),
            "rank_input": {"plan": coder._plan_from_counts(head[3:7]),
                           "rows": rows, "feats": feats.astype(np.float32),
                           "nums": head[:3].copy()}}
        log(f"8 frame {name}: {len(cloud)} voxels, bottleneck {len(ds)} "
            f"rows, plan {frames[name]['rank_input']['plan'].nb}; decoded "
            f"monolithic {len(mono)}, streamed {len(streamed)}, symmetric "
            f"difference {sym_diff(mono, streamed)}")
        del coder
        torch.cuda.empty_cache()
    return frames, params


def spatial_run(model, frame: dict, group, device, keep_points: bool):
    """Two spatial decodes of `frame` on this rank.  The first checks every
    forward conv3 launch on its own inputs (spy_forward); the second is
    the one measured: wall, the top-k's wall (a spy on
    ops.blocks.topk_mask), peak memory, conv3 launches, and the stacked
    output's digest (the assembled points where `keep_points`), which must
    be the first decode's."""
    import hashlib

    import torch
    import torch.distributed as dist

    from pcgcv2_torch.ops import blocks as B
    from pcgcv2_torch.ops import conv3 as K
    from pcgcv2_torch.parallel import spatial as S

    nums = frame["nums"]
    fn = S.make_spatial_decode_fn(model, frame["plan"], group, int(nums[2]),
                                  device=device)
    args = (torch.from_numpy(frame["rows"]).to(device),
            torch.from_numpy(frame["feats"]).to(device),
            torch.ones(len(frame["rows"]), dtype=torch.bool, device=device),
            torch.from_numpy(nums).to(device))

    def digest(oc, counts):
        return hashlib.sha256(oc.cpu().numpy().tobytes()
                              + counts.cpu().numpy().tobytes()).hexdigest()

    checked = []
    dist.barrier()
    with torch.inference_mode(), spy_forward(checked):
        first = digest(*fn(*args)[:2])
    topk, real = [], B.topk_mask

    def spy(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*a, **kw)
        torch.cuda.synchronize()
        topk.append(time.perf_counter() - t0)
        return out

    B.topk_mask = spy
    try:
        dist.barrier()
        torch.cuda.reset_peak_memory_stats()
        set_counts()
        with torch.inference_mode():
            sec, (oc, counts, dropped) = timed(lambda: fn(*args))
        launches = (K.conv3.launches, K.conv3.tc_launches)
        peak = torch.cuda.max_memory_allocated()
    finally:
        B.topk_mask = real
    h = digest(oc, counts)
    oc, counts = oc.cpu().numpy(), counts.cpu().numpy()
    n = dist.get_world_size()
    return {"points": S.assemble_decoded(oc, counts, n) if keep_points
            else None,
            "digest": h, "same_as_checked": h == first, "checked": checked,
            "counts": counts.tolist(), "dropped": int(dropped), "sec": sec,
            "topk_s": sum(topk), "launches": launches, "peak": peak}


def check_spatial(name: str, frame: dict, outs: list, card: str,
                  tag: str) -> dict:
    """8c/8d gates: every rank's SPATIAL_LAUNCHES forward conv3 launches
    against conv3_plain on their own inputs (the checked decode), the
    timed decode's output that of the checked one and the same on every
    rank, nothing dropped, the assembled set equal to the monolithic and
    the streamed decodes, the phase-6 bpp and D1 gates, SPATIAL_LAUNCHES
    conv3 launches per rank, all on the tensor cores."""
    import numpy as np

    from pcgcv2_torch.eval.metrics import pc_metrics

    checked = [forward_summary(o["checked"], f"{tag} {name} rank {r}", card)
               for r, o in enumerate(outs)]
    for r, o in enumerate(outs):
        assert len(o["checked"]) == SPATIAL_LAUNCHES, \
            f"{tag} {name} rank {r}: {len(o['checked'])} launches checked"
        assert o["same_as_checked"], \
            f"{tag} {name} rank {r}: the timed decode differs from the first"
    pts, n = outs[0]["points"], len(frame["cloud"])
    d_mono, d_str = sym_diff(pts, frame["mono"]), sym_diff(
        pts, frame["streamed"])
    d1 = pc_metrics(frame["cloud"], np.unique(pts, axis=0), frame["res"],
                    with_d2=False)["mseF,PSNR (p2point)"]
    bpp = frame["bits"] / n
    for r, o in enumerate(outs):
        log(f"{tag} {name} rank {r}: {o['sec']:.4f} s (top-k "
            f"{o['topk_s']:.4f} s)  peak {o['peak'] / 2**30:.2f} GiB  "
            f"counts {o['counts']}  dropped {o['dropped']}  conv3 launches "
            f"{o['launches'][0]} ({o['launches'][1]} tensor-core)  [{card}]")
    log(f"{tag} {name}: decoded {len(pts)} / {n}; symmetric difference to "
        f"the monolithic decode {d_mono}, to the streamed {d_str}  bpp "
        f"{bpp:.6f}  D1 {d1:.4f} dB")
    assert len({o["digest"] for o in outs}) == 1, f"{tag} ranks disagree"
    assert all(o["dropped"] == 0 for o in outs), f"{tag} {name} dropped"
    assert len(pts) == n and d_mono == 0 and d_str == 0, \
        f"{tag} {name}: {len(pts)} points, differences {d_mono} / {d_str}"
    want_bpp, want_d1 = (VOX11_GATES if name == "vox11"
                         else VOX10_GATES)["bfloat16"]
    assert abs(bpp - want_bpp) <= 0.005 * want_bpp, f"{tag} {name} bpp"
    assert abs(d1 - want_d1) <= 0.05, f"{tag} {name} D1 {d1}"
    for o in outs:
        assert o["launches"] == (SPATIAL_LAUNCHES,) * 2, \
            f"{tag} {name} launches {o['launches']}"
    return {"decoded": len(pts), "sym_diff_mono": d_mono,
            "sym_diff_streamed": d_str, "bpp": bpp, "d1_psnr": d1,
            "checked": checked,
            "ranks": [{k: o[k] for k in ("sec", "topk_s", "peak", "counts",
                                         "launches", "dropped")}
                      for o in outs]}


def parallel_rank(rank: int, world: int, init: str, dp, frames: dict,
                  params):
    """A rank of 8b and 8c (spawned; world DP_RANKS on the one card over
    gloo): DP_STEPS DP steps on its 4 clouds at its plan (dp_plan), rank
    0 checking every conv3 launch of the first, then the spatial decode
    of each frame (checked, then timed)."""
    import torch
    import torch.distributed as dist

    from pcgcv2_torch.checkpoint import params_from_jax
    from pcgcv2_torch.config import ModelConfig
    from pcgcv2_torch.ops import blocks as B
    from pcgcv2_torch.parallel import mesh as M
    from pcgcv2_torch.parallel.train import make_dp_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    group, dev = M.init_group(rank, world, init, device="cuda",
                              backend="gloo")
    try:
        B.set_compute_dtype("bfloat16")
        state0, coords, counts = dp
        model, opt = dp_model(state0, TRAIN_BATCH // world, dev)
        cfg = train_config()
        step = make_dp_train_step(model, opt, group, cfg.alpha, cfg.beta,
                                  dp_plan(world), device=dev, seed=0)
        torch.cuda.reset_peak_memory_stats()
        steps, first, checked = dp_steps(step, model, coords, counts, dev,
                                         world, check=rank == 0)
        out = {"dp": {"steps": steps, "grads": first[0],
                      "params": first[1], "checked": checked,
                      "peak": torch.cuda.max_memory_allocated()}}
        del model, opt, step
        torch.cuda.empty_cache()
        model = params_from_jax(params, ModelConfig(), dev)
        out["spatial"] = {name: spatial_run(model, f, group, dev, rank == 0)
                          for name, f in frames.items()}
        return out
    finally:
        dist.destroy_process_group()


def check_dp_ranks(device, ranks: list, state0, coords, counts,
                   card: str) -> dict:
    """8b gates: every conv3 launch of rank 0's first step (at this plan's
    caps) against the plain versions on its own inputs (phase 7a's gates);
    the ranks' averaged gradients and updated parameters after their first
    step, identical on both ranks and within DP_TOL of one single-process
    replica on the card (per-shard backward with each rank's noise
    generator, gradients averaged by hand, one Adam step); launches per
    rank and step."""
    import torch

    from pcgcv2_torch.parallel.train import collate_on_device
    from pcgcv2_torch.train.loss import rd_loss

    world, local = len(ranks), TRAIN_BATCH // len(ranks)
    fwd, bwd = ranks[0]["dp"]["checked"]
    checked = {"forward": forward_summary(fwd, "8b rank 0 step 0", card),
               "backward": backward_summary(bwd, "8b rank 0 step 0")}
    assert (len(fwd), checked["backward"]["dx"], len(bwd)) \
        == TRAIN_LAUNCHES[::2], "8b: the check missed conv3 launches"
    plan = dp_plan(world)
    model, opt = dp_model(state0, local, device)
    cfg = train_config()
    named = dict(model.named_parameters())
    total = {k: torch.zeros_like(p) for k, p in named.items()}
    losses = []
    for r in range(world):
        gen = torch.Generator(device=device)
        gen.manual_seed(r)  # rank r's generator: seed 0 + r
        sl = slice(r * local, (r + 1) * local)
        rows, valid = collate_on_device(
            torch.from_numpy(coords[sl]).to(device),
            torch.from_numpy(counts[sl]).to(device))
        out = model(rows, valid, plan, training=True, generator=gen)
        loss = rd_loss(out, cfg.alpha, cfg.beta, "train")["loss"]
        opt.zero_grad(set_to_none=True)
        loss.backward()
        losses.append(loss.item())
        for k, p in named.items():
            total[k] += p.grad
        del out, loss
    for k, p in named.items():
        p.grad = total[k] / world
    ref_g = named_copy(model, grads=True)
    opt.step()
    ref_p = named_copy(model)
    del model, opt, total
    torch.cuda.empty_cache()
    ref_loss = sum(losses) / world
    d_g = max(rel_spread(ref_g, r["dp"]["grads"]) for r in ranks)
    d_p = max(rel_spread(ref_p, r["dp"]["params"]) for r in ranks)
    d_loss = max(abs(r["dp"]["steps"][0]["loss"] - ref_loss) / abs(ref_loss)
                 for r in ranks)
    same = all(torch.equal(ranks[0]["dp"][w][k], r["dp"][w][k])
               for r in ranks for w in ("grads", "params")
               for k in ref_g)
    for i, r in enumerate(ranks):
        st = r["dp"]["steps"]
        ms = ", ".join("%.2f" % s["ms"] for s in st)
        losses = ", ".join("%.6f" % s["loss"] for s in st)
        log(f"8b rank {i}: steps {ms} ms (the first warms up and, on rank "
            f"0, is checked)  losses {losses}  peak of steps 1-"
            f"{DP_STEPS - 1} {r['dp']['peak'] / 2**30:.2f} GiB  launches "
            f"per step {st[-1]['launches']}  [{card}; two ranks share the "
            f"card's SMs: not a scale-out time]")
    log(f"8b: ranks identical {same}; against the replica: loss "
        f"{d_loss:.3g} (relative), gradients {d_g:.3g}, parameters "
        f"{d_p:.3g} (of max |.|; gate {DP_TOL})")
    assert same, "8b ranks hold different gradients or parameters"
    assert d_loss <= DP_TOL and d_g <= DP_TOL and d_p <= DP_TOL, \
        f"8b differs from the replica: {d_loss}, {d_g}, {d_p}"
    for r in ranks:
        for s in r["dp"]["steps"]:
            assert s["dropped"] == 0, "8b step dropped blocks"
            assert s["launches"] == TRAIN_LAUNCHES, \
                f"8b launches {s['launches']}, want {TRAIN_LAUNCHES}"
    return {"diff_loss": d_loss, "diff_grads": d_g, "diff_params": d_p,
            "checked": checked,
            "ranks": [{"step_ms": [s["ms"] for s in r["dp"]["steps"]],
                       "step_ms_median": statistics.median(
                           s["ms"] for s in r["dp"]["steps"][1:]),
                       "losses": [s["loss"] for s in r["dp"]["steps"]],
                       "peak": r["dp"]["peak"]} for r in ranks],
            "launches": dict(zip(("fwd", "fwd_tc", "dx", "dx_tc", "dw"),
                                 ranks[0]["dp"]["steps"][-1]["launches"]))}


def phase_parallel(device, workdir: str, card: str):
    """Phase 8: 8a (DP, one rank, NCCL) and 8d (spatial decode of vox10,
    one rank, NCCL) in this process; then 8b (DP) and 8c (spatial decode
    of vox11 and vox10) on DP_RANKS spawned ranks sharing the card over
    gloo.  The kernels are built before (main), so no rank builds."""
    import torch
    import torch.distributed as dist

    from pcgcv2_torch.checkpoint import params_from_jax
    from pcgcv2_torch.config import ModelConfig
    from pcgcv2_torch.parallel import mesh as M

    clouds = train_batch()
    result = {}
    group, _ = M.init_group(0, 1, f"file://{workdir}/nccl_store",
                            device=device)
    try:
        result["8a"], state0 = dp_world1(device, workdir, card, group,
                                         clouds)
        frames, params = spatial_frames(device, workdir, card)
        log("== phase 8d: spatial decode at world size 1 over NCCL, vox10 "
            "frame ==")
        model = params_from_jax(params, ModelConfig(), device)
        out = spatial_run(model, frames["vox10"]["rank_input"], group,
                          device, True)
        result["8d"] = check_spatial("vox10", frames["vox10"], [out], card,
                                     "8d")
        del model
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    log(f"== phase 8b/8c: {DP_RANKS} ranks on the one card over gloo: DP "
        f"step (4 clouds per rank), spatial decode of vox11 and vox10 ==")
    coords, counts = dp_batch(clouds)
    state0 = {k: v.cpu() for k, v in state0.items()}
    t0 = time.perf_counter()
    ranks = M.spawn(parallel_rank, DP_RANKS, (state0, coords, counts),
                    {k: f["rank_input"] for k, f in frames.items()}, params)
    result["ranks_s"] = time.perf_counter() - t0
    log(f"8b/8c: {DP_RANKS} ranks spawned, ran and joined in "
        f"{result['ranks_s']:.1f} s")
    result["8b"] = check_dp_ranks(device, ranks, state0, coords, counts,
                                  card)
    result["8c"] = {name: check_spatial(name, frames[name],
                                        [r["spatial"][name] for r in ranks],
                                        card, "8c")
                    for name in frames}
    return result


def parallel_launches(par: dict) -> dict:
    """The conv3 launches phase 8 read, per kernel and path, and the worst
    error over max |ref| of the launches it checked on their own inputs
    (8b rank 0's first step, 8c and 8d every rank's checked decode)."""
    def sp(tag, name):
        out = par[tag][name] if tag == "8c" else par[tag]
        return [r["launches"][0] for r in out["ranks"]]

    spatial = [par["8d"]] + list(par["8c"].values())
    checked_bwd = par["8b"]["checked"]["backward"]["worst_rel_err"]
    return {
        "conv3": {"dp_world1_per_step": par["8a"]["launches"]["fwd"],
                  "dp_world2_per_rank_step": par["8b"]["launches"]["fwd"],
                  "spatial_vox11_world2_per_rank": sp("8c", "vox11"),
                  "spatial_vox10_world2_per_rank": sp("8c", "vox10"),
                  "spatial_vox10_world1": sp("8d", None),
                  "checked_max_rel_err": max(
                      [par["8b"]["checked"]["forward"]["worst_rel_err"]]
                      + [c["worst_rel_err"] for f in spatial
                         for c in f["checked"]])},
        **{name: {"dp_world1_per_step": par["8a"]["launches"][key],
                  "dp_world2_per_rank_step": par["8b"]["launches"][key],
                  "checked_max_rel_err": checked_bwd[key]}
           for name, key in (("conv3_dgrad", "dx"), ("conv3_wgrad", "dw"))},
    }


# ---------------------------------------------------------------------------
# Phase 9: 8^3 blocks (PCGC_BLOCK_SIZE=8), in a child process
# ---------------------------------------------------------------------------

BS8_CHILD_TIMEOUT = 900  # seconds


def frame_caps() -> dict:
    """The vox10 frame's occupied blocks per stride (1, 2, 4, 8) and its
    exact-fit plan at this process's block side: encoder caps, decoder
    caps and candidate caps, with the dense slots (cap x BS^3) of each."""
    from pcgcv2_torch.codec.coder import block_counts
    from pcgcv2_torch.config import BlockPlan
    from pcgcv2_torch.data.synthetic import torus_cloud
    from pcgcv2_torch.ops import blocks as B

    counts = block_counts(torus_cloud(684, density=4.0, seed=0))
    plan = BlockPlan.for_frame(1024, counts)
    caps = {"bs": B.BS, "blocks": list(counts), "nb": list(plan.nb),
            "dec_nb": list(plan.dec_nb),
            "up_caps": [plan.up_cap(s) for s in range(3)]}
    caps["dense_slots"] = {k: [c * B.VOL for c in caps[k]]
                           for k in ("nb", "dec_nb", "up_caps")}
    caps["dense_slots_total"] = sum(sum(v)
                                    for v in caps["dense_slots"].values())
    return caps


def time_forward(launch, kernel: str, bg, nbrs, weight, bias, cd,
                 packed) -> dict:
    """One forward launch's shape, timed on its own inputs: the kernel
    through `launch` (ops.conv3.launch, KERNEL_REPS), conv3_plain, F.conv3d
    on the live rows' halo, and the bound as phase 2 counts it."""
    import torch.nn.functional as F

    from pcgcv2_torch.ops import conv3 as K

    dtype = {"torch.float32": "float32", "torch.bfloat16": "bfloat16"}[
        str(cd)]
    n = int(bg.count)
    ci, co = bg.channels, weight.shape[-1]
    ms = cuda_ms(lambda: launch(kernel, bg, nbrs, weight, bias, cd, packed),
                 KERNEL_REPS)
    plain_ms = cuda_ms(lambda: K.conv3_plain(bg, nbrs, weight, bias, cd), 1)
    h = K.halo(bg.feats.to(cd), nbrs[:n]).permute(0, 4, 1, 2, 3).contiguous()
    wl = weight.permute(4, 3, 0, 1, 2).contiguous()
    lib_ms = cuda_ms(lambda: F.conv3d(h, wl, bias), 3)
    del h
    bytes_ms, ops_ms = conv3_bound(bg, nbrs, ci, co, dtype)
    return {"nb_cap": bg.nb_cap, "live_rows": n, "ci": ci, "co": co,
            "route": kernel, "launches": 0, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms)}


@contextlib.contextmanager
def spy_forward_timed(rows: list, shapes: dict):
    """spy_forward, and the first launch of each (nb_cap, ci, co) also
    timed on its inputs by `time_forward` (its launches taken out of the
    counts); `shapes[key]["launches"]` counts the path's launches of each
    shape."""
    import functools

    from pcgcv2_torch.ops import conv3 as K

    real = K.launch

    @functools.wraps(real)
    def launch(kernel, bg, nbrs, weight, bias, cd, packed=None):
        out = real(kernel, bg, nbrs, weight, bias, cd, packed)
        rows.append(check_forward(kernel, bg, nbrs, weight, bias, cd,
                                  out.feats))
        key = (bg.nb_cap, bg.channels, weight.shape[-1])
        if key not in shapes:
            counts = launch_counts()
            shapes[key] = time_forward(real, kernel, bg, nbrs, weight, bias,
                                       cd, packed)
            set_counts(counts)
        shapes[key]["launches"] += 1
        return out

    K.launch = launch
    try:
        yield
    finally:
        K.launch = real


def bs8_frame_kernels(device, workdir: str, card: str) -> dict:
    """9a: one vox10 encode + decode per dtype (ckpts/r4) at 8^3 blocks,
    every conv3 forward spied on: all 64 on the 8^3 tensor-core instance,
    each held against conv3_plain on its own inputs (FWD_TOL of max |ref|,
    as the real-input checks of phases 7a and 8 hold them: the codec's
    activations reach |ref| 45, where f32 sums of another order already
    differ by more than phase 2's 1e-4 abs), and each shape timed on the
    inputs of its first launch; per-frame sums weight each shape by its
    launches."""
    import torch

    from pcgcv2_torch.checkpoint import load_params
    from pcgcv2_torch.codec.coder import Coder
    from pcgcv2_torch.data.synthetic import torus_cloud
    from pcgcv2_torch.ops import blocks as B

    log("== phase 9a: every conv3 forward of a vox10 encode + decode at "
        "8^3 blocks vs conv3_plain, each shape timed ==")
    params = load_params(str(ROOT / "ckpts/r4/r4_final.ckpt"))
    cloud = torus_cloud(684, density=4.0, seed=0)
    result = {}
    for dtype in ("float32", "bfloat16"):
        B.set_compute_dtype(dtype)
        coder = Coder(params, os.path.join(workdir, f"bs8a_{dtype}"),
                      res=1024, device=device)
        rows, shapes = [], {}
        with spy_forward_timed(rows, shapes):
            _, _, dec, launches, tc = run_frame(coder, cloud, "")
        torch.cuda.synchronize()
        for key, r in sorted(shapes.items()):
            log(f"bs8 conv3 nb={key[0]:<6d} ci={key[1]:<3d} co={key[2]:<3d} "
                f"{dtype:<8s} x{r['launches']}/frame  live {r['live_rows']}"
                f"  {r['route']} {r['ms']:.4f} ms  plain {r['plain_ms']:.4f}"
                f"  F.conv3d(halo) {r['library_ms']:.4f}  bound "
                f"{r['bound_ms']:.4f} ({r['bytes_ms']:.4f} bytes / "
                f"{r['ops_ms']:.4f} ops)  "
                f"{plan_note(key[1], key[2], B._DTYPES[dtype], r['live_rows'])[1]}")
        tot = {k: sum(r["launches"] * r[k] for r in shapes.values())
               for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                         "bytes_ms", "ops_ms")}
        err = max(r["max_abs_err"] for r in rows)
        ref = max(r["max_abs_ref"] for r in rows)
        bad = [r for r in rows if not r["ok"]]
        log(f"bs8 conv3 per vox10 frame, {dtype}: {launches} launches "
            f"({tc} tensor-core, {len(rows)} checked, {len(shapes)} shapes)"
            f"  kernel {tot['ms']:.3f} ms  plain {tot['plain_ms']:.3f}  "
            f"F.conv3d(halo) {tot['library_ms']:.3f}  bound "
            f"{tot['bound_ms']:.4f}  max abs err {err:.3g} (|ref| max "
            f"{ref:.3g}), worst err/|ref| {worst_rel(rows):.3g} (tolerance "
            f"{FWD_TOL[dtype]}) {'OK' if not bad else 'FAIL'}  [{card}]")
        assert len(dec) == len(cloud), f"bs8 decoded {len(dec)} points"
        assert launches == tc == len(rows) == 64, \
            f"bs8 {launches} conv3 launches ({tc} tc, {len(rows)} seen)"
        if bad:
            raise AssertionError(f"bs8 conv3 disagrees with conv3_plain in "
                                 f"{len(bad)} of 64 launches; first {bad[0]}")
        result[dtype] = {
            "launches": launches, "tc_launches": tc, "max_abs_err": err,
            "max_rel_err": worst_rel(rows),
            **tot, "bound_by": ("bytes" if tot["bytes_ms"] >= tot["ops_ms"]
                                else "operations"),
            "shapes": list(shapes.values()),
        }
        del coder
        torch.cuda.empty_cache()
    return result


def worst_rel(rows: list) -> float:
    """The worst max abs error over max |ref| of check_forward's rows."""
    return max(r["max_abs_err"] / max(r["max_abs_ref"], 1e-30)
               for r in rows)


def frame_forward_errors(device, workdir: str, card: str) -> dict:
    """The 9a check at this process's block side, untimed: every conv3
    forward of one vox10 encode + decode per dtype against conv3_plain on
    its own inputs; the worst abs and relative errors, for 9a's beside."""
    import torch

    from pcgcv2_torch.checkpoint import load_params
    from pcgcv2_torch.codec.coder import Coder
    from pcgcv2_torch.data.synthetic import torus_cloud
    from pcgcv2_torch.ops import blocks as B

    params = load_params(str(ROOT / "ckpts/r4/r4_final.ckpt"))
    cloud = torus_cloud(684, density=4.0, seed=0)
    out = {}
    for dtype in ("float32", "bfloat16"):
        B.set_compute_dtype(dtype)
        coder = Coder(params, os.path.join(workdir, f"ferr_{dtype}"),
                      res=1024, device=device)
        rows = []
        with spy_forward(rows):
            run_frame(coder, cloud, "")
        out[dtype] = forward_summary(rows, f"9 {dtype}, the same frame at "
                                     f"{B.BS}^3 blocks", card)
        out[dtype]["max_abs_err"] = max(r["max_abs_err"] for r in rows)
        out[dtype]["max_abs_ref"] = max(r["max_abs_ref"] for r in rows)
        log(f"9 {dtype} at {B.BS}^3: max abs err "
            f"{out[dtype]['max_abs_err']:.3g} (|ref| max "
            f"{out[dtype]['max_abs_ref']:.3g})")
        del coder
        torch.cuda.empty_cache()
    return out


def run_bs8_child(device, workdir: str, card: str, out: str) -> None:
    """Phase 9 at 8^3 blocks, in this process (PCGC_BLOCK_SIZE=8): 9a-9d,
    each phase's result written to `out` (JSON) as it ends; raises on the
    first failure."""
    from pcgcv2_torch.checkpoint import load_params
    from pcgcv2_torch.ops import blocks as B

    assert B.BS == 8, f"phase 9's child runs at BS {B.BS}"
    res = {"card": card, "phase_s": {}}

    def run(key, fn):
        t = time.perf_counter()
        res[key] = fn()
        res["phase_s"][key] = time.perf_counter() - t
        log(f"phase {key}: {res['phase_s'][key]:.1f} s")
        Path(out).write_text(json.dumps(res))

    run("9a", lambda: bs8_frame_kernels(device, workdir, card))
    run("9b", lambda: phase_golden(
        device, workdir, "phase 9b: golden triple at 8^3 blocks, float32"))
    params = load_params(str(ROOT / "ckpts/r4/r4_final.ckpt"))
    run("9c", lambda: {
        "frame": phase_vox10(device, workdir, card,
                             "phase 9c: vox10 frame at 8^3 blocks, ckpts/r4"),
        "caps": frame_caps(),
        "profile": phase_profile(
            device, workdir, "phase 9c: profiler breakdown at 8^3 blocks",
            "_bs8"),
        "streamed": streamed_vox10(device, workdir, card, params, rounds=1)})
    for dtype in ("bfloat16", "float32"):
        assert res["9c"]["streamed"][f"vox10_{dtype}"]["sym_diff"] == 0, \
            f"bs8 {dtype}: the 8-slab decode differs from the monolithic"
    clouds = train_batch()
    run("9d", lambda: {
        "kernels": phase_train_kernels(device, workdir, clouds, "phase 9d"),
        "steps": phase_train_steps(device, workdir, card, clouds,
                                   n_steps=BS8_TRAIN_STEPS,
                                   title="phase 9d", tag="_bs8")})


def phase_bs8(device, workdir: str, card: str) -> dict:
    """Phase 9: `run_bs8_child` in a child process with
    PCGC_BLOCK_SIZE=8 (the block side is read at import); a nonzero exit
    fails the phase.  Prints the child's results beside this process's
    16^3 ones."""
    log("== phase 9: 8^3 blocks (PCGC_BLOCK_SIZE=8), in a child process ==")
    caps16 = frame_caps()
    errs16 = frame_forward_errors(device, workdir, card)
    out = Path(workdir) / "bs8.json"
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--phases", "9",
         "--bs8-child", str(out)],
        env=dict(os.environ, PCGC_BLOCK_SIZE="8"), timeout=BS8_CHILD_TIMEOUT)
    if r.returncode != 0:
        raise RuntimeError(f"phase 9's child exited with {r.returncode}")
    res = json.loads(out.read_text())
    res["child_s"] = time.perf_counter() - t0
    caps8 = res["9c"]["caps"]
    res["caps16"] = caps16
    res["forward_errors16"] = errs16
    for c in (caps16, caps8):
        log(f"9c caps at BS {c['bs']}: blocks {c['blocks']}  nb {c['nb']}  "
            f"dec_nb {c['dec_nb']}  up caps {c['up_caps']}  dense slots nb "
            f"{c['dense_slots']['nb']} dec {c['dense_slots']['dec_nb']} "
            f"cand {c['dense_slots']['up_caps']}  total "
            f"{c['dense_slots_total']}")
    log(f"9c dense slots, 8^3 over 16^3: "
        f"{caps8['dense_slots_total'] / caps16['dense_slots_total']:.3f}")
    for dtype in ("float32", "bfloat16"):
        a, f = res["9a"][dtype], res["9c"]["frame"][dtype]
        st = res["9d"]["steps"][dtype]
        log(f"9 {dtype} at 8^3: conv3 per vox10 frame {a['ms']:.3f} ms "
            f"(bound {a['bound_ms']:.4f}, F.conv3d {a['library_ms']:.3f}), "
            f"max abs err {a['max_abs_err']:.3g}, worst err/|ref| "
            f"{a['max_rel_err']:.3g} (16^3 on the same frame: "
            f"{errs16[dtype]['max_abs_err']:.3g}, "
            f"{errs16[dtype]['worst_rel_err']:.3g}); "
            f"frame enc {f['enc_s']:.4f} + dec {f['dec_s']:.4f} s, peak "
            f"{f['peak_bytes'] / 2**30:.2f} GiB; train step median "
            f"{st['step_ms_median']:.2f} ms, peak "
            f"{st['peak_bytes'] / 2**30:.2f} GiB  [{card}]")
    log(f"phase 9's child: {res['child_s']:.1f} s")
    return res


def bs8_kernel_entries(bs8: dict) -> dict:
    """The kernels line's `bs8` blocks, by kernel name: conv3 from 9a (per
    vox10 frame), conv3_dgrad and conv3_wgrad from 9d (per training
    step), f32 with bf16 beside it."""
    keys = ("launches", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "max_abs_err", "max_rel_err")

    def fwd(dtype):
        return {k: bs8["9a"][dtype][k] for k in keys}

    out = {"conv3": {**fwd("float32"), "dtype": "float32",
                     "bfloat16": fwd("bfloat16"), "per": "vox10 frame",
                     "train_step_launches": bs8["9d"]["steps"]["float32"][
                         "launches"]["fwd"]}}
    for e in train_kernel_entries(bs8["9d"]):
        out[e["name"]] = {**{k: e[k] for k in keys + ("bound_cuda_cores_ms",)
                             if k in e}, "dtype": "float32",
                          "bfloat16": {k: e["bfloat16"][k] for k in keys},
                          "per": "training step"}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--phases", default="1,2,3,4,5,6,7,8,9")
    p.add_argument("--bs8-child", metavar="OUT", default=None,
                   help=argparse.SUPPRESS)  # phase 9's child (internal)
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
    OUT_DIR.mkdir(exist_ok=True)
    if not args.bs8_child:  # phase 9's child appends to the parent's log
        (OUT_DIR / "chip_smoke.log").write_text("")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as ex:  # one compiler per source, together
        builds = [ex.submit(K.build, True), ex.submit(native.build)]
        for f in builds:
            log(f"built {f.result()}")
    log(f"build: {time.perf_counter() - t0:.1f} s")
    # each conv3_tc.cu instance holds the products its plan names; the
    # scan runs beside the phases and is read before the kernels line
    sass_pool = ThreadPoolExecutor(1)
    sass_check = (None if args.bs8_child else
                  sass_pool.submit(check_tc_sass, builds[0].result()))

    log("== phase 1: card ==")
    card = card_identity()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda}  "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}  "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    if args.bs8_child:
        with tempfile.TemporaryDirectory() as workdir:
            run_bs8_child(device, workdir, card, args.bs8_child)
        return 0

    report = {"card": card, "phase_s": {}}
    with tempfile.TemporaryDirectory() as workdir:
        for n, key, run in (
                (2, "conv3_shapes", lambda: phase_kernels(device)),
                (3, "golden", lambda: phase_golden(device, workdir)),
                (4, "vox10", lambda: phase_vox10(device, workdir, card)),
                (5, "profile", lambda: phase_profile(device, workdir)),
                (6, "streamed", lambda: phase_streamed(device, workdir,
                                                       card)),
                (7, "train", lambda: phase_train(device, workdir, card)),
                (8, "parallel", lambda: phase_parallel(device, workdir,
                                                       card)),
                (9, "bs8", lambda: phase_bs8(device, workdir, card))):
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
            "kernel_route": f"tc (conv3_tc.cu, {F32_ROUTE})",
            "bfloat16": {
                **entry("bfloat16"),
                "source": "pcgcv2_torch/csrc/conv3_tc.cu",
                "kernel_route": f"tc (conv3_tc.cu, {BF16_ROUTE})",
            },
            "library": "F.conv3d on the assembled halo (dense part only)",
            "train_step_launches": report.get("train", {}).get(
                "steps", {}).get("float32", {}).get("launches", {}).get(
                    "fwd"),
        })
    if "train" in report:
        kernels += train_kernel_entries(report["train"])
        # mode="scan": the launches one captured step holds (7d), replayed
        # graph_replays times there
        scan = report["train"]["scanned"]
        for k in kernels:
            i = {"conv3": 0, "conv3_dgrad": 2, "conv3_wgrad": 4}[k["name"]]
            k["scan_step"] = {
                dt: {"captured_launches": scan[dt]["captured"][i],
                     "graph_replays": scan[dt]["graph_replays"]}
                for dt in ("float32", "bfloat16")}
    if "parallel" in report:
        launches = parallel_launches(report["parallel"])
        for k in kernels:
            k["parallel_launches"] = launches[k["name"]]
    if "bs8" in report:  # the 8^3 numbers beside each kernel's 16^3 ones
        bs8 = bs8_kernel_entries(report["bs8"])
        for k in kernels:
            k["bs8"] = bs8[k["name"]]
    if sass_check is not None:
        sass_check.result()  # raises where an instance is not its plan's
    sass_pool.shutdown()
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
