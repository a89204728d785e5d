"""Where conv3_wgrad.cu spends a training step's time, on the card.

    python3 tests/torch_conv3_wgrad_diagnosis.py OLD_CSRC [--f32]

OLD_CSRC is the csrc/ directory of a checkout whose conv3_wgrad.cu runs
the instances timed on the CUDA cores (f32 FMAs over cp.async-staged
planes, f32 x under bf16 compute rounded by a pass over the staged
planes): every instance before bf16 dW went to mma.sync, the f32-dy ones
before f32 dW did, for example unpacked with `git archive <commit>
pcgcv2_torch/csrc | tar -x -C DIR`.  Five libraries are built from it,
both block sides each (the full-width model's pairs), the source changed
in memory only: as it is; without the rounding pass; without the FMA loop
(and its shared-memory reads); without staging (no input plane or dy is
copied); and with none of the three (the mask scan, the barriers, the
partial sums and the second kernel alone).  One training step of
chip_smoke.py's phase 7 (bf16 compute, or f32 with --f32; 8^3 blocks:
phase 9d, in a child process with PCGC_BLOCK_SIZE=8) runs with
conv3_wgrad spied on: every weight gradient of the step is launched on
its own inputs by every library (with the CUDA-core kernel's plan) and by
this tree's kernel, each timed as CUDA events around 20 back-to-back
launches after a warm-up (so the wrapper's host time is hidden where the
device is the slower).  The differences of the step's sums split the old
time into staging, rounding and the FMA loop; the last variant is the
floor.  This tree's launches are held against conv3_wgrad_plain (within
chip_smoke.TRAIN_TOL of max |ref|).  Prints one JSON line.  Not collected
by pytest: it needs the card.

    python3 tests/torch_conv3_wgrad_diagnosis.py --tree [--f32]

times variants of this tree's conv3_wgrad.cu (changed in memory,
TREE_EDITS) on the same training step's inputs, each launched with its
own plan (TREE_PLANS).  bf16: as it is; with the instances of ci below 8
on mma.sync (channels zero-padded to 8) instead of the CUDA-core loop
(`MMA_MIN_CI`); and with every mma.sync instance compiled for two CTAs per
SM (at most 128 registers a thread), or for one (`MIN_CTAS`).  f32
(3xTF32): as it is; with G from 256 or 128 CTAs a launch (`GRID_CTAS`);
without the products and their operand loads (staging and the floor);
with the co = 8 instances (8 -> 8, 32 -> 8) on mma.sync too
(`MMA_MIN_CO_F32`); and every instance on the CUDA cores (`MMA_MIN_CI`
above every ci), with and without its FMA loop.  Every variant's launches but those of
UNCHECKED must agree with conv3_wgrad_plain; with --f32 each is also held
to the sums in f64 (`wgrad_f64`), its error printed.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

REPS = 20  # back-to-back launches per timing
# the source edits of each variant of the old kernel: (old, new) pairs
ROUND = "if constexpr (C::ROUND) {"
FMA = "for (int k = s; k < n; k += C::KSPLIT) {"
STAGE_X = ("for (int k = t; k < PLANE * CH; k += THREADS) {\n"
           "    const int r = k / CH, c = k % CH;\n    int ny, sy, nz, sz;")
STAGE_DY = "for (int k = t; k < n * CH; k += THREADS) {"
EDITS = {
    "no_round": ((ROUND, "if constexpr (false) {"),),
    "no_fma": ((FMA, "for (int k = s; k < 0; k += C::KSPLIT) {"),),
    "no_stage": ((STAGE_X, STAGE_X.replace("k < PLANE * CH", "k < 0")),
                 (STAGE_DY, STAGE_DY.replace("k < n * CH", "k < 0"))),
}
EDITS["floor"] = EDITS["no_round"] + EDITS["no_fma"] + EDITS["no_stage"]
MIN_CI = "constexpr int MMA_MIN_CI = 8;"


class OldPlan(NamedTuple):
    """(ci tile, co tile, G) of the CUDA-core kernel's `make_plan`, the
    plan every instance of the old conv3_wgrad.cu checks at its launch."""

    ci_tile: int
    co_tile: int
    g: int


def old_wgrad_plan(ci: int, co: int, sx: int, sg: int, bs: int) -> OldPlan:
    """The CUDA-core conv3_wgrad.cu's plan for x and dy elements of sx and
    sg bytes: the widest co tile, then the widest ci tile, with at most 64
    accumulators per thread and a ring of 4 staged planes (y rows padded
    by 16 bytes) and 2 dy planes, or the k-split sums, in 232448 - 9216
    bytes."""
    for cot in (c for c in (64, 32, 16, 8, 4, 2, 1) if c <= co):
        for cit in (c for c in (64, 32, 16, 8, 4, 2, 1) if c <= ci):
            e = 27 * cit * cot
            f = max(1 << (-(-e // 256) - 1).bit_length(), min(16, cit * cot))
            side = 8 if f >= 64 else 4 if f >= 16 else 2 if f >= 4 else 1
            tm = min(cit, side)
            tn = f // tm
            if tn > cot:
                tn, tm = cot, f // cot
            ksplit = 256 // (e // f)
            hs = bs + 2
            smem = max(4 * hs * (hs * cit * sx + 16) + 2 * bs * bs * cot * sg,
                       ksplit * e * 4)
            if tm * tn <= 64 and smem <= 232448 - 9216:
                splits = (ci // cit) * (co // cot)
                return OldPlan(cit, cot, max(8, 512 // splits))
    raise ValueError(f"no plan for {ci} -> {co}")


def variants(src: str) -> dict:
    """The old source as it is and under each of EDITS."""
    out = {"as_is": src}
    for name, edits in EDITS.items():
        text = src
        for old, new in edits:
            assert text.count(old) == 1, (name, old)
            text = text.replace(old, new)
        out[name] = text
    return out


MIN_CTAS = "WHOLE || U * NT * 4 + PREFETCH <= 64 ? 2 : 1;"
MIN_CO_F32 = "constexpr int MMA_MIN_CO_F32 = 16;"
MMA_GATE = "if (ci >= MMA_MIN_CI && (sg == 2 || co >= MMA_MIN_CO_F32)) {"
GRID = "constexpr int GRID_CTAS = 512;"
TF32_CALL = ("        tf32_chunks<C>(acc, idx, kb, ke, xo, ring, dyb, lane, "
             "warp);")
# the variants of this tree's source per compute dtype, and the plan
# arguments each one's launches take (wgrad_plan's keywords, and
# grid_ctas: G from that many CTAs, as GRID_CTAS)
TREE_EDITS = {
    "bfloat16": {
        # bf16 dy from ci = 1 on mma.sync (f32 dy as it is)
        "narrow_mma": ((MMA_GATE, MMA_GATE.replace(
            "ci >= MMA_MIN_CI", "ci >= (sg == 2 ? 1 : MMA_MIN_CI)")),),
        "two_ctas": ((MIN_CTAS, "2;"),),
        "one_cta": ((MIN_CTAS, "1;"),),
    },
    "float32": {
        # G from 256 or 128 CTAs a launch instead of 512 (GRID_CTAS): fewer,
        # longer work items (whole rows or more planes an item)
        "g256": ((GRID, GRID.replace("512", "256")),),
        "g128": ((GRID, GRID.replace("512", "128")),),
        # no products (nor their operand loads): staging and the floor
        "no_products": ((TF32_CALL, "        (void)dyb;"),),
        # the co = 8 instances on mma.sync too (the narrowest co tile the
        # 3xTF32 code takes)
        "co8_mma": ((MIN_CO_F32, MIN_CO_F32.replace("16;", "8;")),),
        # every instance on the CUDA cores (the kernel before f32 dy went
        # to mma.sync), and that without its FMA loop
        "cuda_cores": ((MIN_CI, MIN_CI.replace("8;", "128;")),),
        "cuda_cores_no_fma": (
            (MIN_CI, MIN_CI.replace("8;", "128;")),
            (FMA, "for (int k = s; k < 0; k += C::KSPLIT) {")),
    },
}
TREE_PLANS = {"narrow_mma": {"mma_min_ci": 1}, "co8_mma": {"tf32_min_co": 8},
              "cuda_cores": {"mma_min_ci": 128},
              "cuda_cores_no_fma": {"mma_min_ci": 128},
              "g256": {"grid_ctas": 256}, "g128": {"grid_ctas": 128}}
# variants whose sums are not dW (timed only)
UNCHECKED = ("no_products", "cuda_cores_no_fma")


def tree_variants(src: str, dtype: str) -> dict:
    """This tree's source as it is and under each of TREE_EDITS[dtype]."""
    out = {"as_is": src}
    for name, edits in TREE_EDITS[dtype].items():
        text = src
        for old, new in edits:
            assert text.count(old) == 1, (name, old)
            text = text.replace(old, new)
        out[name] = text
    return out


def build(texts: dict, tmp: Path) -> dict:
    """One library per variant, both block sides, the model's pairs: every
    unit compiled by its own nvcc, all together, then linked."""
    from pcgcv2_torch.ops import conv3 as K

    pairs = " ".join(f"X({ci}, {co})" for ci, co in K.MODEL_PAIRS)
    jobs = []
    for name, text in texts.items():
        d = tmp / name
        d.mkdir()
        (d / "conv3_wgrad.cu").write_text(text)
        for bs in K.BLOCK_SIDES:
            unit = d / f"unit_bs{bs}.cu"
            unit.write_text(f"#define PCGC_BS {bs}\n#define PCGC_PAIRS(X) "
                            f'{pairs}\n#include "conv3_wgrad.cu"\n')
            jobs.append((name, unit, subprocess.Popen(
                [K._nvcc(), *K._NVCC_FLAGS, "-c", "-o",
                 str(unit.with_suffix(".o")), str(unit)])))
    if any(p.wait() != 0 for _, _, p in jobs):
        raise RuntimeError("nvcc failed on a variant")
    out = {}
    for name in texts:
        so = tmp / name / "lib.so"
        subprocess.run([K._nvcc(), "-shared", "-o", str(so),
                        *(str(u.with_suffix(".o")) for n, u, _ in jobs
                          if n == name)], check=True)
        out[name] = str(so)
    return out


def wgrad_f64(bg, dy, nbrs):
    """dW in f64 on the card, [3, 3, 3, ci, co]: conv3_wgrad_plain's sums
    over x and dy as the kernel reads them, each product and sum in f64."""
    import torch

    from pcgcv2_torch.ops import blocks as B
    from pcgcv2_torch.ops import conv3 as K

    n = int(bg.count)
    ci, co = bg.channels, dy.shape[-1]
    g = torch.where(K._live(bg)[:n, :, None], dy[:n], 0).double()
    g = g.reshape(n * B.VOL, co)
    h = K.halo(bg.feats, nbrs[:n]).double()
    out = torch.empty(3, 3, 3, ci, co, dtype=torch.float64, device=g.device)
    for dx in range(3):
        for dy_ in range(3):
            for dz in range(3):
                win = h[:, dx:dx + B.BS, dy_:dy_ + B.BS, dz:dz + B.BS]
                out[dx, dy_, dz] = win.reshape(-1, ci).T @ g
    return out


def f64_err(dw, ref) -> float:
    """max |dw - ref| over max |ref|, ref the f64 sums."""
    return float((dw.double() - ref).abs().max()
                 / ref.abs().max().clamp_min(1e-300))


def event_ms(fn, reps: int = REPS) -> float:
    """Device ms per call of `fn`: CUDA events around `reps` back-to-back
    calls, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps


@contextlib.contextmanager
def spy_wgrad(fn):
    """While open, every conv3_wgrad call of Conv3Fn.backward also calls
    fn(real, bg, dy, nbrs, cd, dw) on its own inputs, launches uncounted
    (`real` is the wrapper itself: a timing through K.conv3_wgrad would
    call the spy again)."""
    import functools

    from pcgcv2_torch.ops import conv3 as K

    real = K.conv3_wgrad

    @functools.wraps(real)  # copies the launch count, which real bumps
    def spy(bg, dy, nbrs, compute_dtype=None):
        dw = real(bg, dy, nbrs, compute_dtype)
        n = spy.launches
        fn(real, bg, dy, nbrs, compute_dtype, dw)
        spy.launches = n
        return dw

    K.conv3_wgrad = spy
    try:
        yield
    finally:
        K.conv3_wgrad = real
        real.launches = spy.launches


def side(libs: dict, mode: str, dtype: str) -> list:
    """One training step in `dtype` compute of this process's block side
    with every dW timed through each library and this tree's kernel: one
    row per call."""
    import torch

    import chip_smoke as CS
    from pcgcv2_torch.ops import blocks as B
    from pcgcv2_torch.ops import conv3 as K

    dev = torch.device("cuda", 0)
    fns = {}
    for name, so in libs.items():
        fn = getattr(ctypes.CDLL(so), f"pcgc_conv3_wgrad_bs{B.BS}")
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fns[name] = fn
    rows = []

    def per_call(real, bg, dy, nbrs, cd, dw):
        ci, co = bg.channels, dy.shape[-1]
        x, g, nb, mask = K._wgrad_inputs(bg, dy, nbrs, cd)
        live = bg.mask & bg.valid[:, None]
        row = {"bs": B.BS, "nb_cap": bg.nb_cap, "stride": bg.stride,
               "live_rows": int(bg.count),
               "occupancy": float(live.sum()) / (int(bg.count) * B.VOL),
               "ci": ci, "co": co,
               "this_tree_ms": event_ms(lambda: real(bg, dy, nbrs, cd))}
        ref = K.conv3_wgrad_plain(bg, dy, nbrs, cd)
        row["rel_err"] = float((dw - ref).abs().max()
                               / ref.abs().max().clamp_min(1e-30))
        f64 = wgrad_f64(bg, g, nbrs) if cd == torch.float32 else None
        if f64 is not None:
            row["f64_err"] = f64_err(dw, f64)
        stream = torch.cuda.current_stream(dev).cuda_stream
        for name, fn in fns.items():
            if mode == "old":  # the CUDA-core plan, mma 0
                p = old_wgrad_plan(ci, co, x.element_size(),
                                   g.element_size(), B.BS)
                sel = (ctypes.c_int * 4)(*p, 0)
            else:
                kw = dict(TREE_PLANS.get(name, {}))
                ctas = kw.pop("grid_ctas", None)
                p = K.wgrad_plan(ci, co, x.dtype, cd, **kw)
                if ctas:  # a build with another GRID_CTAS
                    p = p._replace(g=max(8, ctas // p.splits))
                sel = (ctypes.c_int * 4)(p.ci_tile, p.co_tile, p.g,
                                         int(p.mma))
            part = torch.empty(p.g, 27, ci, co, device=dev)
            out = torch.empty(3, 3, 3, ci, co, device=dev)

            def run(fn=fn, sel=sel, part=part, out=out):
                rc = fn(x.data_ptr(), g.data_ptr(), nb.data_ptr(),
                        mask.data_ptr(), bg.count.data_ptr(),
                        part.data_ptr(), out.data_ptr(),
                        ctypes.addressof(sel), ci, co,
                        int(x.dtype == torch.bfloat16),
                        int(cd == torch.bfloat16), stream)
                assert rc == 0, (name, rc)
            row[name + "_ms"] = event_ms(run)
            if mode != "old" and name not in UNCHECKED:
                row[name + "_rel_err"] = float(
                    (out - ref).abs().max()
                    / ref.abs().max().clamp_min(1e-30))
            if f64 is not None and name not in UNCHECKED and (
                    mode != "old" or name == "as_is"):
                row[name + "_f64_err"] = f64_err(out, f64)
        rows.append(row)

    clouds = CS.train_batch()
    with tempfile.TemporaryDirectory() as work:
        tr = CS.make_trainer(dtype, work, dev)
        coords, valid = tr._collate(clouds)
        with spy_wgrad(per_call):
            tr.step(coords, valid)
        torch.cuda.synchronize()
    return rows


def summary(rows: list, names: list) -> dict:
    """The step's sums per library, and the old kernel's split."""
    out = {}
    for bs in sorted({r["bs"] for r in rows}, reverse=True):
        rs = [r for r in rows if r["bs"] == bs]
        s = {k: sum(r[k + "_ms"] for r in rs) for k in names + ["this_tree"]}
        s["calls"] = len(rs)
        s["worst_rel_err"] = max(r["rel_err"] for r in rs)
        for k in sorted({k for r in rs for k in r if k.endswith("f64_err")}):
            s["worst_" + k] = max(r.get(k, 0.0) for r in rs)
        if "no_stage" in names:
            s["staging_ms"] = s["as_is"] - s["no_stage"]
            s["rounding_ms"] = s["as_is"] - s["no_round"]
            s["fma_loop_ms"] = s["as_is"] - s["no_fma"]
            s["floor_ms"] = s["floor"]
        out[f"bs{bs}"] = s
    return out


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    if len(argv) == 6 and argv[1] == "--child":  # the 8^3 side
        Path(argv[3]).write_text(json.dumps(
            side(json.loads(argv[2]), argv[4], argv[5])))
        return 0
    import chip_smoke as CS
    from pcgcv2_torch.ops import blocks as B
    from pcgcv2_torch.ops import conv3 as K

    assert B.BS == 16, "the parent process runs the 16^3 side"
    dtype = "float32" if "--f32" in argv else "bfloat16"
    args = [a for a in argv[1:] if a != "--f32"]
    K.build()  # once, before the child loads it
    mode = "tree" if args[0] == "--tree" else "old"
    if mode == "old":
        texts = variants((Path(args[0]) / "conv3_wgrad.cu").read_text())
    else:
        texts = tree_variants(
            (ROOT / "pcgcv2_torch/csrc/conv3_wgrad.cu").read_text(), dtype)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(texts, Path(tmp))
        rows = side(libs, mode, dtype)
        out = Path(tmp) / "bs8.json"
        subprocess.run([sys.executable, __file__, "--child",
                        json.dumps(libs), str(out), mode, dtype],
                       check=True, env={**os.environ, "PCGC_BLOCK_SIZE": "8"})
        rows += json.loads(out.read_text())
    print(json.dumps({"dtype": dtype,
                      "summary": summary(rows, list(texts)), "calls": rows,
                      "card": CS.card_identity()}))
    tol = CS.TRAIN_TOL["dw"][dtype]
    return 1 if any(v > tol for r in rows for k, v in r.items()
                    if k.endswith("rel_err")) else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
