"""Where conv3_wgrad.cu's bf16 instances spend a training step's time, on
the card.

    python3 tests/torch_conv3_wgrad_diagnosis.py OLD_CSRC

OLD_CSRC is the csrc/ directory of a checkout whose conv3_wgrad.cu runs
every instance on the CUDA cores (f32 FMAs over cp.async-staged planes,
f32 x under bf16 compute rounded by a pass over the staged planes), for
example one unpacked with `git archive <commit> pcgcv2_torch/csrc | tar
-x -C DIR`.  Five libraries are built from it, both block sides each (the
full-width model's pairs), the source changed in memory only: as it is;
without the rounding pass; without the FMA loop (and its shared-memory
reads); without staging (no input plane or dy is copied); and with none
of the three (the mask scan, the barriers, the partial sums and the
second kernel alone).  One bf16 training step of chip_smoke.py's phase 7
(8^3 blocks: phase 9d, in a child process with PCGC_BLOCK_SIZE=8) runs
with conv3_wgrad spied on: every weight gradient of the step is launched
on its own inputs by every library and by this tree's kernel, each timed
as CUDA events around 20 back-to-back launches after a warm-up (so the
wrapper's host time is hidden where the device is the slower).  The
differences of the step's sums split the old time into staging, rounding
and the FMA loop; the last variant is the floor.  This tree's launches
are held against conv3_wgrad_plain (within chip_smoke.TRAIN_TOL of max
|ref|).  Prints one JSON line.  Not collected by pytest: it needs the
card.

    python3 tests/torch_conv3_wgrad_diagnosis.py --tree

times variants of this tree's conv3_wgrad.cu (changed in memory) on the
same training step's inputs: as it is; with the bf16 instances of ci
below 8 on mma.sync (channels zero-padded to 8) instead of the CUDA-core
loop (`MMA_MIN_CI`); and with every mma.sync instance compiled for two
CTAs per SM (at most 128 registers a thread), or for one (`MIN_CTAS`).
Every variant's launches must agree with conv3_wgrad_plain.
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
TREE_EDITS = {
    "narrow_mma": ((MIN_CI, MIN_CI.replace("8", "1")),),
    "two_ctas": ((MIN_CTAS, "2;"),),
    "one_cta": ((MIN_CTAS, "1;"),),
}


def tree_variants(src: str) -> dict:
    """This tree's source as it is and under each of TREE_EDITS."""
    out = {"as_is": src}
    for name, edits in TREE_EDITS.items():
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


def side(libs: dict, mode: str) -> list:
    """One bf16 training step of this process's block side with every dW
    timed through each library and this tree's kernel: one row per call."""
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
        stream = torch.cuda.current_stream(dev).cuda_stream
        for name, fn in fns.items():
            if mode == "old":
                p = old_wgrad_plan(ci, co, x.element_size(), 2, B.BS)
                sel = (ctypes.c_int * 3)(*p)
            else:
                p = K.wgrad_plan(ci, co, x.dtype, cd, mma_min_ci=(
                    1 if name == "narrow_mma" else None))
                sel = (ctypes.c_int * 4)(p.ci_tile, p.co_tile, p.g,
                                         int(p.mma))
            part = torch.empty(p.g, 27, ci, co, device=dev)
            out = torch.empty(3, 3, 3, ci, co, device=dev)

            def run(fn=fn, sel=sel, part=part, out=out):
                rc = fn(x.data_ptr(), g.data_ptr(), nb.data_ptr(),
                        mask.data_ptr(), bg.count.data_ptr(),
                        part.data_ptr(), out.data_ptr(),
                        ctypes.addressof(sel), ci, co,
                        int(x.dtype == torch.bfloat16), 1, stream)
                assert rc == 0, (name, rc)
            row[name + "_ms"] = event_ms(run)
            if mode != "old":
                row[name + "_rel_err"] = float(
                    (out - ref).abs().max()
                    / ref.abs().max().clamp_min(1e-30))
        rows.append(row)

    clouds = CS.train_batch()
    with tempfile.TemporaryDirectory() as work:
        tr = CS.make_trainer("bfloat16", work, dev)
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
    if len(argv) == 5 and argv[1] == "--child":  # the 8^3 side
        Path(argv[3]).write_text(json.dumps(
            side(json.loads(argv[2]), argv[4])))
        return 0
    import chip_smoke as CS
    from pcgcv2_torch.ops import blocks as B
    from pcgcv2_torch.ops import conv3 as K

    assert B.BS == 16, "the parent process runs the 16^3 side"
    K.build()  # once, before the child loads it
    mode = "tree" if argv[1] == "--tree" else "old"
    if mode == "old":
        texts = variants((Path(argv[1]) / "conv3_wgrad.cu").read_text())
    else:
        texts = tree_variants(
            (ROOT / "pcgcv2_torch/csrc/conv3_wgrad.cu").read_text())
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(texts, Path(tmp))
        rows = side(libs, mode)
        out = Path(tmp) / "bs8.json"
        subprocess.run([sys.executable, __file__, "--child",
                        json.dumps(libs), str(out), mode],
                       check=True, env={**os.environ, "PCGC_BLOCK_SIZE": "8"})
        rows += json.loads(out.read_text())
    print(json.dumps({"summary": summary(rows, list(texts)), "calls": rows,
                      "card": CS.card_identity()}))
    tol = CS.TRAIN_TOL["dw"]["bfloat16"]
    return 1 if any(v > tol for r in rows for k, v in r.items()
                    if k.endswith("rel_err")) else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
