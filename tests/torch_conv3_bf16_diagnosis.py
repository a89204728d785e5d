"""Where the bf16 instances of the mma.sync conv3_tc.cu (the one that read
its weight fragments from L2 in every warp) spend their time, on the card.

    python3 tests/torch_conv3_bf16_diagnosis.py OLD_CSRC

OLD_CSRC is the csrc/ directory of a checkout whose conv3_tc.cu has
`tile_bf16` reading B with one __ldg per lane, k chunk and n tile (for
example one unpacked with `git archive <commit> pcgcv2_torch/csrc | tar -x
-C DIR`).  Four libraries are built from its conv3_tc.cu, both block
sides each, the source changed in memory only: as it is; with every B
read hitting one fixed word per lane (the weight stream gone); with the
MMAs also replaced by a cheap register sum that keeps the A loads alive;
and with the warp tiles' arithmetic skipped altogether (staging, masks
and the epilogue alone).  Each runs the bf16 pairs 16->4 at 5632 rows,
64->16 and 64->64 at 512 (16^3 blocks), and 64->64 and 16->16 at 4096
rows of 8^3 blocks (chip_smoke.py's random grids, about 77% of rows live
at 5% occupancy), timed as the median of 10 launches, beside this tree's
kernel at the same shapes.  The differences split the old time into
weights, MMAs and the rest (whose floor is the last variant).  The 8^3
side runs in a child process (PCGC_BLOCK_SIZE=8, read at import).  Prints
one JSON line.  Not collected by pytest: it needs the card.

    python3 tests/torch_conv3_bf16_diagnosis.py --wgmma-min-n

times this tree's bf16 instances with ci >= 16 and co >= 16 under each
threshold of `MIN_N` (the WG_MIN_N_BF16 of conv3_tc.cu, changed in memory:
at 128 no bf16 instance runs wgmma) at phase 2's vox10 shapes and at 4096
rows of 8^3 blocks, each the median of 10 launches, in one process per
side; the threshold that gives the least time per shape is the one to
ship (`ops/conv3.py::TC_WGMMA_MIN_N`).

    python3 tests/torch_conv3_bf16_diagnosis.py --whole-without-producer

times this tree's bf16 instances whose weights sit in shared memory
whole (the narrow pairs of phase 2 and 9a) as they are and with the
producer warp left out of those instances (thread 0 issues the one bulk
copy; the source changed in memory only), each the median of 10
launches, and checks that both give the same bits: what the producer
warp costs in CTAs per SM where threads bound the residency.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SHAPES = {16: ((5632, 16, 4), (512, 64, 16), (512, 64, 64)),
          8: ((4096, 64, 64), (4096, 16, 16))}
# --wgmma-min-n: the thresholds, and the shapes (phase 2's vox10 shapes
# with ci, co >= 16 at 16^3; the model's such pairs at 8^3)
MIN_N = (16, 32, 64, 128)
MIN_N_SHAPES = {16: ((5632, 16, 16), (1536, 32, 32), (512, 64, 16),
                     (512, 16, 32), (512, 16, 16), (512, 64, 64)),
                8: ((4096, 16, 16), (4096, 32, 32), (4096, 64, 16),
                    (4096, 16, 32), (4096, 64, 64))}
MIN_N_LINE = "constexpr int WG_MIN_N_BF16 = "
# --whole-without-producer: narrow pairs at the caps of phase 2 (16^3) and
# 9a (8^3), whose bf16 weights sit in shared memory whole
WHOLE_SHAPES = {16: ((5632, 1, 16), (5632, 4, 4), (5632, 4, 8),
                     (5632, 16, 4), (1536, 8, 8)),
                8: ((20992, 1, 16), (20992, 4, 4), (20992, 16, 4),
                    (5632, 8, 8))}
# the source edits that leave the producer warp out of whole instances
NO_PRODUCER = (
    ("  static constexpr int TOT = XP / PS * NSTEP;  // steps of a CTA\n",
     "  static constexpr int TOT = XP / PS * NSTEP;  // steps of a CTA\n"
     "  static constexpr int LAUNCH = WHOLE ? THREADS : CTA;\n"),
    ("k += C::CTA)", "k += C::LAUNCH)"),
    ("kern<<<grid, C::CTA, C::SMEM, stream>>>",
     "kern<<<grid, C::LAUNCH, C::SMEM, stream>>>"),
    ("CI, CO, BS>::CTA", "CI, CO, BS>::LAUNCH"),
    ("    mbar_fence_init();\n",
     "    mbar_fence_init();\n    if constexpr (C::WHOLE) {\n"
     "      mbar_expect_tx(wt.full, C::WB);\n"
     "      tma_load(wt.w, wpack, C::WB, wt.full);\n    }\n"))
B_READ = "const uint32_t* w = wt + (kc * C::NT + nt) * 32 * C::FRAG;"
FIXED_B = "const uint32_t* w = wpack + lane * C::FRAG;"
TILE = "tile_bf16<C>(acc, ring0, j, y0, wpack, lane);"
FAKE_MMA = """
template <int KS>
__device__ __forceinline__ void fake_mma(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  const uint32_t x = KS == 16 ? a[0] ^ a[1] ^ a[2] ^ a[3] : a[0] ^ a[1];
  d[0] += __uint_as_float((x ^ b0 ^ b1) & 0x3f800000u);
}
"""


def variants(src: str) -> dict:
    """The old source as it is, with fixed B reads, with fake MMAs, and
    without the tile arithmetic."""
    i = src.index("template <typename C>\n__device__ __forceinline__ void "
                  "tile_bf16(")
    j = src.index("__device__ __forceinline__ void conv3_tc(")
    assert B_READ in src[i:j], "OLD_CSRC's tile_bf16 is not the L2-read one"
    assert TILE in src
    fixed = src[:i] + src[i:j].replace(B_READ, FIXED_B) + src[j:]
    j = fixed.index("__device__ __forceinline__ void conv3_tc(")
    body = fixed[i:j].replace("mma_bf16<C::KS>(", "fake_mma<C::KS>(")
    nomma = fixed[:i] + FAKE_MMA + body + fixed[j:]
    return {"as_is": src, "fixed_b": fixed, "no_mma": nomma,
            "no_tile": src.replace(TILE, ";")}


def min_n_variants(src: str) -> dict:
    """This tree's source under each bf16 wgmma threshold of MIN_N."""
    i = src.index(MIN_N_LINE)
    j = src.index(";", i)
    return {f"min_n_{n}": src[:i] + MIN_N_LINE + str(n) + src[j:]
            for n in MIN_N}


def producer_variants(src: str) -> dict:
    """This tree's source as it is, and without the producer warp in
    whole instances."""
    out = src
    for old, new in NO_PRODUCER:
        assert old in out, old
        out = out.replace(old, new)
    return {"as_is": src, "no_producer": out}


def build(texts: dict, tmp: Path, shapes_by_side: dict = SHAPES) -> dict:
    """One library per variant, both block sides: every unit compiled by
    its own nvcc, all together, then linked."""
    from pcgcv2_torch.ops import conv3 as K

    jobs = []
    for name, text in texts.items():
        d = tmp / name
        d.mkdir()
        (d / "conv3_tc.cu").write_text(text)
        for bs, shapes in shapes_by_side.items():
            pairs = " ".join(f"X({ci}, {co})" for _, ci, co in shapes)
            unit = d / f"unit_bs{bs}.cu"
            unit.write_text(f"#define PCGC_BS {bs}\n#define PCGC_PAIRS(X) "
                            f'{pairs}\n#include "conv3_tc.cu"\n')
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


def old_plan(ci: int, bs: int) -> tuple:
    """(XP, ROWS, SMEM, 1, 0) of the old bf16 instance: a ring of 4
    planes, one output plane at a time."""
    cip = max(ci, 8)
    rs = cip + (8 if (cip * 2 // 16) % 2 == 0 else 0)
    ys = 2 if 4 * (bs + 2) ** 2 * rs * 2 > 232448 - 256 else 1
    rows = bs // ys
    return 4 if bs == 16 else 8, rows, 4 * (rows + 2) * (bs + 2) * rs * 2, 1, 0


# the modes: the old kernel's split, the wgmma threshold, the producer
# warp of whole instances; each mode's variants, and its shapes by side
MODES = {"old": SHAPES, "min_n": MIN_N_SHAPES, "whole": WHOLE_SHAPES}


def side(libs: dict, mode: str = "old") -> list:
    """Every shape of this process's block side, each variant timed: the
    old kernel's variants on its own pack and plan ("old"), or this
    tree's variants on this tree's ("min_n", "whole"; "whole" also checks
    that every variant gives the first one's bits)."""
    import torch

    import chip_smoke as CS
    from pcgcv2_torch.ops import blocks as B
    from pcgcv2_torch.ops import conv3 as K

    dev = torch.device("cuda", 0)
    cd = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    fns = {}
    for name, so in libs.items():
        lib = ctypes.CDLL(so)
        fn = getattr(lib, f"pcgc_conv3_tc_bs{B.BS}")
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fns[name] = fn
    rows = []
    for nb_cap, ci, co in MODES[mode][B.BS]:
        base = CS.random_grid(nb_cap, 64, seed=nb_cap, device=dev)
        nbrs = B.neighbor_rows(base)
        bg = base.replace(feats=base.feats[:, :, :ci].to(cd).contiguous())
        w = (0.1 * torch.randn(3, 3, 3, ci, co, device=dev,
                               generator=gen)).to(cd)
        b = torch.randn(co, device=dev, generator=gen).to(cd)
        packed = K.pack_weight(w)
        if mode == "old":
            # the old fragment-order pack has the new one's size; its
            # values do not change the timing
            wpack = (0.1 * torch.randn(K.packed_bytes(ci, co, cd) // 2,
                                       device=dev, generator=gen)).to(cd)
            plan = (ctypes.c_int * 5)(*old_plan(ci, B.BS))
        else:
            wpack = packed
            p = K.tc_plan(ci, co, cd)
            plan = (ctypes.c_int * 5)(p.xp, p.rows, p.smem, p.ps, p.wslots)
        stream = torch.cuda.current_stream().cuda_stream
        row = {"bs": B.BS, "nb_cap": nb_cap, "live_rows": int(base.count),
               "ci": ci, "co": co}
        outs = []
        for name, fn in fns.items():
            out = torch.empty(nb_cap, B.VOL, co, device=dev, dtype=cd)

            def run(fn=fn, out=out):
                rc = fn(bg.feats.data_ptr(), nbrs.data_ptr(),
                        bg.mask.data_ptr(), bg.count.data_ptr(),
                        wpack.data_ptr(), b.data_ptr(), out.data_ptr(),
                        ctypes.addressof(plan), nb_cap, ci, co, 1, stream)
                assert rc == 0, rc
            row[name + "_ms"] = CS.cuda_ms(run, 10)
            outs.append(out)
        if mode != "old":
            p = K.tc_plan(ci, co, cd)
            row["mma"], row["wslots"] = p.mma, p.wslots
            row["best"] = min(libs, key=lambda n: row[n + "_ms"])
            if mode == "whole":
                row["same_bits"] = all(torch.equal(outs[0], o)
                                       for o in outs[1:])
            rows.append(row)
            continue
        row["this_tree_ms"] = CS.cuda_ms(
            lambda: K.conv3(bg, nbrs, w, b, cd, packed=packed), 10)
        row["weights_ms"] = row["as_is_ms"] - row["fixed_b_ms"]
        row["mma_ms"] = row["fixed_b_ms"] - row["no_mma_ms"]
        row["rest_ms"] = row["no_mma_ms"]
        row["floor_ms"] = row["no_tile_ms"]
        for k in ("weights", "mma", "rest", "floor"):
            row[k + "_share"] = row[k + "_ms"] / row["as_is_ms"]
        rows.append(row)
    return rows


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
    mode = {"--wgmma-min-n": "min_n",
            "--whole-without-producer": "whole"}.get(argv[1], "old")
    if mode == "old":
        K.build()  # once, before the child loads it
        texts = variants((Path(argv[1]) / "conv3_tc.cu").read_text())
    else:
        src = (ROOT / "pcgcv2_torch/csrc/conv3_tc.cu").read_text()
        texts = (min_n_variants if mode == "min_n"
                 else producer_variants)(src)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(texts, Path(tmp), MODES[mode])
        rows = side(libs, mode)
        out = Path(tmp) / "bs8.json"
        subprocess.run([sys.executable, __file__, "--child",
                        json.dumps(libs), str(out), mode],
                       check=True, env={**os.environ, "PCGC_BLOCK_SIZE": "8"})
        rows += json.loads(out.read_text())
    print(json.dumps({"shapes": rows, "card": CS.card_identity()}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
