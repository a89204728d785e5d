"""Where the f32 instances of the mma.sync conv3_tc.cu (the one that read
its weight fragments from L2 in every warp) spend their time, on the card.

    python3 tests/torch_conv3_f32_diagnosis.py OLD_CSRC

OLD_CSRC is the csrc/ directory of a checkout whose conv3_tc.cu has
`tile_f32` reading B with one __ldg per lane and n tile (for example one
unpacked with `git archive <commit> pcgcv2_torch/csrc | tar -x -C DIR`).
Five libraries are built from its conv3_tc.cu, the source changed in
memory only: as it is; with every B read hitting one fixed 16-byte word
per lane (the weight stream gone); with the MMAs also replaced by a cheap
register sum that keeps the A loads and splits alive; as it is but with
the A fragments passed to the MMAs unsplit (hi = lo = x: the split's
cost); and with the warp tiles' arithmetic skipped altogether (staging,
masks and the epilogue alone).  Each runs the 16^3 f32 pairs 16->4 at 5632
rows, 64->16 and 64->64 at 512 (chip_smoke.py's random grids, about 77% of
rows live at 5% occupancy), timed as the median of 10 launches, beside
this tree's kernel at the same shapes.  The differences split the old time
into weights, MMAs and the rest, and the rest into the split and the
floor.  Prints one JSON line.  Not collected by pytest: it needs the
card.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SHAPES = ((5632, 16, 4), (512, 64, 16), (512, 64, 64))
B_READ = "b[nt] = __ldg(wl + ((size_t)(tap * C::KC + kc) * C::NT + nt) * 32);"
SPLIT = "split_tf32(a, hi[r], lo[r]);"
NO_SPLIT = "for (int e = 0; e < 4; ++e) hi[r][e] = lo[r][e] = a[e];"
TILE = "tile_f32<C>(acc, ring0, j, y0, wpack, lane);"
FAKE_MMA = """
__device__ __forceinline__ void fake_mma(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  d[0] += __uint_as_float((a[0] ^ a[1] ^ a[2] ^ a[3] ^ b0 ^ b1) &
                          0x3f800000u);
}
"""


def variants(src: str) -> dict:
    """The old source as it is, with fixed B reads, and with fake MMAs."""
    i = src.index("__device__ __forceinline__ void tile_f32(")
    j = src.index("__device__ __forceinline__ void conv3_tc(")
    assert B_READ in src[i:j], "OLD_CSRC's tile_f32 is not the L2-read one"
    fixed = src[:i] + src[i:j].replace(B_READ, "b[nt] = __ldg(wl);") + src[j:]
    j = fixed.index("__device__ __forceinline__ void conv3_tc(")
    k = fixed.index("template <typename C>\n__device__ __forceinline__ "
                    "void tile_f32(")
    body = fixed[k:j].replace("mma_tf32(", "fake_mma(")
    nomma = fixed[:k] + FAKE_MMA + body + fixed[j:]
    assert SPLIT in src and TILE in src
    nosplit = src[:i] + src[i:j].replace(SPLIT, NO_SPLIT) + src[j:]
    notile = src.replace(TILE, ";")
    return {"as_is": src, "fixed_b": fixed, "no_mma": nomma,
            "no_split": nosplit, "no_tile": notile}


def build(name: str, text: str, tmp: Path) -> ctypes.CDLL:
    from pcgcv2_torch.ops import conv3 as K

    d = tmp / name
    d.mkdir()
    (d / "conv3_tc.cu").write_text(text)
    pairs = " ".join(f"X({ci}, {co})" for _, ci, co in SHAPES)
    (d / "unit.cu").write_text(f"#define PCGC_BS 16\n#define PCGC_PAIRS(X) "
                               f'{pairs}\n#include "conv3_tc.cu"\n')
    so = d / "lib.so"
    subprocess.run([K._nvcc(), *K._NVCC_FLAGS, "-shared", "-o", str(so),
                    str(d / "unit.cu")], check=True)
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.pcgc_conv3_tc_bs16.restype = ci
    lib.pcgc_conv3_tc_bs16.argtypes = [vp] * 8 + [ci] * 4 + [vp]
    return lib


def old_plan(ci: int) -> tuple:
    """(XP, ROWS, SMEM) of the old f32 16^3 instance: a ring of 4 planes."""
    cip = max(ci, 8)
    rs = cip + (4 if (cip * 4 // 16) % 2 == 0 else 0)
    ys = 2 if 4 * 18 * 18 * rs * 4 > 232448 - 256 else 1
    rows = 16 // ys
    return 4, rows, 4 * (rows + 2) * 18 * rs * 4


def main(argv) -> int:
    import torch

    import chip_smoke as CS
    from pcgcv2_torch.ops import blocks as B
    from pcgcv2_torch.ops import conv3 as K

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    assert B.BS == 16, "times the 16^3 instances"
    dev = torch.device("cuda", 0)
    src = (Path(argv[1]) / "conv3_tc.cu").read_text()
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        texts = variants(src)
        libs = {n: build(n, t, Path(tmp)) for n, t in texts.items()}
        gen = torch.Generator(device=dev).manual_seed(0)
        for nb_cap, ci, co in SHAPES:
            base = CS.random_grid(nb_cap, 64, seed=nb_cap, device=dev)
            nbrs = B.neighbor_rows(base)
            bg = base.replace(feats=base.feats[:, :, :ci].contiguous())
            w = torch.randn(3, 3, 3, ci, co, device=dev, generator=gen)
            b = torch.randn(co, device=dev, generator=gen)
            # the old fragment-order pack has the new one's size; its
            # values do not change the timing
            old_packed = torch.randn(27 * max(ci, 8) * max(co, 8) * 2,
                                     device=dev, generator=gen)
            out = torch.empty(nb_cap, B.VOL, co, device=dev)
            plan = (ctypes.c_int * 3)(*old_plan(ci))
            stream = torch.cuda.current_stream().cuda_stream
            row = {"nb_cap": nb_cap, "live_rows": int(base.count), "ci": ci,
                   "co": co}
            for name, lib in libs.items():
                def run(lib=lib):
                    rc = lib.pcgc_conv3_tc_bs16(
                        bg.feats.data_ptr(), nbrs.data_ptr(),
                        bg.mask.data_ptr(), bg.count.data_ptr(),
                        old_packed.data_ptr(), b.data_ptr(), out.data_ptr(),
                        ctypes.addressof(plan), nb_cap, ci, co, 0, stream)
                    assert rc == 0, rc
                row[name + "_ms"] = CS.cuda_ms(run, 10)
            packed = K.pack_weight(w)
            row["this_tree_ms"] = CS.cuda_ms(
                lambda: K.conv3(bg, nbrs, w, b, torch.float32,
                                packed=packed), 10)
            row["weights_ms"] = row["as_is_ms"] - row["fixed_b_ms"]
            row["mma_ms"] = row["fixed_b_ms"] - row["no_mma_ms"]
            row["rest_ms"] = row["no_mma_ms"]
            row["split_ms"] = row["as_is_ms"] - row["no_split_ms"]
            row["floor_ms"] = row["no_tile_ms"]
            rows.append(row)
    print(json.dumps({"shapes": rows, "card": CS.card_identity()}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
