"""conv3_tc.cu and conv3_wgrad.cu against an earlier version of the same
sources on the card, at both block sides.

    python3 tests/torch_kernel_bits_witness.py OLD_CSRC

OLD_CSRC is the csrc/ directory of an earlier checkout whose conv3_tc.cu
and conv3_wgrad.cu have the per-side entry points pcgc_conv3_tc_bs16 /
_bs8 and pcgc_conv3_wgrad_bs16 / _bs8, and whose conv3_tc.cu instances
take this tree's packs and plans in both dtypes (the first commit with
bf16 weights staged by TMA, or a later one), unpacked with `git archive
<commit> pcgcv2_torch/csrc | tar -x -C DIR`.  The earlier library is
built here with nvcc from this tree's translation units
(`ops/conv3.py::units`, the same instances) over OLD_CSRC's sources; every
(ci, co) of the full-width model, and at 16^3 three more, runs in both
compute dtypes on random grids of 512 and 1536 blocks (8^3: 4096 and
12288, the same volume), forward and weight gradient:

* every forward, f32 and bf16, and every f32 weight gradient must have
  the bits of the earlier library's launch on the same inputs;
* every bf16 weight gradient (bf16 dy, f32 x: the training step's), which
  this tree sums on mma.sync and a library from before it on the CUDA
  cores (the earlier library launched with its own plan,
  tests/torch_conv3_wgrad_diagnosis.py::old_wgrad_plan), in other orders,
  must be within DW_BF16_TOL of max |old| of the earlier launch and of
  max |ref| of conv3_wgrad_plain in bf16, and a second launch must give
  the same bits.

The 8^3 side runs in a child process (PCGC_BLOCK_SIZE=8, read at import).
Prints one JSON line and exits non-zero on a difference.  Not collected by
pytest: it needs the card.
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
sys.path.insert(0, str(ROOT / "tests"))

from torch_conv3_wgrad_diagnosis import old_wgrad_plan  # noqa: E402

EXTRA_PAIRS = {16: ((64, 32), (1, 64), (4, 16)), 8: ()}
# a bf16 dW (f32 sums of exact bf16 products, on mma.sync here and on the
# CUDA cores in a library from before it, in other orders) against the
# earlier launch and against conv3_wgrad_plain, over max |old| or max
# |ref|: chip_smoke.TRAIN_TOL's dW tolerance, far inside 2^-7
DW_BF16_TOL = 1e-4


def old_library(csrc: Path, out: Path) -> Path:
    """OLD_CSRC's conv3_tc.cu and conv3_wgrad.cu, both block sides, built
    from this tree's units as one library."""
    from pcgcv2_torch.ops import conv3 as K

    srcs = []
    for name, text in K.units():
        if name == "conv3":  # conv3.cu is not compared
            continue
        src = out / f"{name}.cu"
        src.write_text(text)
        srcs.append(src)
    procs = [subprocess.Popen([K._nvcc(), *K._NVCC_FLAGS, "-I", str(csrc),
                               "-c", "-o", str(s.with_suffix(".o")), str(s)])
             for s in srcs]
    if any(p.wait() != 0 for p in procs):
        raise RuntimeError("nvcc failed on the earlier sources")
    so = out / "libold.so"
    subprocess.run([K._nvcc(), "-shared", "-o", str(so),
                    *(str(s.with_suffix(".o")) for s in srcs)], check=True)
    return so


def load(so: Path) -> ctypes.CDLL:
    from pcgcv2_torch.ops import conv3 as K

    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for bs in K.BLOCK_SIDES:
        for fn in (f"pcgc_conv3_tc_bs{bs}", f"pcgc_conv3_wgrad_bs{bs}"):
            getattr(lib, fn).restype = ci
            getattr(lib, fn).argtypes = [vp] * 8 + [ci] * 4 + [vp]
    return lib


def side(old: ctypes.CDLL) -> dict:
    """Every pair of this process's block side, both dtypes, forward and
    dW, against the earlier library."""
    import torch

    import chip_smoke as CS
    from pcgcv2_torch.ops import blocks as B
    from pcgcv2_torch.ops import conv3 as K

    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream().cuda_stream
    tc_old = getattr(old, f"pcgc_conv3_tc_bs{B.BS}")
    wgrad_old = getattr(old, f"pcgc_conv3_wgrad_bs{B.BS}")
    gen = torch.Generator(device=dev).manual_seed(0)
    res = {"bs": B.BS, "fwd": 0, "fwd_same": 0, "dw": 0, "dw_same": 0,
           "bf16_dw": 0, "bf16_dw_within": 0, "bf16_dw_repeat_same": 0,
           "bf16_dw_worst_old_rel": 0.0, "bf16_dw_worst_ref_rel": 0.0,
           "differ": []}
    scale = (16 // B.BS) ** 3  # the same volume at either side
    pairs = tuple(p for p in K.MODEL_PAIRS + EXTRA_PAIRS[B.BS]
                  if K.route(*p, torch.float32) == "tc")
    for nb_cap in (512 * scale, 1536 * scale):
        base = CS.random_grid(nb_cap, 64, seed=nb_cap, device=dev)
        nbrs = B.neighbor_rows(base)
        mask16 = K._aligned(base.mask, 16)
        for ci, co in pairs:
            for cd in (torch.float32, torch.bfloat16):
                bf16 = int(cd == torch.bfloat16)
                x32 = base.feats[:, :, :ci].contiguous()
                bg = base.replace(feats=x32.to(cd))
                w = (0.1 * torch.randn(3, 3, 3, ci, co, device=dev,
                                       generator=gen)).to(cd)
                b = torch.randn(co, device=dev, generator=gen).to(cd)
                packed = K.pack_weight(w)
                new = K.conv3(bg, nbrs, w, b, cd, packed=packed).feats
                p = K.tc_plan(ci, co, cd)
                ref = torch.empty_like(new)
                sel = (ctypes.c_int * 5)(p.xp, p.rows, p.smem, p.ps,
                                         p.wslots)
                rc = tc_old(bg.feats.data_ptr(), nbrs.data_ptr(),
                            bg.mask.data_ptr(), bg.count.data_ptr(),
                            packed.data_ptr(), b.data_ptr(),
                            ref.data_ptr(), ctypes.addressof(sel),
                            nb_cap, ci, co, bf16, stream)
                torch.cuda.synchronize()
                res["fwd"] += 1
                if rc == 0 and torch.equal(new, ref):
                    res["fwd_same"] += 1
                else:
                    res["differ"].append(("conv3", str(cd), nb_cap, ci, co,
                                          rc))
                dy = torch.randn(nb_cap, B.VOL, co, device=dev,
                                 generator=gen)
                dy = torch.where((bg.mask & bg.valid[:, None])[:, :, None],
                                 dy, 0).to(cd)
                g32 = bg.replace(feats=x32)
                dw = K.conv3_wgrad(g32, dy, nbrs, cd)
                # the earlier library's plan: its own (CUDA cores) for bf16
                # dy, this tree's (the same code) for f32
                p = old_wgrad_plan(ci, co, 4, 2 if bf16 else 4, B.BS)
                part = torch.empty(p.g, 27, ci, co, device=dev)
                ref = torch.empty_like(dw)
                sel = (ctypes.c_int * 3)(p.ci_tile, p.co_tile, p.g)
                rc = wgrad_old(x32.data_ptr(), dy.data_ptr(),
                               nbrs.data_ptr(), mask16.data_ptr(),
                               bg.count.data_ptr(), part.data_ptr(),
                               ref.data_ptr(), ctypes.addressof(sel), ci,
                               co, 0, bf16, stream)
                torch.cuda.synchronize()
                if not bf16:
                    res["dw"] += 1
                    if rc == 0 and torch.equal(dw, ref):
                        res["dw_same"] += 1
                    else:
                        res["differ"].append(("conv3_wgrad", nb_cap, ci, co,
                                              str(cd), rc))
                    continue
                again = K.conv3_wgrad(g32, dy, nbrs, cd)
                plain = K.conv3_wgrad_plain(g32, dy, nbrs, cd)
                old_rel = float((dw - ref).abs().max()
                                / ref.abs().max().clamp_min(1e-30))
                ref_rel = float((dw - plain).abs().max()
                                / plain.abs().max().clamp_min(1e-30))
                res["bf16_dw"] += 1
                res["bf16_dw_worst_old_rel"] = max(
                    res["bf16_dw_worst_old_rel"], old_rel)
                res["bf16_dw_worst_ref_rel"] = max(
                    res["bf16_dw_worst_ref_rel"], ref_rel)
                if rc == 0 and max(old_rel, ref_rel) <= DW_BF16_TOL:
                    res["bf16_dw_within"] += 1
                else:
                    res["differ"].append(("conv3_wgrad bf16", nb_cap, ci,
                                          co, rc, old_rel, ref_rel))
                if torch.equal(dw, again):
                    res["bf16_dw_repeat_same"] += 1
                else:
                    res["differ"].append(("conv3_wgrad bf16 repeat", nb_cap,
                                          ci, co))
    return res


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    if len(argv) == 4 and argv[1] == "--child":  # the 8^3 side
        Path(argv[3]).write_text(json.dumps(side(load(Path(argv[2])))))
        return 0
    import chip_smoke as CS
    from pcgcv2_torch.ops import blocks as B
    from pcgcv2_torch.ops import conv3 as K

    assert B.BS == 16, "the parent process runs the 16^3 side"
    K.build()  # once, before the child loads it
    with tempfile.TemporaryDirectory() as tmp:
        so = old_library(Path(argv[1]), Path(tmp))
        sides = [side(load(so))]
        out = Path(tmp) / "bs8.json"
        subprocess.run([sys.executable, __file__, "--child", str(so),
                        str(out)], check=True,
                       env={**os.environ, "PCGC_BLOCK_SIZE": "8"})
        sides.append(json.loads(out.read_text()))
    differ = [d for s in sides for d in s["differ"]]
    print(json.dumps({"sides": sides, "differ": len(differ),
                      "card": CS.card_identity()}))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
