"""conv3_tc.cu and conv3_wgrad.cu against an earlier version of the same
sources on the card, at both block sides.

    python3 tests/torch_kernel_bits_witness.py OLD_CSRC

OLD_CSRC is the csrc/ directory of an earlier checkout whose conv3_tc.cu
and conv3_wgrad.cu have the per-side entry points pcgc_conv3_tc_bs16 /
_bs8 and pcgc_conv3_wgrad_bs16 / _bs8, whose conv3_tc.cu instances take
this tree's packs and plans in both dtypes, and whose conv3_wgrad.cu takes
a 4-field plan and runs f32 dy on the CUDA cores and bf16 dy on this
tree's bf16 plans (the commit with bf16 dW on mma.sync), unpacked with
`git archive <commit> pcgcv2_torch/csrc | tar -x -C DIR`.  The earlier
library is built here with nvcc from this tree's translation units
(`ops/conv3.py::units`, the same instances) over OLD_CSRC's sources; every
(ci, co) of the full-width model, and at 16^3 three more, runs in both
compute dtypes on random grids of 512 and 1536 blocks (8^3: 4096 and
12288, the same volume), forward and weight gradient:

* every forward, f32 and bf16, must have the bits of the earlier
  library's launch on the same inputs;
* every bf16 weight gradient (bf16 dy, f32 x: the training step's) must
  be within DW_TOL["bf16"] of max |old| of the earlier launch and of max
  |ref| of conv3_wgrad_plain in bf16, and a second launch must give the
  same bits;
* every f32 weight gradient, which this tree sums in 3xTF32 on mma.sync
  at ci >= 8 and co >= 16 (in f32 FMAs on the CUDA cores below) and the
  earlier library in f32 FMAs on the CUDA cores (launched with its
  own plan, tests/torch_conv3_wgrad_diagnosis.py::old_wgrad_plan), must be
  within DW_TOL["f32"] of max |old|, a second launch the same bits, and
  its error against an f64 reference (the same sums in f64 on the card)
  at most F64_RATIO times the earlier library's, the worst over the calls
  of each; both errors are printed.

The f32 weight gradients of one f32 training step of chip_smoke.py's
phase 7 (8^3: 9d) are held to the same f32 checks on their own inputs.
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

from torch_conv3_wgrad_diagnosis import (  # noqa: E402
    old_wgrad_plan, spy_wgrad, wgrad_f64)

EXTRA_PAIRS = {16: ((64, 32), (1, 64), (4, 16)), 8: ()}
# a dW against the earlier launch (and bf16 against conv3_wgrad_plain),
# over max |old| or max |ref|.  bf16: f32 sums of exact bf16 products in
# another order, chip_smoke.TRAIN_TOL's dW tolerance, far inside 2^-7.
# f32: 3xTF32 (the lo.lo term, ~2^-22 of a product, dropped) against f32
# FMAs, both summed in f32 in other orders
DW_TOL = {"bf16": 1e-4, "f32": 1e-5}
# f32 dW: the worst error against f64 over max |ref|, this tree's over the
# earlier library's, at most
F64_RATIO = 2.0


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


def f32_dw(res: dict, what: tuple, wgrad, wgrad_old, bg, dy, nbrs,
           dw=None) -> None:
    """One f32 dW, this tree's launch `dw` (or `wgrad`'s) against a second
    launch (the same bits), the earlier library's launch with its own plan
    (within DW_TOL["f32"] of max |old|) and the f64 sums (each error over
    max |ref|, the worst of each kept in `res`)."""
    import torch

    from pcgcv2_torch.ops import blocks as B
    from pcgcv2_torch.ops import conv3 as K

    cd = torch.float32
    ci, co = bg.channels, dy.shape[-1]
    dw = wgrad(bg, dy, nbrs, cd) if dw is None else dw
    again = wgrad(bg, dy, nbrs, cd)
    x, g, nb, mask = K._wgrad_inputs(bg, dy, nbrs, cd)
    p = old_wgrad_plan(ci, co, x.element_size(), 4, B.BS)
    part = torch.empty(p.g, 27, ci, co, device=dy.device)
    old = torch.empty_like(dw)
    sel = (ctypes.c_int * 4)(*p, 0)
    rc = wgrad_old(x.data_ptr(), g.data_ptr(), nb.data_ptr(),
                   mask.data_ptr(), bg.count.data_ptr(), part.data_ptr(),
                   old.data_ptr(), ctypes.addressof(sel), ci, co,
                   int(x.dtype == torch.bfloat16), 0,
                   torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    ref = wgrad_f64(bg, g, nbrs)
    scale = float(ref.abs().max().clamp_min(1e-300))
    new_err = float((dw.double() - ref).abs().max()) / scale
    old_err = float((old.double() - ref).abs().max()) / scale
    old_rel = float((dw - old).abs().max() / old.abs().max().clamp_min(1e-30))
    res["f32_dw"] += 1
    res["f32_dw_worst_old_rel"] = max(res["f32_dw_worst_old_rel"], old_rel)
    res["f32_dw_worst_f64_err"] = max(res["f32_dw_worst_f64_err"], new_err)
    res["f32_dw_old_worst_f64_err"] = max(res["f32_dw_old_worst_f64_err"],
                                          old_err)
    if rc == 0 and old_rel <= DW_TOL["f32"]:
        res["f32_dw_within"] += 1
    else:
        res["differ"].append(("conv3_wgrad f32", *what, ci, co, rc, old_rel))
    if torch.equal(dw, again):
        res["f32_dw_repeat_same"] += 1
    else:
        res["differ"].append(("conv3_wgrad f32 repeat", *what, ci, co))


def side(old: ctypes.CDLL) -> dict:
    """Every pair of this process's block side, both dtypes, forward and
    dW, against the earlier library; then the f32 dW calls of one f32
    training step."""
    import torch

    import chip_smoke as CS
    from pcgcv2_torch.ops import blocks as B
    from pcgcv2_torch.ops import conv3 as K

    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream().cuda_stream
    tc_old = getattr(old, f"pcgc_conv3_tc_bs{B.BS}")
    wgrad_old = getattr(old, f"pcgc_conv3_wgrad_bs{B.BS}")
    gen = torch.Generator(device=dev).manual_seed(0)
    res = {"bs": B.BS, "fwd": 0, "fwd_same": 0,
           "bf16_dw": 0, "bf16_dw_within": 0, "bf16_dw_repeat_same": 0,
           "bf16_dw_worst_old_rel": 0.0, "bf16_dw_worst_ref_rel": 0.0,
           "f32_dw": 0, "f32_dw_within": 0, "f32_dw_repeat_same": 0,
           "f32_dw_worst_old_rel": 0.0, "f32_dw_worst_f64_err": 0.0,
           "f32_dw_old_worst_f64_err": 0.0, "differ": []}
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
                if not bf16:
                    f32_dw(res, ("grid", nb_cap), K.conv3_wgrad, wgrad_old,
                           g32, dy, nbrs)
                    continue
                dw = K.conv3_wgrad(g32, dy, nbrs, cd)
                # the earlier library's bf16 plan is this tree's
                p = K.wgrad_plan(ci, co, torch.float32, cd)
                part = torch.empty(p.g, 27, ci, co, device=dev)
                ref = torch.empty_like(dw)
                sel = (ctypes.c_int * 4)(p.ci_tile, p.co_tile, p.g,
                                         int(p.mma))
                rc = wgrad_old(x32.data_ptr(), dy.data_ptr(),
                               nbrs.data_ptr(), mask16.data_ptr(),
                               bg.count.data_ptr(), part.data_ptr(),
                               ref.data_ptr(), ctypes.addressof(sel), ci,
                               co, 0, bf16, stream)
                torch.cuda.synchronize()
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
                if rc == 0 and max(old_rel, ref_rel) <= DW_TOL["bf16"]:
                    res["bf16_dw_within"] += 1
                else:
                    res["differ"].append(("conv3_wgrad bf16", nb_cap, ci,
                                          co, rc, old_rel, ref_rel))
                if torch.equal(dw, again):
                    res["bf16_dw_repeat_same"] += 1
                else:
                    res["differ"].append(("conv3_wgrad bf16 repeat", nb_cap,
                                          ci, co))
    # the f32 dW calls of one f32 training step, on their own inputs
    grid_calls = res["f32_dw"]

    def per_call(real, bg, dy, nbrs, cd, dw):
        f32_dw(res, ("step", bg.nb_cap, bg.stride), real, wgrad_old, bg, dy,
               nbrs, dw)

    with tempfile.TemporaryDirectory() as work:
        tr = CS.make_trainer("float32", work, dev)
        coords, valid = tr._collate(CS.train_batch())
        with spy_wgrad(per_call):
            tr.step(coords, valid)
        torch.cuda.synchronize()
    res["f32_dw_step_calls"] = res["f32_dw"] - grid_calls
    if res["f32_dw_worst_f64_err"] > F64_RATIO * res[
            "f32_dw_old_worst_f64_err"]:
        res["differ"].append(("conv3_wgrad f32 against f64",
                              res["f32_dw_worst_f64_err"],
                              res["f32_dw_old_worst_f64_err"]))
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
