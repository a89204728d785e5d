"""The 16^3 instances of conv3_tc.cu and conv3_wgrad.cu against an earlier
version of the same sources, bit for bit, on the card.

    python3 tests/torch_kernel_bits_witness.py OLD_CSRC

OLD_CSRC is the csrc/ directory of an earlier checkout whose conv3_tc.cu
and conv3_wgrad.cu have 16^3 blocks only (their entry points
pcgc_conv3_tc and pcgc_conv3_wgrad), for example one unpacked with
`git archive <commit> pcgcv2_torch/csrc | tar -x -C DIR`.  Both libraries
are built here with nvcc; every (ci, co) of the full-width model and
three more run in both compute dtypes on random grids of 512 and 1536
blocks, forward and weight gradient, and each output must have the same
bits.  Prints one JSON line and exits non-zero on a difference.  Not
collected by pytest: it needs the card.
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

EXTRA_PAIRS = ((64, 32), (1, 64), (4, 16))


def old_library(csrc: Path, out: Path) -> ctypes.CDLL:
    """The earlier conv3_tc.cu and conv3_wgrad.cu, built as one library."""
    from pcgcv2_torch.ops import conv3 as K

    objs = [out / f"{name}.o" for name in ("conv3_tc", "conv3_wgrad")]
    procs = [subprocess.Popen([K._nvcc(), *K._NVCC_FLAGS, "-c", "-o",
                               str(o), str(csrc / f"{o.stem}.cu")])
             for o in objs]
    if any(p.wait() != 0 for p in procs):
        raise RuntimeError("nvcc failed on the earlier sources")
    so = out / "libold.so"
    subprocess.run([K._nvcc(), "-shared", "-o", str(so), *map(str, objs)],
                   check=True)
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.pcgc_conv3_tc.restype = ci
    lib.pcgc_conv3_tc.argtypes = [vp] * 7 + [ci] * 4 + [vp]
    lib.pcgc_conv3_wgrad.restype = ci
    lib.pcgc_conv3_wgrad.argtypes = [vp] * 8 + [ci] * 4 + [vp]
    return lib


def main(argv) -> int:
    import torch

    import chip_smoke as CS
    from pcgcv2_torch.ops import blocks as B
    from pcgcv2_torch.ops import conv3 as K

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    assert B.BS == 16, "compares the 16^3 instances"
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory() as tmp:
        old = old_library(Path(argv[1]), Path(tmp))
        gen = torch.Generator(device=dev).manual_seed(0)
        n, differ = 0, []
        for nb_cap in (512, 1536):
            base = CS.random_grid(nb_cap, 64, seed=nb_cap, device=dev)
            nbrs = B.neighbor_rows(base)
            mask16 = K._aligned(base.mask, 16)
            for ci, co in K.MODEL_PAIRS + EXTRA_PAIRS:
                for cd in (torch.float32, torch.bfloat16):
                    bf16 = int(cd == torch.bfloat16)
                    x32 = base.feats[:, :, :ci].contiguous()
                    bg = base.replace(feats=x32.to(cd))
                    w = (0.1 * torch.randn(3, 3, 3, ci, co, device=dev,
                                           generator=gen)).to(cd)
                    b = torch.randn(co, device=dev, generator=gen).to(cd)
                    packed = K.pack_weight(w)
                    new = K.conv3(bg, nbrs, w, b, cd, packed=packed).feats
                    ref = torch.empty_like(new)
                    rc = old.pcgc_conv3_tc(
                        bg.feats.data_ptr(), nbrs.data_ptr(),
                        bg.mask.data_ptr(), bg.count.data_ptr(),
                        packed.data_ptr(), b.data_ptr(), ref.data_ptr(),
                        nb_cap, ci, co, bf16, stream)
                    torch.cuda.synchronize()
                    n += 1
                    if rc != 0 or not torch.equal(new, ref):
                        differ.append(("conv3", nb_cap, ci, co, str(cd)))
                    dy = torch.randn(nb_cap, B.VOL, co, device=dev,
                                     generator=gen)
                    dy = torch.where((bg.mask & bg.valid[:, None])[:, :, None],
                                     dy, 0).to(cd)
                    g32 = bg.replace(feats=x32)
                    dw = K.conv3_wgrad(g32, dy, nbrs, cd)
                    p = K.wgrad_plan(ci, co, torch.float32, cd)
                    part = torch.empty(p.g, 27, ci, co, device=dev)
                    ref = torch.empty_like(dw)
                    sel = (ctypes.c_int * 3)(p.ci_tile, p.co_tile, p.g)
                    rc = old.pcgc_conv3_wgrad(
                        x32.data_ptr(), dy.data_ptr(), nbrs.data_ptr(),
                        mask16.data_ptr(), bg.count.data_ptr(),
                        part.data_ptr(), ref.data_ptr(),
                        ctypes.addressof(sel), ci, co, 0, bf16, stream)
                    torch.cuda.synchronize()
                    n += 1
                    if rc != 0 or not torch.equal(dw, ref):
                        differ.append(("conv3_wgrad", nb_cap, ci, co,
                                       str(cd)))
    print(json.dumps({"launches": n, "same_bits": n - len(differ),
                      "differ": differ, "card": CS.card_identity()}))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
