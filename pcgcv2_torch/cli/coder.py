"""Single-frame codec CLI of the PyTorch port (the flags of
pcgcv2_tpu/cli/coder.py plus --device).

    python -m pcgcv2_torch.cli.coder --ckptdir ckpts/r3/r3_final.ckpt \
        --filedir frame.ply [--device cuda|cpu]

Prints per-phase timings, per-file bits/bpp and D1 PSNR (the native
metric; the pc_error binary bridge is not ported).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter
    )
    p.add_argument("--ckptdir", default="ckpts/r3/r3_final.ckpt")
    p.add_argument("--filedir", default="testdata/longdress_vox10_1300.ply")
    p.add_argument("--scaling_factor", type=float, default=1.0)
    p.add_argument("--rho", type=float, default=1.0,
                   help="ratio of output points to input points")
    p.add_argument("--res", type=int, default=1024, help="resolution")
    p.add_argument("--outdir", default="./output")
    p.add_argument("--device", default="cuda",
                   help="torch device of the network (cuda or cpu)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from pcgcv2_torch.checkpoint import load_params
    from pcgcv2_torch.codec.coder import Coder
    from pcgcv2_torch.data.io import load_coords, write_ply_ascii_geo
    from pcgcv2_torch.data.voxelize import scale_coords
    from pcgcv2_torch.eval.metrics import pc_metrics

    start = time.time()
    coords = load_coords(args.filedir)
    print("Loading Time:\t", round(time.time() - start, 4), "s")

    os.makedirs(args.outdir, exist_ok=True)
    filename = os.path.join(
        args.outdir, os.path.split(args.filedir)[-1].split(".")[0]
    )
    print(filename)

    print("=" * 10, "Test", "=" * 10)
    assert os.path.exists(args.ckptdir), f"missing checkpoint {args.ckptdir}"
    params = load_params(args.ckptdir)
    print("load checkpoint from \t", args.ckptdir)

    # the codec operates in the (possibly pre-scaled) coordinate space
    enc_res = int(np.ceil(args.res * args.scaling_factor))
    coder = Coder(params, filename, res=enc_res, device=args.device)

    x_in = (
        scale_coords(coords, args.scaling_factor)
        if args.scaling_factor != 1
        else coords
    )

    start = time.time()
    coder.encode(x_in)
    print("Enc Time:\t", round(time.time() - start, 3), "s")

    start = time.time()
    x_dec = coder.decode(rho=args.rho)
    print("Dec Time:\t", round(time.time() - start, 3), "s")

    if args.scaling_factor != 1:
        x_dec = scale_coords(x_dec, 1.0 / args.scaling_factor)

    sizes = coder.bitstream_bytes()
    bits = np.array([sizes[k] * 8 for k in
                     ("_C.bin", "_F.bin", "_H.bin", "_num_points.bin")])
    bpps = (bits / len(coords)).round(3)
    print("bits:\t", bits, "\nbpps:\t", bpps)
    print("bits:\t", sum(bits), "\nbpps:\t", sum(bpps).round(3))

    start = time.time()
    write_ply_ascii_geo(filename + "_dec.ply", x_dec)
    print("Write PC Time:\t", round(time.time() - start, 3), "s")

    start = time.time()
    metrics = pc_metrics(coords, x_dec, args.res, with_d2=False)
    print("PC Error Metric Time:\t", round(time.time() - start, 3), "s")
    print("D1 PSNR:\t", metrics["mseF,PSNR (p2point)"])


if __name__ == "__main__":
    main()
