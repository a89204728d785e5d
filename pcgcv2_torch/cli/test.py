"""Rate-sweep evaluation CLI of the PyTorch port (twin of
pcgcv2_tpu/cli/test.py, plus --device).

    python -m pcgcv2_torch.cli.test --filedir frame.ply \
        --ckpts ckpts/r1/r1_final.ckpt ckpts/r2/r2_final.ckpt ... \
        [--res 2048] [--device cuda|cpu]

Encodes and decodes the frame once per checkpoint and writes one CSV row
per rate point to <resultdir>/<sequence>.csv, with the columns of the
results/ tables.  The CSV is written with the standard library; the RD
plot (<sequence>.jpg) is drawn only where matplotlib is installed.
"""

from __future__ import annotations

import argparse
import csv
import importlib.util
import os
import time

import numpy as np

DEFAULT_CKPTS = [f"./ckpts/r{i}/r{i}_final.ckpt" for i in range(1, 8)]


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter
    )
    p.add_argument("--filedir", default="testdata/longdress_vox10_1300.ply")
    p.add_argument("--outdir", default="./output")
    p.add_argument("--resultdir", default="./results")
    p.add_argument("--scaling_factor", type=float, default=1.0)
    p.add_argument("--res", type=int, default=1024)
    p.add_argument("--rho", type=float, default=1.0)
    p.add_argument("--ckpts", nargs="*", default=DEFAULT_CKPTS)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"],
                   help="conv compute dtype (bfloat16 = production)")
    p.add_argument("--cold_times", action="store_true",
                   help="skip the warm-up rep: time(enc)/time(dec) include "
                        "the first call's kernel builds")
    p.add_argument("--device", default="cuda",
                   help="torch device of the network (cuda or cpu)")
    return p.parse_args(argv)


def run_sweep(filedir, ckptdir_list, outdir, resultdir,
              scaling_factor=1.0, rho=1.0, res=1024, warmup=True,
              device="cuda"):
    """Encode + decode `filedir` at every checkpoint; returns the CSV rows
    as a list of dicts (also written to <resultdir>/<sequence>.csv)."""
    from pcgcv2_torch.checkpoint import load_params
    from pcgcv2_torch.codec.coder import Coder
    from pcgcv2_torch.data.io import load_coords, write_ply_ascii_geo
    from pcgcv2_torch.data.voxelize import scale_coords
    from pcgcv2_torch.eval import pc_error as pce
    from pcgcv2_torch.eval.metrics import pc_metrics

    start = time.time()
    coords = load_coords(filedir)
    print("Loading Time:\t", round(time.time() - start, 4), "s")

    os.makedirs(outdir, exist_ok=True)
    os.makedirs(resultdir, exist_ok=True)
    sequence = os.path.split(filedir)[-1].split(".")[0]
    filename = os.path.join(outdir, sequence)
    csv_name = os.path.join(resultdir, sequence + ".csv")
    print("output filename:\t", filename)

    rows = []
    coder = None
    for idx, ckptdir in enumerate(ckptdir_list):
        print("=" * 10, idx + 1, "=" * 10)
        if not os.path.exists(ckptdir):
            raise FileNotFoundError(f"missing checkpoint {ckptdir}")
        params = load_params(ckptdir)
        print("load checkpoint from \t", ckptdir)
        if coder is None:
            enc_res = int(np.ceil(res * scaling_factor))
            coder = Coder(params, filename, res=enc_res, device=device)
        else:
            coder.params = params
        postfix = f"_r{idx + 1}"

        x_in = (
            scale_coords(coords, scaling_factor)
            if scaling_factor != 1 else coords
        )

        if warmup and idx == 0:
            # the first call builds the kernels: keep it out of the timed
            # reps, so time(enc)/time(dec) are steady-state
            start = time.time()
            coder.encode(x_in, postfix="_warm")
            coder.decode(rho=rho, postfix="_warm")
            print("Warm-up:\t", round(time.time() - start, 3), "s")

        start = time.time()
        coder.encode(x_in, postfix=postfix)
        time_enc = round(time.time() - start, 3)
        print("Enc Time:\t", time_enc, "s")

        start = time.time()
        x_dec = coder.decode(rho=rho, postfix=postfix)
        time_dec = round(time.time() - start, 3)
        print("Dec Time:\t", time_dec, "s")

        if scaling_factor != 1:
            x_dec = scale_coords(x_dec, 1.0 / scaling_factor)

        sizes = coder.bitstream_bytes(postfix=postfix)
        bits = np.array([sizes[k] * 8 for k in
                         ("_C.bin", "_F.bin", "_H.bin", "_num_points.bin")])
        bpps = (bits / len(coords)).round(3)
        print("bits:\t", sum(bits), "\nbpps:\t", sum(bpps).round(3))

        dec_ply = filename + postfix + "_dec.ply"
        write_ply_ascii_geo(dec_ply, x_dec)

        start = time.time()
        metrics = {}
        if pce.find_pc_error() is not None:
            metrics = pce.pc_error(filedir, dec_ply, res=res, normal=True)
        if "mseF,PSNR (p2point)" not in metrics:
            # binary absent, or it failed (`-n` on a PLY without normals):
            # the native KD-tree D1/D2 gives the same keys
            metrics = pc_metrics(coords, x_dec, res, with_d2=True)
        print("PC Error Metric Time:\t", round(time.time() - start, 3), "s")
        print("D1 PSNR:\t", metrics["mseF,PSNR (p2point)"])

        row = dict(metrics)
        row["num_points(input)"] = len(coords)
        row["num_points(output)"] = len(x_dec)
        row["resolution"] = res
        row["bits"] = float(sum(bits))
        row["bpp"] = float(sum(bpps).round(3))
        row["bpp(coords)"] = float(bpps[0])
        row["bpp(feats)"] = float(bpps[1])
        row["time(enc)"] = time_enc
        row["time(dec)"] = time_dec
        rows.append(row)

        with open(csv_name, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0]),
                               lineterminator="\n")
            w.writeheader()
            w.writerows(rows)
        print("Write results to: \t", csv_name)

    return rows


def plot_rd(results, filedir, resultdir):
    """RD curve image <sequence>.jpg beside the CSV, one line per
    distortion metric present in the rows."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    name = os.path.splitext(os.path.basename(filedir))[0]
    rate = [float(r["bpp"]) for r in results]
    curves = [
        ("mseF,PSNR (p2point)", "D1"),
        ("mseF,PSNR (p2plane)", "D2"),
    ]
    fig, ax = plt.subplots()
    for column, label in curves:
        if column not in results[0]:
            continue
        ax.plot(rate, [float(r[column]) for r in results],
                marker="o", label=label)
    ax.set(title=name, xlabel="bpp", ylabel="PSNR (dB)")
    ax.grid(alpha=0.4)
    ax.legend()
    fig.tight_layout()
    fig.savefig(os.path.join(resultdir, name + ".jpg"), dpi=120)
    plt.close(fig)


def main(argv=None):
    args = parse_args(argv)
    from pcgcv2_torch.ops import blocks as B

    B.set_compute_dtype(args.dtype)
    results = run_sweep(
        args.filedir, args.ckpts, args.outdir, args.resultdir,
        scaling_factor=args.scaling_factor, rho=args.rho, res=args.res,
        warmup=not args.cold_times, device=args.device,
    )
    if importlib.util.find_spec("matplotlib") is None:
        print("matplotlib is not installed: no RD plot")
    else:
        plot_rd(results, args.filedir, args.resultdir)


if __name__ == "__main__":
    main()
