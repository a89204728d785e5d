"""The readings that the limits of `correct` are set from (not part of a
benchmark run).

    python3 -m h100bench.calibrate --workload <cell> --seeds 1 2 3 ... \
        [--faults] [--out FILE]

For each seed, in one process, at the cell's own size: the program's
numbers as a run of the cell computes them (codec: the mix's
`check_frames` frames, coded closed loop and then checked; training: the
check's three steps of the first `train_scanned` call), then the
control's: the reference computed in the precision below the
configuration's, put in the program's place, against the reference in
float32.  A bfloat16 training cell also reads the reference in bfloat16
in that place; with `--faults`, training also reads the planted fault
`half_batch`.  The lower reading of a number is the largest the program
gives over the seeds, its upper the smallest the control (or a fault)
gives.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from h100bench.run import Cell, log, make_driver

# The nearest precision below the configuration's (the control).
CONTROL = {"bfloat16": "fp8", "float32": "tf32"}


def codec_seed(cell, driver, seed, device, control, root):
    import torch

    from h100bench import check
    from h100bench.reference import codec as RC

    n = int(cell.mix["check_frames"])
    for i in range(n):
        driver.step(i)
    torch.cuda.synchronize()
    prog = check.check_codec(driver, cell.cfg, root, seed, n, device, log)
    net32, eb = check.reference_net(cell.cfg, root, device, "f32")
    netc, _ = check.reference_net(cell.cfg, root, device, control)
    ctrl = {}
    for i in range(n):
        frame = driver.load.frame(i)
        ref = RC.run_frame(net32, eb, frame, driver.rho)
        low = RC.run_frame(netc, eb, frame, driver.rho)
        out = dict(latent_xyz=low["latent_xyz"],
                   latents_q=np.round(low["latents"]),
                   decoded=low["decoded"])
        nums = check.codec_numbers(out, ref)
        nums["bits_gap"] = check.bits_gap(
            {"all": check.reference_bits(low) / 8.0}, ref)
        for k, v in nums.items():
            ctrl[k] = max(ctrl.get(k, 0.0), v)
    return {"program": prog, "control": ctrl}


def train_seed(cell, driver, seed, device, control, root, faults):
    """The program's numbers, then each stand-in's, the reference in some
    precision or with a planted fault put in the program's place: the
    control; in a bfloat16 cell the reference in bfloat16 (the look:
    whether bfloat16 rounding alone reads as the program does); with
    `faults`, the half batch."""
    from h100bench import check

    snap = driver.snap
    prog_in = dict(rows=snap["rows"], exp_avg=snap["exp_avg"],
                   params=snap["params"])
    args = (cell.cfg, cell.mix, root, seed, driver.check_batches,
            snap["noise_rows"], device)
    driver.release()
    ref = check.reference_steps(*args)
    alpha, beta = float(cell.mix["alpha"]), float(cell.mix["beta"])

    def numbers(part, other):
        nums = check.train_numbers(other, ref, alpha, beta)
        log(f"seed {seed} {part}: {nums.pop('_info')}")
        return nums

    def as_program(other):
        return dict(rows=[[l_ / alpha, 0.0] for l_ in other["losses"]],
                    exp_avg={k: v * (1 - 0.9)
                             for k, v in other["grad1"].items()},
                    params=other["params"])

    out = {"program": numbers("program", prog_in)}
    stand_ins = {"control": dict(precision=control)}
    if cell.cfg["compute_dtype"] == "bfloat16":
        stand_ins["bf16_reference"] = dict(precision="bf16")
    if faults:
        stand_ins["half_batch"] = dict(fault="half_batch")
    for part, kw in stand_ins.items():
        out[part] = numbers(part, as_program(
            check.reference_steps(*args, **kw)))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--faults", action="store_true")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    root = Path.cwd()
    cell = Cell(root, args.workload)
    os.environ.update(cell.cfg.get("env", {}))
    import torch

    device = torch.device("cuda")
    control = CONTROL[cell.cfg["compute_dtype"]]
    results = {}
    for seed in args.seeds:
        t0 = time.perf_counter()
        workdir = tempfile.mkdtemp(prefix="h100bench_cal_")
        driver = make_driver(cell, seed, device, workdir, str(root))
        if cell.mix["kind"] == "codec":
            r = codec_seed(cell, driver, seed, device, control, str(root))
        else:
            driver.warm()
            r = train_seed(cell, driver, seed, device, control, str(root),
                           args.faults)
        del driver
        shutil.rmtree(workdir, ignore_errors=True)
        torch.cuda.empty_cache()
        results[seed] = r
        log(f"seed {seed} ({time.perf_counter() - t0:.1f} s): "
            + json.dumps(r))
    summary = {"cell": args.workload, "control": control, "seeds": results}
    for part in ("program", "control", "bf16_reference", "half_batch"):
        rows = [r[part] for r in results.values() if part in r]
        if rows:
            summary[part] = {k: {"max": max(x[k] for x in rows),
                                 "min": min(x[k] for x in rows)}
                             for k in rows[0]}
    text = json.dumps(summary, indent=1)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
