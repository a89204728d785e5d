"""Run one cell of the benchmark once.

    python3 -m h100bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell (`BENCHMARK.json`'s `workloads`)
names a configuration (`h100bench/configs/<config>.json`) and a traffic
mix (`h100bench/traffic/<mix>.json`); its limits are
`h100bench/limits/<cell>.json` and each per-layer metric is read by
`h100bench/metrics/<metric>.py`, all found by name.

Set-up (from the process's start: imports, the port's kernel library,
the load from the seed and the warm-up: for training the first call,
from which the check takes its three steps) is `setup_s`.  Then the window: the cell's driver runs for
`--seconds`, closed loop; its rates and tails are over all the work and
all the time of the window.  With `--trace 1` a stretch of the window is
profiled and the per-layer metrics are read from it.  After the window
the program's state is freed and the reference judges; the numbers
compared are printed with their limits as the last lines of stderr and
under `checks`, the last key of the result, the last line of stdout.
Without the card the cell asks for the run exits with 3, with JAX or the
JAX package loaded once the window has closed with 4, and with other
weights than the configuration's with 5, printing no result.
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pcgcv2_tpu")
HERE = Path(__file__).resolve().parent
GIB = float(1 << 30)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_metric(name: str, base: Path = HERE):
    path = base / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"h100bench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Cell:
    """A cell of BENCHMARK.json with its files, found by name."""

    def __init__(self, root: Path, name: str):
        bench = load_json(root / "BENCHMARK.json")
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}")
        self.name = name
        self.entry = cells[name]
        conf = {c["name"]: c for c in bench["configs"]}[self.entry["config"]]
        self.cfg = load_json(root / conf["file"])
        self.base = root / HERE.name
        self.mix = load_json(self.base / "traffic"
                             / f"{self.entry['traffic']}.json")
        self.limits = load_json(self.base / "limits" / f"{name}.json")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        e2e = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in e2e)]


def make_driver(cell: Cell, seed: int, device, workdir: str, root: str):
    from h100bench import drive

    kind = cell.mix["kind"]
    cls = {"codec": drive.CodecDriver, "train": drive.TrainDriver}[kind]
    return cls(cell.cfg, cell.mix, seed, device, workdir, root)


def window(driver, seconds: float, trace: bool, stretch: Dict, workdir: str,
           cuda: bool = True):
    """Run the driver until `seconds` have passed, closed loop.  With
    `trace`, profile units [start, start + count) of the window: the
    profiler starts one unit earlier, so that its own start-up stall falls
    outside the stretch.  Returns (units, work units, window seconds,
    trace or None)."""
    import torch

    sync = torch.cuda.synchronize if cuda else (lambda: None)
    tr = prof = rf = None
    start, count = int(stretch["start"]), int(stretch["count"])
    i, work = 0, 0
    sync()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds or (trace and i < start + count):
        if trace and i == max(0, start - 1):
            acts = [torch.profiler.ProfilerActivity.CPU]
            if cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
        if prof is not None and i == start:
            sync()
            rf = torch.profiler.record_function("bench.stretch")
            rf.__enter__()
        work += driver.step(i, profiled=prof is not None,
                            stretch=rf is not None)
        i += 1
        if rf is not None and i == start + count:
            sync()
            rf.__exit__(None, None, None)
            prof.__exit__(None, None, None)
            path = os.path.join(workdir, "trace.json")
            prof.export_chrome_trace(path)
            from h100bench.trace import read_chrome_trace

            tr = read_chrome_trace(path)
            os.remove(path)
            prof = rf = None
    sync()
    return i, work, time.perf_counter() - t0, tr


def end_to_end_metrics(cell: Cell, driver, units: int, work: int,
                       window_s: float, setup_s: float, peak: int
                       ) -> Dict[str, Dict]:
    from h100bench.readers import percentile

    vals = {"setup_s": setup_s, "peak_mem_gib": peak / GIB}
    if driver.kind == "codec":
        vals["frames_per_s"] = units / window_s
        vals["decode_p90_ms"] = 1e3 * percentile(
            [r["decode_s"] for r in driver.records], 90)
    else:
        vals["train_voxels_per_s"] = work / window_s
    return {m["name"]: {"value": vals[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end if m["name"] in vals}


def per_layer_metrics(cell: Cell, rec) -> Dict[str, Dict]:
    out = {}
    for m in cell.per_layer:
        v = load_metric(m["name"], cell.base)(rec)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def work_of_stretch(cell: Cell, driver, device) -> List[Dict]:
    """Work entries of the profiled units, from their coordinates."""
    import torch

    from h100bench import work as W
    from h100bench.reference.codec import frame_keys

    out: List[Dict] = []
    dtype = cell.cfg["compute_dtype"]
    with torch.no_grad():
        for r in driver.records:
            if not r["stretch"]:
                continue
            if driver.kind == "codec":
                sets = W.sets_of(frame_keys(driver.load.frame(r["index"]),
                                            device))
                out += W.conv_work(cell.cfg["convs"], sets, dtype, False)
            else:
                for clouds in r["batches"]:
                    sets = W.sets_of(W.batch_keys(clouds, device))
                    out += W.conv_work(cell.cfg["convs"], sets, dtype, True)
    return out


def run(argv: Optional[List[str]] = None, root: Optional[Path] = None,
        device_override: Optional[str] = None, fault=None,
        mix_override: Optional[Dict] = None) -> int:
    """The whole run; returns the exit code.  `device_override`, `fault`
    and `mix_override` serve the tests, which drive a run on the CPU at a
    small size with the timed path broken underneath (`fault(driver)`
    before the warm-up)."""
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = root or Path.cwd()
    cell = Cell(root, args.workload)
    cell.mix.update(mix_override or {})
    os.environ.update(cell.cfg.get("env", {}))
    from h100bench.reference.ckpt import sha256

    if sha256(str(root / cell.cfg["weights"])) != cell.cfg["weights_sha256"]:
        log(f"{cell.cfg['weights']} is not the configuration's weights")
        return 5

    import torch

    if device_override is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < int(cell.entry["chips"]):
            log(f"needs {cell.entry['chips']} CUDA device(s); "
                f"torch.cuda.is_available() = {torch.cuda.is_available()}")
            return 3
        device = torch.device("cuda:0")
    else:
        device = torch.device(device_override)
    cuda = device.type == "cuda"
    import tempfile

    workdir = tempfile.mkdtemp(prefix="h100bench_")
    driver = make_driver(cell, args.seed, device, workdir, str(root))
    if fault is not None:
        fault(driver)
    driver.warm()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - _T_START
    log(f"set-up {setup_s:.3f} s")
    units, work, window_s, tr = window(
        driver, args.seconds, bool(args.trace),
        cell.mix["stretch"], workdir, cuda)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    log(f"window {window_s:.3f} s: {units} {driver.kind} units, {work} "
        f"voxels, peak {peak / GIB:.3f} GiB")
    if driver.kind == "codec":
        bad = sum(r["decoded"] != int(driver.rho * r["voxels"])
                  for r in driver.records)
        log(f"frames whose decoded count differs from rho x input: {bad}")

    from types import SimpleNamespace

    # a unit that raises ends the run without a result
    result = {"attempted": units, "failed": 0}
    if args.trace:
        rec = SimpleNamespace(
            kind=driver.kind, dtype=cell.cfg["compute_dtype"], trace=tr,
            records=driver.records, work=work_of_stretch(cell, driver,
                                                         device),
            stretch_units=int(cell.mix["stretch"]["count"]),
            steps_per_unit=(int(cell.mix.get("batches_per_call", 1))))
        metrics = per_layer_metrics(cell, rec)
        busy = tr.busy_s()
        dev_extra = {"busy_s": busy, "window_s": tr.window_s}
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_gaps()}
        log(f"traced stretch {tr.window_s:.3f} s, busy {busy:.3f} s")
    else:
        metrics = end_to_end_metrics(cell, driver, units, work, window_s,
                                     setup_s, peak)
        dev_extra = {}

    # the program's state goes before the reference runs
    if driver.kind == "train":
        snap = driver.snap
        check_in = dict(rows=snap["rows"], exp_avg=snap["exp_avg"],
                        params=snap["params"])
        check_batches, noise_rows = driver.check_batches, snap["noise_rows"]
    driver.release()
    import gc

    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    from h100bench import check

    if driver.kind == "codec":
        nums = check.check_codec(driver, cell.cfg, str(root), args.seed,
                                 int(cell.mix["check_frames"]), device, log)
    else:
        ref = check.reference_steps(cell.cfg, cell.mix, str(root),
                                    args.seed, check_batches, noise_rows,
                                    device)
        nums = check.train_numbers(check_in, ref, float(cell.mix["alpha"]),
                                   float(cell.mix["beta"]))
        log(nums.pop("_info"))
    log("not compared: " + ", ".join(f"{k} {v:.6g}" for k, v in nums.items()
                                     if k not in cell.limits))
    checks = {k: {"value": nums[k], "limit": float(v)}
              for k, v in cell.limits.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {bad}")
        return 4
    import shutil

    shutil.rmtree(workdir, ignore_errors=True)
    result.update({
        "correct": bool(correct),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": int(cell.entry["chips"]) if cuda else 0,
            "memory_peak_bytes": int(peak), **dev_extra},
        "checks": checks,
    })
    for k, c in checks.items():
        log(f"{k} {c['value']:.6g} limit {c['limit']:.6g}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(run())
