"""A whole run of a cell on the CPU at a small size, for the tests: the
cell's files as they are, the mix cut to a few small frames or clouds."""

import json
from pathlib import Path

from h100bench import run

SMALL = {
    "codec": {"res": 128, "sizes": [80, 96], "check_frames": 2,
              "stretch": {"start": 1, "count": 1}},
    "train": {"res": 32, "capacity": 8192, "batch_size": 2,
              "batches_per_call": 3,
              "cloud": {"shape": "random_surface", "resolution": 31,
                        "density": 2.0, "pool": 6}},
}


def small_run(capsys, cell: str, seed: int = 2147483659, fault=None,
              compute_dtype=None, seconds: float = 1.0, trace: int = 0):
    """(exit code, the result line as a dict or None)."""
    orig = run.Cell.__init__

    def init(self, root, name):
        orig(self, root, name)
        if compute_dtype:
            self.cfg["compute_dtype"] = compute_dtype

    run.Cell.__init__ = init
    try:
        kind = "train" if cell.startswith("train") else "codec"
        rc = run.run(["--workload", cell, "--seed", str(seed), "--seconds",
                      str(seconds), "--trace", str(trace)],
                     root=Path.cwd(), device_override="cpu", fault=fault,
                     mix_override=SMALL[kind])
    finally:
        run.Cell.__init__ = orig
    lines = capsys.readouterr().out.strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)
