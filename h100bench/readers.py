"""Helpers of the per-layer metric readers (`metrics/<metric>.py`).

A reader takes the traced run's record: `trace` (the profiled stretch,
`trace.Trace`), `records` (per unit of the window: a frame of a codec
cell, a `train_scanned` call of a training cell, with host-clock spans
and whether it was profiled), `work` (the conv work of the profiled
units, `work.conv_work`), `dtype`, `stretch_units` and `steps_per_unit`.
It returns one number, or None where it finds nothing to read.
"""

from __future__ import annotations

import statistics
from typing import List, Optional, Sequence

from h100bench import work as W


def unprofiled(rec, key: str) -> List[float]:
    return [r[key] for r in rec.records if not r["profiled"]]


def per_unit_ms(rec, patterns: Sequence[str], per_step: bool) -> Optional[
        float]:
    """Device ms of the matching kernels per frame or per step."""
    ev = rec.trace.kernels(patterns)
    if not ev:
        return None
    units = rec.stretch_units * (rec.steps_per_unit if per_step else 1)
    return 1e3 * sum(d for _, _, d in ev) / units


def roofline(rec, patterns: Sequence[str], passes: Sequence[str]
             ) -> Optional[float]:
    """Least time of the conv3 work of `passes` over the matching
    kernels' device time, in %."""
    ev = rec.trace.kernels(patterns)
    entries = [e for e in rec.work if e["kind"] == "conv3"
               and e["pass_"] in passes]
    t = sum(d for _, _, d in ev)
    if not ev or not entries or t <= 0:
        return None
    return 100.0 * W.bound_s(entries, rec.dtype) / t


def mfu(rec) -> Optional[float]:
    """Model FLOP of the profiled units over the stretch's wall and the
    chip's peak for the dtype, in %."""
    if not rec.work or rec.trace.window_s <= 0:
        return None
    flop = sum(e["flop"] for e in rec.work)
    return 100.0 * flop / rec.trace.window_s / W.peak_flops(rec.dtype)


def idle_pct(rec) -> Optional[float]:
    if rec.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s() / rec.trace.window_s)


def percentile(values: List[float], q: int) -> Optional[float]:
    """The q-th percentile (Python's exclusive method), the only value
    where there is one, None where there is none."""
    if not values:
        return None
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=100, method="exclusive")[q - 1]
