"""Spans of the program's stages, on the profiler's clock.

`span(name)` is a context manager around one stage of a call into the
package (a stage of `Coder.encode`, a plan search, a replay of the
trainer's graph).  While a `torch.profiler` is recording it is that
profiler's `record_function(name)`: the span lands in the profile, on the
same clock as the CUDA kernels, copies and memsets the profiler traces,
so an idle stretch of the device can be read against the host stage that
ran then.  Otherwise it is one shared context manager that does nothing:
the check costs a tenth of a microsecond, where entering
`record_function` with no profiler running costs several.

There is no flag, store or exporter: a span exists only in a profile.
Its count in a profile counts the stage (plan-ladder retries, captures,
replays, plan searches, library builds).  Every name starts with
`pcgc.`; the names and the metrics that read them are listed in PERF.md.
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()
_recording = torch.autograd._profiler_enabled


def span(name: str):
    """`torch.profiler.record_function(name)` while a profiler records,
    else a shared no-op context manager."""
    if _recording():
        return torch.profiler.record_function(name)
    return _OFF
