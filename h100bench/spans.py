"""Readers of the program's own stage spans in a traced stretch.

The port marks its stages with `record_function` spans named `pcgc.*`
(`pcgcv2_torch/obs.py`), which exist only while a profiler records: a
program without them gives no such span, and every reader here then
returns None.  Three spans are parents, each the whole of one call into
the port (`PARENTS`); every other `pcgc.*` span is a stage.  Spans are
read from `trace.Trace.host`, clipped to the stretch; device idle time is
measured against `Trace.busy_intervals()`.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

PREFIX = "pcgc."
PARENTS = ("pcgc.encode", "pcgc.decode", "pcgc.train.call")

Intervals = List[Tuple[float, float]]


def spans(tr, names: Iterable[str]) -> Intervals:
    """[start, end) of the host spans whose name is one of `names`,
    clipped to the stretch, in the order of the trace."""
    names = set(names)
    out = []
    for name, s, d, _ in tr.host:
        a, b = max(s, tr.t0), min(s + d, tr.t1)
        if name in names and b > a:
            out.append((a, b))
    return out


def stage_names(tr) -> List[str]:
    """The names of the trace's stage spans: `pcgc.*` but no parent."""
    return sorted({h[0] for h in tr.host if h[0].startswith(PREFIX)
                   and h[0] not in PARENTS})


def union(iv: Intervals) -> Intervals:
    out: List[List[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def intersect(x: Intervals, y: Intervals) -> Intervals:
    """The intersection of two unions (each sorted, disjoint)."""
    out, i, j = [], 0, 0
    while i < len(x) and j < len(y):
        a, b = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        if b > a:
            out.append((a, b))
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return out


def length(iv: Intervals) -> float:
    return sum(b - a for a, b in iv)


def idle_s(tr, iv: Intervals) -> float:
    """Seconds inside the union of `iv` in which the device ran
    nothing."""
    u = union(iv)
    return length(u) - length(intersect(u, tr.busy_intervals()))


def ms_per_unit(rec, names: Sequence[str]) -> Optional[float]:
    """Summed durations of the named spans, ms per unit of the stretch
    (a frame, a call); None where there is none."""
    iv = spans(rec.trace, names)
    return 1e3 * length(iv) / rec.stretch_units if iv else None


def idle_ms_per_unit(rec, names: Sequence[str]) -> Optional[float]:
    """Device-idle ms per unit inside the union of the named spans."""
    iv = spans(rec.trace, names)
    return 1e3 * idle_s(rec.trace, iv) / rec.stretch_units if iv else None


def unnamed_idle_pct(rec, parents: Sequence[str]) -> Optional[float]:
    """Of the device-idle time inside the `parents` spans, the share that
    no stage span covers, in %: what the spans cannot name yet."""
    tr = rec.trace
    inside = union(spans(tr, parents))
    if not inside:
        return None
    idle = idle_s(tr, inside)
    if idle <= 0:
        return 0.0
    staged = intersect(inside, union(spans(tr, stage_names(tr))))
    return 100.0 * (idle - idle_s(tr, staged)) / idle
