"""Reading a `torch.profiler` trace of a stretch of the window.

The traced stretch is one `record_function` annotation, `bench.stretch`,
that ends after a device synchronize, so its span is the stretch's wall
and every kernel it caused lies inside it.  Device activity (kernels,
copies, memsets) is read from the exported Chrome trace; busy time is the
union of their intervals inside the stretch, so overlapping streams count
once (the arithmetic of the builders' one-stream profiles, 1 - kernel
time / wall, reworked to the union).  An idle gap is named by what ran
on the host at its middle: the deepest benchmark span (`bench.*`) and
the deepest other host op.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

STRETCH = "bench.stretch"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Trace:
    t0: float  # stretch start, s
    t1: float  # stretch end, s
    device: List[Tuple[str, float, float]] = field(default_factory=list)
    host: List[Tuple[str, float, float, bool]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def kernels(self, patterns: Sequence[str]) -> List[Tuple[str, float,
                                                             float]]:
        """Device events whose name matches any of the regexes."""
        rx = [re.compile(p) for p in patterns]
        return [e for e in self.device if any(r.search(e[0]) for r in rx)]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """Union of the device events' [start, end) inside the stretch."""
        spans = sorted((max(s, self.t0), min(s + d, self.t1))
                       for _, s, d in self.device)
        out: List[List[float]] = []
        for a, b in spans:
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def device_ops(self, n: int = 10) -> List[List]:
        tot: Dict[str, float] = {}
        for name, _, d in self.device:
            tot[name] = tot.get(name, 0.0) + d
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:200], sec] for name, sec in top]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The longest idle gaps, each named by what the host ran."""
        busy = self.busy_intervals()
        gaps, last = [], self.t0
        for a, b in busy:
            if a > last:
                gaps.append((last, a))
            last = b
        if self.t1 > last:
            gaps.append((last, self.t1))
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self._host_at(0.5 * (a + b)), b - a] for a, b in gaps[:n]]

    def _host_at(self, t: float) -> str:
        """'<deepest bench span> > <deepest other host op>' at time t."""
        deepest: Dict[bool, Tuple[float, str]] = {}
        for name, s, d, is_bench in self.host:
            if name == STRETCH or not (s <= t < s + d):
                continue
            if is_bench not in deepest or d < deepest[is_bench][0]:
                deepest[is_bench] = (d, name)
        parts = [deepest[k][1] for k in (True, False) if k in deepest]
        return " > ".join(parts)[:200] if parts else "host (no op recorded)"


def read_chrome_trace(path: str) -> Trace:
    with open(path) as f:
        events = json.load(f)
    events = events.get("traceEvents", events)
    stretch = [e for e in events if e.get("name") == STRETCH
               and e.get("ph") == "X" and e.get("cat") in
               ("user_annotation", "cpu_op")]
    if not stretch:
        raise RuntimeError(f"no {STRETCH} span in the trace")
    st = max(stretch, key=lambda e: e.get("dur", 0))
    tr = Trace(t0=st["ts"] * 1e-6, t1=(st["ts"] + st["dur"]) * 1e-6)
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        s, d = e["ts"] * 1e-6, e["dur"] * 1e-6
        if not tr.t0 <= s < tr.t1:  # the profiler's lead-in unit
            continue
        if cat in _DEVICE_CATS:
            tr.device.append((e.get("name", cat), s, d))
        elif cat in ("cpu_op", "user_annotation", "python_function"):
            name = e.get("name", "")
            tr.host.append((name, s, d, name.startswith("bench.")))
    return tr
