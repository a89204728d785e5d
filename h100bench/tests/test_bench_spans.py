"""The readers of the port's stage spans (`spans.py`, the `pcgc.*`
metrics) on traces built by hand, to the microsecond: summed durations,
device-idle time inside a union of spans that overlap busy intervals in
part, the share of idle time no stage span names, and None where the
program has no such spans."""

from types import SimpleNamespace

import pytest

from h100bench import run
from h100bench.trace import Trace

US = 1e-3  # one microsecond, in ms


def _trace(host, device, t1=1.0):
    return Trace(t0=0.0, t1=t1,
                 device=[("kernel", a, b - a) for a, b in device],
                 host=[(n, a, b - a, n.startswith("bench."))
                       for n, a, b in host])


# two frames; the device busy in [0.1, 0.17) (two overlapping kernels),
# [0.3, 0.4) and [0.6, 0.61)
CODEC = _trace(host=[
    ("bench.stretch", 0.0, 1.0),
    ("bench.encode", 0.0, 0.3),
    ("pcgc.encode", 0.01, 0.3),
    ("pcgc.encode.unique_rows", 0.02, 0.05),
    ("pcgc.encode.block_counts", 0.05, 0.08),
    ("aten::lt", 0.055, 0.056),
    ("pcgc.encode.upload", 0.08, 0.09),
    ("pcgc.encode.network", 0.09, 0.16),
    ("pcgc.encode.fetch", 0.16, 0.2),
    ("pcgc.encode.order", 0.2, 0.23),
    ("bench.feature_coder", 0.235, 0.262),
    ("pcgc.rans.encode", 0.24, 0.26),
    ("pcgc.octree.encode", 0.26, 0.29),
    ("bench.decode", 0.3, 0.75),
    ("pcgc.decode", 0.3, 0.7),
    ("pcgc.octree.decode", 0.3, 0.32),
    ("pcgc.rans.decode", 0.32, 0.34),
    ("pcgc.decode.unpack", 0.34, 0.35),
    ("pcgc.decode.network", 0.35, 0.42),
    ("pcgc.decode.coarse", 0.351, 0.38),
    ("pcgc.decode.retry", 0.42, 0.62),
    ("pcgc.decode.fetch", 0.62, 0.64),
    ("pcgc.decode.host_extract", 0.64, 0.69),
], device=[(0.1, 0.15), (0.14, 0.17), (0.3, 0.4), (0.6, 0.61)])

# one call; the device busy in [0.05, 0.15) and [0.5, 0.85)
TRAIN = _trace(host=[
    ("bench.stretch", 0.0, 1.0),
    ("bench.train_scanned", 0.0, 1.0),
    ("pcgc.train.call", 0.0, 1.0),
    ("pcgc.train.collate", 0.01, 0.03),
    ("pcgc.train.upload", 0.03, 0.04),
    ("pcgc.train.first_step", 0.04, 0.2),
    ("pcgc.train.capture", 0.2, 0.5),
    ("pcgc.train.replay", 0.5, 0.55),
    ("pcgc.train.replay", 0.55, 0.6),
    ("pcgc.train.fetch", 0.6, 0.9),
    ("pcgc.train.record", 0.9, 0.92),
    ("pcgc.train.save_model", 0.92, 0.98),
], device=[(0.05, 0.15), (0.5, 0.85)])

# idle inside the parents [0.01, 0.7): 0.69 less 0.18 busy; of it, no
# stage covers [0.01, 0.02), [0.23, 0.24), [0.29, 0.3) and [0.69, 0.7)
CODEC_UNNAMED = 100 * 0.04 / 0.51
# idle inside [0, 1): 0.55; no stage covers [0, 0.01) and [0.98, 1)
TRAIN_UNNAMED = 100 * 0.03 / 0.55

CASES = [
    # (unit ms) / 2 frames: 30 + 30 + 10 + 30 + 10 + 50
    ("codec.driver_host_ms", CODEC, 2, 80.0),
    ("codec.rans_ms", CODEC, 2, 20.0),  # 20 + 20
    ("codec.octree_ms", CODEC, 2, 25.0),  # 30 + 20
    # idle in encode.network 10 ms ([0.09, 0.1)), decode.network 20
    # ([0.4, 0.42)), retry 190 (200 less [0.6, 0.61))
    ("model.idle_ms.codec", CODEC, 2, 110.0),
    ("device.idle_unnamed.codec", CODEC, 2, CODEC_UNNAMED),
    ("train.graph_setup_ms", TRAIN, 1, 460.0),  # 160 + 300
    ("train.call_edges_ms", TRAIN, 1, 110.0),  # 20 + 10 + 20 + 60
    ("device.idle_unnamed.train", TRAIN, 1, TRAIN_UNNAMED),
]


@pytest.mark.parametrize("name, tr, units, want", CASES,
                         ids=[c[0] for c in CASES])
def test_reader(name, tr, units, want):
    got = run.load_metric(name)(SimpleNamespace(trace=tr,
                                                stretch_units=units))
    assert got == pytest.approx(want, abs=US)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_none_without_the_programs_spans(name):
    """The parent commit's trace: the benchmark's spans and aten ops
    only."""
    tr = _trace(host=[("bench.stretch", 0.0, 1.0),
                      ("bench.encode", 0.0, 0.4),
                      ("bench.train_scanned", 0.0, 0.4),
                      ("aten::copy_", 0.1, 0.2)],
                device=[(0.1, 0.3)])
    assert run.load_metric(name)(SimpleNamespace(trace=tr,
                                                 stretch_units=1)) is None


def test_spans_clipped_to_the_stretch_and_busy_parents_read_zero():
    tr = _trace(host=[("pcgc.decode", 0.0, 0.2),
                      ("pcgc.decode.network", 0.05, 0.3)],
                device=[(0.0, 0.2)], t1=0.2)
    rec = SimpleNamespace(trace=tr, stretch_units=1)
    assert run.load_metric("model.idle_ms.codec")(rec) == 0.0
    assert run.load_metric("device.idle_unnamed.codec")(rec) == 0.0
