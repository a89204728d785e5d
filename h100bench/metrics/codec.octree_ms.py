"""Host ms per frame in the coordinate coder (`CoordinateCoder.encode` /
`.decode`: octree or tmc3, file I/O), from the port's `pcgc.octree.*`
spans in the traced stretch."""

from h100bench.spans import ms_per_unit

NAMES = ("pcgc.octree.encode", "pcgc.octree.decode")


def read(rec):
    return ms_per_unit(rec, NAMES)
