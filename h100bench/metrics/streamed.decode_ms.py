"""Median `Coder.decode` wall (host clock, ms) over the window's
unprofiled frames: the streamed decode of the vox11 cell."""

from h100bench.readers import percentile, unprofiled


def read(rec):
    v = percentile(unprofiled(rec, "decode_s"), 50)
    return None if v is None else 1e3 * v
