"""90th percentile of `Coder.encode` wall (host clock, ms) over the
window's unprofiled frames."""

from h100bench.readers import percentile, unprofiled


def read(rec):
    v = percentile(unprofiled(rec, "encode_s"), 90)
    return None if v is None else 1e3 * v
