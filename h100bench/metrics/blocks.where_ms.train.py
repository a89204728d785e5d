"""Device ms per training step of the `aten::where` kernels (the
structure ops' masking, `ops/blocks.py`) in the traced call."""

from h100bench.readers import per_unit_ms

PATTERNS = ("where_kernel",)


def read(rec):
    return per_unit_ms(rec, PATTERNS, per_step=True)
