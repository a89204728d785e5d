"""conv3 forward (`csrc/conv3_tc.cu`, `csrc/conv3.cu`): the least time of
the traced frames' 3^3 convs (`work.py`) over those kernels' device time,
in %."""

from h100bench.readers import roofline

PATTERNS = ("conv3_tc_kernel", "conv3_kernel")


def read(rec):
    return roofline(rec, PATTERNS, ("fwd",))
