"""conv3 weight gradient (`csrc/conv3_wgrad.cu`): the least time of the
traced call's 3^3 weight-gradient work over those kernels' device time,
in %."""

from h100bench.readers import roofline

PATTERNS = ("wgrad_",)


def read(rec):
    return roofline(rec, PATTERNS, ("dw",))
