"""conv3 forward and input gradient (`csrc/conv3_tc.cu`, the input
gradient on the flipped weight): the least time of the traced call's
forward and input-gradient 3^3 work over those kernels' device time, in %.
The forward is counted once: remat's second forward is the program's
choice, not work the step needs."""

from h100bench.readers import roofline

PATTERNS = ("conv3_tc_kernel", "conv3_kernel")


def read(rec):
    return roofline(rec, PATTERNS, ("fwd", "dx"))
