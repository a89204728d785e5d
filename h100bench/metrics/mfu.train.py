"""Model FLOP of the traced call's steps (forward, input and weight
gradients of every conv, counted by `work.py`) over the call's wall and
the chip's peak in the compute dtype, in %."""

from h100bench.readers import mfu


def read(rec):
    return mfu(rec)
