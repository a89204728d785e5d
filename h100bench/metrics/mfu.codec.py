"""Model FLOP of the traced frames (every conv of the published
architecture, encode and decode, counted by `work.py`) over the stretch's
wall and the chip's peak in the compute dtype, in %."""

from h100bench.readers import mfu


def read(rec):
    return mfu(rec)
