"""Share of the traced stretch of frames in which no operation ran on
the device, in %."""

from h100bench.readers import idle_pct


def read(rec):
    return idle_pct(rec)
