"""Of the device-idle time inside the port's `pcgc.train.call` span in the
traced call, the share that none of its stage spans covers, in %: what
the trainer's tracing cannot name yet."""

from h100bench.spans import unnamed_idle_pct


def read(rec):
    return unnamed_idle_pct(rec, ("pcgc.train.call",))
