"""Of the device-idle time inside the port's `pcgc.encode` and
`pcgc.decode` spans in the traced stretch, the share that none of its
stage spans covers, in %: what the codec's tracing cannot name yet."""

from h100bench.spans import unnamed_idle_pct


def read(rec):
    return unnamed_idle_pct(rec, ("pcgc.encode", "pcgc.decode"))
