"""Host ms per frame in the feature coder (`FeatureCoder.encode` /
`.decode`: pmf, CDF quantization, rANS, file I/O), from the port's
`pcgc.rans.*` spans in the traced stretch."""

from h100bench.spans import ms_per_unit

NAMES = ("pcgc.rans.encode", "pcgc.rans.decode")


def read(rec):
    return ms_per_unit(rec, NAMES)
