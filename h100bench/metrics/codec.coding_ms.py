"""Host ms per frame in the codec's byte-level coding: the benchmark's
spans around the `Coder`'s `feature_coder` and `coordinate_coder` calls
(rANS, CDF quantization, octree), encode and decode, mean over the
window's unprofiled frames."""

from h100bench.readers import unprofiled


def read(rec):
    v = unprofiled(rec, "coding_s")
    return 1e3 * sum(v) / len(v) if v else None
