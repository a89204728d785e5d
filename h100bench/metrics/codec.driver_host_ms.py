"""Host ms per frame in the codec driver's own stages, from the port's
spans (`pcgcv2_torch/codec/coder.py`): `pcgc.encode.unique_rows`,
`.block_counts`, `.upload`, `.order`, `pcgc.decode.unpack` and
`.host_extract`, summed over the traced stretch."""

from h100bench.spans import ms_per_unit

NAMES = ("pcgc.encode.unique_rows", "pcgc.encode.block_counts",
         "pcgc.encode.upload", "pcgc.encode.order", "pcgc.decode.unpack",
         "pcgc.decode.host_extract")


def read(rec):
    return ms_per_unit(rec, NAMES)
