"""Host ms per `train_scanned` call in the captured graph's set-up: the
eager first step (`pcgc.train.first_step`) and the capture
(`pcgc.train.capture`), from the port's spans in the traced call."""

from h100bench.spans import ms_per_unit

NAMES = ("pcgc.train.first_step", "pcgc.train.capture")


def read(rec):
    return ms_per_unit(rec, NAMES)
