"""Host ms per `train_scanned` call around its steps: collate
(`pcgc.train.collate`), the copy to the device (`.upload`), the records
(`.record`) and the checkpoint (`.save_model`), from the port's spans in
the traced call."""

from h100bench.spans import ms_per_unit

NAMES = ("pcgc.train.collate", "pcgc.train.upload", "pcgc.train.record",
         "pcgc.train.save_model")


def read(rec):
    return ms_per_unit(rec, NAMES)
