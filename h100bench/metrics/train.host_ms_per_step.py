"""Host ms per training step: the traced `train_scanned` call's wall
less its device-busy time, over its steps."""


def read(rec):
    tr = rec.trace
    steps = rec.stretch_units * rec.steps_per_unit
    return 1e3 * (tr.window_s - tr.busy_s()) / steps if steps else None
