"""Device-idle ms per frame while the port dispatches the network: inside
the union of its `pcgc.encode.network`, `pcgc.decode.network` and
`pcgc.decode.retry` spans in the traced stretch, the time eager dispatch
leaves the device starved."""

from h100bench.spans import idle_ms_per_unit

NAMES = ("pcgc.encode.network", "pcgc.decode.network", "pcgc.decode.retry")


def read(rec):
    return idle_ms_per_unit(rec, NAMES)
