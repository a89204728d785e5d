"""The port's native coordinate extraction (pcgcv2_torch/codec/native.py
::extract_coords) refuses what the C side cannot do right: a `bcoords` of
another shape than [nb, 3], and a count that is not the bits' popcount.
Both checks are raises, so they hold under `python -O` too."""

import subprocess
import sys

import numpy as np
import pytest

from pcgcv2_torch.codec import native
from pcgcv2_torch.ops import blocks as TB


def _packed(seed=0, nb=3):
    """Block coords [nb, 3] and random occupancy bits [nb, VOL // 8]."""
    rng = np.random.RandomState(seed)
    bcoords = rng.randint(0, 4, size=(nb, 3)).astype(np.int32)
    bits = rng.randint(0, 256, size=(nb, TB.VOL // 8)).astype(np.uint8)
    return bcoords, bits


def test_extract_coords_counts_every_bit():
    bcoords, bits = _packed()
    out = native.extract_coords(bcoords, bits, TB._LOG_BS, stride=2)
    assert out.shape == (int(np.unpackbits(bits).sum()), 3)
    per_block = np.unpackbits(bits, axis=1).sum(axis=1).astype(np.int64)
    np.testing.assert_array_equal((out // 2) >> TB._LOG_BS,
                                  np.repeat(bcoords, per_block, axis=0))


@pytest.mark.parametrize("shape", [(3, 4), (2, 3), (9,), (3, 3, 1)])
def test_extract_coords_rejects_bcoords_of_another_shape(shape):
    _, bits = _packed()
    with pytest.raises(ValueError, match="bcoords"):
        native.extract_coords(np.zeros(shape, np.int32), bits, TB._LOG_BS)


@pytest.mark.parametrize("delta", [1, -1])
def test_extract_coords_raises_on_a_count_mismatch(monkeypatch, delta):
    """A popcount the C side cannot meet: one more (it extracts fewer) or
    one less (it runs out of room and returns -1)."""
    lib = native._load()
    real = lib.popcount_bytes
    monkeypatch.setattr(lib, "popcount_bytes",
                        lambda p, n: real(p, n) + delta)
    bcoords, bits = _packed(1)
    with pytest.raises(RuntimeError, match="popcount"):
        native.extract_coords(bcoords, bits, TB._LOG_BS)


def test_extract_coords_raises_under_python_O():
    code = (
        "import numpy as np\n"
        "from pcgcv2_torch.codec import native\n"
        "assert not __debug__\n"
        "lib = native._load()\n"
        "real = lib.popcount_bytes\n"
        "lib.popcount_bytes = lambda p, n: real(p, n) + 1\n"
        "bits = np.full((2, 512), 255, np.uint8)\n"
        "for bc in (np.zeros((2, 4), np.int32), np.zeros((2, 3), np.int32)):\n"
        "    try:\n"
        "        native.extract_coords(bc, bits, 4)\n"
        "    except (ValueError, RuntimeError) as e:\n"
        "        print(type(e).__name__)\n")
    r = subprocess.run([sys.executable, "-O", "-c", code],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["ValueError", "RuntimeError"]
