"""A run driven on the CPU at a small size, its chip look skipped, with
the timed path broken underneath: `correct` comes out false for each
fault a cell can have, and true for the unbroken path.  The compute is
float32 here, where the port matches the reference to round-off, so that
only the fault can fail the comparison.  (One chip: no exchange between
chips to leave out.)"""

import numpy as np
import pytest

from h100bench.tests.smallrun import small_run


def _decoded_altered(driver):
    """Decode answers with 1% of their voxels moved one step."""
    decode = driver.coder.decode

    def broken(*a, **k):
        out = decode(*a, **k).copy()
        n = max(1, len(out) // 100)
        out[:n, 0] += 1
        return out

    driver.coder.decode = broken


def _stream_altered(driver):
    """Latents altered where they are coded: 5% of the entries off by 1."""
    fc = driver.coder.feature_coder
    encode = fc.encode

    def broken(feats, postfix=""):
        f = np.array(feats, copy=True)
        f.reshape(-1)[::20] += 1.0
        return encode(f, postfix)

    fc.encode = broken


def _state_unchanged(driver):
    """Steps that leave the parameters as they were."""
    driver.trainer.optimizer.step = lambda *a, **k: None


def _half_batch(driver):
    """Half of every batch left out, the mean taken over the rest."""
    tr = driver.trainer
    train_scanned = tr.train_scanned

    def broken(batches, mode=None):
        return train_scanned([b[:max(1, len(b) // 2)] for b in batches],
                             mode=mode)

    tr.train_scanned = broken


@pytest.mark.parametrize("cell,fault", [
    ("codec-vox10-f32", None),
    ("codec-vox10-f32", _decoded_altered),
    ("codec-vox10-f32", _stream_altered),
    ("train-bf16", None),
    ("train-bf16", _state_unchanged),
    ("train-bf16", _half_batch),
], ids=["codec-sound", "codec-decoded-altered", "codec-stream-altered",
        "train-sound", "train-state-unchanged", "train-half-batch"])
def test_fault_is_caught(capsys, cell, fault):
    rc, res = small_run(capsys, cell, fault=fault, compute_dtype="float32")
    assert rc == 0 and res is not None
    assert res["correct"] is (fault is None), res["checks"]
    assert list(res)[-1] == "checks"
