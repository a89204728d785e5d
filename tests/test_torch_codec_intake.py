"""The codec's frame intake on the device (`Coder._intake`,
`device_block_counts`), on the CPU: one upload of the raw rows, the
sorted-unique check, the dedup only where a frame needs it, and the four
block counts, each equal to the host reference (`unique_rows`,
`block_counts`) to the integer, since the counts go into
`_num_points.bin`.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pcgcv2_torch import config as TCFG
from pcgcv2_torch.checkpoint import params_to_jax
from pcgcv2_torch.codec.coder import Coder, block_counts, device_block_counts
from pcgcv2_torch.data.synthetic import sphere_cloud, torus_cloud
from pcgcv2_torch.data.voxelize import unique_rows
from pcgcv2_torch.models.pcc import PCCModel
from tests._tiny import TINY_MODEL

TINY = TCFG.ModelConfig(**dataclasses.asdict(TINY_MODEL))
RES = 256


@pytest.fixture(scope="module")
def coder(tmp_path_factory):
    model = PCCModel(TINY)
    model.init_weights(torch.Generator().manual_seed(0))
    return Coder(params_to_jax(model),
                 str(tmp_path_factory.mktemp("intake") / "frame"), res=RES,
                 model_config=TINY, device="cpu")


def _sparse(res, n, seed):
    """n uniform random voxels of a res^3 box: one a block, nearly."""
    rng = np.random.default_rng(seed)
    return unique_rows(rng.integers(0, res, (n, 3)))


# densities that keep every cloud near 10^4-10^5 points
CLOUDS = {
    ("sphere", 64): lambda: sphere_cloud(64, density=1.0, seed=1),
    ("torus", 64): lambda: torus_cloud(64, density=1.0, seed=2),
    ("sphere", 256): lambda: sphere_cloud(256, density=0.3, seed=3),
    ("torus", 256): lambda: torus_cloud(256, density=0.3, seed=4),
    ("sphere", 2048): lambda: sphere_cloud(2048, density=0.01, seed=5),
    ("torus", 2048): lambda: torus_cloud(2048, density=0.01, seed=6),
    # a 512^3 block grid at 16^3 blocks: past the dense pyramid's 256^3
    ("sparse", 8192): lambda: _sparse(8192, 20000, 7),
}


@pytest.mark.parametrize("kind, res", list(CLOUDS))
def test_device_counts_equal_host(kind, res):
    cloud = CLOUDS[kind, res]()
    got = device_block_counts(torch.from_numpy(cloud), res).tolist()
    assert tuple(got) == block_counts(unique_rows(cloud))
    assert got[0] > got[3] > 0


def _frame(name):
    cloud = sphere_cloud(RES, density=0.3, seed=11)
    return {
        "empty": np.zeros((0, 3), np.int32),
        "single": cloud[:1],
        "sorted": cloud,
        "unsorted": np.concatenate([cloud[::-1], cloud[::7]]),
        "int64": cloud.astype(np.int64),
        "strided": np.asfortranarray(cloud),
    }[name]


@pytest.mark.parametrize("name, dedup", [
    ("empty", 0), ("single", 0), ("sorted", 0), ("unsorted", 1),
    ("int64", 0), ("strided", 0)])
def test_intake_rows_counts_and_dedups(coder, name, dedup):
    """Rows as `unique_rows` gives them, after a batch column of zeros;
    every row valid; the host's counts; a dedup only for the frame that
    is not sorted-unique."""
    frame = _frame(name)
    before = coder.intake_dedups
    rows, valid, counts = coder._intake(frame)
    want = unique_rows(frame)
    assert rows.dtype == torch.int32 and rows.shape == (len(want), 4)
    np.testing.assert_array_equal(rows[:, 1:].numpy(), want)
    assert not rows[:, 0].any()
    assert valid.dtype == torch.bool and valid.all()
    assert len(valid) == len(want)
    assert counts == block_counts(want)
    assert coder.intake_dedups - before == dedup


def test_staging_buffer_reused_and_grown(coder):
    """A smaller frame after a larger one reads its own rows from the
    shared staging buffer; a larger one grows it at least twofold."""
    big = sphere_cloud(RES, density=0.5, seed=12)
    small = torus_cloud(RES, density=0.3, seed=13)
    for frame in (big, small, big):
        rows, _, _ = coder._intake(frame)
        np.testing.assert_array_equal(rows[:, 1:].numpy(), frame)
    size = coder._staging.numel()
    assert size >= big.size
    bigger = np.concatenate([big, big])
    coder._intake(bigger)
    assert coder._staging.numel() >= max(bigger.size, 2 * size)
