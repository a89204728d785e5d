"""The port's flax-free checkpoint reader must return exactly the tree of
pcgcv2_tpu.train.trainer.load_params, and params_from_jax must load it
into the port's modules leaf for leaf."""

import os

import numpy as np
import pytest
import torch

from pcgcv2_torch.checkpoint import flatten, load_params, params_from_jax
from pcgcv2_tpu.train.trainer import load_params as jax_load_params

ROOT = os.path.join(os.path.dirname(__file__), "..")
CKPTS = ["tests/golden/golden.ckpt", "ckpts/r4/r4_final.ckpt"]


@pytest.mark.parametrize("rel", CKPTS)
def test_reader_matches_flax(rel):
    path = os.path.join(ROOT, rel)
    ours = flatten(load_params(path))
    ref = flatten(jax_load_params(path))
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        got = ours[k]
        assert got.dtype == np.asarray(v).dtype, k
        assert got.shape == np.asarray(v).shape, k
        np.testing.assert_array_equal(got, np.asarray(v), err_msg=k)


def test_params_from_jax_loads_every_leaf():
    tree = load_params(os.path.join(ROOT, CKPTS[0]))
    model = params_from_jax(tree, device="cpu")
    state = model.state_dict()
    flat = flatten(tree["params"])
    assert sorted(state) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(state[k].numpy(), v, err_msg=k)
    assert all(t.device.type == "cpu" for t in state.values())


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tree = load_params(os.path.join(ROOT, CKPTS[0]))
    with pytest.raises(RuntimeError, match="cuda"):
        params_from_jax(tree)
