"""pcgcv2_torch at 8^3 blocks (PCGC_BLOCK_SIZE=8) on the CPU.

The block side is read when the packages are imported, so the checks run
in one child process, tests/torch_bs8_witness.py, started once by a module
fixture; each test reads one of its checks from the JSON it writes:

* the port's blockify, conv3 (plain), conv_down, conv_up_generative,
  topk_mask and prune against the JAX package's at BS = 8 (structure
  exactly equal, f32 features within 1e-5), conv3 against
  conv3_pallas(interpret=True), and the BlockPlan constructors and
  block_counts against JAX's;
* the port's block ops against the port's per-voxel oracle
  (ops/sparse.py), as tests/test_blocks.py holds JAX's;
* the tiny-model codec: bitstream files equal to JAX's, the decoded sets
  equal, the streams cross-decoding both ways, and the streamed decode in
  3 slabs equal to the monolithic one;
* one training step: the loss within 1e-5 and every gradient leaf within
  1e-4 of its max |g| of JAX's, given JAX's noise.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
CHECKS = (
    "blockify_vs_jax", "conv3_vs_jax", "conv3_vs_pallas_interpret",
    "conv_down_vs_jax", "conv_up_generative_vs_jax", "topk_prune_vs_jax",
    "plans_vs_jax", "conv3_vs_sparse", "conv_down_vs_sparse",
    "conv_up_generative_vs_sparse", "topk_vs_sparse", "isin_vs_sparse",
    "codec_bitstreams_equal", "codec_decoded_equal",
    "cross_decode_jax_to_port", "cross_decode_port_to_jax",
    "streamed_3_slabs", "train_step_vs_jax",
)


@pytest.fixture(scope="module")
def witness(tmp_path_factory):
    out = tmp_path_factory.mktemp("bs8") / "bs8.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PCGC_BLOCK_SIZE="8")
    r = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_bs8_witness.py"),
         str(out)], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=900)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    return json.loads(out.read_text())


def test_witness_ran_every_check(witness):
    assert sorted(witness) == sorted(CHECKS)


@pytest.mark.parametrize("name", CHECKS)
def test_bs8(witness, name):
    r = witness[name]
    assert r["ok"], json.dumps(r, indent=1)
