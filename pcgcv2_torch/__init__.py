"""pcgcv2_torch — the PyTorch/CUDA port of the pcgcv2_tpu point-cloud codec.

A second package beside `pcgcv2_tpu` (which stays the reference).  It runs
the single-frame codec (`codec.coder.Coder`: encode -> 4-file bitstream ->
decode, streamed over x-slabs for frames at res >= 2048), the rate-sweep
CLI (`cli.test`) and training (`train.trainer.Trainer`, `cli.train`) on an
NVIDIA Hopper card, with the one TPU kernel of the JAX package (the fused
halo + 3^3 convolution, `pcgcv2_tpu/ops/pallas_conv.py`) rewritten by hand
in CUDA C++: `csrc/conv3_tc.cu` on the tensor cores for every channel pair
the model has (forward, and the input gradient on the flipped weight),
`csrc/conv3.cu` on the CUDA cores for any other, and `csrc/conv3_wgrad.cu`
for the weight gradient.

Rules the package keeps:

* It imports torch and numpy, never jax/flax and nothing of `pcgcv2_tpu`;
  the host modules it needs (config, octree/rANS coding, I/O, metrics)
  are its own copies.
* Entry points run on the card by default (`device="cuda"`) and raise when
  no card is present; the caller asks for the CPU with `device="cpu"`.
* A kernel wrapper runs the plain PyTorch version only for tensors that lie
  on the CPU; a CUDA tensor launches the kernel or raises.

Subpackages mirror the JAX package: ops, models, codec, data, eval, train,
cli, plus csrc (CUDA sources) and native (the host entropy-coding library).
"""

__version__ = "0.1.0"
