"""Why tests/test_torch_parallel.py's DP step draws its noise from
PRNGKey(0) and not tests/test_parallel.py's PRNGKey(7): both programs' side
of the one relu input that decides it, read from each program.

    JAX_PLATFORMS=cpu python tests/torch_dp_seed_witness.py

For each key it prints, on the tiny model and the test's batch (one cloud
per shard, shard r's noise drawn from fold_in(key, r)): the gap between the
port's and JAX's shard-averaged gradients (max over tensors of max |d| /
max |g|, the tensor, elements above 1e-4), how far each program's own
gradient moves when the noise is scaled by (1 + 3e-7), and the gap between
the two nudged programs; then, at PRNGKey(7), shard 0's relu input at
decoder.up2's output (block row 6, slot 858, channel 0) in both programs,
with and without the nudge.  Not collected by pytest (about 3 min on the
CPU: four jit compiles of the JAX step).
"""

import dataclasses
import os
import sys
from unittest import mock

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")
jax.config.update("jax_enable_x64", False)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from pcgcv2_torch import config as TCFG  # noqa: E402
from pcgcv2_tpu import config as JCFG  # noqa: E402
from pcgcv2_tpu.models import PCCModel as JPCC  # noqa: E402
from pcgcv2_tpu.ops import blocks as JB  # noqa: E402
from pcgcv2_tpu.parallel.train import collate_on_device  # noqa: E402
from pcgcv2_tpu.train import loss as JL  # noqa: E402
from tests import test_torch_parallel as T  # noqa: E402
from tests._tiny import TINY_MODEL  # noqa: E402

NUDGE = 1 + 3e-7
ELEMENT = (6, 858, 0)  # decoder.up2's output, shard 0 under PRNGKey(7)

torch.set_num_threads(1)
plan = JCFG.BlockPlan(**T.TPLAN_ARGS)
model = JPCC(config=TINY_MODEL, plan=plan, num_batches=1)
coords, counts = (jnp.asarray(a) for a in T._dp_batch())
rows0, valid0 = collate_on_device(coords[:1], counts[:1])
kp, kn = jax.random.split(jax.random.PRNGKey(3))
params = jax.jit(lambda a, b: model.init(
    {"params": a, "noise": b}, rows0, valid0, True))(kp, kn)
tree = jax.tree.map(np.asarray, params)
cfg = TCFG.ModelConfig(**dataclasses.asdict(TINY_MODEL))
uniform = jax.random.uniform


def scaled_uniform(scale):
    return mock.patch.object(jax.random, "uniform",
                             lambda *a, **k: uniform(*a, **k) * scale)


def jax_grads(rng, scale):
    """JAX's shard-averaged gradients, its noise scaled by `scale` (a
    fresh jit, traced under the patch)."""
    @jax.jit
    def shard(p, c, n, key):
        rows, valid = collate_on_device(c, n)

        def loss_fn(pp):
            out = model.apply(pp, rows, valid, True, key)
            return JL.rd_loss(out, T.ALPHA, T.BETA, "train")["loss"]

        return jax.value_and_grad(loss_fn)(p)[1]

    with scaled_uniform(scale):
        gs = [T._np_tree(shard(params, coords[r:r + 1], counts[r:r + 1],
                               jax.random.fold_in(rng, r))["params"])
              for r in range(T.N_RANKS)]
    return {k: sum(g[k] for g in gs) / T.N_RANKS for k in gs[0]}


def port_forward(r, noise, up2_out=None):
    """The port's training forward of shard r; `up2_out` (a list) receives
    decoder.up2's output feats."""
    rows, valid = T.TP.collate_on_device(
        torch.from_numpy(np.array(coords[r:r + 1])),
        torch.from_numpy(np.array(counts[r:r + 1])))
    m = T._port_model(tree, cfg, 1)
    if up2_out is not None:
        m.decoder.up2.register_forward_hook(
            lambda mod, args, out: up2_out.append(out.feats.detach()))
    return m, m(rows, valid, TCFG.BlockPlan(**T.TPLAN_ARGS), training=True,
                noise=torch.from_numpy(noise))


def port_grads(noise):
    """The port's shard-averaged gradients on the given per-shard noise."""
    total = {}
    for r in range(T.N_RANKS):
        m, out = port_forward(r, noise[r])
        T.TL.rd_loss(out, T.ALPHA, T.BETA, "train")["loss"].backward()
        for k, p in m.named_parameters():
            total[k] = total.get(k, 0) + p.grad.numpy() / T.N_RANKS
    return total


def gap(a, b):
    worst, name, n_over = 0.0, None, 0
    for k in b:
        d = np.abs(a[k] - b[k]) / np.abs(b[k]).max()
        n_over += int((d > 1e-4).sum())
        if d.max() > worst:
            worst, name = float(d.max()), k
    return f"{worst:.3g} ({name}, {n_over} elements above 1e-4)"


def noise_of(rng, scale=1.0):
    return [np.array(jax.random.uniform(
        jax.random.fold_in(rng, r),
        (plan.nb[3] * JB.VOL, TINY_MODEL.enc_channels[-1]), jnp.float32,
        -0.5, 0.5)) * np.float32(scale) for r in range(T.N_RANKS)]


def up2_element(scale):
    """(JAX, port) value of ELEMENT of decoder.up2's output (the relu's
    input) on shard 0 under PRNGKey(7), the noise scaled by `scale`."""
    key = jax.random.fold_in(jax.random.PRNGKey(7), 0)
    rows, valid = collate_on_device(coords[0:1], counts[0:1])
    with scaled_uniform(scale):
        _, state = jax.jit(lambda p: model.apply(
            p, rows, valid, True, key, capture_intermediates=True,
            mutable=["intermediates"]))(params)
    j = np.asarray(state["intermediates"]["decoder"]["up2"]["__call__"][0]
                   .feats)[ELEMENT]
    seen = []
    with torch.no_grad():
        port_forward(0, noise_of(jax.random.PRNGKey(7), scale)[0], seen)
    (p,) = seen
    return float(j), float(p[ELEMENT])


def main():
    for key in (7, 0):
        rng = jax.random.PRNGKey(key)
        jg, jgn = jax_grads(rng, 1.0), jax_grads(rng, NUDGE)
        pg, pgn = port_grads(noise_of(rng)), port_grads(noise_of(rng, NUDGE))
        print(f"PRNGKey({key}): port vs JAX {gap(pg, jg)}; JAX moves "
              f"{gap(jgn, jg)} under the nudge, the port {gap(pgn, pg)}; "
              f"nudged port vs nudged JAX {gap(pgn, jgn)}", flush=True)
    for scale in (1.0, NUDGE):
        j, p = up2_element(scale)
        print(f"PRNGKey(7) shard 0, noise x {scale!r}: decoder.up2 output "
              f"{ELEMENT} = {j:.4g} (JAX), {p:.4g} (port)", flush=True)


if __name__ == "__main__":
    main()
