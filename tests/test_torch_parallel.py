"""The port's multi-process paths (pcgcv2_torch/parallel/) against the JAX
package's shard_map twins, on the CPU: 2 ranks spawned with
torch.multiprocessing, joined over gloo through a file store, the tiny
test model (tests/_tiny.py).

* the global top-k (`topk_mask(group=...)`) against the single-process
  top-k and JAX's `topk_mask(psum_axis=...)` on a 2-device mesh, ties
  included, with the mesh helpers' collectives;
* `collate_on_device` / `pad_batch` against JAX's;
* one DP step against JAX's per-shard value_and_grad averaged over the
  shards (the replica of tests/test_parallel.py, JAX's fold_in(rng, r)
  noise handed to rank r), against the port's own single-process replica,
  and at one rank against `Trainer.step`;
* the spatial decode against JAX's `make_spatial_decode_fn` on a 2-device
  mesh (tests/test_spatial.py's set-up) and the monolithic decode;
* the entry points raising without a card.

The ranks import this module by name, so JAX and pcgcv2_tpu are imported
only inside the fixtures and tests that run in the parent process.  Each
group of ranks is spawned once per module (a module fixture), and its
results are checked by several tests.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from pcgcv2_torch import checkpoint as TC
from pcgcv2_torch import config as TCFG
from pcgcv2_torch.ops import blocks as TB
from pcgcv2_torch.ops import collectives as TCOL
from pcgcv2_torch.parallel import mesh as TM
from pcgcv2_torch.parallel import spatial as TS
from pcgcv2_torch.parallel import train as TP
from pcgcv2_torch.train import loss as TL
from pcgcv2_torch.train import trainer as TT

N_RANKS = 2
# the training plan and step of tests/test_torch_train.py
TPLAN_ARGS = dict(res=32, nb=(24, 8, 8, 8), dec_nb=(8, 8, 24))
ALPHA, BETA, LR = 2.0, 1.0, 1e-3
ITEM_CAP = 1024
# f32 against JAX: the loss within 1e-5 (relative), every averaged
# gradient within 1e-4 of its max |g| (the single-step tolerances of
# tests/test_torch_train.py); against the port's own replica the same
# arithmetic in the same order: 1e-6 of max |p|
TOL_LOSS, TOL_GRAD, TOL_REPLICA = 1e-5, 1e-4, 1e-6
# tests/test_spatial.py's set-up (res 64, its narrow model, a seeded
# sphere), with a sphere of 48 voxels: test_spatial's sphere of 24 lies in
# the first stride-2 block, so a rank of a 2-way split would own nothing.
# The plan is the codec's exact fit for the frame (BlockPlan.for_frame):
# the port's plain CPU ops scale with the caps.
SP_RES, SP_SPHERE = 64, 48
SP_CFG_ARGS = dict(enc_channels=(1, 8, 16, 16, 16, 8),
                   dec_channels=(8, 16, 16, 8), blocks_per_scale=1)
SP_OUT_CAP = 8192


@pytest.fixture(autouse=True, scope="module")
def _production_dtypes():
    """f32 as in production (tests/test_trainer.py); TF32 off."""
    import jax

    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    jax.config.update("jax_enable_x64", old)


def _join(rank, world, init):
    torch.set_num_threads(1)
    return TM.init_group(rank, world, init, device="cpu")[0]


def _np_tree(tree):
    return {k: np.asarray(v) for k, v in TC.flatten(tree).items()}


# ---------------------------------------------------------------------------
# (a) The global top-k and the collectives
# ---------------------------------------------------------------------------

TOPK_RES, TOPK_NB = 64, 160
# (scores seed, k per batch item, x-block split of the two ranks); the
# scores take 4 values, so every threshold has many ties on both ranks
TOPK_CASES = [
    (0, (700, 300), (0, 2, 4)),
    (1, (0, 450), (0, 2, 4)),          # k = 0 keeps nothing
    (2, (10 ** 6, 1), (0, 1, 4)),      # k >= live keeps every live slot
    (3, (1234, 2345), (0, 3, 4)),
    (4, (1, 0), (0, 2, 4)),
]


def _topk_inputs(seed):
    """Two batch items of random voxels in a 64^3 box (both ranks and JAX
    build the same grid from these rows), and 4-level scores."""
    rng = np.random.RandomState(seed)
    rows = np.concatenate([
        np.concatenate([np.full((n, 1), b), rng.randint(0, TOPK_RES, (n, 3))],
                       axis=1) for b, n in ((0, 1500), (1, 900))
    ]).astype(np.int32)
    scores = rng.randint(-2, 2, (TOPK_NB, TB.VOL)).astype(np.float32)
    return rows, scores


def _port_grid(rows):
    n = len(rows)
    return TB.blockify(torch.from_numpy(rows), torch.ones(n, 1),
                       torch.ones(n, dtype=torch.bool), TOPK_NB, stride=1,
                       res=TOPK_RES, num_batches=2)


def _slab(bg, split, r):
    bx = bg.coords[:, 1]
    return ((bx >= split[r]) & (bx < split[r + 1]))[:, None]


def _collectives_rank(rank, world, init):
    group = _join(rank, world, init)
    try:
        keeps = []
        for seed, k, split in TOPK_CASES:
            rows, scores = _topk_inputs(seed)
            bg = _port_grid(rows)
            keeps.append(TB.topk_mask(
                bg, torch.from_numpy(scores), torch.tensor(k),
                live_mask=_slab(bg, split, rank), group=group).numpy())
        t = torch.arange(6, dtype=torch.int64).reshape(2, 3) + 10 * rank
        mean = [torch.full((3,), float(rank)), torch.full((2, 2), 2.0 * rank)]
        TM.all_reduce_mean_(mean, group)
        bcast = [torch.full((4,), float(rank + 1))]
        TM.broadcast_(bcast, group, src=1)
        return {"keeps": keeps, "gather": TCOL.all_gather(t, group).numpy(),
                "sum": TCOL.all_reduce_sum(t, group).numpy(),
                "mean": [m.numpy() for m in mean],
                "bcast": bcast[0].numpy()}
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def collectives():
    return TM.spawn(_collectives_rank, N_RANKS)


@pytest.fixture(scope="module")
def jax_topk():
    """JAX's topk_mask(psum_axis=...) under shard_map on 2 of the
    conftest's virtual devices: per case, [2, nb_cap, VOL] keeps."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from pcgcv2_tpu.ops import blocks as JB
    from pcgcv2_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(N_RANKS, "sp")
    out = []
    for seed, k, split in TOPK_CASES:
        rows, scores = _topk_inputs(seed)
        n = len(rows)
        bg = JB.blockify(jnp.asarray(rows), jnp.ones((n, 1)),
                         jnp.ones((n,), bool), TOPK_NB, stride=1,
                         res=TOPK_RES, num_batches=2)
        bounds = jnp.asarray(split, jnp.int32)

        def local(bg, s, nums, bounds=bounds):
            i = jax.lax.axis_index("sp")
            bx = bg.coords[:, 1]
            lm = ((bx >= bounds[i]) & (bx < bounds[i + 1]))[:, None]
            return JB.topk_mask(bg, s, nums, live_mask=lm,
                                psum_axis="sp")[None]

        fn = jax.jit(shard_map(local, mesh=mesh, in_specs=(P(), P(), P()),
                               out_specs=P("sp"), check_vma=False))
        out.append(np.asarray(fn(bg, jnp.asarray(scores),
                                 jnp.asarray(k, jnp.int32))))
    return out


@pytest.mark.parametrize("case", range(len(TOPK_CASES)))
def test_global_topk_matches_single_process_and_jax(collectives, jax_topk,
                                                   case):
    """Each rank keeps exactly JAX's psum_axis keep set on its slab, and
    the union is exactly the single-process top-k of the whole grid."""
    seed, k, split = TOPK_CASES[case]
    rows, scores = _topk_inputs(seed)
    bg = _port_grid(rows)
    whole = TB.topk_mask(bg, torch.from_numpy(scores), torch.tensor(k))
    keeps = [c["keeps"][case] for c in collectives]
    for r in range(N_RANKS):
        np.testing.assert_array_equal(keeps[r], jax_topk[case][r],
                                      err_msg=f"rank {r}")
        assert not (keeps[r] & ~_slab(bg, split, r).numpy()).any()
    np.testing.assert_array_equal(keeps[0] | keeps[1], whole.numpy())
    live = (bg.mask & bg.valid[:, None]).numpy()
    per_item = [(whole.numpy() & live & (bg.coords[:, :1] == b).numpy()
                 ).sum() for b in range(2)]
    # k is clamped to the live slots of each item
    for b in range(2):
        n_live = (live & (bg.coords[:, :1] == b).numpy()).sum()
        assert per_item[b] == min(k[b], n_live)


def test_collective_helpers(collectives):
    """SUM all-reduce, all-gather in rank order, the flat mean and the
    broadcast from a chosen source rank, on every rank."""
    t = [np.arange(6).reshape(2, 3) + 10 * r for r in range(N_RANKS)]
    for c in collectives:
        np.testing.assert_array_equal(c["gather"], np.stack(t))
        np.testing.assert_array_equal(c["sum"], t[0] + t[1])
        np.testing.assert_array_equal(c["mean"][0], np.full(3, 0.5))
        np.testing.assert_array_equal(c["mean"][1], np.full((2, 2), 1.0))
        np.testing.assert_array_equal(c["bcast"], np.full(4, 2.0))


def _failing_rank(rank, world, init):
    if rank == 1:
        raise ValueError("rank 1 fails")
    return rank


def test_spawn_raises_when_a_rank_fails():
    with pytest.raises(Exception, match="rank 1 fails"):
        TM.spawn(_failing_rank, N_RANKS)


# ---------------------------------------------------------------------------
# (b) Collate
# ---------------------------------------------------------------------------


def test_collate_and_pad_batch_match_jax():
    import jax.numpy as jnp

    from pcgcv2_tpu.data.synthetic import sphere_cloud
    from pcgcv2_tpu.parallel import train as JP

    clouds = [sphere_cloud(24, 1.0, s) for s in range(3)]
    clouds[1] = clouds[1][:500]
    for cap in (ITEM_CAP, 600):  # 600 cuts the longer clouds
        coords, counts = TP.pad_batch(clouds, cap)
        jc, jn = JP.pad_batch(clouds, cap)
        np.testing.assert_array_equal(coords, jc)
        np.testing.assert_array_equal(counts, jn)
        assert coords.dtype == jc.dtype and counts.dtype == jn.dtype
        rows, valid = TP.collate_on_device(torch.from_numpy(coords),
                                           torch.from_numpy(counts))
        jr, jv = JP.collate_on_device(jnp.asarray(coords),
                                      jnp.asarray(counts))
        np.testing.assert_array_equal(rows.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))
        assert rows.dtype == torch.int32 and valid.dtype == torch.bool


# ---------------------------------------------------------------------------
# (c, d) One DP step
# ---------------------------------------------------------------------------


def _dp_batch():
    from pcgcv2_torch.data.synthetic import sphere_cloud

    return TP.pad_batch([sphere_cloud(24, 1.0, s) for s in range(N_RANKS)],
                        ITEM_CAP)


def _port_model(tree, cfg, num_batches):
    model = TC.params_from_jax(tree, cfg, device="cpu")
    model.num_batches = num_batches
    return model


def _dp_rank(rank, world, init, tree, cfg, noise):
    group = _join(rank, world, init)
    try:
        coords, counts = _dp_batch()
        model = _port_model(tree, cfg, len(coords) // world)
        opt = TT.make_optimizer(model.parameters(), LR, 1e-4)
        step = TP.make_dp_train_step(model, opt, group, ALPHA, BETA,
                                     TCFG.BlockPlan(**TPLAN_ARGS),
                                     device="cpu")
        loss, dropped = step(torch.from_numpy(coords),
                             torch.from_numpy(counts),
                             noise=torch.from_numpy(noise[rank]))
        named = dict(model.named_parameters())
        return {"loss": loss.item(), "dropped": int(dropped),
                "grads": {k: p.grad.numpy() for k, p in named.items()},
                "params": {k: p.detach().numpy() for k, p in named.items()}}
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def dp_case():
    """JAX's replica of the DP step on the tiny model (one cloud per
    shard): per-shard value_and_grad with the rng key fold_in(rng, r),
    averaged; the port's 2-rank step from the same parameters, rank r
    given the noise JAX draws from that key."""
    import jax
    import jax.numpy as jnp

    from pcgcv2_tpu import config as JCFG
    from pcgcv2_tpu.models import PCCModel as JPCC
    from pcgcv2_tpu.ops import blocks as JB
    from pcgcv2_tpu.parallel.train import collate_on_device
    from pcgcv2_tpu.train import loss as JL
    from tests._tiny import TINY_MODEL

    plan = JCFG.BlockPlan(**TPLAN_ARGS)
    model = JPCC(config=TINY_MODEL, plan=plan, num_batches=1)
    coords, counts = _dp_batch()
    coords, counts = jnp.asarray(coords), jnp.asarray(counts)
    rows0, valid0 = collate_on_device(coords[:1], counts[:1])
    kp, kn = jax.random.split(jax.random.PRNGKey(3))
    params = jax.jit(lambda a, b: model.init(
        {"params": a, "noise": b}, rows0, valid0, True))(kp, kn)

    @jax.jit
    def shard_loss_and_grads(p, c, n, key):
        rows, valid = collate_on_device(c, n)

        def loss_fn(pp):
            out = model.apply(pp, rows, valid, True, key)
            return JL.rd_loss(out, ALPHA, BETA, "train")["loss"]

        return jax.value_and_grad(loss_fn)(p)

    # Not tests/test_parallel.py's PRNGKey(7).  Under its shard-0 draw one
    # relu input (decoder.up2's output, block row 6, slot 858, channel 0)
    # lies within f32 rounding of 0 on opposite sides in the two programs:
    # -4.47e-10 in JAX, +8.59e-10 in the port.  The relu passes its
    # gradient in one program only, and the averaged gradients differ by
    # 2.93e-3 of max |g| (decoder.up2.kernel).  With the noise scaled by
    # (1 + 3e-7) the input is negative in both (-9.54e-9 and -8.86e-9) and
    # the gradients agree within 3.31e-6 of max |g|; JAX's own gradient
    # moves by 2.48e-6 under that nudge, the port's by 2.93e-3.  Under
    # PRNGKey(0) the programs agree within 3.51e-6 with no nudge.
    # tests/torch_dp_seed_witness.py prints these numbers.
    rng = jax.random.PRNGKey(0)
    losses, grads, noise = [], [], []
    for r in range(N_RANKS):
        key = jax.random.fold_in(rng, r)
        loss, g = shard_loss_and_grads(params, coords[r:r + 1],
                                       counts[r:r + 1], key)
        losses.append(float(loss))
        grads.append(_np_tree(g["params"]))
        noise.append(np.array(jax.random.uniform(
            key, (plan.nb[3] * JB.VOL, TINY_MODEL.enc_channels[-1]),
            jnp.float32, -0.5, 0.5)))
    tree = jax.tree.map(np.asarray, params)
    cfg = TCFG.ModelConfig(**dataclasses.asdict(TINY_MODEL))
    ranks = TM.spawn(_dp_rank, N_RANKS, tree, cfg, noise)
    return dict(tree=tree, cfg=cfg, noise=noise, ranks=ranks,
                loss=np.mean(losses),
                grads={k: sum(g[k] for g in grads) / N_RANKS
                       for k in grads[0]})


def test_dp_step_matches_jax(dp_case):
    """The averaged loss within 1e-5 and every averaged gradient within
    1e-4 of its max |g| of JAX's replica, on both ranks; nothing
    dropped."""
    for r, out in enumerate(dp_case["ranks"]):
        assert out["dropped"] == 0
        np.testing.assert_allclose(out["loss"], dp_case["loss"],
                                   rtol=TOL_LOSS, err_msg=f"rank {r}")
        assert sorted(out["grads"]) == sorted(dp_case["grads"])
        for k, g in dp_case["grads"].items():
            scale = np.abs(g).max()
            assert scale > 0, k
            np.testing.assert_allclose(out["grads"][k], g, rtol=0,
                                       atol=TOL_GRAD * scale,
                                       err_msg=f"rank {r} {k}")


def test_dp_step_matches_the_port_replica(dp_case):
    """The ranks' updated parameters are identical to each other and
    equal, within 1e-6 of max |p|, one Adam step of the per-shard
    gradients averaged by hand in one process."""
    coords, counts = _dp_batch()
    plan = TCFG.BlockPlan(**TPLAN_ARGS)
    model = _port_model(dp_case["tree"], dp_case["cfg"], 1)
    named = dict(model.named_parameters())
    total = {k: torch.zeros_like(p) for k, p in named.items()}
    for r in range(N_RANKS):
        rows, valid = TP.collate_on_device(
            torch.from_numpy(coords[r:r + 1]),
            torch.from_numpy(counts[r:r + 1]))
        out = model(rows, valid, plan, training=True,
                    noise=torch.from_numpy(dp_case["noise"][r]))
        model.zero_grad(set_to_none=True)
        TL.rd_loss(out, ALPHA, BETA, "train")["loss"].backward()
        for k, p in named.items():
            total[k] += p.grad
    for k, p in named.items():
        p.grad = total[k] / N_RANKS
    TT.make_optimizer(model.parameters(), LR, 1e-4).step()
    ranks = dp_case["ranks"]
    for k, p in named.items():
        ref = p.detach().numpy()
        np.testing.assert_array_equal(ranks[0]["params"][k],
                                      ranks[1]["params"][k], err_msg=k)
        np.testing.assert_allclose(ranks[0]["params"][k], ref, rtol=0,
                                   atol=TOL_REPLICA * np.abs(ref).max(),
                                   err_msg=k)
        np.testing.assert_allclose(ranks[0]["grads"][k],
                                   (total[k] / N_RANKS).numpy(), rtol=0,
                                   atol=TOL_REPLICA * np.abs(ref).max(),
                                   err_msg=k)


def _one_rank_rank(rank, world, init, ckpt, cfg, workdir):
    """Trainer.step and a one-rank DP step from one checkpoint and seed."""
    group = _join(rank, world, init)
    try:
        from pcgcv2_torch.data.synthetic import sphere_cloud

        plan = TCFG.BlockPlan(**TPLAN_ARGS)
        clouds = [sphere_cloud(24, 1.0, s) for s in range(N_RANKS)]
        tr = TT.Trainer(TCFG.TrainConfig(alpha=ALPHA, beta=BETA, lr=LR,
                                         batch_size=N_RANKS),
                        plan, N_RANKS * ITEM_CAP, cfg,
                        logdir=f"{workdir}/l", ckptdir=f"{workdir}/c",
                        init_ckpt=ckpt, seed=5, device="cpu")
        d, _, _ = tr.step(*tr._collate(clouds))
        model = _port_model(TC.load_params(ckpt), cfg, N_RANKS)
        step = TP.make_dp_train_step(
            model, TT.make_optimizer(model.parameters(), LR, 1e-4), group,
            ALPHA, BETA, plan, device="cpu", seed=5)
        loss, _ = step(*map(torch.from_numpy, TP.pad_batch(clouds,
                                                           ITEM_CAP)))
        return {"trainer": (d["loss"].item(), {
                    k: p.detach().numpy()
                    for k, p in tr.model.named_parameters()}),
                "dp": (loss.item(), {k: p.detach().numpy()
                                     for k, p in model.named_parameters()})}
    finally:
        dist.destroy_process_group()


def test_one_rank_dp_step_is_trainer_step(dp_case, tmp_path):
    """At one rank, with the Trainer's seed, the DP step is Trainer.step:
    the same loss and the same updated parameters, exactly."""
    ckpt = str(tmp_path / "init.ckpt")
    TC.save_params(ckpt, dp_case["tree"])
    (out,) = TM.spawn(_one_rank_rank, 1, ckpt, dp_case["cfg"],
                      str(tmp_path))
    (tl, tp), (dl, dp) = out["trainer"], out["dp"]
    assert tl == dl
    assert sorted(tp) == sorted(dp)
    for k in tp:
        np.testing.assert_array_equal(dp[k], tp[k], err_msg=k)


# ---------------------------------------------------------------------------
# (e) The spatial decode
# ---------------------------------------------------------------------------


def _spatial_rank(rank, world, init, tree, cfg, plan, bottleneck):
    group = _join(rank, world, init)
    try:
        model = _port_model(tree, cfg, 1)
        fn = TS.make_spatial_decode_fn(model, plan, group, SP_OUT_CAP,
                                       device="cpu")
        with torch.inference_mode():
            oc, counts, dropped = fn(*map(torch.from_numpy, bottleneck))
        return {"coords": oc.numpy(), "counts": counts.numpy(),
                "dropped": int(dropped)}
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def spatial_case():
    """tests/test_spatial.py's frame and model through JAX's encoder; JAX's
    2-device spatial decode and its monolithic decode; the port's 2-rank
    spatial decode of the same bottleneck."""
    import jax
    import jax.numpy as jnp

    from pcgcv2_tpu.config import BlockPlan, ModelConfig
    from pcgcv2_tpu.data.synthetic import sphere_cloud
    from pcgcv2_tpu.data.voxelize import collate
    from pcgcv2_tpu.models import PCCModel
    from pcgcv2_tpu.ops import blocks as B
    from pcgcv2_tpu.parallel.mesh import make_mesh
    from pcgcv2_tpu.parallel.spatial import make_spatial_decode_fn

    from pcgcv2_torch.codec.coder import block_counts

    cloud = sphere_cloud(SP_SPHERE, density=1.5, seed=3)
    plan = BlockPlan.for_frame(SP_RES, block_counts(cloud))
    jcfg = ModelConfig(**SP_CFG_ARGS)
    coords, valid = collate([cloud], capacity=8192)
    model = PCCModel(config=jcfg, plan=plan, num_batches=1)
    # keys (2, 3): test_spatial's (0, 1) leave this untrained model's
    # stage-1 output in the first x-slab, so rank 1 would decode nothing;
    # here the ranks decode 3023 and 1843 points
    params = jax.jit(lambda c, v: model.init(
        {"params": jax.random.PRNGKey(2), "noise": jax.random.PRNGKey(3)},
        c, v, True))(coords, valid)
    y, nums, _ = jax.jit(lambda p, c, v: model.apply(
        p, c, v, method=PCCModel.encode_fn))(params, coords, valid)
    yc, yf, ny = B.extract(y, 4096)
    ny = int(ny)
    rows = np.zeros((4096, 4), np.int32)
    rows[:ny] = np.asarray(yc)[:ny]
    feats = np.zeros((4096, 8), np.float32)
    feats[:ny] = np.round(np.asarray(yf)[:ny])
    valid_y = np.arange(4096) < ny
    nums = np.concatenate([np.asarray(v) for v in nums]).astype(np.int32)

    yb = B.blockify(jnp.asarray(rows), jnp.asarray(feats),
                    jnp.asarray(valid_y), plan.nb[3], stride=8,
                    res=SP_RES // 8, num_batches=1)
    jn = jnp.asarray(nums)
    oc, _, cnt = jax.jit(lambda p, y, n: B.extract(model.apply(
        p, y, [n[0:1], n[1:2], n[2:3]], method=PCCModel.decode_fn),
        SP_OUT_CAP, with_feats=False))(params, yb, jn)
    mono = np.asarray(oc)[:int(cnt), 1:]

    fn = make_spatial_decode_fn(model, plan, make_mesh(N_RANKS, "sp"),
                                out_cap=SP_OUT_CAP)
    j_oc, j_counts, j_dropped = fn(params, jnp.asarray(rows),
                                   jnp.asarray(feats), jnp.asarray(valid_y),
                                   jn)
    tree = jax.tree.map(np.asarray, params)
    ranks = TM.spawn(_spatial_rank, N_RANKS, tree,
                     TCFG.ModelConfig(**SP_CFG_ARGS),
                     TCFG.BlockPlan(**dataclasses.asdict(plan)),
                     (rows, feats, valid_y, nums))
    return dict(mono=mono, ranks=ranks, j_oc=np.asarray(j_oc),
                j_counts=np.asarray(j_counts), j_dropped=int(j_dropped))


def _segment(coords, counts, r):
    cap = coords.shape[0] // N_RANKS
    return coords[r * cap:r * cap + int(counts[r]), 1:]


def _as_set(a):
    return set(map(tuple, np.asarray(a).tolist()))


def test_spatial_decode_per_rank_matches_jax(spatial_case):
    """Per-rank counts and point sets (in block-scan order) equal JAX's
    per-device ones, the same on both ranks; dropped 0 on both sides."""
    c = spatial_case
    assert c["j_dropped"] == 0
    for out in c["ranks"]:
        assert out["dropped"] == 0
        np.testing.assert_array_equal(out["counts"], c["j_counts"])
        for r in range(N_RANKS):
            np.testing.assert_array_equal(
                _segment(out["coords"], out["counts"], r),
                _segment(c["j_oc"], c["j_counts"], r))
    np.testing.assert_array_equal(c["ranks"][0]["coords"],
                                  c["ranks"][1]["coords"])
    assert all(int(n) > 0 for n in c["j_counts"])  # both slabs decode


def test_spatial_decode_equals_monolithic(spatial_case):
    out = spatial_case["ranks"][0]
    got = TS.assemble_decoded(out["coords"], out["counts"], N_RANKS)
    assert len(got) == len(spatial_case["mono"])
    assert _as_set(got) == _as_set(spatial_case["mono"])


@pytest.mark.parametrize("n", [1, 2, 3, 8, 64])
def test_spatial_caps_are_jax_clamped_to_the_whole_grid(n):
    """JAX's cap formulas (spatial.py:71-73), never above the whole
    frame's caps, and equal to JAX's wherever those are smaller."""
    # the vox11-class frame of chip_smoke.py phase 6b: 3,546,032 voxels
    # in (17726, 4455, 1120, 282) blocks at strides 1, 2, 4, 8
    plan = TCFG.BlockPlan.for_frame(2048, (17726, 4455, 1120, 282))
    out_cap = 3_546_032
    local, sub_in, sub_cand = TS.spatial_caps(plan, n, out_cap)
    j_local = max(256, -(-out_cap // n) * 4)
    j_in = max(32, plan.dec_nb[1] * 4 // n)
    j_cand = plan.up_factors[2] * j_in
    assert (local, sub_in, sub_cand) == (min(j_local, out_cap),
                                         min(j_in, plan.dec_nb[1]),
                                         min(j_cand, plan.up_cap(2)))
    if n == 2:  # JAX's caps are 2x and over 4x the whole grid's
        assert (sub_in, sub_cand) == (plan.dec_nb[1], plan.up_cap(2))
        assert j_in == 2 * sub_in and j_cand > 4 * sub_cand


# ---------------------------------------------------------------------------
# (f) No card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("entry", ["rank_device", "init_group", "dp_step",
                                   "spatial"])
def test_entry_points_raise_without_a_card(entry, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from pcgcv2_torch.models.pcc import PCCModel

    model = PCCModel(TCFG.ModelConfig(**SP_CFG_ARGS))
    call = {
        "rank_device": lambda: TM.rank_device(0),
        "init_group": lambda: TM.init_group(
            0, 1, f"file://{tmp_path}/store"),
        "dp_step": lambda: TP.make_dp_train_step(
            model, TT.make_optimizer(model.parameters(), LR, 1e-4), None,
            ALPHA, BETA, TCFG.BlockPlan(**TPLAN_ARGS)),
        "spatial": lambda: TS.make_spatial_decode_fn(
            model, TCFG.BlockPlan(**TPLAN_ARGS), None, SP_OUT_CAP),
    }[entry]
    with pytest.raises(RuntimeError, match="cuda"):
        call()
    assert not dist.is_initialized()
