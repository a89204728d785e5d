"""The training slice of the port against the JAX package on the CPU, f32
(JAX at `highest` matmul precision, torch with TF32 off): structure ops,
the quantizers and the likelihood bound, random init, the loss terms, one
full training step of the tiny test model (forward, loss, every gradient),
remat, the optimizer, checkpoints both ways, batching, the Trainer and the
training CLI.  The conv3 backward alone is tests/test_torch_conv3_grad.py.

The JAX training step is one jit of value_and_grad on tests/_tiny.py's
model at a training plan of res 32 (about half a minute to compile here,
once per module).  The port's plain CPU ops scale with the block caps, so
the plans are small: `TPLAN` leaves headroom past each scale's live blocks,
and the Trainer tests use BlockPlan.for_training's own caps.
"""

import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcgcv2_torch import checkpoint as TC
from pcgcv2_torch import config as TCFG
from pcgcv2_torch.data import dataset as TD
from pcgcv2_torch.data import voxelize as TV
from pcgcv2_torch.models import entropy as TE
from pcgcv2_torch.models.pcc import PCCModel as TPCC
from pcgcv2_torch.ops import blocks as TB
from pcgcv2_torch.ops import conv3 as TK
from pcgcv2_torch.train import loss as TL
from pcgcv2_torch.train import trainer as TT
from pcgcv2_tpu import config as JCFG
from pcgcv2_tpu.data import dataset as JD
from pcgcv2_tpu.data import voxelize as JV
from pcgcv2_tpu.data.io import write_ply_ascii_geo
from pcgcv2_tpu.data.synthetic import sphere_cloud
from pcgcv2_tpu.models import PCCModel as JPCC
from pcgcv2_tpu.models import entropy as JE
from pcgcv2_tpu.ops import blocks as B
from pcgcv2_tpu.train import loss as JL
from pcgcv2_tpu.train import trainer as JT
from tests._tiny import TINY_MODEL

TPLAN_ARGS = dict(res=32, nb=(24, 8, 8, 8), dec_nb=(8, 8, 24))
TINY = TCFG.ModelConfig(**dataclasses.asdict(TINY_MODEL))
# f32, different summation order: logits and gradients over a step of
# ~100 ops deep compose more rounding than one conv (1e-4); the scalar loss
# within 1e-5 (relative)
TOL_LOGITS = 1e-4
TOL_LOSS = 1e-5
TOL_GRAD = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _production_dtypes():
    """f32 as in production: under the suite's x64 flag XLA:CPU's backward
    compiles blow up (tests/test_trainer.py)."""
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.set_num_threads(threads)
    jax.config.update("jax_enable_x64", old)


def _batch():
    return [sphere_cloud(24, 1.0, 0), sphere_cloud(24, 1.0, 1)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _flat_np(tree):
    return {k: np.asarray(v) for k, v in TC.flatten(tree).items()}


# ---------------------------------------------------------------------------
# One JAX training step (module fixture)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_step():
    plan = JCFG.BlockPlan(**TPLAN_ARGS)
    model = JPCC(config=TINY_MODEL, plan=plan, num_batches=2)
    coords, valid = JV.collate(_batch(), capacity=2048)
    kp, kn = jax.random.split(jax.random.PRNGKey(3))
    params = jax.jit(lambda a, b: model.init(
        {"params": a, "noise": b}, coords, valid, True))(kp, kn)

    def loss_fn(p):
        out = model.apply(p, coords, valid, True, kn)
        d = JL.rd_loss(out, 2.0, 1.0, "train")
        return d["loss"], (out, d)

    (_, (out, d)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    noise = jax.random.uniform(kn, (plan.nb[3] * B.VOL, 8), jnp.float32,
                               -0.5, 0.5)
    return dict(coords=coords, valid=valid, params=params, out=out, d=d,
                grads=grads, noise=np.asarray(noise))


def _port_model(params, remat=False):
    cfg = dataclasses.replace(TINY, remat_training=remat)
    model = TC.params_from_jax(jax.device_get(params), cfg, device="cpu")
    model.num_batches = 2
    return model


def _port_step(js, model, alpha=2.0):
    out = model(_t(js["coords"]), _t(js["valid"]),
                TCFG.BlockPlan(**TPLAN_ARGS), training=True,
                noise=_t(js["noise"]))
    d = TL.rd_loss(out, alpha, 1.0, "train")
    model.zero_grad(set_to_none=True)
    d["loss"].backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    return out, d, grads


def _same_structure(j, t, what):
    for name in ("coords", "mask", "table", "count", "dropped"):
        np.testing.assert_array_equal(
            getattr(t, name).numpy(), np.asarray(getattr(j, name)),
            err_msg=f"{what}.{name}")
    assert (t.stride, t.res) == (j.stride, j.res), what


def test_training_step_matches_jax(jax_step):
    """PCCModel.forward(training=True) from the JAX init's params with the
    JAX noise: structure exact, logits within 1e-4, the loss within 1e-5
    and every gradient leaf within 1e-4 of its max |g|."""
    js = jax_step
    out, d, grads = _port_step(js, _port_model(js["params"]))
    jout = js["out"]
    for s in range(3):
        _same_structure(jout["out_cls_list"][s], out["out_cls_list"][s],
                        f"cls{s}")
        _same_structure(jout["ground_truth_list"][s],
                        out["ground_truth_list"][s], f"gt{s}")
        np.testing.assert_array_equal(out["nums_list"][s].numpy(),
                                      np.asarray(jout["nums_list"][s]))
        ref = np.asarray(jout["out_cls_list"][s].feats)
        np.testing.assert_allclose(out["out_cls_list"][s].feats.detach(),
                                   ref, rtol=0,
                                   atol=TOL_LOGITS * np.abs(ref).max())
    _same_structure(jout["out"], out["out"], "out")
    _same_structure(jout["prior"], out["prior"], "prior")
    assert int(out["out"].dropped) == 0
    np.testing.assert_allclose(out["likelihood"].detach(),
                               np.asarray(jout["likelihood"]),
                               rtol=TOL_LOGITS, atol=0)
    for k in ("loss", "bce", "bpp"):
        np.testing.assert_allclose(d[k].item(), float(js["d"][k]),
                                   rtol=TOL_LOSS, err_msg=k)
    ref = _flat_np(js["grads"]["params"])
    assert sorted(ref) == sorted(grads)
    for k, g in ref.items():
        scale = np.abs(g).max()
        assert scale > 0, k
        np.testing.assert_allclose(grads[k].numpy(), g, rtol=0,
                                   atol=TOL_GRAD * scale, err_msg=k)


def test_random_init_matches_jax(jax_step):
    """Constant entropy parameters exactly JAX's init; kernels uniform
    within JAX's bound sqrt(6 / fan_in) (flax fan_in: all but the last
    dimension), both packages reaching it; biases zero; entropy biases in
    (-0.5, 0.5)."""
    model = TPCC(TINY, num_batches=2)
    model.init_weights(torch.Generator().manual_seed(0))
    ours = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    ref = _flat_np(jax_step["params"]["params"])
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        assert ours[k].shape == v.shape, k
        leaf = k.rsplit(".", 1)[1]
        if k.startswith("entropy_bottleneck."):
            if leaf.startswith(("matrix_", "factor_")):
                np.testing.assert_array_equal(ours[k], v, err_msg=k)
            else:
                assert np.abs(ours[k]).max() < 0.5, k
                assert np.abs(v).max() < 0.5, k
        elif leaf == "bias":
            assert not ours[k].any() and not v.any(), k
        else:
            bound = np.sqrt(6.0 / np.prod(v.shape[:-1]))
            for arr in (ours[k], v):
                assert np.abs(arr).max() <= bound, k
                if arr.size >= 512:
                    assert np.abs(arr).max() > 0.9 * bound, k


def test_remat_gives_the_same_gradients(jax_step):
    """torch.utils.checkpoint over encoder scales and decoder stages:
    equal gradients with remat on and off."""
    js = jax_step
    _, d0, g0 = _port_step(js, _port_model(js["params"], remat=False))
    _, d1, g1 = _port_step(js, _port_model(js["params"], remat=True))
    assert d0["loss"].item() == d1["loss"].item()
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=0, atol=0, msg=k)


def test_remat_recomputes_each_forward_once(jax_step, monkeypatch):
    """With remat, a step runs every conv3 forward twice except the final
    encoder conv (outside the checkpointed scales), and one dX per conv
    but the first (its input is data) and one dW per conv: on the full
    model that is 127 forward, 63 dX and 64 dW launches per step."""
    counts = {"fwd": 0, "dx": 0, "dw": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            counts[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(TK, "_conv3", counting("fwd", TK._conv3))
    monkeypatch.setattr(TK, "conv3_dgrad", counting("dx", TK.conv3_dgrad))
    monkeypatch.setattr(TK, "conv3_wgrad", counting("dw", TK.conv3_wgrad))
    n = 13 + 15  # tiny model: 4 per encoder scale + 1, 5 per decoder stage
    for remat, fwd in ((False, n), (True, 2 * n - 1)):
        counts.update(fwd=0, dx=0, dw=0)
        _port_step(jax_step, _port_model(jax_step["params"], remat))
        assert counts == {"fwd": fwd, "dx": n - 1, "dw": n}, (remat, counts)


# ---------------------------------------------------------------------------
# Structure ops, quantizers, loss terms
# ---------------------------------------------------------------------------


def _grid_pair(seeds, nb_cap, stride=1, res=64, ch=1, feat_seed=0,
               shift=0):
    clouds = [sphere_cloud(40, density=1.0, seed=s) + shift for s in seeds]
    coords, valid = JV.collate(clouds, capacity=16384)
    coords[:, 1:] *= stride
    feats = np.random.RandomState(feat_seed).randn(len(coords), ch)
    feats = (feats * valid[:, None]).astype(np.float32)
    args = (nb_cap, stride, res, len(seeds))
    j = B.blockify(jnp.asarray(coords), jnp.asarray(feats), jnp.asarray(valid),
                   *args)
    t = TB.blockify(_t(coords), _t(feats), _t(valid), *args)
    return j, t


@pytest.mark.parametrize("stride", [1, 2])
def test_slot_coords_exact(stride):
    j, t = _grid_pair((3, 4), 64, stride=stride, res=64 * stride)
    np.testing.assert_array_equal(TB.slot_coords(t).numpy(),
                                  np.asarray(B.slot_coords(j)))


@pytest.mark.parametrize("gt_cap", [64, 20])
def test_isin_exact(gt_cap):
    """Membership of one frame's voxels in another's: exact, also where the
    ground truth overflowed its cap (dropped blocks read the sentinel)."""
    jq, tq = _grid_pair((3, 4), 64)
    jg, tg = _grid_pair((3, 5), gt_cap)
    got = TB.isin(tq, tg).numpy()
    np.testing.assert_array_equal(got, np.asarray(B.isin(jq, jg)))
    assert got.any() and (~got & tq.mask.numpy()).any()
    assert (int(tg.dropped) > 0) == (gt_cap == 20)
    assert int(tq.dropped) == 0


def test_isin_table_miss_aliasing_a_block():
    """A table row whose block is not the query block (here a ground-truth
    table made for the same frame shifted by one block) must not count:
    the coords check."""
    jq, tq = _grid_pair((3, 4), 64)
    jg, tg = _grid_pair((3, 4), 64, feat_seed=1)
    jo, to = _grid_pair((3, 4), 64, shift=16)
    jg, tg = jg.replace(table=jo.table), tg.replace(table=to.table)
    got = TB.isin(tq, tg).numpy()
    np.testing.assert_array_equal(got, np.asarray(B.isin(jq, jg)))
    rows = tg.table.long()[TB._flat_block_key(tq.coords, tq.G)]
    alias = (tg.coords[rows] != tq.coords).any(-1) & tq.valid \
        & tg.mask[rows].any(-1)
    assert bool(alias.any())  # some query blocks hit another real block
    assert not got[alias.numpy()].any()


def test_round_ste_and_lower_bound_grads():
    x = np.array([-1.5, -0.5, 0.4, 0.5, 2.5, 1e-12, 0.0, 3e-9, -2.0],
                 dtype=np.float32)
    g = np.array([1.0, -2.0, 3.0, -4.0, 0.5, 2.0, -1.0, 1.0, 0.25],
                 dtype=np.float32)
    for tfn, jfn in ((TE.round_ste, JE.round_ste),
                     (TE.lower_bound, JE.lower_bound)):
        xt = _t(x).requires_grad_(True)
        y = tfn(xt)
        y.backward(_t(g))
        jy, vjp = jax.vjp(jfn, jnp.asarray(x))
        np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jy))
        np.testing.assert_array_equal(xt.grad.numpy(),
                                      np.asarray(vjp(jnp.asarray(g))[0]))
    # the rule: pass where x >= bound or g < 0
    xt = _t(x).requires_grad_(True)
    TE.lower_bound(xt).backward(_t(g))
    want = np.where((x >= TE.LIKELIHOOD_BOUND) | (g < 0), g, 0)
    np.testing.assert_array_equal(xt.grad.numpy(), want)


def test_noise_quantization():
    eb = TE.EntropyBottleneck(8)
    x = torch.zeros(4096, 8)
    y = eb.quantize(x, "noise", generator=torch.Generator().manual_seed(1))
    assert float(y.min()) >= -0.5 and float(y.max()) < 0.5
    assert abs(float(y.mean())) < 0.02
    n = torch.full((4096, 8), 0.25)
    assert torch.equal(eb.quantize(x, "noise", noise=n), n)
    with pytest.raises(ValueError, match="generator"):
        eb.quantize(x, "noise")


def _loss_inputs():
    """cls grids with random logits and ground-truth grids at the same
    scale in both packages, two batch items, and a likelihood array."""
    jc, tc = _grid_pair((3, 4), 64, feat_seed=2)
    jg, tg = _grid_pair((3, 5), 64)
    jg = jg.with_feats(jnp.ones_like(jg.feats))
    tg = tg.with_feats(torch.ones_like(tg.feats))
    lh = np.random.RandomState(1).uniform(1e-3, 1.0, (64, B.VOL, 8))
    return jc, tc, jg, tg, lh.astype(np.float32)


def test_loss_terms_match_jax():
    jc, tc, jg, tg, lh = _loss_inputs()
    np.testing.assert_allclose(float(TL.bce_bits(tc, tg)),
                               float(JL.bce_bits(jc, jg)), rtol=TOL_LOSS)
    np.testing.assert_allclose(float(TL.rate_bits(_t(lh))),
                               float(JL.rate_bits(jnp.asarray(lh))),
                               rtol=TOL_LOSS)
    np.testing.assert_allclose(TL.cls_metrics(tc, tg).numpy(),
                               np.asarray(JL.cls_metrics(jc, jg)),
                               rtol=TOL_LOSS, atol=0)
    for normalize in ("train", "test"):
        tset = {"out_cls_list": [tc] * 3, "ground_truth_list": [tg] * 3,
                "likelihood": _t(lh)}
        jset = {"out_cls_list": [jc] * 3, "ground_truth_list": [jg] * 3,
                "likelihood": jnp.asarray(lh)}
        got = TL.rd_loss(tset, 2.0, 0.5, normalize)
        ref = JL.rd_loss(jset, 2.0, 0.5, normalize)
        for k in ("loss", "bce", "bces", "bpp"):
            np.testing.assert_allclose(np.asarray(got[k]),
                                       np.asarray(ref[k]), rtol=TOL_LOSS,
                                       err_msg=f"{normalize} {k}")


# ---------------------------------------------------------------------------
# Optimizer, checkpoints, configuration, batching
# ---------------------------------------------------------------------------


def test_adam_matches_the_optax_chain():
    """make_optimizer against add_decayed_weights -> scale_by_adam ->
    scale(-lr) over 3 steps of fixed gradients, within 1e-7."""
    rng = np.random.RandomState(0)
    p0 = (rng.randn(64) * 0.1).astype(np.float32)
    grads = [(rng.randn(64) * 0.01).astype(np.float32) for _ in range(3)]
    lr, wd = 8e-4, 1e-4
    tx = JT.make_optimizer(wd)
    jp = {"w": jnp.asarray(p0)}
    state = tx.init(jp)
    state.hyperparams["lr"] = jnp.asarray(lr, jnp.float32)
    tp = torch.nn.Parameter(_t(p0.copy()))
    opt = TT.make_optimizer([tp], lr, wd)
    for g in grads:
        upd, state = tx.update({"w": jnp.asarray(g)}, state, jp)
        jp = jax.tree.map(lambda a, b: a + b, jp, upd)
        tp.grad = _t(g)
        opt.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp["w"]),
                                   rtol=0, atol=1e-7)
    assert np.abs(tp.detach().numpy() - p0).max() > 1e-3


def test_adam_lr_in_place_and_reset_match_optax():
    """The lr written in place between steps (set_lr) against optax's
    injected lr, and the state zeroed in place (reset_optimizer) against
    tx.init, as an epoch boundary does: 2 steps, a reset and a new lr,
    2 more steps, within 1e-7."""
    rng = np.random.RandomState(1)
    p0 = (rng.randn(64) * 0.1).astype(np.float32)
    grads = [(rng.randn(64) * 0.01).astype(np.float32) for _ in range(4)]
    lrs, wd = (8e-4, 8e-4, 4e-4, 4e-4), 1e-4
    tx = JT.make_optimizer(wd)
    jp = {"w": jnp.asarray(p0)}
    state = tx.init(jp)
    tp = torch.nn.Parameter(_t(p0.copy()))
    opt = TT.make_optimizer([tp], 1.0, wd)
    lr_t = opt.param_groups[0]["lr"]
    assert torch.is_tensor(lr_t) and lr_t.dim() == 0
    for i, (g, lr) in enumerate(zip(grads, lrs)):
        if i == 2:
            state = tx.init(jp)
            TT.reset_optimizer(opt)
            assert all(float(v.abs().max()) == 0
                       for v in opt.state[tp].values())
        state.hyperparams["lr"] = jnp.asarray(lr, jnp.float32)
        TT.set_lr(opt, lr)
        assert opt.param_groups[0]["lr"] is lr_t
        upd, state = tx.update({"w": jnp.asarray(g)}, state, jp)
        jp = jax.tree.map(lambda a, b: a + b, jp, upd)
        tp.grad = _t(g)
        opt.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp["w"]),
                                   rtol=0, atol=1e-7, err_msg=f"step {i}")
    assert int(opt.state[tp]["step"]) == 2


def test_checkpoints_cross_both_ways(jax_step, tmp_path):
    """The port's weights-only file is flax's bytes and JAX's load_params
    reads it into its template; the port reads a JAX-written file."""
    model = TPCC(TINY, num_batches=2)
    model.init_weights(torch.Generator().manual_seed(5))
    path = str(tmp_path / "port.ckpt")
    TT.save_params(path, model)
    tree = TC.params_to_jax(model)
    from flax import serialization

    assert open(path, "rb").read() == serialization.to_bytes(tree)
    restored = JT.load_params(path, jax.device_get(jax_step["params"]))
    got = _flat_np(restored)
    want = {f"params.{k}": v.detach().numpy()
            for k, v in model.state_dict().items()}
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)

    jpath = str(tmp_path / "jax.ckpt")
    JT.save_params(jpath, jax_step["params"])
    back = TT.load_params(jpath, TPCC(TINY, num_batches=2))
    for k, v in _flat_np(jax_step["params"]["params"]).items():
        np.testing.assert_array_equal(back.state_dict()[k].numpy(), v,
                                      err_msg=k)


def test_configs_match_jax():
    for args in ((524288, 128, 8), (2048, 32, 2), (100000, 256, 4),
                 (4096, 64, 1)):
        assert dataclasses.asdict(TCFG.BlockPlan.for_training(*args)) == \
            dataclasses.asdict(JCFG.BlockPlan.for_training(*args))
    big = TCFG.BlockPlan.for_training(524288, 128, 8)
    assert big.nb == (4097, 513, 65, 9) and big.dec_nb == (65, 513, 4097)
    assert [big.up_cap(s) for s in range(3)] == [72, 520, 4104]
    assert dataclasses.asdict(TCFG.TrainConfig()) == \
        dataclasses.asdict(JCFG.TrainConfig())
    assert dataclasses.asdict(TCFG.ModelConfig()) == \
        dataclasses.asdict(JCFG.ModelConfig())


def test_collate_and_buckets_match_jax():
    clouds = [sphere_cloud(24, 1.0, s) for s in range(3)]
    for cap in (0, 4096):
        for a, b in zip(TV.collate(clouds, cap), JV.collate(clouds, cap)):
            np.testing.assert_array_equal(a, b)
    for n in (0, 1, 65536, 65537, 10 ** 6):
        assert TV.bucket_capacity(n) == JV.bucket_capacity(n)
    assert TV.bucket_capacity(1000, 256, 1.5) == \
        JV.bucket_capacity(1000, 256, 1.5)
    with pytest.raises(ValueError, match="capacity"):
        TV.collate(clouds, 100)


def test_datasets_and_batch_order_match_jax(tmp_path):
    files = []
    for i in range(7):
        f = str(tmp_path / f"c{i}.ply")
        write_ply_ascii_geo(f, sphere_cloud(16, 1.0, i))
        files.append(f)
    tds, jds = TD.PCDataset(files), JD.PCDataset(files)
    assert len(tds) == len(jds) == 7
    for i in range(7):
        np.testing.assert_array_equal(tds[i], jds[i])
        assert tds[i].dtype == np.int32
    for kw in (dict(shuffle=True, seed=3), dict(shuffle=False),
               dict(shuffle=True, seed=1, drop_last=True)):
        got = list(TD.iterate_batches(tds, 3, **kw))
        ref = list(JD.iterate_batches(jds, 3, **kw))
        assert [len(b) for b in got] == [len(b) for b in ref]
        for bg, br in zip(got, ref):
            for a, b in zip(bg, br):
                np.testing.assert_array_equal(a, b)
    rep = TD.iterate_batches(tds, 3, seed=2, repeat=True)
    assert len([next(rep) for _ in range(7)]) == 7


# ---------------------------------------------------------------------------
# Trainer and the CLI
# ---------------------------------------------------------------------------


def _trainer(tmp, name, **cfg):
    c = TCFG.TrainConfig(**{"batch_size": 2, "check_time": 60.0, "lr": 1e-3,
                            **cfg})
    plan = TCFG.BlockPlan.for_training(2048, 32, 2)
    return TT.Trainer(c, plan, 2048, TINY, logdir=str(tmp / f"l{name}"),
                      ckptdir=str(tmp / f"c{name}"), device="cpu")


def _batches(n=3):
    return [[sphere_cloud(24, 1.0, 2 * i), sphere_cloud(24, 1.0, 2 * i + 1)]
            for i in range(n)]


def test_trainer_epoch_and_checkpoint(tmp_path):
    tr = _trainer(tmp_path, "a")
    tr.train(_batches())
    assert tr.epoch == 1
    (ckpt,) = glob.glob(os.path.join(tr.ckptdir, "*.ckpt"))
    tree = JT.load_params(ckpt)  # the JAX package reads it
    for k, v in _flat_np(tree["params"]).items():
        np.testing.assert_array_equal(tr.model.state_dict()[k].numpy(), v)
    tr.test(_batches(1))
    log = open(os.path.join(tr.logdir, "log.txt")).read()
    assert "Train Epoch 0 Step 3" in log and "Test Epoch 1" in log
    assert "nan" not in log


def test_lr_halving_and_floor(tmp_path):
    tr = _trainer(tmp_path, "b", lr=1e-3, lr_min=3e-4)
    lrs = []
    for _ in range(4):
        tr.train([])
        lrs.append(tr.lr)
    assert lrs == [1e-3, 5e-4, 3e-4, 3e-4]
    tr = _trainer(tmp_path, "c", lr=1e-3, lr_halve_every=2)
    for _ in range(3):
        tr.train([])
    assert tr.lr == 5e-4


@pytest.mark.parametrize("reset", [True, False])
def test_optimizer_reset_each_epoch(tmp_path, reset):
    tr = _trainer(tmp_path, f"d{reset}", reset_optimizer_each_epoch=reset)
    tr.train(_batches(2))
    tr.train(_batches(1))
    steps = {int(s["step"]) for s in tr.optimizer.state.values()}
    assert steps == ({1} if reset else {3})


def test_oversized_batch_is_skipped(tmp_path):
    tr = _trainer(tmp_path, "e")
    big = [sphere_cloud(30, 4.0, 0), sphere_cloud(30, 4.0, 1)]
    assert sum(len(c) for c in big) > tr.capacity
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    tr.train([big])
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert not glob.glob(os.path.join(tr.ckptdir, "*.ckpt"))


def test_save_restore_state_gives_the_same_next_step(tmp_path):
    a = _trainer(tmp_path, "f")
    a.train(_batches(2))
    path = a.save_state()
    b = _trainer(tmp_path, "g")
    b.generator.manual_seed(99)
    b.restore_state(path)
    assert (b.epoch, b.lr) == (a.epoch, a.lr)
    for tr in (a, b):
        tr.train(_batches(1))
    for k, v in a.model.state_dict().items():
        assert torch.equal(b.model.state_dict()[k], v), k
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def _records(tr):
    """Every record() call of `tr`: (tag, step, copy of the record set)."""
    seen, real = [], tr.record

    def record(tag, step):
        seen.append((tag, step, {k: [np.array(v) for v in vs]
                                 for k, vs in tr.record_set.items()}))
        real(tag, step)

    tr.record = record
    return seen


def test_train_scanned_matches_the_loop(tmp_path):
    """train_scanned / test_scanned (one upload and one packed fetch per
    epoch) against train / test on the same batches from the same seed,
    over two epochs with an oversized batch skipped in each: the same
    parameters, records, lr, checkpoints and generator state."""
    big = [sphere_cloud(30, 4.0, 0), sphere_cloud(30, 4.0, 1)]
    batches = _batches(3)
    batches = batches[:1] + [big] + batches[1:]
    loop, scan = _trainer(tmp_path, "s0"), _trainer(tmp_path, "s1")
    seen = [_records(tr) for tr in (loop, scan)]
    for _ in range(2):
        loop.train(batches)
        scan.train_scanned(batches)
    loop.test(_batches(1))
    scan.test_scanned(_batches(1))
    assert (scan.epoch, scan.lr) == (loop.epoch, loop.lr) == (2, 5e-4)
    for k, v in loop.model.state_dict().items():
        assert torch.equal(scan.model.state_dict()[k], v), k
    assert torch.equal(loop.generator.get_state(),
                       scan.generator.get_state())
    assert [r[:2] for r in seen[1]] == [r[:2] for r in seen[0]] == [
        ("Train", 3), ("Train", 10003), ("Test", 2)]
    for (_, _, a), (_, _, b) in zip(*seen):
        assert sorted(a) == sorted(b)
        for k in a:
            assert len(a[k]) == len(b[k]) > 0, k
            for x, y in zip(a[k], b[k]):
                np.testing.assert_array_equal(y, x, err_msg=k)
    names = sorted(os.listdir(loop.ckptdir))
    assert names == sorted(os.listdir(scan.ckptdir)) == ["epoch_0.ckpt",
                                                          "epoch_1.ckpt"]


def test_train_scanned_with_nothing_that_fits(tmp_path):
    tr = _trainer(tmp_path, "n")
    big = [sphere_cloud(30, 4.0, 0), sphere_cloud(30, 4.0, 1)]
    tr.train_scanned([big])
    tr.test_scanned([big])
    assert tr.epoch == 1 and not os.listdir(tr.ckptdir)


def test_cli_train_on_a_ply_directory(tmp_path, monkeypatch):
    from pcgcv2_torch.cli import train as cli

    data = tmp_path / "data"
    data.mkdir()
    for i in range(6):
        write_ply_ascii_geo(str(data / f"p{i}.ply"),
                            sphere_cloud(24, 1.0, i))
    monkeypatch.chdir(tmp_path)
    tr = cli.main(["--dataset", str(data), "--epoch", "1", "--batch_size",
                   "2", "--batch_capacity", "2048", "--train_res", "32",
                   "--prefix", "t", "--device", "cpu"])
    assert tr.epoch == 1 and tr.device.type == "cpu"
    assert glob.glob(str(tmp_path / "ckpts" / "t" / "*.ckpt"))
    log = open(tmp_path / "logs" / "t" / "log.txt").read()
    assert "train files: 5, test files: 1" in log


def test_cuda_entry_points_raise_without_a_card(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from pcgcv2_torch.cli import train as cli

    with pytest.raises(RuntimeError, match="cuda"):
        TT.Trainer(TCFG.TrainConfig(), TCFG.BlockPlan.for_training(
            2048, 32, 2), 2048, logdir=str(tmp_path / "l"),
            ckptdir=str(tmp_path / "c"))
    monkeypatch.chdir(tmp_path)
    assert cli.parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--dataset", str(tmp_path), "--epoch", "1"])
