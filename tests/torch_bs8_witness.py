"""pcgcv2_torch at 8^3 blocks (PCGC_BLOCK_SIZE=8), against the JAX package
at 8^3 blocks and against the port's own per-voxel oracle, on the CPU.

The block side is read when `ops.blocks` is imported, so these checks run
in a process of their own: tests/test_torch_bs8.py starts this script once
and reads the JSON it writes, one check per test.  It repeats the suite's
settings (tests/conftest.py): JAX on the CPU at `highest` matmul precision,
its persistent compilation cache, and x64 off (nothing here needs the JAX
oracle's int64 keys: the port's oracle is plain torch).

    JAX_PLATFORMS=cpu python tests/torch_bs8_witness.py OUT.json

Each check is a function returning a dict with "ok"; one that raises is
recorded as failed, with its traceback, and the rest still run.
"""

from __future__ import annotations

import os
import sys

os.environ["PCGC_BLOCK_SIZE"] = "8"  # before either package is imported

import json  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")
jax.config.update("jax_enable_x64", False)

import dataclasses  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from pcgcv2_torch import checkpoint as TC  # noqa: E402
from pcgcv2_torch import config as TCFG  # noqa: E402
from pcgcv2_torch.codec import coder as TCODER  # noqa: E402
from pcgcv2_torch.ops import blocks as TB  # noqa: E402
from pcgcv2_torch.ops import conv3 as TK  # noqa: E402
from pcgcv2_torch.ops import sparse as TS  # noqa: E402
from pcgcv2_torch.train import loss as TL  # noqa: E402
from pcgcv2_tpu import config as JCFG  # noqa: E402
from pcgcv2_tpu.cache import enable_persistent_cache  # noqa: E402
from pcgcv2_tpu.codec import coder as JCODER  # noqa: E402
from pcgcv2_tpu.data.synthetic import sphere_cloud  # noqa: E402
from pcgcv2_tpu.data.voxelize import collate  # noqa: E402
from pcgcv2_tpu.models import PCCModel as JPCC  # noqa: E402
from pcgcv2_tpu.ops import blocks as JB  # noqa: E402
from pcgcv2_tpu.ops.pallas_conv import conv3_pallas  # noqa: E402
from pcgcv2_tpu.train import loss as JL  # noqa: E402
from tests._tiny import TINY_MODEL  # noqa: E402

enable_persistent_cache(jax)
assert TB.BS == JB.BS == 8 and TCFG._BS == JCFG._BS == 8

TOL = 1e-5       # f32 features, another order of summation
TOL_LOSS = 1e-5  # the training step's loss, relative
TOL_GRAD = 1e-4  # every gradient leaf, over its max |g|
TINY = TCFG.ModelConfig(**dataclasses.asdict(TINY_MODEL))
CHECKS = {}


def check(fn):
    CHECKS[fn.__name__] = fn
    return fn


def _t(a):
    return torch.from_numpy(np.array(a))


def _rand_cloud(rng, n, res, batches=1, stride=1):
    """tests/test_blocks.py::rand_cloud: n unique (b, x, y, z) rows."""
    coords = set()
    while len(coords) < n:
        b = rng.randint(0, batches)
        xyz = tuple(rng.randint(0, res // stride, size=3) * stride)
        coords.add((b,) + xyz)
    return np.array(sorted(coords), dtype=np.int32)


def _both(coords, feats, nb_cap, stride, res, num_batches=1):
    valid = np.ones(len(coords), bool)
    j = JB.blockify(jnp.asarray(coords), jnp.asarray(feats),
                    jnp.asarray(valid), nb_cap, stride, res, num_batches)
    t = TB.blockify(_t(coords), _t(feats), _t(valid), nb_cap, stride, res,
                    num_batches)
    return j, t


def _same_grid(j, t) -> dict:
    """Structure exactly equal, features within TOL: the failures, or
    {"ok": True, "max_feat_err": ...}."""
    bad = [name for name in ("coords", "table", "count", "dropped", "mask")
           if not np.array_equal(getattr(t, name).numpy(),
                                 np.asarray(getattr(j, name)))]
    bad += [name for name in ("stride", "res", "num_batches")
            if getattr(t, name) != getattr(j, name)]
    err = float(np.abs(t.feats.float().numpy() - np.asarray(j.feats)).max())
    return {"ok": not bad and err <= TOL, "differs": bad,
            "max_feat_err": err, "count": int(t.count)}


# ---------------------------------------------------------------------------
# The block ops against the JAX package's at BS = 8
# ---------------------------------------------------------------------------


def _grid_pair(ch, seed, n=300, res=32, batches=2, nb_cap=160, stride=1):
    rng = np.random.RandomState(seed)
    coords = _rand_cloud(rng, n, res, batches, stride)
    feats = rng.randn(n, ch).astype(np.float32)
    return _both(coords, feats, nb_cap, stride, res // stride, batches)


def _weights(shape, seed, scale=0.2):
    rng = np.random.RandomState(seed)
    return ((rng.randn(*shape) * scale).astype(np.float32),
            rng.randn(shape[-1]).astype(np.float32))


@check
def blockify_vs_jax():
    out = {}
    # 160 rows hold the 2-item cloud; 40 overflow it: the same `dropped`
    for nb_cap in (160, 40):
        j, t = _grid_pair(4, 0, nb_cap=nb_cap)
        out[nb_cap] = {**_same_grid(j, t), "dropped": int(t.dropped)}
    return {"ok": all(r["ok"] for r in out.values())
            and out[40]["dropped"] > 0, "caps": out}


@check
def conv3_vs_jax():
    j, t = _grid_pair(8, 1)
    w, b = _weights((3, 3, 3, 8, 16), 2)
    jo = JB.conv3(j, JB.neighbor_rows(j), jnp.asarray(w), jnp.asarray(b),
                  compute_dtype=jnp.float32)
    to = TK.conv3(t, TB.neighbor_rows(t), torch.from_numpy(w),
                  torch.from_numpy(b), compute_dtype=torch.float32)
    nbrs_equal = np.array_equal(TB.neighbor_rows(t).numpy(),
                                np.asarray(JB.neighbor_rows(j)))
    r = _same_grid(jo, to)
    return {**r, "ok": r["ok"] and nbrs_equal, "nbrs_equal": nbrs_equal}


@check
def conv3_vs_pallas_interpret():
    j, t = _grid_pair(16, 3, n=200)
    w, b = _weights((3, 3, 3, 16, 32), 4)
    ref = conv3_pallas(j, JB.neighbor_rows(j), jnp.asarray(w),
                       jnp.asarray(b), compute_dtype=jnp.float32,
                       interpret=True)
    got = TK.conv3_plain(t, TB.neighbor_rows(t), torch.from_numpy(w),
                         torch.from_numpy(b), compute_dtype=torch.float32)
    err = float(np.abs(got.feats.numpy() - np.asarray(ref.feats)).max())
    return {"ok": err <= TOL, "max_feat_err": err}


@check
def conv_down_vs_jax():
    out = {}
    for cap in (48, 6):  # 6 overflows: the same blocks dropped
        j, t = _grid_pair(4, 5)
        w, b = _weights((8, 4, 6), 6)
        jo = JB.conv_down(j, jnp.asarray(w), jnp.asarray(b), cap)
        to = TB.conv_down(t, torch.from_numpy(w), torch.from_numpy(b), cap)
        out[cap] = _same_grid(jo, to)
    return {"ok": all(r["ok"] for r in out.values()), "caps": out}


@check
def conv_up_generative_vs_jax():
    out = {}
    for cap in (160, 12):
        j, t = _grid_pair(4, 7, n=80, res=32, stride=2, nb_cap=48)
        w, b = _weights((8, 4, 3), 8)
        jo = JB.conv_up_generative(j, jnp.asarray(w), jnp.asarray(b), cap)
        to = TB.conv_up_generative(t, torch.from_numpy(w),
                                   torch.from_numpy(b), cap)
        out[cap] = _same_grid(jo, to)
    return {"ok": all(r["ok"] for r in out.values()), "caps": out}


@check
def topk_prune_vs_jax():
    j, t = _grid_pair(1, 9)
    nums = np.array([40, 1000], np.int32)
    jk = JB.topk_mask(j, j.feats[:, :, 0], jnp.asarray(nums))
    tk = TB.topk_mask(t, t.feats[:, :, 0], _t(nums))
    same_keep = np.array_equal(tk.numpy(), np.asarray(jk))
    r = _same_grid(JB.prune(j, jk), TB.prune(t, tk))
    return {**r, "ok": r["ok"] and same_keep, "same_keep": same_keep,
            "kept": int(tk.sum())}


@check
def plans_vs_jax():
    """BlockPlan.for_frame / for_training / for_cloud and block_counts at
    BS = 8 in both packages (each reads PCGC_BLOCK_SIZE)."""
    cloud = sphere_cloud(48, density=1.5, seed=3)
    counts = (TCODER.block_counts(cloud), JCODER.block_counts(cloud))
    plans = [(getattr(TCFG.BlockPlan, f)(*a), getattr(JCFG.BlockPlan, f)(*a))
             for f, a in (("for_frame", (64, counts[1])),
                          ("for_training", (524288, 128, 8)),
                          ("for_cloud", (858862, 1024)))]
    same = [dataclasses.asdict(a) == dataclasses.asdict(b) for a, b in plans]
    return {"ok": counts[0] == counts[1] and all(same),
            "block_counts": counts[0], "plans_equal": same,
            "for_training": dataclasses.asdict(plans[1][0])}


# ---------------------------------------------------------------------------
# The block ops against the port's per-voxel oracle (tests/test_blocks.py)
# ---------------------------------------------------------------------------


def _rows(bg):
    c, f, n = TB.extract(bg, bg.nb_cap * TB.VOL)
    n = int(n)
    return {tuple(r): v for r, v in zip(c[:n].tolist(), f[:n].numpy())}


def _sparse_rows(sv):
    n = int(sv.count)
    return {tuple(r): v for r, v in zip(sv.coords[:n].tolist(),
                                        sv.feats[:n].numpy())}


def _same_rows(got, want) -> dict:
    if set(got) != set(want):
        return {"ok": False, "sym_diff": len(set(got) ^ set(want))}
    err = max((float(np.abs(got[k] - want[k]).max()) for k in want),
              default=0.0)
    return {"ok": err <= 1e-4, "rows": len(want), "max_feat_err": err}


def _cloud_rows(seed, n, res, stride=1, ch=4, batches=1):
    rng = np.random.RandomState(seed)
    coords = _rand_cloud(rng, n, res, batches, stride)
    return coords, rng.randn(n, ch).astype(np.float32)


@check
def conv3_vs_sparse():
    out = {}
    for stride, res in ((1, 32), (4, 64)):
        coords, feats = _cloud_rows(10 + stride, 200, res, stride)
        w, b = _weights((3, 3, 3, 4, 5), 11)
        bg = TB.blockify(_t(coords), _t(feats), torch.ones(len(coords),
                                                           dtype=torch.bool),
                         160, stride, res // stride, 1)
        got = TK.conv3(bg, TB.neighbor_rows(bg), torch.from_numpy(w),
                       torch.from_numpy(b), compute_dtype=torch.float32)
        sv = TS.build(_t(coords), _t(feats), len(coords), stride=stride)
        kmap = TS.build_kernel_map(sv, TS.stencil_offsets(3, stride))
        ref = TS.conv(sv, kmap, torch.from_numpy(w.reshape(27, 4, 5)),
                      torch.from_numpy(b))
        out[stride] = _same_rows(_rows(got), _sparse_rows(ref))
    return {"ok": all(r["ok"] for r in out.values()), "strides": out}


@check
def conv_down_vs_sparse():
    coords, feats = _cloud_rows(12, 250, 32)
    w, b = _weights((8, 4, 6), 13, 0.3)
    bg = TB.blockify(_t(coords), _t(feats),
                     torch.ones(len(coords), dtype=torch.bool), 160, 1, 32, 1)
    got = TB.conv_down(bg, torch.from_numpy(w), torch.from_numpy(b), 48)
    sv = TS.build(_t(coords), _t(feats), len(coords))
    ref = TS.conv_down(sv, torch.from_numpy(w), torch.from_numpy(b), 256)
    r = _same_rows(_rows(got), _sparse_rows(ref))
    return {**r, "ok": r["ok"] and got.stride == 2 and got.res == 16}


@check
def conv_up_generative_vs_sparse():
    coords, feats = _cloud_rows(14, 80, 32, stride=2)
    w, b = _weights((8, 4, 3), 15, 0.3)
    bg = TB.blockify(_t(coords), _t(feats),
                     torch.ones(len(coords), dtype=torch.bool), 48, 2, 16, 1)
    got = TB.conv_up_generative(bg, torch.from_numpy(w), torch.from_numpy(b),
                                160)
    sv = TS.build(_t(coords), _t(feats), len(coords), stride=2)
    ref = TS.conv_up_generative(sv, torch.from_numpy(w), torch.from_numpy(b))
    r = _same_rows(_rows(got), _sparse_rows(ref))
    return {**r, "ok": r["ok"] and int(got.voxel_count()) == 8 * len(coords)}


@check
def topk_vs_sparse():
    coords, scores = _cloud_rows(16, 300, 32, ch=1, batches=3)
    nums = torch.tensor([20, 1000, 0], dtype=torch.int32)
    bg = TB.blockify(_t(coords), _t(scores),
                     torch.ones(len(coords), dtype=torch.bool), 200, 1, 32, 3)
    pr = TB.prune(bg, TB.topk_mask(bg, bg.feats[:, :, 0], nums))
    sv = TS.build(_t(coords), _t(scores), len(coords))
    ref = TS.prune(sv, TS.topk_mask(sv, sv.feats[:, 0], nums, 3),
                   len(coords))
    return _same_rows(_rows(pr), _sparse_rows(ref))


@check
def isin_vs_sparse():
    (ca, fa), (cb, fb) = _cloud_rows(17, 200, 32, ch=1), \
        _cloud_rows(18, 150, 32, ch=1)
    ones = torch.ones(200, dtype=torch.bool)
    a = TB.blockify(_t(ca), _t(fa), ones, 160, 1, 32, 1)
    b = TB.blockify(_t(cb), _t(fb), ones[:150], 160, 1, 32, 1)
    got = TB.isin(a, b).reshape(-1)
    sb = TS.build(_t(cb), _t(fb), len(cb))
    slots = TB.slot_coords(a).reshape(-1, 4)
    live = (a.mask & a.valid[:, None]).reshape(-1)
    from pcgcv2_torch.ops import keys as TKEYS

    want = TKEYS.isin(sb.keys, TKEYS.ravel(slots)) & live
    return {"ok": bool(torch.equal(got, want)), "members": int(want.sum())}


# ---------------------------------------------------------------------------
# The slice: the tiny-model codec and one training step at BS = 8
# ---------------------------------------------------------------------------


_CTX = {}


def _codec():
    """JAX-initialised tiny-model weights, one coder per package, and one
    frame encoded by each (tests/test_torch_codec.py at BS = 8)."""
    if _CTX:
        return _CTX
    coords, valid = collate([sphere_cloud(32, density=1.2, seed=7)],
                            capacity=2048)
    plan = JCFG.BlockPlan(res=64, nb=(512, 128, 32, 16))
    model = JPCC(config=TINY_MODEL, plan=plan, num_batches=1)
    params = jax.jit(lambda k1, k2: model.init(
        {"params": k1, "noise": k2}, coords, valid, True))(
            jax.random.PRNGKey(0), jax.random.PRNGKey(1))
    params = jax.tree_util.tree_map(np.asarray, params)
    out = Path(tempfile.mkdtemp(prefix="bs8_codec_"))
    kw = dict(res=64, model_config=TINY_MODEL, input_granularity=4096)
    jc = JCODER.Coder(params, str(out / "jax"), prune_granularity=512, **kw)
    tc = TCODER.Coder(params, str(out / "torch"), device="cpu", **kw)
    cloud = sphere_cloud(48, density=1.5, seed=3)
    jc.encode(cloud)
    tc.encode(cloud)
    _CTX.update(params=params, jc=jc, tc=tc, cloud=cloud, kw=kw)
    return _CTX


def _sorted(pts):
    return pts[np.lexsort((pts[:, 2], pts[:, 1], pts[:, 0]))]


def _decode_as(reader, writer):
    """`reader` decodes the stream `writer` wrote."""
    old = reader.filename
    for c in (reader, reader.coordinate_coder, reader.feature_coder):
        c.filename = writer.filename
    try:
        return reader.decode()
    finally:
        for c in (reader, reader.coordinate_coder, reader.feature_coder):
            c.filename = old


@check
def codec_bitstreams_equal():
    ctx = _codec()
    differ = []
    for ext in ("_C.bin", "_F.bin", "_H.bin", "_num_points.bin"):
        if (Path(ctx["jc"].filename + ext).read_bytes()
                != Path(ctx["tc"].filename + ext).read_bytes()):
            differ.append(ext)
    return {"ok": not differ, "differ": differ,
            "bytes": sum(ctx["tc"].bitstream_bytes().values())}


@check
def codec_decoded_equal():
    ctx = _codec()
    jdec, tdec = ctx["jc"].decode(), ctx["tc"].decode()
    ctx["jdec"] = jdec
    same = len(tdec) == len(jdec) == len(ctx["cloud"]) and np.array_equal(
        _sorted(tdec), _sorted(jdec))
    return {"ok": bool(same), "decoded": len(tdec), "n": len(ctx["cloud"])}


@check
def cross_decode_jax_to_port():
    ctx = _codec()
    got, own = _decode_as(ctx["tc"], ctx["jc"]), ctx["jc"].decode()
    return {"ok": bool(np.array_equal(_sorted(got), _sorted(own))),
            "decoded": len(got)}


@check
def cross_decode_port_to_jax():
    ctx = _codec()
    got, own = _decode_as(ctx["jc"], ctx["tc"]), ctx["tc"].decode()
    return {"ok": bool(np.array_equal(_sorted(got), _sorted(own))),
            "decoded": len(got)}


@check
def streamed_3_slabs():
    """The port's decode of its res-64 stream streamed over 3 x-slabs with
    a 1-block halo: at BS = 8 the final stage's receptive field is exactly
    one block, so the set must equal the monolithic decode's."""
    ctx = _codec()
    mono = ctx["tc"].decode()
    tc = TCODER.Coder(ctx["params"], ctx["tc"].filename, streamed_slabs=3,
                      device="cpu", **ctx["kw"])
    got = tc.decode()
    return {"ok": bool(len(got) == len(mono) and np.array_equal(
        _sorted(got), _sorted(mono))), "decoded": len(got)}


def _flat_np(tree):
    return {k: np.asarray(v) for k, v in TC.flatten(tree).items()}


@check
def train_step_vs_jax():
    """One training step of the tiny model from JAX's init, given JAX's
    noise: the loss within 1e-5 (relative) and every gradient leaf within
    1e-4 of its max |g| (tests/test_torch_train.py at BS = 8)."""
    plan_args = dict(res=32, nb=(160, 24, 8, 8), dec_nb=(8, 24, 160))
    plan = JCFG.BlockPlan(**plan_args)
    model = JPCC(config=TINY_MODEL, plan=plan, num_batches=2)
    coords, valid = collate([sphere_cloud(24, 1.0, 0),
                             sphere_cloud(24, 1.0, 1)], capacity=2048)
    kp, kn = jax.random.split(jax.random.PRNGKey(3))
    params = jax.jit(lambda a, b: model.init(
        {"params": a, "noise": b}, coords, valid, True))(kp, kn)

    def loss_fn(p):
        out = model.apply(p, coords, valid, True, kn)
        d = JL.rd_loss(out, 2.0, 1.0, "train")
        return d["loss"], (out["out"].dropped, d)

    (jloss, (jdrop, _)), jgrads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    noise = jax.random.uniform(kn, (plan.nb[3] * JB.VOL, 8), jnp.float32,
                               -0.5, 0.5)
    tmodel = TC.params_from_jax(jax.device_get(params), TINY, device="cpu")
    tmodel.num_batches = 2
    out = tmodel(_t(coords), _t(valid), TCFG.BlockPlan(**plan_args),
                 training=True, noise=_t(noise))
    d = TL.rd_loss(out, 2.0, 1.0, "train")
    d["loss"].backward()
    jg = _flat_np(jax.device_get(jgrads)["params"])
    same_leaves = sorted(jg) == sorted(k for k, _ in
                                       tmodel.named_parameters())
    errs = {}
    for k, p in tmodel.named_parameters():
        ref = jg[k]
        errs[k] = float(np.abs(p.grad.numpy() - ref).max()
                        / max(float(np.abs(ref).max()), 1e-30))
    loss = d["loss"].item()
    loss_err = abs(loss - float(jloss)) / abs(float(jloss))
    worst = max(errs, key=errs.get)
    return {"ok": same_leaves and loss_err <= TOL_LOSS
            and errs[worst] <= TOL_GRAD and int(jdrop) == 0
            and int(out["out"].dropped) == 0,
            "loss": loss, "jax_loss": float(jloss),
            "loss_rel_err": loss_err, "worst_grad": worst,
            "worst_grad_rel_err": errs[worst], "leaves": len(errs)}


def main(argv) -> int:
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    for name, fn in CHECKS.items():
        t0 = time.perf_counter()
        try:
            r = fn()
        except Exception:  # recorded as a failed check, the rest still run
            r = {"ok": False, "error": traceback.format_exc()}
        r["seconds"] = time.perf_counter() - t0
        results[name] = r
        print(f"{name}: {'ok' if r['ok'] else 'FAIL'} "
              f"({r['seconds']:.1f} s)", flush=True)
    Path(argv[1]).write_text(json.dumps(results, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
