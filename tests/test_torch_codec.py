"""The slice as a whole: the port's Coder (device="cpu") against the JAX
package's Coder on the tiny test model (tests/_tiny.py) and a res-64
sphere frame of tests/test_codec.py.

Same weights (JAX PCCModel.init -> numpy -> params_from_jax), same frame:
the bottleneck coordinates and feature symbols must be equal, the decoded
point sets equal, and each package must decode the other's bitstream.
"""

import jax
import numpy as np
import pytest
import torch

from pcgcv2_torch.codec.coder import Coder as TCoder
from pcgcv2_torch.models.entropy import EntropyBottleneck as TEB
from pcgcv2_tpu.codec.coder import Coder as JCoder
from pcgcv2_tpu.config import BlockPlan
from pcgcv2_tpu.data.synthetic import sphere_cloud
from pcgcv2_tpu.data.voxelize import collate
from pcgcv2_tpu.models import PCCModel
from pcgcv2_tpu.models.entropy import EntropyBottleneck as JEB


@pytest.fixture(autouse=True, scope="module")
def _production_dtypes():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    # tiny tensors: one torch thread, so parallel test workers do not
    # oversubscribe the host's cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.set_num_threads(threads)
    jax.config.update("jax_enable_x64", old)


@pytest.fixture(scope="module")
def ctx(tmp_path_factory, _production_dtypes):
    """JAX-initialised tiny-model weights (the init call of
    tests/test_codec.py), one coder per package, and one encoded frame
    from each."""
    from tests._tiny import TINY_MODEL

    train_cloud = sphere_cloud(32, density=1.2, seed=7)
    coords, valid = collate([train_cloud], capacity=2048)
    plan = BlockPlan(res=64, nb=(256, 128, 64, 64))
    model = PCCModel(config=TINY_MODEL, plan=plan, num_batches=1)
    params = jax.jit(
        lambda k1, k2: model.init(
            {"params": k1, "noise": k2}, coords, valid, True
        )
    )(jax.random.PRNGKey(0), jax.random.PRNGKey(1))
    params = jax.tree_util.tree_map(np.asarray, params)

    out = tmp_path_factory.mktemp("torch_codec")
    kw = dict(res=64, model_config=TINY_MODEL, input_granularity=4096)
    jc = JCoder(params, str(out / "jax"), prune_granularity=512, **kw)
    tc = TCoder(params, str(out / "torch"), device="cpu", **kw)
    cloud = sphere_cloud(48, density=1.5, seed=3)
    return dict(params=params, jc=jc, tc=tc, cloud=cloud,
                jenc=jc.encode(cloud), tenc=tc.encode(cloud))


def test_bottleneck_coords_and_symbols_equal(ctx):
    (jcoords, jsyms), (tcoords, tsyms) = ctx["jenc"], ctx["tenc"]
    np.testing.assert_array_equal(tcoords, jcoords)
    assert tsyms.shape == jsyms.shape
    same = float(np.mean(tsyms == jsyms))
    assert same == 1.0, f"share of equal feature symbols: {same:.6f}"


def test_bitstream_files_equal(ctx):
    """Equal coordinates and symbols make byte-identical files."""
    for ext in ("_C.bin", "_F.bin", "_H.bin", "_num_points.bin"):
        with open(ctx["jc"].filename + ext, "rb") as f:
            jb = f.read()
        with open(ctx["tc"].filename + ext, "rb") as f:
            tb = f.read()
        assert tb == jb, ext


def test_shuffled_duplicated_frame_same_files(ctx):
    """The device intake sorts and dedups a frame in any order, with
    repeats, into the bitstream of the frame itself, byte for byte."""
    tc, cloud = ctx["tc"], ctx["cloud"]
    rng = np.random.default_rng(5)
    frame = np.concatenate([cloud, cloud[rng.integers(0, len(cloud), 100)]])
    frame = frame[rng.permutation(len(frame))]
    before = tc.intake_dedups
    tc.encode(frame, postfix="_shuffled")
    assert tc.intake_dedups - before == 1
    for ext in ("_C.bin", "_F.bin", "_H.bin", "_num_points.bin"):
        with open(tc.filename + ext, "rb") as f:
            want = f.read()
        with open(tc.filename + "_shuffled" + ext, "rb") as f:
            assert f.read() == want, ext


def _sorted(pts):
    return pts[np.lexsort((pts[:, 2], pts[:, 1], pts[:, 0]))]


def test_decoded_point_sets_equal(ctx):
    jdec = ctx["jc"].decode()
    tdec = ctx["tc"].decode()
    assert len(tdec) == len(ctx["cloud"])
    np.testing.assert_array_equal(_sorted(tdec), _sorted(jdec))


@pytest.mark.parametrize("writer,reader", [("jc", "tc"), ("tc", "jc")])
def test_cross_decode(ctx, writer, reader):
    """A stream written by one package decodes in the other to the
    writer's own decode."""
    w, r = ctx[writer], ctx[reader]
    own = w.decode()
    old = r.filename
    r.filename = w.filename
    r.coordinate_coder.filename = w.filename
    r.feature_coder.filename = w.filename
    try:
        got = r.decode()
    finally:
        r.filename = old
        r.coordinate_coder.filename = old
        r.feature_coder.filename = old
    np.testing.assert_array_equal(_sorted(got), _sorted(own))


@pytest.mark.parametrize("rho", [0.5, 1.5])
def test_rho_scales_final_count(ctx, rho):
    out = ctx["tc"].decode(rho=rho)
    assert len(out) == int(rho * len(ctx["cloud"]))
    assert len(np.unique(out, axis=0)) == len(out)


def test_entropy_bottleneck_matches_jax(ctx):
    eb = ctx["params"]["params"]["entropy_bottleneck"]
    jeb = JEB(channels=8)
    teb = TEB(8)
    teb.load_state_dict({k: torch.tensor(v) for k, v in eb.items()})
    x = np.random.RandomState(0).randn(257, 8).astype(np.float32) * 3
    jl = jeb.apply({"params": eb}, jax.numpy.asarray(x),
                   method=JEB.likelihood)
    with torch.no_grad():
        tl = teb.likelihood(torch.from_numpy(x))
        tp = teb.pmf(-4, 8)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-6)
    jp = jeb.apply({"params": eb}, jax.numpy.asarray(-4), 8, method=JEB.pmf)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(
        np.round(teb.quantize(torch.from_numpy(x)).numpy()), np.round(x))


def test_cli_device_cuda_without_card_raises(tmp_path):
    """The codec CLI defaults to the card and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from pcgcv2_torch.cli.coder import main
    from pcgcv2_torch.data.io import write_ply_ascii_geo

    ply = str(tmp_path / "frame.ply")
    write_ply_ascii_geo(ply, sphere_cloud(16, density=1.0, seed=1))
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--ckptdir", "tests/golden/golden.ckpt", "--filedir", ply,
              "--res", "16", "--outdir", str(tmp_path)])


# --- the streamed decode --------------------------------------------------


@pytest.fixture(scope="module")
def jdec(ctx):
    """The JAX package's (monolithic) decode of its own stream."""
    return ctx["jc"].decode()


@pytest.mark.parametrize("n_slabs", [1, 3, 8])
def test_streamed_decode_of_jax_stream(ctx, jdec, n_slabs):
    """The port's streamed decode of the JAX stream gives the JAX decode's
    point set.  At res 64 the stage-2 input spans 2 block planes, so 3 and
    8 slabs leave slabs empty."""
    from tests._tiny import TINY_MODEL

    tc = TCoder(ctx["params"], ctx["jc"].filename, res=64,
                model_config=TINY_MODEL, input_granularity=4096,
                streamed_slabs=n_slabs, device="cpu")
    got = tc.decode()
    assert len(got) == len(jdec) == len(ctx["cloud"])
    np.testing.assert_array_equal(_sorted(got), _sorted(jdec))


class _Streamed(Exception):
    pass


@pytest.mark.parametrize("streamed_slabs,res,want", [
    (0, 64, None), (0, 2048, 8), (5, 64, 5)])
def test_streamed_dispatch(ctx, monkeypatch, streamed_slabs, res, want):
    """The JAX package's rule: streamed_slabs, else 8 slabs for plans at
    res >= 2048, else the monolithic decode."""
    from tests._tiny import TINY_MODEL

    seen = []

    def spy(self, y, nums_list, plan, n):
        seen.append((n, plan.res))
        raise _Streamed

    monkeypatch.setattr(TCoder, "_decode_streamed", spy)
    tc = TCoder(ctx["params"], ctx["jc"].filename, res=res,
                model_config=TINY_MODEL, input_granularity=4096,
                streamed_slabs=streamed_slabs, device="cpu")
    if want is None:
        assert len(tc.decode()) == len(ctx["cloud"])
        assert seen == []
    else:
        with pytest.raises(_Streamed):
            tc.decode()
        assert seen == [(want, res)]


def test_decode_stage_fns_match_jax(ctx):
    """decode_coarse_fn, compact_where on its output and decode_stage2_fn
    on that sub-grid at the streamed decode's caps, against the JAX
    model's: structure exactly equal, features and logits within 1e-4."""
    import jax.numpy as jnp

    from pcgcv2_torch.ops import blocks as TB
    from pcgcv2_tpu.ops import blocks as JB
    from tests._tiny import TINY_MODEL

    with open(ctx["jc"].filename + "_num_points.bin", "rb") as f:
        head = np.frombuffer(f.read(28), dtype=np.int32)
    plan = BlockPlan.for_frame(64, tuple(int(c) for c in head[3:7]))
    coords, feats = ctx["jenc"]
    rows = np.zeros((len(coords), 4), np.int32)
    rows[:, 1:] = coords * 8
    valid = np.ones(len(coords), bool)
    nums = head[:3].copy()
    # the stride-2 grid holds 2 blocks, at bz = 0 and 1: keep the second
    sub_cap = max(32, plan.dec_nb[1] * 2 // 3)
    up_cap = max(256, plan.up_cap(2) * 2 // 3)
    model = PCCModel(config=TINY_MODEL, plan=plan, num_batches=1)

    def jax_stages(params, rows, feats, valid, nums):
        y = JB.blockify(rows, feats, valid, plan.nb[3], 8, 8, 1)
        out = model.apply(params, y, [nums[0:1], nums[1:2]],
                          method=PCCModel.decode_coarse_fn)
        sub = JB.compact_where(out, out.coords[:, 3] >= 1, sub_cap)
        cls = model.apply(params, sub, up_cap,
                          method=PCCModel.decode_stage2_fn)
        return out, sub, cls

    args = (ctx["params"], jnp.asarray(rows), jnp.asarray(feats),
            jnp.asarray(valid), jnp.asarray(nums))
    # XLA's backend optimisations cost more compile time than they save
    # in one run of this tiny graph
    jgrids = jax.jit(jax_stages).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)
    tmodel = ctx["tc"].model
    with torch.inference_mode():
        ty = TB.blockify(torch.from_numpy(rows), torch.from_numpy(feats),
                         torch.from_numpy(valid), plan.nb[3], 8, 8, 1)
        tn = torch.from_numpy(nums)
        tout = tmodel.decode_coarse_fn(ty, [tn[0:1], tn[1:2]], plan)
        tsub = TB.compact_where(tout, tout.coords[:, 3] >= 1, sub_cap)
        tcls = tmodel.decode_stage2_fn(tsub, up_cap)
    for j, t in zip(jgrids, (tout, tsub, tcls)):
        for name in ("coords", "table", "count", "dropped", "mask"):
            np.testing.assert_array_equal(
                getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                err_msg=name)
        np.testing.assert_allclose(t.feats.float().numpy(),
                                   np.asarray(j.feats), rtol=1e-4, atol=1e-4)
    assert 0 < int(tsub.count) < int(tout.count) and int(tcls.count) > 0
