"""The port's per-voxel oracle (pcgcv2_torch/ops/keys.py, ops/sparse.py)
against the JAX package's twins, the port's block ops against that oracle,
and the oracle's CapacityPlan, on the CPU.

Keys, coordinates, counts, kernel maps and masks must be exactly equal;
f32 features agree within 1e-5 (another order of summation).  The JAX side
runs under the suite's x64 flag (tests/conftest.py), which the oracle's
int64 keys need.  The block-vs-oracle tests mirror tests/test_blocks.py
(:68-263) on the port.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcgcv2_torch import config as TCFG
from pcgcv2_torch.ops import blocks as TB
from pcgcv2_torch.ops import conv3 as TK
from pcgcv2_torch.ops import keys as TKEYS
from pcgcv2_torch.ops import sparse as TS
from pcgcv2_tpu import config as JCFG
from pcgcv2_tpu.ops import keys as JKEYS
from pcgcv2_tpu.ops import sparse as JS

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _x64_for_the_oracle():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax.config.update("jax_enable_x64", old)


def _t(a):
    return torch.from_numpy(np.array(a))


def rand_cloud(rng, n, res, batches=1, stride=1):
    """tests/test_blocks.py::rand_cloud: n unique (b, x, y, z) rows,
    sorted."""
    coords = set()
    while len(coords) < n:
        b = rng.randint(0, batches)
        xyz = tuple(rng.randint(0, res // stride, size=3) * stride)
        coords.add((b,) + xyz)
    return np.array(sorted(coords), dtype=np.int32)


def _cloud(seed, n=200, res=32, batches=1, stride=1, ch=4):
    """Shuffled rows with random features."""
    rng = np.random.RandomState(seed)
    coords = rand_cloud(rng, n, res, batches, stride)
    coords = coords[rng.permutation(n)]
    return coords, rng.randn(n, ch).astype(np.float32)


def assert_same_sv(j, t, exact_feats=True):
    np.testing.assert_array_equal(t.coords.numpy(), np.asarray(j.coords))
    np.testing.assert_array_equal(t.keys.numpy(), np.asarray(j.keys))
    assert int(t.count) == int(j.count) and t.stride == j.stride
    if exact_feats:
        np.testing.assert_array_equal(t.feats.numpy(), np.asarray(j.feats))
    else:
        np.testing.assert_allclose(t.feats.numpy(), np.asarray(j.feats),
                                   rtol=TOL, atol=TOL)


def _both_sv(coords, feats, count=None, stride=1, **kw):
    n = count if count is not None else len(coords)
    j = JS.build(jnp.asarray(coords), jnp.asarray(feats), jnp.int32(n),
                 stride=stride, **kw)
    t = TS.build(_t(coords), _t(feats), n, stride=stride, **kw)
    return j, t


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------


def test_key_constants_match_jax():
    assert (TKEYS.COORD_BITS, TKEYS.R, TKEYS.PAD_BATCH, TKEYS.PAD_COORD,
            TKEYS.PAD_KEY) == (JKEYS.COORD_BITS, JKEYS.R, JKEYS.PAD_BATCH,
                               JKEYS.PAD_COORD, JKEYS.PAD_KEY)


def test_ravel_unravel_match_jax():
    coords, _ = _cloud(0, n=300, res=4096, batches=5)
    coords = np.concatenate([coords, np.array([TKEYS.PAD_COORD],
                                              np.int32)])
    jk = JKEYS.ravel(jnp.asarray(coords))
    tk = TKEYS.ravel(_t(coords))
    assert tk.dtype == torch.int64
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert int(tk[-1]) == TKEYS.PAD_KEY
    np.testing.assert_array_equal(TKEYS.unravel(tk).numpy(), coords)
    np.testing.assert_array_equal(TKEYS.unravel(tk).numpy(),
                                  np.asarray(JKEYS.unravel(jk)))


def test_sort_search_lookup_isin_match_jax():
    rng = np.random.RandomState(1)
    keys = rng.randint(0, 1 << 40, size=257).astype(np.int64)
    keys[:5] = TKEYS.PAD_KEY
    payload = rng.randn(257, 3).astype(np.float32)
    js = JKEYS.sort_by_key(jnp.asarray(keys), jnp.asarray(payload))
    ts = TKEYS.sort_by_key(_t(keys), _t(payload))
    for a, b in zip(ts, js):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    sk = ts[0]
    q = np.concatenate([keys[::3], rng.randint(0, 1 << 40, size=50),
                        [TKEYS.PAD_KEY, 0]]).astype(np.int64)
    np.testing.assert_array_equal(
        TKEYS.searchsorted(sk, _t(q)).numpy(),
        np.asarray(JKEYS.searchsorted(js[0], jnp.asarray(q))))
    (ti, th), (ji, jh) = (TKEYS.lookup(sk, _t(q)),
                          JKEYS.lookup(js[0], jnp.asarray(q)))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(TKEYS.isin(sk, _t(q)).numpy(),
                                  np.asarray(JKEYS.isin(js[0],
                                                        jnp.asarray(q))))
    assert not bool(th[-2])  # PAD_KEY is never a member


# ---------------------------------------------------------------------------
# sparse: construction and kernel maps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dedupe", [False, True])
@pytest.mark.parametrize("capacity", [None, 180, 260])
def test_build_matches_jax(dedupe, capacity):
    coords, feats = _cloud(2, n=220, batches=2)
    if dedupe:  # repeated rows: the first in key order wins
        coords = np.concatenate([coords, coords[:30]])
        feats = np.concatenate([feats, feats[:30] + 1.0])
    j, t = _both_sv(coords, feats, count=len(coords) - 7, dedupe=dedupe,
                    capacity=capacity)
    assert_same_sv(j, t)
    # without dedupe JAX leaves count as given, even past the capacity
    assert t.capacity == (capacity or len(coords))


def test_build_with_valid_mask_matches_jax():
    coords, feats = _cloud(3, n=150)
    valid = np.random.RandomState(3).rand(150) < 0.6
    j = JS.build(jnp.asarray(coords), jnp.asarray(feats),
                 valid_mask=jnp.asarray(valid))
    t = TS.build(_t(coords), _t(feats), valid_mask=_t(valid))
    assert_same_sv(j, t)
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    np.testing.assert_array_equal(t.num_per_batch(2).numpy(),
                                  np.asarray(j.num_per_batch(2)))


@pytest.mark.parametrize("k,s", [(3, 1), (3, 4), (2, 1), (2, 2)])
def test_stencil_offsets_match_jax(k, s):
    np.testing.assert_array_equal(TS.stencil_offsets(k, s).numpy(),
                                  np.asarray(JS.stencil_offsets(k, s)))


@pytest.mark.parametrize("stride", [1, 2])
def test_build_kernel_map_matches_jax(stride):
    coords, feats = _cloud(4, n=200, res=32, stride=stride)
    j, t = _both_sv(coords, feats, stride=stride)
    jm = JS.build_kernel_map(j, JS.stencil_offsets(3, stride))
    tm = TS.build_kernel_map(t, TS.stencil_offsets(3, stride))
    for a, b in zip(tm, jm):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert bool(tm[1].any())


# ---------------------------------------------------------------------------
# sparse: convolutions, top-k, prune
# ---------------------------------------------------------------------------


def _weights(shape, seed, scale=0.2):
    rng = np.random.RandomState(seed)
    return ((rng.randn(*shape) * scale).astype(np.float32),
            rng.randn(shape[-1]).astype(np.float32))


@pytest.mark.parametrize("group_size", [9, 27])
def test_conv_matches_jax(group_size):
    coords, feats = _cloud(5, n=250)
    j, t = _both_sv(coords, feats)
    w, b = _weights((27, 4, 5), 6)
    jo = JS.conv(j, JS.build_kernel_map(j, JS.stencil_offsets(3, 1)),
                 jnp.asarray(w), jnp.asarray(b), group_size)
    to = TS.conv(t, TS.build_kernel_map(t, TS.stencil_offsets(3, 1)),
                 torch.from_numpy(w), torch.from_numpy(b), group_size)
    assert_same_sv(jo, to, exact_feats=False)


@pytest.mark.parametrize("cap", [256, 40])
def test_downsample_and_conv_down_match_jax(cap):
    coords, feats = _cloud(7, n=250, batches=2)
    j, t = _both_sv(coords, feats)
    jd = JS.downsample_coords(j, cap)
    td = TS.downsample_coords(t, cap)
    for a, b in zip(td, jd):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    w, b = _weights((8, 4, 6), 8, 0.3)
    jo = JS.conv_down(j, jnp.asarray(w), jnp.asarray(b), cap)
    to = TS.conv_down(t, torch.from_numpy(w), torch.from_numpy(b), cap)
    assert_same_sv(jo, to, exact_feats=False)
    assert to.stride == 2 and int(to.count) == min(cap, int(to.count))


def test_conv_up_generative_matches_jax():
    coords, feats = _cloud(9, n=80, stride=2)
    j, t = _both_sv(coords, feats, count=75, stride=2)
    w, b = _weights((8, 4, 3), 10, 0.3)
    jo = JS.conv_up_generative(j, jnp.asarray(w), jnp.asarray(b))
    to = TS.conv_up_generative(t, torch.from_numpy(w), torch.from_numpy(b))
    assert_same_sv(jo, to, exact_feats=False)
    assert int(to.count) == 8 * 75 and to.stride == 1


@pytest.mark.parametrize("nums", [(20, 1000, 0), (5, 5, 5)])
def test_topk_mask_and_prune_match_jax(nums):
    coords, scores = _cloud(11, n=300, batches=3, ch=1)
    j, t = _both_sv(coords, scores, count=290)
    nums = np.array(nums, np.int32)
    jk = JS.topk_mask(j, j.feats[:, 0], jnp.asarray(nums), 3)
    tk = TS.topk_mask(t, t.feats[:, 0], _t(nums), 3)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    for cap in (300, 12):  # 12 cuts the kept rows
        assert_same_sv(JS.prune(j, jk, cap), TS.prune(t, tk, cap))


def test_cat_feats_matches_jax():
    coords, feats = _cloud(12, n=60)
    j, t = _both_sv(coords, feats)
    assert_same_sv(JS.cat_feats(j, j), TS.cat_feats(t, t))
    assert TS.cat_feats(t, t).channels == 8


# ---------------------------------------------------------------------------
# The port's block ops against the oracle (tests/test_blocks.py:68-263)
# ---------------------------------------------------------------------------


def _rows_of(bg):
    c, f, n = TB.extract(bg, bg.nb_cap * TB.VOL)
    n = int(n)
    return {tuple(r): v for r, v in zip(c[:n].tolist(), f[:n].numpy())}


def _sv_rows(sv):
    n = int(sv.count)
    return {tuple(r): v for r, v in zip(sv.coords[:n].tolist(),
                                        sv.feats[:n].numpy())}


def assert_same_rows(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4)


def _grid(coords, feats, nb_cap, stride, res, batches=1):
    return TB.blockify(_t(coords), _t(feats),
                       torch.ones(len(coords), dtype=torch.bool), nb_cap,
                       stride, res // stride, batches)


@pytest.mark.parametrize("stride,res", [(1, 32), (4, 64)])
def test_block_conv3_matches_sparse(stride, res):
    coords, feats = _cloud(13 + stride, n=250 if stride == 1 else 120,
                           res=res, stride=stride)
    w, b = _weights((3, 3, 3, 4, 5), 15)
    bg = _grid(coords, feats, 128, stride, res)
    out = TK.conv3(bg, TB.neighbor_rows(bg), torch.from_numpy(w),
                   torch.from_numpy(b), compute_dtype=torch.float32)
    sv = TS.build(_t(coords), _t(feats), len(coords), stride=stride)
    ref = TS.conv(sv, TS.build_kernel_map(sv, TS.stencil_offsets(3, stride)),
                  torch.from_numpy(w.reshape(27, 4, 5)), torch.from_numpy(b))
    assert_same_rows(_rows_of(out), _sv_rows(ref))


def test_block_conv_down_matches_sparse():
    coords, feats = _cloud(16, n=250)
    w, b = _weights((8, 4, 6), 17, 0.3)
    out = TB.conv_down(_grid(coords, feats, 128, 1, 32),
                       torch.from_numpy(w), torch.from_numpy(b), 64)
    assert out.stride == 2 and out.res == 16
    ref = TS.conv_down(TS.build(_t(coords), _t(feats), len(coords)),
                       torch.from_numpy(w), torch.from_numpy(b), 256)
    assert_same_rows(_rows_of(out), _sv_rows(ref))


def test_block_conv_up_generative_matches_sparse():
    coords, feats = _cloud(18, n=80, stride=2)
    w, b = _weights((8, 4, 3), 19, 0.3)
    out = TB.conv_up_generative(_grid(coords, feats, 64, 2, 32),
                                torch.from_numpy(w), torch.from_numpy(b),
                                512)
    assert out.stride == 1 and out.res == 32
    assert int(out.voxel_count()) == 8 * len(coords)
    ref = TS.conv_up_generative(
        TS.build(_t(coords), _t(feats), len(coords), stride=2),
        torch.from_numpy(w), torch.from_numpy(b))
    assert_same_rows(_rows_of(out), _sv_rows(ref))


def test_block_topk_prune_matches_sparse():
    coords, scores = _cloud(20, n=300, batches=3, ch=1)
    nums = torch.tensor([20, 1000, 0], dtype=torch.int32)
    bg = _grid(coords, scores, 256, 1, 32, batches=3)
    pr = TB.prune(bg, TB.topk_mask(bg, bg.feats[:, :, 0], nums))
    sv = TS.build(_t(coords), _t(scores), len(coords))
    ref = TS.prune(sv, TS.topk_mask(sv, sv.feats[:, 0], nums, 3), 300)
    assert_same_rows(_rows_of(pr), _sv_rows(ref))


def test_block_isin_matches_sparse():
    (ca, fa), (cb, fb) = _cloud(21, ch=1), _cloud(22, n=150, ch=1)
    a = _grid(ca, fa, 256, 1, 32)
    b = _grid(cb, fb, 256, 1, 32)
    got = TB.isin(a, b)
    sb = TS.build(_t(cb), _t(fb), len(cb))
    slots = TKEYS.ravel(TB.slot_coords(a))
    want = TKEYS.isin(sb.keys, slots) & a.mask & a.valid[:, None]
    assert torch.equal(got, want) and int(want.sum()) > 0


# ---------------------------------------------------------------------------
# CapacityPlan, and the oracle stays off the codec's path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_points", [1000, 43301, 327003, 858862, 3546032])
def test_capacity_plan_matches_jax(n_points):
    t, j = (TCFG.CapacityPlan.for_points(n_points),
            JCFG.CapacityPlan.for_points(n_points))
    assert (t.input, t.scale1, t.scale2, t.scale3, t.train_slack) == (
        j.input, j.scale1, j.scale2, j.scale3, j.train_slack)
    assert t.encoder_caps == j.encoder_caps
    for training in (False, True):
        assert t.decoder_caps(training) == j.decoder_caps(training)


def test_oracle_is_not_imported_on_the_codec_path():
    """The codec and the trainer import the block backend, never the
    oracle (so `pcgcv2_torch.ops`, unlike the JAX package's, does not
    re-export the oracle's names)."""
    code = ("import sys, pcgcv2_torch.codec.coder, pcgcv2_torch.train."
            "trainer, pcgcv2_torch.parallel.spatial; "
            "assert not {'pcgcv2_torch.ops.sparse', 'pcgcv2_torch.ops.keys'}"
            " & set(sys.modules)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
