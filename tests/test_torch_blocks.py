"""Structure ops of the port against pcgcv2_tpu.ops.blocks on the CPU.

Structure (coords, table, count, mask, dropped, keep sets) must be exactly
equal; f32 features agree within 1e-5 (different summation order).  Each
op is also run with a capacity that is too small: both packages must drop
the same blocks and report the same `dropped`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcgcv2_torch.ops import blocks as TB
from pcgcv2_tpu.data.synthetic import sphere_cloud
from pcgcv2_tpu.data.voxelize import collate
from pcgcv2_tpu.ops import blocks as B

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _production_dtypes():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    # tiny tensors: one torch thread, so parallel test workers do not
    # oversubscribe the host's cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax.config.update("jax_enable_x64", old)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _both(coords, feats, valid, nb_cap, stride, res, num_batches=1):
    """blockify in both packages from the same numpy rows."""
    j = B.blockify(jnp.asarray(coords), jnp.asarray(feats),
                   jnp.asarray(valid), nb_cap, stride, res, num_batches)
    t = TB.blockify(_t(coords), _t(feats), _t(valid), nb_cap, stride, res,
                    num_batches)
    return j, t


def assert_same_grid(j, t, exact_feats=False):
    assert (t.stride, t.res, t.num_batches) == (j.stride, j.res,
                                                j.num_batches)
    for name in ("coords", "table", "count", "dropped", "mask"):
        np.testing.assert_array_equal(
            getattr(t, name).numpy(), np.asarray(getattr(j, name)),
            err_msg=name)
    if exact_feats:
        np.testing.assert_array_equal(t.feats.numpy(), np.asarray(j.feats))
    else:
        np.testing.assert_allclose(t.feats.numpy(), np.asarray(j.feats),
                                   rtol=TOL, atol=TOL)


def _frame(ch=8, batches=1, seed=0):
    """Rows of the res-64 sphere frame(s) of tests/test_codec.py with
    random features."""
    clouds = [sphere_cloud(48, density=1.5, seed=3 + b)
              for b in range(batches)]
    coords, valid = collate(clouds, capacity=8192 * batches)
    feats = np.random.RandomState(seed).randn(len(coords), ch)
    feats = (feats * valid[:, None]).astype(np.float32)
    return coords, feats, valid


# nb_cap 64 holds every block of the frame; 9 overflows it (27 blocks)
@pytest.mark.parametrize("nb_cap", [64, 9])
def test_blockify_exact(nb_cap):
    j, t = _both(*_frame(), nb_cap=nb_cap, stride=1, res=64)
    assert_same_grid(j, t, exact_feats=True)
    assert (int(t.dropped) > 0) == (nb_cap == 9)
    # the sentinel row stays all zero, even after overflow
    assert not t.mask[-1].any() and float(t.feats[-1].abs().sum()) == 0


def test_blockify_two_batches_and_counts():
    j, t = _both(*_frame(batches=2), nb_cap=128, stride=1, res=64,
                 num_batches=2)
    assert_same_grid(j, t, exact_feats=True)
    np.testing.assert_array_equal(t.voxels_per_batch().numpy(),
                                  np.asarray(j.voxels_per_batch()))
    assert int(t.voxel_count()) == int(j.voxel_count())


def test_neighbor_rows_exact():
    j, t = _both(*_frame(), nb_cap=64, stride=1, res=64)
    np.testing.assert_array_equal(TB.neighbor_rows(t).numpy(),
                                  np.asarray(B.neighbor_rows(j)))


@pytest.mark.parametrize("out_cap", [16384, 1000])
def test_extract(out_cap):
    j, t = _both(*_frame(), nb_cap=64, stride=1, res=64)
    jc, jf, jn = B.extract(j, out_cap)
    tc, tf, tn = TB.extract(t, out_cap)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert int(tn) == int(jn)


@pytest.mark.parametrize("stride", [1, 2])
def test_pack_occupancy_and_host_extract(stride):
    j, t = _both(*_frame(), nb_cap=64, stride=stride, res=64 // stride)
    jbc, jbits = B.pack_occupancy(j)
    tbc, tbits = TB.pack_occupancy(t)
    np.testing.assert_array_equal(tbits.numpy(), np.asarray(jbits))
    np.testing.assert_array_equal(tbc.numpy(), np.asarray(jbc))
    got = TB.host_extract(tbc.numpy(), tbits.numpy(), stride=stride)
    np.testing.assert_array_equal(
        got, B.host_extract(np.asarray(jbc), np.asarray(jbits), stride=stride))
    tc, _, tn = TB.extract(t, 16384, with_feats=False)
    np.testing.assert_array_equal(got, tc[: int(tn), 1:].numpy())


@pytest.mark.parametrize("nb_cap_out", [16, 3])
def test_conv_down(nb_cap_out):
    j, t = _both(*_frame(), nb_cap=64, stride=1, res=64)
    rng = np.random.RandomState(5)
    w = (rng.randn(8, 8, 16) * 0.2).astype(np.float32)
    b = rng.randn(16).astype(np.float32)
    jo = B.conv_down(j, jnp.asarray(w), jnp.asarray(b), nb_cap_out,
                     compute_dtype=jnp.float32)
    to = TB.conv_down(t, _t(w), _t(b), nb_cap_out,
                      compute_dtype=torch.float32)
    assert_same_grid(jo, to)
    assert (int(to.dropped) > 0) == (nb_cap_out == 3)


def _coarse():
    """The frame at stride 2 (res 32) with random 8-channel features."""
    cloud = np.unique(sphere_cloud(48, density=1.5, seed=3) // 2, axis=0)
    coords, valid = collate([cloud * 2], capacity=4096)
    feats = np.random.RandomState(2).randn(len(coords), 8)
    feats = (feats * valid[:, None]).astype(np.float32)
    return _both(coords, feats, valid, nb_cap=16, stride=2, res=32)


@pytest.mark.parametrize("nb_cap_out", [64, 5])
def test_conv_up_generative(nb_cap_out):
    j, t = _coarse()
    assert_same_grid(j, t, exact_feats=True)
    rng = np.random.RandomState(6)
    w = (rng.randn(8, 8, 16) * 0.2).astype(np.float32)
    b = rng.randn(16).astype(np.float32)
    jo = B.conv_up_generative(j, jnp.asarray(w), jnp.asarray(b), nb_cap_out,
                              compute_dtype=jnp.float32)
    to = TB.conv_up_generative(t, _t(w), _t(b), nb_cap_out,
                               compute_dtype=torch.float32)
    assert_same_grid(jo, to)
    assert (int(to.dropped) > 0) == (nb_cap_out == 5)
    assert not to.mask[-1].any() and float(to.feats[-1].abs().sum()) == 0


def _scores(shape, seed):
    """Scores drawn from a few values (many ties), with -0.0 and +0.0."""
    rng = np.random.RandomState(seed)
    vals = np.array([-1.5, -0.0, 0.0, 0.25, 0.25, 2.0, 3.5], np.float32)
    return vals[rng.randint(0, len(vals), size=shape)]


@pytest.mark.parametrize("ks", [(0,), (1,), (777,), (3000,), (10 ** 6,),
                                (500, 0), (0, 2222)])
def test_topk_mask_exact(ks):
    batches = len(ks)
    j, t = _both(*_frame(batches=batches), nb_cap=64 * batches, stride=1,
                 res=64, num_batches=batches)
    scores = _scores((j.nb_cap, B.VOL), seed=sum(ks) % 97)
    nums = np.array(ks, np.int32)
    jk = np.asarray(B.topk_mask(j, jnp.asarray(scores), jnp.asarray(nums)))
    tk = TB.topk_mask(t, _t(scores), _t(nums)).numpy()
    np.testing.assert_array_equal(tk, jk)
    live = np.asarray(j.mask & j.valid[:, None])
    per_batch = [int(v) for v in np.asarray(j.voxels_per_batch())]
    assert int(tk.sum()) == sum(min(k, n) for k, n in zip(ks, per_batch))
    assert not (tk & ~live).any()


def test_monotone_bits_order():
    x = np.array([-np.inf, -2.0, -1e-30, -0.0, 0.0, 1e-30, 3.0, np.inf],
                 np.float32)
    got = TB._monotone_bits(_t(x)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(B._monotone_bits(jnp.asarray(x))).astype(np.int64))
    assert (np.diff(got) > 0).all()


@pytest.mark.parametrize("nb_cap_out", [64, 6])
def test_prune_compact(nb_cap_out):
    j, t = _both(*_frame(), nb_cap=64, stride=1, res=64)
    scores = _scores((j.nb_cap, B.VOL), seed=11)
    keep = scores > 0.1  # leaves some blocks empty
    jp = B.prune(j, jnp.asarray(keep))
    tp = TB.prune(t, _t(keep))
    assert_same_grid(jp, tp, exact_feats=True)
    jc = B.compact(jp, nb_cap_out)
    tc = TB.compact(tp, nb_cap_out)
    assert_same_grid(jc, tc, exact_feats=True)
    assert (int(tc.dropped) > 0) == (nb_cap_out == 6)



def test_port_drops_voxels_and_blocks_outside_the_grid():
    """A deliberate difference from the JAX package, pinned here: the
    port's blockify drops voxels whose block lies outside the block grid
    (grid_dim(res) blocks per axis; a voxel past res inside the last block
    stays), and conv_up_generative drops child blocks outside the finer
    grid.  Neither counts them in `dropped`, which reads capacity overflow
    only.  The JAX twins have no range check (such a block key aliases
    another cell of the dense table); inputs inside res are not affected."""
    # a stride-2 grid of res 24 (grid coords): grid_dim 2, so blocks 0 and
    # 1 per axis, grid coords 0..31
    grid = np.array([[0, 1, 2, 3], [0, 20, 5, 5], [0, 28, 5, 5],
                     [0, 32, 5, 5], [0, -1, 5, 5], [0, 5, 40, 5]], np.int32)
    pts = grid * np.array([1, 2, 2, 2], np.int32)  # voxel coords
    valid = np.ones(len(pts), bool)
    feats = np.ones((len(pts), 1), np.float32)
    t = TB.blockify(_t(pts), _t(feats), _t(valid), nb_cap=16, stride=2,
                    res=24, num_batches=1)
    assert int(t.dropped) == 0 and int(t.count) == 2
    coords, _, n = TB.extract(t, 16, with_feats=False)
    kept = {tuple(c) for c in (coords[:int(n), 1:] // 2).tolist()}
    assert kept == {(1, 2, 3), (20, 5, 5), (28, 5, 5)}
    # children 2p + (0|1) on the stride-1 grid of res 48 (grid_dim 3):
    # those of p = 28 (56, 57) fall in its block 3 and are dropped; those
    # of p = 1 and 20 stay
    up = TB.conv_up_generative(t, torch.ones(8, 1, 1), None, 16)
    assert int(up.dropped) == 0 and int(up.voxel_count()) == 16
    coords, _, n = TB.extract(up, 64, with_feats=False)
    xs = coords[:int(n), 1]
    assert int(xs.max()) == 41 and not bool(((xs >= 48)).any())
