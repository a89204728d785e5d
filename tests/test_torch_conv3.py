"""The port's conv3 (plain path on the CPU) against the JAX package's
blocks.conv3 and the Pallas kernel (interpret mode), f32, on the res-64
sphere grid of tests/test_pallas_conv.py.  The CUDA kernel itself is
checked against conv3_plain on the card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcgcv2_torch.ops import blocks as TB
from pcgcv2_torch.ops import conv3 as TK
from pcgcv2_tpu.data.synthetic import sphere_cloud
from pcgcv2_tpu.data.voxelize import collate
from pcgcv2_tpu.ops import blocks as B
from pcgcv2_tpu.ops.pallas_conv import conv3_pallas

TOL = 1e-5  # f32, different summation order


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


def _grids(ci, seed=0):
    """The same BlockGrid in both packages (sphere 20, nb_cap 64)."""
    cloud = sphere_cloud(20, density=1.5, seed=7)
    coords, valid = collate([cloud], capacity=4096)
    feats = np.random.RandomState(seed).randn(4096, ci).astype(np.float32)
    jbg = B.blockify(jnp.asarray(coords), jnp.asarray(feats),
                     jnp.asarray(valid), nb_cap=64, stride=1, res=64,
                     num_batches=1)
    tbg = TB.blockify(torch.from_numpy(coords), torch.from_numpy(feats),
                      torch.from_numpy(valid), nb_cap=64, stride=1, res=64,
                      num_batches=1)
    return jbg, tbg


def _weights(ci, co, seed=1):
    rng = np.random.RandomState(seed)
    w = (rng.randn(3, 3, 3, ci, co) * 0.1).astype(np.float32)
    b = rng.randn(co).astype(np.float32)
    return w, b


# every (ci, co) class of the shipped checkpoint, ci=1 and co=1 included
PAIRS = [(1, 16), (4, 4), (4, 8), (8, 8), (8, 16), (16, 4), (16, 16),
         (16, 32), (32, 8), (32, 32), (64, 16), (64, 64), (16, 1), (32, 1),
         (64, 1)]


@pytest.mark.parametrize("ci,co", PAIRS)
def test_conv3_plain_matches_jax(ci, co):
    jbg, tbg = _grids(ci)
    w, b = _weights(ci, co)
    jn = B.neighbor_rows(jbg)
    tn = TB.neighbor_rows(tbg)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    ref = B.conv3(jbg, jn, jnp.asarray(w), jnp.asarray(b),
                  compute_dtype=jnp.float32)
    TK.conv3.launches = 0
    got = TK.conv3(tbg, tn, torch.from_numpy(w), torch.from_numpy(b),
                   compute_dtype=torch.float32)
    # a CPU tensor takes the plain path and never touches the kernel
    assert TK.conv3.launches == 0
    np.testing.assert_allclose(got.feats.numpy(), np.asarray(ref.feats),
                               rtol=TOL, atol=TOL)
    assert np.asarray(jbg.mask).any()


def test_conv3_plain_matches_pallas_interpret():
    ci, co = 16, 32
    jbg, tbg = _grids(ci, seed=3)
    w, b = _weights(ci, co, seed=4)
    ref = conv3_pallas(jbg, B.neighbor_rows(jbg), jnp.asarray(w),
                       jnp.asarray(b), compute_dtype=jnp.float32,
                       interpret=True)
    got = TK.conv3_plain(tbg, TB.neighbor_rows(tbg), torch.from_numpy(w),
                         torch.from_numpy(b), compute_dtype=torch.float32)
    np.testing.assert_allclose(got.feats.numpy(), np.asarray(ref.feats),
                               rtol=TOL, atol=TOL)


def test_halo_reads_sentinel_for_misses():
    """Halo cells outside the occupied neighbourhood come from the zero
    sentinel row; the centre 16^3 is the block itself."""
    _, tbg = _grids(2)
    nbrs = TB.neighbor_rows(tbg)
    h = TK.halo(tbg.feats, nbrs)
    n = int(tbg.count)
    np.testing.assert_array_equal(
        h[:n, 1:-1, 1:-1, 1:-1].reshape(n, TB.VOL, 2).numpy(),
        tbg.feats[:n].numpy())
    miss = (nbrs[:n] == tbg.nb_cap - 1).numpy()
    assert miss.any()
    assert float(tbg.feats[-1].abs().sum()) == 0.0


def test_conv3_cpu_path_runs_any_channel_count():
    """On the CPU any co runs (plain path); the kernel's shape checks apply
    to CUDA tensors only."""
    _, tbg = _grids(4)
    w, b = _weights(4, 3)
    out = TK.conv3(tbg, TB.neighbor_rows(tbg), torch.from_numpy(w),
                   torch.from_numpy(b))
    assert out.feats.shape == (64, TB.VOL, 3)


def test_layer_casts_weights_once_per_dtype():
    """A layer hands its op weights in the compute dtype, cast once per
    dtype, and casts again after its parameters are written."""
    from pcgcv2_torch.models.layers import BConv3

    layer = BConv3(4, 8)
    try:
        TB.set_compute_dtype("bfloat16")
        k, b = layer.weights()
        assert (k.dtype, b.dtype) == (torch.bfloat16, torch.bfloat16)
        assert layer.weights()[0] is k
        with torch.no_grad():
            layer.kernel.fill_(1.5)
        k2, _ = layer.weights()
        assert k2 is not k and bool((k2 == 1.5).all())
        TB.set_compute_dtype("float32")
        assert layer.weights()[0].dtype == torch.float32
    finally:
        TB.set_compute_dtype("float32")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ci,co", PAIRS)
def test_route(ci, co, dtype):
    """bf16 with ci, co >= 4 runs on the tensor cores; f32 and the ci = 1 /
    co = 1 convs stay on the CUDA-core kernel."""
    want = ("tc" if dtype == torch.bfloat16 and min(ci, co) >= 4
            else "simt")
    assert TK.route(ci, co, dtype) == want


TC_PAIRS = [(ci, co) for ci, co in PAIRS if min(ci, co) >= 4]


@pytest.mark.parametrize("ci,co", TC_PAIRS)
def test_pack_weight_roundtrip(ci, co):
    w = torch.from_numpy(_weights(ci, co)[0]).to(torch.bfloat16)
    packed = TK.pack_weight(w)
    assert packed.is_contiguous() and packed.dtype == torch.bfloat16
    torch.testing.assert_close(TK.unpack_weight(packed, ci, co), w,
                               rtol=0, atol=0)
    # ci and co below 8 are padded with zeros, nothing else is added
    assert packed.numel() == 27 * max(ci, 8) * max(co, 8)
    assert int((packed != 0).sum()) == int((w != 0).sum())


@pytest.mark.parametrize("ci,co", [(8, 16), (32, 8)])
def test_pack_weight_fragment_order(ci, co):
    """Lane 4g+q of n tile nt holds W[tap, KS*kc + 8r + 2q + e, 8nt + g],
    the B fragment of mma.sync m16n8k{KS} (KS = 8 for ci = 8, else 16)."""
    w = torch.arange(27 * ci * co, dtype=torch.float32).reshape(
        3, 3, 3, ci, co)
    packed = TK.pack_weight(w)
    ks = 8 if ci == 8 else 16
    wf = w.reshape(27, ci, co)
    rng = np.random.RandomState(0)
    for _ in range(50):
        tap, kc, nt = (rng.randint(27), rng.randint(ci // ks),
                       rng.randint(co // 8))
        g, q, r, e = (rng.randint(8), rng.randint(4), rng.randint(ks // 8),
                      rng.randint(2))
        assert (packed[tap, kc, nt, g, q, r, e]
                == wf[tap, ks * kc + 8 * r + 2 * q + e, 8 * nt + g])


def test_layer_packs_once_per_dtype():
    """BConv3 packs its bf16 kernel for the tensor-core route once, under
    the cast's key: again only after a parameter is written; not in f32 and
    not for a co = 1 head."""
    from pcgcv2_torch.models.layers import BConv3

    layer, head = BConv3(16, 32), BConv3(16, 1)
    try:
        TB.set_compute_dtype("bfloat16")
        k, _ = layer.weights()
        packed = layer.packed()
        assert packed is not None and layer.packed() is packed
        torch.testing.assert_close(TK.unpack_weight(packed, 16, 32), k,
                                   rtol=0, atol=0)
        assert head.packed() is None
        with torch.no_grad():
            layer.kernel.fill_(0.5)
        packed2 = layer.packed()
        assert packed2 is not packed and bool((packed2 == 0.5).all())
        TB.set_compute_dtype("float32")
        assert layer.packed() is None
    finally:
        TB.set_compute_dtype("float32")


def test_kernel_launch_needs_cuda_tensors():
    """`launch` runs a kernel or raises; it never takes the plain path."""
    _, tbg = _grids(8)
    w, b = _weights(8, 8)
    wb = torch.from_numpy(w).to(torch.bfloat16)
    with pytest.raises(ValueError, match="cuda"):
        TK.launch("tc", tbg, TB.neighbor_rows(tbg), wb,
                  torch.from_numpy(b).to(torch.bfloat16), torch.bfloat16,
                  TK.pack_weight(wb))
