"""The port's conv3 (plain path on the CPU) against the JAX package's
blocks.conv3 and the Pallas kernel (interpret mode), f32, on the res-64
sphere grid of tests/test_pallas_conv.py, with the weight packing and the
split-TF32 arithmetic of the tensor-core kernel.  The CUDA kernels
themselves are checked against conv3_plain on the card by
chip_smoke.py."""

import json
import os
import subprocess
import sys

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
    """Every (ci, co) of the main path runs on the tensor cores, in f32 and
    bf16; a ci outside {1, 4, 8, 16, 32, 64} takes the CUDA-core kernel."""
    assert TK.route(ci, co, dtype) == "tc"
    assert TK.route(ci + 2, co, dtype) == "simt"


def _pack_cases(pairs):
    """(ci, co, dtype) cases: bf16 under the plain "ci-co" id, f32 under
    "f32-ci-co"."""
    return ([pytest.param(ci, co, torch.bfloat16, id=f"{ci}-{co}")
             for ci, co in pairs]
            + [pytest.param(ci, co, torch.float32, id=f"f32-{ci}-{co}")
               for ci, co in pairs])


@pytest.mark.parametrize("ci,co,dtype", _pack_cases(PAIRS))
def test_pack_weight_roundtrip(ci, co, dtype):
    w = torch.from_numpy(_weights(ci, co)[0]).to(dtype)
    packed = TK.pack_weight(w)
    assert packed.is_contiguous() and packed.dtype == dtype
    assert tuple(packed.shape) == TK.packed_shape(ci, co, dtype)
    # ci and co below 8 are padded with zeros, nothing else is added
    parts = 2 if dtype == torch.float32 else 1
    assert packed.numel() == parts * 27 * max(ci, 8) * max(co, 8)
    if dtype == torch.bfloat16:
        torch.testing.assert_close(TK.unpack_weight(packed, ci, co), w,
                                   rtol=0, atol=0)
        assert int((packed != 0).sum()) == int((w != 0).sum())
        return
    # f32: hi (part 0) is a TF32 value, its low 13 mantissa bits zero, lo
    # is hi's remainder rounded to TF32, and hi + lo gives the weight back
    # within 2^-21 relative
    hi, lo = TK.unpack_parts(packed, ci, co)
    torch.testing.assert_close((hi, lo), TK.tf32_split(w), rtol=0, atol=0)
    assert int((hi.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    torch.testing.assert_close(TK.unpack_weight(packed, ci, co), w,
                               rtol=2.0 ** -21, atol=0)
    assert int((hi != 0).sum()) == int((w != 0).sum())


@pytest.mark.parametrize("ci,co,dtype", _pack_cases([(8, 16), (32, 8)]))
def test_pack_weight_fragment_order(ci, co, dtype):
    """bf16: step (dx, dz, kc), tap dy, n tile nt, k half h, row n, column
    k holds W[dx, dy, dz, KS*kc + 8h + k, 8nt + n] (KS = 8 for ci = 8,
    else 16): lane 4g+q, whose ldmatrix reads row g at columns 2q and 2q +
    1 of core matrix (nt, h), gets the B fragment of mma.sync m16n8k{KS}.
    f32: step (dx, dz, kc), tap dy, part s (hi, lo), n tile nt, k half h,
    row n, column k holds part s of W[dx, dy, dz, 8kc + 4h + k, 8nt + n].
    Both are the K-major core matrices of the step's weights in shared
    memory."""
    g_ = torch.Generator().manual_seed(ci * co)
    w = torch.randn(3, 3, 3, ci, co, generator=g_).to(dtype)
    packed = TK.pack_weight(w)
    f32 = dtype == torch.float32
    ks = 8 if ci == 8 or f32 else 16
    wf = w.reshape(27, ci, co)
    parts = torch.stack(TK.tf32_split(wf)) if f32 else None
    rng = np.random.RandomState(0)
    for _ in range(50):
        tap, kc, nt = (rng.randint(27), rng.randint(ci // ks),
                       rng.randint(co // 8))
        g, q, r, e = (rng.randint(8), rng.randint(4), rng.randint(2),
                      rng.randint(2))
        dx, dy, dz = tap // 9, tap // 3 % 3, tap % 3
        if f32:  # e is the part s, r the k half, g the row, q the column
            assert (packed[dx, dz, kc, dy, e, nt, r, g, q]
                    == parts[e, tap, 8 * kc + 4 * r + q, 8 * nt + g])
        else:  # lane 4g + q's pair (k = 2q + e) of core matrix (nt, r)
            r %= ks // 8
            assert (packed[dx, dz, kc, dy, nt, r, g, 2 * q + e]
                    == wf[tap, ks * kc + 8 * r + 2 * q + e, 8 * nt + g])


def _conv3_3xtf32(tbg, nbrs, w, b):
    """The f32 route's arithmetic in plain torch: halo and weights split
    into TF32 hi and lo parts, lo.hi + hi.lo + hi.hi per tap accumulated
    in f32, bias added in f32, re-masked."""
    ci = tbg.channels
    hh, hl = TK.tf32_split(TK.halo(tbg.feats, nbrs))
    wh, wl = TK.tf32_split(w)
    acc = torch.zeros(tbg.nb_cap * TB.VOL, w.shape[-1])
    for dx in range(3):
        for dy in range(3):
            for dz in range(3):
                win = [p[:, dx:dx + TB.BS, dy:dy + TB.BS, dz:dz + TB.BS]
                       .reshape(-1, ci) for p in (hh, hl)]
                acc += win[1] @ wh[dx, dy, dz]
                acc += win[0] @ wl[dx, dy, dz]
                acc += win[0] @ wh[dx, dy, dz]
    return tbg.with_feats((acc + b).reshape(tbg.nb_cap, TB.VOL, -1))


@pytest.mark.parametrize("ci,co", [(1, 16), (16, 1), (8, 16), (32, 8)])
def test_split_tf32_product_matches_f32(ci, co):
    """The 3xTF32 arithmetic of the f32 tensor-core route keeps f32
    accuracy: within 1e-5 of conv3_plain in f32 and of the JAX
    blocks.conv3 at highest precision."""
    jbg, tbg = _grids(ci, seed=5)
    w, b = _weights(ci, co, seed=6)
    tn = TB.neighbor_rows(tbg)
    got = _conv3_3xtf32(tbg, tn, torch.from_numpy(w), torch.from_numpy(b))
    plain = TK.conv3_plain(tbg, tn, torch.from_numpy(w), torch.from_numpy(b),
                           compute_dtype=torch.float32)
    ref = B.conv3(jbg, B.neighbor_rows(jbg), jnp.asarray(w), jnp.asarray(b),
                  compute_dtype=jnp.float32)
    np.testing.assert_allclose(got.feats.numpy(), plain.feats.numpy(),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.feats.numpy(), np.asarray(ref.feats),
                               rtol=TOL, atol=TOL)
    # one TF32 pass (hi.hi only) would not hold the tolerance
    assert float(got.feats.abs().max()) > 1.0


def test_layer_packs_once_per_dtype():
    """BConv3 packs its kernel for the tensor-core route once per dtype,
    under the cast's key, and again only after a parameter is written; a
    co = 1 head is packed too, and in f32 the pack holds the TF32 parts."""
    from pcgcv2_torch.models.layers import BConv3

    layer, head = BConv3(16, 32), BConv3(16, 1)
    try:
        TB.set_compute_dtype("bfloat16")
        k, _ = layer.weights()
        packed = layer.packed()
        assert packed is not None and layer.packed() is packed
        torch.testing.assert_close(TK.unpack_weight(packed, 16, 32), k,
                                   rtol=0, atol=0)
        assert head.packed().shape == TK.packed_shape(16, 1, torch.bfloat16)
        with torch.no_grad():
            layer.kernel.fill_(0.5)
        packed2 = layer.packed()
        assert packed2 is not packed and bool((packed2 == 0.5).all())
        TB.set_compute_dtype("float32")
        packed32 = layer.packed()
        assert packed32.dtype == torch.float32
        assert packed32.shape == TK.packed_shape(16, 32, torch.float32)
        # 0.5 is a TF32 value: hi holds it, lo is zero
        hi, lo = TK.unpack_parts(packed32, 16, 32)
        assert bool((hi == 0.5).all()) and bool((lo == 0).all())
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


def test_library_units_are_the_same_at_either_block_side():
    """One library holds both block sides: its translation units (and so
    its name, a hash of the sources, units and flags) are the same in a
    PCGC_BLOCK_SIZE=8 process as here, each side's unit defines its side
    and instantiates `TC_PAIRS` / `WGRAD_PAIRS` of it, and conv3.cu is
    built once, as it is."""
    units = TK.units()
    code = ("import json; from pcgcv2_torch.ops import conv3 as K, "
            "blocks as B; assert B.BS == 8; print(json.dumps(K.units()))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env={**os.environ, "PCGC_BLOCK_SIZE": "8"})
    assert r.returncode == 0, r.stderr
    assert [list(u) for u in units] == json.loads(r.stdout)
    names = [n for n, _ in units]
    assert names == ["conv3", "conv3_tc_bs16", "conv3_wgrad_bs16",
                     "conv3_tc_bs8", "conv3_wgrad_bs8"]
    for name, text in units[1:]:
        src, bs = name.rsplit("_bs", 1)
        pairs = (TK.TC_PAIRS if src == "conv3_tc" else TK.WGRAD_PAIRS)[
            int(bs)]
        assert f"#define PCGC_BS {bs}\n" in text
        assert text.count("X(") == len(pairs)
        assert all(f"X({ci}, {co})" in text for ci, co in pairs)
        assert text.endswith(f'#include "{src}.cu"\n')
