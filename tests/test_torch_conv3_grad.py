"""conv3's backward in the port (`Conv3Fn`: dX by a forward conv3 with the
flipped weight, dW by `conv3_wgrad`, dbias by a masked sum) on the CPU,
against autograd through `conv3_plain` and against `jax.vjp` of the JAX
package's blocks.conv3, f32.  The grids have partial masks, rows past
`count` and neighbour misses that read the sentinel row, and the incoming
gradient is random at every slot, so the masking of dy is tested too.
The CUDA kernels (conv3_tc.cu on the flipped weight, conv3_wgrad.cu) are
held against these plain versions on the card by chip_smoke.py."""

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

# f32 sums of a few thousand products in another order: within 1e-5 of
# max |ref| of the same computation by autograd, 1e-4 of max |ref| of
# XLA's (its banded z-fold conv sums in yet another order)
TOL_PLAIN = 1e-5
TOL_JAX = 1e-4

PAIRS = [(1, 16), (16, 1), (8, 16), (32, 8), (4, 4)]


@pytest.fixture(autouse=True, scope="module")
def _production_dtypes():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax.config.update("jax_enable_x64", old)


def _grids(ci, seed=0):
    """The same grid in both packages: a res-64 sphere, nb_cap 64 (count
    below it, so rows past count exist), N(0,1) features."""
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


def _inputs(ci, co, seed):
    """Unmasked raw features, weight, bias and the incoming gradient (random
    at every slot, the sentinel row and the rows past count included)."""
    rng = np.random.RandomState(seed)
    raw = rng.randn(64, TB.VOL, ci).astype(np.float32)
    w = (rng.randn(3, 3, 3, ci, co) * 0.2).astype(np.float32)
    b = rng.randn(co).astype(np.float32)
    g = rng.randn(64, TB.VOL, co).astype(np.float32)
    return raw, w, b, g


def _port_grads(tbg, raw, w, b, g, conv):
    """Gradients of sum(conv(with_feats(raw)) * g) w.r.t. raw, w, b, and
    w.r.t. the conv's input feats themselves."""
    r = torch.from_numpy(raw).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    x = tbg.with_feats(r)
    x.feats.retain_grad()
    out = conv(x, TB.neighbor_rows(tbg), wt, bt)
    (out.feats * torch.from_numpy(g)).sum().backward()
    return r.grad, wt.grad, bt.grad, x.feats.grad


def _plain(x, nbrs, w, b):
    return TK.conv3_plain(x, nbrs, w, b, compute_dtype=torch.float32)


def _fn(x, nbrs, w, b):
    return TK.conv3(x, nbrs, w, b, compute_dtype=torch.float32)


def _close(got, ref, tol, what):
    ref = np.asarray(ref)
    err = float(np.abs(np.asarray(got) - ref).max())
    assert err <= tol * float(np.abs(ref).max()), (what, err)


@pytest.mark.parametrize("ci,co", PAIRS)
def test_conv3fn_matches_plain_autograd(ci, co):
    _, tbg = _grids(ci)
    raw, w, b, g = _inputs(ci, co, seed=ci * 100 + co)
    for counter in (TK.conv3, TK.conv3_dgrad):
        counter.launches = 0
    TK.conv3_wgrad.launches = 0
    got = _port_grads(tbg, raw, w, b, g, _fn)
    ref = _port_grads(tbg, raw, w, b, g, _plain)
    # the CPU path never touches a kernel
    assert TK.conv3.launches == TK.conv3_dgrad.launches == 0
    assert TK.conv3_wgrad.launches == 0
    for name, a, r in zip(("dX(raw)", "dW", "db"), got[:3], ref[:3]):
        _close(a.numpy(), r.numpy(), TOL_PLAIN, name)
    # dX w.r.t. the conv input itself: equal at the live slots, zero at
    # every other slot (the producer's mask discards those anyway)
    live = (tbg.mask & tbg.valid[:, None])[:, :, None].expand_as(got[3])
    _close(got[3][live].numpy(), ref[3][live].numpy(), TOL_PLAIN, "dX live")
    assert float(got[3][~live].abs().max()) == 0.0
    assert float(ref[3][~live].abs().max()) > 0.0  # the full VJP is not
    assert int(tbg.count) < tbg.nb_cap - 1  # rows past count exist


@pytest.mark.parametrize("ci,co", PAIRS)
def test_conv3fn_matches_jax_vjp(ci, co):
    jbg, tbg = _grids(ci)
    raw, w, b, g = _inputs(ci, co, seed=ci * 100 + co + 1)
    jn = B.neighbor_rows(jbg)

    def loss(r, w_, b_):
        out = B.conv3(jbg.with_feats(r), jn, w_, b_,
                      compute_dtype=jnp.float32)
        return jnp.sum(out.feats * g)

    ref = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(raw), jnp.asarray(w), jnp.asarray(b))
    got = _port_grads(tbg, raw, w, b, g, _fn)
    for name, a, r in zip(("dX(raw)", "dW", "db"), got[:3], ref):
        _close(a.numpy(), r, TOL_JAX, name)
    # the weight gradient's plain version alone, against the VJP w.r.t. W
    dw = TK.conv3_wgrad_plain(tbg.with_feats(torch.from_numpy(raw)),
                              torch.from_numpy(g), TB.neighbor_rows(tbg),
                              compute_dtype=torch.float32)
    _close(dw.numpy(), ref[1], TOL_JAX, "conv3_wgrad_plain")


def test_flip_weight_taps():
    """W'[dx, dy, dz] = W[2-dx, 2-dy, 2-dz]^T, tap by tap."""
    w = torch.from_numpy(
        np.random.RandomState(5).randn(3, 3, 3, 4, 8).astype(np.float32))
    wf = TK.flip_weight(w)
    assert wf.shape == (3, 3, 3, 8, 4) and wf.is_contiguous()
    for dx in range(3):
        for dy in range(3):
            for dz in range(3):
                assert torch.equal(wf[dx, dy, dz], w[2 - dx, 2 - dy, 2 - dz].T)
    assert torch.equal(wf[0, 1, 2], w[2, 1, 0].T)
    assert torch.equal(TK.flip_weight(wf), w)


def test_conv3fn_bf16_compute_f32_parameters():
    """bf16 compute with f32 storage and parameters: the cast weight's
    gradient comes back in bf16 and `.to` carries it to the f32 parameter;
    dX in the storage dtype.  Within bf16 rounding of the f32 gradients."""
    _, tbg = _grids(8)
    raw, w, b, g = _inputs(8, 16, seed=9)
    grads = {}
    for cd in (torch.float32, torch.bfloat16):
        r = torch.from_numpy(raw).requires_grad_(True)
        w32 = torch.from_numpy(w).requires_grad_(True)
        b32 = torch.from_numpy(b).requires_grad_(True)
        wc, bc = w32.to(cd), b32.to(cd)
        out = TK.conv3(tbg.with_feats(r), TB.neighbor_rows(tbg), wc, bc,
                       compute_dtype=cd)
        assert out.feats.dtype == torch.float32
        (out.feats * torch.from_numpy(g)).sum().backward()
        assert r.grad.dtype == w32.grad.dtype == b32.grad.dtype \
            == torch.float32
        grads[cd] = (r.grad, w32.grad, b32.grad)
    for a, r in zip(grads[torch.bfloat16], grads[torch.float32]):
        _close(a.numpy(), r.numpy(), 2e-2, "bf16")


def test_backward_wrappers_raise_off_cpu_and_cuda():
    """A wrapper runs its plain version for CPU tensors only; any other
    device is refused (CUDA launches the kernel or raises)."""
    _, tbg = _grids(4)
    meta = tbg.replace(feats=torch.empty(64, TB.VOL, 4, device="meta"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        TK.conv3_wgrad(meta, torch.empty(64, TB.VOL, 4, device="meta"),
                       TB.neighbor_rows(tbg))


def test_layer_packs_flip_once_per_step():
    """BConv3 packs flip_weight(kernel) for the input gradient once per
    cast, so once per optimizer step; under no_grad the cast stays cached
    and detached, while with grad the layer hands out a live cast.  (The
    f32 pack holds hi + lo TF32 parts: x within 2^-22 relative.)"""
    from pcgcv2_torch.models.layers import BConv3

    layer = BConv3(16, 4)
    with torch.no_grad():
        layer.kernel.normal_()
    pf = layer.packed_flip()
    assert layer.packed_flip() is pf
    torch.testing.assert_close(
        TK.unpack_weight(pf, 4, 16), TK.flip_weight(layer.kernel.detach()),
        rtol=2 ** -21, atol=0)
    k, b = layer.weights()
    assert k.requires_grad and k.grad_fn is None  # f32: the parameter
    with torch.no_grad():
        kc, _ = layer.weights()
        assert not kc.requires_grad and layer.weights()[0] is kc
    opt = torch.optim.SGD(layer.parameters(), lr=0.1)
    layer.kernel.grad = torch.ones_like(layer.kernel)
    opt.step()
    pf2 = layer.packed_flip()
    assert pf2 is not pf
    torch.testing.assert_close(
        TK.unpack_weight(pf2, 4, 16), TK.flip_weight(layer.kernel.detach()),
        rtol=2 ** -21, atol=0)
