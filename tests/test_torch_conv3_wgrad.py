"""The plan and the argument checks of conv3's weight-gradient kernel
(csrc/conv3_wgrad.cu), on the CPU.

`wgrad_plan` mirrors the kernel's own `make_plan`: every CTA computes the
27 taps of one (ci tile, co tile) split; on mma.sync each warp the m16 x
n8 fragments of its units, (tap, m16 tile) for bf16 dy and m16 tiles of
the (tap, ci) rows for f32 dy (3xTF32; tests/test_torch_conv3_wgrad_tc.py
and tests/test_torch_conv3_wgrad_tf32.py emulate those paths), on the CUDA
cores each thread a tm x tn tile of one tap's block, over every ksplit-th
voxel.  These tests walk that mapping as
the kernel does and check that it covers every entry of dW exactly once
and fits the card.  The kernel's results are held against
`conv3_wgrad_plain` by chip_smoke.py phase 7a, and `conv3_wgrad_plain`
against JAX by tests/test_torch_conv3_grad.py."""

import numpy as np
import pytest
import torch

from pcgcv2_torch.ops import blocks as TB
from pcgcv2_torch.ops import conv3 as TK

CHANNELS = (1, 4, 8, 16, 32, 64)


def _mma_entries(p):
    """Flat [tap, ci_tile, co_tile] entries that an mma.sync CTA's warps
    store: warp w owns the units w, w + 8, ... (tap, m16 tile) with every
    n8 tile; lane 4g + q holds rows g, g + 8 and columns 2q, 2q + 1 of each
    m16 x n8 fragment; rows and columns past the tiles are padding."""
    mt = -(-max(p.ci_tile, 8) // 16)
    out = []
    for w in range(TK.WGRAD_WARPS):
        for u in range(w, TK.wgrad_mma_units(p.ci_tile), TK.WGRAD_WARPS):
            tap = u // mt
            for nt in range(max(p.co_tile, 8) // 8):
                for lane in range(32):
                    for r in range(4):
                        m = u % mt * 16 + lane // 4 + 8 * (r // 2)
                        n = nt * 8 + 2 * (lane % 4) + r % 2
                        if m < p.ci_tile and n < p.co_tile:
                            out.append((tap * p.ci_tile + m) * p.co_tile + n)
    return np.array(out)


def _tf32_entries(p):
    """Flat [tap, ci_tile, co_tile] entries that a 3xTF32 CTA's warps
    store: m16 tile u holds rows 16u .. 16u + 15 of the (tap, ci) space
    (row R channel R % ci_tile of tap R // ci_tile); lane 4g + q holds its
    rows 2g, 2g + 1 and columns 2q, 2q + 1 of each n8 tile; rows past tap
    26 and columns past the co tile are padding."""
    out = []
    for u in range(TK.wgrad_tf32_units(p.ci_tile)):
        for nt in range(p.co_tile // 8):
            for lane in range(32):
                for r in range(4):
                    row = u * 16 + 2 * (lane // 4) + r // 2
                    n = nt * 8 + 2 * (lane % 4) + r % 2
                    if row < 27 * p.ci_tile and n < p.co_tile:
                        out.append(row * p.co_tile + n)
    return np.array(out)


def _check_tiles(p, bs, x_dtype, cd):
    """One CTA's tiles cover its 27 x ci_tile x co_tile sums once and fit:
    the CUDA cores' thread tiles (k-split over the voxels) and ring of 4
    planes with y rows padded by 16 bytes, or the mma.sync warp fragments
    and staged planes within half an SM's shared memory (bf16 dy: bf16
    planes; f32 dy: planes in x's dtype)."""
    if p.mma and cd == F32:
        ent = _tf32_entries(p)
        sx = torch.empty((), dtype=x_dtype).element_size()
        assert TK.wgrad_tf32_acc(p.ci_tile, p.co_tile) <= TK.WGRAD_ACC_MAX
        assert p.smem == TK.wgrad_tf32_smem(bs, p.ci_tile, p.co_tile, sx)
        assert p.smem <= TK.wgrad_tf32_smem_max(bs)
    elif p.mma:
        ent = _mma_entries(p)
        assert TK.wgrad_mma_acc(p.ci_tile, p.co_tile) <= TK.WGRAD_ACC_MAX
        assert p.smem == TK.wgrad_mma_smem(bs, p.ci_tile, p.co_tile)
        assert p.smem <= TK.WGRAD_SMEM_MMA
    else:
        ent = _thread_entries(p, p.ci_tile, p.co_tile).ravel()
        assert p.tiles * p.ksplit <= TK.WGRAD_THREADS
        assert p.tm * p.tn <= TK.WGRAD_ACC_MAX
    assert np.array_equal(np.sort(ent), np.arange(27 * p.ci_tile * p.co_tile))


def _thread_entries(p, ci_tile, co_tile):
    """Flat [tap, ci_tile, co_tile] entries of each active thread's tile,
    as the kernel maps thread t: tile t % tiles, voxel phase t // tiles."""
    mt, ntl = ci_tile // p.tm, co_tile // p.tn
    out = []
    for pt in range(p.tiles):
        m0 = (pt // ntl) % mt * p.tm
        n0 = pt % ntl * p.tn
        tap = pt // (ntl * mt)
        out.append([(tap * ci_tile + m0 + a) * co_tile + n0 + b
                    for a in range(p.tm) for b in range(p.tn)])
    return np.array(out)


F32, BF16 = torch.float32, torch.bfloat16
# (x as the grid stores it, compute dtype): the training path stores f32
DTYPES = [(F32, F32), (F32, BF16), (BF16, BF16), (BF16, F32)]
DTYPE_IDS = ["f32", "bf16", "bf16-stored", "bf16-stored-f32"]


@pytest.mark.parametrize("x_dtype,cd", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("co", CHANNELS)
@pytest.mark.parametrize("ci", CHANNELS)
def test_wgrad_plan_covers_dw_once_and_fits(ci, co, x_dtype, cd):
    p = TK.wgrad_plan(ci, co, x_dtype, cd)
    assert ci % p.ci_tile == 0 and co % p.co_tile == 0
    assert p.splits == (ci // p.ci_tile) * (co // p.co_tile)
    # the threads (or warps) of a CTA cover its 27 x ci_tile x co_tile
    # sums once
    _check_tiles(p, 16, x_dtype, cd)
    assert p.mma == (ci >= TK.WGRAD_MMA_MIN_CI
                     and (cd == BF16 or co >= TK.WGRAD_TF32_MIN_CO))
    # the splits (co tile fastest, as blockIdx.y) cover dW[27, ci, co] once
    seen = np.zeros((27, ci, co), dtype=np.int64)
    for split in range(p.splits):
        ci0 = split // (co // p.co_tile) * p.ci_tile
        co0 = split % (co // p.co_tile) * p.co_tile
        seen[:, ci0:ci0 + p.ci_tile, co0:co0 + p.co_tile] += 1
    assert (seen == 1).all()
    # shared memory: the ring of 4 planes (y rows padded by 16 bytes) and
    # two dy planes, or the k-split sums after them; with the 8 KB slot
    # list within the 227 KB of a CTA
    sx = torch.empty((), dtype=x_dtype).element_size()
    sg = torch.empty((), dtype=cd).element_size()
    ring = (4 * 18 * (18 * p.ci_tile * sx + 16)
            + 2 * TK.WGRAD_THREADS * p.co_tile * sg)
    if not p.mma:
        assert p.smem == max(ring,
                             p.ksplit * 27 * p.ci_tile * p.co_tile * 4)
    assert p.smem + 4096 * 2 <= 227 * 1024
    assert p.g * p.splits <= 512 and p.g >= 8


def test_wgrad_plan_keeps_narrow_instances_whole():
    """Splits come only where the accumulators or shared memory force
    them: every pair with 27 ci co <= 16384 that fits runs in one split,
    the stage-2 16 -> 4 among them, with 512 persistent CTAs."""
    for x_dtype, cd in DTYPES:
        p = TK.wgrad_plan(16, 4, x_dtype, cd)
        assert (p.splits, p.g, p.ci_tile, p.co_tile) == (1, 512, 16, 4)
    # f32 dy (3xTF32, two CTAs on an SM): 64 -> 64 takes a co tile of 32
    # (f32 dy of two 256-slot planes of 64 channels is 131,072 B) over a
    # ci tile of 8 (a ring of 4 x 41,472 B), 107,008 B in all
    f32 = TK.wgrad_plan(64, 64, F32, F32)
    assert (f32.ci_tile, f32.co_tile, f32.splits, f32.g) == (8, 32, 16, 32)
    assert f32.smem == TK.wgrad_tf32_smem_max(16) == 107008
    # f32 64 -> 16: a 16-channel ring (4 x 82,944 B) with 32,768 B of dy
    # does not fit; 64 -> 8 stays on the CUDA cores, whole
    assert TK.wgrad_plan(64, 16, F32, F32).ci_tile == 8
    assert TK.wgrad_plan(64, 8, BF16, F32).ci_tile == 64
    # bf16 dy (mma.sync): 64 -> 16 splits ci for the accumulators (two
    # tiles of 32: 14 units of a warp x 2 n8 tiles x 4 > 64), 64 -> 8 for
    # two CTAs on an SM (a 64-channel bf16 ring is 165,888 B)
    assert TK.wgrad_plan(64, 16, F32, BF16).ci_tile == 32
    assert TK.wgrad_plan(64, 8, BF16, BF16).ci_tile == 32


def _meta_grid(nb=64, ci=16, feats_dtype=torch.float32):
    m = "meta"
    return TB.BlockGrid(
        feats=torch.empty(nb, TB.VOL, ci, dtype=feats_dtype, device=m),
        coords=torch.empty(nb, 4, dtype=torch.int32, device=m),
        mask=torch.empty(nb, TB.VOL, dtype=torch.bool, device=m),
        table=torch.empty(8, dtype=torch.int32, device=m),
        count=torch.empty((), dtype=torch.int32, device=m),
        dropped=torch.empty((), dtype=torch.int32, device=m),
        stride=1, res=64, num_batches=1)


def test_wgrad_reads_the_stored_grid_without_a_cast():
    """bf16 compute on an f32-stored grid: the kernel is handed the grid's
    own f32 feats (it rounds them to bf16 as it reads them), not a bf16
    copy of the whole grid; dy comes in the compute dtype."""
    bg = _meta_grid()
    dy = torch.empty(64, TB.VOL, 4, dtype=torch.bfloat16, device="meta")
    nbrs = torch.empty(64, 3, 3, 3, dtype=torch.int32, device="meta")
    x, g, nb, mask = TK._wgrad_inputs(bg, dy, nbrs, torch.bfloat16)
    assert x is bg.feats and x.dtype == torch.float32
    assert g is dy and mask is bg.mask and nb is nbrs
    # a bf16-stored grid is read as bf16, also under f32 compute
    bg16 = _meta_grid(feats_dtype=torch.bfloat16)
    x, g, _, _ = TK._wgrad_inputs(bg16, dy, nbrs, torch.float32)
    assert x is bg16.feats and g.dtype == torch.float32


@pytest.mark.parametrize("bad", ["dy", "nbrs_dtype", "nbrs_shape", "mask",
                                 "count", "channels", "feats_dtype"])
def test_wgrad_inputs_raise(bad):
    m = "meta"
    bg = _meta_grid(feats_dtype=torch.float16 if bad == "feats_dtype"
                    else torch.float32)
    dy = torch.empty(64, TB.VOL, 3 if bad == "channels" else 4, device=m)
    nbrs = torch.empty(64, 3, 3, 3, dtype=torch.int32, device=m)
    if bad == "dy":
        dy = torch.empty(32, TB.VOL, 4, device=m)
    elif bad == "nbrs_dtype":
        nbrs = nbrs.long()
    elif bad == "nbrs_shape":
        nbrs = torch.empty(64, 27, dtype=torch.int32, device=m)
    elif bad == "mask":
        bg = bg.replace(mask=torch.empty(64, TB.VOL, dtype=torch.uint8,
                                         device=m))
    elif bad == "count":
        bg = bg.replace(count=torch.empty((), dtype=torch.int64, device=m))
    err = NotImplementedError if bad == "channels" else ValueError
    with pytest.raises(err):
        TK._wgrad_inputs(bg, dy, nbrs, torch.bfloat16)


# --- 8^3 blocks (PCGC_BLOCK_SIZE=8), planned in this BS = 16 process -------


@pytest.mark.parametrize("x_dtype,cd", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("ci,co", TK.WGRAD_PAIRS[8])
def test_wgrad_plan_at_bs8_covers_dw_once_and_fits(ci, co, x_dtype, cd):
    """The 8^3 instances (the model's pairs) plan as the 16^3 ones do, with
    10 x 10 staged planes and dy buffers of one 8 x 8 plane."""
    p = TK.wgrad_plan(ci, co, x_dtype, cd, bs=8)
    assert ci % p.ci_tile == 0 and co % p.co_tile == 0
    assert p.splits == (ci // p.ci_tile) * (co // p.co_tile)
    _check_tiles(p, 8, x_dtype, cd)
    assert p.mma == (ci >= TK.WGRAD_MMA_MIN_CI
                     and (cd == BF16 or co >= TK.WGRAD_TF32_MIN_CO))
    sx = torch.empty((), dtype=x_dtype).element_size()
    sg = torch.empty((), dtype=cd).element_size()
    ring = 4 * 10 * (10 * p.ci_tile * sx + 16) + 2 * 64 * p.co_tile * sg
    if not p.mma:
        assert p.smem == max(ring,
                             p.ksplit * 27 * p.ci_tile * p.co_tile * 4)
    # the row scan: 256 threads x 2 mask bytes = the 512 slots of a block
    assert TK.WGRAD_THREADS * 2 == 8 ** 3
    assert p.smem + 512 * 2 <= 227 * 1024
    assert p.g * p.splits <= 512 and p.g >= 8
    # the 16^3 plan of the same instance is unchanged by the bs argument
    assert TK.wgrad_plan(ci, co, x_dtype, cd) == TK.wgrad_plan(
        ci, co, x_dtype, cd, bs=16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("bs", [16, 8])
def test_tc_plan_fits_and_tiles_every_output_once(bs, dtype):
    """conv3_tc.cu's tiling at every instance of a block side: one thread
    per (y, z) voxel of a CTA's rows in each of the planes of a step (32
    per warp, two m16 tiles; whole warpgroups), the CTAs of a row
    covering its bs^3 outputs once, the mask slab a whole number of words
    per thread, the plane ring within a CTA's shared memory; 8^3 blocks
    whole in one CTA, without a y-split."""
    for ci, co in TK.TC_PAIRS[bs]:
        p = TK.tc_plan(ci, co, dtype, bs=bs)
        assert p.threads % 32 == 0 and p.threads == p.ps * p.rows * bs
        assert p.xp % p.ps == 0
        assert p.threads % 128 == 0
        assert p.grid[0] * p.xp == bs and p.grid[1] * p.rows == bs
        assert (p.xp * p.rows * bs) % (4 * p.threads) == 0
        assert p.smem <= TK.TC_SMEM_MAX
        if bs == 8:
            assert (p.xp, p.rows, p.grid) == (8, 8, (1, 1))
    if bs == 16:  # the one y-split: f32 at ci = 64, in half planes
        assert TK.tc_plan(64, 64, dtype, bs=16).rows == (
            8 if dtype == torch.float32 else 16)


def test_bs8_instances_cover_the_model():
    """Every conv3 of the full-width model, and of its input gradients,
    has an 8^3 tensor-core instance, and every weight gradient an 8^3
    conv3_wgrad instance: the 8^3 path has no conv3 that could only
    raise."""
    from pcgcv2_torch.config import ModelConfig
    from pcgcv2_torch.models.layers import BConv3
    from pcgcv2_torch.models.pcc import PCCModel

    pairs = {(m.kernel.shape[3], m.kernel.shape[4])
             for m in PCCModel(ModelConfig()).modules()
             if isinstance(m, BConv3)}
    assert pairs == set(TK.MODEL_PAIRS) == set(TK.WGRAD_PAIRS[8])
    assert pairs | {(co, ci) for ci, co in pairs} == set(TK.TC_PAIRS[8])
    for ci, co in TK.TC_PAIRS[8]:
        assert TK.route(ci, co, torch.bfloat16, bs=8) == "tc"
    # a pair the model does not use has no 8^3 instance
    assert TK.route(64, 32, torch.float32, bs=8) == "simt"


@pytest.mark.parametrize("bs", [8, 12])
def test_wrappers_raise_where_no_instance(bs, monkeypatch):
    """At a block side other than 8 or 16 the forward and dW wrappers
    raise; at 8, conv3.cu (16^3 only) and a pair outside the 8^3 sets
    raise too, rather than fall back."""
    monkeypatch.setattr(TB, "BS", bs)
    monkeypatch.setattr(TB, "VOL", bs ** 3)
    m = "meta"
    bg = _meta_grid(ci=64).replace(
        feats=torch.empty(64, bs ** 3, 64, device=m),
        mask=torch.empty(64, bs ** 3, dtype=torch.bool, device=m))
    nbrs = torch.empty(64, 3, 3, 3, dtype=torch.int32, device=m)
    w = torch.empty(3, 3, 3, 64, 32, device=m)
    with pytest.raises(NotImplementedError):
        TK._check(bg, nbrs, w, None, torch.float32, None, "simt")
    dy = torch.empty(64, bs ** 3, 32, device=m)
    with pytest.raises(NotImplementedError):
        TK._wgrad_inputs(bg, dy, nbrs, torch.float32)
    if bs == 8:  # a model pair passes the checks
        w16 = torch.empty(3, 3, 3, 64, 16, device=m)
        TK._check(bg, nbrs, w16, None, torch.float32,
                  torch.empty(TK.packed_shape(64, 16, torch.float32),
                              device=m), "tc")
        TK._wgrad_inputs(bg, torch.empty(64, 512, 16, device=m), nbrs,
                         torch.float32)
