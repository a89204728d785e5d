"""conv3_wgrad.cu's f32 instances (3xTF32 on mma.sync m16n8k8), on the
CPU: the rounding, the layouts and the plan, and a plain emulation of the
kernel's launch.

The kernel cannot run here, so `emulate` walks what one launch of
`wgrad_mma_kernel` with f32 dy does, in numpy, with the kernel's own index
functions: the work items of G persistent CTAs, the row's slot list, x
copied in its own dtype into sub-planes of 32-byte rows and f32 dy rows
into a byte array, with zero dy rows up to the next multiple of 8, the K
chunks of 8 listed voxels in list order, each lane's rows 2g and 2g + 1 of
its m16 tiles of the (tap, ci) space (a ci tile of 8 packs two taps into a
tile) read at the staged voxel v + tap of its list entries
(past the list, the last entry; past tap 26, tap 0), the split of both
operands into tf32 hi and lo (`tf32_rna`), the m16n8k8 fragment layouts
(each operand's low 13 bits cleared, as the mma reads them) and the three
products, the small terms first (two for a bf16 x, whose lo is 0), of a
chunk into a fresh fragment added to the accumulator, the epilogue's lane
-> (tap, ci, co) entries, and the second kernel's fixed-order sum of the
CTAs' partials.  Shared memory the launch has not written holds random
bytes, NaNs among them: a read of it that reached a stored entry would
show.  Every instance here is one the plan ships (f32 dy at ci >= 8 and
co >= 16: ci and co tiles from 8).

Tolerance: the emulated products of tf32 parts are exact, the lo.lo term
(~2^-22 of a product) is dropped, and the sums run in f32 in another order
than conv3_wgrad_plain's matmuls: within 1e-5 of max |ref| of
conv3_wgrad_plain in f32 and of jax.grad of the JAX package's blocks.conv3
in f32 on the same inputs.  On the card chip_smoke.py holds the kernel
itself to autograd through conv3_plain (phases 7a, 9d), and
tests/torch_kernel_bits_witness.py to an f64 reference beside the CUDA-core
kernel it replaces."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcgcv2_torch.ops import blocks as TB
from pcgcv2_torch.ops import conv3 as TK
from pcgcv2_tpu.ops import blocks as B
from tests.test_torch_conv3_wgrad_tc import _close, _grid, halo_src, work_items

TOL = 1e-5
F32, BF16 = torch.float32, torch.bfloat16
RED_Y, AHEAD, WARPS = 8, 1, 8
SMEM_SM = 233472  # shared memory of an SM, bytes


# --- tf32 rounding ----------------------------------------------------------


def tf32_rna(a):
    """The kernel's tf32_rna: f32 -> tf32 bits (uint32) in integer
    arithmetic, (bits + 0x1000) & 0xffffe000."""
    u = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return (u + np.uint32(0x1000)) & np.uint32(0xffffe000)


def cvt_rna(a):
    """cvt.rna.tf32.f32 modelled in f64: to the nearest multiple of the
    tf32 ulp (10 mantissa bits, 2^-136 below the normal range), ties away
    from zero, beyond the largest finite tf32 to infinity."""
    x = np.asarray(a, dtype=np.float32).astype(np.float64)
    _, e = np.frexp(np.abs(x))
    ulp = np.ldexp(1.0, np.maximum(e - 11, -136))
    r = np.floor(np.abs(x) / ulp + 0.5) * ulp
    r = np.where(r > (2 - 2.0 ** -10) * 2.0 ** 127, np.inf, r)
    return np.copysign(r, x).astype(np.float32)


def _bits(*words):
    return np.array(words, dtype=np.uint32).view(np.float32)


def test_tf32_rna_is_cvt_rna():
    """The integer rounding gives cvt.rna's bits: ties (away from zero),
    either side of a tie, subnormals (a subnormal tie, the largest
    subnormal rounding up to the smallest normal), +-0, the largest tf32,
    FLT_MAX and the values that round past the largest tf32 to infinity,
    and random finite values."""
    special = [0x00000000, 0x3f800000, 0x3f801000, 0x3f800fff, 0x3f801001,
               0x3f803000, 0x3f802fff, 0x00000001, 0x00000fff, 0x00001000,
               0x00001001, 0x00003000, 0x007fffff, 0x007ff000, 0x00800000,
               0x00800fff, 0x00801000, 0x7f7fe000, 0x7f7fefff, 0x7f7ff000,
               0x7f7fffff, 0x4b7ff000, 0x3effffff]
    x = _bits(*special, *(w | 0x80000000 for w in special))
    rng = np.random.RandomState(0)
    r = rng.randint(0, 2 ** 32, size=100000, dtype=np.uint64).astype(
        np.uint32)
    r = r[(r & 0x7f800000) != 0x7f800000]  # finite
    x = np.concatenate([x, r.view(np.float32)])
    got = tf32_rna(x)
    want = cvt_rna(x).view(np.uint32)
    assert np.array_equal(got, want)
    # the named cases, as values: ties go away from zero, the largest
    # subnormal reaches the smallest normal, FLT_MAX overflows
    v = tf32_rna(_bits(0x3f801000, 0xbf801000, 0x007fffff, 0x00001000,
                       0x7f7fffff, 0x7f7fe000))
    assert list(v) == [0x3f802000, 0xbf802000, 0x00800000, 0x00002000,
                       0x7f800000, 0x7f7fe000]


# --- layouts ----------------------------------------------------------------


def chan_at(c, sx, sub_b):
    """Byte of channel c of a staged voxel of sx-byte channels, beside its
    row: sub-plane c * sx // 32 (sub_b bytes each), as TCfg::chan_at."""
    return c * sx // 32 * sub_b + c * sx % 32


# the ci tiles of the shipped 3xTF32 plans (test_tf32_plan_is_make_plans_rule)
CI_TILES = [8, 16, 32]


@pytest.mark.parametrize("cit", CI_TILES)
@pytest.mark.parametrize("sx", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("slots", [4, 10], ids=["ring", "whole"])
def test_staged_layout_is_conflict_free(cit, sx, slots):
    """Staged x (sub-planes of `slots` x PLANE 32-byte rows, a voxel's
    channels across them) fills the ring once; a 16-byte copy never
    straddles a row; a voxel's address is its staged row * 32 plus a
    constant per channel, so a lane adds one offset per unit; and any 4
    consecutive rows of a sub-plane (a z run of a surface) put a 32-byte
    piece in the 4 bank groups of a 128-byte line, so a half warp's 64-bit
    loads of f32 pairs or a warp's 32-bit loads of bf16 pairs of 4 voxels,
    and the 4 dy rows of a K half, touch 32 distinct banks, with no XOR
    swizzle."""
    plane = 18 * 18 if slots == 4 else 10 * 10
    xb = TK.wgrad_tf32_row(cit, sx)
    assert xb == max(cit * sx, 32)
    sub_b = slots * plane * 32
    offs = np.array([(q * plane + r) * 32 + chan_at(c, sx, sub_b)
                     for q in range(slots) for r in range(plane)
                     for c in range(cit)])
    assert len(set(offs)) == len(offs)
    assert offs.max() + sx <= slots * plane * xb
    assert cit * sx % 16 == 0
    for c in range(0, cit, 16 // sx):
        start = chan_at(c, sx, sub_b)
        assert start // 32 == (start + 15) // 32
    for r0 in range(60):
        for sub in range(xb // 32):
            banks = {(sub * sub_b + (r0 + d) * 32 + w) // 4 % 32
                     for d in range(4) for w in range(0, 32, 4)}
            assert len(banks) == 32


_LANE = np.arange(32)
_G, _Q = _LANE // 4, _LANE % 4


def _unit_rows(u, cit, r):
    """(tap, channel, exists) of row 2g + r of m16 tile u, per lane: row R
    = 16u + 2g + r of the (tap, ci) space is channel R % cit of tap R //
    cit (fragment rows g and g + 8 are rows 2g and 2g + 1)."""
    row = np.asarray(u)[..., None] * 16 + 2 * _G + r
    return row // cit, row % cit, row // cit < 27


def mma(c, a, b):
    """mma.sync m16n8k8 row.col, f32 d = a b + c, for every unit u and n8
    tile t: a [U, 32, 4] bits (a0 row g k q, a1 row g + 8 k q, a2 row g k q
    + 4, a3 row g + 8 k q + 4), b [T, 32, 2] bits (b0 k q col g, b1 k q + 4
    col g), c and the result [U, T, 32, 4] f32 (c0, c1 row g cols 2q, 2q +
    1; c2, c3 row g + 8).  The 8 products and c are summed exactly and
    rounded once."""
    # the mma reads the tf32 part of each operand: its low 13 bits cleared
    f = lambda w: (w.astype(np.uint32) & np.uint32(0xffffe000)).view(
        np.float32).astype(np.float64)
    A = np.zeros((a.shape[0], 16, 8))
    Bm = np.zeros((b.shape[0], 8, 8))
    d = np.empty_like(c)
    with np.errstate(invalid="ignore", over="ignore"):  # NaN garbage
        for r, (dm, dk) in enumerate(((0, 0), (8, 0), (0, 4), (8, 4))):
            A[:, _G + dm, _Q + dk] = f(a[:, :, r])
        for r in range(2):
            Bm[:, _Q + 4 * r, _G] = f(b[:, :, r])
        D = np.einsum("umk,tkn->utmn", A, Bm)
        for h in range(2):
            for e in range(2):
                d[..., 2 * h + e] = (c[..., 2 * h + e]
                                     + D[:, :, _G + 8 * h, 2 * _Q + e])
    return d


@pytest.mark.parametrize("cot", [16, 32])
@pytest.mark.parametrize("cit", CI_TILES)
def test_fragments_with_the_row_permutation(cit, cot):
    """Lane 4g + q loads rows 2g, 2g + 1 of each m16 tile (one voxel's
    adjacent channels) into fragment rows g, g + 8, and the epilogue
    stores them back there, every n8 tile of the co tile: the m16n8k8
    products of the packed (tap, ci) rows equal X^T dY for every tap,
    channel and column, once."""
    rng = np.random.RandomState(cit + cot)
    units, nt = TK.wgrad_tf32_units(cit), cot // 8
    X = rng.randn(27, 8, cit).astype(np.float32)  # [tap, k, ci]
    Y = rng.randn(8, cot).astype(np.float32)      # [k, co]
    a = np.zeros((units, 32, 4), np.uint32)
    for h in range(2):
        for r in range(2):
            tap, ch, ok = _unit_rows(np.arange(units), cit, r)
            v = np.where(ok, X[np.minimum(tap, 26), _Q + 4 * h, ch], 0)
            a[:, :, 2 * h + r] = tf32_rna(v)
    b = np.stack([np.stack([tf32_rna(Y[_Q + 4 * h, t * 8 + _G])
                            for h in range(2)], -1) for t in range(nt)])
    acc = mma(np.zeros((units, nt, 32, 4), np.float32), a, b)
    out = np.full((27, cit, cot), np.nan)
    for e in range(4):
        tap, ch, ok = _unit_rows(np.arange(units), cit, e // 2)
        sel = np.nonzero(ok)
        for t in range(nt):
            n = np.broadcast_to(t * 8 + 2 * _Q + e % 2, ok.shape)[sel]
            assert np.isnan(out[tap[sel], ch[sel], n]).all()
            out[tap[sel], ch[sel], n] = acc[:, t, :, e][sel]
    Xr = tf32_rna(X).view(np.float32).astype(np.float64)
    ref = np.einsum("tkc,kn->tcn", Xr, tf32_rna(Y).view(np.float32))
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


# --- the plan ---------------------------------------------------------------


def _tf32_instances():
    return [(bs, ci, co, xd) for bs in TK.BLOCK_SIDES
            for ci, co in TK.WGRAD_PAIRS[bs] for xd in (F32, BF16)]


@pytest.mark.parametrize("bs,ci,co,x_dtype", _tf32_instances(),
                         ids=lambda v: str(v).replace("torch.", ""))
def test_tf32_plan_is_make_plans_rule(bs, ci, co, x_dtype):
    """wgrad_plan's f32 dy choice is make_plan's: at ci >=
    WGRAD_MMA_MIN_CI and co >= WGRAD_TF32_MIN_CO the first (widest co
    tile, then widest ci tile, both from 8) whose accumulators and staging
    fit two CTAs on an SM, its warps' m16 tiles storing every dW entry of
    the split once; else the CUDA cores' plan."""
    p = TK.wgrad_plan(ci, co, x_dtype, F32, bs=bs)
    assert p.mma == (ci >= TK.WGRAD_MMA_MIN_CI
                     and co >= TK.WGRAD_TF32_MIN_CO)
    if not p.mma:
        assert p == TK.wgrad_plan(ci, co, x_dtype, F32, bs=bs,
                                  mma_min_ci=128)
        return
    sx = torch.empty((), dtype=x_dtype).element_size()
    limit = SMEM_SM // 2 - 1024 - (2 * bs ** 3 + 512)
    assert TK.wgrad_tf32_smem_max(bs) == limit
    fits = [(cot, cit) for cot in (64, 32, 16, 8) if cot <= co
            for cit in (64, 32, 16, 8) if cit <= ci
            if TK.wgrad_tf32_acc(cit, cot) <= TK.WGRAD_ACC_MAX
            and TK.wgrad_tf32_smem(bs, cit, cot, sx) <= limit]
    assert (p.co_tile, p.ci_tile) == fits[0]
    assert p.ci_tile in CI_TILES and p.co_tile in (16, 32)
    hs, xb = bs + 2, max(p.ci_tile * sx, 32)
    dyb = p.co_tile * 4
    assert p.smem == (hs ** 3 * xb + bs ** 3 * dyb if bs == 8
                      else 4 * hs * hs * xb + 2 * bs * bs * dyb)
    assert p.splits == (ci // p.ci_tile) * (co // p.co_tile)
    assert p.g == max(8, 512 // p.splits)
    # the epilogue's entries: warp w's units w, w + 8, ...
    units = TK.wgrad_tf32_units(p.ci_tile)
    seen = np.zeros((27, p.ci_tile, p.co_tile), np.int64)
    per_warp = np.zeros(WARPS, np.int64)
    for u in range(units):
        per_warp[u % WARPS] += 1
        for e in range(4):
            tap, ch, ok = _unit_rows(u, p.ci_tile, e // 2)
            for nt in range(p.co_tile // 8):
                n = np.broadcast_to(nt * 8 + 2 * _Q + e % 2, ok.shape)
                np.add.at(seen, (tap[ok], ch[ok], n[ok]), 1)
    assert (seen == 1).all()
    assert per_warp.max() * (p.co_tile // 8) * 4 == \
        TK.wgrad_tf32_acc(p.ci_tile, p.co_tile) <= TK.WGRAD_ACC_MAX


# --- the emulation ----------------------------------------------------------


class _Kernel:
    """The constants of one 3xTF32 instance, as TCfg."""

    def __init__(self, ci, co, bs, plan, sx):
        self.ci, self.co, self.bs, self.p, self.sx = ci, co, bs, plan, sx
        self.hs = bs + 2
        self.plane = self.hs * self.hs
        self.cit, self.cot = plan.ci_tile, plan.co_tile
        self.nsub = TK.wgrad_tf32_row(self.cit, sx) // 32
        self.nt = self.cot // 8
        self.units = TK.wgrad_tf32_units(self.cit)
        self.whole = bs == 8
        self.slots = self.hs if self.whole else 3 + AHEAD
        self.sub_b = self.slots * self.plane * 32
        self.dyrows = bs ** 3 if self.whole else bs * bs
        self.gbuf_b = self.dyrows * self.cot * 4
        self.ring_b = self.nsub * self.sub_b
        assert plan.smem == self.ring_b + (1 if self.whole else 2) \
            * self.gbuf_b

    def chan_at(self, c):
        return chan_at(c, self.sx, self.sub_b)


def _load(mem, addr, nbytes):
    """Little-endian words of `nbytes` at byte addresses `addr`."""
    raw = np.ascontiguousarray(mem[np.asarray(addr)[..., None]
                                   + np.arange(nbytes)])
    return raw.view({2: np.uint16, 4: np.uint32}[nbytes])[..., 0].astype(
        np.uint32)


def _store(mem, addr, words):
    """uint32 words to byte addresses `addr`, little-endian."""
    w = np.ascontiguousarray(np.broadcast_to(words, np.shape(addr)),
                             dtype=np.uint32)
    mem[np.asarray(addr)[..., None] + np.arange(4)] = \
        w.view(np.uint8).reshape(w.shape + (4,))


def _split(w):
    """f32 bits -> tf32 (hi, lo) bits, as split_tf32."""
    with np.errstate(invalid="ignore", over="ignore"):  # NaN garbage
        f = w.astype(np.uint32).view(np.float32)
        hi = tf32_rna(f)
        return hi, tf32_rna(f - hi.view(np.float32))


def emulate(x, dy, nbrs, mask, count, ci, co, bs, plan, x_bf16=False,
            g=None, garbage=None, seed=0):
    """One launch of the 3xTF32 instance, walked in numpy: x f32 [nb,
    bs^3, ci] (bf16 values where x_bf16, staged as bf16), dy f32 [nb, bs^3,
    co] (zero off the live slots), nbrs int [nb, 27], mask bool [nb,
    bs^3], `count` live rows, G = g (default the plan's) CTAs per split;
    shared memory the launch has not written holds `garbage` bytes
    (default random).  Returns f32 [27, ci, co]."""
    sx = 2 if x_bf16 else 4
    K = _Kernel(ci, co, bs, plan, sx)
    g = g or plan.g
    hs = K.hs
    xf = np.ascontiguousarray(x, dtype=np.float32)
    xbytes = ((xf.view(np.uint32) >> 16).astype(np.uint16) if x_bf16
              else xf).view(np.uint8).reshape(x.shape + (sx,))
    dbytes = np.ascontiguousarray(dy, dtype=np.float32).view(
        np.uint8).reshape(dy.shape + (4,))
    items, xp = work_items(count, g, bs)
    n_cta = min(g, items)
    part = np.zeros((n_cta, 27, ci, co), np.float32)
    size = K.ring_b + (1 if K.whole else 2) * K.gbuf_b
    if garbage is None:
        garbage = np.random.RandomState(seed).randint(0, 256, size=size)
    garbage = np.array(garbage, np.uint8)[:size]
    cos = co // K.cot
    us = np.arange(K.units)
    for split_i in range(plan.splits):
        ci0, co0 = split_i // cos * K.cit, split_i % cos * K.cot
        for b in range(n_cta):
            mem = garbage.copy()
            acc = np.zeros((K.units, K.nt, 32, 4), np.float32)

            def copy_plane(q, rows):  # copy_plane
                base = (q % K.slots) * K.plane * 32
                nx, sxx = halo_src(np.array(q), bs)
                r = np.arange(hs * hs)
                ny, sy = halo_src(r // hs, bs)
                nz, sz = halo_src(r % hs, bs)
                cell = (sxx * bs + sy) * bs + sz
                vals = xbytes[rows[nx * 9 + ny * 3 + nz], cell,
                              ci0:ci0 + K.cit]  # [hs^2, cit, sx]
                off = base + r[:, None] * 32 + K.chan_at(np.arange(K.cit))
                mem[off[..., None] + np.arange(sx)] = vals

            def stage_dy(row, idx_list, buf):  # stage_dy_f32
                n = np.arange(K.cot)
                j = np.arange(len(idx_list))[:, None]
                off = buf + n // 8 * K.dyrows * 32 + j * 32 + n % 8 * 4
                mem[off[..., None] + np.arange(4)] = \
                    dbytes[row, idx_list][:, co0:co0 + K.cot]
                pad = -len(idx_list) % 8
                n = np.arange(K.cot)
                j = len(idx_list) + np.arange(pad)[:, None]
                _store(mem, buf + n // 8 * K.dyrows * 32 + j * 32
                       + n % 8 * 4, 0)

            def chunks(idx, kb, ke, xo, dyb):  # tf32_chunks
                tap, ch, ok = _unit_rows(us, K.cit, 0)
                tap = np.where(ok, tap, 0)
                tx, tyz = tap // 9, (tap // 3) % 3 * hs + tap % 3
                sl = tx if K.whole else (xo + tx) % K.slots
                uo = (sl * K.plane + tyz) * 32 + K.chan_at(ch)
                for k0 in range(kb, ke, 8):
                    c = chunk(idx, k0, kb, ke, dyb, uo, np.zeros_like(acc))
                    with np.errstate(invalid="ignore", over="ignore"):
                        acc[...] = acc + c

            def chunk(idx, k0, kb, ke, dyb, uo, c):
                """One chunk's products, added to the fragments c."""
                bh = np.zeros((K.nt, 32, 2), np.uint32)
                bl = np.zeros((K.nt, 32, 2), np.uint32)
                ah = np.zeros((K.units, 32, 4), np.uint32)
                al = np.zeros((K.units, 32, 4), np.uint32)
                for h in range(2):
                    v = idx[np.minimum(k0 + _Q + 4 * h, ke - 1)]
                    vrow = ((v // (bs * bs) * K.plane if K.whole else 0)
                            + (v // bs) % bs * hs + v % bs) * 32
                    for nt in range(K.nt):
                        w = _load(mem, dyb + nt * K.dyrows * 32
                                  + (k0 - kb + _Q + 4 * h) * 32 + 4 * _G, 4)
                        bh[nt, :, h], bl[nt, :, h] = _split(w)
                    for r in range(2):  # a pair of one voxel
                        e = 2 * h + r
                        if sx == 2:
                            w = _load(mem, vrow + uo, 4)
                            ah[:, :, e] = w << 16 if r == 0 else \
                                w & 0xffff0000
                        else:
                            ah[:, :, e], al[:, :, e] = _split(
                                _load(mem, vrow + uo + 4 * r, 4))
                if sx == 4:
                    c = mma(mma(c, al, bh), ah, bl)
                else:  # a bf16 value is a tf32 value
                    c = mma(c, ah, bl)
                return mma(c, ah, bh)

            for it in range(b, items, g):
                i, x0 = it // (bs // xp), it % (bs // xp) * xp
                rows = nbrs[i]
                idx = np.flatnonzero(mask[i])
                pstart = np.searchsorted(idx // (bs * bs), np.arange(bs + 1))
                occ = [pstart[p + 1] > pstart[p] for p in range(bs)]
                if not any(occ[x0:x0 + xp]):
                    continue

                def needed(q):
                    return any(occ[max(0, q - 2):min(bs - 1, q) + 1])

                qend = x0 + xp + 2
                if K.whole:
                    for q in range(x0, qend):
                        if needed(q):
                            copy_plane(q, rows)
                    kb, ke = pstart[x0], pstart[x0 + xp]
                    stage_dy(i, idx[kb:ke], K.ring_b)
                    chunks(idx, kb, ke, x0, K.ring_b)
                    continue

                def dybuf(xo):
                    return K.ring_b + (xo % 2) * K.gbuf_b

                for q in range(x0, x0 + 2 + AHEAD):
                    if q < qend and needed(q):
                        copy_plane(q, rows)
                    if q >= x0 + 2 and q - 2 < x0 + xp:
                        xo = q - 2
                        stage_dy(i, idx[pstart[xo]:pstart[xo + 1]],
                                 dybuf(xo))
                for xo in range(x0, x0 + xp):
                    qn = xo + 2 + AHEAD
                    if qn < qend and needed(qn):
                        copy_plane(qn, rows)
                    if xo + AHEAD < x0 + xp:
                        xn = xo + AHEAD
                        stage_dy(i, idx[pstart[xn]:pstart[xn + 1]],
                                 dybuf(xn))
                    if occ[xo]:
                        chunks(idx, pstart[xo], pstart[xo + 1], xo,
                               dybuf(xo))
            # the epilogue: each stored entry from its lane's register
            for e in range(4):
                tap, ch, ok = _unit_rows(us, K.cit, e // 2)
                for nt in range(K.nt):
                    n = nt * 8 + 2 * _Q + e % 2
                    sel = ok & (n < K.cot)
                    part[b, tap[sel], ci0 + ch[sel],
                         co0 + np.broadcast_to(n, sel.shape)[sel]] = \
                        acc[:, nt, :, e][sel]
    # wgrad_reduce_kernel: RED_Y phases, each summing every RED_Y-th
    # partial in order, then the phases in order
    out = np.zeros((27, ci, co), np.float32)
    for y in range(RED_Y):
        s = np.zeros((27, ci, co), np.float32)
        for r in range(y, n_cta, RED_Y):
            s = s + part[r]
        out = out + s
    return out


def _dy32(tbg, co, seed):
    """f32 dy as Conv3Fn hands it to the kernel: zero off the live
    slots."""
    g = np.random.RandomState(seed).randn(tbg.nb_cap, TB.VOL, co)
    live = (tbg.mask & tbg.valid[:, None]).numpy()[:, :, None]
    return np.where(live, g, 0).astype(np.float32)


def _args16(ci, co, x_dtype, seed):
    tbg = _grid(ci, seed=seed)
    if x_dtype == BF16:
        tbg = tbg.replace(feats=tbg.feats.to(BF16))
    dy = _dy32(tbg, co, seed=co + seed)
    nbrs = TB.neighbor_rows(tbg)
    return tbg, dy, nbrs


# (ci, co): ci 8 (2 taps a tile; one ci tile under f32 x), 16 on whole
# tiles under bf16 x, co tiles of 16 and 32, splits over ci and over co
PAIRS_16 = [(16, 16), (8, 16), (16, 32), (32, 32), (64, 16), (8, 64)]


@pytest.mark.parametrize("x_dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("ci,co", PAIRS_16)
def test_emulation_matches_plain(ci, co, x_dtype):
    """At 16^3: the emulated launch (G = 2: whole rows; and the plan's G:
    single planes) equals conv3_wgrad_plain in f32, for x stored as f32
    and as bf16."""
    tbg, dy, nbrs = _args16(ci, co, x_dtype, seed=ci)
    ref = TK.conv3_wgrad_plain(tbg, torch.from_numpy(dy), nbrs, F32)
    plan = TK.wgrad_plan(ci, co, x_dtype, F32, bs=16)
    assert plan.mma
    args = (tbg.feats.float().numpy(), dy, nbrs.reshape(-1, 27).numpy(),
            tbg.mask.numpy(), int(tbg.count), ci, co, 16, plan,
            x_dtype == BF16)
    for g in (2, plan.g):
        _close(emulate(*args, g=g), ref.reshape(27, ci, co).numpy(), TOL,
               f"G={g}")


def test_zero_lanes_past_the_list():
    """Every byte the launch has not written is a NaN: lanes past a
    plane's list (lists of every length mod 8) read its last entry against
    the zero dy rows, and rows past tap 26 (ci 8: the 14th m16 tile is
    half padding) feed only entries that are not stored."""
    ci, co = 8, 16
    tbg, dy, nbrs = _args16(ci, co, F32, seed=3)
    idx = np.flatnonzero(tbg.mask.numpy()[:int(tbg.count)].reshape(-1))
    lens = np.bincount(idx // 256)
    assert len(set(lens[lens > 0] % 8)) >= 6
    ref = TK.conv3_wgrad_plain(tbg, torch.from_numpy(dy), nbrs, F32)
    plan = TK.wgrad_plan(ci, co, F32, F32, bs=16)
    got = emulate(tbg.feats.numpy(), dy, nbrs.reshape(-1, 27).numpy(),
                  tbg.mask.numpy(), int(tbg.count), ci, co, 16, plan,
                  g=4, garbage=np.full(plan.smem, 0xff, np.uint8))
    assert np.isfinite(got).all()
    _close(got, ref.reshape(27, ci, co).numpy(), TOL, "NaN garbage")


@pytest.mark.parametrize("x_dtype", [F32, BF16], ids=["f32", "bf16"])
def test_emulation_matches_jax_vjp(x_dtype):
    """The emulated launch against jax.grad of blocks.conv3 w.r.t. W on
    the same inputs, in f32 (the JAX package at 'highest' matmul
    precision, as conftest pins it)."""
    ci, co = 16, 16
    jbg, tbg = _grid(ci, seed=5, jax_too=True)
    if x_dtype == BF16:
        tbg = tbg.replace(feats=tbg.feats.to(BF16))
    dy = _dy32(tbg, co, seed=6)
    jx = jnp.asarray(tbg.feats.float().numpy())
    jn = B.neighbor_rows(jbg)

    def loss(w):
        out = B.conv3(jbg.with_feats(jx), jn, w, None,
                      compute_dtype=jnp.float32)
        return jnp.sum(out.feats * jnp.asarray(dy))

    ref = jax.grad(loss)(jnp.zeros((3, 3, 3, ci, co), jnp.float32))
    plan = TK.wgrad_plan(ci, co, x_dtype, F32, bs=16)
    got = emulate(tbg.feats.float().numpy(), dy,
                  TB.neighbor_rows(tbg).reshape(-1, 27).numpy(),
                  tbg.mask.numpy(), int(tbg.count), ci, co, 16, plan,
                  x_dtype == BF16, g=8)
    _close(got, np.asarray(ref).reshape(27, ci, co), TOL, "jax")


def _grid8(nb, ci, co, seed, x_dtype):
    """A random 8^3 grid (the process runs 16^3 blocks, so its own grid):
    nb - 1 rows, 20% of slots occupied, neighbour rows drawn at random
    with a third of them misses (the zero sentinel row nb - 1)."""
    rng = np.random.RandomState(seed)
    vol = 512
    mask = rng.rand(nb, vol) < 0.2
    mask[-1] = False
    x = rng.randn(nb, vol, ci).astype(np.float32)
    x[-1] = 0
    if x_dtype == BF16:
        x = torch.from_numpy(x).to(BF16).float().numpy()
    nbrs = rng.randint(0, nb - 1, size=(nb, 27))
    nbrs[rng.rand(nb, 27) < 0.33] = nb - 1
    dy = np.where(mask[:, :, None], rng.randn(nb, vol, co), 0)
    return x, dy.astype(np.float32), nbrs, mask


def _plain8(x, dy, nbrs, mask, count, bs=8):
    """dW in f64: the halo of each row gathered by halo_src."""
    d, cell = halo_src(np.arange(bs + 2), bs)
    out = 0
    for i in range(count):
        nb = nbrs[i][(d[:, None, None] * 9 + d[None, :, None] * 3
                      + d[None, None, :])]
        sl = (cell[:, None, None] * bs + cell[None, :, None]) * bs \
            + cell[None, None, :]
        halo = x[nb, sl].astype(np.float64)  # [hs, hs, hs, ci]
        g = dy[i].reshape(-1, dy.shape[-1]).astype(np.float64)
        out = out + np.stack([
            halo[a:a + bs, b:b + bs, c:c + bs].reshape(-1, x.shape[-1]).T @ g
            for a in range(3) for b in range(3) for c in range(3)])
    return out


@pytest.mark.parametrize("x_dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("ci,co", [(16, 16), (8, 16), (64, 16)])
def test_emulation_bs8_whole_halo(ci, co, x_dtype):
    """At 8^3 (the whole halo staged, K chunks across an item's planes; G
    = 2: whole rows, G = 64: two planes an item) against a direct f64
    sum."""
    x, dy, nbrs, mask = _grid8(9, ci, co, ci * 7 + co, x_dtype)
    plan = TK.wgrad_plan(ci, co, x_dtype, F32, bs=8)
    assert plan.mma
    ref = _plain8(x, dy, nbrs, mask, 8)
    for g in (2, 64):
        got = emulate(x, dy, nbrs, mask, 8, ci, co, 8, plan,
                      x_dtype == BF16, g=g)
        _close(got, ref, TOL, f"G={g}")
