"""conv3_wgrad.cu's bf16 instances on mma.sync, on the CPU: the plan's
warp tiles, and a plain emulation of the kernel's decomposition.

The kernel cannot run here, so `emulate` walks what one launch does, in
numpy, with the kernel's own index functions: the work items of G
persistent CTAs, the row's slot list, the bf16 staging of input planes
(a ring of 4 at 16^3, the whole halo at 8^3) and dy rows into a byte
array at their XOR-swizzled offsets, the 16-voxel K chunks in list order,
each lane's ldmatrix row address (the staged voxel v + tap of its list
entry, or the zero chunk past the end), ldmatrix .trans and the
m16n8k16 fragment layouts, the epilogue's lane -> (ci, co) entries, and
the second kernel's fixed-order sum of the CTAs' partials.  Channels past
a narrow tile hold random values, as unwritten shared memory does: they
feed only products that are not stored.  A ci below 8 runs on the CUDA
cores (`WGRAD_MMA_MIN_CI`); its mma.sync plan (`mma_min_ci=1`, with which
the kernel can still be built) is emulated too.

Tolerance: the emulation's products of bf16 values are exact in f32 and
its sums are f32 sums in another order than conv3_wgrad_plain's matmuls
(a few hundred terms a chunk, a few thousand in all): within 1e-5 of max
|ref|; against jax.grad of the JAX package's blocks.conv3 on the same
bf16-rounded inputs (XLA's conv sums in yet another order) within 1e-4,
test_torch_conv3_grad.py's tolerances.  On the card chip_smoke.py holds
the kernel itself to conv3_wgrad_plain (phases 7a, 9d)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcgcv2_torch.data import synthetic as TS
from pcgcv2_torch.data import voxelize as TV
from pcgcv2_torch.ops import blocks as TB
from pcgcv2_torch.ops import conv3 as TK
from pcgcv2_tpu.data.synthetic import sphere_cloud
from pcgcv2_tpu.data.voxelize import collate
from pcgcv2_tpu.ops import blocks as B

TOL_PLAIN = 1e-5
TOL_JAX = 1e-4
F32, BF16 = torch.float32, torch.bfloat16
GRID_CTAS, RED_Y, AHEAD = 512, 8, 1


# --- the plan ---------------------------------------------------------------


def _bf16_instances():
    return [(bs, ci, co, xd) for bs in TK.BLOCK_SIDES
            for ci, co in TK.WGRAD_PAIRS[bs] for xd in (F32, BF16)]


def _warp_entries(p):
    """(tap, ci, co) entries of one CTA's split that each warp's lanes
    store, as the kernel's epilogue maps them: warp w owns the units u =
    w, w + 8, ... (tap u / MT, m16 tile u % MT) with every n8 tile; lane
    4g + q holds rows g, g + 8 and columns 2q, 2q + 1."""
    mt_n = -(-max(p.ci_tile, 8) // 16)
    nt_n = max(p.co_tile, 8) // 8
    units = TK.wgrad_mma_units(p.ci_tile)
    out = []
    for w in range(TK.WGRAD_WARPS):
        for u in range(w, units, TK.WGRAD_WARPS):
            tap, mt = divmod(u, mt_n)
            for nt in range(nt_n):
                for lane in range(32):
                    g, q = divmod(lane, 4)
                    for h in range(2):
                        for e in range(2):
                            m, n = mt * 16 + g + 8 * h, nt * 8 + 2 * q + e
                            if m < p.ci_tile and n < p.co_tile:
                                out.append((w, tap, m, n))
    return out


@pytest.mark.parametrize("bs,ci,co,x_dtype", _bf16_instances(),
                         ids=lambda v: str(v).replace("torch.", ""))
def test_mma_plan_covers_dw_once_and_fits(bs, ci, co, x_dtype):
    """Every bf16 instance at ci >= 8 runs on mma.sync (a narrow ci on the
    CUDA cores, measured), and its plan the way the emulation below does
    (with ci padded to 8 for the narrow ones, as the kernel can be built)."""
    p = TK.wgrad_plan(ci, co, x_dtype, BF16, bs=bs)
    assert p.mma == (ci >= 8) and TK.WGRAD_MMA_MIN_CI == 8
    p = TK.wgrad_plan(ci, co, x_dtype, BF16, bs=bs, mma_min_ci=1)
    assert p.mma
    assert ci % p.ci_tile == 0 and co % p.co_tile == 0
    assert p.splits == (ci // p.ci_tile) * (co // p.co_tile)
    seen = np.zeros((27, ci, co), dtype=np.int64)
    ent = _warp_entries(p)
    for split in range(p.splits):
        ci0 = split // (co // p.co_tile) * p.ci_tile
        co0 = split % (co // p.co_tile) * p.co_tile
        for _, tap, m, n in ent:
            seen[tap, ci0 + m, co0 + n] += 1
    assert (seen == 1).all()
    # the accumulators a thread holds: its warp's units x n8 tiles x 4
    per_warp = np.bincount([w for w, *_ in ent], minlength=8)
    assert TK.wgrad_mma_acc(p.ci_tile, p.co_tile) <= TK.WGRAD_ACC_MAX
    assert per_warp.max() <= 32 * TK.wgrad_mma_acc(p.ci_tile, p.co_tile)
    # shared memory: bf16 planes and dy rows, two CTAs to an SM with the
    # slot list (2 bytes a slot) and the scan's words beside them
    assert p.smem == TK.wgrad_mma_smem(bs, p.ci_tile, p.co_tile)
    assert p.smem <= TK.WGRAD_SMEM_MMA
    assert 2 * (p.smem + 2 * bs ** 3 + 1024) <= 232448
    assert p.g * p.splits <= 512 and p.g >= 8


def test_mma_plan_fields():
    """f32 dy runs on mma.sync too, from ci = `mma_min_ci` (default 8) and
    co = `tf32_min_co` (default 16; 3xTF32, its own plan:
    test_torch_conv3_wgrad_tf32.py), and on the CUDA cores below them;
    bf16 dy runs on mma.sync from ci = `mma_min_ci`, a co below 8
    included."""
    for ci, co in ((16, 16), (64, 64), (16, 4)):
        f32 = TK.wgrad_plan(ci, co, F32, F32)
        assert f32.mma == (co >= TK.WGRAD_TF32_MIN_CO)
        if f32.mma:
            assert f32.tm * f32.tn == 0
            assert f32.smem == TK.wgrad_tf32_smem(16, f32.ci_tile,
                                                  f32.co_tile, 4)
        else:
            assert f32.tm * f32.tn > 0
        simt = TK.wgrad_plan(ci, co, F32, F32, mma_min_ci=128)
        assert not simt.mma and simt.tm * simt.tn > 0
    for ci, co in ((16, 4), (16, 1), (64, 1), (8, 8)):
        assert TK.wgrad_plan(ci, co, F32, BF16).mma
    for ci, co in ((1, 16), (4, 4), (4, 8)):
        simt = TK.wgrad_plan(ci, co, F32, BF16)
        assert not simt.mma and simt.ksplit > 0
        assert TK.wgrad_plan(ci, co, F32, BF16, mma_min_ci=1).mma
    assert TK.wgrad_plan(64, 64, F32, BF16) == TK.WgradPlan(
        16, 32, 0, 0, 0, 0, 8, 64, 74240, True)


# --- the emulation ----------------------------------------------------------


def _bf16_bits(a):
    """f32 array -> its bf16 bits (round to nearest even), uint16."""
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def _f32(bits):
    return (bits.astype(np.uint32) << 16).view(np.float32)


def swz(p, c, nch):
    """Byte offset of 16-byte chunk c of staged row p (rows of nch
    chunks), as the kernel's swz<NCH>."""
    per = 8 // nch
    return p * nch * 16 + ((c ^ ((p // per) & (nch - 1))) << 4)


def halo_src(h, bs):
    """Halo coordinate -> (neighbour offset 0..2, cell), as halo_src."""
    nbr = np.where(h == 0, 0, np.where(h == bs + 1, 2, 1))
    cell = np.where(h == 0, bs - 1, np.where(h == bs + 1, 0, h - 1))
    return nbr, cell


def work_items(n_rows, g, bs):
    xp = bs
    while xp > 1 and n_rows * (bs // xp) < g:
        xp //= 2
    return n_rows * (bs // xp), xp


def ldsm_trans(mem, addrs, n):
    """ldmatrix .xN .trans of a batch of warps: lanes 8m .. 8m + 7 of
    addrs [..., 32] address the 16-byte rows of matrix m; thread T gets,
    in register m, (row 2(T%4), col T/4) and (row 2(T%4)+1, col T/4).
    mem: uint16 words; -> [..., 32, n, 2] bits."""
    lane = np.arange(32)
    out = np.empty(addrs.shape + (n, 2), dtype=np.uint16)
    for m in range(n):
        rows = mem[(addrs[..., 8 * m:8 * m + 8] // 2)[..., None]
                   + np.arange(8)]
        out[..., m, 0] = rows[..., 2 * (lane % 4), lane // 4]
        out[..., m, 1] = rows[..., 2 * (lane % 4) + 1, lane // 4]
    return out


_LANE = np.arange(32)
_G, _Q = _LANE // 4, _LANE % 4


def mma(acc, a, b):
    """mma.sync m16n8k16 row.col, f32 += bf16 x bf16, for every unit u and
    n8 tile t: a [U, 32, 4, 2] (a0 rows g, k 2q..; a1 rows g+8; a2 k + 8;
    a3 both), b [T, 32, 2, 2] (b0 k 2q.., col g; b1 k + 8), acc [U, T,
    32, 4] (c0, c1 row g cols 2q, 2q+1; c2, c3 row g + 8)."""
    A = np.zeros((a.shape[0], 16, 16), np.float32)
    Bm = np.zeros((b.shape[0], 16, 8), np.float32)
    for r, (dm, dk) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
        for e in range(2):
            A[:, _G + dm, 2 * _Q + e + dk] = _f32(a[:, :, r, e])
    for r in range(2):
        for e in range(2):
            Bm[:, 2 * _Q + e + 8 * r, _G] = _f32(b[:, :, r, e])
    D = np.einsum("umk,tkn->utmn", A, Bm)
    for h in range(2):
        for e in range(2):
            acc[..., 2 * h + e] += D[:, :, _G + 8 * h, 2 * _Q + e]


class _Kernel:
    """The constants of one instance, as MCfg."""

    def __init__(self, ci, co, bs, plan):
        self.ci, self.co, self.bs, self.p = ci, co, bs, plan
        self.hs = bs + 2
        self.cit, self.cot = plan.ci_tile, plan.co_tile
        self.cip, self.cop = max(self.cit, 8), max(self.cot, 8)
        self.nc, self.nco = self.cip // 8, self.cop // 8
        self.mt = -(-self.cip // 16)
        self.nt = self.nco
        self.units = 27 * self.mt
        self.x4 = self.cip >= 16
        self.whole = bs == 8
        self.slots = self.hs if self.whole else 3 + AHEAD
        self.slot_b = self.hs * self.hs * self.cip * 2
        self.gbuf_b = (bs ** 3 if self.whole else bs * bs) * self.cop * 2
        ring = self.slots * self.slot_b
        assert plan.smem == ring + (1 if self.whole else 2) * self.gbuf_b
        self.ring_b = ring


def emulate(x, dy, nbrs, mask, count, ci, co, bs, plan, g=None, seed=0):
    """One launch of the bf16 mma.sync instance, walked in numpy: x f32
    [nb, bs^3, ci], dy f32 [nb, bs^3, co] (bf16 values, zero off the live
    slots), nbrs int [nb, 27], mask bool [nb, bs^3], `count` live rows, G
    = g (default the plan's) CTAs per split.  Returns f32 [27, ci, co]."""
    K = _Kernel(ci, co, bs, plan)
    g = g or plan.g
    vol, hs = bs ** 3, K.hs
    xb = _bf16_bits(x)
    dyb = _bf16_bits(dy)
    rng = np.random.RandomState(seed)
    items, xp = work_items(count, g, bs)
    n_cta = min(g, items)
    part = np.zeros((n_cta, 27, ci, co), np.float32)
    lane = np.arange(32)
    ka = (lane & 7) | ((lane >> 4) << 3) if K.x4 else lane & 15
    ca = (lane >> 3) & 1 if K.x4 else np.zeros(32, np.int64)
    kbb, nbl = lane & 15, lane >> 4
    tap_u, mtu = np.divmod(np.arange(K.units), K.mt)
    tx, ty, tz = tap_u // 9, (tap_u // 3) % 3, tap_u % 3
    cos = co // K.cot
    # the epilogue's map: (unit, n8 tile, lane, register) -> (tap, m, n)
    e_u, e_nt, e_lane, e_reg = np.meshgrid(
        np.arange(K.units), np.arange(K.nt), lane, np.arange(4),
        indexing="ij")
    e_tap = e_u // K.mt
    e_m = e_u % K.mt * 16 + e_lane // 4 + 8 * (e_reg // 2)
    e_n = e_nt * 8 + 2 * (e_lane % 4) + e_reg % 2
    ok = (e_m < K.cit) & (e_n < K.cot)
    e_u, e_nt, e_lane, e_reg, e_tap, e_m, e_n = (
        a[ok] for a in (e_u, e_nt, e_lane, e_reg, e_tap, e_m, e_n))
    # unwritten shared memory: random finite bf16 values; the zero chunk
    # at the end
    zero = K.ring_b + 2 * K.gbuf_b
    garbage = _bf16_bits(rng.randn(zero // 2 + 8))
    garbage[zero // 2:] = 0
    for split in range(plan.splits):
        ci0, co0 = split // cos * K.cit, split % cos * K.cot
        for b in range(n_cta):
            mem = garbage.copy()
            acc = np.zeros((K.units, K.nt, 32, 4), np.float32)

            def stage(q, rows):
                base = (q % K.slots) * K.slot_b
                nx, sx = halo_src(np.array(q), bs)
                r = np.arange(hs * hs)
                ny, sy = halo_src(r // hs, bs)
                nz, sz = halo_src(r % hs, bs)
                src_row = rows[nx * 9 + ny * 3 + nz]
                cell = (sx * bs + sy) * bs + sz
                vals = xb[src_row, cell, ci0:ci0 + K.cit]  # [hs^2, cit]
                ch = np.arange(K.cit)
                off = base + swz(r[:, None], ch // 8, K.nc)
                mem[off // 2 + ch % 8] = vals

            def stage_dy(row, idx_list, buf):
                ch = np.arange(K.cot)
                j = np.arange(len(idx_list))[:, None]
                off = buf + swz(j, ch // 8, K.nco)
                mem[off // 2 + ch % 8] = dyb[row, idx_list][:, co0:co0 + K.cot]

            def chunks(idx, kb, ke, dybase):
                for k0 in range(kb, ke, 16):
                    j = k0 - kb + kbb
                    inb = k0 + kbb < ke
                    if K.nt == 1:
                        ad = np.where(inb, dybase + swz(j, 0, K.nco), zero)
                        bfr = ldsm_trans(mem, ad, 2)[None]
                    else:
                        ad = np.where(inb, dybase + swz(
                            j, np.arange(0, K.nt, 2)[:, None] + nbl, K.nco),
                            zero)
                        r = ldsm_trans(mem, ad, 4)  # [NT / 2, 32, 4, 2]
                        bfr = np.stack([r[:, :, :2], r[:, :, 2:]], 1)
                        bfr = bfr.reshape(K.nt, 32, 2, 2)
                    ina = k0 + ka < ke
                    v = np.where(ina, idx[np.minimum(k0 + ka, len(idx) - 1)],
                                 0)
                    vx, vy, vz = v // (bs * bs), (v // bs) % bs, v % bs
                    p = (vy + ty[:, None]) * hs + vz + tz[:, None]
                    ad = np.where(ina, ((vx + tx[:, None]) % K.slots)
                                  * K.slot_b + swz(p, 2 * mtu[:, None] + ca,
                                                   K.nc), zero)
                    if K.x4:
                        a = ldsm_trans(mem, ad, 4)
                    else:  # ci <= 8: the upper m8 rows are zero
                        r = ldsm_trans(mem, ad, 2)
                        a = np.zeros(r.shape[:2] + (4, 2), np.uint16)
                        a[:, :, 0], a[:, :, 2] = r[:, :, 0], r[:, :, 1]
                    mma(acc, a, bfr)

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
                            stage(q, rows)
                    kb, ke = pstart[x0], pstart[x0 + xp]
                    stage_dy(i, idx[kb:ke], K.ring_b)
                    chunks(idx, kb, ke, K.ring_b)
                    continue

                def dybuf(xo):
                    return K.ring_b + (xo % 2) * K.gbuf_b

                for q in range(x0, x0 + 2 + AHEAD):
                    if q < qend and needed(q):
                        stage(q, rows)
                    if q >= x0 + 2 and q - 2 < x0 + xp:
                        xo = q - 2
                        stage_dy(i, idx[pstart[xo]:pstart[xo + 1]],
                                 dybuf(xo))
                for xo in range(x0, x0 + xp):
                    qn = xo + 2 + AHEAD
                    if qn < qend and needed(qn):
                        stage(qn, rows)
                    if xo + AHEAD < x0 + xp:
                        xn = xo + AHEAD
                        stage_dy(i, idx[pstart[xn]:pstart[xn + 1]],
                                 dybuf(xn))
                    if occ[xo]:
                        chunks(idx, pstart[xo], pstart[xo + 1], dybuf(xo))
            # the epilogue: each stored entry from its lane's register
            part[b, e_tap, ci0 + e_m, co0 + e_n] = acc[e_u, e_nt, e_lane,
                                                      e_reg]
    # wgrad_reduce_kernel: RED_Y phases, each summing every RED_Y-th
    # partial in order, then the phases in order
    out = np.zeros((27, ci, co), np.float32)
    for y in range(RED_Y):
        s = np.zeros((27, ci, co), np.float32)
        for r in range(y, n_cta, RED_Y):
            s = s + part[r]
        out = out + s
    return out


def _grid(ci, seed=0, jax_too=False):
    """test_torch_conv3_grad.py's grid, in the port and (`jax_too`) in the
    JAX package: a res-64 sphere, nb_cap 64, N(0,1) features."""
    pkg = (TS.sphere_cloud, TV.collate) if not jax_too else (sphere_cloud,
                                                             collate)
    cloud = pkg[0](20, density=1.5, seed=7)
    coords, valid = pkg[1]([cloud], capacity=4096)
    feats = np.random.RandomState(seed).randn(4096, ci).astype(np.float32)
    tbg = TB.blockify(torch.from_numpy(coords), torch.from_numpy(feats),
                      torch.from_numpy(valid), nb_cap=64, stride=1, res=64,
                      num_batches=1)
    if not jax_too:
        return tbg
    jbg = B.blockify(jnp.asarray(coords), jnp.asarray(feats),
                     jnp.asarray(valid), nb_cap=64, stride=1, res=64,
                     num_batches=1)
    return jbg, tbg


def _dy(tbg, co, seed):
    """dy as Conv3Fn hands it to the kernel: bf16 values, zero off the
    live slots."""
    g = np.random.RandomState(seed).randn(tbg.nb_cap, TB.VOL, co)
    g = torch.from_numpy(g.astype(np.float32))
    live = (tbg.mask & tbg.valid[:, None])[:, :, None]
    return torch.where(live, g, 0).to(BF16).float()


def _close(got, ref, tol, what):
    ref = np.asarray(ref, dtype=np.float64)
    err = float(np.abs(np.asarray(got, dtype=np.float64) - ref).max())
    assert err <= tol * float(np.abs(ref).max()), (what, err)


# (ci, co): the narrow ones padded, ci = 8 on half an m16 tile, splits
# over ci (32 -> 32) and over ci and co (64 -> 64)
PAIRS_16 = [(16, 16), (8, 16), (16, 4), (1, 16), (32, 32), (64, 64)]


@pytest.mark.parametrize("ci,co", PAIRS_16)
def test_emulation_matches_plain(ci, co):
    """At 16^3: the emulated launch (G = 2: whole rows; and the plan's G:
    single planes) equals conv3_wgrad_plain in bf16."""
    tbg = _grid(ci, seed=ci)
    dy = _dy(tbg, co, seed=co)
    nbrs = TB.neighbor_rows(tbg)
    ref = TK.conv3_wgrad_plain(tbg, dy, nbrs, BF16).reshape(27, ci, co)
    plan = TK.wgrad_plan(ci, co, F32, BF16, bs=16, mma_min_ci=1)
    args = (tbg.feats.numpy(), dy.numpy(), nbrs.reshape(-1, 27).numpy(),
            tbg.mask.numpy(), int(tbg.count), ci, co, 16, plan)
    for g in (2, plan.g):
        _close(emulate(*args, g=g), ref.numpy(), TOL_PLAIN, f"G={g}")


@pytest.mark.parametrize("ci,co", [(8, 16)])
def test_emulation_matches_jax_vjp(ci, co):
    """The emulated launch against jax.grad of blocks.conv3 w.r.t. W on
    the same bf16-rounded inputs, in f32."""
    jbg, tbg = _grid(ci, seed=ci + 1, jax_too=True)
    dy = _dy(tbg, co, seed=co + 1)
    x = tbg.feats.to(BF16).float()
    jx = jnp.asarray(x.numpy())
    jn = B.neighbor_rows(jbg)

    def loss(w):
        out = B.conv3(jbg.with_feats(jx), jn, w, None,
                      compute_dtype=jnp.float32)
        return jnp.sum(out.feats * jnp.asarray(dy.numpy()))

    ref = jax.grad(loss)(jnp.zeros((3, 3, 3, ci, co), jnp.float32))
    plan = TK.wgrad_plan(ci, co, F32, BF16, bs=16)
    got = emulate(tbg.feats.numpy(), dy.numpy(),
                  TB.neighbor_rows(tbg).reshape(-1, 27).numpy(),
                  tbg.mask.numpy(), int(tbg.count), ci, co, 16, plan, g=4)
    _close(got, np.asarray(ref).reshape(27, ci, co), TOL_JAX, "jax")


def _grid8(nb, ci, co, seed):
    """A random 8^3 grid (the process runs 16^3 blocks, so its own grid):
    nb - 1 rows, 20% of slots occupied, neighbour rows drawn at random
    with a third of them misses (the zero sentinel row nb - 1), and the
    gather of a row's (bs+2)^3 halo by halo_src as the plain reference."""
    rng = np.random.RandomState(seed)
    vol = 512
    mask = rng.rand(nb, vol) < 0.2
    mask[-1] = False
    x = rng.randn(nb, vol, ci).astype(np.float32)
    x[-1] = 0
    nbrs = rng.randint(0, nb - 1, size=(nb, 27))
    nbrs[rng.rand(nb, 27) < 0.33] = nb - 1
    dy = np.where(mask[:, :, None], rng.randn(nb, vol, co), 0)
    dy = torch.from_numpy(dy.astype(np.float32)).to(BF16).float().numpy()
    return x, dy, nbrs, mask


def _plain8(x, dy, nbrs, mask, count, bs=8):
    """dW in f64 over bf16-rounded x: the halo gathered by halo_src."""
    xr = torch.from_numpy(x).to(BF16).double().numpy()
    h = np.arange(bs + 2)
    d, cell = halo_src(h, bs)
    out = 0
    for i in range(count):
        nb = nbrs[i][(d[:, None, None] * 9 + d[None, :, None] * 3
                      + d[None, None, :])]
        sl = (cell[:, None, None] * bs + cell[None, :, None]) * bs \
            + cell[None, None, :]
        halo = xr[nb, sl]  # [hs, hs, hs, ci]
        g = dy[i].reshape(bs, bs, bs, -1).astype(np.float64)
        taps = [halo[a:a + bs, b:b + bs, c:c + bs].reshape(-1, x.shape[-1])
                for a in range(3) for b in range(3) for c in range(3)]
        out = out + np.stack([t.T @ g.reshape(-1, g.shape[-1])
                              for t in taps])
    return out


@pytest.mark.parametrize("ci,co", [(16, 16), (4, 8), (64, 16)])
def test_emulation_bs8_whole_halo(ci, co):
    """At 8^3 (the whole halo staged, one step per item; G = 2: whole
    rows, G = 64: two planes an item) against a direct sum."""
    x, dy, nbrs, mask = _grid8(9, ci, co, seed=ci * 7 + co)
    plan = TK.wgrad_plan(ci, co, F32, BF16, bs=8, mma_min_ci=1)
    ref = _plain8(x, dy, nbrs, mask, 8)
    for g in (2, 64):
        got = emulate(x, dy, nbrs, mask, 8, ci, co, 8, plan, g=g)
        _close(got, ref, TOL_PLAIN, f"G={g}")
