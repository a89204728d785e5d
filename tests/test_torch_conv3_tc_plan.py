"""conv3_tc.cu's plans and its weight layout, on the CPU: every instance
fits its shared memory, the weight ring hands each step of every pass the
weights it needs, every instance reads at most a quarter of the weight
bytes from L2 that per-warp fragment reads took, and the pack read the
way the kernel's wgmma descriptors (and, in bf16, its ldmatrix B loads)
address it gives the weight back, in f32 and bf16.  The kernel itself
runs only on the card (chip_smoke.py)."""

import pytest
import torch

from pcgcv2_torch.ops import conv3 as TK

SMEM_MAX = 232448 - 256
CASES = [pytest.param(bs, ci, co, dtype,
                      id=f"bs{bs}-{ci}-{co}-{str(dtype)[6:]}")
         for bs in (16, 8) for ci, co in TK.TC_PAIRS[bs]
         for dtype in (torch.float32, torch.bfloat16)]


def _ring_schedule(p, nstep):
    """Step by step, the weight step each f32 CTA step reads: its slot's
    content as the kernel's producer fills it (slot c % wslots takes step
    c % nstep of the pass when step c - wslots has been freed), or the
    whole kernel."""
    tot = p.xp // p.ps * nstep
    if p.wslots == 1:
        return [gs % nstep for gs in range(tot)]
    slots = {s: s for s in range(p.wslots)}  # the first wslots steps
    seen = []
    for gs in range(tot):
        seen.append(slots[gs % p.wslots] % nstep)
        if gs + p.wslots < tot:  # freed: refilled wslots steps on
            slots[gs % p.wslots] = gs + p.wslots
    return seen


@pytest.mark.parametrize("bs,ci,co,dtype", CASES)
def test_tc_plan_fits_and_covers(bs, ci, co, dtype):
    """One rule for both dtypes: whole warpgroups and a producer warp, the
    weights in shared memory beside the planes (whole, or a ring of
    one-step slots), the products on wgmma where N reaches the dtype's
    threshold and a chunk is 32 bytes deep."""
    p = TK.tc_plan(ci, co, dtype, bs=bs)
    f32 = dtype == torch.float32
    sz, parts = (4, 2) if f32 else (2, 1)
    cip, cop = max(ci, 8), max(co, 8)
    ks = 8 if f32 or cip < 16 else 16
    assert p.smem <= SMEM_MAX
    # the product's N is the padded co: a multiple of 8 up to wgmma's 256
    assert cop % 8 == 0 and cop <= 256
    live = 1000
    # the per-warp design read the packed kernel once per warp and output
    # plane: bs^3 / 32 times per live row
    per_warp = live * bs ** 3 // 32 * TK.packed_bytes(ci, co, dtype)
    assert p.threads % 128 == 0
    kg = p.kg
    kb = 3 * parts * ks * cop * sz  # a k chunk: 3 dy x parts KS x co
    nstep, sb = 9 * (cip // ks) // kg, kg * kb
    assert (cip // ks) % kg == 0 and (sb <= 12288 or kg == 1)
    wgmma = ks * sz == 32 and cop >= TK.TC_WGMMA_MIN_N[dtype]
    assert p.mma == ("wgmma" if wgmma else "mma.sync")
    assert TK.packed_bytes(ci, co, dtype) == nstep * sb == (
        27 * cip * cop * sz * parts)
    nbuf = 2 * p.ps + 2
    rs = cip + (16 // sz if (cip * sz // 16) % 2 == 0 else 0)
    ring = nbuf * (p.rows + 2) * (bs + 2) * rs * sz
    if p.wslots == 1:
        assert p.smem == ring + nstep * sb + 8
    else:
        assert 2 <= p.wslots <= min(8, nstep)
        assert p.smem == ring + p.wslots * (sb + 16)
    # every step of every pass reads the weights of its own (dx, dz, kc):
    # the 27 taps x ci once per pass, a pass per step of output planes
    # (streamed) or per CTA (whole)
    seen = _ring_schedule(p, nstep)
    passes = p.xp // p.ps
    assert seen == list(range(nstep)) * passes
    ng = nstep // 9  # k groups per (dx, dz)
    taps = sorted((k // (3 * ng), dy, k // ng % 3, k % ng * kg + kk)
                  for k in seen[:nstep] for dy in range(3)
                  for kk in range(kg))
    assert taps == sorted((dx, dy, dz, kc) for dx in range(3)
                          for dy in range(3) for dz in range(3)
                          for kc in range(cip // ks))
    reads = p.grid[0] * p.grid[1] * (1 if p.wslots == 1 else passes)
    assert p.weight_reads == reads
    # L2 weight bytes at most a quarter of per-warp fragment reads
    assert 4 * p.weight_reads <= bs ** 3 // 32
    assert 4 * p.l2_weight_bytes(live, ci, co, dtype) <= per_warp


@pytest.mark.parametrize("ci,co", [(1, 16), (4, 4), (16, 4), (32, 8),
                                   (64, 64), (16, 1)])
def test_f32_pack_read_by_wgmma_descriptors(ci, co):
    """Walk the packed f32 kernel as conv3_tc.cu's wgmma descriptors
    address it, in plain Python: step k = (dx, dz, kc) at k * SB bytes,
    the (dy, part) slice at (2 dy + part) * 32 co bytes, element (k8, n)
    of its K8 x co tile at n / 8 * 256 (stride byte offset) + k8 / 4 *
    128 (leading byte offset) + n % 8 * 16 + k8 % 4 * 4; then W = hi + lo
    comes back, each part TF32's split of W."""
    g = torch.Generator().manual_seed(ci * 100 + co)
    w = torch.randn(3, 3, 3, ci, co, generator=g)
    flat = TK.pack_weight(w).reshape(-1).tolist()
    cip, cop = max(ci, 8), max(co, 8)
    kc_n, sb = cip // 8, 3 * 2 * 8 * cop * 4
    parts = [[[[[[0.0] * cop for _ in range(cip)] for _ in range(3)]
               for _ in range(3)] for _ in range(3)] for _ in range(2)]
    for k in range(9 * kc_n):
        dx, dz, kc = k // (3 * kc_n), k // kc_n % 3, k % kc_n
        for dy in range(3):
            for s in range(2):
                start = k * sb + (2 * dy + s) * 32 * cop  # descriptor start
                for k8 in range(8):
                    for n in range(cop):
                        off = (start + n // 8 * 256 + k8 // 4 * 128
                               + n % 8 * 16 + k8 % 4 * 4)
                        assert off % 4 == 0
                        parts[s][dx][dy][dz][8 * kc + k8][n] = flat[off // 4]
    hi, lo = (torch.tensor(p)[..., :ci, :co] for p in parts)
    th, tl = TK.tf32_split(w)
    torch.testing.assert_close(hi, th, rtol=0, atol=0)
    torch.testing.assert_close(lo, tl, rtol=0, atol=0)
    torch.testing.assert_close(hi + lo, w, rtol=2.0 ** -21, atol=0)
    # the padding (ci, co below 8) is zero
    full = torch.tensor(parts)
    assert float(full[..., ci:, :].abs().sum()) == 0.0
    assert float(full[..., co:].abs().sum()) == 0.0


@pytest.mark.parametrize("ci,co", [(1, 16), (4, 4), (16, 4), (32, 8),
                                   (64, 64), (16, 1)])
def test_bf16_pack_read_by_wgmma_descriptors(ci, co):
    """Walk the packed bf16 kernel as conv3_tc.cu addresses it, in plain
    Python: step k = (dx, dz, kc) at k * SB bytes (KS the chunk depth, 16,
    or 8 at ci <= 8), the dy slice at dy * 2 KS co bytes.  wgmma's
    descriptor reads element (k, n) of its K16 x co tile at n / 8 * 256
    (stride byte offset) + k / 8 * 128 (leading byte offset) + n % 8 * 16
    + k % 8 * 2; mma.sync's ldmatrix B loads (lane l at l * 16 bytes of
    the slice, four core matrices a load) give lane 4g + q of n tile nt
    the pair k = 8h + 2q, 2q + 1 of n = 8nt + g in register nt KS/8 + h.
    Both give W back, the padding zero."""
    g_ = torch.Generator().manual_seed(ci * 100 + co)
    w = torch.randn(3, 3, 3, ci, co, generator=g_).to(torch.bfloat16)
    flat = TK.pack_weight(w).view(torch.int16).reshape(-1).tolist()
    cip, cop = max(ci, 8), max(co, 8)
    ks = 16 if cip >= 16 else 8
    kc_n, slb = cip // ks, 2 * ks * cop
    bits = w.view(torch.int16)
    desc = [[[[[None] * cop for _ in range(cip)] for _ in range(3)]
             for _ in range(3)] for _ in range(3)]
    for k in range(9 * kc_n):
        dx, dz, kc = k // (3 * kc_n), k // kc_n % 3, k % kc_n
        for dy in range(3):
            start = k * 3 * slb + dy * slb  # the slice
            for kk in range(ks):
                for n in range(cop):
                    off = (start + n // 8 * (ks * 16) + kk // 8 * 128
                           + n % 8 * 16 + kk % 8 * 2)
                    desc[dx][dy][dz][ks * kc + kk][n] = flat[off // 2]
            # ldmatrix: matrix m of the slice, row r, at m * 128 + r * 16;
            # lane T reads row T / 4, elements 2 (T % 4), +1
            kh = ks // 8
            for nt in range(cop // 8):
                for h in range(kh):
                    m = nt * kh + h
                    for lane in range(32):
                        gg, q = lane // 4, lane % 4
                        for e in range(2):
                            off = start + m * 128 + gg * 16 + (2 * q + e) * 2
                            kk, n = ks * kc + 8 * h + 2 * q + e, 8 * nt + gg
                            assert flat[off // 2] == desc[dx][dy][dz][kk][n]
    full = torch.tensor(desc, dtype=torch.int16)
    torch.testing.assert_close(full[..., :ci, :co], bits, rtol=0, atol=0)
    # the padding (ci, co below 8) is zero
    assert int(full[..., ci:, :].abs().sum()) == 0
    assert int(full[..., co:].abs().sum()) == 0
