// 3^3 stride-1 sparse convolution over dense BS^3 voxel blocks (BS = 16
// or 8, a template parameter) on the tensor cores (sm_90a), in bf16 and in
// f32 through split TF32, both on one design: the weights staged in shared
// memory by TMA, the products on wgmma or mma.sync.
//
// Replaces the TPU kernel pcgcv2_tpu/ops/pallas_conv.py::conv3_pallas
// (:119, body _kernel at :63), which is written for any block side, for
// every call with ci, co in {1, 4, 8, 16, 32, 64}, in both compute
// dtypes.  It computes what ops/conv3.py::conv3_plain computes:
//
//   bf16: out[i, v, :] = mask[i, v] ? bf16(bf16(sum_27 taps halo_i[v+tap]
//                                      @ W[tap]) + bias) : 0,
//   f32:  out[i, v, :] = mask[i, v] ? sum_27 taps halo_i[v+tap] @ W[tap]
//                                     + bias : 0,     rows i >= count: 0.
//
// What bounds it on this card: the dense block form does 2*27*ci*co FLOP
// per slot against (ci+co)*2 (bf16) or *4 (f32) bytes, 6-860 FLOP per byte
// at the checkpoint's pairs, so the wide convs are bound by arithmetic,
// which the CUDA cores (conv3.cu) run at 1/15 of the bf16 tensor-core rate.
// Design:
//   * implicit GEMM: M = output voxels, N = co, K = 27 taps x ci.  One m16
//     tile is 16 consecutive (y, z) voxels of an output x-plane: one y row
//     of 16 z at BS = 16, two y rows of 8 z at BS = 8 (TY = 16 / BS rows).
//     The im2col gather is only an address: each lane's ldmatrix row points
//     at the shifted halo voxel (y+dy, z+dz) of a staged input plane, lanes
//     0-7 and 8-15 at the two staged y rows of the tile where BS = 8;
//   * ci < 8 is zero-padded to 8 channels in shared memory, co < 8 to one
//     n8 tile (only the real columns are stored);
//   * each consumer warp owns two m16 tiles, 32 output voxels of a plane (2
//     y rows at BS = 16, 4 at BS = 8), and every output channel.  A CTA =
//     one live block row x XP output x-planes x ROWS output y rows: BS =
//     16, XP = 4 of the 16 planes, ROWS = 16, or 8 where a ring of full
//     planes does not fit in shared memory (f32 at ci = 64: the y-halves
//     restage 2 of their 10 halo rows each); BS = 8, the whole block;
//   * the input planes are gathered as (ROWS+2) x (BS+2) x ci tiles from
//     the neighbour rows of each plane with cp.async (16 bytes, or 8 or 4
//     for a narrower voxel; a 2-byte bf16 voxel is copied by plain loads;
//     misses read the zero sentinel row, no branch) into a ring of plane
//     buffers, the next step's planes in flight while a step's are read;
//   * staged voxel rows are padded by 16 bytes where the row is an even
//     number of 16-byte groups: the 8 rows of one ldmatrix phase then fall
//     on distinct bank groups;
//   * the CTA is whole warpgroups of consumers plus one producer warp.  A
//     step is one (dx, dz) and KG k chunks (k16 in bf16, k8 in f32 and for
//     bf16 at ci <= 8); the packed kernel is laid out step by step as the
//     shared-memory image the products read (ops/conv3.py::pack_weight),
//     and the producer copies it by 1-D bulk copies (TMA, cp.async.bulk
//     with an mbarrier's transaction count): whole, once per CTA, where it
//     fits beside the plane ring without costing CTAs per SM, else step by
//     step through a ring of NS slots with full and empty mbarriers, which
//     the consumers release as they finish a step.  The weights cross L2
//     once per CTA or once per step of output planes, not once per warp
//     and plane (the earlier design, whose per-warp fragment reads took
//     14-32% of the f32 time: tests/torch_conv3_f32_diagnosis.py, and the
//     bf16 share tests/torch_conv3_bf16_diagnosis.py measures);
//   * BS = 16: one output plane per step (1 or 2 warpgroups); BS = 8: two
//     planes per step (warps 0-1 and 2-3 of one warpgroup, a ring of 6
//     planes), so that a pass over the weights serves 128 output voxels at
//     either side;
//   * the products: where N = co padded reaches the dtype's WG_MIN_N (and
//     bf16 runs k16), wgmma m64nNk16 bf16 or m64nNk8 tf32 with A from
//     registers (each warp's m16 fragment in mma.sync's order, which is
//     wgmma's per-warp order) and B by descriptor from the staged slice
//     (K-major 8 x 16-byte core matrices, no swizzle, the same bytes per
//     slice in both dtypes), a chunk's wgmmas one group, the next chunk's
//     fragments loaded while it runs; below, mma.sync m16n8k16 / m16n8k8
//     (bf16) or m16n8k8 (tf32), its B read from the same slice by
//     ldmatrix: a tf32 wgmma of N = 8 or 16, and a bf16 one of N = 16 or
//     32, took longer than the mma.sync it replaces, or as long (measured
//     on the H100: tests/torch_conv3_bf16_diagnosis.py --wgmma-min-n).
// f32 is 3xTF32.  Each operand x is split into hi = tf32(x) and lo =
// tf32(x - hi), and a_lo.b_hi + a_hi.b_lo + a_hi.b_hi is accumulated in
// f32, which keeps f32 accuracy (about 2^-22 relative per product).
// ldmatrix of f32 rows yields the tf32 A fragment as it is; A is split in
// registers (tf32_rna), once per fragment for all three dy taps that read
// it; B comes pre-split, the hi and lo slices side by side in a chunk.
// bf16 has no split: a chunk holds one slice per dy.
// ops/conv3.py::build compiles this file once per block side, with
// PCGC_BS and the (ci, co) pairs to instantiate (PCGC_PAIRS) defined, into
// one library; the entry point of each side is pcgc_conv3_tc_bs<BS>;
// ops/conv3.py::tc_plan mirrors Cfg.
// Not yet: persistent CTAs, TMA multicast of the weights.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#ifndef PCGC_BS
#define PCGC_BS 16
#endif

namespace {

constexpr int SMEM_MAX = 232448 - 256;  // dynamic smem a block may use
// the least N (co padded) at which a wgmma beats the mma.sync it replaces,
// by dtype (ops/conv3.py::TC_WGMMA_MIN_N; measured on the H100)
constexpr int WG_MIN_N_F32 = 32;
constexpr int WG_MIN_N_BF16 = 64;

// halo coordinate h in [0, BS + 2) -> neighbour offset (0, 1, 2) and the
// cell it reads inside that neighbour block
template <int BS>
__device__ __forceinline__ void halo_src(int h, int& nbr, int& cell) {
  nbr = h == 0 ? 0 : (h == BS + 1 ? 2 : 1);
  cell = h == 0 ? BS - 1 : (h == BS + 1 ? 0 : h - 1);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of one N-byte piece (N = 16, 8 or 4)
template <int N>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src) {
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
                 "l"(src), "n"(N)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// N 8 x 8 b16 matrices by ldmatrix (N = 4, 2 or 1): lanes 8m .. 8m + 7
// address the rows of matrix m.  An A fragment of one m16 tile is x4 (k16
// bf16, k8 f32) or x2 (k8 bf16).
template <int N>
__device__ __forceinline__ void ldsm(uint32_t addr, uint32_t* r) {
  if constexpr (N == 4)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr));
  else if constexpr (N == 2)
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(addr));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x1.shared.b16 {%0}, [%1];\n"
                 : "=r"(r[0])
                 : "r"(addr));
}

template <int KS>
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  if constexpr (KS == 16) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(b0));
  }
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// f32 -> tf32 bits, rounded to nearest, ties away (the mma would
// truncate): the 13 low mantissa bits rounded off in integer arithmetic,
// which gives cvt.rna.tf32.f32's bits for every finite x in two
// instructions where the cvt takes several
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// f32 A fragment -> its tf32 hi and lo parts
__device__ __forceinline__ void split_tf32(const uint32_t (&a)[4],
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float x = __uint_as_float(a[e]);
    hi[e] = tf32_rna(x);
    lo[e] = tf32_rna(x - __uint_as_float(hi[e]));
  }
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// gather halo plane x0 + p (halo x coordinate, 0..BS+1), halo rows
// y_lo .. y_lo + HY - 1, of this CTA's block row into ring slot p % NB:
// HY x (BS+2) voxels from the neighbour rows rows[nx][ny][nz] of that
// plane, ci channels each
template <typename T, int CI, int RS, int HY, int THREADS, int BS, int NB>
__device__ __forceinline__ void stage(const T* __restrict__ feats,
                                      const int* rows, T* ring, int x0,
                                      int y_lo, int p, int t) {
  constexpr int HS = BS + 2, VOL = BS * BS * BS;
  int nx, sx;
  halo_src<BS>(x0 + p, nx, sx);
  T* slot = ring + (p % NB) * HY * HS * RS;
  constexpr int VB = CI * sizeof(T);          // bytes per voxel
  constexpr int PIECE = VB < 16 ? VB : 16;    // bytes per copy
  constexpr int CH = VB / PIECE;              // copies per voxel
  constexpr int PE = PIECE / sizeof(T);       // elements per copy
  for (int k = t; k < HY * HS * CH; k += THREADS) {
    const int r = k / CH, c = k % CH;
    int ny, sy, nz, sz;
    halo_src<BS>(y_lo + r / HS, ny, sy);
    halo_src<BS>(r % HS, nz, sz);
    const size_t row = rows[nx * 9 + ny * 3 + nz];
    const T* src = feats + (row * VOL + (sx * BS + sy) * BS + sz) * CI + c * PE;
    T* dst = slot + r * RS + c * PE;
    if constexpr (PIECE >= 4)
      cp_async<PIECE>(smem_u32(dst), src);
    else
      *dst = *src;  // a 2-byte voxel: cp.async moves 4, 8 or 16 bytes
  }
}

// CTAs per SM that `smem` bytes of dynamic shared memory (plus 1 KB
// reserved per CTA and rows[]) and `threads` threads admit
constexpr int tc_fit(int smem, int threads) {
  return 233472 / (smem + 1024 + 27 * 4) < 2048 / threads
             ? 233472 / (smem + 1024 + 27 * 4)
             : 2048 / threads;
}

// one-step weight slots (sb bytes, and a full and an empty mbarrier each)
// of a streamed instance: the most, from 2 up to 8 and the steps of a pass,
// that keep `keep` CTAs per SM beside the plane ring (0 if none does)
constexpr int tc_keep_slots(int ring, int sb, int nstep, int threads,
                            int keep) {
  int best = 0;
  for (int k = 2; k <= (nstep < 8 ? nstep : 8); ++k)
    if (ring + k * (sb + 16) <= SMEM_MAX &&
        tc_fit(ring + k * (sb + 16), threads) >= keep)
      best = k;
  return best;
}

// ... else the most that fit
constexpr int tc_slots(int ring, int sb, int nstep, int threads, int keep) {
  return tc_keep_slots(ring, sb, nstep, threads, keep) > 0
             ? tc_keep_slots(ring, sb, nstep, threads, keep)
             : tc_keep_slots(ring, sb, nstep, threads, 1);
}

// k chunks per step (kb weight bytes a chunk): the most of a tap's kc
// within 12 KB a step ...
constexpr int tc_kmax(int kc, int kb) {
  return kc > 1 && kc * kb > 12288 ? tc_kmax(kc / 2, kb) : kc;
}

// ... and where the weights stream, the most with which two slots keep
// `keep` CTAs per SM (finer steps before fewer CTAs), else that most
constexpr int tc_kgroup(int kc, int kb, int ring, int threads, int keep,
                        int g) {
  return tc_keep_slots(ring, g * kb, 9 * kc / g, threads, keep) > 0
             ? g
             : (g > 1 ? tc_kgroup(kc, kb, ring, threads, keep, g / 2)
                      : tc_kmax(kc, kb));
}

// An instance's tiling (ops/conv3.py::tc_plan mirrors it).  A step is one
// (dx, dz) and a group of k chunks of the 27-tap K loop: its weights are
// the 3 dy taps x PARTS KS x COP slices (f32: the TF32 hi and lo parts),
// SB bytes, and a pass over the NSTEP steps covers the whole kernel.
// 16^3: one output plane per step (the CTA's 16 or 8 rows, 2 or 1
// warpgroups).  8^3: two output planes per step, warps 0-1 on the first
// and 2-3 on the second, so that a CTA is one warpgroup and a pass of the
// weights serves 128 output voxels, as at 16^3; the plane ring then holds
// 6 planes (the step's 4 and the next step's 2).  One more warp, the
// producer, issues the weights' bulk copies.
template <typename T, int CI, int CO, int BS_>
struct Cfg {
  static_assert(BS_ == 16 || BS_ == 8, "block side");
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int BS = BS_;
  static constexpr int VOL = BS * BS * BS;
  static constexpr int HS = BS + 2;
  static constexpr int TY = 16 / BS;           // y rows per m16 tile
  static constexpr int PS = BS == 16 ? 1 : 2;  // output planes per step
  static constexpr int XP = BS == 16 ? 4 : 8;  // output planes per CTA
  static constexpr int NB = 2 * PS + 2;        // ring of staged planes
  static constexpr int SZ = sizeof(T);
  static constexpr int CIP = CI < 8 ? 8 : CI;
  static constexpr int COP = CO < 8 ? 8 : CO;  // the products' N
  // the products' depth: tf32 k8; bf16 k16, k8 at ci <= 8
  static constexpr int KS = F32 || CIP < 16 ? 8 : 16;
  static constexpr int KC = CIP / KS;  // k chunks per tap
  static constexpr int NT = COP / 8;   // n8 tiles
  static constexpr int PARTS = F32 ? 2 : 1;  // f32: TF32 hi and lo
  static constexpr bool X4 = KS * SZ == 32;  // A by ldmatrix .x4, else .x2
  static constexpr int RS = CIP + ((CIP * SZ / 16) % 2 == 0 ? 16 / SZ : 0);
  static constexpr int YS = NB * HS * HS * RS * SZ > SMEM_MAX ? 2 : 1;
  static constexpr int ROWS = BS / YS;  // output y rows per CTA
  static constexpr int HY = ROWS + 2;
  static constexpr int THREADS = PS * ROWS * BS;  // the consumer warps'
  static constexpr int NW = THREADS / 32;
  static_assert(NW % 4 == 0, "the consumers are whole warpgroups");
  static constexpr int CTA = THREADS + 32;    // and the producer warp
  static constexpr int WPL = ROWS * BS / 32;  // warps per output plane
  static constexpr int SLOT = HY * HS * RS;   // elements per plane buffer
  static constexpr int RING = NB * SLOT * SZ;
  // a KS x COP slice: K-major 8 x 16-byte core matrices (one n each row),
  // n tiles NTB bytes apart, a k16 tile's two k halves 128 apart
  static constexpr int NTB = KS * SZ * 8;
  static constexpr int SLB = NT * NTB;
  static constexpr int KB = 3 * PARTS * SLB;        // weights of a k chunk
  static constexpr int WB = 27 * CIP * COP * SZ * PARTS;  // the kernel
  static constexpr int KEEP = tc_fit(RING, CTA) < 2 ? tc_fit(RING, CTA) : 2;
  // the whole kernel once per CTA where it fits without costing CTAs per
  // SM (up to 2); else a ring of NS one-step slots, refilled as they free
  static constexpr bool WHOLE =
      RING + WB + 8 <= SMEM_MAX && tc_fit(RING + WB + 8, CTA) >= KEEP;
  // a step: one (dx, dz) and KG of its KC k chunks, SB bytes of weights
  static constexpr int KG =
      WHOLE ? tc_kmax(KC, KB)
            : tc_kgroup(KC, KB, RING, CTA, KEEP, tc_kmax(KC, KB));
  static constexpr int NSTEP = 9 * KC / KG;
  static constexpr int SB = KG * KB;
  static constexpr int NS = WHOLE ? 1 : tc_slots(RING, SB, NSTEP, CTA, KEEP);
  // the products: wgmma (m64nNk8 tf32, m64nNk16 bf16) where N = COP
  // reaches the dtype's WG_MIN_N and a chunk is 32 bytes deep; below,
  // where a wgmma takes longer than the mma.sync it replaces, mma.sync
  static constexpr bool WG =
      KS * SZ == 32 && COP >= (F32 ? WG_MIN_N_F32 : WG_MIN_N_BF16);
  static_assert(WHOLE || NS >= 2, "weight ring does not fit");
  static constexpr int WSM = WHOLE ? WB : NS * SB;
  static constexpr int NBAR = WHOLE ? 1 : 2 * NS;  // full[NS], empty[NS]
  static constexpr int SMEM = RING + WSM + 8 * NBAR;
  static_assert(SMEM <= SMEM_MAX, "shared memory");
  // CTAs per SM that shared memory admits; where that is 1 or 2 the
  // kernel asks for that many in __launch_bounds__: without it ptxas trims
  // registers (and spills) toward an occupancy the ring rules out anyway.
  // A wgmma instance asks for 1: below its registers ptxas serializes the
  // wgmmas.
  static constexpr int FIT = tc_fit(SMEM, CTA);
  static constexpr int MINB = WG ? 1 : (FIT <= 2 ? FIT : 0);
  static constexpr int TOT = XP / PS * NSTEP;  // steps of a CTA
  static constexpr int WPP = ROWS * BS / 4;    // mask words per plane
  static constexpr int MW = XP * WPP / THREADS;
  static_assert(MW * THREADS == XP * WPP, "mask words per thread");
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t n) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(n)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// 1-D bulk copy (TMA) of `bytes` (a multiple of 16) global -> shared,
// completing on the transaction count of mbarrier `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const void* src,
                                         uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma m64nNk8 tf32 / m64nNk16 bf16, N = co padded: d (this warp's 16 of
// the warpgroup's 64 rows, per n8 tile in mma.sync's m16n8 accumulator
// order) += A (this warp's m16 fragment in registers, in mma.sync's order)
// x B (K x N in shared memory, descriptor b; K-major, no transpose)
template <typename T, int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 8][4],
                                      const uint32_t (&a)[4], uint64_t b);

#define PCGC_WG_OP(T, N)                                                   \
  template <>                                                              \
  __device__ __forceinline__ void wgmma<T, N>(                             \
      float(&d)[N / 8][4], const uint32_t(&a)[4], uint64_t b)

PCGC_WG_OP(float, 32) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

PCGC_WG_OP(float, 64) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// bf16: the last immediate (imm-trans-b) 0 reads B K-major as staged
PCGC_WG_OP(__nv_bfloat16, 16) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

PCGC_WG_OP(__nv_bfloat16, 32) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

PCGC_WG_OP(__nv_bfloat16, 64) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef PCGC_WG_OP

// descriptor of a KS x N B slice at shared address `addr`, K-major
// without swizzle: 8 x 16-byte core matrices (one n each row: 4 tf32 or 8
// bf16 k), the two k halves of the 32-byte depth 128 bytes apart (leading
// byte offset), n tiles 256 apart (stride byte offset); the fields in
// 16-byte units
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accesses of the accumulators across the
// asynchronous wgmmas' issue and wait
template <int NT>
__device__ __forceinline__ void fence_acc(float (&acc)[2][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        asm volatile("" : "+f"(acc[mt][nt][e])::"memory");
}

// the A fragments of one k chunk of a warp: the TY + 3 m16 x KS fragments
// that its two tiles read over the 3 dy taps (tile mt, tap dy: fragment
// mt TY + dy); in f32 `a` is TF32's hi part and `lo` the rest
template <typename C>
struct Frags {
  uint32_t a[C::TY + 3][4], lo[C::F32 ? C::TY + 3 : 1][4];
};

// load (and in f32 split) the fragments of k chunk kc at dz of input
// plane pl (its shared address plus this lane's ldmatrix offset)
template <typename C>
__device__ __forceinline__ void load_frags(Frags<C>& f, uint32_t pl, int y0,
                                           int dz, int kc) {
#pragma unroll
  for (int r = 0; r < C::TY + 3; ++r) {
    const uint32_t at =
        pl + (((y0 + r) * C::HS + dz) * C::RS + kc * C::KS) * C::SZ;
    if constexpr (C::F32) {
      uint32_t a[4];
      ldsm<4>(at, a);
      split_tf32(a, f.a[r], f.lo[r]);
    } else {
      ldsm<C::X4 ? 4 : 2>(at, f.a[r]);
    }
  }
}

// issue the wgmmas of one k chunk for the warpgroup as one group (bf16:
// 3 dy x 2 tiles; f32: 3 dy x the products lo.hi, hi.lo, hi.hi x 2
// tiles); wb: shared address of the chunk's weights, whose (dy, part)
// slice is a KS x COP tile (`wgmma_desc`)
template <typename C>
__device__ __forceinline__ void issue_chunk(float (&acc)[2][C::NT][4],
                                            const Frags<C>& f, uint32_t wb) {
  using T = typename std::conditional<C::F32, float, __nv_bfloat16>::type;
  wgmma_fence();  // the fragments were just written
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    if constexpr (C::F32) {
      const uint64_t bh = wgmma_desc(wb + dy * 2 * C::SLB);
      const uint64_t bl = wgmma_desc(wb + (dy * 2 + 1) * C::SLB);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        wgmma<T, C::COP>(acc[mt], f.lo[mt * C::TY + dy], bh);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        wgmma<T, C::COP>(acc[mt], f.a[mt * C::TY + dy], bl);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        wgmma<T, C::COP>(acc[mt], f.a[mt * C::TY + dy], bh);
    } else {
      const uint64_t b = wgmma_desc(wb + dy * C::SLB);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        wgmma<T, C::COP>(acc[mt], f.a[mt * C::TY + dy], b);
    }
  }
  wgmma_commit();
}

// KG k chunks of a warpgroup's step on wgmma (input plane pl, chunks kc0
// ..): a chunk's products run while the next chunk's fragments are loaded
// (and split) into the other register set
template <typename C>
__device__ __forceinline__ void step_wgmma(float (&acc)[2][C::NT][4],
                                           uint32_t pl, int y0, int dz,
                                           int kc0, uint32_t wb) {
  Frags<C> f[2];
  fence_acc<C::NT>(acc);
#pragma unroll
  for (int kk = 0; kk < C::KG; ++kk) {
    load_frags<C>(f[kk & 1], pl, y0, dz, kc0 + kk);
    issue_chunk<C>(acc, f[kk & 1], wb + kk * C::KB);
    wgmma_wait<1>();  // the chunk before has retired: its set is free
  }
  wgmma_wait<0>();
  fence_acc<C::NT>(acc);
}

// the same on mma.sync, a warp's two m16 tiles; B by ldmatrix from the
// chunk's (dy, part) slices, b_lane this lane's row in them
template <typename C>
__device__ __forceinline__ void step_mma(float (&acc)[2][C::NT][4],
                                         uint32_t pl, int y0, int dz, int kc0,
                                         uint32_t wb, uint32_t b_lane) {
#pragma unroll
  for (int kk = 0; kk < C::KG; ++kk) {
    Frags<C> f;
    load_frags<C>(f, pl, y0, dz, kc0 + kk);
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      if constexpr (C::F32) {
        // lanes 8m .. 8m + 7 address core matrix m = (part m / 2, k half
        // m % 2) of n tile nt: (hi k = q, hi q + 4, lo q, lo q + 4) of n = g
        uint32_t b[C::NT][4];
#pragma unroll
        for (int nt = 0; nt < C::NT; ++nt)
          ldsm<4>(wb + kk * C::KB + dy * 2 * C::SLB + nt * 256 + b_lane,
                  b[nt]);
#pragma unroll
        for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            mma_tf32(acc[mt][nt], f.lo[mt * C::TY + dy], b[nt][0], b[nt][1]);
#pragma unroll
        for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            mma_tf32(acc[mt][nt], f.a[mt * C::TY + dy], b[nt][2], b[nt][3]);
#pragma unroll
        for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            mma_tf32(acc[mt][nt], f.a[mt * C::TY + dy], b[nt][0], b[nt][1]);
      } else {
        // the slice's NM core matrices lie in order (n tile, k half), 128
        // bytes each: matrix m's register holds k = 2q, 2q + 1 of n = g
        constexpr int KH = C::KS / 8, NM = C::NT * KH;
        uint32_t b[NM];
        const uint32_t s = wb + kk * C::KB + dy * C::SLB + b_lane;
#pragma unroll
        for (int m = 0; m < NM; m += 4)
          ldsm<(NM < 4 ? NM : 4)>(s + m * 128, b + m);
#pragma unroll
        for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            mma_bf16<C::KS>(acc[mt][nt], f.a[mt * C::TY + dy], b[nt * KH],
                            b[nt * KH + KH - 1]);
      }
    }
  }
}

// Step k of a warp's tile (its two m16 tiles, output rows y0 .. y0 + 2TY
// - 1 of local output plane jl): (dx, dz) and KG k chunks.  ring0: shared
// address of ring slot 0 plus this lane's ldmatrix offset; wb: the step's
// weights.
template <typename C>
__device__ __forceinline__ void step(float (&acc)[2][C::NT][4],
                                     uint32_t ring0, int jl, int y0, int k,
                                     uint32_t wb, uint32_t b_lane) {
  constexpr int NG = C::NSTEP / 9;  // k groups per (dx, dz)
  const int dx = k / (3 * NG), dz = k / NG % 3, kc0 = k % NG * C::KG;
  const uint32_t pl = ring0 + ((jl + dx) % C::NB) * C::SLOT * C::SZ;
  if constexpr (C::WG)
    step_wgmma<C>(acc, pl, y0, dz, kc0, wb);
  else
    step_mma<C>(acc, pl, y0, dz, kc0, wb, b_lane);
}

// The CTA's weights: the whole packed kernel at shared address w, or a ring
// of NS one-step slots with full / empty mbarriers
template <typename C>
struct Weights {
  uint32_t w, full, empty;

  // shared address of step k of pass js (waits for it where streamed)
  __device__ __forceinline__ uint32_t acquire(int js, int k) const {
    if constexpr (C::WHOLE) {
      mbar_wait(full, 0);
      return w + k * C::SB;
    }
    const int gs = js * C::NSTEP + k, s = gs % C::NS;
    mbar_wait(full + 8 * s, (gs / C::NS) & 1);
    return w + s * C::SB;
  }
  // this warp is done with step k of pass js
  __device__ __forceinline__ void release(int js, int k, int lane) const {
    if constexpr (!C::WHOLE) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * ((js * C::NSTEP + k) % C::NS));
    }
  }
};

template <int THREADS>
__device__ __forceinline__ void consumer_sync() {  // the consumer warps
  asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");
}

template <typename T, int CI, int CO, int BS>
__device__ __forceinline__ void conv3_staged(const T* __restrict__ feats,
                                             const int* __restrict__ nbrs,
                                             const uint8_t* __restrict__ mask,
                                             const int* __restrict__ count,
                                             const T* wpack,
                                             const T* __restrict__ bias,
                                             T* __restrict__ out) {
  using C = Cfg<T, CI, CO, BS>;
  constexpr int VOL = C::VOL, XP = C::XP, PS = C::PS;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  __shared__ int rows[27];

  const int i = blockIdx.x;
  const int x0 = blockIdx.y * XP;
  const int ybase = blockIdx.z * C::ROWS;  // first output y row
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  // a row >= count or a tile without an occupied slot: zeros, nothing else
  uint32_t m4 = 0u;
  if (t < C::THREADS) {
#pragma unroll
    for (int w = 0; w < C::MW; ++w) {
      const int k = t + w * C::THREADS;
      m4 |= *reinterpret_cast<const uint32_t*>(
          mask + (size_t)i * VOL + (x0 + k / C::WPP) * BS * BS + ybase * BS +
          4 * (k % C::WPP));
    }
  }
  const int any = __syncthreads_or(m4 != 0u);
  if (i >= *count || !any) {
    constexpr int N16 = C::ROWS * BS * CO * C::SZ / 16;  // per plane
    for (int k = t; k < XP * N16; k += C::CTA) {
      uint4* o = reinterpret_cast<uint4*>(
          out + ((size_t)i * VOL + ((x0 + k / N16) * BS + ybase) * BS) * CO);
      o[k % N16] = make_uint4(0, 0, 0, 0);
    }
    return;
  }
  if (t < 27) rows[t] = nbrs[(size_t)i * 27 + t];
  if constexpr (CI < C::CIP) {  // ci < 8: zero the padded voxels once
    constexpr int N16 = C::CIP * C::SZ / 16;
    for (int k = t; k < C::NB * C::HY * C::HS * N16; k += C::CTA)
      *reinterpret_cast<uint4*>(ring + (k / N16) * C::RS +
                                (k % N16) * 16 / C::SZ) =
          make_uint4(0, 0, 0, 0);
  }
  // the weights: shared bytes [RING, RING + WSM), then the mbarriers
  Weights<C> wt;
  wt.w = smem_u32(smem + C::RING);
  wt.full = wt.w + C::WSM;
  wt.empty = wt.full + 8 * C::NS;
  if (t == 0) {
    for (int s = 0; s < C::NS; ++s) {
      mbar_init(wt.full + 8 * s, 1);
      if constexpr (!C::WHOLE) mbar_init(wt.empty + 8 * s, C::NW);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == C::NW) {  // the producer: the whole kernel, or step by step
    if (lane == 0) {
      const char* src = reinterpret_cast<const char*>(wpack);
      for (int c = 0; c < (C::WHOLE ? 1 : C::TOT); ++c) {
        const int s = c % C::NS;
        if (c >= C::NS) mbar_wait(wt.empty + 8 * s, (c / C::NS - 1) & 1);
        mbar_expect_tx(wt.full + 8 * s, C::WSM / C::NS);
        tma_load(wt.w + s * C::SB, src + (size_t)(c % C::NSTEP) * C::SB,
                 C::WSM / C::NS, wt.full + 8 * s);
      }
    }
    return;
  }

  for (int p = 0; p < PS + 2; ++p) {
    stage<T, CI, C::RS, C::HY, C::THREADS, BS, C::NB>(feats, rows, ring, x0,
                                                      ybase, p, t);
    cp_async_commit();
  }

  const int g = lane >> 2, q = lane & 3;
  const int pw = warp / C::WPL;                // output plane within a step
  const int y0 = (warp % C::WPL) * 2 * C::TY;  // first local output row
  // this lane's ldmatrix row: m16 row r = lane % 16 is voxel (y0' + r / BS,
  // r % BS) of a tile starting at row y0'; and its k half inside a plane
  const int r16 = lane & 15;
  const uint32_t ring0 = smem_u32(ring) +
                         ((r16 / BS * C::HS + r16 % BS) * C::RS) * C::SZ +
                         (lane >> 4) * 16;
  // ... and its row in the B slices of the mma.sync products (f32: the hi
  // and lo slices of one n tile; bf16: core matrices in order)
  const uint32_t b_lane = C::F32 ? (lane >> 4) * C::SLB +
                                       ((lane >> 3) & 1) * 128 +
                                       (lane & 7) * 16
                                 : lane * 16;
  float bv[C::NT][2];
#pragma unroll
  for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = nt * 8 + 2 * q + e;
      bv[nt][e] = (bias != nullptr && col < CO) ? to_f(bias[col]) : 0.f;
    }

  for (int js = 0; js < XP / PS; ++js) {
    for (int p = js * PS + PS + 2; p < js * PS + 2 * PS + 2; ++p)
      if (p < XP + 2)
        stage<T, CI, C::RS, C::HY, C::THREADS, BS, C::NB>(
            feats, rows, ring, x0, ybase, p, t);
    cp_async_commit();
    cp_async_wait<1>();  // the step's planes have landed (this thread's part)
    consumer_sync<C::THREADS>();  // ... and every consumer's

    const int jl = js * PS + pw;  // this warp's output plane, local
    // the warp's 32 output voxels are consecutive in the mask: lane l is
    // m16 row l % 16 of tile l / 16
    const size_t vbase =
        (size_t)i * VOL + ((x0 + jl) * BS + ybase + y0) * BS;
    const uint32_t bits =
        __ballot_sync(0xffffffffu, mask[vbase + lane] != 0);
    // a warp skips an empty tile; a wgmma takes the whole warpgroup, whose
    // 128 output voxels of the step are consecutive in the mask too, and
    // it skips the products where they are all empty
    const bool live =
        C::WG ? __any_sync(0xffffffffu,
                           *reinterpret_cast<const uint32_t*>(
                               mask + (size_t)i * VOL +
                               ((x0 + js * PS) * BS + ybase) * BS +
                               (warp >> 2) * 128 + 4 * lane) != 0u)
              : bits != 0u;
    float acc[2][C::NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
#pragma unroll 1
    for (int k = 0; k < C::NSTEP; ++k) {
      const uint32_t wb = wt.acquire(js, k);
      if (live) step<C>(acc, ring0, jl, y0, k, wb, b_lane);
      wt.release(js, k, lane);
    }

    // epilogue: this lane holds m16 rows m = g and g+8 of both tiles,
    // columns nt*8 + 2q, +1; f32: add the bias; bf16: round, add the bias
    // in bf16; then mask; columns >= co are padding and not stored
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      T* orow = out + (vbase + mt * 16) * CO;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = g + 8 * h;
        const bool keep = (bits >> (mt * 16 + m)) & 1u;
#pragma unroll
        for (int nt = 0; nt < C::NT; ++nt) {
          const int col = nt * 8 + 2 * q;
          if (col >= CO) continue;
          float r0 = acc[mt][nt][2 * h], r1 = acc[mt][nt][2 * h + 1];
          if constexpr (C::F32) {
            r0 += bv[nt][0];
            r1 += bv[nt][1];
          } else {
            r0 = round_bf16(r0);
            r1 = round_bf16(r1);
            if (bias != nullptr) {
              r0 = round_bf16(r0 + bv[nt][0]);
              r1 = round_bf16(r1 + bv[nt][1]);
            }
          }
          if (!keep) r0 = r1 = 0.f;
          T* o = orow + m * CO + col;
          if constexpr (C::F32) {
            if constexpr (CO == 1)
              *o = r0;
            else
              *reinterpret_cast<float2*>(o) = make_float2(r0, r1);
          } else {
            if constexpr (CO == 1)
              *o = __float2bfloat16_rn(r0);
            else
              *reinterpret_cast<__nv_bfloat162*>(o) =
                  __floats2bfloat162_rn(r0, r1);
          }
        }
      }
    }
    consumer_sync<C::THREADS>();  // the step's oldest planes are restaged
  }
}

// The entry points, by dtype: one with the plain thread bound, one that
// also asks for the config's MINB CTAs per SM.  Profiles find them by the
// name conv3_tc_kernel.
#define PCGC_PARAMS(T)                                                     \
  const T *__restrict__ feats, const int *__restrict__ nbrs,              \
      const uint8_t *__restrict__ mask, const int *__restrict__ count,    \
      const T *wpack, const T *__restrict__ bias, T *__restrict__ out
#define PCGC_ENTRY(NAME, T, ...)                                           \
  template <int CI, int CO, int BS>                                        \
  __global__ void __launch_bounds__(__VA_ARGS__) NAME(PCGC_PARAMS(T)) {    \
    conv3_staged<T, CI, CO, BS>(feats, nbrs, mask, count, wpack, bias,    \
                                out);                                      \
  }

PCGC_ENTRY(conv3_tc_kernel_f32, float, Cfg<float, CI, CO, BS>::CTA)
PCGC_ENTRY(conv3_tc_kernel_f32_fit, float, Cfg<float, CI, CO, BS>::CTA,
           Cfg<float, CI, CO, BS>::MINB)
PCGC_ENTRY(conv3_tc_kernel_bf16, __nv_bfloat16,
           Cfg<__nv_bfloat16, CI, CO, BS>::CTA)
PCGC_ENTRY(conv3_tc_kernel_bf16_fit, __nv_bfloat16,
           Cfg<__nv_bfloat16, CI, CO, BS>::CTA,
           Cfg<__nv_bfloat16, CI, CO, BS>::MINB)

#undef PCGC_ENTRY
#undef PCGC_PARAMS

template <typename T, int CI, int CO, int BS>
int launch(const void* feats, const void* nbrs, const void* mask,
           const void* count, const void* wpack, const void* bias, void* out,
           int nb, const int* plan, cudaStream_t stream) {
  using C = Cfg<T, CI, CO, BS>;
  if (plan[0] != C::XP || plan[1] != C::ROWS || plan[2] != C::SMEM ||
      plan[3] != C::PS || plan[4] != C::NS)
    return -2;  // the wrapper's plan is not this instance's
  if (reinterpret_cast<uintptr_t>(wpack) % 16 != 0) return -3;  // bulk copy
  void (*kern)(const T*, const int*, const uint8_t*, const int*, const T*,
               const T*, T*);
  if constexpr (C::F32 && C::MINB > 0)
    kern = conv3_tc_kernel_f32_fit<CI, CO, BS>;
  else if constexpr (C::F32)
    kern = conv3_tc_kernel_f32<CI, CO, BS>;
  else if constexpr (C::MINB > 0)
    kern = conv3_tc_kernel_bf16_fit<CI, CO, BS>;
  else
    kern = conv3_tc_kernel_bf16<CI, CO, BS>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(nb, BS / C::XP, C::YS);
  kern<<<grid, C::CTA, C::SMEM, stream>>>(
      static_cast<const T*>(feats), static_cast<const int*>(nbrs),
      static_cast<const uint8_t*>(mask), static_cast<const int*>(count),
      static_cast<const T*>(wpack), static_cast<const T*>(bias),
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The (ci, co) pairs to instantiate, X(ci, co) each: by default all of
// {1, 4, 8, 16, 32, 64}^2; ops/conv3.py::build defines the list of each
// block side.
#ifndef PCGC_PAIRS
#define PCGC_CO_ALL(X, ci) \
  X(ci, 1) X(ci, 4) X(ci, 8) X(ci, 16) X(ci, 32) X(ci, 64)
#define PCGC_PAIRS(X)                                                    \
  PCGC_CO_ALL(X, 1) PCGC_CO_ALL(X, 4) PCGC_CO_ALL(X, 8) PCGC_CO_ALL(X, 16) \
      PCGC_CO_ALL(X, 32) PCGC_CO_ALL(X, 64)
#endif

template <typename T>
int by_pair(const void* feats, const void* nbrs, const void* mask,
            const void* count, const void* wpack, const void* bias, void* out,
            int nb, const int* plan, cudaStream_t s, int ci, int co) {
#define PCGC_CASE(ci_, co_)                                                \
  if (ci == ci_ && co == co_)                                              \
    return launch<T, ci_, co_, PCGC_BS>(feats, nbrs, mask, count, wpack,   \
                                        bias, out, nb, plan, s);
  PCGC_PAIRS(PCGC_CASE)
#undef PCGC_CASE
  return -1;
}

}  // namespace

#define PCGC_CAT2(a, b) a##b
#define PCGC_CAT(a, b) PCGC_CAT2(a, b)

// pcgc_conv3_tc_bs16 / pcgc_conv3_tc_bs8: feats [nb, BS^3, ci], bias [co]
// (or null) and out [nb, BS^3, co] in f32 (bf16 = 0) or bf16 (bf16 = 1);
// nbrs int32 [nb, 27]; mask bool [nb, BS^3] (4-byte aligned); count int32
// [1] on the device; weight: the [3,3,3,ci,co] kernel packed by
// ops/conv3.py::pack_weight as the shared-memory image of the kernel's
// steps (K-major core matrices per (dx, dz, k chunk, dy), f32 as its TF32
// hi and lo parts), 16-byte aligned; plan int32[5] on the host: (XP,
// ROWS, SMEM, PS, NS) of ops/conv3.py::tc_plan.  Returns 0, a
// cudaError_t of the launch, -1 for an instance it does not have, -2
// where `plan` is not the instance's, -3 for a misaligned weight.
extern "C" int PCGC_CAT(pcgc_conv3_tc_bs, PCGC_BS)(
    const void* feats, const void* nbrs, const void* mask, const void* count,
    const void* weight, const void* bias, void* out, const int* plan, int nb,
    int ci, int co, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return by_pair<__nv_bfloat16>(feats, nbrs, mask, count, weight, bias, out,
                                  nb, plan, s, ci, co);
  return by_pair<float>(feats, nbrs, mask, count, weight, bias, out, nb, plan,
                        s, ci, co);
}
