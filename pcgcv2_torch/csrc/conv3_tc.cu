// 3^3 stride-1 sparse convolution over dense BS^3 voxel blocks (BS = 16
// or 8, a template parameter) on the tensor cores (sm_90a, mma.sync), in
// bf16 and in f32 through split TF32.
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
//   * bf16: mma.sync m16n8k16 (m16n8k8 for ci <= 8).  f32: m16n8k8 tf32
//     three times (3xTF32): each operand x is split into hi = tf32(x) and
//     lo = tf32(x - hi), and a_lo.b_hi + a_hi.b_lo + a_hi.b_hi is
//     accumulated in f32, which keeps f32 accuracy (about 2^-22 relative
//     per product).  ldmatrix of f32 rows yields the tf32 A fragment as
//     it is; A is split in registers, B comes pre-split.  The split makes
//     the A side cost more than the MMAs at narrow co, so each fragment
//     is loaded and split once for all three dy taps that read it
//     (tile_f32);
//   * ci < 8 is zero-padded to 8 channels in shared memory, co < 8 to one
//     n8 tile (only the real columns are stored);
//   * each warp owns two m16 tiles, 32 output voxels of a plane (2 y rows
//     at BS = 16, 4 at BS = 8), and every output channel.  A CTA = one
//     live block row x XP output x-planes x ROWS output y rows, one thread
//     per (y, z) voxel of its ROWS rows:
//       BS = 16: XP = 4 of the 16 planes, ROWS = 16 (8 warps), or 8 (4
//         warps) where a 4-plane ring of full planes does not fit in
//         shared memory (f32 at ci = 64): the y-halves then restage 2 of
//         their 10 halo rows each (11% more staged bytes);
//       BS = 8: the whole block, XP = 8, ROWS = 8 (2 warps, 512 outputs).
//         A block has an eighth of a 16^3 block's slots and the grid about
//         4x the rows, so one CTA per row keeps 8 m-tile pairs per warp
//         (as many as at BS = 16) and stages 10 halo planes for 8 output
//         planes (the 4-plane slab would stage 6 for 4).  Its ring of 4
//         planes of 10 x 10 voxels is at most 108,800 bytes (f32, ci =
//         64), so no y-split is needed and 2-4 CTAs share an SM: 4-8
//         warps, as the 16^3 instances run 4-8;
//   * the XP+2 input planes it needs are gathered as (ROWS+2) x (BS+2) x
//     ci tiles from the neighbour rows of each plane with cp.async (16
//     bytes, or 8 or 4 for a narrower voxel; a 2-byte bf16 voxel is copied
//     by plain loads; misses read the zero sentinel row, no branch) into a
//     ring of 4 plane buffers, so plane x+3 is in flight while plane x is
//     consumed;
//   * staged voxel rows are padded by 16 bytes where the row is an even
//     number of 16-byte groups: the 8 rows of one ldmatrix phase then fall
//     on distinct bank groups;
//   * B fragments come pre-packed in mma fragment order (ops/conv3.py::
//     pack_weight, packed once per layer) and are read with one 4-, 8- or
//     16-byte __ldg per lane from L1/L2;
//   * empty tiles are skipped exactly: the output is re-masked, so a CTA
//     whose tile holds no occupied slot only writes zeros, and a warp
//     whose 32 output voxels are empty skips its MMAs.
// ops/conv3.py::build compiles this file once per block side, with
// PCGC_BS and the (ci, co) pairs to instantiate (PCGC_PAIRS) defined, into
// one library; the entry point of each side is pcgc_conv3_tc_bs<BS>.
// Not yet: wgmma, TMA, warp specialisation, persistent CTAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#ifndef PCGC_BS
#define PCGC_BS 16
#endif

namespace {

constexpr int NBUF = 4;                 // ring of staged input planes
constexpr int SMEM_MAX = 232448 - 256;  // dynamic smem a block may use

template <typename T, int CI, int CO, int BS_>
struct Cfg {
  static_assert(BS_ == 16 || BS_ == 8, "block side");
  static constexpr int BS = BS_;
  static constexpr int VOL = BS * BS * BS;
  static constexpr int HS = BS + 2;
  static constexpr int XP = BS == 16 ? 4 : 8;  // output x-planes per CTA
  static constexpr int TY = 16 / BS;           // y rows per m16 tile
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int SZ = sizeof(T);
  static constexpr int CIP = CI < 8 ? 8 : CI;  // channels per staged voxel
  static constexpr int COP = CO < 8 ? 8 : CO;  // n8-padded output width
  // mma depth in elements: tf32 m16n8k8; bf16 m16n8k16, m16n8k8 at ci <= 8
  static constexpr int KS = F32 ? 8 : (CIP >= 16 ? 16 : 8);
  static constexpr int KC = CIP / KS;  // k chunks per tap
  static constexpr int NT = COP / 8;   // n8 tiles
  // packed B words per lane per (k chunk, n tile): bf16 pairs, or the tf32
  // hi and lo halves of the two f32 values
  static constexpr int FRAG = F32 ? 4 : KS / 8;
  static constexpr bool X4 = KS * SZ == 32;  // A by ldmatrix .x4 (else .x2)
  // staged voxel stride in elements: an odd number of 16-byte groups keeps
  // ldmatrix conflict-free
  static constexpr int RS = CIP + ((CIP * SZ / 16) % 2 == 0 ? 16 / SZ : 0);
  static constexpr int YS =  // y-halves per block row
      NBUF * HS * HS * RS * SZ > SMEM_MAX ? 2 : 1;
  static constexpr int ROWS = BS / YS;  // output y rows per CTA
  static constexpr int HY = ROWS + 2;   // staged halo y rows
  // one thread per (y, z) voxel of the CTA's rows: 32 per warp
  static constexpr int THREADS = ROWS * BS;
  static constexpr int SLOT = HY * HS * RS;  // elements per plane buffer
  static constexpr int SMEM = NBUF * SLOT * SZ;
  static_assert(SMEM <= SMEM_MAX, "plane ring does not fit");
  // CTAs per SM that shared memory admits (228 KB per SM, 1 KB reserved
  // per CTA, plus rows[]).  Where that is 1 or 2 the kernel asks for that
  // many in __launch_bounds__: without it ptxas trims registers (and
  // spills) toward an occupancy the ring rules out anyway.
  static constexpr int FIT = 233472 / (SMEM + 1024 + 27 * 4);
  static constexpr int MINB = FIT <= 2 ? FIT : 0;
  // the CTA's slab of the mask, XP x ROWS x BS bytes: MW words per thread
  // (1 at BS = 16, 2 at BS = 8)
  static constexpr int WPP = ROWS * BS / 4;  // mask words per plane
  static constexpr int MW = XP * WPP / THREADS;
  static_assert(MW * THREADS == XP * WPP, "mask words per thread");
};

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

// A fragment of one m16 tile: x4 = k16 bf16 or k8 f32, x2 = k8 bf16
template <bool X4>
__device__ __forceinline__ void ldsm_a(uint32_t addr, uint32_t (&a)[4]) {
  if constexpr (X4) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
        : "r"(addr));
  } else {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(a[0]), "=r"(a[1])
                 : "r"(addr));
  }
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

// f32 -> tf32 bits, rounded to nearest, ties away (the mma would truncate)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
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
__device__ __forceinline__ void from_f(float v, float* o) { *o = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* o) {
  *o = __float2bfloat16_rn(v);
}

// gather halo plane x0 + p (halo x coordinate, 0..BS+1), halo rows
// y_lo .. y_lo + HY - 1, of this CTA's block row into ring slot p % NBUF:
// HY x (BS+2) voxels from the neighbour rows rows[nx][ny][nz] of that
// plane, ci channels each
template <typename T, int CI, int RS, int HY, int THREADS, int BS>
__device__ __forceinline__ void stage(const T* __restrict__ feats,
                                      const int* rows, T* ring, int x0,
                                      int y_lo, int p, int t) {
  constexpr int HS = BS + 2, VOL = BS * BS * BS;
  int nx, sx;
  halo_src<BS>(x0 + p, nx, sx);
  T* slot = ring + (p % NBUF) * HY * HS * RS;
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

// The 27-tap implicit GEMM of one warp tile (output rows y0 .. y0 + 2TY - 1
// of output plane j, every column; m16 tile mt starts at row y0 + mt TY)
// into acc.  ring0: shared address of ring slot 0 plus this lane's
// ldmatrix offset.
template <typename C>
__device__ __forceinline__ void tile_bf16(float (&acc)[2][C::NT][4],
                                          uint32_t ring0, int j, int y0,
                                          const uint32_t* __restrict__ wpack,
                                          int lane) {
#pragma unroll 1
  for (int dx = 0; dx < 3; ++dx) {
    const uint32_t pl = ring0 + ((j + dx) % NBUF) * C::SLOT * C::SZ;
#pragma unroll 1
    for (int k9 = 0; k9 < 9; ++k9) {
      const int dy = k9 / 3, dz = k9 % 3;
      const uint32_t* wt =
          wpack + (size_t)(dx * 9 + k9) * C::KC * C::NT * 32 * C::FRAG +
          lane * C::FRAG;
#pragma unroll
      for (int kc = 0; kc < C::KC; ++kc) {
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldsm_a<C::X4>(pl + (((y0 + mt * C::TY + dy) * C::HS + dz) * C::RS +
                              kc * C::KS) *
                                 C::SZ,
                        a[mt]);
#pragma unroll
        for (int nt = 0; nt < C::NT; ++nt) {
          const uint32_t* w = wt + (kc * C::NT + nt) * 32 * C::FRAG;
          uint2 b;
          if constexpr (C::FRAG == 2)
            b = __ldg(reinterpret_cast<const uint2*>(w));
          else
            b = make_uint2(__ldg(w), 0u);
          mma_bf16<C::KS>(acc[0][nt], a[0], b.x, b.y);
          mma_bf16<C::KS>(acc[1][nt], a[1], b.x, b.y);
        }
      }
    }
  }
}

// f32 by 3xTF32.  The two m16 tiles of a warp, over the three dy taps,
// read the A fragments that start at input rows y0 .. y0 + TY + 2 (tile mt,
// tap dy: row y0 + mt TY + dy), so for each (dx, dz, k chunk) those TY + 3
// fragments are loaded and split once and serve all 6 (tile, dy) pairs:
// 4 (BS = 16) or 5 (BS = 8) ldmatrix and splits where one tap at a time
// takes 6.  The
// three products run as three passes over the n tiles, so back-to-back
// MMAs are independent.  Where a CTA has only 4 warps (ci = 64, half
// planes) and co <= 16 (at most 4 accumulator tiles per warp), lo.hi and
// hi.lo go to accumulators of their own, which keeps the dependent chains
// on one accumulator short.
template <typename C>
__device__ __forceinline__ void tile_f32(float (&acc)[2][C::NT][4],
                                         uint32_t ring0, int j, int y0,
                                         const uint32_t* __restrict__ wpack,
                                         int lane) {
  constexpr bool SEP = C::YS == 2 && C::NT <= 2;
  float ext[2][2][C::NT][4];  // lo.hi and hi.lo sums (SEP only)
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) ext[p][mt][nt][e] = 0.f;
  const uint4* wl = reinterpret_cast<const uint4*>(wpack) + lane;
#pragma unroll 1
  for (int dx = 0; dx < 3; ++dx) {
    const uint32_t pl = ring0 + ((j + dx) % NBUF) * C::SLOT * C::SZ;
#pragma unroll 1
    for (int dz = 0; dz < 3; ++dz) {
#pragma unroll
      for (int kc = 0; kc < C::KC; ++kc) {
        constexpr int NR = C::TY + 3;  // fragments of the 6 (tile, dy)
        uint32_t hi[NR][4], lo[NR][4];
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          uint32_t a[4];
          ldsm_a<true>(
              pl + (((y0 + r) * C::HS + dz) * C::RS + kc * C::KS) * C::SZ, a);
          split_tf32(a, hi[r], lo[r]);
        }
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const int tap = dx * 9 + dy * 3 + dz;
          uint4 b[C::NT];
#pragma unroll
          for (int nt = 0; nt < C::NT; ++nt)
            b[nt] = __ldg(wl + ((size_t)(tap * C::KC + kc) * C::NT + nt) * 32);
#pragma unroll
          for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
              mma_tf32(SEP ? ext[0][mt][nt] : acc[mt][nt], lo[mt * C::TY + dy],
                       b[nt].x, b[nt].y);
#pragma unroll
          for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
              mma_tf32(SEP ? ext[1][mt][nt] : acc[mt][nt], hi[mt * C::TY + dy],
                       b[nt].z, b[nt].w);
#pragma unroll
          for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
              mma_tf32(acc[mt][nt], hi[mt * C::TY + dy], b[nt].x, b[nt].y);
        }
      }
    }
  }
  if constexpr (SEP) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[mt][nt][e] += ext[0][mt][nt][e] + ext[1][mt][nt][e];
  }
}

template <typename T, int CI, int CO, int BS>
__device__ __forceinline__ void conv3_tc(const T* __restrict__ feats,
                                         const int* __restrict__ nbrs,
                                         const uint8_t* __restrict__ mask,
                                         const int* __restrict__ count,
                                         const uint32_t* __restrict__ wpack,
                                         const T* __restrict__ bias,
                                         T* __restrict__ out) {
  using C = Cfg<T, CI, CO, BS>;
  constexpr int VOL = C::VOL, XP = C::XP;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  __shared__ int rows[27];

  const int i = blockIdx.x;
  const int x0 = blockIdx.y * XP;
  const int ybase = blockIdx.z * C::ROWS;  // first output y row
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  // a row >= count or a tile without an occupied slot: zeros, nothing else
  uint32_t m4 = 0u;
#pragma unroll
  for (int w = 0; w < C::MW; ++w) {
    const int k = t + w * C::THREADS;
    m4 |= *reinterpret_cast<const uint32_t*>(
        mask + (size_t)i * VOL + (x0 + k / C::WPP) * BS * BS + ybase * BS +
        4 * (k % C::WPP));
  }
  const int any = __syncthreads_or(m4 != 0u);
  if (i >= *count || !any) {
    constexpr int N16 = C::ROWS * BS * CO * C::SZ / 16;  // per plane
    for (int k = t; k < XP * N16; k += C::THREADS) {
      uint4* o = reinterpret_cast<uint4*>(
          out + ((size_t)i * VOL + ((x0 + k / N16) * BS + ybase) * BS) * CO);
      o[k % N16] = make_uint4(0, 0, 0, 0);
    }
    return;
  }
  if (t < 27) rows[t] = nbrs[(size_t)i * 27 + t];
  if constexpr (CI < C::CIP) {  // ci < 8: zero the padded voxels once
    constexpr int N16 = C::CIP * C::SZ / 16;
    for (int k = t; k < NBUF * C::HY * C::HS * N16; k += C::THREADS)
      *reinterpret_cast<uint4*>(ring + (k / N16) * C::RS + (k % N16) * 16 /
                                                               C::SZ) =
          make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  for (int p = 0; p < 3; ++p) {
    stage<T, CI, C::RS, C::HY, C::THREADS, BS>(feats, rows, ring, x0, ybase,
                                               p, t);
    cp_async_commit();
  }

  const int g = lane >> 2, q = lane & 3;
  const int y0 = warp * 2 * C::TY;  // first local output row of this warp
  // this lane's ldmatrix row: m16 row r = lane % 16 is voxel (y0' + r / BS,
  // r % BS) of a tile starting at row y0'; and its k half inside a plane
  const int r16 = lane & 15;
  const uint32_t a_lane = ((r16 / BS * C::HS + r16 % BS) * C::RS) * C::SZ +
                          (C::X4 ? (lane >> 4) * 16 : 0);
  float bv[C::NT][2];
#pragma unroll
  for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = nt * 8 + 2 * q + e;
      bv[nt][e] = (bias != nullptr && col < CO) ? to_f(bias[col]) : 0.f;
    }

  for (int j = 0; j < XP; ++j) {
    if (j + 3 < XP + 2)
      stage<T, CI, C::RS, C::HY, C::THREADS, BS>(feats, rows, ring, x0,
                                                 ybase, j + 3, t);
    cp_async_commit();
    cp_async_wait<1>();  // planes j .. j+2 have landed (this thread's part)
    __syncthreads();     // ... and everyone's

    const int xo = x0 + j;
    // the warp's 32 output voxels are consecutive in the mask: lane l is
    // m16 row l % 16 of tile l / 16
    const size_t vbase = (size_t)i * VOL + (xo * BS + ybase + y0) * BS;
    const uint32_t bits =
        __ballot_sync(0xffffffffu, mask[vbase + lane] != 0);
    float acc[2][C::NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

    if (bits != 0u) {  // warp tile with an occupied slot
      const uint32_t ring0 = smem_u32(ring) + a_lane;
      if constexpr (C::F32)
        tile_f32<C>(acc, ring0, j, y0, wpack, lane);
      else
        tile_bf16<C>(acc, ring0, j, y0, wpack, lane);
    }

    // epilogue: this lane holds m16 rows m = g and g+8 of both tiles,
    // columns nt*8 + 2q, +1.  bf16: round, add the bias in bf16.  f32: add
    // the bias.  Then mask; columns >= co are padding and not stored.
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
          if constexpr (CO == 1) {
            from_f(r0, o);
          } else if constexpr (C::F32) {
            *reinterpret_cast<float2*>(o) = make_float2(r0, r1);
          } else {
            *reinterpret_cast<__nv_bfloat162*>(o) =
                __floats2bfloat162_rn(r0, r1);
          }
        }
      }
    }
    __syncthreads();  // slot j % NBUF is restaged by the next iteration
  }
}

// The entry points: one with the plain thread bound, one that also asks
// for Cfg::MINB CTAs per SM.
#define PCGC_PARAMS                                                        \
  const T *__restrict__ feats, const int *__restrict__ nbrs,              \
      const uint8_t *__restrict__ mask, const int *__restrict__ count,    \
      const uint32_t *__restrict__ wpack, const T *__restrict__ bias,     \
      T *__restrict__ out

template <typename T, int CI, int CO, int BS>
__global__ void __launch_bounds__(Cfg<T, CI, CO, BS>::THREADS)
    conv3_tc_kernel(PCGC_PARAMS) {
  conv3_tc<T, CI, CO, BS>(feats, nbrs, mask, count, wpack, bias, out);
}

template <typename T, int CI, int CO, int BS>
__global__ void __launch_bounds__(Cfg<T, CI, CO, BS>::THREADS,
                                  Cfg<T, CI, CO, BS>::MINB)
    conv3_tc_kernel_fit(PCGC_PARAMS) {
  conv3_tc<T, CI, CO, BS>(feats, nbrs, mask, count, wpack, bias, out);
}

#undef PCGC_PARAMS

template <typename T, int CI, int CO, int BS>
int launch(const void* feats, const void* nbrs, const void* mask,
           const void* count, const void* wpack, const void* bias, void* out,
           int nb, const int* plan, cudaStream_t stream) {
  using C = Cfg<T, CI, CO, BS>;
  if (plan[0] != C::XP || plan[1] != C::ROWS || plan[2] != C::SMEM)
    return -2;  // the wrapper's plan is not this instance's
  void (*kern)(const T*, const int*, const uint8_t*, const int*,
               const uint32_t*, const T*, T*);
  if constexpr (C::MINB > 0)
    kern = conv3_tc_kernel_fit<T, CI, CO, BS>;
  else
    kern = conv3_tc_kernel<T, CI, CO, BS>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(nb, BS / C::XP, C::YS);
  kern<<<grid, C::THREADS, C::SMEM, stream>>>(
      static_cast<const T*>(feats), static_cast<const int*>(nbrs),
      static_cast<const uint8_t*>(mask), static_cast<const int*>(count),
      static_cast<const uint32_t*>(wpack), static_cast<const T*>(bias),
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
#define PCGC_CASE(ci_, co_)                                             \
  if (ci == ci_ && co == co_)                                           \
    return launch<T, ci_, co_, PCGC_BS>(feats, nbrs, mask, count, wpack, \
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
// [1] on the device; weight: the [3,3,3,ci,co] kernel packed in mma
// fragment order by ops/conv3.py::pack_weight; plan int32[3] on the host:
// (XP, ROWS, SMEM) of ops/conv3.py::tc_plan.  Returns 0, a cudaError_t of
// the launch, -1 for an instance it does not have, or -2 where `plan` is
// not the instance's.
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
