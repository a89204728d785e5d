// 3^3 stride-1 sparse convolution over dense BS^3 voxel blocks (BS = 16
// or 8, a template parameter) on the tensor cores (sm_90a), in bf16
// (mma.sync) and in f32 through split TF32 (wgmma or mma.sync, with the
// weights staged in shared memory by TMA).
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
// Design, both dtypes:
//   * implicit GEMM: M = output voxels, N = co, K = 27 taps x ci.  One m16
//     tile is 16 consecutive (y, z) voxels of an output x-plane: one y row
//     of 16 z at BS = 16, two y rows of 8 z at BS = 8 (TY = 16 / BS rows).
//     The im2col gather is only an address: each lane's ldmatrix row points
//     at the shifted halo voxel (y+dy, z+dz) of a staged input plane, lanes
//     0-7 and 8-15 at the two staged y rows of the tile where BS = 8;
//   * ci < 8 is zero-padded to 8 channels in shared memory, co < 8 to one
//     n8 tile (only the real columns are stored);
//   * each warp owns two m16 tiles, 32 output voxels of a plane (2 y rows
//     at BS = 16, 4 at BS = 8), and every output channel.  A CTA = one
//     live block row x XP output x-planes x ROWS output y rows: BS = 16,
//     XP = 4 of the 16 planes, ROWS = 16, or 8 where a ring of full planes
//     does not fit in shared memory (f32 at ci = 64: the y-halves restage
//     2 of their 10 halo rows each); BS = 8, the whole block;
//   * the input planes are gathered as (ROWS+2) x (BS+2) x ci tiles from
//     the neighbour rows of each plane with cp.async (16 bytes, or 8 or 4
//     for a narrower voxel; a 2-byte bf16 voxel is copied by plain loads;
//     misses read the zero sentinel row, no branch) into a ring of plane
//     buffers, the next step's planes in flight while a step's are read;
//   * staged voxel rows are padded by 16 bytes where the row is an even
//     number of 16-byte groups: the 8 rows of one ldmatrix phase then fall
//     on distinct bank groups;
//   * empty tiles are skipped exactly: the output is re-masked, so a CTA
//     whose tile holds no occupied slot only writes zeros, and a warp (a
//     warpgroup, on wgmma) whose output voxels are empty skips its MMAs.
// bf16 (Cfg, conv3_tc): one thread per (y, z) voxel of the CTA's rows, one
// output plane at a time over a ring of 4 planes (BS = 8: 2 warps, 8
// planes); mma.sync m16n8k16 (m16n8k8 for ci <= 8), its B fragments
// pre-packed in fragment order (ops/conv3.py::pack_weight) and read with
// one 4- or 8-byte __ldg per lane from L1/L2.
// f32 (CfgF, conv3_f32): 3xTF32.  Each operand x is split into hi =
// tf32(x) and lo = tf32(x - hi), and a_lo.b_hi + a_hi.b_lo + a_hi.b_hi is
// accumulated in f32, which keeps f32 accuracy (about 2^-22 relative per
// product).  ldmatrix of f32 rows yields the tf32 A fragment as it is; A is
// split in registers (tf32_rna), once per fragment for all three dy taps
// that read it; B comes pre-split.  What held the per-warp design back
// (measured by tests/torch_conv3_f32_diagnosis.py): the split, a third of
// the time at 16->4 where the cvt it used lowered to several instructions
// a value, and the B fragments that every warp streamed from L1/L2 for
// every output plane, 14-32% at phase 2's pairs.  So:
//   * the CTA is whole warpgroups of consumers plus one producer warp.  A
//     step is one (dx, dz) and KG k8 chunks; the packed f32 kernel is laid
//     out step by step as the shared-memory image the products read
//     (ops/conv3.py::pack_weight), and the producer copies it by 1-D bulk
//     copies (TMA, cp.async.bulk with an mbarrier's transaction count):
//     whole, once per CTA, where it fits beside the plane ring without
//     costing CTAs per SM, else step by step through a ring of NS slots
//     with full and empty mbarriers, which the consumers release as they
//     finish a step.  The weights cross L2 once per CTA or once per step
//     of output planes, not once per warp and plane;
//   * BS = 16: one output plane per step (1 or 2 warpgroups); BS = 8: two
//     planes per step (warps 0-1 and 2-3 of one warpgroup, a ring of 6
//     planes), so that a pass over the weights serves 128 output voxels at
//     either side;
//   * the products: where N = co padded >= 32, wgmma m64nNk8 tf32 with A
//     from registers (each warp's m16 fragment, mma.sync's tf32 order) and
//     B by descriptor from the staged slice (K-major 8 x 16-byte core
//     matrices, no swizzle), a chunk's 18 wgmmas one group, the next
//     chunk's fragments split while it runs; below 32, mma.sync m16n8k8,
//     its B read from the same slice by ldmatrix (four core matrices: hi
//     and lo, both k halves): a wgmma of N = 8 or 16 took longer than the
//     four mma.sync it replaces (both measured on the H100).
// ops/conv3.py::build compiles this file once per block side, with
// PCGC_BS and the (ci, co) pairs to instantiate (PCGC_PAIRS) defined, into
// one library; the entry point of each side is pcgc_conv3_tc_bs<BS>;
// ops/conv3.py::tc_plan mirrors both configs.
// Not yet: the bf16 instances on staged weights and wgmma, persistent CTAs.

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
  static constexpr int SZ = sizeof(T);
  static constexpr int CIP = CI < 8 ? 8 : CI;  // channels per staged voxel
  static constexpr int COP = CO < 8 ? 8 : CO;  // n8-padded output width
  // mma depth in elements: m16n8k16, m16n8k8 at ci <= 8
  static constexpr int KS = CIP >= 16 ? 16 : 8;
  static constexpr int KC = CIP / KS;  // k chunks per tap
  static constexpr int NT = COP / 8;   // n8 tiles
  // packed B words (bf16 pairs) per lane per (k chunk, n tile)
  static constexpr int FRAG = KS / 8;
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

__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* o) {
  *o = __float2bfloat16_rn(v);
}

// gather halo plane x0 + p (halo x coordinate, 0..BS+1), halo rows
// y_lo .. y_lo + HY - 1, of this CTA's block row into ring slot p % NB:
// HY x (BS+2) voxels from the neighbour rows rows[nx][ny][nz] of that
// plane, ci channels each
template <typename T, int CI, int RS, int HY, int THREADS, int BS,
          int NB = NBUF>
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
      tile_bf16<C>(acc, ring0, j, y0, wpack, lane);
    }

    // epilogue: this lane holds m16 rows m = g and g+8 of both tiles,
    // columns nt*8 + 2q, +1: round, add the bias in bf16, mask; columns >=
    // co are padding and not stored.
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
          r0 = round_bf16(r0);
          r1 = round_bf16(r1);
          if (bias != nullptr) {
            r0 = round_bf16(r0 + bv[nt][0]);
            r1 = round_bf16(r1 + bv[nt][1]);
          }
          if (!keep) r0 = r1 = 0.f;
          T* o = orow + m * CO + col;
          if constexpr (CO == 1) {
            from_f(r0, o);
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

// ---------------------------------------------------------------------------
// f32: 3xTF32 on wgmma or mma.sync, the weights staged in shared memory
// by TMA
// ---------------------------------------------------------------------------

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

// k8 chunks per step (kb weight bytes a chunk): the most of a tap's kc
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

// The f32 instances' tiling (ops/conv3.py::tc_plan mirrors it).  A step is
// one (dx, dz) and a group of k8 chunks of the 27-tap K loop: its weights
// are the 3 dy taps x (hi, lo) x KG K8 x COP slices, SB bytes, and a pass
// over the NSTEP steps covers the whole kernel.  16^3: one output plane per
// step (the CTA's 16 or 8 rows, 2 or 1 warpgroups).  8^3: two output
// planes per step, warps 0-1 on the first and 2-3 on the second, so that a
// CTA is one warpgroup and a pass of the weights serves 128 output voxels,
// as at 16^3; the plane ring then holds 6 planes (the step's 4 and the
// next step's 2).  One more warp, the producer, issues the weights' bulk
// copies.
template <int CI, int CO, int BS_>
struct CfgF {
  static_assert(BS_ == 16 || BS_ == 8, "block side");
  static constexpr int BS = BS_;
  static constexpr int VOL = BS * BS * BS;
  static constexpr int HS = BS + 2;
  static constexpr int TY = 16 / BS;           // y rows per m16 tile
  static constexpr int PS = BS == 16 ? 1 : 2;  // output planes per step
  static constexpr int XP = BS == 16 ? 4 : 8;  // output planes per CTA
  static constexpr int NB = 2 * PS + 2;        // ring of staged planes
  static constexpr int CIP = CI < 8 ? 8 : CI;
  static constexpr int COP = CO < 8 ? 8 : CO;  // the products' N
  static constexpr int KC = CIP / 8;  // tf32 k8 chunks per tap
  static constexpr int NT = COP / 8;  // n8 tiles
  static constexpr int RS = CIP + ((CIP / 4) % 2 == 0 ? 4 : 0);
  static constexpr int YS = NB * HS * HS * RS * 4 > SMEM_MAX ? 2 : 1;
  static constexpr int ROWS = BS / YS;  // output y rows per CTA
  static constexpr int HY = ROWS + 2;
  static constexpr int THREADS = PS * ROWS * BS;  // the consumer warps'
  static constexpr int NW = THREADS / 32;
  static_assert(NW % 4 == 0, "the consumers are whole warpgroups");
  static constexpr int CTA = THREADS + 32;    // and the producer warp
  static constexpr int WPL = ROWS * BS / 32;  // warps per output plane
  static constexpr int SLOT = HY * HS * RS;   // floats per plane buffer
  static constexpr int RING = NB * SLOT * 4;
  static constexpr int KB = 3 * 2 * 8 * COP * 4;  // weights of a k8 chunk
  static constexpr int WB = 27 * CIP * COP * 8;   // the packed kernel
  static constexpr int KEEP = tc_fit(RING, CTA) < 2 ? tc_fit(RING, CTA) : 2;
  // the whole kernel once per CTA where it fits without costing CTAs per
  // SM (up to 2); else a ring of NS one-step slots, refilled as they free
  static constexpr bool WHOLE =
      RING + WB + 8 <= SMEM_MAX && tc_fit(RING + WB + 8, CTA) >= KEEP;
  // a step: one (dx, dz) and KG of its KC k8 chunks, SB bytes of weights
  static constexpr int KG =
      WHOLE ? tc_kmax(KC, KB)
            : tc_kgroup(KC, KB, RING, CTA, KEEP, tc_kmax(KC, KB));
  static constexpr int NSTEP = 9 * KC / KG;
  static constexpr int SB = KG * KB;
  static constexpr int NS = WHOLE ? 1 : tc_slots(RING, SB, NSTEP, CTA, KEEP);
  // the products: wgmma m64nNk8 where N = COP >= 32; below, where a wgmma
  // takes longer than the four m16n8k8 mma.sync it replaces, mma.sync
  static constexpr bool WG = COP >= 32;
  static_assert(WHOLE || NS >= 2, "weight ring does not fit");
  static constexpr int WSM = WHOLE ? WB : NS * SB;
  static constexpr int NBAR = WHOLE ? 1 : 2 * NS;  // full[NS], empty[NS]
  static constexpr int SMEM = RING + WSM + 8 * NBAR;
  static_assert(SMEM <= SMEM_MAX, "shared memory");
  // CTAs per SM that shared memory admits; where that is 1 or 2 the
  // kernel asks for that many in __launch_bounds__ (as Cfg does).  A
  // wgmma instance asks for 1: below its registers ptxas serializes the
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

// wgmma m64nNk8 tf32, N = co padded: d (this warp's 16 of the warpgroup's
// 64 rows, per n8 tile in mma.sync's m16n8 accumulator order) += A (this
// warp's m16 x k8 fragment in registers, in mma.sync's tf32 order) x B
// (K8 x N in shared memory, descriptor b)
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 8][4],
                                           const uint32_t (&a)[4],
                                           uint64_t b);

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[4][4],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
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

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[8][4],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
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

// descriptor of a K8 x N tf32 B tile at shared address `addr`, K-major
// without swizzle: 8 x 16-byte core matrices (one n each row, 4 k), the two
// k halves 128 bytes apart (leading byte offset), n tiles 256 apart (stride
// byte offset); the fields in 16-byte units
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

// the split A fragments of one k8 chunk of a warp: the TY + 3 m16 x k8
// fragments that its two tiles read over the 3 dy taps (tile mt, tap dy:
// fragment mt TY + dy), each as TF32 hi and lo
template <typename C>
struct FragsF {
  uint32_t hi[C::TY + 3][4], lo[C::TY + 3][4];
};

// load and split the fragments of k8 chunk kc at dz of input plane pl
// (its shared address plus this lane's ldmatrix offset)
template <typename C>
__device__ __forceinline__ void load_frags(FragsF<C>& f, uint32_t pl, int y0,
                                           int dz, int kc) {
#pragma unroll
  for (int r = 0; r < C::TY + 3; ++r) {
    uint32_t a[4];
    ldsm_a<true>(pl + (((y0 + r) * C::HS + dz) * C::RS + kc * 8) * 4, a);
    split_tf32(a, f.hi[r], f.lo[r]);
  }
}

// issue the 18 wgmmas of one k8 chunk for the warpgroup (3 dy x the
// products lo.hi, hi.lo, hi.hi x 2 tiles) as one group; wb: shared address
// of the chunk's weights, whose (dy, part) slice is a K8 x COP tile
// (`wgmma_desc`)
template <typename C>
__device__ __forceinline__ void issue_chunk(float (&acc)[2][C::NT][4],
                                            const FragsF<C>& f, uint32_t wb) {
  wgmma_fence();  // the fragments were just written
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const uint64_t bh = wgmma_desc(wb + dy * 2 * C::COP * 32);
    const uint64_t bl = wgmma_desc(wb + (dy * 2 + 1) * C::COP * 32);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      wgmma_tf32<C::COP>(acc[mt], f.lo[mt * C::TY + dy], bh);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      wgmma_tf32<C::COP>(acc[mt], f.hi[mt * C::TY + dy], bl);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      wgmma_tf32<C::COP>(acc[mt], f.hi[mt * C::TY + dy], bh);
  }
  wgmma_commit();
}

// KG k8 chunks of a warpgroup's step on wgmma (input plane pl, chunks kc0
// ..): a chunk's products run while the next chunk's fragments are loaded
// and split into the other register set
template <typename C>
__device__ __forceinline__ void step_wgmma(float (&acc)[2][C::NT][4],
                                           uint32_t pl, int y0, int dz,
                                           int kc0, uint32_t wb) {
  FragsF<C> f[2];
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
    FragsF<C> f;
    load_frags<C>(f, pl, y0, dz, kc0 + kk);
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      // lanes 8m .. 8m + 7 address core matrix m = (part m / 2, k half
      // m % 2) of n tile nt: (hi k = q, hi q + 4, lo q, lo q + 4) of n = g
      uint32_t b[C::NT][4];
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt)
        ldsm_a<true>(
            wb + kk * C::KB + dy * 2 * C::COP * 32 + nt * 256 + b_lane,
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
          mma_tf32(acc[mt][nt], f.hi[mt * C::TY + dy], b[nt][2], b[nt][3]);
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          mma_tf32(acc[mt][nt], f.hi[mt * C::TY + dy], b[nt][0], b[nt][1]);
    }
  }
}

// Step k of a warp's tile (its two m16 tiles, output rows y0 .. y0 + 2TY
// - 1 of local output plane jl): (dx, dz) and KG k8 chunks.  ring0: shared
// address of ring slot 0 plus this lane's ldmatrix offset; wb: the step's
// weights.
template <typename C>
__device__ __forceinline__ void step_f32(float (&acc)[2][C::NT][4],
                                         uint32_t ring0, int jl, int y0,
                                         int k, uint32_t wb, uint32_t b_lane) {
  constexpr int NG = C::NSTEP / 9;  // k groups per (dx, dz)
  const int dx = k / (3 * NG), dz = k / NG % 3, kc0 = k % NG * C::KG;
  const uint32_t pl = ring0 + ((jl + dx) % C::NB) * C::SLOT * 4;
  if constexpr (C::WG)
    step_wgmma<C>(acc, pl, y0, dz, kc0, wb);
  else
    step_mma<C>(acc, pl, y0, dz, kc0, wb, b_lane);
}

// The CTA's weights: the whole packed kernel at shared address w, or a ring
// of NS one-step slots with full / empty mbarriers
template <typename C>
struct WeightsF {
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

template <int CI, int CO, int BS>
__device__ __forceinline__ void conv3_f32(const float* __restrict__ feats,
                                          const int* __restrict__ nbrs,
                                          const uint8_t* __restrict__ mask,
                                          const int* __restrict__ count,
                                          const float* wpack,
                                          const float* __restrict__ bias,
                                          float* __restrict__ out) {
  using C = CfgF<CI, CO, BS>;
  constexpr int VOL = C::VOL, XP = C::XP, PS = C::PS;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
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
    constexpr int N16 = C::ROWS * BS * CO * 4 / 16;  // per plane
    for (int k = t; k < XP * N16; k += C::CTA) {
      uint4* o = reinterpret_cast<uint4*>(
          out + ((size_t)i * VOL + ((x0 + k / N16) * BS + ybase) * BS) * CO);
      o[k % N16] = make_uint4(0, 0, 0, 0);
    }
    return;
  }
  if (t < 27) rows[t] = nbrs[(size_t)i * 27 + t];
  if constexpr (CI < C::CIP) {  // ci < 8: zero the padded voxels once
    for (int k = t; k < C::NB * C::HY * C::HS * 2; k += C::CTA)
      *reinterpret_cast<uint4*>(ring + (k / 2) * C::RS + (k % 2) * 4) =
          make_uint4(0, 0, 0, 0);
  }
  // the weights: shared bytes [RING, RING + WSM), then the mbarriers
  WeightsF<C> wt;
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
    stage<float, CI, C::RS, C::HY, C::THREADS, BS, C::NB>(feats, rows, ring,
                                                          x0, ybase, p, t);
    cp_async_commit();
  }

  const int g = lane >> 2, q = lane & 3;
  const int pw = warp / C::WPL;                // output plane within a step
  const int y0 = (warp % C::WPL) * 2 * C::TY;  // first local output row
  const int r16 = lane & 15;
  const uint32_t ring0 = smem_u32(ring) +
                         ((r16 / BS * C::HS + r16 % BS) * C::RS) * 4 +
                         (lane >> 4) * 16;
  const uint32_t b_lane =
      (lane >> 4) * C::COP * 32 + ((lane >> 3) & 1) * 128 + (lane & 7) * 16;
  float bv[C::NT][2];
#pragma unroll
  for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = nt * 8 + 2 * q + e;
      bv[nt][e] = (bias != nullptr && col < CO) ? bias[col] : 0.f;
    }

  for (int js = 0; js < XP / PS; ++js) {
    for (int p = js * PS + PS + 2; p < js * PS + 2 * PS + 2; ++p)
      if (p < XP + 2)
        stage<float, CI, C::RS, C::HY, C::THREADS, BS, C::NB>(
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
      if (live) step_f32<C>(acc, ring0, jl, y0, k, wb, b_lane);
      wt.release(js, k, lane);
    }

    // epilogue: this lane holds m16 rows m = g and g+8 of both tiles,
    // columns nt*8 + 2q, +1; add the bias, mask; columns >= co are padding
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      float* orow = out + (vbase + mt * 16) * CO;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = g + 8 * h;
        const bool keep = (bits >> (mt * 16 + m)) & 1u;
#pragma unroll
        for (int nt = 0; nt < C::NT; ++nt) {
          const int col = nt * 8 + 2 * q;
          if (col >= CO) continue;
          float r0 = acc[mt][nt][2 * h] + bv[nt][0];
          float r1 = acc[mt][nt][2 * h + 1] + bv[nt][1];
          if (!keep) r0 = r1 = 0.f;
          float* o = orow + m * CO + col;
          if constexpr (CO == 1)
            *o = r0;
          else
            *reinterpret_cast<float2*>(o) = make_float2(r0, r1);
        }
      }
    }
    consumer_sync<C::THREADS>();  // the step's oldest planes are restaged
  }
}

// The entry points: one with the plain thread bound, one that also asks
// for the config's MINB CTAs per SM (bf16: Cfg, f32: CfgF).
#define PCGC_PARAMS                                                        \
  const T *__restrict__ feats, const int *__restrict__ nbrs,              \
      const uint8_t *__restrict__ mask, const int *__restrict__ count,    \
      const uint32_t *__restrict__ wpack, const T *__restrict__ bias,     \
      T *__restrict__ out
#define PCGC_PARAMS_F32                                                    \
  const float *__restrict__ feats, const int *__restrict__ nbrs,          \
      const uint8_t *__restrict__ mask, const int *__restrict__ count,    \
      const float *wpack, const float *__restrict__ bias,                 \
      float *__restrict__ out

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

template <int CI, int CO, int BS>
__global__ void __launch_bounds__(CfgF<CI, CO, BS>::CTA)
    conv3_tc_kernel_f32(PCGC_PARAMS_F32) {
  conv3_f32<CI, CO, BS>(feats, nbrs, mask, count, wpack, bias, out);
}

template <int CI, int CO, int BS>
__global__ void __launch_bounds__(CfgF<CI, CO, BS>::CTA,
                                  CfgF<CI, CO, BS>::MINB)
    conv3_tc_kernel_f32_fit(PCGC_PARAMS_F32) {
  conv3_f32<CI, CO, BS>(feats, nbrs, mask, count, wpack, bias, out);
}

#undef PCGC_PARAMS
#undef PCGC_PARAMS_F32

template <int CI, int CO, int BS>
int launch_f32(const void* feats, const void* nbrs, const void* mask,
               const void* count, const void* wpack, const void* bias,
               void* out, int nb, const int* plan, cudaStream_t stream) {
  using C = CfgF<CI, CO, BS>;
  if (plan[0] != C::XP || plan[1] != C::ROWS || plan[2] != C::SMEM ||
      plan[3] != C::PS || plan[4] != C::NS)
    return -2;  // the wrapper's plan is not this instance's
  if (reinterpret_cast<uintptr_t>(wpack) % 16 != 0) return -3;  // bulk copy
  void (*kern)(const float*, const int*, const uint8_t*, const int*,
               const float*, const float*, float*);
  if constexpr (C::MINB > 0)
    kern = conv3_tc_kernel_f32_fit<CI, CO, BS>;
  else
    kern = conv3_tc_kernel_f32<CI, CO, BS>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(nb, BS / C::XP, C::YS);
  kern<<<grid, C::CTA, C::SMEM, stream>>>(
      static_cast<const float*>(feats), static_cast<const int*>(nbrs),
      static_cast<const uint8_t*>(mask), static_cast<const int*>(count),
      static_cast<const float*>(wpack), static_cast<const float*>(bias),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int CI, int CO, int BS>
int launch(const void* feats, const void* nbrs, const void* mask,
           const void* count, const void* wpack, const void* bias, void* out,
           int nb, const int* plan, cudaStream_t stream) {
  using C = Cfg<T, CI, CO, BS>;
  if (plan[0] != C::XP || plan[1] != C::ROWS || plan[2] != C::SMEM ||
      plan[3] != 1 || plan[4] != 0)
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
#define PCGC_CASE(ci_, co_)                                              \
  if (ci == ci_ && co == co_) {                                          \
    if constexpr (std::is_same<T, float>::value)                         \
      return launch_f32<ci_, co_, PCGC_BS>(feats, nbrs, mask, count,     \
                                           wpack, bias, out, nb, plan, s); \
    else                                                                 \
      return launch<T, ci_, co_, PCGC_BS>(feats, nbrs, mask, count,      \
                                          wpack, bias, out, nb, plan, s); \
  }
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
// fragment order (bf16) or as the shared-memory image of its steps (f32)
// by ops/conv3.py::pack_weight, 16-byte aligned; plan int32[5] on the
// host: (XP, ROWS, SMEM, PS, NS) of ops/conv3.py::tc_plan.  Returns 0, a
// cudaError_t of the launch, -1 for an instance it does not have, -2 where
// `plan` is not the instance's, -3 for a misaligned f32 weight.
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
