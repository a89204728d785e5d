// 3^3 stride-1 sparse convolution over dense 16^3 voxel blocks on the
// tensor cores, bf16 in, f32 accumulation (sm_90a, mma.sync).
//
// Replaces the TPU kernel pcgcv2_tpu/ops/pallas_conv.py::conv3_pallas
// (:119, body _kernel at :63) for bf16 calls with ci, co in {4..64};
// conv3.cu keeps f32 and the ci = 1 / co = 1 convs.  It computes what
// ops/conv3.py::conv3_plain computes in bf16:
//
//   out[i, v, :] = mask[i, v] ? bf16(bf16(sum_27 taps halo_i[v+tap] @ W[tap])
//                                    + bias) : 0,     rows i >= count: 0.
//
// What bounds it on this card: the dense block form does 2*27*ci*co FLOP
// per slot against (ci+co)*2 bytes, 27-860 FLOP per byte at the
// checkpoint's pairs, so the wide convs are bound by arithmetic, which
// the CUDA cores (conv3.cu) run at 1/15 of the bf16 tensor-core rate.
// Design:
//   * implicit GEMM: M = output voxels (one m16 tile = one (x, y) row of 16
//     z), N = co, K = 27 taps x ci.  The im2col gather is only an address:
//     each lane's ldmatrix row points at the shifted halo voxel
//     (y+dy, z+dz) of a staged input plane.  mma.sync m16n8k16 (m16n8k8 for
//     ci <= 8; ci = 4 is zero-padded to 8 in shared memory, co = 4 to n8);
//   * one CTA = one live block row x XP = 4 output x-planes, 8 warps, warp w
//     owns the rows y = 2w, 2w+1 and every output channel;
//   * the XP+2 input planes it needs are gathered as 18x18xci tiles from
//     the 9 neighbour rows of each plane with 16-byte cp.async (misses read
//     the zero sentinel row, no branch) into a ring of 4 plane buffers, so
//     plane x+3 is in flight while plane x is consumed;
//   * staged voxel rows are padded by 16 bytes (ci >= 16): the 8 rows of
//     one ldmatrix phase then fall on distinct bank groups;
//   * B fragments come pre-packed in mma fragment order (ops/conv3.py::
//     pack_weight, packed once per layer) and are read with one 8-byte
//     __ldg per lane from L1/L2;
//   * empty tiles are skipped exactly: the output is re-masked, so a CTA
//     whose 4 planes hold no occupied slot only writes zeros, and a warp
//     whose 32 output voxels are empty skips its MMAs.
// Not yet: wgmma, TMA, warp specialisation, persistent CTAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BS = 16;
constexpr int VOL = BS * BS * BS;
constexpr int HS = BS + 2;
constexpr int PLANE = HS * HS;  // halo voxels per staged x-plane
constexpr int THREADS = 256;    // 8 warps x 2 output rows of 16 voxels
constexpr int XP = 4;           // output x-planes per CTA
constexpr int NBUF = 4;         // ring of staged input planes

template <int CI, int CO>
struct Cfg {
  static constexpr int CIP = CI < 8 ? 8 : CI;    // channels per staged voxel
  static constexpr int COP = CO < 8 ? 8 : CO;    // n8-padded output width
  static constexpr int KS = CIP >= 16 ? 16 : 8;  // mma depth
  static constexpr int KC = CIP / KS;            // k chunks per tap
  static constexpr int NT = COP / 8;             // n8 tiles
  static constexpr int FRAG = KS / 8;            // B registers per lane
  // staged voxel stride in elements: +16 B keeps ldmatrix conflict-free
  static constexpr int RS = CIP >= 16 ? CIP + 8 : CIP;
  static constexpr int SLOT = PLANE * RS;  // elements per plane buffer
  static constexpr int SMEM = NBUF * SLOT * 2;
};

// halo coordinate h in [0, 18) -> neighbour offset (0, 1, 2) and the cell
// it reads inside that neighbour block
__device__ __forceinline__ void halo_src(int h, int& nbr, int& cell) {
  nbr = h == 0 ? 0 : (h == HS - 1 ? 2 : 1);
  cell = h == 0 ? BS - 1 : (h == HS - 1 ? 0 : h - 1);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A fragment of one m16 x k16 (x4) or m16 x k8 (x2) tile
template <int KS>
__device__ __forceinline__ void ldsm_a(uint32_t addr, uint32_t (&a)[4]) {
  if constexpr (KS == 16) {
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
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint2 b) {
  if constexpr (KS == 16) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(b.x));
  }
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// gather halo plane x0 + p (halo x coordinate, 0..17) of this CTA's block
// row into ring slot p % NBUF: 18x18 voxels from the 9 neighbour rows
// rows[nx][ny][nz] of that plane, ci channels each, by cp.async
template <int CI, int RS>
__device__ __forceinline__ void stage(const __nv_bfloat16* __restrict__ feats,
                                      const int* rows, __nv_bfloat16* ring,
                                      int x0, int p, int t) {
  int nx, sx;
  halo_src(x0 + p, nx, sx);
  const uint32_t base = smem_u32(ring + (p % NBUF) * PLANE * RS);
  constexpr int CH = CI >= 8 ? CI / 8 : 1;  // 16-B pieces (8-B at ci = 4)
  for (int k = t; k < PLANE * CH; k += THREADS) {
    const int r = k / CH, c = k % CH;
    int ny, sy, nz, sz;
    halo_src(r / HS, ny, sy);
    halo_src(r % HS, nz, sz);
    const size_t row = rows[nx * 9 + ny * 3 + nz];
    const __nv_bfloat16* src =
        feats + (row * VOL + (sx * BS + sy) * BS + sz) * CI + c * 8;
    const uint32_t dst = base + (r * RS + c * 8) * 2;
    if constexpr (CI >= 8)
      cp_async16(dst, src);
    else
      cp_async8(dst, src);
  }
}

template <int CI, int CO>
__global__ void __launch_bounds__(THREADS)
conv3_tc_kernel(const __nv_bfloat16* __restrict__ feats,
                const int* __restrict__ nbrs,
                const uint8_t* __restrict__ mask,
                const int* __restrict__ count,
                const uint32_t* __restrict__ wpack,
                const __nv_bfloat16* __restrict__ bias,
                __nv_bfloat16* __restrict__ out) {
  using C = Cfg<CI, CO>;
  extern __shared__ __align__(16) __nv_bfloat16 ring[];
  __shared__ int rows[27];

  const int i = blockIdx.x;
  const int x0 = blockIdx.y * XP;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  // a row >= count or a slab without an occupied slot: zeros, nothing else
  const uint32_t m4 = reinterpret_cast<const uint32_t*>(
      mask + (size_t)i * VOL + x0 * BS * BS)[t];
  const int any = __syncthreads_or(m4 != 0u);
  if (i >= *count || !any) {
    constexpr int N16 = XP * BS * BS * CO * 2 / 16;
    uint4* o = reinterpret_cast<uint4*>(out + ((size_t)i * VOL + x0 * BS * BS) *
                                                  CO);
    for (int k = t; k < N16; k += THREADS) o[k] = make_uint4(0, 0, 0, 0);
    return;
  }
  if (t < 27) rows[t] = nbrs[(size_t)i * 27 + t];
  if constexpr (CI < C::CIP) {  // ci = 4: zero the pad channels 4..7 once
    for (int k = t; k < NBUF * PLANE; k += THREADS)
      *reinterpret_cast<uint2*>(ring + k * C::RS + CI) = make_uint2(0, 0);
  }
  __syncthreads();

  for (int p = 0; p < 3; ++p) {
    stage<CI, C::RS>(feats, rows, ring, x0, p, t);
    cp_async_commit();
  }

  const int g = lane >> 2, q = lane & 3;
  const int y0 = 2 * warp;
  // this lane's ldmatrix row (z = lane % 16) and k half inside a plane
  const uint32_t a_lane =
      ((lane & 15) * C::RS + (C::KS == 16 ? (lane >> 4) * 8 : 0)) * 2;
  float bv[C::NT][2];
#pragma unroll
  for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = nt * 8 + 2 * q + e;
      bv[nt][e] =
          (bias != nullptr && col < CO) ? __bfloat162float(bias[col]) : 0.f;
    }

  for (int j = 0; j < XP; ++j) {
    if (j + 3 < XP + 2) stage<CI, C::RS>(feats, rows, ring, x0, j + 3, t);
    cp_async_commit();
    cp_async_wait<1>();  // planes j .. j+2 have landed (this thread's part)
    __syncthreads();     // ... and everyone's

    const int xo = x0 + j;
    const uint32_t bits = __ballot_sync(
        0xffffffffu, mask[(size_t)i * VOL + (xo * BS + y0) * BS + lane] != 0);
    float acc[2][C::NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

    if (bits != 0u) {  // warp tile with an occupied slot
#pragma unroll 1
      for (int dx = 0; dx < 3; ++dx) {
        const uint32_t pl =
            smem_u32(ring + ((j + dx) % NBUF) * C::SLOT) + a_lane;
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
              ldsm_a<C::KS>(
                  pl + (((y0 + mt + dy) * HS + dz) * C::RS + kc * C::KS) * 2,
                  a[mt]);
#pragma unroll
            for (int nt = 0; nt < C::NT; ++nt) {
              const uint32_t* w = wt + (kc * C::NT + nt) * 32 * C::FRAG;
              uint2 b;
              if constexpr (C::FRAG == 2)
                b = __ldg(reinterpret_cast<const uint2*>(w));
              else
                b = make_uint2(__ldg(w), 0u);
              mma<C::KS>(acc[0][nt], a[0], b);
              mma<C::KS>(acc[1][nt], a[1], b);
            }
          }
        }
      }
    }

    // epilogue: this lane holds z = g and g+8 of rows y0, y0+1, columns
    // nt*8 + 2q, +1.  Round to bf16, add the bias in bf16, mask.
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      __nv_bfloat16* orow =
          out + ((size_t)i * VOL + (xo * BS + y0 + mt) * BS) * CO;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int z = g + 8 * h;
        const bool keep = (bits >> (mt * 16 + z)) & 1u;
#pragma unroll
        for (int nt = 0; nt < C::NT; ++nt) {
          const int col = nt * 8 + 2 * q;
          if (col < CO) {
            float r0 = round_bf16(acc[mt][nt][2 * h]);
            float r1 = round_bf16(acc[mt][nt][2 * h + 1]);
            if (bias != nullptr) {
              r0 = round_bf16(r0 + bv[nt][0]);
              r1 = round_bf16(r1 + bv[nt][1]);
            }
            *reinterpret_cast<__nv_bfloat162*>(orow + z * CO + col) =
                keep ? __floats2bfloat162_rn(r0, r1)
                     : __floats2bfloat162_rn(0.f, 0.f);
          }
        }
      }
    }
    __syncthreads();  // slot j % NBUF is restaged by the next iteration
  }
}

template <int CI, int CO>
int launch(const void* feats, const void* nbrs, const void* mask,
           const void* count, const void* wpack, const void* bias, void* out,
           int nb, cudaStream_t stream) {
  using C = Cfg<CI, CO>;
  auto kern = conv3_tc_kernel<CI, CO>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(nb, BS / XP);
  kern<<<grid, THREADS, C::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(feats), static_cast<const int*>(nbrs),
      static_cast<const uint8_t*>(mask), static_cast<const int*>(count),
      static_cast<const uint32_t*>(wpack),
      static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <int CI>
int by_co(const void* feats, const void* nbrs, const void* mask,
          const void* count, const void* wpack, const void* bias, void* out,
          int nb, int co, cudaStream_t s) {
  switch (co) {
    case 4:
      return launch<CI, 4>(feats, nbrs, mask, count, wpack, bias, out, nb, s);
    case 8:
      return launch<CI, 8>(feats, nbrs, mask, count, wpack, bias, out, nb, s);
    case 16:
      return launch<CI, 16>(feats, nbrs, mask, count, wpack, bias, out, nb, s);
    case 32:
      return launch<CI, 32>(feats, nbrs, mask, count, wpack, bias, out, nb, s);
    case 64:
      return launch<CI, 64>(feats, nbrs, mask, count, wpack, bias, out, nb, s);
    default:
      return -1;
  }
}

}  // namespace

// feats [nb, 4096, ci] bf16; nbrs int32 [nb, 27]; mask bool [nb, 4096]
// (4-byte aligned); count int32 [1] on the device; weight: the [3,3,3,ci,co]
// kernel packed in mma fragment order by ops/conv3.py::pack_weight; bias
// [co] bf16 (or null); out [nb, 4096, co] bf16.  bf16 must be 1 (the
// tensor-core route has no f32 instance).  Returns 0, a cudaError_t of the
// launch, or -1 for an instance it does not have.
extern "C" int pcgc_conv3_tc(const void* feats, const void* nbrs,
                             const void* mask, const void* count,
                             const void* weight, const void* bias, void* out,
                             int nb, int ci, int co, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bf16) return -1;
  switch (ci) {
    case 4:
      return by_co<4>(feats, nbrs, mask, count, weight, bias, out, nb, co, s);
    case 8:
      return by_co<8>(feats, nbrs, mask, count, weight, bias, out, nb, co, s);
    case 16:
      return by_co<16>(feats, nbrs, mask, count, weight, bias, out, nb, co, s);
    case 32:
      return by_co<32>(feats, nbrs, mask, count, weight, bias, out, nb, co, s);
    case 64:
      return by_co<64>(feats, nbrs, mask, count, weight, bias, out, nb, co, s);
    default:
      return -1;
  }
}
