// 3^3 stride-1 sparse convolution over dense 16^3 voxel blocks (sm_90a).
//
// Replaces the TPU kernel pcgcv2_tpu/ops/pallas_conv.py::conv3_pallas
// (:119, body _kernel at :63).  For every block row i < count:
//
//   out[i, x, y, z, :] = sum_{dx,dy,dz in 0..2} halo_i[x+dx, y+dy, z+dz, :]
//                                                @ W[dx, dy, dz] + bias
//
// where halo_i is the 18^3-cell neighbourhood assembled from the 27
// neighbour rows nbrs[i, dx, dy, dz] (a miss points at the all-zero row
// nb-1), and the result is zeroed outside the occupancy mask, exactly as
// BlockGrid.with_feats does after the JAX conv.  Rows >= count are written
// as zeros without any arithmetic.
//
// What bounds it on this card: the dense-block formulation does
// 2*27*ci*co FLOP per slot against (ci+co)*4 bytes per slot, 13-120 FLOP
// per byte at the checkpoint's channel pairs, so all but the narrow-output
// convs (co = 1) are bound by arithmetic; this version runs it on the
// CUDA cores in f32 (bf16 inputs are widened when staged), with f32
// accumulation.  Design:
//   * one CTA per (block row, output x-plane), 256 threads = one thread per
//     (y, z) output voxel of the plane, holding all co accumulators in
//     registers;
//   * for each dx and each chunk of CIC input channels, the CTA gathers
//     the 18x18 input plane x = xo+dx-1 from the 9 neighbour rows of that
//     plane straight from global memory into shared memory (the gather
//     the TPU had to express as 27 slab DMAs), plus the matching 9 x CIC x
//     co weight slice;
//   * each staged input value feeds co FMAs, weights are read as float4
//     broadcasts, so shared-memory traffic stays below the FMA rate.
// The TPU version's banded z-fold weights and ci->16 lane padding are not
// carried over: they were lane-layout devices and only add zero FLOPs.
// Every call of the main path, f32 and bf16, runs on the tensor cores in
// conv3_tc.cu (ops/conv3.py::route); this kernel takes only a ci outside
// {1, 4, 8, 16, 32, 64} and stays as the comparison kernel that
// chip_smoke.py checks and times beside it.  It is written for 16^3 blocks
// only: under PCGC_BLOCK_SIZE=8 ops/conv3.py raises rather than launch it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BS = 16;
constexpr int VOL = BS * BS * BS;
constexpr int HS = BS + 2;
constexpr int PLANE = HS * HS;
constexpr int THREADS = BS * BS;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// halo coordinate h in [0, 18) -> neighbour offset (0, 1, 2) and the cell
// it reads inside that neighbour block
__device__ __forceinline__ void halo_src(int h, int& nbr, int& cell) {
  nbr = h == 0 ? 0 : (h == HS - 1 ? 2 : 1);
  cell = h == 0 ? BS - 1 : (h == HS - 1 ? 0 : h - 1);
}

template <typename T, int CO>
__device__ __forceinline__ void store_row(T* dst, const float* v) {
  if constexpr (std::is_same<T, float>::value && CO % 4 == 0) {
#pragma unroll
    for (int o = 0; o < CO; o += 4)
      *reinterpret_cast<float4*>(dst + o) =
          make_float4(v[o], v[o + 1], v[o + 2], v[o + 3]);
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value && CO % 2 == 0) {
#pragma unroll
    for (int o = 0; o < CO; o += 2)
      *reinterpret_cast<__nv_bfloat162*>(dst + o) =
          __floats2bfloat162_rn(v[o], v[o + 1]);
  } else {
#pragma unroll
    for (int o = 0; o < CO; ++o) dst[o] = from_f<T>(v[o]);
  }
}

template <typename T, int CO, int CIC>
__global__ void __launch_bounds__(THREADS)
conv3_kernel(const T* __restrict__ feats, const int* __restrict__ nbrs,
             const uint8_t* __restrict__ mask, const int* __restrict__ count,
             const T* __restrict__ weight, const T* __restrict__ bias,
             T* __restrict__ out, int ci) {
  __shared__ float plane[CIC * PLANE];
  __shared__ __align__(16) float wsm[9 * CIC * CO];
  __shared__ int rows[27];

  const int i = blockIdx.x;
  const int xo = blockIdx.y;
  const int t = threadIdx.x;
  const int y = t / BS, z = t % BS;
  const int v = (xo * BS + y) * BS + z;
  T* orow = out + ((size_t)i * VOL + v) * CO;

  float acc[CO];
#pragma unroll
  for (int o = 0; o < CO; ++o) acc[o] = 0.f;

  if (i >= *count) {  // invalid row: zeros, no arithmetic
    store_row<T, CO>(orow, acc);
    return;
  }
  if (t < 27) rows[t] = nbrs[(size_t)i * 27 + t];

  for (int dx = 0; dx < 3; ++dx) {
    int nx, sx;
    halo_src(xo + dx, nx, sx);
    for (int c0 = 0; c0 < ci; c0 += CIC) {
      __syncthreads();  // previous chunk consumed (and rows[] visible)
      for (int idx = t; idx < CIC * PLANE; idx += THREADS) {
        const int c = idx % CIC, r = idx / CIC;
        int ny, sy, nz, sz;
        halo_src(r / HS, ny, sy);
        halo_src(r % HS, nz, sz);
        const size_t row = rows[nx * 9 + ny * 3 + nz];
        plane[c * PLANE + r] = to_f(
            feats[(row * VOL + (sx * BS + sy) * BS + sz) * ci + c0 + c]);
      }
      for (int idx = t; idx < 9 * CIC * CO; idx += THREADS) {
        const int o = idx % CO, r = idx / CO;
        const int c = r % CIC, k = r / CIC;
        wsm[idx] =
            to_f(weight[((size_t)(dx * 9 + k) * ci + c0 + c) * CO + o]);
      }
      __syncthreads();
#pragma unroll 1
      for (int k = 0; k < 9; ++k) {
        const float* p = plane + (y + k / 3) * HS + z + k % 3;
        const float* wk = wsm + k * CIC * CO;
#pragma unroll
        for (int c = 0; c < CIC; ++c) {
          const float a = p[c * PLANE];
          const float* w = wk + c * CO;
          if constexpr (CO % 4 == 0) {
#pragma unroll
            for (int o = 0; o < CO; o += 4) {
              const float4 wv = *reinterpret_cast<const float4*>(w + o);
              acc[o] = fmaf(a, wv.x, acc[o]);
              acc[o + 1] = fmaf(a, wv.y, acc[o + 1]);
              acc[o + 2] = fmaf(a, wv.z, acc[o + 2]);
              acc[o + 3] = fmaf(a, wv.w, acc[o + 3]);
            }
          } else {
#pragma unroll
            for (int o = 0; o < CO; ++o) acc[o] = fmaf(a, w[o], acc[o]);
          }
        }
      }
    }
  }

  // epilogue: round to T, add the bias in T (the JAX bf16 semantics:
  // conv output stored in bf16, bias added in bf16), mask.
  const bool keep = mask[(size_t)i * VOL + v] != 0;
#pragma unroll
  for (int o = 0; o < CO; ++o) {
    float r = to_f(from_f<T>(acc[o]));
    if (bias != nullptr) r = to_f(from_f<T>(r + to_f(bias[o])));
    acc[o] = keep ? r : 0.f;
  }
  store_row<T, CO>(orow, acc);
}

template <typename T, int CO, int CIC>
int launch(const void* feats, const void* nbrs, const void* mask,
           const void* count, const void* weight, const void* bias,
           void* out, int nb, int ci, cudaStream_t stream) {
  const dim3 grid(nb, BS);
  conv3_kernel<T, CO, CIC><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(feats), static_cast<const int*>(nbrs),
      static_cast<const uint8_t*>(mask), static_cast<const int*>(count),
      static_cast<const T*>(weight), static_cast<const T*>(bias),
      static_cast<T*>(out), ci);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int CO>
int by_ci(const void* feats, const void* nbrs, const void* mask,
          const void* count, const void* weight, const void* bias, void* out,
          int nb, int ci, cudaStream_t stream) {
  if (ci % 8 == 0)
    return launch<T, CO, 8>(feats, nbrs, mask, count, weight, bias, out, nb,
                            ci, stream);
  if (ci % 4 == 0)
    return launch<T, CO, 4>(feats, nbrs, mask, count, weight, bias, out, nb,
                            ci, stream);
  return launch<T, CO, 1>(feats, nbrs, mask, count, weight, bias, out, nb,
                          ci, stream);
}

template <typename T>
int by_co(const void* feats, const void* nbrs, const void* mask,
          const void* count, const void* weight, const void* bias, void* out,
          int nb, int ci, int co, cudaStream_t stream) {
  switch (co) {
    case 1:
      return by_ci<T, 1>(feats, nbrs, mask, count, weight, bias, out, nb, ci,
                         stream);
    case 4:
      return by_ci<T, 4>(feats, nbrs, mask, count, weight, bias, out, nb, ci,
                         stream);
    case 8:
      return by_ci<T, 8>(feats, nbrs, mask, count, weight, bias, out, nb, ci,
                         stream);
    case 16:
      return by_ci<T, 16>(feats, nbrs, mask, count, weight, bias, out, nb,
                          ci, stream);
    case 32:
      return by_ci<T, 32>(feats, nbrs, mask, count, weight, bias, out, nb,
                          ci, stream);
    case 64:
      return by_ci<T, 64>(feats, nbrs, mask, count, weight, bias, out, nb,
                          ci, stream);
    default:
      return -1;
  }
}

}  // namespace

// feats [nb, 4096, ci] and weight [3,3,3,ci,co], bias [co] (or null) and
// out [nb, 4096, co] in f32 (bf16 = 0) or bf16 (bf16 = 1); nbrs int32
// [nb, 27]; mask bool [nb, 4096]; count int32 [1] on the device.
// Returns 0, a cudaError_t of the launch, or -1 for an unsupported co.
extern "C" int pcgc_conv3(const void* feats, const void* nbrs,
                          const void* mask, const void* count,
                          const void* weight, const void* bias, void* out,
                          int nb, int ci, int co, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return by_co<__nv_bfloat16>(feats, nbrs, mask, count, weight, bias, out,
                                nb, ci, co, s);
  return by_co<float>(feats, nbrs, mask, count, weight, bias, out, nb, ci,
                      co, s);
}
