// Weight gradient of the 3^3 stride-1 sparse convolution over dense 16^3
// voxel blocks (sm_90a, CUDA cores, f32 accumulation), in bf16 and f32.
//
// conv3's backward has no Pallas original: the TPU kernel
// pcgcv2_tpu/ops/pallas_conv.py::conv3_pallas (:119) is forward only, and
// the JAX package trains through XLA's VJP of pcgcv2_tpu/ops/blocks.py::
// conv3 (:656).  This kernel replaces the weight half of that VJP.  It
// computes what ops/conv3.py::conv3_wgrad_plain computes:
//
//   dW[tap, a, b] = sum over rows i < count, occupied slots v of row i of
//                   halo_i[v + tap][a] * dy[i, v][b]          (in f32),
//
// halo_i the (16+2)^3 neighbourhood of block row i gathered through
// nbrs[i] (a miss reads the all-zero sentinel row), dy the output
// gradient, read only at occupied slots.  (The input gradient is the
// forward kernel, conv3_tc.cu, on the flipped, transposed weight.)
//
// What bounds it on this card: per occupied output voxel and tap it does
// 2*ci*co FLOP against ci + co gathered values, at most 2*64*64 / (128*2)
// = 32 FLOP per bf16 byte, so the dense work is small and a sparse grid
// (5-30% of the slots of a live block are occupied) makes it a gather.
// Design, simple first:
//   * pass 1: one CTA per (block row, tap).  It lists the occupied slots of
//     its row in shared memory (a block-wide scan of the mask, ascending),
//     then walks them in chunks: stages dy of the chunk's voxels and the
//     input voxel at the tap's shift (an address from nbrs, as in the
//     forward's halo) as f32 in shared memory, and accumulates the outer
//     products x^T dy in registers, each thread a TM x TN tile of the
//     [ci, co] result over every KSPLIT-th voxel.  The KSPLIT partial
//     tiles are summed in a fixed order and written to part[row, tap];
//   * pass 2: dW[e] = sum over rows < count of part[row, e], one column
//     per thread x, 8 row phases per column, summed in a fixed order.
//   Both passes are deterministic: no atomics, the same bits every run.
// Not yet: tensor cores (mma.sync / wgmma on a 64-voxel K), fusing the 27
// taps of a row into one CTA, a persistent reduction.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BS = 16;
constexpr int VOL = BS * BS * BS;
constexpr int HS = BS + 2;
constexpr int THREADS = 256;
constexpr int RED_Y = 8;  // row phases per column in pass 2

template <int CI, int CO>
struct WCfg {
  static constexpr int TM = CI < 4 ? CI : 4;  // thread tile along ci
  static constexpr int TN = CO < 4 ? CO : 4;  // thread tile along co
  static constexpr int PN = CO / TN;
  static constexpr int P = (CI / TM) * PN;    // threads per k-split group
  static constexpr int KSPLIT = THREADS / P;  // voxel phases
  static constexpr int CMAX = CI > CO ? CI : CO;
  static constexpr int CH = 4096 / CMAX > 128 ? 128 : 4096 / CMAX;
  static constexpr int STAGE = CH * (CI + CO);  // floats staged per chunk
  static constexpr int RED = KSPLIT * CI * CO;  // floats of the k-split sum
  static constexpr int BUF = STAGE > RED ? STAGE : RED;
  static_assert(P <= THREADS && THREADS % P == 0, "thread tiling");
};

// halo coordinate h in [0, 18) -> neighbour offset (0, 1, 2) and the cell
// it reads inside that neighbour block
__device__ __forceinline__ void halo_src(int h, int& nbr, int& cell) {
  nbr = h == 0 ? 0 : (h == HS - 1 ? 2 : 1);
  cell = h == 0 ? BS - 1 : (h == HS - 1 ? 0 : h - 1);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int CI, int CO>
__global__ void __launch_bounds__(THREADS)
    wgrad_partial_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                         const int* __restrict__ nbrs,
                         const uint8_t* __restrict__ mask,
                         const int* __restrict__ count,
                         float* __restrict__ part) {
  using C = WCfg<CI, CO>;
  __shared__ __align__(16) float buf[C::BUF];
  __shared__ uint16_t idx[VOL];
  __shared__ int rows[27];
  __shared__ int wsum[THREADS / 32];

  const int i = blockIdx.x, tap = blockIdx.y;
  if (i >= *count) return;  // the whole CTA: pass 2 reads rows < count
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int tx = tap / 9, ty = (tap / 3) % 3, tz = tap % 3;
  if (t < 27) rows[t] = nbrs[(size_t)i * 27 + t];

  // the occupied slots of row i, ascending: thread t scans slots 16t ..
  // 16t+15, a block-wide exclusive scan places them
  const uint4 m4 = reinterpret_cast<const uint4*>(mask + (size_t)i * VOL)[t];
  const uint32_t mw[4] = {m4.x, m4.y, m4.z, m4.w};
  int c = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) c += ((mw[k / 4] >> (8 * (k % 4))) & 0xffu) != 0;
  int incl = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  int pos = incl - c, nlive = 0;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) {
    pos += w < warp ? wsum[w] : 0;
    nlive += wsum[w];
  }
#pragma unroll
  for (int k = 0; k < 16; ++k)
    if ((mw[k / 4] >> (8 * (k % 4))) & 0xffu) idx[pos++] = 16 * t + k;
  __syncthreads();

  const int s = t / C::P, p = t % C::P;
  const int m0 = (p / C::PN) * C::TM, n0 = (p % C::PN) * C::TN;
  float acc[C::TM][C::TN];
#pragma unroll
  for (int a = 0; a < C::TM; ++a)
#pragma unroll
    for (int b = 0; b < C::TN; ++b) acc[a][b] = 0.f;

  float* xs = buf;               // [CH][CI]: x at the tap's shift
  float* gs = buf + C::CH * CI;  // [CH][CO]: dy
  for (int c0 = 0; c0 < nlive; c0 += C::CH) {
    const int n = min(C::CH, nlive - c0);
    for (int k = t; k < n * CO; k += THREADS) {
      const int v = idx[c0 + k / CO];
      gs[k] = to_f(dy[((size_t)i * VOL + v) * CO + k % CO]);
    }
    for (int k = t; k < n * CI; k += THREADS) {
      const int v = idx[c0 + k / CI];
      int nx, sx, ny, sy, nz, sz;
      halo_src((v >> 8) + tx, nx, sx);
      halo_src(((v >> 4) & 15) + ty, ny, sy);
      halo_src((v & 15) + tz, nz, sz);
      const size_t row = rows[nx * 9 + ny * 3 + nz];
      xs[k] = to_f(x[(row * VOL + (sx * BS + sy) * BS + sz) * CI + k % CI]);
    }
    __syncthreads();
    for (int k = s; k < n; k += C::KSPLIT) {
      float a[C::TM], b[C::TN];
#pragma unroll
      for (int q = 0; q < C::TM; ++q) a[q] = xs[k * CI + m0 + q];
#pragma unroll
      for (int q = 0; q < C::TN; ++q) b[q] = gs[k * CO + n0 + q];
#pragma unroll
      for (int q = 0; q < C::TM; ++q)
#pragma unroll
        for (int r = 0; r < C::TN; ++r) acc[q][r] = fmaf(a[q], b[r], acc[q][r]);
    }
    __syncthreads();  // the next chunk restages xs and gs
  }

  // sum the KSPLIT partial tiles in a fixed order
  float* red = buf;  // [KSPLIT][CI * CO]
#pragma unroll
  for (int a = 0; a < C::TM; ++a)
#pragma unroll
    for (int b = 0; b < C::TN; ++b)
      red[s * CI * CO + (m0 + a) * CO + n0 + b] = acc[a][b];
  __syncthreads();
  float* dst = part + ((size_t)i * 27 + tap) * CI * CO;
  for (int e = t; e < CI * CO; e += THREADS) {
    float sum = 0.f;
    for (int q = 0; q < C::KSPLIT; ++q) sum += red[q * CI * CO + e];
    dst[e] = sum;
  }
}

// out[e] = sum over rows r < count of part[r, e], e < n_e
__global__ void __launch_bounds__(32 * RED_Y)
    wgrad_reduce_kernel(const float* __restrict__ part,
                        const int* __restrict__ count, float* __restrict__ out,
                        int n_e) {
  __shared__ float red[RED_Y][33];
  const int e = blockIdx.x * 32 + threadIdx.x;
  const int n = *count;
  float s = 0.f;
  if (e < n_e) {
#pragma unroll 4
    for (int r = threadIdx.y; r < n; r += RED_Y) s += part[(size_t)r * n_e + e];
  }
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && e < n_e) {
    float sum = 0.f;
#pragma unroll
    for (int q = 0; q < RED_Y; ++q) sum += red[q][threadIdx.x];
    out[e] = sum;
  }
}

template <typename T, int CI, int CO>
int launch(const void* x, const void* dy, const void* nbrs, const void* mask,
           const void* count, void* part, void* out, int nb,
           cudaStream_t stream) {
  wgrad_partial_kernel<T, CI, CO><<<dim3(nb, 27), THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const int*>(nbrs), static_cast<const uint8_t*>(mask),
      static_cast<const int*>(count), static_cast<float*>(part));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_e = 27 * CI * CO;
  wgrad_reduce_kernel<<<(n_e + 31) / 32, dim3(32, RED_Y), 0, stream>>>(
      static_cast<const float*>(part), static_cast<const int*>(count),
      static_cast<float*>(out), n_e);
  return static_cast<int>(cudaGetLastError());
}

#define PCGC_ARGS x, dy, nbrs, mask, count, part, out, nb, s

template <typename T, int CI>
int by_co(const void* x, const void* dy, const void* nbrs, const void* mask,
          const void* count, void* part, void* out, int nb, cudaStream_t s,
          int co) {
  switch (co) {
    case 1: return launch<T, CI, 1>(PCGC_ARGS);
    case 4: return launch<T, CI, 4>(PCGC_ARGS);
    case 8: return launch<T, CI, 8>(PCGC_ARGS);
    case 16: return launch<T, CI, 16>(PCGC_ARGS);
    case 32: return launch<T, CI, 32>(PCGC_ARGS);
    case 64: return launch<T, CI, 64>(PCGC_ARGS);
    default: return -1;
  }
}

template <typename T>
int by_ci(const void* x, const void* dy, const void* nbrs, const void* mask,
          const void* count, void* part, void* out, int nb, cudaStream_t s,
          int ci, int co) {
  switch (ci) {
    case 1: return by_co<T, 1>(PCGC_ARGS, co);
    case 4: return by_co<T, 4>(PCGC_ARGS, co);
    case 8: return by_co<T, 8>(PCGC_ARGS, co);
    case 16: return by_co<T, 16>(PCGC_ARGS, co);
    case 32: return by_co<T, 32>(PCGC_ARGS, co);
    case 64: return by_co<T, 64>(PCGC_ARGS, co);
    default: return -1;
  }
}

#undef PCGC_ARGS

}  // namespace

// x [nb, 4096, ci] and dy [nb, 4096, co] in f32 (bf16 = 0) or bf16
// (bf16 = 1); nbrs int32 [nb, 27]; mask bool [nb, 4096] (16-byte
// aligned); count int32 [1] on the device; part f32 [nb, 27, ci, co]
// scratch; out f32 [27, ci, co].  Returns 0, a cudaError_t of a launch,
// or -1 for an instance it does not have.
extern "C" int pcgc_conv3_wgrad(const void* x, const void* dy,
                                const void* nbrs, const void* mask,
                                const void* count, void* part, void* out,
                                int nb, int ci, int co, int bf16,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return by_ci<__nv_bfloat16>(x, dy, nbrs, mask, count, part, out, nb, s,
                                ci, co);
  return by_ci<float>(x, dy, nbrs, mask, count, part, out, nb, s, ci, co);
}
