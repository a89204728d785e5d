// Weight gradient of the 3^3 stride-1 sparse convolution over dense BS^3
// voxel blocks (BS = 16 or 8, a template parameter; sm_90a, f32
// accumulation) on the tensor cores: bf16 dy on mma.sync m16n8k16, f32 dy
// in 3xTF32 on mma.sync m16n8k8; ci below 8 on the CUDA cores.
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
// halo_i the (BS+2)^3 neighbourhood of block row i gathered through
// nbrs[i] (a miss reads the all-zero sentinel row), dy the output
// gradient, read only at occupied slots.  Under bf16 compute dy comes in
// bf16 and x, read as the grid stores it, is rounded to bf16 as it is
// staged: the rounding conv3_wgrad_plain does.  (The input gradient is
// the forward kernel, conv3_tc.cu, on the flipped, transposed weight.)
//
// What bounds it on this card: per occupied output voxel and tap it does
// 2*ci*co FLOP against ci + co values, so the dense work is small and a
// sparse grid (5-30% of the slots of a live block are occupied) makes it a
// gather: every input voxel is read by up to 27 output voxels, every dy
// value by 27 taps.  The design reads each from device memory once per
// row and split, and keeps the 27-fold reuse in shared memory:
//   * G persistent CTAs per split (G a constant of the plan, not of the
//     card, so the order of summation is the same on any card) walk the
//     work items below *count (read on the device: no host sync) and keep
//     their sums in registers.  An item is a live row, or a chunk of
//     BS/2, ..., 2 or 1 of its BS output x-planes where the rows are too
//     few to give every CTA one (`work_items`);
//   * every CTA computes all 27 taps of a ci tile x co tile (a split),
//     chosen per (ci, co, x dtype, dy dtype) by `make_plan` (the wrapper's
//     ops/conv3.py::wgrad_plan mirrors it and the launch refuses another
//     plan) so that each thread holds at most ACC_MAX accumulators and the
//     staging fits in shared memory;
//   * per item, a block-wide scan of the row's BS^3 mask bytes lists its
//     occupied slots in ascending order, grouped by x-plane
//     (`list_slots`).  A plane no occupied output plane reads is not
//     staged, an empty output plane is not computed; at the end a second
//     kernel sums the partials of the CTAs that had an item in a fixed
//     order.  No atomics: the same bits every run.
// bf16 dy (`wgrad_mma_kernel`): dW[tap] = X^T dY is a product with the
// listed voxels as K, on mma.sync m16n8k16 (f32 accumulation).  Input
// planes land in shared memory as bf16 ((BS+2)^2 voxels of max(ci tile, 8)
// channels; an f32 x is rounded on its way through the registers, a bf16 x
// copied by cp.async) and dy at the listed slots as bf16 rows; both are
// XOR-swizzled by 16-byte chunk so that the 8 rows of an ldmatrix phase
// over consecutive voxels fall in distinct banks.  Each warp owns fixed
// (tap, m16 tile of ci) units with every n8 tile of co; per chunk of 16
// listed voxels it loads dY once by ldmatrix.trans and, per unit, X^T by
// ldmatrix.trans with each lane's row address the staged voxel v + tap of
// its own list entry: the im2col gather is an address.  Lanes past the
// list read a zero chunk.  A co tile below 8 pads to 8 channels (ci 8
// fills half an m16 tile): the padded rows and columns are never stored.
// ci below 8 stays on the CUDA cores (MMA_MIN_CI).  At BS = 16 the
// planes go through a ring, one output plane a step (a K chunk stays in
// one plane), an f32 x's next plane loaded into registers before a step's
// products and stored after them; at BS = 8 an item's whole halo is staged at once (10^3 x 16
// channels x 2 B = 32 KB) and its K chunks run across its planes, one
// barrier per item.  The accumulators stay in registers across items and
// each is stored once, by its lane.
// f32 dy (the same kernel, `tf32_chunks`): 3xTF32, a_lo.b_hi + a_hi.b_lo
// + a_hi.b_hi on mma.sync m16n8k8 with the listed voxels as K in chunks of
// 8, each operand split into tf32 hi and lo in the registers (`tf32_rna`;
// dY once per chunk for all of a warp's units; a bf16 x is exact in tf32
// and has no lo, so two products), each chunk's products added to the f32
// sums (the tensor cores' own accumulation truncates).  ldmatrix .trans
// moves b16 only and the tf32 A fragment holds K at lane % 4, so X is read
// by plain shared loads: x is staged by cp.async in its own dtype as
// 32-byte rows in sub-planes, dy as f32 rows, so that 4 consecutive voxels
// or dy rows fall in distinct banks and a voxel's address is its staged
// row plus a constant per unit.  An m16 tile is 16 rows of the (tap, ci)
// space (a ci tile of 8 packs two taps into one); lane 4g + q holds
// fragment rows g and g + 8 as rows 2g and 2g + 1 (the store undoes it),
// adjacent channels of one voxel v + tap that one 64-bit load gives (32
// bits for bf16 pairs).  Lanes past the list read its last entry against
// zero dy rows.  The staging and the steps are the bf16 instances': a ring
// of planes at 16^3 (cp.async keeps the next plane in flight during a
// plane's products), the whole halo at 8^3.
// ci below 8, either dy, and f32 dy at co below 16
// (`wgrad_partial_kernel`; under bf16 an f32 x rounded by a pass over each
// staged plane): every thread owns a TM x TN
// tile of one tap's [ci, co] block and walks every KSPLIT-th listed voxel
// over f32 planes staged by cp.async (y rows padded by 16 bytes), f32 FMAs;
// the KSPLIT partial tiles are summed in a fixed order at the end.
// ops/conv3.py::build compiles this file once per block side, with
// PCGC_BS and the (ci, co) pairs to instantiate (PCGC_PAIRS) defined, into
// one library; the entry point of each side is pcgc_conv3_wgrad_bs<BS>.
// Measured on the H100: PERF.md (the conv3_wgrad rows, and how the bf16
// and f32 redesigns moved them).  Not yet: overlap of one item's staging
// with the previous item's products; staging only the voxels an occupied
// output reads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#ifndef PCGC_BS
#define PCGC_BS 16
#endif

namespace {

constexpr int THREADS = 256;            // BS^3 / 256 mask bytes each
constexpr int WARPS = THREADS / 32;
constexpr int ACC_MAX = 64;             // accumulators per thread
constexpr int GRID_CTAS = 512;          // G x splits, about
constexpr int SMEM_MAX = 232448 - 9216;  // dynamic smem, beside idx[]
                                         // (4096 slots at BS = 16)
// the mma.sync instances keep two CTAs on an SM
constexpr int SMEM_MMA = 232448 / 2 - 9216 - 1024;
constexpr int RED_Y = 8;                // row phases per column in pass 2
constexpr int AHEAD = 1;                // planes staged ahead of their use
constexpr int NBUF = 3 + AHEAD;         // ring of staged input planes
constexpr int DYBUF = 1 + AHEAD;        // ring of staged dy planes
// bf16 dy with ci >= MMA_MIN_CI runs on mma.sync (a co below 8 padded to
// 8: 16 -> 4 and the -> 1 heads); ci below it (1 -> 16, 4 -> 4, 4 -> 8)
// on the CUDA cores, which were faster there at both block sides (an m16
// tile of ci 4 is three quarters padding; measured, PERF.md)
constexpr int MMA_MIN_CI = 8;
// f32 dy runs 3xTF32 on mma.sync m16n8k8 at ci >= MMA_MIN_CI and co >=
// MMA_MIN_CO_F32; the narrower co (16 -> 4, 32 -> 8 and the -> 1 heads,
// 8 -> 8) on the CUDA cores, which were faster there at both block sides:
// an n8 tile of co 4 is half padding and the split into hi and lo costs
// the same at any co (measured, PERF.md)
constexpr int MMA_MIN_CO_F32 = 16;

// The plan of one (ci, co, x and dy element sizes, block side) instance;
// ops/conv3.py::wgrad_plan computes the same and the launch checks that
// they agree.
struct Plan {
  int cit, cot;   // ci and co tiles of a split
  int tm, tn;     // a thread's accumulator tile (CUDA cores)
  int p, ksplit;  // thread tiles per CTA, voxel phases (CUDA cores)
  int splits, g;  // splits, persistent CTAs per split
  int smem;       // dynamic smem bytes
  int mma;        // 1: the products on mma.sync m16n8k16, 0: CUDA cores
};

constexpr int pow2_ceil(int v) {
  int p = 1;
  while (p < v) p *= 2;
  return p;
}

constexpr int imax(int a, int b) { return a > b ? a : b; }
constexpr int imin(int a, int b) { return a < b ? a : b; }

constexpr Plan plan_for(int ci, int co, int sx, int sg, int bs, int cit,
                        int cot) {
  const int e = 27 * cit * cot;
  const int f = imax(pow2_ceil((e + THREADS - 1) / THREADS),
                     imin(16, cit * cot));
  const int side = f >= 64 ? 8 : (f >= 16 ? 4 : (f >= 4 ? 2 : 1));
  int tm = imin(cit, side), tn = f / tm;
  if (tn > cot) {
    tn = cot;
    tm = f / cot;
  }
  const int p = e / f, ksplit = THREADS / p;
  const int splits = (ci / cit) * (co / cot);
  // staged y rows are padded by 16 bytes (bank conflicts of the dy taps);
  // a dy buffer holds the bs^2 slots of one plane
  const int hs = bs + 2;
  const int ring = NBUF * hs * (hs * cit * sx + 16);
  const int smem = imax(ring + DYBUF * bs * bs * cot * sg,
                        ksplit * e * 4);
  return Plan{cit, cot, tm, tn, p, ksplit, splits,
              imax(8, GRID_CTAS / splits), smem, 0};
}

// mma.sync: channels padded to 8 (an m16 tile of ci = 8 takes its upper
// half as zeros), a warp's units are (tap, m16 tile) pairs, each with
// every n8 tile of the co tile; staged planes and dy rows hold bf16.  At
// BS = 16 a ring of NBUF planes and DYBUF dy planes, as the CUDA cores
// stage; at BS = 8 an item's whole halo (BS + 2 planes) and the dy of all
// its slots.
constexpr int mma_units(int cit) { return 27 * ((imax(cit, 8) + 15) / 16); }
constexpr int mma_acc(int cit, int cot) {
  return (mma_units(cit) + WARPS - 1) / WARPS * (imax(cot, 8) / 8) * 4;
}
constexpr int mma_smem(int bs, int cit, int cot) {
  const int hs = bs + 2, cip = imax(cit, 8), cop = imax(cot, 8);
  return bs == 8 ? hs * hs * hs * cip * 2 + bs * bs * bs * cop * 2
                 : NBUF * hs * hs * cip * 2 + DYBUF * bs * bs * cop * 2;
}

// 3xTF32 (f32 dy): an m16 tile is 16 rows of the (tap, ci) space, row R
// = tap * cit + c, so a ci tile of 8 packs two taps into one (27 taps: 14
// tiles, the last half padding); a warp's units are m16 tiles, each with
// every n8 tile of the co tile.  A staged voxel is 32-byte rows of x in its
// own dtype (a ci tile of 8 in bf16 half of one), dy rows are f32.  Two CTAs
// share an SM (one was slower, measured): each has half the SM's 233472
// bytes, less the 1 KB a CTA reserves and the static arrays (the slot list
// and 512 bytes).
constexpr int tf32_units(int cit) { return (27 * cit + 15) / 16; }
constexpr int tf32_acc(int cit, int cot) {
  return (tf32_units(cit) + WARPS - 1) / WARPS * (cot / 8) * 4;
}
constexpr int tf32_row(int cit, int sx) { return imax(cit * sx, 32); }
constexpr int tf32_smem(int bs, int cit, int cot, int sx) {
  const int hs = bs + 2, xb = tf32_row(cit, sx), db = cot * 4;
  return bs == 8 ? hs * hs * hs * xb + bs * bs * bs * db
                 : NBUF * hs * hs * xb + DYBUF * bs * bs * db;
}
constexpr int smem_tf32(int bs) {
  return 233472 / 2 - 1024 - (2 * bs * bs * bs + 512);
}

// The first that fits: the widest co tile, then the widest ci tile (on
// mma.sync under f32 dy, tiles of ci and co from 8).
constexpr Plan make_plan(int ci, int co, int sx, int sg, int bs) {
  if (ci >= MMA_MIN_CI && (sg == 2 || co >= MMA_MIN_CO_F32)) {
    const int least = sg == 2 ? 1 : 8;
    for (int cot = co; cot >= least; cot /= 2)
      for (int cit = ci; cit >= least; cit /= 2) {
        const int smem = sg == 2 ? mma_smem(bs, cit, cot)
                                 : tf32_smem(bs, cit, cot, sx);
        if (sg == 2 ? mma_acc(cit, cot) <= ACC_MAX && smem <= SMEM_MMA
                    : tf32_acc(cit, cot) <= ACC_MAX &&
                          smem <= smem_tf32(bs)) {
          const int splits = (ci / cit) * (co / cot);
          return Plan{cit, cot, 0, 0, 0, 0, splits,
                      imax(8, GRID_CTAS / splits), smem, 1};
        }
      }
    return Plan{};
  }
  for (int cot = co; cot >= 1; cot /= 2)
    for (int cit = ci; cit >= 1; cit /= 2) {
      const Plan p = plan_for(ci, co, sx, sg, bs, cit, cot);
      if (p.tm * p.tn <= ACC_MAX && p.smem <= SMEM_MAX) return p;
    }
  return Plan{};
}

template <typename TX, typename TG, int CI, int CO, int BS_>
struct Cfg {
  static_assert(BS_ == 16 || BS_ == 8, "block side");
  static constexpr int BS = BS_;
  static constexpr int VOL = BS * BS * BS;
  static constexpr int HS = BS + 2;
  static constexpr int PLANE = HS * HS;  // voxels per staged input plane
  static constexpr Plan PL = make_plan(CI, CO, sizeof(TX), sizeof(TG), BS);
  static constexpr int CIT = PL.cit, COT = PL.cot;
  static constexpr int TM = PL.tm, TN = PL.tn, P = PL.p, KSPLIT = PL.ksplit;
  static constexpr int COS = CO / COT;                 // co tiles
  static constexpr int MT = CIT / TM, NTL = COT / TN;  // thread tiles
  static constexpr int E = 27 * CIT * COT;             // entries per CTA
  static constexpr int RSY = HS * CIT + 16 / sizeof(TX);  // staged y row
  static constexpr int SLOT = HS * RSY;                // staged plane
  static constexpr int RING = NBUF * SLOT;             // staged x elements
  static constexpr int GBUF = BS * BS * COT;           // dy per buffer
  // f32 x under bf16 compute (bf16 dy) is rounded to bf16 as it lands
  static constexpr bool ROUND = std::is_same<TX, float>::value &&
                                std::is_same<TG, __nv_bfloat16>::value;
  static_assert(PL.cit != 0, "no plan fits");
  static_assert(P * KSPLIT <= THREADS && TM * TN <= ACC_MAX, "plan");
};

// The mma.sync instances (bf16 dy): x staged as bf16 voxels of CIP
// channels (NC 16-byte chunks), dy as bf16 rows of COP channels
template <typename TX, int CI, int CO, int BS_>
struct MCfg {
  static_assert(BS_ == 16 || BS_ == 8, "block side");
  static constexpr int BS = BS_;
  static constexpr int VOL = BS * BS * BS;
  static constexpr int HS = BS + 2;
  static constexpr int PLANE = HS * HS;
  static constexpr Plan PL = make_plan(CI, CO, sizeof(TX), 2, BS);
  static constexpr int CIT = PL.cit, COT = PL.cot;
  static constexpr int COS = CO / COT;               // co tiles
  static constexpr int CIP = imax(CIT, 8), COP = imax(COT, 8);
  static constexpr int NC = CIP / 8, NCO = COP / 8;  // 16-byte chunks
  static constexpr int MT = (CIP + 15) / 16;         // m16 tiles
  static constexpr int NT = NCO;                     // n8 tiles
  static constexpr int UNITS = 27 * MT;              // (tap, m16 tile)
  static constexpr int U = (UNITS + WARPS - 1) / WARPS;  // units a warp
  static constexpr bool X4 = CIP >= 16;  // A by ldmatrix .x4, else .x2
  // BS = 16: a ring of NBUF planes, one output plane a step; BS = 8: the
  // whole halo, every plane in its own slot, one step per item
  static constexpr bool WHOLE = BS == 8;
  static constexpr int SLOTS = WHOLE ? HS : NBUF;
  static constexpr int SLOT_B = PLANE * CIP * 2;     // bytes per plane
  static constexpr int GBUF_B = (WHOLE ? VOL : BS * BS) * COP * 2;
  static constexpr int RING_B = SLOTS * SLOT_B;
  static_assert(PL.mma == 1 && PL.cit != 0, "no mma plan fits");
  static_assert(CIT == 1 || CIT == 4 || CIT % 8 == 0, "ci tile");
  static_assert(COT == 1 || COT == 4 || COT % 8 == 0, "co tile");
  static_assert(PL.smem == RING_B + (WHOLE ? 1 : DYBUF) * GBUF_B, "smem");
  static_assert(U * NT * 4 <= ACC_MAX, "accumulators");
  // CTAs per SM the kernel is compiled for: two (at most 128 registers a
  // thread) where the accumulators and an f32 plane's prefetch (PlaneStage,
  // 16³ only) take at most 64 registers, and at BS = 8; else one
  // (measured both ways per pair on a training step, PERF.md)
  static constexpr int PREFETCH =
      std::is_same<TX, float>::value && !WHOLE
          ? (PLANE * NC + THREADS - 1) / THREADS * (CIT >= 8 ? 8 : 4)
          : 0;
  static constexpr int MIN_CTAS =
      WHOLE || U * NT * 4 + PREFETCH <= 64 ? 2 : 1;
};

// The 3xTF32 instances (f32 dy).  Staged x is NSUB sub-planes of SLOTS x
// PLANE 32-byte rows: staged row R = slot * PLANE + (y, z) holds a voxel's
// channels c in sub-plane c * SX / 32.  Any 4 consecutive rows of a
// sub-plane fill the 4 32-byte bank groups of a 128-byte line, and a
// voxel's address is R * 32 plus a constant per channel.  dy: NT
// sub-buffers of 32-byte rows (8 f32 channels), row j the j-th listed slot.
template <typename TX, int CI, int CO, int BS_>
struct TCfg {
  static_assert(BS_ == 16 || BS_ == 8, "block side");
  static constexpr int BS = BS_;
  static constexpr int VOL = BS * BS * BS;
  static constexpr int HS = BS + 2;
  static constexpr int PLANE = HS * HS;
  static constexpr Plan PL = make_plan(CI, CO, sizeof(TX), 4, BS);
  static constexpr int CIT = PL.cit, COT = PL.cot;
  static constexpr int COS = CO / COT;  // co tiles
  static constexpr int SX = sizeof(TX);
  // an f32 x has a lo part (3 products); a bf16 x is exact in tf32 (2)
  static constexpr bool LO = std::is_same<TX, float>::value;
  static constexpr int NSUB = tf32_row(CIT, SX) / 32;
  static constexpr int NT = COT / 8;             // n8 tiles
  static constexpr int UNITS = tf32_units(CIT);  // m16 tiles of (tap, ci)
  static constexpr int U = (UNITS + WARPS - 1) / WARPS;  // units a warp
  static constexpr bool WHOLE = BS == 8;
  static constexpr int SLOTS = WHOLE ? HS : NBUF;
  static constexpr int SLOT_B = PLANE * 32;      // a slot's rows
  static constexpr int SUB_B = SLOTS * SLOT_B;   // a sub-plane
  static constexpr int DYROWS = WHOLE ? VOL : BS * BS;
  static constexpr int GBUF_B = DYROWS * COT * 4;
  static constexpr int RING_B = NSUB * SUB_B;
  // byte of channel c of a staged voxel, beside its row
  __device__ static constexpr int chan_at(int c) {
    return c * SX / 32 * SUB_B + c * SX % 32;
  }
  static_assert(PL.mma == 1 && PL.cit != 0, "no tf32 plan fits");
  static_assert(CIT % 8 == 0 && COT % 8 == 0, "tiles of 8 channels");
  static_assert(PL.smem == RING_B + (WHOLE ? 1 : DYBUF) * GBUF_B, "smem");
  static_assert(U * NT * 4 <= ACC_MAX, "accumulators");
  static constexpr int MIN_CTAS = 2;
};

// The work items of a grid of g CTAs over n_rows live rows: (row, chunk of
// xp output x-planes), xp the widest of BS, BS/2, ..., 1 that still gives
// every CTA an item.  A function of count and G alone, so the order of
// summation is too.
template <int BS>
__device__ __forceinline__ int work_items(int n_rows, int g, int& xp) {
  xp = BS;
  while (xp > 1 && n_rows * (BS / xp) < g) xp /= 2;
  return n_rows * (BS / xp);
}

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

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// N consecutive elements at p (aligned to their size) as f32
template <int N, typename T>
__device__ __forceinline__ void load_f(const T* p, float (&v)[N]) {
  constexpr int B = N * sizeof(T);
  alignas(16) T tmp[N];
  if constexpr (B % 16 == 0) {
#pragma unroll
    for (int j = 0; j < B / 16; ++j)
      reinterpret_cast<uint4*>(tmp)[j] = reinterpret_cast<const uint4*>(p)[j];
  } else if constexpr (B == 8) {
    *reinterpret_cast<uint2*>(tmp) = *reinterpret_cast<const uint2*>(p);
  } else if constexpr (B == 4) {
    *reinterpret_cast<uint32_t*>(tmp) = *reinterpret_cast<const uint32_t*>(p);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) tmp[j] = p[j];
  }
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = to_f(tmp[j]);
}

// N 8 x 8 b16 matrices by ldmatrix .trans (N = 4 or 2): lanes 8m .. 8m + 7
// address the rows of matrix m; a row is 16 bytes of one voxel (8 channels)
template <int N>
__device__ __forceinline__ void ldsm(uint32_t addr, uint32_t* r) {
  if constexpr (N == 4)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
        : "=r"(r[0]), "=r"(r[1])
        : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a.b + c on mma.sync m16n8k8 tf32 (f32 accumulation), and d = a.b;
// no side effects, so not volatile: the compiler may interleave chains
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1,
                                         const float (&c)[4]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// f32 -> tf32 bits, rounded to nearest, ties away (the mma would
// truncate): conv3_tc.cu's integer rounding, cvt.rna.tf32.f32's bits for
// every finite x
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// an f32 value -> its tf32 hi and lo parts, both rounded (leaving lo, or
// both, to the mma's truncation was faster, and less accurate: measured)
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(__uint_as_float(x));
  lo = tf32_rna(__uint_as_float(x) - __uint_as_float(hi));
}

// gather halo plane p (halo x coordinate, 0..BS+1) of block row `rows`,
// channels c0 .. c0 + CIT - 1, into `slot`: (BS+2)^2 voxels from the
// neighbour rows of that plane, y rows RSY elements apart
template <typename TX, int CI, int CIT, int RSY, int BS>
__device__ __forceinline__ void stage(const TX* __restrict__ x,
                                      const int* rows, TX* slot, int p,
                                      int c0, int t) {
  constexpr int HS = BS + 2, PLANE = HS * HS, VOL = BS * BS * BS;
  int nx, sx;
  halo_src<BS>(p, nx, sx);
  constexpr int VB = CIT * sizeof(TX);       // bytes per staged voxel
  constexpr int PIECE = VB < 16 ? VB : 16;   // bytes per copy
  constexpr int CH = VB / PIECE;             // copies per voxel
  constexpr int PE = PIECE / sizeof(TX);     // elements per copy
  for (int k = t; k < PLANE * CH; k += THREADS) {
    const int r = k / CH, c = k % CH;
    int ny, sy, nz, sz;
    halo_src<BS>(r / HS, ny, sy);
    halo_src<BS>(r % HS, nz, sz);
    const size_t row = rows[nx * 9 + ny * 3 + nz];
    const TX* src =
        x + (row * VOL + (sx * BS + sy) * BS + sz) * CI + c0 + c * PE;
    TX* dst = slot + (r / HS) * RSY + (r % HS) * CIT + c * PE;
    if constexpr (PIECE >= 4)
      cp_async<PIECE>(smem_u32(dst), src);
    else
      *dst = *src;  // a 2-byte voxel: cp.async moves 4, 8 or 16 bytes
  }
}

// round to bf16 (then f32) the part of a staged f32 plane that `stage`
// made thread t copy
template <int CIT, int RSY, int BS>
__device__ __forceinline__ void round_bf16(float* slot, int t) {
  constexpr int HS = BS + 2, PLANE = HS * HS;
  constexpr int PIECE = CIT * 4 < 16 ? CIT * 4 : 16;
  constexpr int CH = CIT * 4 / PIECE;
  constexpr int PE = PIECE / 4;
  for (int k = t; k < PLANE * CH; k += THREADS) {
    const int r = k / CH, c = k % CH;
    float* f = slot + (r / HS) * RSY + (r % HS) * CIT + c * PE;
    if constexpr (PE == 1) {
      f[0] = __bfloat162float(__float2bfloat16_rn(f[0]));
    } else {  // pairs: one cvt.rn.bf16x2.f32 for two values
#pragma unroll
      for (int j = 0; j < PE; j += 2) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(f[j], f[j + 1]);
        f[j] = __low2float(h);
        f[j + 1] = __high2float(h);
      }
    }
  }
}

// gather dy at the listed slots idx[0 .. n) of the row at `row0` (flat
// voxel index), co tile co0 .., into buf [n][COT]
template <typename TG, int CO, int COT>
__device__ __forceinline__ void stage_dy(const TG* __restrict__ dy,
                                         const uint16_t* idx, size_t row0,
                                         int n, int co0, TG* buf, int t) {
  constexpr int VB = COT * sizeof(TG);
  constexpr int PIECE = VB < 16 ? VB : 16;
  constexpr int CH = VB / PIECE;
  constexpr int PE = PIECE / sizeof(TG);
  for (int k = t; k < n * CH; k += THREADS) {
    const int j = k / CH, c = k % CH;
    const TG* src = dy + (row0 + idx[j]) * CO + co0 + c * PE;
    TG* dst = buf + j * COT + c * PE;
    if constexpr (PIECE >= 4)
      cp_async<PIECE>(smem_u32(dst), src);
    else
      *dst = *src;
  }
}

// The occupied slots of the row at flat voxel index row0 into idx[],
// ascending, and where each x-plane's slots start into pstart[] (pstart[BS]
// is their count): thread t scans mask bytes MB t .. MB t + MB - 1 (plane
// t / TPP), a block-wide exclusive scan places them.  Ends on a barrier.
template <int BS>
__device__ __forceinline__ void list_slots(const uint8_t* __restrict__ mask,
                                           size_t row0, uint16_t* idx,
                                           int* pstart, int* wsum, int t) {
  constexpr int MB = BS * BS * BS / THREADS, TPP = BS * BS / MB;
  const int lane = t & 31, warp = t >> 5;
  uint32_t mw[4] = {0u, 0u, 0u, 0u};
  if constexpr (MB == 16) {
    const uint4 m4 = reinterpret_cast<const uint4*>(mask + row0)[t];
    mw[0] = m4.x, mw[1] = m4.y, mw[2] = m4.z, mw[3] = m4.w;
  } else {
    static_assert(MB == 2, "mask bytes per thread");
    mw[0] = reinterpret_cast<const uint16_t*>(mask + row0)[t];
  }
  int c = 0;
#pragma unroll
  for (int k = 0; k < MB; ++k)
    c += ((mw[k / 4] >> (8 * (k % 4))) & 0xffu) != 0;
  int incl = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  int pos = incl - c;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) pos += w < warp ? wsum[w] : 0;
  if (t % TPP == 0) pstart[t / TPP] = pos;
  if (t == THREADS - 1) pstart[BS] = pos + c;
#pragma unroll
  for (int k = 0; k < MB; ++k)
    if ((mw[k / 4] >> (8 * (k % 4))) & 0xffu) idx[pos++] = MB * t + k;
  __syncthreads();
}

// Byte offset of 16-byte chunk c of staged row p, rows of nc chunks: the
// chunk index is XOR-ed with a function of p that gives the 8 rows p ..
// p + 7 eight distinct bank groups, so an ldmatrix phase over consecutive
// rows (a z run of a surface, or consecutive dy rows) is conflict-free.
template <int NCH>
__device__ __forceinline__ uint32_t swz(int p, int c) {
  constexpr int PER = 8 / NCH;  // rows per 128 bytes
  return static_cast<uint32_t>(p * NCH * 16 +
                               ((c ^ ((p / PER) & (NCH - 1))) << 4));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // cvt.rn.bf16x2
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Halo plane p of block row `rows`, channels c0 .. c0 + CIT - 1, gathered
// as bf16 into a staged plane (PLANE rows of NC swizzled 16-byte chunks).
// An f32 x goes through the registers and is rounded there (cvt.rn.bf16x2,
// the rounding conv3_wgrad_plain does), in two halves so that a plane's
// loads can fly while the previous plane's products run: `load` issues
// this thread's loads, `store` rounds them and writes them to the plane at
// `slot`.  A bf16 x is copied by cp.async (`copy`).  The channels past CIT
// of a narrow voxel are left as they are: they only feed products that
// are not stored.
template <typename TX, int CI, int CIT, int BS>
struct PlaneStage {
  static constexpr int HS = BS + 2, PLANE = HS * HS, VOL = BS * BS * BS;
  static constexpr int NC = CIT >= 8 ? CIT / 8 : 1;
  static constexpr int TASKS = PLANE * NC;
  static constexpr int ITER = (TASKS + THREADS - 1) / THREADS;
  float4 v[ITER][CIT >= 8 ? 2 : 1];

  // the source of this thread's i-th task of plane p, or nullptr
  __device__ __forceinline__ static const TX* src(const TX* __restrict__ x,
                                                  const int* rows, int p,
                                                  int c0, int k) {
    if (k >= TASKS) return nullptr;
    int nx, sx, ny, sy, nz, sz;
    const int r = k / NC, c = k % NC;
    halo_src<BS>(p, nx, sx);
    halo_src<BS>(r / HS, ny, sy);
    halo_src<BS>(r % HS, nz, sz);
    const size_t row = rows[nx * 9 + ny * 3 + nz];
    return x + (row * VOL + (sx * BS + sy) * BS + sz) * CI + c0 + c * 8;
  }

  __device__ __forceinline__ void load(const float* __restrict__ x,
                                       const int* rows, int p, int c0,
                                       int t) {
#pragma unroll
    for (int i = 0; i < ITER; ++i) {
      const float* s = src(x, rows, p, c0, t + i * THREADS);
      if (s == nullptr) continue;
      if constexpr (CIT >= 8) {
        v[i][0] = __ldg(reinterpret_cast<const float4*>(s));
        v[i][1] = __ldg(reinterpret_cast<const float4*>(s) + 1);
      } else if constexpr (CIT == 4) {
        v[i][0] = __ldg(reinterpret_cast<const float4*>(s));
      } else {
        v[i][0].x = __ldg(s);
      }
    }
  }

  __device__ __forceinline__ void store(unsigned char* slot, int t) const {
#pragma unroll
    for (int i = 0; i < ITER; ++i) {
      const int k = t + i * THREADS;
      if (k >= TASKS) continue;
      unsigned char* dst = slot + swz<NC>(k / NC, k % NC);
      if constexpr (CIT >= 8) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(
            pack_bf16(v[i][0].x, v[i][0].y), pack_bf16(v[i][0].z, v[i][0].w),
            pack_bf16(v[i][1].x, v[i][1].y), pack_bf16(v[i][1].z, v[i][1].w));
      } else if constexpr (CIT == 4) {
        *reinterpret_cast<uint2*>(dst) = make_uint2(
            pack_bf16(v[i][0].x, v[i][0].y), pack_bf16(v[i][0].z, v[i][0].w));
      } else {
        *reinterpret_cast<__nv_bfloat16*>(dst) = __float2bfloat16_rn(v[i][0].x);
      }
    }
  }

  __device__ __forceinline__ static void copy(const TX* __restrict__ x,
                                              const int* rows, int p,
                                              int c0, unsigned char* slot,
                                              int t) {
#pragma unroll
    for (int i = 0; i < ITER; ++i) {
      const int k = t + i * THREADS;
      const TX* s = src(x, rows, p, c0, k);
      if (s == nullptr) continue;
      unsigned char* dst = slot + swz<NC>(k / NC, k % NC);
      if constexpr (CIT >= 8)
        cp_async<16>(smem_u32(dst), s);
      else if constexpr (CIT == 4)
        cp_async<8>(smem_u32(dst), s);
      else  // one bf16 channel: cp.async moves 4, 8 or 16 bytes
        *reinterpret_cast<TX*>(dst) = *s;
    }
  }
};

// gather bf16 dy at the listed slots idx[0 .. n) of the row at `row0`,
// co tile co0 .., into buf: row j of NCO swizzled 16-byte chunks
template <int CO, int COT>
__device__ __forceinline__ void stage_dy_bf16(
    const __nv_bfloat16* __restrict__ dy, const uint16_t* idx, size_t row0,
    int n, int co0, unsigned char* buf, int t) {
  constexpr int NCO = COT >= 8 ? COT / 8 : 1;
  for (int k = t; k < n * NCO; k += THREADS) {
    const int j = k / NCO, c = k % NCO;
    const __nv_bfloat16* src = dy + (row0 + idx[j]) * CO + co0 + c * 8;
    unsigned char* dst = buf + swz<NCO>(j, c);
    if constexpr (COT >= 8)
      cp_async<16>(smem_u32(dst), src);
    else if constexpr (COT == 4)
      cp_async<8>(smem_u32(dst), src);
    else
      *reinterpret_cast<__nv_bfloat16*>(dst) = *src;
  }
}

// The copies of a staged voxel (or dy row) of VB bytes, VB a multiple of
// 16: 16-byte pieces in 32-byte rows of successive sub-planes; copy k is
// piece k % PIECES of voxel k / PIECES, so neighbouring threads read one
// voxel's bytes from device memory.  (A quarter warp's pieces then land two
// to a bank group at 2 sub-planes; ordering the copies by sub-plane avoids
// that but read device memory in 32-byte pieces and was slower, measured.)

// Halo plane p of block row `rows`, channels c0 .. c0 + CIT - 1, copied by
// cp.async as the grid stores it into the staged rows at `slot` (TCfg's
// layout).  The upper half of a bf16 ci tile of 8's row is never read.
template <typename C, int CI, typename TX>
__device__ __forceinline__ void copy_plane(const TX* __restrict__ x,
                                           const int* rows, int p, int c0,
                                           unsigned char* slot, int t) {
  constexpr int HS = C::HS, BS = C::BS, VOL = C::VOL;
  constexpr int PIECES = C::CIT * C::SX / 16;
  int nx, sx;
  halo_src<BS>(p, nx, sx);
  for (int k = t; k < C::PLANE * PIECES; k += THREADS) {
    const int r = k / PIECES, b = k % PIECES * 16;
    int ny, sy, nz, sz;
    halo_src<BS>(r / HS, ny, sy);
    halo_src<BS>(r % HS, nz, sz);
    const size_t row = rows[nx * 9 + ny * 3 + nz];
    const TX* src =
        x + (row * VOL + (sx * BS + sy) * BS + sz) * CI + c0 + b / C::SX;
    cp_async<16>(smem_u32(slot + r * 32 + C::chan_at(b / C::SX)), src);
  }
}

// gather f32 dy at the listed slots idx[0 .. n) of the row at `row0`, co
// tile co0 .., into buf (TCfg's layout), and zeros into rows n .. up to
// the next multiple of 8: a K chunk past the list multiplies by 0
template <typename C, int CO>
__device__ __forceinline__ void stage_dy_f32(const float* __restrict__ dy,
                                             const uint16_t* idx,
                                             size_t row0, int n, int co0,
                                             unsigned char* buf, int t) {
  constexpr int PIECES = C::COT * 4 / 16;
  constexpr int SUB = C::DYROWS * 32;  // bytes of a sub-buffer
  for (int k = t; k < n * PIECES; k += THREADS) {
    const int j = k / PIECES, b = k % PIECES * 16;
    const float* src = dy + (row0 + idx[j]) * CO + co0 + b / 4;
    cp_async<16>(smem_u32(buf + b / 32 * SUB + j * 32 + b % 32), src);
  }
  const int pad = (8 - n % 8) % 8;
  for (int k = t; k < pad * C::COT; k += THREADS) {
    const int j = n + k / C::COT, ch = k % C::COT;
    *reinterpret_cast<float*>(buf + ch / 8 * SUB + j * 32 + ch % 8 * 4) =
        0.f;
  }
}

// acc[u][nt] += X[v + tap]^T dY[v] in 3xTF32 over the listed slots idx[kb
// .. ke) of the staged planes: K chunks of 8 listed voxels, in list order
// (dy rows 0 ..; a chunk's rows past ke are zero).  Warp w owns the units
// u = w, w + WARPS, ... (m16 tiles of the (tap, ci) rows) and every n8
// tile.  Lane 4g + q holds fragment rows g and g + 8, which are rows 2g and
// 2g + 1 of the unit (the store undoes this permutation): adjacent
// channels of one voxel v + tap, one 64-bit load (32 bits for a bf16
// pair); fragment k q and q + 4 are list entries k0 + q and k0 + q +
// 4 (past ke, the last entry: finite values times zero dy).  A row past
// tap 26 (and a unit past UNITS) reads tap 0: it feeds no stored entry.
// Each unit's offset from a lane's staged row is fixed for the call (at
// 16^3 with its planes' ring slots).  The next chunk's list entries and dY
// words are loaded before this chunk's products.  Both operands are split
// into tf32 hi and lo in the registers, dY once per chunk for all of the
// warp's units; a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, the small terms first
// (a bf16 x has no lo), go into a fresh fragment that is then added to the
// accumulator in f32: the tensor cores' own accumulation truncates, which
// over a call's thousands of products would bias the sums.
template <typename C>
__device__ __forceinline__ void tf32_chunks(float (&acc)[C::U][C::NT][4],
                                            const uint16_t* idx, int kb,
                                            int ke, int xo,
                                            const unsigned char* ring,
                                            const unsigned char* dyb,
                                            int lane, int warp) {
  constexpr int BS = C::BS, HS = C::HS;
  const int g = lane >> 2, q = lane & 3;
  // each unit's rows 2g, 2g + 1 of this lane (one voxel: CIT is even): its
  // tap's planes, (y, z) and channel as a byte offset from the lane's
  // staged row
  int uo[C::U];
#pragma unroll
  for (int j = 0; j < C::U; ++j) {
    const int row = (warp + j * WARPS) * 16 + 2 * g;
    const int tap = row / C::CIT < 27 ? row / C::CIT : 0;
    const int tx = tap / 9, tyz = (tap / 3) % 3 * HS + tap % 3;
    uo[j] = ((C::WHOLE ? tx : (xo + tx) % C::SLOTS) * C::PLANE + tyz) * 32 +
            C::chan_at(row % C::CIT);
  }
  constexpr int SUB = C::DYROWS * 32;
  constexpr float ZERO[4] = {0.f, 0.f, 0.f, 0.f};
  // a chunk's list entries and raw dY words of this lane (k q, q + 4)
  int vn[2];
  uint32_t bn[C::NT][2];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      vn[h] = idx[min(k0 + q + 4 * h, ke - 1)];
      const unsigned char* b =
          dyb + min(k0 - kb + q + 4 * h, C::DYROWS - 1) * 32 + 4 * g;
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt)
        bn[nt][h] = *reinterpret_cast<const uint32_t*>(b + nt * SUB);
    }
  };
  fetch(kb);
#pragma unroll 2
  for (int k0 = kb; k0 < ke; k0 += 8) {
    uint32_t bh[C::NT][2], bl[C::NT][2];
    const unsigned char* vrow[2];  // the lane's staged rows, k q and q + 4
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int v = vn[h];
      vrow[h] = ring + ((C::WHOLE ? v / (BS * BS) * C::PLANE : 0) +
                        (v / BS) % BS * HS + v % BS) *
                           32;
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt)
        split_tf32(bn[nt][h], bh[nt][h], bl[nt][h]);
    }
    if (k0 + 8 < ke) fetch(k0 + 8);  // warp-uniform
    // every warp runs U units, one past UNITS on tap 0 and never stored:
    // no branch between the units, so their loads and products interleave
#pragma unroll
    for (int j = 0; j < C::U; ++j) {
      // rows g, g + 8 at k q (a0, a1) and at k q + 4 (a2, a3)
      uint32_t ah[4], al[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // channels 2g, 2g + 1 of one voxel
        const unsigned char* at = vrow[h] + uo[j];
        if constexpr (!C::LO) {  // a bf16 pair
          const uint32_t w = *reinterpret_cast<const uint32_t*>(at);
          ah[2 * h] = w << 16, ah[2 * h + 1] = w & 0xffff0000u;
        } else {
          const uint2 w = *reinterpret_cast<const uint2*>(at);
          split_tf32(w.x, ah[2 * h], al[2 * h]);
          split_tf32(w.y, ah[2 * h + 1], al[2 * h + 1]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt) {
        float c[4];
        if constexpr (C::LO) {
          mma_tf32(c, al, bh[nt][0], bh[nt][1], ZERO);
          mma_tf32(c, ah, bl[nt][0], bl[nt][1], c);
        } else {
          mma_tf32(c, ah, bl[nt][0], bl[nt][1], ZERO);
        }
        mma_tf32(c, ah, bh[nt][0], bh[nt][1], c);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][nt][e] += c[e];
      }
    }
  }
}

// acc[u][nt] += X[v + tap]^T dY[v] over the listed slots idx[kb .. ke) of
// the staged planes: K chunks of 16 listed voxels, in list order.  Warp w
// owns the units u = w, w + WARPS, ... (unit = tap * MT + m16 tile) and
// every n8 tile.  dY comes by ldmatrix.trans from the dy rows at list
// position k - kb, X^T by ldmatrix.trans with each lane's address the
// staged voxel v + tap of its own list entry: the gather is an address.
// Lanes past ke point at the zero chunk.
template <typename C>
__device__ __forceinline__ void mma_chunks(float (&acc)[C::U][C::NT][4],
                                           const uint16_t* idx, int kb,
                                           int ke, uint32_t ring,
                                           uint32_t dyb, uint32_t zero,
                                           int lane, int warp) {
  constexpr int BS = C::BS, HS = C::HS;
  // A: lane -> (k, 16-byte chunk) of its ldmatrix row
  const int ka = C::X4 ? (lane & 7) | ((lane >> 4) << 3) : (lane & 15);
  const int ca = C::X4 ? (lane >> 3) & 1 : 0;
  // B: lane -> (k, n8 tile within a pair)
  const int kbb = lane & 15, nb = lane >> 4;
#pragma unroll 1
  for (int k0 = kb; k0 < ke; k0 += 16) {
    uint32_t b[C::NT][2];
    {
      const bool in = k0 + kbb < ke;
      const int j = k0 - kb + kbb;
      if constexpr (C::NT == 1) {
        uint32_t r[2];
        ldsm<2>(in ? dyb + swz<C::NCO>(j, 0) : zero, r);
        b[0][0] = r[0], b[0][1] = r[1];
      } else {
#pragma unroll
        for (int nt = 0; nt < C::NT; nt += 2) {
          uint32_t r[4];
          ldsm<4>(in ? dyb + swz<C::NCO>(j, nt + nb) : zero, r);
          b[nt][0] = r[0], b[nt][1] = r[1];
          b[nt + 1][0] = r[2], b[nt + 1][1] = r[3];
        }
      }
    }
    const bool in = k0 + ka < ke;
    const int v = in ? idx[k0 + ka] : 0;
    const int vx = v / (BS * BS), vy = (v / BS) % BS, vz = v % BS;
#pragma unroll
    for (int j = 0; j < C::U; ++j) {
      const int u = warp + j * WARPS;
      if (u >= C::UNITS) break;  // warp-uniform
      const int tap = u / C::MT, mt = u % C::MT;
      const int tx = tap / 9, ty = (tap / 3) % 3, tz = tap % 3;
      const int p = (vy + ty) * HS + vz + tz;
      const uint32_t addr =
          in ? ring + ((vx + tx) % C::SLOTS) * C::SLOT_B +
                   swz<C::NC>(p, 2 * mt + ca)
             : zero;
      uint32_t a[4];
      if constexpr (C::X4) {
        ldsm<4>(addr, a);
      } else {  // ci <= 8: the upper m8 rows are zero
        uint32_t r[2];
        ldsm<2>(addr, r);
        a[0] = r[0], a[1] = 0u, a[2] = r[1], a[3] = 0u;
      }
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt)
        mma_bf16(acc[j][nt], a, b[nt][0], b[nt][1]);
    }
  }
}

// The tensor-core instances' configuration: MCfg for bf16 dy, TCfg for
// f32 dy
template <typename TX, typename TG, int CI, int CO, int BS>
using MmaCfg = std::conditional_t<std::is_same<TG, float>::value,
                                  TCfg<TX, CI, CO, BS>, MCfg<TX, CI, CO, BS>>;

// The tensor-core instances: as wgrad_partial_kernel walks items and lists
// their slots, with the sums on mma.sync (f32 accumulation) over staged
// planes: bf16 dy m16n8k16 over bf16 planes (`mma_chunks`), f32 dy 3xTF32
// m16n8k8 over planes in x's own dtype (`tf32_chunks`).  Each warp's
// fragments stay in registers across the items and are written to
// part[b, tap, ci, co] at the end, each entry by one thread: no k split to
// sum.
template <typename TX, typename TG, int CI, int CO, int BS>
__global__ void __launch_bounds__(THREADS,
                                  MmaCfg<TX, TG, CI, CO, BS>::MIN_CTAS)
    wgrad_mma_kernel(const TX* __restrict__ x, const TG* __restrict__ dy,
                     const int* __restrict__ nbrs,
                     const uint8_t* __restrict__ mask,
                     const int* __restrict__ count,
                     float* __restrict__ part) {
  using C = MmaCfg<TX, TG, CI, CO, BS>;
  constexpr bool TF = std::is_same<TG, float>::value;  // 3xTF32
  constexpr int VOL = C::VOL;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  unsigned char* gbuf = smem + C::RING_B;
  __shared__ uint16_t idx[VOL];   // the row's occupied slots, ascending
  __shared__ int pstart[BS + 1];  // where each x-plane's slots start
  __shared__ int rows[27];
  __shared__ int wsum[WARPS];
  __shared__ __align__(16) uint32_t zrow[4];  // the zero chunk

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int ci0 = blockIdx.y / C::COS * C::CIT;
  const int co0 = blockIdx.y % C::COS * C::COT;
  if (t < 4) zrow[t] = 0u;  // before the first scan's barriers
  const uint32_t ring_s = smem_u32(ring), zero_s = smem_u32(zrow);

  float acc[C::U][C::NT][4];
#pragma unroll
  for (int j = 0; j < C::U; ++j)
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][nt][e] = 0.f;

  int xp;
  const int items = work_items<BS>(*count, gridDim.x, xp),
            per_row = BS / xp;
  if (blockIdx.x >= items) return;  // its partial is never read
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int i = it / per_row, x0 = it % per_row * xp;
    const size_t row0 = (size_t)i * VOL;
    if (t < 27) rows[t] = nbrs[(size_t)i * 27 + t];
    list_slots<BS>(mask, row0, idx, pstart, wsum, t);
    uint32_t occ = 0;  // this item's occupied output planes
    for (int p = x0; p < x0 + xp; ++p)
      occ |= (uint32_t)(pstart[p + 1] > pstart[p]) << p;
    if (occ == 0u) {
      __syncthreads();  // rows, wsum, pstart, idx are rewritten
      continue;
    }
    auto needed = [&](int q) {  // input plane q is read by outputs q-2 .. q
      const int lo = max(0, q - 2), hi = min(BS - 1, q);
      return ((occ >> lo) & ((2u << (hi - lo)) - 1u)) != 0u;
    };
    using Stage = PlaneStage<TX, CI, C::CIT, BS>;
    // bf16 dy over an f32 x: each plane rounded on its way through the
    // registers; else copied by cp.async
    constexpr bool REG = !TF && std::is_same<TX, float>::value;
    [[maybe_unused]] Stage st;  // an f32 plane on its way through registers
    auto slot = [&](int q) { return ring + (q % C::SLOTS) * C::SLOT_B; };
    auto copy = [&](int q) {  // plane q by cp.async
      if constexpr (TF)
        copy_plane<C, CI>(x, rows, q, ci0, slot(q), t);
      else
        Stage::copy(x, rows, q, ci0, slot(q), t);
    };
    auto stage_plane = [&](int q) {  // plane q, landed or in flight
      if constexpr (REG) {
        st.load(x, rows, q, ci0, t);
        st.store(slot(q), t);
      } else {
        copy(q);
      }
    };
    auto stage_dy = [&](int kb, int n, unsigned char* buf) {
      if constexpr (TF)
        stage_dy_f32<C, CO>(dy, idx + kb, row0, n, co0, buf, t);
      else
        stage_dy_bf16<CO, C::COT>(dy, idx + kb, row0, n, co0, buf, t);
    };
    // the products of output plane xo (at 8^3 of the item) over dy at dyb
    auto chunks = [&](int kb, int ke, int xo, unsigned char* dyb) {
      if constexpr (TF)
        tf32_chunks<C>(acc, idx, kb, ke, xo, ring, dyb, lane, warp);
      else
        mma_chunks<C>(acc, idx, kb, ke, ring_s, smem_u32(dyb), zero_s, lane,
                      warp);
    };
    const int qend = x0 + xp + 2;  // input planes x0 .. qend - 1
    if constexpr (C::WHOLE) {
      // the item's planes and the dy of all its slots, then one step
      for (int q = x0; q < qend; ++q)
        if (needed(q)) stage_plane(q);
      const int kb = pstart[x0], ke = pstart[x0 + xp];
      stage_dy(kb, ke - kb, gbuf);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      chunks(kb, ke, x0, gbuf);
      __syncthreads();  // the planes, dy and the list are rewritten
      continue;
    } else {
      auto dybuf = [&](int xo) { return gbuf + (xo % DYBUF) * C::GBUF_B; };
      auto dy_of = [&](int xo) {
        stage_dy(pstart[xo], pstart[xo + 1] - pstart[xo], dybuf(xo));
      };
#pragma unroll 1
      for (int q = x0; q < x0 + 2 + AHEAD; ++q) {
        if (q < qend && needed(q)) stage_plane(q);
        if (q >= x0 + 2 && q - 2 < x0 + xp) dy_of(q - 2);
        cp_async_commit();
      }
      // an f32 x under bf16: the next plane's loads are issued before this
      // plane's products and stored after them
#pragma unroll 1
      for (int xo = x0; xo < x0 + xp; ++xo) {
        // AHEAD planes ahead, into the slots output plane xo - 1 read
        const int qn = xo + 2 + AHEAD;
        const bool next = qn < qend && needed(qn);
        if (next) {
          if constexpr (REG)
            st.load(x, rows, qn, ci0, t);
          else
            copy(qn);
        }
        if (xo + AHEAD < x0 + xp) dy_of(xo + AHEAD);
        cp_async_commit();
        if (!((occ >> xo) & 1u)) {
          if constexpr (REG)
            if (next) st.store(slot(qn), t);
          continue;
        }
        cp_async_wait<AHEAD>();  // planes xo .. xo + 2, dy of xo (own part)
        __syncthreads();         // ... everyone's
        chunks(pstart[xo], pstart[xo + 1], xo, dybuf(xo));
        if constexpr (REG)  // a slot no warp reads for plane xo
          if (next) st.store(slot(qn), t);
        __syncthreads();  // the ring slot and the dy buffer are reused
      }
      cp_async_wait<0>();  // no copy of this item may land in the next one's
      __syncthreads();
    }
  }

  // fragment (unit, n8 tile): lane 4g + q holds (row g, n 2q, 2q + 1) and
  // (row g + 8, n 2q, 2q + 1) of its m16 x n8 tile.  bf16: row m of m16
  // tile mt is channel 16 mt + m of the unit's tap; 3xTF32: rows g and g +
  // 8 are rows 2g and 2g + 1 of the unit, row R of the (tap, ci) space
  // channel R % CIT of tap R / CIT.
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int j = 0; j < C::U; ++j) {
    const int u = warp + j * WARPS;
    if (u >= C::UNITS) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int tap, m;
      if constexpr (TF) {
        const int row = u * 16 + 2 * g + h;
        tap = row / C::CIT, m = row % C::CIT;
        if (tap >= 27) continue;
      } else {
        tap = u / C::MT, m = u % C::MT * 16 + g + 8 * h;
        if (m >= C::CIT) continue;
      }
      float* out = part + ((size_t)blockIdx.x * 27 + tap) * CI * CO +
                   (size_t)(ci0 + m) * CO + co0;
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = nt * 8 + 2 * q + e;
          if (n < C::COT) out[n] = acc[j][nt][2 * h + e];
        }
    }
  }
}

template <typename TX, typename TG, int CI, int CO, int BS>
__global__ void __launch_bounds__(THREADS)
    wgrad_partial_kernel(const TX* __restrict__ x, const TG* __restrict__ dy,
                         const int* __restrict__ nbrs,
                         const uint8_t* __restrict__ mask,
                         const int* __restrict__ count,
                         float* __restrict__ part) {
  using C = Cfg<TX, TG, CI, CO, BS>;
  constexpr int VOL = C::VOL;
  extern __shared__ __align__(16) unsigned char smem[];
  TX* ring = reinterpret_cast<TX*>(smem);
  TG* gbuf = reinterpret_cast<TG*>(smem + C::RING * sizeof(TX));
  __shared__ uint16_t idx[VOL];   // the row's occupied slots, ascending
  __shared__ int pstart[BS + 1];  // where each x-plane's slots start
  __shared__ int rows[27];
  __shared__ int wsum[WARPS];

  const int t = threadIdx.x;
  // the split: ci tile ci0 .., co tile co0 .. (co fastest)
  const int ci0 = blockIdx.y / C::COS * C::CIT;
  const int co0 = blockIdx.y % C::COS * C::COT;

  // this thread's tile: tap, ci ci0 + m0 .., co co0 + n0 ..; voxel phase s
  const int s = t / C::P, pt = t % C::P;
  const bool active = s < C::KSPLIT;
  const int m0 = (pt / C::NTL) % C::MT * C::TM, n0 = pt % C::NTL * C::TN;
  const int tap = pt / (C::NTL * C::MT);
  const int tdx = tap / 9, tdy = (tap / 3) % 3, tdz = tap % 3;

  float acc[C::TM][C::TN];
#pragma unroll
  for (int a = 0; a < C::TM; ++a)
#pragma unroll
    for (int b = 0; b < C::TN; ++b) acc[a][b] = 0.f;

  int xp;
  const int items = work_items<BS>(*count, gridDim.x, xp),
            per_row = BS / xp;
  if (blockIdx.x >= items) return;  // its partial is never read
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int i = it / per_row, x0 = it % per_row * xp;
    const size_t row0 = (size_t)i * VOL;
    if (t < 27) rows[t] = nbrs[(size_t)i * 27 + t];
    list_slots<BS>(mask, row0, idx, pstart, wsum, t);
    uint32_t occ = 0;  // this item's occupied output planes
    for (int p = x0; p < x0 + xp; ++p)
      occ |= (uint32_t)(pstart[p + 1] > pstart[p]) << p;
    if (occ == 0u) {
      __syncthreads();  // rows, wsum, pstart, idx are rewritten
      continue;
    }
    // input plane q (halo x coordinate) is read by the output planes
    // q - 2 .. q
    auto needed = [&](int q) {
      const int lo = max(0, q - 2), hi = min(BS - 1, q);
      return ((occ >> lo) & ((2u << (hi - lo)) - 1u)) != 0u;
    };
    auto slot = [&](int q) { return ring + (q % NBUF) * C::SLOT; };
    auto dybuf = [&](int xo) { return gbuf + (xo % DYBUF) * C::GBUF; };
    [[maybe_unused]] int rnd = x0;  // f32 x, bf16 dy: first plane unrounded
    auto dy_of = [&](int xo) {  // dy at output plane xo's occupied slots
      stage_dy<TG, CO, C::COT>(dy, idx + pstart[xo], row0,
                               pstart[xo + 1] - pstart[xo], co0, dybuf(xo),
                               t);
    };
    const int qend = x0 + xp + 2;  // input planes x0 .. qend - 1
#pragma unroll 1
    for (int q = x0; q < x0 + 2 + AHEAD; ++q) {
      if (q < qend && needed(q))
        stage<TX, CI, C::CIT, C::RSY, BS>(x, rows, slot(q), q, ci0, t);
      if (q >= x0 + 2 && q - 2 < x0 + xp) dy_of(q - 2);
      cp_async_commit();
    }
#pragma unroll 1
    for (int xo = x0; xo < x0 + xp; ++xo) {
      // AHEAD planes ahead: input plane xo + 2 + AHEAD into the slot output
      // plane xo - 1 read, dy of output plane xo + AHEAD into the buffer it
      // read
      const int qn = xo + 2 + AHEAD;
      if (qn < qend && needed(qn))
        stage<TX, CI, C::CIT, C::RSY, BS>(x, rows, slot(qn), qn, ci0, t);
      if (xo + AHEAD < x0 + xp) dy_of(xo + AHEAD);
      cp_async_commit();
      if (!((occ >> xo) & 1u)) continue;
      cp_async_wait<AHEAD>();  // planes xo .. xo + 2, dy of xo (own part)
      if constexpr (C::ROUND) {  // each thread rounds the copies it made
        for (rnd = max(rnd, xo); rnd <= xo + 2; ++rnd)
          round_bf16<C::CIT, C::RSY, BS>(slot(rnd), t);
      }
      __syncthreads();  // ... everyone's

      if (active) {
        const TX* pl = slot(xo + tdx) + tdy * C::RSY + tdz * C::CIT + m0;
        const TG* g = dybuf(xo) + n0;
        const uint16_t* vs = idx + pstart[xo];
        const int n = pstart[xo + 1] - pstart[xo];
#pragma unroll 2
        for (int k = s; k < n; k += C::KSPLIT) {
          const int v = vs[k] & (BS * BS - 1);  // (y, z) in the plane
          float a[C::TM], b[C::TN];
          load_f<C::TM>(pl + (v / BS) * C::RSY + (v % BS) * C::CIT, a);
          load_f<C::TN>(g + k * C::COT, b);
#pragma unroll
          for (int p = 0; p < C::TM; ++p)
#pragma unroll
            for (int r = 0; r < C::TN; ++r)
              acc[p][r] = fmaf(a[p], b[r], acc[p][r]);
        }
      }
      __syncthreads();  // the ring slot and the dy buffer are reused
    }
    cp_async_wait<0>();  // no copy of this item may land in the next one's
    __syncthreads();
  }

  // sum the KSPLIT partial tiles in a fixed order into part[b, tap, ci, co]
  float* red = reinterpret_cast<float*>(smem);  // [KSPLIT][E]
  if (active) {
#pragma unroll
    for (int a = 0; a < C::TM; ++a)
#pragma unroll
      for (int b = 0; b < C::TN; ++b)
        red[s * C::E + (tap * C::CIT + m0 + a) * C::COT + n0 + b] = acc[a][b];
  }
  __syncthreads();
  for (int e = t; e < C::E; e += THREADS) {
    float sum = 0.f;
    for (int q = 0; q < C::KSPLIT; ++q) sum += red[q * C::E + e];
    const int tp = e / (C::CIT * C::COT), m = (e / C::COT) % C::CIT;
    part[((size_t)blockIdx.x * 27 + tp) * CI * CO + (ci0 + m) * CO +
         co0 + e % C::COT] = sum;
  }
}

// out[e] = sum over the partials r < min(g, items) of part[r, e], e < n_e
template <int BS>
__global__ void __launch_bounds__(32 * RED_Y)
    wgrad_reduce_kernel(const float* __restrict__ part,
                        const int* __restrict__ count, int g,
                        float* __restrict__ out, int n_e) {
  __shared__ float red[RED_Y][33];
  const int e = blockIdx.x * 32 + threadIdx.x;
  int xp;
  g = min(g, work_items<BS>(*count, g, xp));
  float s = 0.f;
  if (e < n_e) {
#pragma unroll 4
    for (int r = threadIdx.y; r < g; r += RED_Y) s += part[(size_t)r * n_e + e];
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

template <typename TX, typename TG, int CI, int CO, int BS>
int launch(const void* x, const void* dy, const void* nbrs, const void* mask,
           const void* count, void* part, void* out, const int* plan,
           cudaStream_t stream) {
  constexpr Plan PL = make_plan(CI, CO, sizeof(TX), sizeof(TG), BS);
  if (plan[0] != PL.cit || plan[1] != PL.cot || plan[2] != PL.g ||
      plan[3] != PL.mma)
    return -2;  // the wrapper's plan is not this instance's
  cudaError_t e;
  if constexpr (PL.mma) {
    auto kern = wgrad_mma_kernel<TX, TG, CI, CO, BS>;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             PL.smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kern<<<dim3(PL.g, PL.splits), THREADS, PL.smem, stream>>>(
        static_cast<const TX*>(x), static_cast<const TG*>(dy),
        static_cast<const int*>(nbrs), static_cast<const uint8_t*>(mask),
        static_cast<const int*>(count), static_cast<float*>(part));
  } else {
    auto kern = wgrad_partial_kernel<TX, TG, CI, CO, BS>;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             PL.smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kern<<<dim3(PL.g, PL.splits), THREADS, PL.smem, stream>>>(
        static_cast<const TX*>(x), static_cast<const TG*>(dy),
        static_cast<const int*>(nbrs), static_cast<const uint8_t*>(mask),
        static_cast<const int*>(count), static_cast<float*>(part));
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_e = 27 * CI * CO;
  wgrad_reduce_kernel<BS><<<(n_e + 31) / 32, dim3(32, RED_Y), 0, stream>>>(
      static_cast<const float*>(part), static_cast<const int*>(count),
      PL.g, static_cast<float*>(out), n_e);
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

template <typename TX, typename TG>
int by_pair(const void* x, const void* dy, const void* nbrs,
            const void* mask, const void* count, void* part, void* out,
            const int* plan, cudaStream_t s, int ci, int co) {
#define PCGC_CASE(ci_, co_)                                                \
  if (ci == ci_ && co == co_)                                              \
    return launch<TX, TG, ci_, co_, PCGC_BS>(x, dy, nbrs, mask, count, part, \
                                             out, plan, s);
  PCGC_PAIRS(PCGC_CASE)
#undef PCGC_CASE
  return -1;
}

}  // namespace

#define PCGC_CAT2(a, b) a##b
#define PCGC_CAT(a, b) PCGC_CAT2(a, b)

// pcgc_conv3_wgrad_bs16 / pcgc_conv3_wgrad_bs8: x [nb, BS^3, ci] in f32
// (x_bf16 = 0) or bf16 (x_bf16 = 1), as the grid stores it; dy [nb, BS^3,
// co] in the compute dtype, f32 (dy_bf16 = 0) or bf16 (dy_bf16 = 1); nbrs
// int32 [nb, 27]; mask bool [nb, BS^3] (16-byte aligned); count int32 [1]
// on the device; plan int32[4] on the host: (ci tile, co tile, G, mma)
// of ops/conv3.py::wgrad_plan; part f32 [G, 27, ci, co] scratch; out f32
// [27, ci, co].  Returns 0, a cudaError_t of a launch, -1 for an instance
// it does not have, or -2 where `plan` is not the instance's.
extern "C" int PCGC_CAT(pcgc_conv3_wgrad_bs, PCGC_BS)(
    const void* x, const void* dy, const void* nbrs, const void* mask,
    const void* count, void* part, void* out, const int* plan, int ci,
    int co, int x_bf16, int dy_bf16, void* stream) {
  using bf16 = __nv_bfloat16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && dy_bf16)
    return by_pair<bf16, bf16>(x, dy, nbrs, mask, count, part, out, plan, s,
                               ci, co);
  if (x_bf16)
    return by_pair<bf16, float>(x, dy, nbrs, mask, count, part, out, plan, s,
                                ci, co);
  if (dy_bf16)
    return by_pair<float, bf16>(x, dy, nbrs, mask, count, part, out, plan, s,
                                ci, co);
  return by_pair<float, float>(x, dy, nbrs, mask, count, part, out, plan, s,
                               ci, co);
}
