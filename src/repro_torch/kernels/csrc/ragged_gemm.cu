// Ragged grouped expert GEMM for Hopper (sm_90a): dense bodies (float32
// activations against float32 or bf16 weights) and quantized bodies (int8
// and fp8 e4m3 activations and weights) on the tensor cores.
//
// Replaces the TPU kernel repro/kernels/ragged_gemm.py:73 `ragged_gemm`:
// its dense body (`_dense_body`, :41) and its quantized body
// (`_quant_body`, :52, called at :148).
//
// Computes y[p*m + r, :] = x[p*m + r, :] @ w[pe[p]] for P row groups of m
// rows each: every routed (sample, slot) pair of the serving step is one
// group, contracting against its own expert's stacked (D, F) weight.  The
// quantized bodies end with the reference's dequant epilogue
//   y = (float(acc) * xs[row]) * ws[pe[p]]
// with per-row activation scales xs and per-expert weight scales ws.  An
// out-of-range expert id writes NaN rows instead of reading outside the
// weight stack.  Every m, D and F goes through the same kernels: ragged
// row, column and depth edges are masked (zero-filled loads, guarded
// stores).  Grid (F/128, m/BM, P): each block owns one BM × 128 output
// tile of one group, so it has exactly one expert (BM = 128; the dense
// bodies also have a 32-row tile).
//
// Dense bodies.  At the serving shapes (m = 512 rows of D = 768 into
// F = 3072, 16 groups) a launch does 2·M·D·F ≈ 39 G operations on
// ≈ 0.2 GB of float32 operands: bound by float32 operations, 0.577 ms at
// 67 TFLOP/s.  TF32 tensor cores are excluded on purpose: the reference
// contracts dense float32 in full precision, so every product is an IEEE
// float32 FFMA on the CUDA cores, summed in ascending k.  Between the FFMA
// units and that bound stands shared memory: an SM moves 128 bytes a clock
// from shared memory to registers, 32 floats against 128 FFMA.  The design:
//   * register tiles: a thread accumulates 8 × 8 outputs as 2 × 2
//     sub-tiles of 4 × 4, so each k costs 4 conflict-free 16-byte shared
//     loads (x broadcast over 8 lanes, the weights over 4) for 64 FFMA;
//     the fragments of k + 1 load while those of k are used;
//   * staging: the weights (F contiguous) stream through a ring of 4 slabs
//     of 16 k by 16-byte cp.async, 3 in flight while one is computed; x
//     (k contiguous) is loaded a slab ahead as 16-byte vectors and stored
//     k-major into one of two buffers; one barrier a slab;
//   * bf16 weights stage as bf16, half the bytes, and widen exactly (a
//     shift) as they are read;
//   * a narrow tile, 32 rows × 128 (128 threads of 4 × 8), serves widths
//     where 128-row tiles would idle (m = 1, the 154 text rows) or fill
//     less than one wave of two blocks an SM; the host picks the tile from
//     P, m and F.  Both tiles sum each output in the same order and give
//     the same bits, run to run too (no split-K);
//   * D or F off 16 bytes of alignment, or x or w off a 16-byte address,
//     stage the same tiles element by element in the same kernel.
// What holds it above the bound (PERF.md, chip_smoke on an NVIDIA H100
// 80GB HBM3, 700 W) is the shared-memory path: the 8 × 8 tile loads one
// float per 4 FFMA, as much as the path carries; an 8 × 16 tile halves
// that but leaves 8 warps an SM, and measured slower in a throwaway
// build, as did x staged row-major by cp.async and read 4 k at a time.
//
// Quantized bodies.  Against the int8 tensor-core peak (1979 TOP/s; the
// fp8 body contracts in bf16, 989 TFLOP/s) the same launch needs 20 µs
// (int8) or 39 µs (bf16) of operations, but it writes 0.1 GB of float32
// output of the 0.118 GB it must move: bound by the output bytes (35 µs
// at 3.35 TB/s) or, for bf16, about as much by operations.  The design
// keeps the tensor cores and the output stream busy at once:
//   * one template for both: int8 contracts on wgmma m64n128k32
//     .s32.s8.s8 (exact int32 sums); e4m3 is widened to bf16 as it is
//     staged and contracts on wgmma m64n128k16 .f32.bf16.bf16, because
//     e4m3 wgmma sums with too few bits for the fp8 tolerance (every
//     variant: ragged_gemm_fp8_variant below);
//   * 256 threads: two warpgroups of 64 rows each, every thread also a
//     loader; a ring of 3 stages of 32 KB in dynamic shared memory (A and
//     B tiles of 128 rows × 128 bytes of K, 128-byte swizzle, K-major),
//     slab t on the tensor cores while t + 1 is stored and t + 2 loaded;
//     3 × 32 KB + 1 KB lets two blocks share an SM, so one block's
//     epilogue overlaps the other's main loop;
//   * A (x, K-major already) moves by 16-byte cp.async (by 16-byte loads
//     when widened); B (the weights, F contiguous) must be K-major, and
//     8-bit wgmma has no transpose flag: each thread loads 4 columns of
//     16 K rows as 32-bit words, turns 4×4 byte blocks around with prmt
//     (__byte_perm) and stores one swizzled 16-byte chunk per column, so
//     the weights' (K, [L,] D, F) layout stays as the stores keep it;
//   * the epilogue scales the fragment in registers, stages the 128×128
//     float32 tile in shared memory and writes it out row by row, 16
//     bytes a thread, coalesced;
//   * D = 16 (the patch embedding) zero-fills the slab past D, F = 16 (the
//     final layer) masks the columns; D or F off 16-byte alignment, or an
//     x at an odd address, stage the same tiles byte by byte.
// Tile 128 × 128 with 128-byte slabs: the largest tile whose two 64-row
// accumulators (64 registers a thread) leave room for two blocks an SM;
// 3 stages is the fewest that keep one slab on the tensor cores while one
// is stored and one loaded.  What holds it above the bound on the H100 is
// the staging: each block waits on its own loads of the weights (16 KB of
// 32-bit words a slab); a warp-specialized, persistent form of the same
// ring (producer warpgroups, mbarriers) measured slower, with the loads
// as the limit again.

#include <atomic>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int BM = 128;   // rows per block tile (quantized bodies, wide)
constexpr int BN = 128;   // columns per block tile
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(int v) { return __int2float_rn(v); }

// Writes NaN over the block's tile; true when the group's expert is bad.
__device__ __forceinline__ bool poison_bad_expert(int e, int K, float* yg,
                                                  int rows, int col0, int F) {
  if (e >= 0 && e < K) return false;
  for (int i = threadIdx.x; i < rows * BN; i += blockDim.x) {
    const int r = i / BN, c = col0 + i % BN;
    if (c < F) yg[(int64_t)r * F + c] = nanf("");
  }
  return true;
}

// ---------------------------------------------------------------------------
// Dense bodies: float32 activations against float32 or bf16 weights, every
// product an IEEE float32 FFMA on the CUDA cores.

constexpr int DK = 16;           // depth of one slab
constexpr int D_STAGES = 4;      // weight slabs in the cp.async ring
constexpr int NARROW_BM = 32;    // rows of the narrow tile

// A thread owns MI × NI sub-tiles of 4 rows × 4 columns; a warp is 4 × 8
// threads.  Wide: 8 warps of 8 × 8 tiles cover 128 × 128; narrow: 4 warps
// of 4 × 8 tiles cover 32 × 128.  Shared memory: two k-major x buffers,
// then the ring of weight slabs.
template <typename WT, int BM_>
struct DenseTile {
  static constexpr bool WIDE = BM_ == BM;
  static constexpr int THREADS = WIDE ? 256 : 128;
  static constexpr int MIN_BLOCKS = WIDE ? 2 : 4;   // per SM
  static constexpr int MI = WIDE ? 2 : 1;
  static constexpr int NI = 2;
  static constexpr int WARPS_M = BM_ / (16 * MI);
  static constexpr int WARPS_N = THREADS / 32 / WARPS_M;
  static_assert(WARPS_N * 32 * NI == BN, "the warps cover the tile");
  static constexpr int AS = BM_ + 4;          // floats of a k-major x row
  static constexpr int A_FLOATS = DK * AS;
  static constexpr int B_BYTES = DK * BN * sizeof(WT);
  static constexpr int SMEM = 2 * A_FLOATS * 4 + D_STAGES * B_BYTES;
};

// Four bf16 (lowest first) widened exactly to float32.
__device__ __forceinline__ float4 widen_bf16x4(uint2 v) {
  return make_float4(__uint_as_float(v.x << 16),
                     __uint_as_float(v.x & 0xFFFF0000u),
                     __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xFFFF0000u));
}

// Fragments of one k: MI groups of 4 rows of a k-major x buffer, NI groups
// of 4 columns of a weight slab; and their 16·MI·NI products.
template <int MI, int AS>
__device__ __forceinline__ void load_a_frag(const float* as, int k, int am,
                                            float (&fa)[4 * MI]) {
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    const float4 v =
        *reinterpret_cast<const float4*>(as + k * AS + am + 16 * mi);
    fa[4 * mi] = v.x;
    fa[4 * mi + 1] = v.y;
    fa[4 * mi + 2] = v.z;
    fa[4 * mi + 3] = v.w;
  }
}

template <typename WT, int NI>
__device__ __forceinline__ void load_b_frag(const uint8_t* bs, int k, int bn,
                                            float (&fb)[4 * NI]) {
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) {
    const int at = k * BN + bn + 32 * ni;
    float4 v;
    if constexpr (sizeof(WT) == 4)
      v = *reinterpret_cast<const float4*>(
          reinterpret_cast<const float*>(bs) + at);
    else
      v = widen_bf16x4(*reinterpret_cast<const uint2*>(
          reinterpret_cast<const uint16_t*>(bs) + at));
    fb[4 * ni] = v.x;
    fb[4 * ni + 1] = v.y;
    fb[4 * ni + 2] = v.z;
    fb[4 * ni + 3] = v.w;
  }
}

template <int MI, int NI>
__device__ __forceinline__ void fma_tile(float (&acc)[4 * MI][4 * NI],
                                         const float (&fa)[4 * MI],
                                         const float (&fb)[4 * NI]) {
#pragma unroll
  for (int i = 0; i < 4 * MI; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NI; ++j) acc[i][j] = fmaf(fa[i], fb[j], acc[i][j]);
}

// y = x · w[e] for one BM × 128 tile of one group.
//   WT: float or __nv_bfloat16 (staged as bf16, widened as it is read).
//   BM: 128 (wide) or 32 (narrow, for widths where a 128-row tile idles).
//   VEC: D % 4 == 0, F a multiple of 16 bytes of weights, x and w 16-byte
//     aligned: x moves by 16-byte loads and w by 16-byte cp.async;
//     otherwise the same tiles are staged element by element.
// Each output element sums its D products in ascending k with fmaf, so
// every tile shape gives the same bits.
template <typename WT, int BM_, bool VEC>
__global__ void __launch_bounds__(DenseTile<WT, BM_>::THREADS,
                                  DenseTile<WT, BM_>::MIN_BLOCKS)
ragged_gemm_dense_kernel(const float* __restrict__ x,
                         const WT* __restrict__ w, const int* __restrict__ pe,
                         float* __restrict__ y, int m, int D, int F, int K,
                         long long w_expert_stride) {
  using Tile = DenseTile<WT, BM_>;
  constexpr int NT = Tile::THREADS, MI = Tile::MI, NI = Tile::NI;
  constexpr int AS = Tile::AS, A_FLOATS = Tile::A_FLOATS;
  constexpr int B_BYTES = Tile::B_BYTES;
  using WR = typename std::conditional<sizeof(WT) == 4, uint32_t,
                                       uint16_t>::type;  // raw weight bits
  constexpr int WV = 16 / sizeof(WT);          // weights per 16 bytes
  constexpr int B_CPR = BN / WV;               // 16-byte chunks per k row
  constexpr int NB = DK * B_CPR / NT;          // weight chunks per thread
  constexpr int NA = BM_ * DK / 4 / NT;        // x pieces per thread
  static_assert(DK == 16 && DK * B_CPR % NT == 0 && BM_ * DK % (4 * NT) == 0,
                "slabs split evenly over the threads");

  const int p = blockIdx.z;
  const int row0 = blockIdx.y * BM_;
  const int col0 = blockIdx.x * BN;
  const int rows = min(BM_, m - row0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const int64_t grow0 = (int64_t)p * m + row0;
  float* yg = y + grow0 * F;
  const int e = pe[p];
  if (poison_bad_expert(e, K, yg, rows, col0, F)) return;

  const float* xg = x + grow0 * D;
  const WT* we = w + (int64_t)e * w_expert_stride;

  extern __shared__ __align__(16) uint8_t dense_smem[];
  float* As = reinterpret_cast<float*>(dense_smem);      // 2 x buffers
  uint8_t* ring = dense_smem + 2 * A_FLOATS * 4;          // weight slabs

  // Weight slab t into ring stage t % D_STAGES; commits one cp.async group.
  auto issue = [&](int t) {
    const int k0 = t * DK;
    uint8_t* bs = ring + (t % D_STAGES) * B_BYTES;
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int idx = tid + NT * i;
      const int kr = idx / B_CPR, ch = idx % B_CPR;
      const int kk = k0 + kr, c = col0 + ch * WV;
      WR* dst = reinterpret_cast<WR*>(bs) + kr * BN + ch * WV;
      const WR* src = reinterpret_cast<const WR*>(we) + (int64_t)kk * F + c;
      if constexpr (VEC) {
        const bool ok = kk < D && c < F;
        hopper::cp_async16(hopper::smem_u32(dst),
                           ok ? src : reinterpret_cast<const WR*>(we),
                           ok ? 16 : 0);
      } else {
#pragma unroll
        for (int u = 0; u < WV; ++u)
          dst[u] = kk < D && c + u < F ? src[u] : WR(0);
      }
    }
    hopper::cp_async_commit();
  };

  // x slab t from global memory into registers (4 pieces of 4 floats a
  // row), then into a shared buffer as [k][row].
  float ra[NA][4];
  auto load_a = [&](int t) {
    const int k0 = t * DK;
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int idx = tid + NT * i;
      const int r = idx >> 2, kk = k0 + (idx & 3) * 4;
      const float* src = xg + (int64_t)r * D + kk;
      if constexpr (VEC) {
        const float4 v = r < rows && kk < D
                             ? __ldg(reinterpret_cast<const float4*>(src))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
        ra[i][0] = v.x;
        ra[i][1] = v.y;
        ra[i][2] = v.z;
        ra[i][3] = v.w;
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          ra[i][u] = r < rows && kk + u < D ? src[u] : 0.f;
      }
    }
  };
  auto store_a = [&](int buf) {
    float* as = As + buf * A_FLOATS;
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int idx = tid + NT * i;
      const int r = idx >> 2, kc = (idx & 3) * 4;
#pragma unroll
      for (int u = 0; u < 4; ++u) as[(kc + u) * AS + r] = ra[i][u];
    }
  };

  // Thread tile: rows am + 16·mi + (0..3), columns bn + 32·ni + (0..3).
  const int wm = warp / Tile::WARPS_N, wn = warp % Tile::WARPS_N;
  const int am = wm * 16 * MI + 4 * (lane >> 3);
  const int bn = wn * 32 * NI + 4 * (lane & 7);

  float acc[4 * MI][4 * NI];
#pragma unroll
  for (int i = 0; i < 4 * MI; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NI; ++j) acc[i][j] = 0.f;

  // One slab through the FFMA units, the fragments of k + 1 loaded while
  // those of k are used.
  auto compute = [&](const float* as, const uint8_t* bs) {
    float fa[2][4 * MI], fb[2][4 * NI];
    load_a_frag<MI, AS>(as, 0, am, fa[0]);
    load_b_frag<WT, NI>(bs, 0, bn, fb[0]);
#pragma unroll
    for (int k = 0; k < DK; ++k) {
      if (k + 1 < DK) {
        load_a_frag<MI, AS>(as, k + 1, am, fa[(k + 1) & 1]);
        load_b_frag<WT, NI>(bs, k + 1, bn, fb[(k + 1) & 1]);
      }
      fma_tile<MI, NI>(acc, fa[k & 1], fb[k & 1]);
    }
  };

  // Slab t is computed while slabs t + 1 .. t + D_STAGES − 1 of the weights
  // are in flight and x's slab t + 2 is loaded into registers (its slab
  // t + 1 waits in the other buffer); one barrier a slab.
  const int nk = max(1, (D + DK - 1) / DK);
#pragma unroll
  for (int s = 0; s < D_STAGES - 1; ++s) {
    if (s < nk) issue(s);
    else hopper::cp_async_commit();
  }
  load_a(0);
  store_a(0);
  if (nk > 1) load_a(1);
  for (int t = 0; t < nk; ++t) {
    hopper::cp_async_wait<D_STAGES - 2>();
    __syncthreads();
    if (t + D_STAGES - 1 < nk) issue(t + D_STAGES - 1);
    else hopper::cp_async_commit();
    // (the slab's address is taken before x's registers are stored: the
    // other order schedules measurably slower)
    const uint8_t* bs = ring + (t % D_STAGES) * B_BYTES;
    if (t + 1 < nk) {
      store_a((t + 1) & 1);
      if (t + 2 < nk) load_a(t + 2);
    }
    compute(As + (t & 1) * A_FLOATS, bs);
  }

  const bool vec_out = (F & 3) == 0;
#pragma unroll
  for (int i = 0; i < 4 * MI; ++i) {
    const int r = am + 16 * (i >> 2) + (i & 3);
    if (r >= rows) continue;
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const int c = col0 + bn + 32 * ni;
      float* dst = yg + (int64_t)r * F + c;
      if (vec_out && c + 3 < F) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[i][4 * ni], acc[i][4 * ni + 1],
                        acc[i][4 * ni + 2], acc[i][4 * ni + 3]);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (c + u < F) dst[u] = acc[i][4 * ni + u];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Quantized bodies on the tensor cores.

// What the tensor cores contract: int8, e4m3, or e4m3 widened to bf16
// while it is staged (exact: every e4m3 value is a bf16 value).
enum class Mma { kS8, kE4M3, kBF16 };

constexpr int STAGES = 3;
constexpr int TILE_BYTES = BM * 128;         // 128 rows × 128 bytes of K
constexpr int STAGE_BYTES = 2 * TILE_BYTES;  // A tile, then B tile
constexpr int TC_SMEM = STAGES * STAGE_BYTES + 1024;  // + alignment slack
constexpr int OUT_STRIDE = BN + 4;           // staged output row, floats
static_assert(BM * OUT_STRIDE * 4 <= STAGES * STAGE_BYTES,
              "the output tile is staged in the ring's memory");

// 4×4 byte transpose: word i of the input holds columns 0..3 of row i,
// word j of the output rows 0..3 of column j (lowest byte first).
__device__ __forceinline__ void transpose4x4(uint32_t a, uint32_t b,
                                             uint32_t c, uint32_t d,
                                             uint32_t (&out)[4]) {
  const uint32_t ab_lo = __byte_perm(a, b, 0x5140);  // a0 b0 a1 b1
  const uint32_t cd_lo = __byte_perm(c, d, 0x5140);  // c0 d0 c1 d1
  const uint32_t ab_hi = __byte_perm(a, b, 0x7362);  // a2 b2 a3 b3
  const uint32_t cd_hi = __byte_perm(c, d, 0x7362);  // c2 d2 c3 d3
  out[0] = __byte_perm(ab_lo, cd_lo, 0x5410);         // a0 b0 c0 d0
  out[1] = __byte_perm(ab_lo, cd_lo, 0x7632);         // a1 b1 c1 d1
  out[2] = __byte_perm(ab_hi, cd_hi, 0x5410);
  out[3] = __byte_perm(ab_hi, cd_hi, 0x7632);
}

// Four e4m3 bytes (lowest first) -> four bf16, two a word, lowest first.
// e4m3 -> f16 -> f32 -> bf16 is exact at every step (NaN stays NaN).
__device__ __forceinline__ uint2 e4m3x4_to_bf16x4(uint32_t v) {
  const __half2 lo = __half2(__nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(v & 0xFFFFu), __NV_E4M3));
  const __half2 hi = __half2(__nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(v >> 16), __NV_E4M3));
  const __nv_bfloat162 blo = __float22bfloat162_rn(__half22float2(lo));
  const __nv_bfloat162 bhi = __float22bfloat162_rn(__half22float2(hi));
  return make_uint2(*reinterpret_cast<const uint32_t*>(&blo),
                    *reinterpret_cast<const uint32_t*>(&bhi));
}

// y = (float(x·w) · xs[row]) · ws[e] on the tensor cores.
//   MMA: what the tensor cores contract.
//   PROMOTE (e4m3 only): 0 keeps the whole depth in the wgmma
//     accumulator; n > 0 starts a fresh accumulator every n instructions
//     (32 values of K each) and adds it into float32 registers.
//   VEC: D % 16 == 0, F % 4 == 0, x 16-byte and w 4-byte aligned, so A
//     moves by 16-byte cp.async (16-byte loads when widened) and B by
//     32-bit loads; otherwise both are staged byte by byte.
template <Mma MMA, int PROMOTE, bool VEC>
__device__ __forceinline__ void ragged_gemm_tc(
    const uint8_t* __restrict__ x, const uint8_t* __restrict__ w,
    const int* __restrict__ pe, const float* __restrict__ xs,
    const float* __restrict__ ws, float* __restrict__ y, int m, int D, int F,
    int K, long long w_expert_stride) {
  using Acc = typename std::conditional<MMA == Mma::kS8, int, float>::type;
  constexpr bool WIDEN = MMA == Mma::kBF16;
  constexpr int BK = WIDEN ? 64 : 128;  // K values of a slab (128 B a row)
  constexpr int KC = BK / 8;            // K values of a 16-byte chunk
  constexpr int NQ = BK / 16;           // 16-byte pieces of x per slab row
  constexpr int NA = BM * NQ / THREADS; // pieces of x per thread
  static_assert(PROMOTE == 0 || MMA == Mma::kE4M3, "promotion is e4m3's");

  const int p = blockIdx.z;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int rows = min(BM, m - row0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const int64_t grow0 = (int64_t)p * m + row0;
  float* yg = y + grow0 * F;
  const int e = pe[p];
  if (poison_bad_expert(e, K, yg, rows, col0, F)) return;

  const uint8_t* xg = x + grow0 * D;
  const uint8_t* we = w + (int64_t)e * w_expert_stride;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t s0 = hopper::smem_u32(smem);

  // A: the thread stages the 16 bytes of x at K 16·aq of rows
  // ar + (THREADS / NQ)·i: smem chunk aq, or chunks 2aq and 2aq + 1 when
  // widened to bf16.
  const int aq = tid % NQ, ar = tid / NQ;
  // B: the thread stages columns 4·bc .. 4·bc + 3 at K values KC·bk ..
  // KC·bk + KC − 1 of the slab.  A warp spans a whole row of the tile,
  // so each of its loads reads one full 128-byte line; it stores its four
  // columns starting at column `rot`, so that any 8 neighbouring lanes
  // store to 8 different swizzled chunks: all 32 banks.
  const int bc = lane, bk = warp;
  const int rot = (lane >> 1) & 3;
  const int bcol = col0 + 4 * bc;

  uint32_t ra[NA][4];  // x pieces staged through registers
  uint32_t rb[KC];     // rb[i]: 4 weight columns at K row KC·bk + i

  // Global -> registers (and cp.async -> shared) for slab t into `stage`;
  // always commits one cp.async group.
  auto issue = [&](int t, int stage) {
    const int k0 = t * BK;
    const uint32_t sa = s0 + stage * STAGE_BYTES;
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int r = ar + (THREADS / NQ) * i;
      const int kk = k0 + 16 * aq;
      const uint8_t* src = xg + (int64_t)r * D + kk;
      if constexpr (VEC) {
        const bool ok = r < rows && kk < D;  // the piece is in or out
        if constexpr (WIDEN) {
          const uint4 v = ok ? __ldg(reinterpret_cast<const uint4*>(src))
                             : make_uint4(0u, 0u, 0u, 0u);
          ra[i][0] = v.x;
          ra[i][1] = v.y;
          ra[i][2] = v.z;
          ra[i][3] = v.w;
        } else {
          hopper::cp_async16(sa + hopper::sw128(r, aq), ok ? src : x,
                             ok ? 16 : 0);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t word = 0;
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (r < rows && kk + 4 * j + b < D)
              word |= uint32_t(src[4 * j + b]) << (8 * b);
          ra[i][j] = word;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < KC; ++i) {
      const int kk = k0 + KC * bk + i;
      const uint8_t* src = we + (int64_t)kk * F + bcol;
      if constexpr (VEC) {
        rb[i] = (kk < D && bcol < F)
                    ? __ldg(reinterpret_cast<const unsigned int*>(src))
                    : 0u;
      } else {
        uint32_t word = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (kk < D && bcol + b < F) word |= uint32_t(src[b]) << (8 * b);
        rb[i] = word;
      }
    }
    hopper::cp_async_commit();
  };

  // Registers -> shared for the slab issued last into `stage`: x pieces
  // (unless cp.async moved them), and the weights turned K-major.
  auto store = [&](int stage) {
    const uint32_t sa = s0 + stage * STAGE_BYTES;
    const uint32_t sb = sa + TILE_BYTES;
    if constexpr (WIDEN || !VEC) {
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        const int r = ar + (THREADS / NQ) * i;
        if constexpr (WIDEN) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint2 lo = e4m3x4_to_bf16x4(ra[i][2 * h]);
            const uint2 hi = e4m3x4_to_bf16x4(ra[i][2 * h + 1]);
            hopper::st_shared_v4(sa + hopper::sw128(r, 2 * aq + h), lo.x,
                                 lo.y, hi.x, hi.y);
          }
        } else {
          hopper::st_shared_v4(sa + hopper::sw128(r, aq), ra[i][0], ra[i][1],
                               ra[i][2], ra[i][3]);
        }
      }
    }
    uint32_t col[4][KC / 4];  // col[j][b]: K values 4b..4b+3 of column j
#pragma unroll
    for (int b = 0; b < KC / 4; ++b) {
      uint32_t t[4];
      transpose4x4(rb[4 * b], rb[4 * b + 1], rb[4 * b + 2], rb[4 * b + 3], t);
#pragma unroll
      for (int j = 0; j < 4; ++j) col[j][b] = t[j];
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = (q + rot) & 3;
      uint32_t c[KC / 4];  // col[j], selected without indexing registers
#pragma unroll
      for (int b = 0; b < KC / 4; ++b)
        c[b] = j == 0 ? col[0][b] : j == 1 ? col[1][b]
             : j == 2 ? col[2][b] : col[3][b];
      const uint32_t dst = sb + hopper::sw128(4 * bc + j, bk);
      if constexpr (WIDEN) {
        const uint2 lo = e4m3x4_to_bf16x4(c[0]);
        const uint2 hi = e4m3x4_to_bf16x4(c[1]);
        hopper::st_shared_v4(dst, lo.x, lo.y, hi.x, hi.y);
      } else {
        hopper::st_shared_v4(dst, c[0], c[1], c[2], c[3]);
      }
    }
  };

  Acc acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = Acc(0);
  float part[PROMOTE ? 64 : 1];  // one promotion interval's partial sum

  // The slab in `stage` through the tensor cores: 4 instructions of 32
  // bytes of K, this warpgroup's 64 rows against all 128 columns.
  auto mma = [&](int stage) {
    const uint32_t sa = s0 + stage * STAGE_BYTES + (warp >> 2) * 64 * 128;
    const uint64_t da = hopper::sw128_desc(sa);
    const uint64_t db = hopper::sw128_desc(s0 + stage * STAGE_BYTES +
                                           TILE_BYTES);
    if constexpr (PROMOTE == 0) {
      hopper::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        if constexpr (MMA == Mma::kS8)
          hopper::wgmma_s8(acc, da + 2 * ks, db + 2 * ks, 1);
        else if constexpr (MMA == Mma::kE4M3)
          hopper::wgmma_e4m3(acc, da + 2 * ks, db + 2 * ks, 1);
        else
          hopper::wgmma_bf16(acc, da + 2 * ks, db + 2 * ks, 1);
      }
      hopper::wgmma_commit();
    } else {
#pragma unroll
      for (int ks = 0; ks < 4; ks += PROMOTE) {
        hopper::wgmma_fence();
#pragma unroll
        for (int u = 0; u < PROMOTE; ++u)
          hopper::wgmma_e4m3(part, da + 2 * (ks + u), db + 2 * (ks + u),
                             u > 0);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::reg_fence(part);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += part[i];
      }
    }
  };

  // Slab t is read by the tensor cores while slab t + 1 goes from
  // registers to shared memory and slab t + 2 from global memory to
  // registers (and by cp.async to shared memory).
  const int nk = max(1, (D + BK - 1) / BK);
  issue(0, 0);
  store(0);
  if (nk > 1) issue(1, 1); else hopper::cp_async_commit();
  hopper::cp_async_wait<1>();
  hopper::fence_proxy_async();
  __syncthreads();
  for (int t = 0; t < nk; ++t) {
    mma(t % STAGES);
    if (t + 1 < nk) store((t + 1) % STAGES);
    if (t + 2 < nk) issue(t + 2, (t + 2) % STAGES);
    else hopper::cp_async_commit();
    hopper::wgmma_wait<0>();
    hopper::cp_async_wait<1>();
    hopper::fence_proxy_async();
    __syncthreads();
  }
  hopper::reg_fence(acc);

  // Epilogue: scale in registers, stage the tile in shared memory (the
  // ring is free), write it out coalesced, 16 bytes a thread.
  float* so = reinterpret_cast<float*>(smem);
  {
    const float wsc = ws[e];
    const int r = (warp >> 2) * 64 + (warp & 3) * 16 + (lane >> 2);
    const float xs_lo = r < rows ? xs[grow0 + r] : 0.f;
    const float xs_hi = r + 8 < rows ? xs[grow0 + r + 8] : 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 8 * j + 2 * (lane & 3);
      *reinterpret_cast<float2*>(so + r * OUT_STRIDE + c) =
          make_float2((to_f32(acc[4 * j]) * xs_lo) * wsc,
                      (to_f32(acc[4 * j + 1]) * xs_lo) * wsc);
      *reinterpret_cast<float2*>(so + (r + 8) * OUT_STRIDE + c) =
          make_float2((to_f32(acc[4 * j + 2]) * xs_hi) * wsc,
                      (to_f32(acc[4 * j + 3]) * xs_hi) * wsc);
    }
  }
  __syncthreads();
  const bool vec_out = (F & 3) == 0;
  for (int i = tid; i < BM * (BN / 4); i += THREADS) {
    const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
    if (r >= rows) break;  // rows ascend with i
    const float4 v = *reinterpret_cast<const float4*>(so + r * OUT_STRIDE + c);
    const int gc = col0 + c;
    float* dst = yg + (int64_t)r * F + gc;
    if (vec_out && gc + 3 < F) {
      *reinterpret_cast<float4*>(dst) = v;
    } else {
      if (gc < F) dst[0] = v.x;
      if (gc + 1 < F) dst[1] = v.y;
      if (gc + 2 < F) dst[2] = v.z;
      if (gc + 3 < F) dst[3] = v.w;
    }
  }
}

// The two bodies under their own names (profiles tell them apart); two
// blocks an SM, one where promotion doubles the accumulator registers.
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
ragged_gemm_int8_kernel(const uint8_t* x, const uint8_t* w, const int* pe,
                        const float* xs, const float* ws, float* y, int m,
                        int D, int F, int K, long long w_expert_stride) {
  ragged_gemm_tc<Mma::kS8, 0, VEC>(x, w, pe, xs, ws, y, m, D, F, K,
                                   w_expert_stride);
}

template <Mma MMA, int PROMOTE, bool VEC>
__global__ void __launch_bounds__(THREADS, PROMOTE ? 1 : 2)
ragged_gemm_fp8_kernel(const uint8_t* x, const uint8_t* w, const int* pe,
                       const float* xs, const float* ws, float* y, int m,
                       int D, int F, int K, long long w_expert_stride) {
  ragged_gemm_tc<MMA, PROMOTE, VEC>(x, w, pe, xs, ws, y, m, D, F, K,
                                    w_expert_stride);
}

dim3 grid_of(int P, int m, int F) {
  return dim3((F + BN - 1) / BN, (m + BM - 1) / BM, P);
}

// The opt-in above 48 KB of shared memory holds per function and device,
// so each kernel asks once per device (a repeat is harmless).
constexpr int MAX_DEVICES = 64;

// Opts `kern` in to `bytes` of dynamic shared memory on the current device,
// once; `opted_in` is the kernel's own flag array.
cudaError_t opt_in_smem(const void* kern, int bytes,
                        std::atomic<bool> (&opted_in)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES || !opted_in[dev].load()) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES) opted_in[dev].store(true);
  }
  return cudaSuccess;
}

template <typename WT, int BM_, bool VEC>
int launch_dense_tile(const float* x, const WT* w, const int* pe, float* y,
                      int P, int m, int D, int F, int K,
                      long long w_expert_stride, cudaStream_t stream) {
  const auto kern = ragged_gemm_dense_kernel<WT, BM_, VEC>;
  constexpr int smem = DenseTile<WT, BM_>::SMEM;
  static std::atomic<bool> opted_in[MAX_DEVICES];
  const cudaError_t err =
      opt_in_smem(reinterpret_cast<const void*>(kern), smem, opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((F + BN - 1) / BN, (m + BM_ - 1) / BM_, P);
  kern<<<grid, DenseTile<WT, BM_>::THREADS, smem, stream>>>(
      x, w, pe, y, m, D, F, K, w_expert_stride);
  return static_cast<int>(cudaGetLastError());
}

// SMs of the current device (0 if it cannot be read), cached per device.
int sm_count() {
  static std::atomic<int> sms[MAX_DEVICES];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < MAX_DEVICES && sms[dev].load() > 0) return sms[dev].load();
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  if (dev < MAX_DEVICES) sms[dev].store(n);
  return n;
}

// The narrow tile serves groups of m rows where the wide tiles would idle:
// where a narrow row costs 1.2 wide rows and still wins on the rows left
// empty (6 · roundup(m, 32) < 5 · roundup(m, 128)), or where the wide
// tiles fill less than one wave of two blocks per SM.
bool narrow_rows(int P, int m, int F) {
  const int64_t wide_tiles = (m + BM - 1) / BM;
  const int64_t narrow = (m + NARROW_BM - 1) / NARROW_BM * (int64_t)NARROW_BM;
  const int64_t wide_blocks = P * wide_tiles * ((F + BN - 1) / BN);
  return 6 * narrow < 5 * wide_tiles * BM || wide_blocks < 2 * sm_count();
}

template <typename WT, bool VEC>
int launch_dense_vec(const float* x, const WT* w, const int* pe, float* y,
                     int P, int m, int D, int F, int K,
                     long long w_expert_stride, cudaStream_t stream) {
  return narrow_rows(P, m, F)
             ? launch_dense_tile<WT, NARROW_BM, VEC>(x, w, pe, y, P, m, D, F,
                                                     K, w_expert_stride,
                                                     stream)
             : launch_dense_tile<WT, BM, VEC>(x, w, pe, y, P, m, D, F, K,
                                              w_expert_stride, stream);
}

template <typename WT>
int launch_dense(const void* x, const void* w, const int* pe, float* y,
                 int P, int m, int D, int F, int K,
                 long long w_expert_stride, void* stream) {
  if (P <= 0 || m <= 0 || F <= 0) return static_cast<int>(cudaGetLastError());
  constexpr int WV = 16 / sizeof(WT);
  const bool vec = D % 4 == 0 && F % WV == 0 && w_expert_stride % WV == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const auto* xf = static_cast<const float*>(x);
  const auto* wt = static_cast<const WT*>(w);
  const auto st = static_cast<cudaStream_t>(stream);
  return vec ? launch_dense_vec<WT, true>(xf, wt, pe, y, P, m, D, F, K,
                                          w_expert_stride, st)
             : launch_dense_vec<WT, false>(xf, wt, pe, y, P, m, D, F, K,
                                           w_expert_stride, st);
}

template <Mma MMA, int PROMOTE, bool VEC>
int launch_tc(const void* x, const void* w, const int* pe, const float* xs,
              const float* ws, float* y, int P, int m, int D, int F, int K,
              long long w_expert_stride, void* stream) {
  void (*kern)(const uint8_t*, const uint8_t*, const int*, const float*,
               const float*, float*, int, int, int, int, long long);
  if constexpr (MMA == Mma::kS8)
    kern = ragged_gemm_int8_kernel<VEC>;
  else
    kern = ragged_gemm_fp8_kernel<MMA, PROMOTE, VEC>;
  static std::atomic<bool> opted_in[MAX_DEVICES];
  const cudaError_t err =
      opt_in_smem(reinterpret_cast<const void*>(kern), TC_SMEM, opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid_of(P, m, F), THREADS, TC_SMEM,
         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(w), pe, xs,
      ws, y, m, D, F, K, w_expert_stride);
  return static_cast<int>(cudaGetLastError());
}

bool vec_operands(const void* x, const void* w, int D, int F,
                  long long w_expert_stride) {
  return D % 16 == 0 && F % 4 == 0 && w_expert_stride % 4 == 0 &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(w) % 4 == 0;
}

template <Mma MMA, int PROMOTE>
int launch_quant(const void* x, const void* w, const int* pe,
                 const float* xs, const float* ws, float* y, int P, int m,
                 int D, int F, int K, long long w_expert_stride,
                 void* stream) {
  if (P <= 0 || m <= 0 || F <= 0) return static_cast<int>(cudaGetLastError());
  return vec_operands(x, w, D, F, w_expert_stride)
             ? launch_tc<MMA, PROMOTE, true>(x, w, pe, xs, ws, y, P, m, D, F,
                                             K, w_expert_stride, stream)
             : launch_tc<MMA, PROMOTE, false>(x, w, pe, xs, ws, y, P, m, D,
                                              F, K, w_expert_stride, stream);
}

}  // namespace

// Common layout: x (P*m, D) row-major; w: K expert matrices (D, F)
// row-major, expert e at w + e*w_expert_stride elements; pe (P,) int32;
// y (P*m, F) float32; xs (P*m,) and ws (K,) float32 scales of the
// quantized bodies.  Each launches on `stream`, allocates nothing, and
// returns cudaGetLastError().
extern "C" int ragged_gemm_f32(const float* x, const float* w, const int* pe,
                               float* y, int P, int m, int D, int F, int K,
                               long long w_expert_stride, void* stream) {
  return launch_dense<float>(x, w, pe, y, P, m, D, F, K, w_expert_stride,
                             stream);
}

// Rows of the dense bodies' block tile for P groups of m rows into F
// columns on the current device: 128 (wide) or 32 (narrow).
extern "C" int ragged_gemm_dense_tile_rows(int P, int m, int F) {
  return narrow_rows(P, m, F) ? NARROW_BM : BM;
}

// float32 activations, bf16 weights.
extern "C" int ragged_gemm_bf16(const float* x, const void* w, const int* pe,
                                float* y, int P, int m, int D, int F, int K,
                                long long w_expert_stride, void* stream) {
  return launch_dense<__nv_bfloat16>(x, w, pe, y, P, m, D, F, K,
                                     w_expert_stride, stream);
}

// int8 activations and weights.
extern "C" int ragged_gemm_int8(const void* x, const void* w, const int* pe,
                                const float* xs, const float* ws, float* y,
                                int P, int m, int D, int F, int K,
                                long long w_expert_stride, void* stream) {
  return launch_quant<Mma::kS8, 0>(x, w, pe, xs, ws, y, P, m, D, F, K,
                                   w_expert_stride, stream);
}

// e4m3 activations and weights, widened to bf16 (variant 3 below).
extern "C" int ragged_gemm_fp8(const void* x, const void* w, const int* pe,
                               const float* xs, const float* ws, float* y,
                               int P, int m, int D, int F, int K,
                               long long w_expert_stride, void* stream) {
  return launch_quant<Mma::kBF16, 0>(x, w, pe, xs, ws, y, P, m, D, F, K,
                                     w_expert_stride, stream);
}

// The e4m3 body through each way of contracting it, for measuring their
// error side by side (Hopper's e4m3 wgmma sums with fewer bits than
// float32; only variant 3 meets the fp8 tolerance, so it is the served
// body):
//   0  e4m3 wgmma, the whole depth in the tensor core's accumulator;
//   1  e4m3 wgmma, promoted into float32 registers every 128 values of K;
//   2  e4m3 wgmma, promoted after every instruction (32 values of K);
//   3  e4m3 widened to bf16 while staged, bf16 wgmma (float32 sums).
// The operands must take the 16-byte path (cudaErrorInvalidValue
// otherwise).
extern "C" int ragged_gemm_fp8_variant(const void* x, const void* w,
                                       const int* pe, const float* xs,
                                       const float* ws, float* y, int P,
                                       int m, int D, int F, int K,
                                       long long w_expert_stride,
                                       void* stream, int variant) {
  if (!vec_operands(x, w, D, F, w_expert_stride))
    return static_cast<int>(cudaErrorInvalidValue);
  if (P <= 0 || m <= 0 || F <= 0) return static_cast<int>(cudaGetLastError());
  switch (variant) {
    case 0:
      return launch_tc<Mma::kE4M3, 0, true>(x, w, pe, xs, ws, y, P, m, D, F,
                                            K, w_expert_stride, stream);
    case 1:
      return launch_tc<Mma::kE4M3, 4, true>(x, w, pe, xs, ws, y, P, m, D, F,
                                            K, w_expert_stride, stream);
    case 2:
      return launch_tc<Mma::kE4M3, 1, true>(x, w, pe, xs, ws, y, P, m, D, F,
                                            K, w_expert_stride, stream);
    case 3:
      return launch_tc<Mma::kBF16, 0, true>(x, w, pe, xs, ws, y, P, m, D, F,
                                            K, w_expert_stride, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
