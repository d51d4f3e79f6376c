// Ragged grouped expert GEMM for Hopper (sm_90a): dense (float32 or bf16
// weights), fp8 e4m3 and int8 bodies.
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
// with per-row activation scales xs and per-expert weight scales ws.
//
// What bounds it on this card: at the serving shapes (m = 512 rows of
// D = 768 into F = 3072, 16 groups) a launch does 2·M·D·F ≈ 39 G
// operations.  Dense: on ≈ 0.2 GB of float32 operands, ~200 FLOP per byte,
// far above the ~20 FLOP per byte where float32 CUDA-core math (67 TFLOP/s)
// overtakes HBM (3.35 TB/s), so it is bound by float32 operations.  TF32
// tensor cores are excluded on purpose: the reference contracts dense
// float32 in full precision.  int8/fp8: against the 1979 TOP/s int8/fp8
// tensor-core peak the same launch is bound by its float32 output bytes
// (0.1 GB, ~30 µs); these bodies do not reach the tensor cores yet
// (int8 runs __dp4a on the CUDA cores, fp8 float32 FMA), so they are
// bound by those instruction rates.  The m = 1 layers are bound by bytes.
//
// Design: shared-memory-tiled GEMM.  Grid (F/128, m/128, P): each block
// owns one 128×128 output tile of one group, so it has exactly one expert
// and never branches on expert ids; ragged row, column and depth edges
// are masked (zero-filled loads, guarded stores), so every m — 1, 154,
// 256, 512 — and any D goes through the same kernel.  256 threads each
// accumulate an 8×8 register micro-tile; the next slab's global loads go
// into registers before the current slab is consumed.
//   * dense/fp8 body: one template, operands converted to float32 on load
//     (bf16 and e4m3 convert exactly), K-slabs of 8, float32 FMA.
//   * int8 body: K-slabs of 32, packed four deep per 32-bit word in shared
//     memory, int32 accumulation with __dp4a (exact).
// An out-of-range expert id writes NaN rows instead of reading outside
// the weight stack.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;   // rows per block tile
constexpr int BN = 128;   // columns per block tile
constexpr int TM = 8;     // rows per thread
constexpr int TN = 8;     // columns per thread
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 v) {
  return static_cast<float>(v);
}

// Writes NaN over the block's tile; true when the group's expert is bad.
__device__ __forceinline__ bool poison_bad_expert(int e, int K, float* yg,
                                                  int rows, int col0, int F) {
  if (e >= 0 && e < K) return false;
  for (int i = threadIdx.x; i < rows * BN; i += THREADS) {
    const int r = i / BN, c = col0 + i % BN;
    if (c < F) yg[(int64_t)r * F + c] = nanf("");
  }
  return true;
}

// Dense (XT = float, WT = float or bf16) and fp8 (XT = WT = e4m3, SCALED)
// bodies: operands become float32 on load, float32 FMA accumulation.
template <typename XT, typename WT, bool SCALED>
__global__ void __launch_bounds__(THREADS)
ragged_gemm_f32acc_kernel(const XT* __restrict__ x, const WT* __restrict__ w,
                          const int* __restrict__ pe,
                          const float* __restrict__ xs,
                          const float* __restrict__ ws, float* __restrict__ y,
                          int m, int D, int F, int K,
                          long long w_expert_stride) {
  constexpr int BK = 8;                      // depth of one slab
  const int p = blockIdx.z;
  const int row0 = blockIdx.y * BM;          // first row of the tile, in-group
  const int col0 = blockIdx.x * BN;
  const int rows = min(BM, m - row0);        // valid rows of this tile
  const int tid = threadIdx.x;
  const int tx = tid & 15;                   // column group of the thread
  const int ty = tid >> 4;                   // row group of the thread

  const int64_t grow0 = (int64_t)p * m + row0;
  float* yg = y + grow0 * F;
  const int e = pe[p];
  if (poison_bad_expert(e, K, yg, rows, col0, F)) return;

  const XT* xg = x + grow0 * D;
  const WT* we = w + (int64_t)e * w_expert_stride;

  __shared__ float As[BK][BM];               // A slab, k-major (transposed)
  __shared__ float Bs[BK][BN];

  // Global-load mapping: A slab is 128 rows × 8 k, B slab 8 k × 128 cols;
  // each thread moves 4 elements of each.
  const int a_row = tid >> 1;
  const int a_k = (tid & 1) * 4;
  const int b_k = tid >> 5;
  const int b_col = (tid & 31) * 4;

  float a_reg[4], b_reg[4];
  auto load_slab = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kk = k0 + a_k + i;
      a_reg[i] = (a_row < rows && kk < D)
                     ? to_f32(xg[(int64_t)a_row * D + kk]) : 0.f;
    }
    const int kb = k0 + b_k;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = col0 + b_col + i;
      b_reg[i] = (kb < D && c < F) ? to_f32(we[(int64_t)kb * F + c]) : 0.f;
    }
  };
  auto store_slab = [&]() {
#pragma unroll
    for (int i = 0; i < 4; ++i) As[a_k + i][a_row] = a_reg[i];
#pragma unroll
    for (int i = 0; i < 4; ++i) Bs[b_k][b_col + i] = b_reg[i];
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  load_slab(0);
  store_slab();
  __syncthreads();
  for (int k0 = 0; k0 < D; k0 += BK) {
    const bool more = k0 + BK < D;
    if (more) load_slab(k0 + BK);            // in flight during the math
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
    if (more) {
      store_slab();
      __syncthreads();
    }
  }

  const float wsc = SCALED ? ws[e] : 1.f;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty * TM + i;
    if (r >= rows) break;
    const float xsc = SCALED ? xs[grow0 + r] : 1.f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx * TN + j;
      if (c >= F) continue;
      yg[(int64_t)r * F + c] = SCALED ? (acc[i][j] * xsc) * wsc : acc[i][j];
    }
  }
}

// int8 body: x (P*m, D) int8, w int8, exact int32 accumulation with
// __dp4a over k packed four deep (byte j of a word holds k = 4·pack + j),
// then the float32 dequant epilogue.  vec_a: D % 16 == 0 and x 16-byte
// aligned, so a thread's 16 A bytes load as one int4.
__global__ void __launch_bounds__(THREADS)
ragged_gemm_int8_kernel(const int8_t* __restrict__ x,
                        const int8_t* __restrict__ w,
                        const int* __restrict__ pe,
                        const float* __restrict__ xs,
                        const float* __restrict__ ws, float* __restrict__ y,
                        int m, int D, int F, int K, long long w_expert_stride,
                        int vec_a) {
  constexpr int BK = 32;                     // depth of one slab
  constexpr int BKP = BK / 4;                // 32-bit packs per slab
  const int p = blockIdx.z;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int rows = min(BM, m - row0);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  const int64_t grow0 = (int64_t)p * m + row0;
  float* yg = y + grow0 * F;
  const int e = pe[p];
  if (poison_bad_expert(e, K, yg, rows, col0, F)) return;

  const int8_t* xg = x + grow0 * D;
  const int8_t* we = w + (int64_t)e * w_expert_stride;

  __shared__ int As[BKP][BM];                // packs of 4 k, k-major
  __shared__ int Bs[BKP][BN];

  // A slab: 128 rows × 32 k; a thread moves 16 k of one row (4 packs).
  // B slab: 32 k × 128 cols; a thread moves 16 k of one column (4 packs).
  const int a_row = tid >> 1;
  const int a_k = (tid & 1) * 16;
  const int b_col = tid & (BN - 1);
  const int b_p0 = (tid >> 7) * 4;

  int a_reg[4], b_reg[4];
  auto load_slab = [&](int k0) {
    if (vec_a) {
      int4 v = make_int4(0, 0, 0, 0);
      if (a_row < rows && k0 + a_k < D)
        v = *reinterpret_cast<const int4*>(xg + (int64_t)a_row * D + k0 + a_k);
      a_reg[0] = v.x; a_reg[1] = v.y; a_reg[2] = v.z; a_reg[3] = v.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t pack = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kk = k0 + a_k + 4 * i + j;
          const uint32_t v = (a_row < rows && kk < D)
              ? (uint8_t)xg[(int64_t)a_row * D + kk] : 0u;
          pack |= v << (8 * j);
        }
        a_reg[i] = (int)pack;
      }
    }
    const int c = col0 + b_col;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t pack = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kk = k0 + 4 * (b_p0 + i) + j;
        const uint32_t v = (kk < D && c < F)
            ? (uint8_t)we[(int64_t)kk * F + c] : 0u;
        pack |= v << (8 * j);
      }
      b_reg[i] = (int)pack;
    }
  };
  auto store_slab = [&]() {
#pragma unroll
    for (int i = 0; i < 4; ++i) As[a_k / 4 + i][a_row] = a_reg[i];
#pragma unroll
    for (int i = 0; i < 4; ++i) Bs[b_p0 + i][b_col] = b_reg[i];
  };

  int acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  load_slab(0);
  store_slab();
  __syncthreads();
  for (int k0 = 0; k0 < D; k0 += BK) {
    const bool more = k0 + BK < D;
    if (more) load_slab(k0 + BK);
#pragma unroll
    for (int kp = 0; kp < BKP; ++kp) {
      int a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kp][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kp][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
    if (more) {
      store_slab();
      __syncthreads();
    }
  }

  const float wsc = ws[e];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty * TM + i;
    if (r >= rows) break;
    const float xsc = xs[grow0 + r];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx * TN + j;
      if (c >= F) continue;
      yg[(int64_t)r * F + c] = (__int2float_rn(acc[i][j]) * xsc) * wsc;
    }
  }
}

dim3 grid_of(int P, int m, int F) {
  return dim3((F + BN - 1) / BN, (m + BM - 1) / BM, P);
}

template <typename XT, typename WT, bool SCALED>
int launch_f32acc(const void* x, const void* w, const int* pe,
                  const float* xs, const float* ws, float* y, int P, int m,
                  int D, int F, int K, long long w_expert_stride,
                  void* stream) {
  if (P > 0 && m > 0 && F > 0) {
    ragged_gemm_f32acc_kernel<XT, WT, SCALED>
        <<<grid_of(P, m, F), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const XT*>(x), static_cast<const WT*>(w), pe, xs, ws,
            y, m, D, F, K, w_expert_stride);
  }
  return static_cast<int>(cudaGetLastError());
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
  return launch_f32acc<float, float, false>(x, w, pe, nullptr, nullptr, y, P,
                                            m, D, F, K, w_expert_stride,
                                            stream);
}

// float32 activations, bf16 weights.
extern "C" int ragged_gemm_bf16(const float* x, const void* w, const int* pe,
                                float* y, int P, int m, int D, int F, int K,
                                long long w_expert_stride, void* stream) {
  return launch_f32acc<float, __nv_bfloat16, false>(
      x, w, pe, nullptr, nullptr, y, P, m, D, F, K, w_expert_stride, stream);
}

// e4m3 activations and weights.
extern "C" int ragged_gemm_fp8(const void* x, const void* w, const int* pe,
                               const float* xs, const float* ws, float* y,
                               int P, int m, int D, int F, int K,
                               long long w_expert_stride, void* stream) {
  return launch_f32acc<__nv_fp8_e4m3, __nv_fp8_e4m3, true>(
      x, w, pe, xs, ws, y, P, m, D, F, K, w_expert_stride, stream);
}

// int8 activations and weights.
extern "C" int ragged_gemm_int8(const void* x, const void* w, const int* pe,
                                const float* xs, const float* ws, float* y,
                                int P, int m, int D, int F, int K,
                                long long w_expert_stride, void* stream) {
  if (P > 0 && m > 0 && F > 0) {
    const int vec_a = (D % 16 == 0) &&
                      (reinterpret_cast<uintptr_t>(x) % 16 == 0);
    ragged_gemm_int8_kernel<<<grid_of(P, m, F), THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), pe, xs,
        ws, y, m, D, F, K, w_expert_stride, vec_a);
  }
  return static_cast<int>(cudaGetLastError());
}
