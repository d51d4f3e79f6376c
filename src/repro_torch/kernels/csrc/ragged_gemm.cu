// Ragged grouped expert GEMM, float32, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ragged_gemm.py:73 `ragged_gemm`
// (its dense float32 body; the int8/fp8 body is still to port).
//
// Computes y[p*m + r, :] = x[p*m + r, :] @ w[pe[p]] for P row groups of m
// rows each: every routed (sample, slot) pair of the serving step is one
// group, contracting against its own expert's stacked (D, F) weight.
//
// What bounds it on this card: at the serving shapes (m = 512 rows of
// D = 768 into F = 3072, 16 groups) a launch does 2·M·D·F ≈ 39 GFLOP on
// ≈ 0.2 GB of operands — about 200 FLOP per byte, far above the ~20 FLOP
// per byte where float32 CUDA-core math (67 TFLOP/s) overtakes HBM
// (3.35 TB/s).  So it is bound by float32 operations.  TF32 tensor cores
// are excluded on purpose: the reference contracts dense float32 in full
// precision, and TF32 keeps only ~3 decimal digits.  The m = 1 layers
// (timestep and modulation MLPs) are the exception: they read a whole
// expert weight per row and are bound by bytes.
//
// Design: a classic shared-memory-tiled SGEMM.  Grid (F/128, m/128, P):
// each block owns one 128×128 output tile of one group, so it has exactly
// one expert and never branches on expert ids; ragged row and column
// edges are masked (zero-filled loads, guarded stores), so every m
// — 1, 154, 256, 512 — goes through the same kernel.  256 threads each
// accumulate an 8×8 register micro-tile over K-slabs of 8; the next
// slab's global loads are issued into registers before the current slab
// is consumed, hiding part of the load latency.  Full FP32 FMA, no
// tensor cores.  An out-of-range expert id writes NaN rows instead of
// reading outside the weight stack.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;   // rows per block tile
constexpr int BN = 128;   // columns per block tile
constexpr int BK = 8;     // depth of one shared-memory slab
constexpr int TM = 8;     // rows per thread
constexpr int TN = 8;     // columns per thread
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
ragged_gemm_f32_kernel(const float* __restrict__ x,
                       const float* __restrict__ w,
                       const int* __restrict__ pe,
                       float* __restrict__ y,
                       int m, int D, int F, int K, long long w_expert_stride) {
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

  if (e < 0 || e >= K) {                     // bad expert id: poison rows
    for (int i = tid; i < rows * BN; i += THREADS) {
      const int r = i / BN, c = col0 + i % BN;
      if (c < F) yg[(int64_t)r * F + c] = nanf("");
    }
    return;
  }

  const float* xg = x + grow0 * D;
  const float* we = w + (int64_t)e * w_expert_stride;

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
      a_reg[i] = (a_row < rows && kk < D) ? xg[(int64_t)a_row * D + kk] : 0.f;
    }
    const int kb = k0 + b_k;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = col0 + b_col + i;
      b_reg[i] = (kb < D && c < F) ? we[(int64_t)kb * F + c] : 0.f;
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

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty * TM + i;
    if (r >= rows) break;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx * TN + j;
      if (c < F) yg[(int64_t)r * F + c] = acc[i][j];
    }
  }
}

}  // namespace

// x (P*m, D) row-major; w: K expert matrices (D, F) row-major, expert e at
// w + e*w_expert_stride; pe (P,) int32; y (P*m, F).  Launches on `stream`,
// allocates nothing, and returns cudaGetLastError().
extern "C" int ragged_gemm_f32(const float* x, const float* w, const int* pe,
                               float* y, int P, int m, int D, int F, int K,
                               long long w_expert_stride, void* stream) {
  if (P > 0 && m > 0 && F > 0) {
    const dim3 grid((F + BN - 1) / BN, (m + BM - 1) / BM, P);
    ragged_gemm_f32_kernel<<<grid, THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        x, w, pe, y, m, D, F, K, w_expert_stride);
  }
  return static_cast<int>(cudaGetLastError());
}
