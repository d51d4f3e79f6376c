// Flash attention for Hopper (sm_90a): online-softmax attention over equal
// q and kv lengths, float32 accumulation, optional causal and
// sliding-window masks, grouped kv heads.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:82
// `flash_attention` (body `_flash_kernel`, :28).  For each (batch, head)
// and query row:
//
//   s_j = (q · k_j) · scale,  masked where kpos > qpos (causal) or
//                              qpos − kpos ≥ window (window > 0)
//   out = Σ_j softmax(s)_j · v_j          in q's dtype
//
// q, k, v and out are addressed by (batch, head, position) element
// strides with a contiguous last axis, so the DiT's (B, S, H, D)
// projections are read as a (B, H, S, D) view without a transposed copy.
// Query head h reads kv head h / (H / Hkv) (the GQA front end without
// repeating k and v).
//
// What bounds it on this card: float32 operations.  At the DiT's
// self-attention shape (32 sequences × 12 heads, S 256, D 64) a launch
// does 4·S²·D per head = 6.4 GFLOP on 100 MB of operands, ~64 FLOP per
// byte, above the ~20 FLOP per byte where float32 CUDA-core math
// (67 TFLOP/s) overtakes HBM (3.35 TB/s).  Tensor cores (TF32 or bf16)
// are excluded on purpose: the reference accumulates in full float32.
//
// Design (a plain, correct body — no wgmma, no TMA): one block of 256
// threads per (batch·head, 64-row query tile).  The query tile, then each
// 64-row k and v tile, is converted to float32 and staged in shared
// memory with rows padded to D + 1 floats (conflict-free column reads).
// Thread (ty, tx) of the 16 × 16 grid owns query rows 4·ty…4·ty+3: it
// computes the logits of key columns tx + 16j, reduces the row maximum
// and sum over its 16-lane half-warp with shuffles, rescales its
// accumulators (output columns tx + 16c) by exp(m_old − m_new), writes
// the probabilities to shared memory and adds P·V.  Only the kv tiles a
// mask leaves partly open are visited (causal and window bounds per
// query tile); every other masked logit is dropped exactly (probability
// 0).  Partial tiles (S not a multiple of 64) are masked.  The output is
// acc / max(l, 1e-30), as the TPU kernel finalises it.  expf and IEEE
// division: no fast-math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;           // query rows per block
constexpr int BK = 64;           // kv rows per tile
constexpr int THREADS = 256;     // 16 × 16
constexpr int RQ = BQ / 16;      // query rows per thread
constexpr int RK = BK / 16;      // key columns per thread
constexpr int PP = BK + 1;       // padded row of the probability tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float* o, float v) { *o = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* o, float v) {
  *o = __float2bfloat16_rn(v);
}

// Reductions over the 16 lanes of a half-warp (one query row's owners).
__device__ __forceinline__ float half_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct Strides {
  int64_t b, h, s;
};

// Stage rows [row0, row0 + 64) of one head as float32, rows past S zeroed.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int64_t ss, int row0, int S, int D,
                                      int DP) {
  for (int i = threadIdx.x; i < 64 * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const int pos = row0 + r;
    dst[r * DP + c] = pos < S ? to_f32(src[(int64_t)pos * ss + c]) : 0.f;
  }
}

// DMAX: a multiple of 16 at least D (output columns per thread DMAX / 16).
template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int H,
                       int group, int S, int D, Strides sq, Strides sk,
                       Strides sv, Strides so, int causal, int window,
                       float scale) {
  constexpr int RC = DMAX / 16;
  extern __shared__ float smem[];
  const int DP = D + 1;
  float* Qs = smem;                // BQ × DP
  float* Ks = Qs + BQ * DP;        // BK × DP
  float* Vs = Ks + BK * DP;        // BK × DP
  float* Ps = Vs + BK * DP;        // BQ × PP

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H, hk = h / group;
  const int q0 = blockIdx.x * BQ;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  const T* qh = q + b * sq.b + h * sq.h;
  const T* kh = k + b * sk.b + hk * sk.h;
  const T* vh = v + b * sv.b + hk * sv.h;
  stage(Qs, qh, sq.s, q0, S, D, DP);

  // kv range this query tile can see: [lo, hi).
  int hi = S;
  if (causal) hi = min(S, q0 + BQ);
  int lo = 0;
  if (window > 0) lo = max(0, q0 - (window - 1));
  lo = (lo / BK) * BK;

  float m[RQ], l[RQ], acc[RQ][RC];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < RC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = lo; k0 < hi; k0 += BK) {
    __syncthreads();               // the previous tile is consumed
    stage(Ks, kh, sk.s, k0, S, D, DP);
    stage(Vs, vh, sv.s, k0, S, D, DP);
    __syncthreads();

    float s[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[RQ], kv[RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qv[i] = Qs[(ty * RQ + i) * DP + d];
#pragma unroll
      for (int j = 0; j < RK; ++j) kv[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qpos = q0 + ty * RQ + i;
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool open = kpos < S && (!causal || kpos <= qpos) &&
                          (window <= 0 || qpos - kpos < window);
        s[i][j] = open ? s[i][j] * scale : -INFINITY;
        tmax = fmaxf(tmax, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_max(tmax));
      // a row with nothing open yet keeps m = -inf and adds nothing
      const float alpha = m_new == -INFINITY ? 1.f : expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_new);
        Ps[(ty * RQ + i) * PP + tx + 16 * j] = p;
        rsum += p;
      }
      l[i] = l[i] * alpha + half_sum(rsum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < RC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    for (int kk = 0; kk < BK; ++kk) {
      float pv[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pv[i] = Ps[(ty * RQ + i) * PP + kk];
#pragma unroll
      for (int c = 0; c < RC; ++c) {
        const int col = tx + 16 * c;
        const float vv = col < D ? Vs[kk * DP + col] : 0.f;
#pragma unroll
        for (int i = 0; i < RQ; ++i) acc[i][c] += pv[i] * vv;
      }
    }
  }

  T* oh = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qpos = q0 + ty * RQ + i;
    if (qpos >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < RC; ++c) {
      const int col = tx + 16 * c;
      if (col < D)
        from_f32(oh + (int64_t)qpos * so.s + col, acc[i][c] / denom);
    }
  }
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int Hkv, int S, int D, Strides sq, Strides sk, Strides sv,
           Strides so, int causal, int window, float scale,
           cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(BQ + 2 * BK) * (D + 1) + (size_t)BQ * PP);
  auto kern = flash_attention_kernel<T, DMAX>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, H / Hkv, S, D, sq, sk,
      sv, so, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_width(const void* q, const void* k, const void* v, void* o, int B,
             int H, int Hkv, int S, int D, Strides sq, Strides sk, Strides sv,
             Strides so, int causal, int window, float scale,
             cudaStream_t st) {
  if (D <= 32)
    return launch<T, 32>(q, k, v, o, B, H, Hkv, S, D, sq, sk, sv, so, causal,
                         window, scale, st);
  if (D <= 64)
    return launch<T, 64>(q, k, v, o, B, H, Hkv, S, D, sq, sk, sv, so, causal,
                         window, scale, st);
  if (D <= 128)
    return launch<T, 128>(q, k, v, o, B, H, Hkv, S, D, sq, sk, sv, so,
                          causal, window, scale, st);
  return launch<T, 256>(q, k, v, o, B, H, Hkv, S, D, sq, sk, sv, so, causal,
                        window, scale, st);
}

}  // namespace

// q, o: (B, H, S, D); k, v: (B, Hkv, S, D) with H % Hkv == 0; each by
// element strides (batch, head, position) with a contiguous last axis;
// all float32 (bf16 = 0) or all bf16 (bf16 = 1).  D ≤ 256, B·H ≤ 65,535.
// window ≤ 0 means no window.  Launches on `stream`, allocates nothing,
// returns the CUDA error code (0 on success).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int bf16, int B, int H, int Hkv,
                               int S, int D, long long sqb, long long sqh,
                               long long sqs, long long skb, long long skh,
                               long long sks, long long svb, long long svh,
                               long long svs, long long sob, long long soh,
                               long long sos, int causal, int window,
                               float scale, void* stream) {
  if (B == 0 || H == 0 || S == 0 || D == 0) return 0;
  const Strides sq{sqb, sqh, sqs}, sk{skb, skh, sks}, sv{svb, svh, svs},
      so{sob, soh, sos};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return by_width<__nv_bfloat16>(q, k, v, o, B, H, Hkv, S, D, sq, sk, sv,
                                   so, causal, window, scale, st);
  return by_width<float>(q, k, v, o, B, H, Hkv, S, D, sq, sk, sv, so, causal,
                         window, scale, st);
}
