// Fused AdaLN modulation for Hopper (sm_90a): out = LN(x)·(1+γ)+β.
//
// Replaces the TPU kernel repro/kernels/adaln_fuse.py:34 `adaln_fuse`
// (body `_adaln_kernel`, :22): LayerNorm over the last axis without
// affine (population variance, eps, statistics in float32), modulated by
// per-batch-row γ and β, written in x's dtype.  It is the DiT's
// AdaLN-Single modulation (paper Eqs. 17/19), run at every modulate site
// of every block and at the final layer; with γ = β = 0 (null pointers)
// it is the DiT's plain LayerNorm before cross-attention.
//
// Rows are addressed as (b, g, s) with separate element strides, so the
// ragged forward's (P, g, T, d) replica view — a broadcast of (P, T, d)
// with stride 0 on g — is read as it is, without a copy; γ and β are
// indexed per b with their own row stride (one slice of the (B, L, 6, d)
// modulation stack).  The output is a new contiguous (B, G, S, D) tensor.
//
// What bounds it on this card: bytes.  At the serving shape (32·256 rows
// of D = 768 float32) a launch reads 25 MB and writes 25 MB for ~8 FLOP
// per element: ~15 µs of HBM time, against ~0.06 µs of float32 math.
// The design reads x from device memory once: one warp per row loads the
// row (16-byte vector loads where the row is aligned), keeps it in shared
// memory as float32, reduces mean and variance with warp shuffles (two
// passes over the cached row, as the plain version computes
// mean((x − μ)²)), then writes the modulated row with vector stores.
// γ and β rows are shared by all S rows of a batch entry and come from
// L1/L2.  No block-level synchronisation: every warp owns its row.
//
// round_scale = 1 rounds 1 + γ to bf16 before the multiply (bf16 γ only):
// the DiT computes `1.0 + γ` in γ's dtype, the reference kernel in float32.
//
// The backward (adaln_fuse_bwd, float32 only) differentiates the same
// function; the TPU kernel has none, so it replaces XLA's autodiff of the
// reference's training forward (repro/models/dit.py:295-314,
// `layers.layernorm` then `_modulate`).  Per row it recomputes μ and
// rstd from x (as the forward does), then with x̂ = (x − μ)·rstd and
// dŷ = dy·(1+γ):
//
//   dx = rstd·(dŷ − mean(dŷ) − x̂·mean(dŷ·x̂)),
//   dγ = Σ_rows dy·x̂,   dβ = Σ_rows dy     (over the G·S rows of each b).
//
// The cross-row sums are deterministic, without atomics: a block owns
// BROWS rows of one b; each lane keeps the column partials of its own
// columns, the block adds its warps in warp order into one (b, chunk)
// partial in device memory, and a second kernel adds the chunks in chunk
// order.  Bound: bytes (x and dy read, dx written; the partials are 2·D
// floats a chunk).  The backward section below says how it meets it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float* o, float v) { *o = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* o, float v) {
  *o = __float2bfloat16_rn(v);
}

// Four consecutive elements: one 16-byte (float) or 8-byte (bf16) access.
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
  v[0] = __low2float(lo); v[1] = __high2float(lo);
  v[2] = __low2float(hi); v[3] = __high2float(hi);
}
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 t;
  t.x = *reinterpret_cast<uint32_t*>(&lo);
  t.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = t;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// XT: x and out; GT: γ and β.  VEC: rows of x, out, γ, β are 4-element
// aligned and D % 4 == 0.
template <typename XT, typename GT, bool VEC>
__global__ void __launch_bounds__(THREADS)
adaln_fuse_kernel(const XT* __restrict__ x, const GT* __restrict__ gamma,
                  const GT* __restrict__ beta, XT* __restrict__ out,
                  int B, int G, int S, int D, int64_t sxb, int64_t sxg,
                  int64_t sxs, int64_t sgb, int64_t sbb, float eps,
                  int round_scale) {
  extern __shared__ float rows[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t r = (int64_t)blockIdx.x * WARPS + warp;
  if (r >= (int64_t)B * G * S) return;
  const int64_t gs = (int64_t)G * S;
  const int b = static_cast<int>(r / gs);
  const int gi = static_cast<int>((r % gs) / S);
  const int si = static_cast<int>(r % S);
  const XT* xr = x + b * sxb + gi * sxg + si * sxs;
  XT* orow = out + r * D;
  float* row = rows + warp * D;

  float sum = 0.f;
  if (VEC) {
    for (int c = 4 * lane; c < D; c += 128) {
      float v[4];
      load4(xr + c, v);
#pragma unroll
      for (int j = 0; j < 4; ++j) { row[c + j] = v[j]; sum += v[j]; }
    }
  } else {
    for (int c = lane; c < D; c += 32) {
      const float v = to_f32(xr[c]);
      row[c] = v;
      sum += v;
    }
  }
  __syncwarp();                     // the row cache is shared by the warp
  const float mu = warp_sum(sum) / static_cast<float>(D);
  float sq = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float d = row[c] - mu;
    sq += d * d;
  }
  const float var = warp_sum(sq) / static_cast<float>(D);
  const float rstd = 1.f / sqrtf(var + eps);

  const GT* gr = gamma ? gamma + b * sgb : nullptr;
  const GT* br = beta ? beta + b * sbb : nullptr;
  auto modulate = [&](int c, float y) {
    if (!gr) return y;
    float s = 1.f + to_f32(gr[c]);
    if (round_scale) s = __bfloat162float(__float2bfloat16_rn(s));
    return y * s + to_f32(br[c]);
  };
  if (VEC) {
    for (int c = 4 * lane; c < D; c += 128) {
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = modulate(c + j, (row[c + j] - mu) * rstd);
      store4(orow + c, v);
    }
  } else {
    for (int c = lane; c < D; c += 32)
      from_f32(orow + c, modulate(c, (row[c] - mu) * rstd));
  }
}

template <typename XT, typename GT, bool VEC>
int launch(const void* x, const void* gamma, const void* beta, void* out,
           int B, int G, int S, int D, int64_t sxb, int64_t sxg, int64_t sxs,
           int64_t sgb, int64_t sbb, float eps, int round_scale,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * WARPS * D;
  auto kern = adaln_fuse_kernel<XT, GT, VEC>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int64_t rows = (int64_t)B * G * S;
  const unsigned blocks = static_cast<unsigned>((rows + WARPS - 1) / WARPS);
  kern<<<blocks, THREADS, smem, stream>>>(
      static_cast<const XT*>(x), static_cast<const GT*>(gamma),
      static_cast<const GT*>(beta), static_cast<XT*>(out), B, G, S, D, sxb,
      sxg, sxs, sgb, sbb, eps, round_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename XT, typename GT>
int dispatch_vec(int vec, const void* x, const void* gamma, const void* beta,
                 void* out, int B, int G, int S, int D, int64_t sxb,
                 int64_t sxg, int64_t sxs, int64_t sgb, int64_t sbb,
                 float eps, int round_scale, cudaStream_t st) {
  return vec ? launch<XT, GT, true>(x, gamma, beta, out, B, G, S, D, sxb, sxg,
                                    sxs, sgb, sbb, eps, round_scale, st)
             : launch<XT, GT, false>(x, gamma, beta, out, B, G, S, D, sxb,
                                     sxg, sxs, sgb, sbb, eps, round_scale, st);
}

}  // namespace

// x: (B, G, S, D) by element strides (sxb, sxg, sxs), last axis
// contiguous, float32 (x_bf16 = 0) or bf16 (x_bf16 = 1); out: contiguous
// (B, G, S, D) of x's dtype.  gamma, beta: (B, D) rows at element strides
// sgb, sbb, last axis contiguous, float32 (g_bf16 = 0) or bf16 (1); both
// null for the plain LayerNorm.  vec = 1 only when D % 4 == 0 and every
// row start of x, out, gamma and beta is 4-element aligned.  D ≤ 7,264
// (eight float32 rows in 227 KB of shared memory).  Launches on `stream`,
// allocates nothing, returns the CUDA error code (0 on success).
extern "C" int adaln_fuse(const void* x, int x_bf16, const void* gamma,
                          const void* beta, int g_bf16, void* out, int B,
                          int G, int S, int D, long long sxb, long long sxg,
                          long long sxs, long long sgb, long long sbb,
                          float eps, int round_scale, int vec, void* stream) {
  if ((int64_t)B * G * S == 0 || D == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!x_bf16 && !g_bf16)
    return dispatch_vec<float, float>(vec, x, gamma, beta, out, B, G, S, D,
                                      sxb, sxg, sxs, sgb, sbb, eps,
                                      round_scale, st);
  if (!x_bf16)
    return dispatch_vec<float, __nv_bfloat16>(vec, x, gamma, beta, out, B, G,
                                              S, D, sxb, sxg, sxs, sgb, sbb,
                                              eps, round_scale, st);
  if (!g_bf16)
    return dispatch_vec<__nv_bfloat16, float>(vec, x, gamma, beta, out, B, G,
                                              S, D, sxb, sxg, sxs, sgb, sbb,
                                              eps, round_scale, st);
  return dispatch_vec<__nv_bfloat16, __nv_bfloat16>(
      vec, x, gamma, beta, out, B, G, S, D, sxb, sxg, sxs, sgb, sbb, eps,
      round_scale, st);
}

namespace {

// ---- backward ------------------------------------------------------------
//
// At the training shape (32 × 256 rows of D = 768) a launch moves 75.5 MB
// (x, dy read once, dx written once): 0.0225 ms at 3.35 TB/s.  To reach
// it, many rows are in flight and each is read once:
//   * the register path (D % 4 == 0, aligned rows, D ≤ REG_MAX_D): one
//     warp a row, held in registers as float4s (lane l owns columns
//     4l + 128v, v < NV), x and dy loaded together at the top; the
//     statistics and the two row means reduce with shuffles; dx is
//     written once with 16-byte stores.  Eight warps a block, two blocks
//     an SM.  With γ, each lane keeps the dγ/dβ partials of its columns in
//     registers over the block's rows; without γ, a block is 8 rows (one
//     a warp) and there are no partials and no second kernel;
//   * the shared-memory path (any other D ≤ 3,584, unaligned views): four
//     warps a block, each caching its row and its column partials in its
//     own shared-memory slice, scalar loads.
// Both write the same (b, chunk) partials, BROWS rows a chunk; a second
// kernel adds the chunks in order.

constexpr int BWARPS = 8;            // warps of a register-path block
constexpr int BTHREADS = BWARPS * 32;
constexpr int SWARPS = 4;            // warps of a shared-memory-path block
constexpr int STHREADS = SWARPS * 32;
constexpr int BROWS = 32;            // rows of one b a block reduces (γ)
constexpr int REG_MAX_D = 1024;      // widest row of the register path

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Register path: NV float4s a lane (D ≤ 128·NV).  One block per (chunk of
// brows rows, b).  Shared memory (AFFINE): each warp's dγ and dβ partials.
template <bool AFFINE, int NV>
__global__ void __launch_bounds__(BTHREADS, NV <= 6 ? 2 : 1)
adaln_fuse_bwd_regs(const float* __restrict__ x,
                    const float* __restrict__ gamma,
                    const float* __restrict__ dy, float* __restrict__ dx,
                    float* __restrict__ part, int G, int S, int D,
                    int64_t sxb, int64_t sxg, int64_t sxs, int64_t sgb,
                    float eps, int brows, int nchunk) {
  extern __shared__ float4 bsm4[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chunk = blockIdx.x, b = blockIdx.y;
  const int64_t rows = (int64_t)G * S;
  const float* gr = AFFINE ? gamma + b * sgb : nullptr;
  float4 pg[NV], pb[NV];               // dγ, dβ of this lane's columns
#pragma unroll
  for (int v = 0; v < NV; ++v)
    pg[v] = pb[v] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int i = warp; i < brows; i += BWARPS) {
    const int64_t r = (int64_t)chunk * brows + i;
    if (r >= rows) break;
    const int gi = static_cast<int>(r / S), si = static_cast<int>(r % S);
    const float* xr = x + b * sxb + gi * sxg + si * sxs;
    const int64_t off = ((int64_t)b * rows + r) * D;
    float4 xv[NV], gv[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int c = 4 * lane + 128 * v;
      const bool in = c < D;
      xv[v] = in ? ld4(xr + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      gv[v] = in ? ld4(dy + off + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    // the forward's statistics: mean, then mean((x − μ)²)
    float sum = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v)
      sum += (xv[v].x + xv[v].y) + (xv[v].z + xv[v].w);
    const float mu = warp_sum(sum) / static_cast<float>(D);
    float sq = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      if (4 * lane + 128 * v >= D) continue;
      const float a = xv[v].x - mu, bb = xv[v].y - mu, c = xv[v].z - mu,
                  d = xv[v].w - mu;
      sq += (a * a + bb * bb) + (c * c + d * d);
    }
    const float var = warp_sum(sq) / static_cast<float>(D);
    const float rstd = 1.f / sqrtf(var + eps);
    // x -> x̂, dy -> dŷ in place; the partials and the two row sums
    float s1 = 0.f, s2 = 0.f;
    const auto elem = [&](float& xe, float& ge, float& pge, float& pbe,
                          float ga) {
      const float xh = (xe - mu) * rstd;
      const float g = ge;
      const float gh = AFFINE ? g * (1.f + ga) : g;
      if (AFFINE) {
        pge += g * xh;
        pbe += g;
      }
      xe = xh;
      ge = gh;
      s1 += gh;
      s2 += gh * xh;
    };
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int c = 4 * lane + 128 * v;
      if (c >= D) continue;
      const float4 g4 = AFFINE ? ld4(gr + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      elem(xv[v].x, gv[v].x, pg[v].x, pb[v].x, g4.x);
      elem(xv[v].y, gv[v].y, pg[v].y, pb[v].y, g4.y);
      elem(xv[v].z, gv[v].z, pg[v].z, pb[v].z, g4.z);
      elem(xv[v].w, gv[v].w, pg[v].w, pb[v].w, g4.w);
    }
    const float m1 = warp_sum(s1) / static_cast<float>(D);
    const float m2 = warp_sum(s2) / static_cast<float>(D);
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int c = 4 * lane + 128 * v;
      if (c >= D) continue;
      *reinterpret_cast<float4*>(dx + off + c) = make_float4(
          rstd * (gv[v].x - m1 - xv[v].x * m2),
          rstd * (gv[v].y - m1 - xv[v].y * m2),
          rstd * (gv[v].z - m1 - xv[v].z * m2),
          rstd * (gv[v].w - m1 - xv[v].w * m2));
    }
  }
  if (AFFINE) {
    // [warp][dγ | dβ] in float4s, then the warps added in order
    const int D4 = D / 4;
    float4* mine = bsm4 + warp * 2 * D4;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int c4 = lane + 32 * v;
      if (c4 < D4) {
        mine[c4] = pg[v];
        mine[D4 + c4] = pb[v];
      }
    }
    __syncthreads();
    float4* out = reinterpret_cast<float4*>(
        part + ((int64_t)b * nchunk + chunk) * 2 * D);
    for (int c = threadIdx.x; c < 2 * D4; c += BTHREADS) {
      float4 s = bsm4[c];
      for (int w = 1; w < BWARPS; ++w) {
        const float4 t = bsm4[w * 2 * D4 + c];
        s = make_float4(s.x + t.x, s.y + t.y, s.z + t.z, s.w + t.w);
      }
      out[c] = s;
    }
  }
}

// Shared-memory path: one block per (chunk of BROWS rows, b).  Shared
// memory: per warp the x̂ row and the dŷ row (2·D floats), then per warp
// its dγ and dβ column partials (2·D floats, AFFINE only).
template <bool AFFINE>
__global__ void __launch_bounds__(STHREADS)
adaln_fuse_bwd_smem(const float* __restrict__ x,
                    const float* __restrict__ gamma,
                    const float* __restrict__ dy, float* __restrict__ dx,
                    float* __restrict__ part, int G, int S, int D,
                    int64_t sxb, int64_t sxg, int64_t sxs, int64_t sgb,
                    float eps, int nchunk) {
  extern __shared__ float bsm[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chunk = blockIdx.x, b = blockIdx.y;
  const int64_t rows = (int64_t)G * S;
  float* xrow = bsm + warp * 2 * D;
  float* grow = xrow + D;
  float* acc = bsm + SWARPS * 2 * D + warp * 2 * D;   // [dγ | dβ]
  if (AFFINE)
    for (int c = lane; c < D; c += 32) acc[c] = acc[D + c] = 0.f;
  const float* gr = AFFINE ? gamma + b * sgb : nullptr;
  for (int i = warp; i < BROWS; i += SWARPS) {
    const int64_t r = (int64_t)chunk * BROWS + i;
    if (r >= rows) break;
    const int gi = static_cast<int>(r / S), si = static_cast<int>(r % S);
    const float* xr = x + b * sxb + gi * sxg + si * sxs;
    const float* dyr = dy + ((int64_t)b * rows + r) * D;
    float* dxr = dx + ((int64_t)b * rows + r) * D;
    // the forward's statistics: mean, then mean((x − μ)²)
    float sum = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float v = xr[c];
      xrow[c] = v;
      sum += v;
    }
    const float mu = warp_sum(sum) / static_cast<float>(D);
    float sq = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float d = xrow[c] - mu;
      sq += d * d;
    }
    const float var = warp_sum(sq) / static_cast<float>(D);
    const float rstd = 1.f / sqrtf(var + eps);
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float xh = (xrow[c] - mu) * rstd;
      const float g = dyr[c];
      const float gh = AFFINE ? g * (1.f + gr[c]) : g;
      if (AFFINE) {
        acc[c] += g * xh;
        acc[D + c] += g;
      }
      xrow[c] = xh;
      grow[c] = gh;
      s1 += gh;
      s2 += gh * xh;
    }
    const float m1 = warp_sum(s1) / static_cast<float>(D);
    const float m2 = warp_sum(s2) / static_cast<float>(D);
    for (int c = lane; c < D; c += 32)
      dxr[c] = rstd * (grow[c] - m1 - xrow[c] * m2);
    __syncwarp();                  // a lane only rereads its own columns
  }
  if (AFFINE) {
    __syncthreads();
    float* out = part + ((int64_t)b * nchunk + chunk) * 2 * D;
    const float* accs = bsm + SWARPS * 2 * D;
    for (int c = threadIdx.x; c < 2 * D; c += STHREADS) {
      float s = 0.f;
      for (int w = 0; w < SWARPS; ++w) s += accs[w * 2 * D + c];
      out[c] = s;
    }
  }
}

// dγ[b, c] and dβ[b, c]: the chunk partials of b added in chunk order.
__global__ void adaln_fuse_bwd_reduce(const float* __restrict__ part,
                                      float* __restrict__ dgamma,
                                      float* __restrict__ dbeta, int B,
                                      int D, int nchunk) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)B * D) return;
  const int64_t b = i / D;
  const int c = static_cast<int>(i % D);
  const float* p = part + b * nchunk * 2 * D;
  float sg = 0.f, sb = 0.f;
  for (int k = 0; k < nchunk; ++k) {
    sg += p[(int64_t)k * 2 * D + c];
    sb += p[(int64_t)k * 2 * D + D + c];
  }
  dgamma[i] = sg;
  dbeta[i] = sb;
}

template <typename K>
cudaError_t allow_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <bool AFFINE, int NV>
cudaError_t launch_regs(const float* x, const float* gamma, const float* dy,
                        float* dx, float* part, int B, int G, int S, int D,
                        int64_t sxb, int64_t sxg, int64_t sxs, int64_t sgb,
                        float eps, cudaStream_t stream) {
  const int64_t rows = (int64_t)G * S;
  const int brows = AFFINE ? BROWS : BWARPS;
  const int nchunk = static_cast<int>((rows + brows - 1) / brows);
  const size_t smem = AFFINE ? sizeof(float) * BWARPS * 2 * D : 0;
  auto kern = adaln_fuse_bwd_regs<AFFINE, NV>;
  const cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(nchunk, B), BTHREADS, smem, stream>>>(
      x, gamma, dy, dx, part, G, S, D, sxb, sxg, sxs, sgb, eps, brows,
      nchunk);
  return cudaGetLastError();
}

template <bool AFFINE>
cudaError_t launch_rows(const float* x, const float* gamma, const float* dy,
                        float* dx, float* part, int B, int G, int S, int D,
                        int64_t sxb, int64_t sxg, int64_t sxs, int64_t sgb,
                        float eps, int vec, cudaStream_t stream) {
  if (vec && D <= REG_MAX_D) {
    if (D <= 256)
      return launch_regs<AFFINE, 2>(x, gamma, dy, dx, part, B, G, S, D, sxb,
                                    sxg, sxs, sgb, eps, stream);
    if (D <= 512)
      return launch_regs<AFFINE, 4>(x, gamma, dy, dx, part, B, G, S, D, sxb,
                                    sxg, sxs, sgb, eps, stream);
    if (D <= 768)
      return launch_regs<AFFINE, 6>(x, gamma, dy, dx, part, B, G, S, D, sxb,
                                    sxg, sxs, sgb, eps, stream);
    return launch_regs<AFFINE, 8>(x, gamma, dy, dx, part, B, G, S, D, sxb,
                                  sxg, sxs, sgb, eps, stream);
  }
  const int64_t rows = (int64_t)G * S;
  const int nchunk = static_cast<int>((rows + BROWS - 1) / BROWS);
  const size_t smem = sizeof(float) * SWARPS * (AFFINE ? 4 : 2) * D;
  auto kern = adaln_fuse_bwd_smem<AFFINE>;
  const cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(nchunk, B), STHREADS, smem, stream>>>(
      x, gamma, dy, dx, part, G, S, D, sxb, sxg, sxs, sgb, eps, nchunk);
  return cudaGetLastError();
}

}  // namespace

// Chunks of one batch entry's G·S rows whose dγ/dβ partials the backward
// writes (the `part` scratch holds B · chunks · 2 · D floats).
extern "C" int adaln_fuse_bwd_chunks(long long rows) {
  return static_cast<int>((rows + BROWS - 1) / BROWS);
}

// Backward of adaln_fuse for float32 x, γ, β.  x: (B, G, S, D) by element
// strides (sxb, sxg, sxs), last axis contiguous; gamma: (B, D) rows at
// element stride sgb, last axis contiguous, or null for the plain
// LayerNorm (then dγ and dβ are skipped and part, dgamma, dbeta may be
// null).  dy, dx: contiguous (B, G, S, D).  part: scratch of
// B · adaln_fuse_bwd_chunks(G·S) · 2 · D floats; dgamma, dbeta: contiguous
// (B, D).  vec = 1 only when D % 4 == 0 and every row start of x, dy, dx
// and gamma is 4-element aligned.  D ≤ 3,584 (four warps' rows and
// partials in 227 KB).  Launches two kernels on `stream` (one without γ),
// allocates nothing, returns the CUDA error code (0 on success).
extern "C" int adaln_fuse_bwd(const void* x, const void* gamma,
                              const void* dy, void* dx, void* part,
                              void* dgamma, void* dbeta, int B, int G, int S,
                              int D, long long sxb, long long sxg,
                              long long sxs, long long sgb, float eps,
                              int vec, void* stream) {
  if ((int64_t)B * G * S == 0 || D == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* dyf = static_cast<const float*>(dy);
  float* dxf = static_cast<float*>(dx);
  if (gamma == nullptr)
    return static_cast<int>(launch_rows<false>(xf, nullptr, dyf, dxf,
                                               nullptr, B, G, S, D, sxb, sxg,
                                               sxs, 0, eps, vec, st));
  cudaError_t e = launch_rows<true>(xf, static_cast<const float*>(gamma), dyf,
                                    dxf, static_cast<float*>(part), B, G, S,
                                    D, sxb, sxg, sxs, sgb, eps, vec, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t n = (int64_t)B * D;
  adaln_fuse_bwd_reduce<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                          st>>>(static_cast<const float*>(part),
                                static_cast<float*>(dgamma),
                                static_cast<float*>(dbeta), B, D,
                                adaln_fuse_bwd_chunks((long long)G * S));
  return static_cast<int>(cudaGetLastError());
}
