// Heterogeneous convert + fuse kernels for Hopper (sm_90a), float32:
// the step-fused update, the velocity-only fuse (coefficient and flag
// forms), and the dequantization of quantized expert leaves.
//
// hetero_fuse_step replaces the TPU kernel repro/kernels/hetero_fuse.py:161
// `hetero_fuse_step`.  Per latent element (b, t):
//
//   for each guidance branch g and routed slot k:
//     x̂0 = clip((x − σ·p) / max(α, α_min), ±clamp)
//     v  = (α′·x̂0 + σ′·p) · vscale
//   fused[g] = Σ_k w[g, b, k] · v
//   u = fused[1] + s·(fused[0] − fused[1])      (G = 2; G = 1: u = fused[0])
//   out = x − u·dt
//
// hetero_fuse_coeffs replaces repro/kernels/hetero_fuse.py:95
// `hetero_fuse_coeffs` (the unfused step path): the same per-slot
// conversion and Σ_k over one (K, B, T) batch, writing the fused velocity;
// the CFG combine and the Euler update follow as separate ops.
//
// hetero_fuse_flags replaces repro/kernels/hetero_fuse.py:266 `hetero_fuse`
// (body `_fuse_kernel`, :49), the flag form behind ops.fused_convert_and_fuse
// (the per-step fusion op of Fig. 2): per expert an `is_ddpm` flag and raw
// (K, B) coefficients; DDPM experts convert as above, FM experts pass their
// prediction through (a select, exactly as the plain version's `where`),
// and Σ_k w_k v_k is written.
//
// hetero_fuse_dequant replaces repro/kernels/hetero_fuse.py:231
// `hetero_fuse_dequant`: out[r, t] = float(q[r, t]) · scale[r] for int8 or
// e4m3 q, then the cast to float32 or bf16 (round to nearest even).
//
// What bounds them on this card: bytes.  At the serving shape (K = 2
// slots, G = 2 branches, B = 8, T = 4096) one step launch reads ≈ 0.66 MB
// and writes 0.13 MB for ~20 FLOP per element — a few hundred nanoseconds
// of HBM time, so in practice the fuse kernels are bound by the launch
// itself.  The design does what the TPU kernel did for the same reason:
// the latent is read once and the result written once, and no per-slot
// velocity exists in device memory.  One thread per element loops over K
// (and G) in registers; neighbouring threads touch neighbouring t, so
// every load of preds/x and the store are coalesced; the per-(k, g, b)
// coefficients and weights are broadcast reads served from L1.  Any T
// works: there is no 128-lane padding.  The dequant kernel reads one byte
// and writes 4 (f32) or 2 (bf16) per element; where rows are a multiple
// of 4 wide and the output aligned, each thread converts 4 elements and
// writes them with one 16-/8-byte store.
//
// Numerics: built with -fmad=false, so every a·b + c rounds twice exactly
// as the plain PyTorch versions (kernels/ref.py) do; division is IEEE
// (no fast-math), and the sum over k starts from 0 in slot order.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
hetero_fuse_step_kernel(const float* __restrict__ preds,   // (K, G, B, T)
                        const float* __restrict__ x,       // (B, T)
                        const float* __restrict__ w,       // (G, B, K)
                        const float* __restrict__ coef,    // (5, K, G, B)
                        const float* __restrict__ dt,      // (1,) or (B,)
                        float* __restrict__ out,           // (B, T)
                        int K, int G, int B, int T, int dt_per_row,
                        float cfg_scale, float clamp, float alpha_min) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= (int64_t)B * T) return;
  const int b = static_cast<int>(i / T);
  const int t = static_cast<int>(i % T);
  const int64_t kgb = (int64_t)K * G * B;
  const float xt = x[i];

  float fused[2] = {0.f, 0.f};
  for (int g = 0; g < G; ++g) {
    float acc = 0.f;
    for (int k = 0; k < K; ++k) {
      const int64_t slot = ((int64_t)k * G + g) * B + b;   // (k, g, b)
      const float alpha = coef[slot];
      const float sigma = coef[slot + kgb];
      const float dalpha = coef[slot + 2 * kgb];
      const float dsigma = coef[slot + 3 * kgb];
      const float vscale = coef[slot + 4 * kgb];
      const float p = preds[slot * T + t];
      const float a = fmaxf(alpha, alpha_min);
      float x0 = (xt - sigma * p) / a;
      x0 = fminf(fmaxf(x0, -clamp), clamp);
      const float v = (dalpha * x0 + dsigma * p) * vscale;
      acc = acc + w[((int64_t)g * B + b) * K + k] * v;
    }
    fused[g] = acc;
  }
  const float u = (G == 1) ? fused[0]
                           : fused[1] + cfg_scale * (fused[0] - fused[1]);
  out[i] = xt - u * dt[dt_per_row ? b : 0];
}

__global__ void __launch_bounds__(THREADS)
hetero_fuse_coeffs_kernel(const float* __restrict__ preds,   // (K, B, T)
                          const float* __restrict__ x,       // (B, T)
                          const float* __restrict__ w,       // (B, K)
                          const float* __restrict__ coef,    // (5, K, B)
                          float* __restrict__ out,           // (B, T)
                          int K, int B, int T, float clamp,
                          float alpha_min) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= (int64_t)B * T) return;
  const int b = static_cast<int>(i / T);
  const int t = static_cast<int>(i % T);
  const int64_t kb = (int64_t)K * B;
  const float xt = x[i];
  float acc = 0.f;
  for (int k = 0; k < K; ++k) {
    const int64_t slot = (int64_t)k * B + b;                 // (k, b)
    const float alpha = coef[slot];
    const float sigma = coef[slot + kb];
    const float dalpha = coef[slot + 2 * kb];
    const float dsigma = coef[slot + 3 * kb];
    const float vscale = coef[slot + 4 * kb];
    const float p = preds[slot * T + t];
    const float a = fmaxf(alpha, alpha_min);
    float x0 = (xt - sigma * p) / a;
    x0 = fminf(fmaxf(x0, -clamp), clamp);
    const float v = (dalpha * x0 + dsigma * p) * vscale;
    acc = acc + w[(int64_t)b * K + k] * v;
  }
  out[i] = acc;
}

__global__ void __launch_bounds__(THREADS)
hetero_fuse_flags_kernel(const float* __restrict__ preds,    // (K, B, T)
                         const float* __restrict__ x,        // (B, T)
                         const float* __restrict__ w,        // (B, K)
                         const uint8_t* __restrict__ ddpm,   // (K,)
                         const float* __restrict__ coef,     // (5, K, B)
                         float* __restrict__ out,            // (B, T)
                         int K, int B, int T, float clamp,
                         float alpha_min) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= (int64_t)B * T) return;
  const int b = static_cast<int>(i / T);
  const int t = static_cast<int>(i % T);
  const int64_t kb = (int64_t)K * B;
  const float xt = x[i];
  float acc = 0.f;
  for (int k = 0; k < K; ++k) {
    const int64_t slot = (int64_t)k * B + b;                 // (k, b)
    const float p = preds[slot * T + t];
    float v = p;
    if (ddpm[k]) {
      const float alpha = coef[slot];
      const float sigma = coef[slot + kb];
      const float dalpha = coef[slot + 2 * kb];
      const float dsigma = coef[slot + 3 * kb];
      const float vscale = coef[slot + 4 * kb];
      const float a = fmaxf(alpha, alpha_min);
      float x0 = (xt - sigma * p) / a;
      x0 = fminf(fmaxf(x0, -clamp), clamp);
      v = (dalpha * x0 + dsigma * p) * vscale;
    }
    acc = acc + w[(int64_t)b * K + k] * v;
  }
  out[i] = acc;
}

__device__ __forceinline__ float q_to_f32(int8_t v) {
  return static_cast<float>(v);
}
__device__ __forceinline__ float q_to_f32(__nv_fp8_e4m3 v) {
  return static_cast<float>(v);
}
__device__ __forceinline__ void store_out(float* o, float v) { *o = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* o, float v) {
  *o = __float2bfloat16_rn(v);
}

// One element per thread, or (VEC4) four consecutive elements of one row
// per thread with one vector store: T % 4 == 0, out 16/8-byte aligned.
template <typename QT, typename OT, bool VEC4>
__global__ void __launch_bounds__(THREADS)
hetero_fuse_dequant_kernel(const QT* __restrict__ q,
                           const float* __restrict__ scale,
                           OT* __restrict__ out, int64_t n, int64_t T) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (!VEC4) {
    if (i >= n) return;
    store_out(out + i, q_to_f32(q[i]) * scale[i / T]);
    return;
  }
  const int64_t i0 = 4 * i;
  if (i0 >= n) return;
  const float s = scale[i0 / T];
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = q_to_f32(q[i0 + j]) * s;
  if constexpr (std::is_same<OT, float>::value) {
    *reinterpret_cast<float4*>(out + i0) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    __nv_bfloat162 lo = __halves2bfloat162(__float2bfloat16_rn(v[0]),
                                           __float2bfloat16_rn(v[1]));
    __nv_bfloat162 hi = __halves2bfloat162(__float2bfloat16_rn(v[2]),
                                           __float2bfloat16_rn(v[3]));
    uint2 packed;
    packed.x = *reinterpret_cast<uint32_t*>(&lo);
    packed.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(out + i0) = packed;
  }
}

template <typename QT, typename OT>
void launch_dequant(const void* q, const float* scale, void* out, int64_t n,
                    int64_t T, int vec4, cudaStream_t stream) {
  const int64_t items = vec4 ? (n + 3) / 4 : n;
  const unsigned blocks = static_cast<unsigned>((items + THREADS - 1) /
                                                THREADS);
  if (vec4) {
    hetero_fuse_dequant_kernel<QT, OT, true><<<blocks, THREADS, 0, stream>>>(
        static_cast<const QT*>(q), scale, static_cast<OT*>(out), n, T);
  } else {
    hetero_fuse_dequant_kernel<QT, OT, false><<<blocks, THREADS, 0, stream>>>(
        static_cast<const QT*>(q), scale, static_cast<OT*>(out), n, T);
  }
}

}  // namespace

// All operands contiguous float32 on the device; G must be 1 or 2.
// Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int hetero_fuse_step_f32(const float* preds, const float* x,
                                    const float* w, const float* coef,
                                    const float* dt, float* out, int K, int G,
                                    int B, int T, int dt_per_row,
                                    float cfg_scale, float clamp,
                                    float alpha_min, void* stream) {
  const int64_t n = (int64_t)B * T;
  if (n > 0) {
    const int64_t blocks = (n + THREADS - 1) / THREADS;
    hetero_fuse_step_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        preds, x, w, coef, dt, out, K, G, B, T, dt_per_row, cfg_scale, clamp,
        alpha_min);
  }
  return static_cast<int>(cudaGetLastError());
}

// All operands contiguous float32 on the device.  Launches on `stream`,
// allocates nothing, returns cudaGetLastError().
extern "C" int hetero_fuse_coeffs_f32(const float* preds, const float* x,
                                      const float* w, const float* coef,
                                      float* out, int K, int B, int T,
                                      float clamp, float alpha_min,
                                      void* stream) {
  const int64_t n = (int64_t)B * T;
  if (n > 0) {
    const int64_t blocks = (n + THREADS - 1) / THREADS;
    hetero_fuse_coeffs_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        preds, x, w, coef, out, K, B, T, clamp, alpha_min);
  }
  return static_cast<int>(cudaGetLastError());
}

// All operands contiguous on the device: float32, except is_ddpm (K,)
// bytes (0 = FM, else DDPM).  Launches on `stream`, allocates nothing,
// returns cudaGetLastError().
extern "C" int hetero_fuse_flags_f32(const float* preds, const float* x,
                                     const float* w, const uint8_t* is_ddpm,
                                     const float* coef, float* out, int K,
                                     int B, int T, float clamp,
                                     float alpha_min, void* stream) {
  const int64_t n = (int64_t)B * T;
  if (n > 0) {
    const int64_t blocks = (n + THREADS - 1) / THREADS;
    hetero_fuse_flags_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        preds, x, w, is_ddpm, coef, out, K, B, T, clamp, alpha_min);
  }
  return static_cast<int>(cudaGetLastError());
}

// q (R, T) contiguous int8 (q_fp8 = 0) or e4m3 (q_fp8 = 1); scale (R,)
// float32; out (R, T) float32 (out_bf16 = 0) or bf16 (out_bf16 = 1).
// vec4 = 1 only when T % 4 == 0 and out is 16-byte (f32) or 8-byte
// (bf16) aligned.  Returns cudaGetLastError().
extern "C" int hetero_fuse_dequant(const void* q, int q_fp8,
                                   const float* scale, void* out,
                                   int out_bf16, long long R, long long T,
                                   int vec4, void* stream) {
  const int64_t n = (int64_t)R * T;
  if (n > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (!q_fp8 && !out_bf16)
      launch_dequant<int8_t, float>(q, scale, out, n, T, vec4, st);
    else if (!q_fp8)
      launch_dequant<int8_t, __nv_bfloat16>(q, scale, out, n, T, vec4, st);
    else if (!out_bf16)
      launch_dequant<__nv_fp8_e4m3, float>(q, scale, out, n, T, vec4, st);
    else
      launch_dequant<__nv_fp8_e4m3, __nv_bfloat16>(q, scale, out, n, T, vec4,
                                                   st);
  }
  return static_cast<int>(cudaGetLastError());
}
