// Step-fused heterogeneous convert + fuse + CFG + Euler, float32, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/hetero_fuse.py:161
// `hetero_fuse_step`.  Per latent element (b, t):
//
//   for each guidance branch g and routed slot k:
//     x̂0 = clip((x − σ·p) / max(α, α_min), ±clamp)
//     v  = (α′·x̂0 + σ′·p) · vscale
//   fused[g] = Σ_k w[g, b, k] · v
//   u = fused[1] + s·(fused[0] − fused[1])      (G = 2; G = 1: u = fused[0])
//   out = x − u·dt
//
// What bounds it on this card: bytes.  At the serving shape (K = 2 slots,
// G = 2 branches, B = 8, T = 4096) one launch reads ≈ 0.66 MB and writes
// 0.13 MB for ~20 FLOP per element — a few hundred nanoseconds of HBM
// time, so in practice it is bound by the launch itself.  The design does
// what the TPU kernel did for the same reason: the latent is read once
// and the updated latent written once per step, and no intermediate
// velocity exists in device memory.  One thread per element loops over
// K and G in registers; neighbouring threads touch neighbouring t, so
// every load of preds/x and the store are coalesced; the per-(k, g, b)
// coefficients and weights are broadcast reads served from L1.  Any T
// works: there is no 128-lane padding.
//
// Numerics: built with -fmad=false, so every a·b + c rounds twice exactly
// as the plain PyTorch version (kernels/ref.py) does; division is IEEE
// (no fast-math), and the sum over k starts from 0 in slot order.

#include <cuda_runtime.h>
#include <stdint.h>

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
