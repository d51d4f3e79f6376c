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
// prediction through (a select, exactly as the plain version's `where`,
// not the Pallas kernel's blend f·v + (1 − f)·p), and Σ_k w_k v_k is
// written.
//
// hetero_fuse_dequant replaces repro/kernels/hetero_fuse.py:231
// `hetero_fuse_dequant`: out[r, t] = float(q[r, t]) · scale[r] for int8 or
// e4m3 q, then the cast to float32 or bf16 (round to nearest even).
//
// What bounds them on this card: bytes.  At the serving shape (K = 2
// slots, G = 2 branches, B = 8, T = 4096) one step launch reads ≈ 0.66 MB
// and writes 0.13 MB for ~20 FLOP per element — a few hundred nanoseconds
// of HBM time, so in practice the fuse kernels are bound by the launch
// and by memory latency.  The design does what the TPU kernel did for the
// same reason: the latent is read once and the result written once, and
// no per-slot velocity exists in device memory.  The step, velocity and
// flag-form kernels share one body (below): a block per (256-element tile,
// latent row), and the slot loops unrolled so that a thread's loads all
// issue before its first divide.  Neighbouring threads touch neighbouring
// t, so every load and store is coalesced, and the coefficients are
// broadcast reads.  Any T works: there is no 128-lane padding.  The
// dequant kernel reads one byte and writes 4 (f32) or 2 (bf16) per
// element; where rows are a
// multiple of 4 wide and the output aligned, each thread converts 4
// elements and writes them with one 16-/8-byte store.
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

// ---------------------------------------------------------------------------
// hetero_fuse_step, hetero_fuse_coeffs and hetero_fuse_flags: one body
// ---------------------------------------------------------------------------
//
// The velocity form is the step body with G = 1 and no Euler update: its
// (K, B, T) predictions, (B, K) weights and (5, K, B) coefficients are the
// step's (K, 1, B, T), (1, B, K) and (5, K, 1, B).  The flag form has the
// velocity form's operands and a (K,) flag per slot: a DDPM slot converts,
// an FM slot adds its prediction as it is (a select; the flag is the same
// across the block, so no warp diverges).
//
// At the serving shape the kernels move a few hundred kilobytes that the
// previous kernel has just left in L2, so what they wait on is latency: a
// slot loop that issues a slot's loads only after the previous slot's
// divide waits for one memory round trip per slot pass.  This body:
// * gives each block row one latent row: the grid is (⌈T / THREADS⌉, B),
//   b is the block's y index, and no element divides by T;
// * unrolls the slot loops at compile time (K = 1..8, G = 1, 2): a thread
//   issues every load it needs — x, all K·G predictions, then its row's
//   5·K·G coefficients, G·K weights, the K flags and dt (one address
//   across the warp: a broadcast) — before its first divide, so it waits
//   for one round trip.  max(α, α_min) is taken once per slot.  K above 8
//   runs the same kernel with a runtime slot loop (the K = 0
//   instantiation).
// One element a thread: 2 or 4 (float2 / float4 accesses) were slower on
// the H100 (PERF.md), since 8 warps an SM hide the IEEE divides' latency
// better than 4 or 2.  Coefficients staged in shared memory by the first
// K·G threads behind a barrier were slower than these broadcast loads.
// Per element the arithmetic is the plain version's, in its order.

enum class Form { kStep, kCoeffs, kFlags };

struct FuseArgs {
  const float* preds;   // (K, G, B, T)
  const float* x;       // (B, T)
  const float* w;       // (G, B, K)
  const float* coef;    // (5, K, G, B): α, σ, α′, σ′, vscale
  const float* dt;      // (1,) or (B,); the step form only
  const uint8_t* ddpm;  // (K,) 0 = FM, else DDPM; the flag form only
  float* out;           // (B, T)
  int K, B, T, dt_per_row;
  float cfg_scale, clamp, alpha_min;
};

// One routed slot's coefficients and fusion weight for latent row b.
// Operands are read-only for the kernel's life: loads take the read-only
// (non-coherent) path.
struct Slot {
  float a, sigma, dalpha, dsigma, vscale, w;
};

template <int G>
__device__ __forceinline__ Slot load_slot(const FuseArgs& p, int K, int k,
                                          int g, int b) {
  const int64_t plane = (int64_t)K * G * p.B;
  const int64_t at = ((int64_t)k * G + g) * p.B + b;        // (k, g, b)
  Slot s;
  s.a = fmaxf(__ldg(p.coef + at), p.alpha_min);
  s.sigma = __ldg(p.coef + at + plane);
  s.dalpha = __ldg(p.coef + at + 2 * plane);
  s.dsigma = __ldg(p.coef + at + 3 * plane);
  s.vscale = __ldg(p.coef + at + 4 * plane);
  s.w = __ldg(p.w + ((int64_t)g * p.B + b) * K + k);         // (g, b, k)
  return s;
}

// Does slot k convert?  Every slot of the step and velocity forms does.
template <Form F>
__device__ __forceinline__ bool load_flag(const FuseArgs& p, int k) {
  if constexpr (F == Form::kFlags) return __ldg(p.ddpm + k) != 0;
  return true;
}

// acc += w · v for one slot and element: x̂0 = clip((x − σ·p) / a, ±clamp),
// v = (α′·x̂0 + σ′·p)·vscale where the slot converts, else v = p.  IEEE
// divide; no FMA (-fmad=false).
__device__ __forceinline__ float add_slot(float acc, float xt, float pr,
                                          const Slot& s, bool convert,
                                          float clamp) {
  float v = pr;
  if (convert) {
    float x0 = (xt - s.sigma * pr) / s.a;
    x0 = fminf(fmaxf(x0, -clamp), clamp);
    v = (s.dalpha * x0 + s.dsigma * pr) * s.vscale;
  }
  return acc + s.w * v;
}

// The shared body: K = 0 loops over p.K slots at run time.
template <int K, int G, Form F>
__device__ __forceinline__ void fuse_rows(const FuseArgs& p) {
  constexpr bool STEP = F == Form::kStep;
  const int64_t t = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (t >= p.T) return;
  const int64_t slab = (int64_t)p.B * p.T;                  // one (k, g)
  for (int b = blockIdx.y; b < p.B; b += gridDim.y) {
    const int64_t row = (int64_t)b * p.T + t;
    const float xt = __ldg(p.x + row);
    float acc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = 0.f;
    float dt = 0.f;
    if constexpr (K > 0) {
      // every load first: predictions, then the row's coefficients
      float pv[K][G];
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int g = 0; g < G; ++g)
          pv[k][g] = __ldg(p.preds + (k * G + g) * slab + row);
      Slot s[K][G];
      bool conv[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
#pragma unroll
        for (int g = 0; g < G; ++g) s[k][g] = load_slot<G>(p, K, k, g, b);
        conv[k] = load_flag<F>(p, k);
      }
      if constexpr (STEP) dt = __ldg(p.dt + (p.dt_per_row ? b : 0));
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int g = 0; g < G; ++g)
          acc[g] = add_slot(acc[g], xt, pv[k][g], s[k][g], conv[k],
                            p.clamp);
    } else {
      if constexpr (STEP) dt = __ldg(p.dt + (p.dt_per_row ? b : 0));
      for (int k = 0; k < p.K; ++k) {
        const bool conv = load_flag<F>(p, k);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float pr = __ldg(p.preds + ((int64_t)k * G + g) * slab + row);
          acc[g] = add_slot(acc[g], xt, pr, load_slot<G>(p, p.K, k, g, b),
                            conv, p.clamp);
        }
      }
    }
    float o;
    if constexpr (!STEP) {
      o = acc[0];
    } else if constexpr (G == 1) {
      o = xt - acc[0] * dt;
    } else {              // branch 0 = cond, 1 = uncond: u_u + s·(u_c − u_u)
      const float u = acc[1] + p.cfg_scale * (acc[0] - acc[1]);
      o = xt - u * dt;
    }
    p.out[row] = o;
  }
}

// One kernel name per form, so the profiler's categories keep their names.
template <int K, int G>
__global__ void __launch_bounds__(THREADS)
hetero_fuse_step_kernel(const FuseArgs p) {
  fuse_rows<K, G, Form::kStep>(p);
}

template <int K>
__global__ void __launch_bounds__(THREADS)
hetero_fuse_coeffs_kernel(const FuseArgs p) {
  fuse_rows<K, 1, Form::kCoeffs>(p);
}

template <int K>
__global__ void __launch_bounds__(THREADS)
hetero_fuse_flags_kernel(const FuseArgs p) {
  fuse_rows<K, 1, Form::kFlags>(p);
}

template <int K, int G, Form F>
void launch_one(const FuseArgs& p, cudaStream_t st) {
  const dim3 grid((p.T + THREADS - 1) / THREADS, p.B < 65535 ? p.B : 65535);
  if constexpr (F == Form::kStep)
    hetero_fuse_step_kernel<K, G><<<grid, THREADS, 0, st>>>(p);
  else if constexpr (F == Form::kCoeffs)
    hetero_fuse_coeffs_kernel<K><<<grid, THREADS, 0, st>>>(p);
  else
    hetero_fuse_flags_kernel<K><<<grid, THREADS, 0, st>>>(p);
}

// G 1 or 2 (1 for the velocity and flag forms).
template <int G, Form F>
int launch_rows(const FuseArgs& p, cudaStream_t st) {
  if ((int64_t)p.B * p.T > 0) {
    switch (p.K) {
      case 1: launch_one<1, G, F>(p, st); break;
      case 2: launch_one<2, G, F>(p, st); break;
      case 3: launch_one<3, G, F>(p, st); break;
      case 4: launch_one<4, G, F>(p, st); break;
      case 5: launch_one<5, G, F>(p, st); break;
      case 6: launch_one<6, G, F>(p, st); break;
      case 7: launch_one<7, G, F>(p, st); break;
      case 8: launch_one<8, G, F>(p, st); break;
      default: launch_one<0, G, F>(p, st);      // K > 8: runtime loop
    }
  }
  return static_cast<int>(cudaGetLastError());
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
// Launches on `stream`, allocates nothing, returns cudaGetLastError()
// (cudaErrorInvalidValue for another G).
extern "C" int hetero_fuse_step_f32(const float* preds, const float* x,
                                    const float* w, const float* coef,
                                    const float* dt, float* out, int K, int G,
                                    int B, int T, int dt_per_row,
                                    float cfg_scale, float clamp,
                                    float alpha_min, void* stream) {
  const FuseArgs p{preds, x, w, coef, dt, nullptr, out, K, B, T,
                   dt_per_row, cfg_scale, clamp, alpha_min};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G == 1) return launch_rows<1, Form::kStep>(p, st);
  if (G == 2) return launch_rows<2, Form::kStep>(p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// All operands contiguous float32 on the device.  Launches on `stream`,
// allocates nothing, returns cudaGetLastError().
extern "C" int hetero_fuse_coeffs_f32(const float* preds, const float* x,
                                      const float* w, const float* coef,
                                      float* out, int K, int B, int T,
                                      float clamp, float alpha_min,
                                      void* stream) {
  const FuseArgs p{preds, x, w, coef, nullptr, nullptr, out, K, B, T, 0, 1.f,
                   clamp, alpha_min};
  return launch_rows<1, Form::kCoeffs>(p, static_cast<cudaStream_t>(stream));
}

// All operands contiguous on the device: float32, except is_ddpm (K,)
// bytes (0 = FM, else DDPM).  Launches on `stream`, allocates nothing,
// returns cudaGetLastError().
extern "C" int hetero_fuse_flags_f32(const float* preds, const float* x,
                                     const float* w, const uint8_t* is_ddpm,
                                     const float* coef, float* out, int K,
                                     int B, int T, float clamp,
                                     float alpha_min, void* stream) {
  const FuseArgs p{preds, x, w, coef, nullptr, is_ddpm, out, K, B, T, 0,
                   1.f, clamp, alpha_min};
  return launch_rows<1, Form::kFlags>(p, static_cast<cudaStream_t>(stream));
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
