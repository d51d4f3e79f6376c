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
// (67 TFLOP/s) overtakes HBM (3.35 TB/s): 0.096 ms.  Tensor cores (TF32 or
// bf16) are excluded on purpose: the reference contracts q·k and p·v in
// full float32, so every product is an IEEE float32 FFMA.
//
// What stands between the FFMA units and that bound is shared memory: an
// SM moves 128 bytes a clock from shared memory to registers, 32 floats
// against 128 FFMA, so every staged float must feed several products.
// The design:
//   * a block of THREADS / 8 row groups × 8 column groups; a thread owns
//     TR query rows, BKV / 8 keys of each kv tile and D / 8 output
//     columns, so S = Q·Kᵀ and O += P·V are register-tiled products that
//     read their operands as 16-byte shared loads (8-byte for bf16, which
//     stays bf16 in shared memory and is widened exactly as it is read);
//   * q, k and v rows are staged as they lie, each row an odd number of
//     16-byte chunks, so the 8 rows a warp reads at once hit 8 different
//     bank groups; P is written row-major at BKV + 8 floats a row
//     (conflict-free stores) and read back by the warp that wrote it
//     (a __syncwarp, not a block barrier);
//   * k and v go through a 2-stage ring of 16-byte cp.async: tile t + 1
//     is in flight while tile t is computed, one block barrier a tile;
//     the query tile is staged once;
//   * operands off 16-byte alignment (D, a stride or a base) stage the
//     same tiles element by element in the same kernel.
// At D 64 a block is 256 threads over 128 query rows with kv tiles of 32
// keys: 90 KB of shared memory, two blocks an SM.  Larger register tiles
// (8 rows × 8 keys) need larger shared tiles, which leave fewer warps an
// SM to hide the softmax's shuffles and exponentials: they measured
// slower in throwaway builds, as did 128-thread blocks of 64 rows.  So
// the kernel stays above its bound on shared-memory traffic and latency,
// not on FFMA issue (PERF.md, chip_smoke on an NVIDIA H100 80GB HBM3,
// 700 W).
//
// Only the kv tiles a mask leaves partly open are visited (causal and
// window bounds per query tile); inside them every masked logit is dropped
// exactly (probability 0), and a tile no mask touches skips the mask
// test.  Partial tiles (S not a multiple of the tile) are zero-filled and
// masked.  The row maximum and sum reduce over the 8 lanes that share a
// row with shuffles.  The output is acc / max(l, 1e-30), as the TPU kernel
// finalises it.  expf and IEEE division: no fast-math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

// Per largest head dim a template instance takes: THREADS threads as
// THREADS / 8 row groups × 8 column groups, TR query rows per thread (a
// block holds THREADS / 8 · TR rows), BKV keys per kv tile, and MINB blocks
// an SM holds (by shared memory at D = DMAX, float32).
template <int DMAX> struct Config;
template <> struct Config<32> {
  static constexpr int THREADS = 128, TR = 4, BKV = 64, MINB = 3;
};
template <> struct Config<64> {
  static constexpr int THREADS = 256, TR = 4, BKV = 32, MINB = 2;
};
template <> struct Config<128> {
  static constexpr int THREADS = 128, TR = 4, BKV = 64, MINB = 1;
};
template <> struct Config<256> {
  static constexpr int THREADS = 128, TR = 4, BKV = 32, MINB = 1;
};

struct Strides {
  int64_t b, h, s;
};

// A staged q, k or v row: D elements in an odd number of 16-byte chunks,
// so that 8 neighbouring rows start in 8 different bank groups.
__host__ __device__ inline int row_pitch(int D, int esize) {
  return (((D * esize + 15) / 16) | 1) * 16;
}

// Shared bytes of a launch: the query tile, two k and two v tiles, and the
// probability tile (BKV + 8 floats a row: conflict-free stores and
// 16-byte reads).
__host__ __device__ inline int smem_bytes(int D, int esize, int BQ,
                                          int BKV) {
  return (BQ + 4 * BKV) * row_pitch(D, esize) + BQ * (BKV + 8) * 4;
}

// Elements d .. d + 3 of a staged row of T, as float32 (bf16 widened
// exactly).
template <typename T>
__device__ __forceinline__ float4 lds4(const uint8_t* row, int d) {
  if constexpr (sizeof(T) == 4) {
    return *reinterpret_cast<const float4*>(row + 4 * d);
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(row + 2 * d);
    return make_float4(__uint_as_float(v.x << 16),
                       __uint_as_float(v.x & 0xFFFF0000u),
                       __uint_as_float(v.y << 16),
                       __uint_as_float(v.y & 0xFFFF0000u));
  }
}

__device__ __forceinline__ void from_f32(float* o, float v) { *o = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* o, float v) {
  *o = __float2bfloat16_rn(v);
}

// Reductions over the 8 lanes that share a query row.
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 4; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 4; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Rows [row0, row0 + n) of one head into shared memory as they lie, rows
// past S zero-filled: 16-byte cp.async (VEC), else element by element with
// the chunk past D zero-filled.
template <typename T, int DMAX, bool VEC>
__device__ __forceinline__ void stage(uint8_t* dst, int pitch,
                                      const T* __restrict__ src, int64_t ss,
                                      int row0, int n, int S, int D) {
  using R = typename std::conditional<sizeof(T) == 4, uint32_t,
                                      uint16_t>::type;  // raw bits
  constexpr int EV = 16 / sizeof(T);      // elements per chunk
  constexpr int CPR = DMAX / EV;          // chunks per row, at most
  const int cpr = (D + EV - 1) / EV;
  for (int i = threadIdx.x; i < n * CPR; i += Config<DMAX>::THREADS) {
    const int r = i / CPR, ch = i % CPR;
    if (ch >= cpr) continue;
    const int pos = row0 + r;
    uint8_t* d = dst + r * pitch + ch * 16;
    const T* g = src + (int64_t)pos * ss + ch * EV;
    if constexpr (VEC) {
      hopper::cp_async16(hopper::smem_u32(d), pos < S ? g : src,
                         pos < S ? 16 : 0);
    } else {
#pragma unroll
      for (int u = 0; u < EV; ++u)
        reinterpret_cast<R*>(d)[u] =
            pos < S && ch * EV + u < D ? reinterpret_cast<const R*>(g)[u]
                                       : R(0);
    }
  }
}

// One block per (batch·head, RG·TR query rows), RG = THREADS / 8; thread
// (rg, cg) owns query rows rg + RG·i (i < TR), keys cg + 8j of each kv tile
// (j < BKV / 8) and output columns 32c + 4cg + (0..3).  VEC: D and every
// stride a multiple of 16 bytes' elements, every base 16-byte aligned.
template <typename T, int DMAX, bool VEC>
__global__ void __launch_bounds__(Config<DMAX>::THREADS, Config<DMAX>::MINB)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int H,
                       int group, int S, int D, Strides sq, Strides sk,
                       Strides sv, Strides so, int causal, int window,
                       float scale) {
  constexpr int TR = Config<DMAX>::TR, BKV = Config<DMAX>::BKV;
  constexpr int RG = Config<DMAX>::THREADS / 8;  // row groups
  constexpr int BQ = RG * TR, TK = BKV / 8, NC = DMAX / 32;
  constexpr int PP = BKV + 8;

  extern __shared__ __align__(16) uint8_t smem[];
  const int pitch = row_pitch(D, sizeof(T));
  uint8_t* Qs = smem;
  uint8_t* Ks = Qs + BQ * pitch;   // two stages
  uint8_t* Vs = Ks + 2 * BKV * pitch;
  float* Ps = reinterpret_cast<float*>(Vs + 2 * BKV * pitch);

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H, hk = h / group;
  const int q0 = blockIdx.x * BQ;
  const int lane = threadIdx.x & 31;
  const int rg = threadIdx.x >> 3, cg = lane & 7;

  const T* qh = q + b * sq.b + h * sq.h;
  const T* kh = k + b * sk.b + hk * sk.h;
  const T* vh = v + b * sv.b + hk * sv.h;

  // kv range this query tile can see: [lo, hi).
  int hi = S;
  if (causal) hi = min(S, q0 + BQ);
  int lo = 0;
  if (window > 0) lo = max(0, q0 - (window - 1));
  lo = (lo / BKV) * BKV;

  stage<T, DMAX, VEC>(Qs, pitch, qh, sq.s, q0, BQ, S, D);
  stage<T, DMAX, VEC>(Ks, pitch, kh, sk.s, lo, BKV, S, D);
  stage<T, DMAX, VEC>(Vs, pitch, vh, sv.s, lo, BKV, S, D);
  hopper::cp_async_commit();

  float m[TR], l[TR], acc[TR][4 * NC];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.f;
  }

  const int D4 = (D + 3) & ~3;
  for (int k0 = lo, t = 0; k0 < hi; k0 += BKV, ++t) {
    // tile t has landed and every thread is done with tile t − 1, whose
    // stage now takes tile t + 1
    hopper::cp_async_wait<0>();
    __syncthreads();
    if (k0 + BKV < hi) {
      const int nxt = ((t + 1) & 1) * BKV * pitch;
      stage<T, DMAX, VEC>(Ks + nxt, pitch, kh, sk.s, k0 + BKV, BKV, S, D);
      stage<T, DMAX, VEC>(Vs + nxt, pitch, vh, sv.s, k0 + BKV, BKV, S, D);
    }
    hopper::cp_async_commit();
    const uint8_t* ks = Ks + (t & 1) * BKV * pitch;
    const uint8_t* vs = Vs + (t & 1) * BKV * pitch;

    // S = Q·Kᵀ, 4 head-dim values at a time: TR + TK 16-byte loads (8-byte
    // for bf16) per 4·TR·TK FFMA.
    float s[TR][TK];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TK; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d0 = 0; d0 < D4; d0 += 4) {
      float4 qf[TR];
#pragma unroll
      for (int i = 0; i < TR; ++i)
        qf[i] = lds4<T>(Qs + (rg + RG * i) * pitch, d0);
#pragma unroll
      for (int j = 0; j < TK; ++j) {
        const float4 kf = lds4<T>(ks + (cg + 8 * j) * pitch, d0);
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          s[i][j] = fmaf(qf[i].x, kf.x, s[i][j]);
          s[i][j] = fmaf(qf[i].y, kf.y, s[i][j]);
          s[i][j] = fmaf(qf[i].z, kf.z, s[i][j]);
          s[i][j] = fmaf(qf[i].w, kf.w, s[i][j]);
        }
      }
    }

    // Online softmax: masked logits are dropped exactly (probability 0).
    const bool open_tile = !causal && window <= 0 && k0 + BKV <= S;
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int qpos = q0 + rg + RG * i;
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < TK; ++j) {
        const int kpos = k0 + cg + 8 * j;
        const bool open = open_tile ||
                          (kpos < S && (!causal || kpos <= qpos) &&
                           (window <= 0 || qpos - kpos < window));
        s[i][j] = open ? s[i][j] * scale : -INFINITY;
        tmax = fmaxf(tmax, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(tmax));
      // a row with nothing open yet keeps m = -inf and adds nothing
      const float alpha = m_new == -INFINITY ? 1.f : expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < TK; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_new);
        Ps[(rg + RG * i) * PP + cg + 8 * j] = p;
        rsum += p;
      }
      l[i] = l[i] * alpha + row_sum(rsum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();                  // a warp reads only its own P rows

    // O += P·V, 4 keys at a time: TR + 4·NC loads per 16·TR·NC FFMA.
#pragma unroll
    for (int j0 = 0; j0 < BKV; j0 += 4) {
      float4 pf[TR];
#pragma unroll
      for (int i = 0; i < TR; ++i)
        pf[i] =
            *reinterpret_cast<const float4*>(Ps + (rg + RG * i) * PP + j0);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const uint8_t* vrow = vs + (j0 + u) * pitch;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int col = 32 * c + 4 * cg;
          if (col >= D) continue;
          const float4 vf = lds4<T>(vrow, col);
#pragma unroll
          for (int i = 0; i < TR; ++i) {
            const float pv = u == 0 ? pf[i].x : u == 1 ? pf[i].y
                           : u == 2 ? pf[i].z : pf[i].w;
            acc[i][4 * c] = fmaf(pv, vf.x, acc[i][4 * c]);
            acc[i][4 * c + 1] = fmaf(pv, vf.y, acc[i][4 * c + 1]);
            acc[i][4 * c + 2] = fmaf(pv, vf.z, acc[i][4 * c + 2]);
            acc[i][4 * c + 3] = fmaf(pv, vf.w, acc[i][4 * c + 3]);
          }
        }
      }
    }
  }

  T* oh = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int qpos = q0 + rg + RG * i;
    if (qpos >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = 32 * c + 4 * cg;
      if (col >= D) continue;
      T* dst = oh + (int64_t)qpos * so.s + col;
      float r[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) r[u] = acc[i][4 * c + u] / denom;
      if constexpr (VEC && sizeof(T) == 4) {
        *reinterpret_cast<float4*>(dst) = make_float4(r[0], r[1], r[2], r[3]);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (col + u < D) from_f32(dst + u, r[u]);
      }
    }
  }
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int Hkv, int S, int D, Strides sq, Strides sk, Strides sv,
           Strides so, int causal, int window, float scale,
           cudaStream_t stream) {
  using C = Config<DMAX>;
  constexpr int BQ = C::THREADS / 8 * C::TR, BKV = C::BKV;
  constexpr int EV = 16 / sizeof(T);
  const int smem = smem_bytes(D, sizeof(T), BQ, BKV);
  // (a stride of an axis of length 1 is never used)
  const auto rows_ok = [&](const Strides& st, int heads) {
    return (B == 1 || st.b % EV == 0) && (heads == 1 || st.h % EV == 0) &&
           st.s % EV == 0;
  };
  const auto aligned = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  };
  const bool vec = D % EV == 0 && rows_ok(sq, H) && rows_ok(so, H) &&
                   rows_ok(sk, Hkv) && rows_ok(sv, Hkv) && aligned(q) &&
                   aligned(k) && aligned(v) && aligned(o);
  auto kern = vec ? flash_attention_kernel<T, DMAX, true>
                  : flash_attention_kernel<T, DMAX, false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  kern<<<grid, Config<DMAX>::THREADS, smem, stream>>>(
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
