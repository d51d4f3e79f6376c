// Flash attention backward for Hopper (sm_90a): the gradients of
// flash_attention.cu's attention (causal and sliding-window masks,
// grouped kv heads, float32 or bf16) from its output and row
// log-sum-exp.  Its own source so that nvcc builds it beside the forward.

#include <math.h>

#include "flash_attention.cuh"
// ---- backward ------------------------------------------------------------
//
// The TPU kernel has no backward; this one replaces XLA's autodiff of the
// reference's training attention (repro/models/layers.py:137
// `chunked_attention`, f32_softmax: q·kᵀ and p·v contracted in float32 on
// float32 copies of the operands).  Causal and sliding-window masks,
// grouped kv heads, float32 or bf16 operands, D ≤ 128.  With
// P = exp(q·kᵀ·scale − lse) recomputed from the forward's row
// log-sum-exp, and Δ_i = Σ_d dO_id·O_id:
//
//   dV = Pᵀ·dO,   dS = P ∘ (dO·Vᵀ − Δ),   dQ = scale·dS·K,
//   dK = scale·dSᵀ·Q,
//
// dK and dV of a kv head summed over the query heads that read it.
//
// What bounds it on this card: float32 operations.  Five products over
// the (query, key) pairs a mask leaves open, a head (q·kᵀ and dO·vᵀ
// recomputed, Pᵀ·dO, dSᵀ·q, dS·k): at the DiT's training shape (32 × 12
// heads, S 256, D 64, float32) 16.1 GFLOP on 100 MB, 0.24 ms at 67
// TFLOP/s; at internlm2-1.8b's (B 4, 16 query heads over 8 kv heads of D
// 128, S 1024, causal, bf16) 43.0 GFLOP, 0.64 ms.  Every product is an
// IEEE float32 FFMA on the CUDA cores, as in the forward's template: bf16
// operands stay bf16 in shared memory and are widened exactly as they are
// read, so every product is the reference's float32 product.  dq, dk and
// dv are rounded once to their input's dtype at the end.  Δ is formed
// from the forward's output as stored (bf16-rounded for bf16).
//
// Three kernels, no atomics, every sum in a fixed order (the result is
// bitwise repeatable):
//   1. `flash_attention_bwd_delta`: Δ, 16 lanes a query row;
//   2. `flash_attention_bwd_tile`: one block per (b·kv head, key tile of
//      64) walks the query tiles of 64 rows that can see its keys, for each
//      query head of its group in order.  It keeps dK and dV for its keys
//      in registers (summed over the group on chip), forms S and dP once
//      per tile pair, then P and dS, and writes this key tile's share of
//      dQ, dS·K, to a float32 scratch: one 64-row share per open
//      (key tile, query tile) pair and query head;
//   3. `flash_attention_bwd_dq_sum`: dQ = scale · the shares written for
//      the row, added in key-tile order.
// So every product is formed once (five, the bound's count): recomputing
// S and dP for dQ in a kernel of its own would take seven.  The shares
// are sized by the open pairs (`pair_count`): causal at S 1024, 136 of
// the 256 tile pairs — 285 MB at internlm2's shape, 356 MB at zamba2's
// (32 heads of D 80), where all pairs would take 537 and 671 MB.  The
// scratch comes from torch.empty: a share is read only where a key tile
// wrote it.
//
// Masks: a key tile visits only the query tiles a mask leaves partly
// open (`q_tiles`); inside them a masked logit gives probability 0
// exactly, so dS is 0 there too.  Causal blocks run heaviest first: the
// grid is (b·kv head, key tile), the key tile in the slow dimension, so
// the low key tiles, which see the most query tiles, are dispatched
// first.
//
// Inside the tile kernel (256 threads, two groups of 128):
//   * q, k, v, dO tiles are staged as they lie by 16-byte cp.async, each
//     row an odd number of 16-byte chunks (the forward's `stage`); the
//     next (head, query tile) is in flight while this one's dQ share is
//     formed; unaligned views stage element by element in the same kernel;
//   * S = Q·Kᵀ (group 0) and dP = dO·Vᵀ (group 1) are register-tiled:
//     a thread owns 4 query rows × 8 keys, 12 shared loads per 128 FFMA;
//   * all 256 threads turn S and dP into P and dS (masked before expf:
//     rows and keys past S, and masked pairs, give 0), in shared memory
//     at BK + 8 floats a row (conflict-free stores, 16-byte reads);
//   * dV += Pᵀ·dO (group 0) and dK += dSᵀ·Q (group 1): a thread owns 4
//     keys × D/8 columns, 3 loads per 32 FFMA at D 64;
//   * dS·K: a thread owns 4 query rows × D/16 columns.
// At D 64 a block takes 105 KB of shared memory in float32 and 128
// registers a thread (no spills), two blocks an SM; four block barriers a
// query tile.  These register tiles give 2–2.7 FFMA per float a thread
// loads from shared memory, where the SM's 32 floats a clock against 128
// FFMA ask for 4.  Two answers measured slower in throwaway builds (same
// call, NVIDIA H100 80GB HBM3, 700 W): 8 × 8 tiles for every product in
// 128-thread blocks (254 registers, 8 warps an SM), and dS·K split over
// the two groups with 4 × 8 tiles and a fifth barrier (no faster).  So
// the kernel stays above its bound on shared-memory traffic and latency
// (PERF.md).  D 80 runs on the D ≤ 128 template, its lanes past D idle.

namespace {

namespace bwd {

constexpr int THREADS = 256;        // two groups of 128 threads
constexpr int BQ = 64, BK = 64;     // query rows, keys of a tile pair
constexpr int PP = BK + 8;          // pitch (floats) of the P and dS tiles
constexpr int MAX_KEY_TILES = 65535;  // grid y

// Shared bytes of a tile kernel: the k, v, q and dO tiles, P and dS, and
// the query tile's lse and Δ.
__host__ __device__ inline int tile_bytes(int D, int esize) {
  return (2 * BK + 2 * BQ) * row_pitch(D, esize) + 2 * BQ * PP * 4 +
         2 * BQ * 4;
}

// The query tiles [first, last) that key tile kt's keys are open to: from
// the key tile's own (causal; BQ == BK) or from 0, up to the tile of the
// last query whose window still holds the tile's last key.  Never empty:
// tile kt sees its own diagonal.
__host__ __device__ inline void q_tiles(int kt, int nqt, int causal,
                                        int window, int& first, int& last) {
  first = causal ? kt : 0;
  last = nqt;
  if (window > 0) {
    const long long qmax = (long long)kt * BK + BK - 1 + window - 1;
    if (qmax / BQ + 1 < nqt) last = static_cast<int>(qmax / BQ + 1);
  }
}

// Open (key tile, query tile) pairs of one head: the dQ shares per head.
__host__ __device__ inline long long pair_count(int S, int causal,
                                                int window) {
  const int nt = (S + BK - 1) / BK;
  long long n = 0;
  for (int kt = 0; kt < nt; ++kt) {
    int first, last;
    q_tiles(kt, nt, causal, window, first, last);
    n += last - first;
  }
  return n;
}

__device__ __forceinline__ float4 fma4(float a, float4 b, float4 c) {
  return make_float4(fmaf(a, b.x, c.x), fmaf(a, b.y, c.y), fmaf(a, b.z, c.z),
                     fmaf(a, b.w, c.w));
}

__device__ __forceinline__ float lane4(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Four float32 values to dst[0 .. 3] of T, rounded once: one 16-byte
// (float32) or 8-byte (bf16) store under VEC, else the first n alone.
template <typename T, bool VEC>
__device__ __forceinline__ void store4(T* dst, const float (&r)[4], int n) {
  if constexpr (VEC && sizeof(T) == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(r[0], r[1], r[2], r[3]);
  } else if constexpr (VEC) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(r[0], r[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(r[2], r[3]);
    *reinterpret_cast<uint2*>(dst) =
        make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                   *reinterpret_cast<const uint32_t*>(&hi));
  } else {
#pragma unroll
    for (int w = 0; w < 4; ++w)
      if (w < n) from_f32(dst + w, r[w]);
  }
}

// Δ[b·h, s] = Σ_d dO·O: 16 lanes a row (two rows a warp), each lane's
// columns in order, then a butterfly over the 16.  VEC: 4-element loads
// (D and the strides of o and dO multiples of 4, both bases 16-byte
// aligned).
template <typename T, bool VEC>
__global__ void __launch_bounds__(256)
flash_attention_bwd_delta(const T* __restrict__ o, const T* __restrict__ dO,
                          float* __restrict__ delta, int H, int S, int D,
                          Strides so, Strides sdo, int64_t rows) {
  const int64_t r = (int64_t)blockIdx.x * 16 + threadIdx.x / 16;
  const int lane = threadIdx.x & 15;
  float acc = 0.f;
  if (r < rows) {
    const int bh = static_cast<int>(r / S), s = static_cast<int>(r % S);
    const int b = bh / H, h = bh % H;
    const T* orow = o + b * so.b + h * so.h + (int64_t)s * so.s;
    const T* grow = dO + b * sdo.b + h * sdo.h + (int64_t)s * sdo.s;
    if constexpr (VEC) {
      for (int c = 4 * lane; c < D; c += 64) {
        const float4 a =
            lds4<T>(reinterpret_cast<const uint8_t*>(orow), c);
        const float4 g =
            lds4<T>(reinterpret_cast<const uint8_t*>(grow), c);
        acc = fmaf(g.x, a.x, acc);
        acc = fmaf(g.y, a.y, acc);
        acc = fmaf(g.z, a.z, acc);
        acc = fmaf(g.w, a.w, acc);
      }
    } else {
      for (int c = lane; c < D; c += 16)
        acc = fmaf(to_f32(grow[c]), to_f32(orow[c]), acc);
    }
  }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (r < rows && lane == 0) delta[r] = acc;
}

// Block (b·Hkv + kv head, key tile kt).  part: the dQ shares, (pairs,
// B·H, BQ, D4) float32 with D4 = D rounded up to 4, pairs ordered by key
// tile, then query tile (`q_tiles`).  VEC: D and every stride of q, k, v,
// dO, dK, dV whole 16-byte chunks of elements, every base 16-byte aligned.
template <typename T, int DMAX, bool VEC>
__global__ void __launch_bounds__(THREADS, DMAX <= 64 ? 2 : 1)
flash_attention_bwd_tile(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dO,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv,
                         float* __restrict__ part, int H, int Hkv, int S,
                         int D, Strides sq, Strides sk, Strides sv,
                         Strides sdo, Strides sdk, Strides sdv, int causal,
                         int window, float scale) {
  constexpr int NC = DMAX / 32;    // 4-column chunks of a thread's dK/dV row
  constexpr int NQ = DMAX / 64;    // 4-column chunks of a thread's dQ row
  extern __shared__ __align__(16) uint8_t smem[];
  const int pitch = row_pitch(D, sizeof(T));
  uint8_t* Ks = smem;
  uint8_t* Vs = Ks + BK * pitch;
  uint8_t* Qs = Vs + BK * pitch;
  uint8_t* dOs = Qs + BQ * pitch;
  float* Ps = reinterpret_cast<float*>(dOs + BQ * pitch);   // S, then P
  float* dSs = Ps + BQ * PP;                                 // dP, then dS
  float* Ls = dSs + BQ * PP;
  float* Ds = Ls + BQ;

  const int group = H / Hkv;
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int kt = blockIdx.y, k0 = kt * BK;
  const int nqt = (S + BQ - 1) / BQ;
  int first, last;
  q_tiles(kt, nqt, causal, window, first, last);
  const int per_head = last - first, n_it = group * per_head;
  const int BH = gridDim.x * group;  // B·H
  const int D4 = (D + 3) & ~3;
  // this key tile's shares: its first pair less `first`, so that query
  // tile qt's share of head bh starts at ((qt · BH) + bh) · BQ · D4; in
  // shared memory, read where a share is written
  __shared__ float* part_kt;
  if (threadIdx.x == 0) {
    int64_t pair0 = 0;
    for (int j = 0; j < kt; ++j) {
      int f, l;
      q_tiles(j, nqt, causal, window, f, l);
      pair0 += l - f;
    }
    part_kt = part + (pair0 - first) * BH * BQ * D4;
  }
  const int tid = threadIdx.x, grp = tid >> 7, t = tid & 127;
  // S, dP: rows rg + 16i, keys kg + 8j.  dK, dV: keys 4ka + u, columns
  // 4ca + 32m.  P, dS and dS·K: rows rq + 16i, columns 4cq (+ 64m).
  const int rg = t >> 3, kg = t & 7;
  const int ka = t >> 3, ca = t & 7;
  const int rq = tid >> 4, cq = tid & 15;

  // iteration it: query head hk·group + it / per_head, query tile
  // first + it % per_head
  const auto head_of = [&](int it) { return hk * group + it / per_head; };
  const auto q0_of = [&](int it) { return (first + it % per_head) * BQ; };
  const auto qh_of = [&](int h) { return q + b * sq.b + h * sq.h; };
  const auto gh_of = [&](int h) { return dO + b * sdo.b + h * sdo.h; };

  stage<T, DMAX, VEC, THREADS>(Ks, pitch, k + b * sk.b + hk * sk.h, sk.s,
                               k0, BK, S, D);
  stage<T, DMAX, VEC, THREADS>(Vs, pitch, v + b * sv.b + hk * sv.h, sv.s,
                               k0, BK, S, D);
  {
    const int h = head_of(0), q0 = q0_of(0);
    stage<T, DMAX, VEC, THREADS>(Qs, pitch, qh_of(h), sq.s, q0, BQ, S, D);
    stage<T, DMAX, VEC, THREADS>(dOs, pitch, gh_of(h), sdo.s, q0, BQ, S, D);
    if (tid < BQ) {
      const int64_t row = (int64_t)(b * H + h) * S + q0 + tid;
      Ls[tid] = q0 + tid < S ? lse[row] : 0.f;
      Ds[tid] = q0 + tid < S ? delta[row] : 0.f;
    }
  }
  hopper::cp_async_commit();

  float4 acc[4][NC];               // dV (group 0) or dK (group 1)
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int m = 0; m < NC; ++m) acc[u][m] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int it = 0; it < n_it; ++it) {
    // the next iteration's lse and Δ, in flight through this one (the
    // indices derived from `it` where they are used, not held: at D 64 a
    // thread has 128 registers)
    float l_next = 0.f, d_next = 0.f;
    if (it + 1 < n_it && tid < BQ && q0_of(it + 1) + tid < S) {
      const int64_t row =
          (int64_t)(b * H + head_of(it + 1)) * S + q0_of(it + 1) + tid;
      l_next = lse[row];
      d_next = delta[row];
    }
    hopper::cp_async_wait<0>();
    __syncthreads();                       // (1) this query tile is staged

    // S = Q·Kᵀ (group 0) or dP = dO·Vᵀ (group 1), 4 head-dim values at a
    // time: 4 + 8 shared loads per 128 FFMA.
    {
      const uint8_t* As = grp ? dOs : Qs;
      const uint8_t* Bs = grp ? Vs : Ks;
      float s[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
      for (int d0 = 0; d0 < D4; d0 += 4) {
        float4 af[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          af[i] = lds4<T>(As + (rg + 16 * i) * pitch, d0);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 bf = lds4<T>(Bs + (kg + 8 * j) * pitch, d0);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            s[i][j] = fmaf(af[i].x, bf.x, s[i][j]);
            s[i][j] = fmaf(af[i].y, bf.y, s[i][j]);
            s[i][j] = fmaf(af[i].z, bf.z, s[i][j]);
            s[i][j] = fmaf(af[i].w, bf.w, s[i][j]);
          }
        }
      }
      float* out = grp ? dSs : Ps;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          out[(rg + 16 * i) * PP + kg + 8 * j] = s[i][j];
    }
    __syncthreads();                       // (2) S and dP are in shared

    // P = exp(S·scale − lse), dS = P ∘ (dP − Δ); masked entries are 0.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rq + 16 * i, qpos = q0_of(it) + r;
      const float L = Ls[r], dl = Ds[r];
      float* pr = Ps + r * PP + 4 * cq;
      float* dr = dSs + r * PP + 4 * cq;
      const float4 sv4 = *reinterpret_cast<const float4*>(pr);
      const float4 dp4 = *reinterpret_cast<const float4*>(dr);
      float p[4], ds[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int kpos = k0 + 4 * cq + u;
        const bool open = qpos < S && kpos < S &&
                          (!causal || kpos <= qpos) &&
                          (window <= 0 || qpos - kpos < window);
        p[u] = open ? expf(lane4(sv4, u) * scale - L) : 0.f;
        ds[u] = p[u] * (lane4(dp4, u) - dl);
      }
      *reinterpret_cast<float4*>(pr) = make_float4(p[0], p[1], p[2], p[3]);
      *reinterpret_cast<float4*>(dr) = make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();                       // (3) P and dS are in shared

    // dV += Pᵀ·dO (group 0), dK += dSᵀ·Q (group 1), one query row at a
    // time: 1 + NC loads per 16·NC FFMA.
    {
      const float* Ms = grp ? dSs : Ps;
      const uint8_t* Os = grp ? Qs : dOs;
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        const float4 pf =
            *reinterpret_cast<const float4*>(Ms + r * PP + 4 * ka);
#pragma unroll
        for (int m = 0; m < NC; ++m) {
          const int col = 4 * ca + 32 * m;
          if (col >= D) continue;
          const float4 of = lds4<T>(Os + r * pitch, col);
          acc[0][m] = fma4(pf.x, of, acc[0][m]);
          acc[1][m] = fma4(pf.y, of, acc[1][m]);
          acc[2][m] = fma4(pf.z, of, acc[2][m]);
          acc[3][m] = fma4(pf.w, of, acc[3][m]);
        }
      }
    }
    __syncthreads();                       // (4) Q and dO are consumed
    if (it + 1 < n_it) {
      const int h_next = head_of(it + 1), q0_next = q0_of(it + 1);
      stage<T, DMAX, VEC, THREADS>(Qs, pitch, qh_of(h_next), sq.s, q0_next,
                                   BQ, S, D);
      stage<T, DMAX, VEC, THREADS>(dOs, pitch, gh_of(h_next), sdo.s,
                                   q0_next, BQ, S, D);
      if (tid < BQ) {
        Ls[tid] = l_next;
        Ds[tid] = d_next;
      }
    }
    hopper::cp_async_commit();

    // This key tile's share of dQ: dS·K, 4 keys at a time: 4 + 4·NQ loads
    // per 64·NQ FFMA.
    float4 dq[4][NQ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int m = 0; m < NQ; ++m) dq[i][m] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j0 = 0; j0 < BK; j0 += 4) {
      float4 df[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        df[i] = *reinterpret_cast<const float4*>(dSs + (rq + 16 * i) * PP + j0);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int m = 0; m < NQ; ++m) {
          const int col = 4 * cq + 64 * m;
          if (col >= D) continue;
          const float4 kf = lds4<T>(Ks + (j0 + u) * pitch, col);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            dq[i][m] = fma4(lane4(df[i], u), kf, dq[i][m]);
        }
    }
    const int q0 = q0_of(it);
    float* ph = part_kt +
                ((int64_t)(q0 / BQ) * BH + b * H + head_of(it)) * BQ * D4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rq + 16 * i;
      if (q0 + r >= S) continue;
#pragma unroll
      for (int m = 0; m < NQ; ++m) {
        const int col = 4 * cq + 64 * m;
        if (col < D)
          *reinterpret_cast<float4*>(ph + (int64_t)r * D4 + col) = dq[i][m];
      }
    }
  }

  // dV (group 0), dK = scale · dSᵀ·Q (group 1), in T
  T* oh = grp ? dk + b * sdk.b + hk * sdk.h : dv + b * sdv.b + hk * sdv.h;
  const int64_t ss = grp ? sdk.s : sdv.s;
  const float sc = grp ? scale : 1.f;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int key = k0 + 4 * ka + u;
    if (key >= S) continue;
    T* row = oh + (int64_t)key * ss;
#pragma unroll
    for (int m = 0; m < NC; ++m) {
      const int col = 4 * ca + 32 * m;
      if (col >= D) continue;
      const float r[4] = {acc[u][m].x * sc, acc[u][m].y * sc,
                          acc[u][m].z * sc, acc[u][m].w * sc};
      store4<T, VEC>(row + col, r, D - col);
    }
  }
}

// dQ = scale · Σ_kt part[kt], over the key tiles that wrote the row's
// query tile, added in key-tile order; one thread per 4 columns of a row,
// written in T.  VEC: dq's strides a multiple of 4, base 16-byte aligned,
// D % 4 == 0.
template <typename T, bool VEC>
__global__ void __launch_bounds__(256)
flash_attention_bwd_dq_sum(const float* __restrict__ part, T* __restrict__ dq,
                           int H, int S, int D, int causal, int window,
                           Strides sdq, float scale, int64_t rows) {
  const int D4 = (D + 3) & ~3, c4 = D4 / 4;
  const int64_t i = (int64_t)blockIdx.x * 256 + threadIdx.x;
  if (i >= rows * c4) return;
  const int64_t row = i / c4;
  const int col = static_cast<int>(i % c4) * 4;
  const int bh = static_cast<int>(row / S), qpos = static_cast<int>(row % S);
  const int qt = qpos / BQ, nt = (S + BK - 1) / BK;
  const int64_t BH = rows / S;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  int64_t pair0 = 0;
  for (int kt = 0; kt < nt; ++kt) {
    int first, last;
    q_tiles(kt, nt, causal, window, first, last);
    if (qt >= first && qt < last) {
      const float4 x = *reinterpret_cast<const float4*>(
          part + ((pair0 + qt - first) * BH + bh) * BQ * D4 +
          (int64_t)(qpos % BQ) * D4 + col);
      s = make_float4(s.x + x.x, s.y + x.y, s.z + x.z, s.w + x.w);
    }
    pair0 += last - first;
  }
  T* dst = dq + (bh / H) * sdq.b + (bh % H) * sdq.h + (int64_t)qpos * sdq.s +
           col;
  const float r[4] = {s.x * scale, s.y * scale, s.z * scale, s.w * scale};
  store4<T, VEC>(dst, r, D - col);
}

int64_t partial_floats(int B, int H, int S, int D, int causal, int window) {
  return pair_count(S, causal, window) * B * H * BQ * ((D + 3) & ~3);
}

template <typename T, int DMAX>
int launch(const T* q, const T* k, const T* v, const T* o, const T* dO,
           const float* lse, float* scratch, T* dq, T* dk, T* dv, int B,
           int H, int Hkv, int S, int D, Strides sq, Strides sk, Strides sv,
           Strides so, Strides sdo, Strides sdq, Strides sdk, Strides sdv,
           int causal, int window, float scale, cudaStream_t stream) {
  const int nkt = (S + BK - 1) / BK;
  if (nkt > MAX_KEY_TILES) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t rows = (int64_t)B * H * S;
  float* part = scratch;
  float* delta = scratch + partial_floats(B, H, S, D, causal, window);
  const int ev = 16 / static_cast<int>(sizeof(T));
  // (a stride of an axis of length 1 is never used)
  const auto rows_ok = [&](const Strides& st, int heads, int e) {
    return (B == 1 || st.b % e == 0) && (heads == 1 || st.h % e == 0) &&
           st.s % e == 0;
  };
  const auto aligned = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  };

  const unsigned dblocks = static_cast<unsigned>((rows + 15) / 16);
  if (D % 4 == 0 && rows_ok(so, H, 4) && rows_ok(sdo, H, 4) && aligned(o) &&
      aligned(dO))
    flash_attention_bwd_delta<T, true><<<dblocks, 256, 0, stream>>>(
        o, dO, delta, H, S, D, so, sdo, rows);
  else
    flash_attention_bwd_delta<T, false><<<dblocks, 256, 0, stream>>>(
        o, dO, delta, H, S, D, so, sdo, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool vec = D % ev == 0 && rows_ok(sq, H, ev) &&
                   rows_ok(sk, Hkv, ev) && rows_ok(sv, Hkv, ev) &&
                   rows_ok(sdo, H, ev) && rows_ok(sdk, Hkv, ev) &&
                   rows_ok(sdv, Hkv, ev) && aligned(q) && aligned(k) &&
                   aligned(v) && aligned(dO) && aligned(dk) && aligned(dv);
  auto kern = vec ? flash_attention_bwd_tile<T, DMAX, true>
                  : flash_attention_bwd_tile<T, DMAX, false>;
  const int smem = tile_bytes(D, sizeof(T));
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<dim3(B * Hkv, nkt), THREADS, smem, stream>>>(
      q, k, v, dO, lse, delta, dk, dv, part, H, Hkv, S, D, sq, sk, sv, sdo,
      sdk, sdv, causal, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  const int64_t n4 = rows * (((D + 3) & ~3) / 4);
  const unsigned blocks = static_cast<unsigned>((n4 + 255) / 256);
  if (D % 4 == 0 && rows_ok(sdq, H, 4) && aligned(dq))
    flash_attention_bwd_dq_sum<T, true><<<blocks, 256, 0, stream>>>(
        part, dq, H, S, D, causal, window, sdq, scale, rows);
  else
    flash_attention_bwd_dq_sum<T, false><<<blocks, 256, 0, stream>>>(
        part, dq, H, S, D, causal, window, sdq, scale, rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_width(const void* q, const void* k, const void* v, const void* o,
             const void* dO, const void* lse, void* scratch, void* dq,
             void* dk, void* dv, int B, int H, int Hkv, int S, int D,
             const Strides* st, int causal, int window, float scale,
             cudaStream_t cs) {
  const auto c = [](const void* p) { return static_cast<const T*>(p); };
  const auto w = [](void* p) { return static_cast<T*>(p); };
  const float* l = static_cast<const float*>(lse);
  float* sc = static_cast<float*>(scratch);
  if (D <= 64)
    return launch<T, 64>(c(q), c(k), c(v), c(o), c(dO), l, sc, w(dq), w(dk),
                         w(dv), B, H, Hkv, S, D, st[0], st[1], st[2], st[3],
                         st[4], st[5], st[6], st[7], causal, window, scale,
                         cs);
  return launch<T, 128>(c(q), c(k), c(v), c(o), c(dO), l, sc, w(dq), w(dk),
                        w(dv), B, H, Hkv, S, D, st[0], st[1], st[2], st[3],
                        st[4], st[5], st[6], st[7], causal, window, scale,
                        cs);
}

}  // namespace bwd

}  // namespace

// Float32 scratch the backward needs: the dQ shares of every open (key
// tile, query tile) pair of every query head, then Δ (B·H·S).
extern "C" long long flash_attention_bwd_scratch(int B, int H, int S, int D,
                                                 int causal, int window) {
  return bwd::partial_floats(B, H, S, D, causal, window) +
         (long long)B * H * S;
}

// Backward of attention.  q, o, dO, dq: (B, H, S, D); k, v, dk, dv:
// (B, Hkv, S, D) with H % Hkv == 0; each by element strides (batch, head,
// position) with a contiguous last axis, in the order q, k, v, o, dO, dq,
// dk, dv; all float32 (bf16 = 0) or all bf16 (bf16 = 1).  lse: the
// forward's contiguous float32 (B·H, S) row log-sum-exp; scratch:
// flash_attention_bwd_scratch(B, H, S, D, causal, window) floats, 16-byte
// aligned.  causal, window as the forward's (window ≤ 0: none).  D ≤ 128,
// S ≤ 65,535 key tiles of 64.  Launches three kernels on `stream`,
// allocates nothing, returns the CUDA error code (0 on success).
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dO, const void* lse, void* scratch, void* dq, void* dk,
    void* dv, int bf16, int B, int H, int Hkv, int S, int D,
    const long long* strides, int causal, int window, float scale,
    void* stream) {
  if (B == 0 || H == 0 || S == 0 || D == 0) return 0;
  if (D > 128 || Hkv <= 0 || H % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st[8];
  for (int i = 0; i < 8; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (bf16)
    return bwd::by_width<__nv_bfloat16>(q, k, v, o, dO, lse, scratch, dq, dk,
                                        dv, B, H, Hkv, S, D, st, causal,
                                        window, scale, cs);
  return bwd::by_width<float>(q, k, v, o, dO, lse, scratch, dq, dk, dv, B, H,
                              Hkv, S, D, st, causal, window, scale, cs);
}
