// Flash attention backward for Hopper (sm_90a): the gradients of
// flash_attention.cu's attention (causal, prefix-LM and sliding-window
// masks, grouped kv heads, float32 or bf16) from its output and row
// log-sum-exp, Sq query rows over Skv keys (equal lengths under a mask).
// Its own source so that nvcc builds it beside the forward.

#include <math.h>

#include "flash_attention.cuh"
// ---- backward ------------------------------------------------------------
//
// The TPU kernel has no backward; this one replaces XLA's autodiff of the
// reference's training attention (repro/models/layers.py:137
// `chunked_attention`, f32_softmax: q·kᵀ and p·v contracted in float32 on
// float32 copies of the operands).  Causal, prefix-LM (`kpos ≤ max(qpos,
// P − 1)`, the forward's) and sliding-window masks, grouped kv heads,
// float32 or bf16 operands, D ≤ 256 (D ≤ 128 on the tensor cores).  With
// P = exp(q·kᵀ·scale − lse) recomputed from the forward's row
// log-sum-exp, and Δ_i = Σ_d dO_id·O_id:
//
//   dV = Pᵀ·dO,   dS = P ∘ (dO·Vᵀ − Δ),   dQ = scale·dS·K,
//   dK = scale·dSᵀ·Q,
//
// dK and dV of a kv head summed over the query heads that read it.
//
// Two routes, picked by shape (the rule is `flash_attention_bwd` at the
// end of this file, as the forward's): bf16 with D a multiple of 16 up to
// 128, 16-byte staging of every operand and gradient and no prefix goes to
// two tensor-core kernels (`bwd::tc`, their design written above them);
// everything else — float32 (the DiT's training backward), bf16 at another
// D, unaligned views, any prefix — goes to the FFMA tile kernel below.  A
// failed launch of either route returns its error; neither falls back to
// the other.
//
// The FFMA route.  What bounds it on this card: float32 operations.  Five
// products over the (query, key) pairs a mask leaves open, a head (q·kᵀ
// and dO·vᵀ recomputed, Pᵀ·dO, dSᵀ·q, dS·k): at the DiT's training shape
// (32 × 12 heads, S 256, D 64, float32) 16.1 GFLOP on 100 MB, 0.24 ms at
// 67 TFLOP/s.  Every product is an IEEE float32 FFMA on the CUDA cores, as
// in the forward's template: bf16 operands (the shapes the tensor-core
// route does not take) stay bf16 in shared memory and are widened exactly
// as they are read, so every product is the reference's float32 product.
// dq, dk and dv are rounded once to their input's dtype at the end.  Δ is
// formed from the forward's output as stored (bf16-rounded for bf16).
//
// Three kernels, no atomics, every sum in a fixed order (the result is
// bitwise repeatable):
//   1. `flash_attention_bwd_delta`: Δ, 16 lanes a query row;
//   2. `flash_attention_bwd_tile`: one block per (b·kv head, key tile of
//      64; of 32 at D > 128) walks the query tiles of 64 rows that can see
//      its keys, for each
//      query head of its group in order.  It keeps dK and dV for its keys
//      in registers (summed over the group on chip), forms S and dP once
//      per tile pair, then P and dS, and writes this key tile's share of
//      dQ, dS·K, to a float32 scratch: one 64-row share per open
//      (key tile, query tile) pair and query head;
//   3. `flash_attention_bwd_dq_sum`: dQ = scale · the shares written for
//      the row, added in key-tile order.
// So every product is formed once (five, the bound's count).  The shares
// are sized by the open pairs (`pair_count`): causal at S 1024, 136 of
// the 256 tile pairs.  The scratch comes from torch.empty: a share is read
// only where a key tile wrote it.
//
// Masks: a key tile visits only the query tiles a mask leaves partly
// open (`q_tiles`: under a prefix, a key tile that starts below P sees
// every query tile); inside them a masked logit gives probability 0
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
//     rows past Sq, keys past Skv and masked pairs give 0), in shared memory
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
// (PERF.md).  A D from 65 to 128 runs on the D ≤ 128 template, its lanes
// past D idle.
//
// D > 128 (PaliGemma's heads are 256 wide) takes key tiles of 32 (the
// same template, BKT = 32): with 64 keys the four staged tiles alone are
// 266 KB in float32, past the 227 KB a block can have, and a thread's
// dK or dV tile would be 4 keys × 32 columns, 128 floats beside the dQ
// share's 64.  With 32 keys the tiles take 216 KB in float32 (122 KB in
// bf16), a thread holds 4 keys × 16 columns of dK or dV and 4 rows × 16
// columns of the dQ share, and one block of 256 threads runs an SM.  The
// dQ shares double with the key tiles: 906 MB of float32 at PaliGemma's
// training shape (B 4, 8 query heads over 1, S 1280, prefix 256), written
// and read once.

namespace {

namespace bwd {

constexpr int THREADS = 256;        // two groups of 128 threads
constexpr int BQ = 64, BK = 64;     // query rows, keys of a tile pair
constexpr int BK_WIDE = 32;         // keys of a tile pair at D > 128
constexpr int MAX_KEY_TILES = 65535;  // grid y

// The FFMA route's key tile at head dim D.
__host__ __device__ constexpr int key_tile(int D) {
  return D > 128 ? BK_WIDE : BK;
}

// Shared bytes of a tile kernel with key tiles of bkt: the k, v, q and dO
// tiles, P and dS (bkt + 8 floats a row), and the query tile's lse and Δ.
__host__ __device__ inline int tile_bytes(int D, int esize, int bkt) {
  return (2 * bkt + 2 * BQ) * row_pitch(D, esize) + 2 * BQ * (bkt + 8) * 4 +
         2 * BQ * 4;
}

// The query tiles [first, last) that key tile kt's keys (bk of them) are
// open to: from the tile of the key tile's first key (causal), or from 0
// (no mask, or a key tile that starts below the prefix P), up to the tile
// of the last query whose window still holds the tile's last key.  Never
// empty: tile kt sees its own diagonal.
__host__ __device__ inline void q_tiles(int kt, int nqt, int causal,
                                        int window, int& first, int& last,
                                        int prefix = 0, int bk = BK) {
  const int k0 = kt * bk;
  first = causal && k0 >= prefix ? k0 / BQ : 0;
  last = nqt;
  if (window > 0) {
    const long long qmax = (long long)k0 + bk - 1 + window - 1;
    if (qmax / BQ + 1 < nqt) last = static_cast<int>(qmax / BQ + 1);
  }
}

// Open (key tile, query tile) pairs of one head: the dQ shares per head.
// A mask takes Sq == Skv; without one every key tile sees every query
// tile.
__host__ __device__ inline long long pair_count(int Sq, int Skv, int causal,
                                                int window, int prefix,
                                                int bk) {
  const int nkt = (Skv + bk - 1) / bk, nqt = (Sq + BQ - 1) / BQ;
  long long n = 0;
  for (int kt = 0; kt < nkt; ++kt) {
    int first, last;
    q_tiles(kt, nqt, causal, window, first, last, prefix, bk);
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
                          float* __restrict__ delta, int H, int Sq, int D,
                          Strides so, Strides sdo, int64_t rows) {
  const int64_t r = (int64_t)blockIdx.x * 16 + threadIdx.x / 16;
  const int lane = threadIdx.x & 15;
  float acc = 0.f;
  if (r < rows) {
    const int bh = static_cast<int>(r / Sq), s = static_cast<int>(r % Sq);
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

// Block (b·Hkv + kv head, key tile kt of BKT keys).  part: the dQ shares,
// (pairs, B·H, BQ, D4) float32 with D4 = D rounded up to 4, pairs ordered
// by key tile, then query tile (`q_tiles`).  VEC: D and every stride of q,
// k, v, dO, dK, dV whole 16-byte chunks of elements, every base 16-byte
// aligned.
template <typename T, int DMAX, int BKT, bool VEC>
__global__ void __launch_bounds__(THREADS, DMAX <= 64 ? 2 : 1)
flash_attention_bwd_tile(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dO,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv,
                         float* __restrict__ part, int H, int Hkv, int Sq,
                         int Skv, int D, Strides sq, Strides sk, Strides sv,
                         Strides sdo, Strides sdk, Strides sdv, int causal,
                         int window, int prefix, float scale) {
  constexpr int PP = BKT + 8;      // pitch (floats) of the P and dS tiles
  constexpr int TK = BKT / 8;      // a thread's keys of S and dP
  constexpr int PC = BKT / 4;      // P and dS: 4-key column groups,
  constexpr int PR = THREADS / PC;  // row groups of a pass,
  constexpr int NP = BQ / PR;      // passes
  constexpr int CA = 4 * 128 / BKT;  // dK/dV: 4-column groups of a thread
  constexpr int NC = DMAX / (4 * CA);  // 4-column chunks of its dK/dV row
  constexpr int NQ = DMAX / 64;    // 4-column chunks of a thread's dQ row
  extern __shared__ __align__(16) uint8_t smem[];
  const int pitch = row_pitch(D, sizeof(T));
  uint8_t* Ks = smem;
  uint8_t* Vs = Ks + BKT * pitch;
  uint8_t* Qs = Vs + BKT * pitch;
  uint8_t* dOs = Qs + BQ * pitch;
  float* Ps = reinterpret_cast<float*>(dOs + BQ * pitch);   // S, then P
  float* dSs = Ps + BQ * PP;                                 // dP, then dS
  float* Ls = dSs + BQ * PP;
  float* Ds = Ls + BQ;

  const int group = H / Hkv;
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int kt = blockIdx.y, k0 = kt * BKT;
  const int nqt = (Sq + BQ - 1) / BQ;
  int first, last;
  q_tiles(kt, nqt, causal, window, first, last, prefix, BKT);
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
      q_tiles(j, nqt, causal, window, f, l, prefix, BKT);
      pair0 += l - f;
    }
    part_kt = part + (pair0 - first) * BH * BQ * D4;
  }
  const int tid = threadIdx.x, grp = tid >> 7, t = tid & 127;
  // S, dP: rows rg + 16i, keys kg + 8j.  dK, dV: keys 4ka + u, columns
  // 4ca + 4·CA·m.  P and dS: rows pr + PR·i, keys 4pc + u.  dS·K: rows
  // rq + 16i, columns 4cq + 64m.  (Key tiles of 64: ka = t >> 3,
  // ca = t & 7, pr = rq, pc = cq.)
  const int rg = t >> 3, kg = t & 7;
  const int ka = t / CA, ca = t % CA;
  const int pr = tid / PC, pc = tid % PC;
  const int rq = tid >> 4, cq = tid & 15;

  // iteration it: query head hk·group + it / per_head, query tile
  // first + it % per_head
  const auto head_of = [&](int it) { return hk * group + it / per_head; };
  const auto q0_of = [&](int it) { return (first + it % per_head) * BQ; };
  const auto qh_of = [&](int h) { return q + b * sq.b + h * sq.h; };
  const auto gh_of = [&](int h) { return dO + b * sdo.b + h * sdo.h; };

  stage<T, DMAX, VEC, THREADS>(Ks, pitch, k + b * sk.b + hk * sk.h, sk.s,
                               k0, BKT, Skv, D);
  stage<T, DMAX, VEC, THREADS>(Vs, pitch, v + b * sv.b + hk * sv.h, sv.s,
                               k0, BKT, Skv, D);
  {
    const int h = head_of(0), q0 = q0_of(0);
    stage<T, DMAX, VEC, THREADS>(Qs, pitch, qh_of(h), sq.s, q0, BQ, Sq, D);
    stage<T, DMAX, VEC, THREADS>(dOs, pitch, gh_of(h), sdo.s, q0, BQ, Sq, D);
    if (tid < BQ) {
      const int64_t row = (int64_t)(b * H + h) * Sq + q0 + tid;
      Ls[tid] = q0 + tid < Sq ? lse[row] : 0.f;
      Ds[tid] = q0 + tid < Sq ? delta[row] : 0.f;
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
    if (it + 1 < n_it && tid < BQ && q0_of(it + 1) + tid < Sq) {
      const int64_t row =
          (int64_t)(b * H + head_of(it + 1)) * Sq + q0_of(it + 1) + tid;
      l_next = lse[row];
      d_next = delta[row];
    }
    hopper::cp_async_wait<0>();
    __syncthreads();                       // (1) this query tile is staged

    // S = Q·Kᵀ (group 0) or dP = dO·Vᵀ (group 1), 4 head-dim values at a
    // time: 4 + TK shared loads per 16·TK FFMA.
    {
      const uint8_t* As = grp ? dOs : Qs;
      const uint8_t* Bs = grp ? Vs : Ks;
      float s[4][TK];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < TK; ++j) s[i][j] = 0.f;
      for (int d0 = 0; d0 < D4; d0 += 4) {
        float4 af[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          af[i] = lds4<T>(As + (rg + 16 * i) * pitch, d0);
#pragma unroll
        for (int j = 0; j < TK; ++j) {
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
        for (int j = 0; j < TK; ++j)
          out[(rg + 16 * i) * PP + kg + 8 * j] = s[i][j];
    }
    __syncthreads();                       // (2) S and dP are in shared

    // P = exp(S·scale − lse), dS = P ∘ (dP − Δ); masked entries are 0.
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int r = pr + PR * i, qpos = q0_of(it) + r;
      const int lastk = max(qpos, prefix - 1);  // the causal mask's last key
      const float L = Ls[r], dl = Ds[r];
      float* prow = Ps + r * PP + 4 * pc;
      float* drow = dSs + r * PP + 4 * pc;
      const float4 sv4 = *reinterpret_cast<const float4*>(prow);
      const float4 dp4 = *reinterpret_cast<const float4*>(drow);
      float p[4], ds[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int kpos = k0 + 4 * pc + u;
        const bool open = qpos < Sq && kpos < Skv &&
                          (!causal || kpos <= lastk) &&
                          (window <= 0 || qpos - kpos < window);
        p[u] = open ? expf(lane4(sv4, u) * scale - L) : 0.f;
        ds[u] = p[u] * (lane4(dp4, u) - dl);
      }
      *reinterpret_cast<float4*>(prow) = make_float4(p[0], p[1], p[2], p[3]);
      *reinterpret_cast<float4*>(drow) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
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
          const int col = 4 * ca + 4 * CA * m;
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
                                   BQ, Sq, D);
      stage<T, DMAX, VEC, THREADS>(dOs, pitch, gh_of(h_next), sdo.s,
                                   q0_next, BQ, Sq, D);
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
    for (int j0 = 0; j0 < BKT; j0 += 4) {
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
      if (q0 + r >= Sq) continue;
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
    if (key >= Skv) continue;
    T* row = oh + (int64_t)key * ss;
#pragma unroll
    for (int m = 0; m < NC; ++m) {
      const int col = 4 * ca + 4 * CA * m;
      if (col >= D) continue;
      const float r[4] = {acc[u][m].x * sc, acc[u][m].y * sc,
                          acc[u][m].z * sc, acc[u][m].w * sc};
      store4<T, VEC>(row + col, r, D - col);
    }
  }
}

// dQ = scale · Σ_kt part[kt], over the key tiles (of bk keys) that wrote
// the row's query tile, added in key-tile order; one thread per 4 columns
// of a row, written in T.  VEC: dq's strides a multiple of 4, base 16-byte
// aligned, D % 4 == 0.
template <typename T, bool VEC>
__global__ void __launch_bounds__(256)
flash_attention_bwd_dq_sum(const float* __restrict__ part, T* __restrict__ dq,
                           int H, int Sq, int Skv, int D, int causal,
                           int window, int prefix, int bk, Strides sdq,
                           float scale, int64_t rows) {
  const int D4 = (D + 3) & ~3, c4 = D4 / 4;
  const int64_t i = (int64_t)blockIdx.x * 256 + threadIdx.x;
  if (i >= rows * c4) return;
  const int64_t row = i / c4;
  const int col = static_cast<int>(i % c4) * 4;
  const int bh = static_cast<int>(row / Sq);
  const int qpos = static_cast<int>(row % Sq);
  const int qt = qpos / BQ, nkt = (Skv + bk - 1) / bk;
  const int nqt = (Sq + BQ - 1) / BQ;
  const int64_t BH = rows / Sq;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  int64_t pair0 = 0;
  for (int kt = 0; kt < nkt; ++kt) {
    int first, last;
    q_tiles(kt, nqt, causal, window, first, last, prefix, bk);
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

int64_t partial_floats(int B, int H, int Sq, int Skv, int D, int causal,
                       int window, int prefix) {
  return pair_count(Sq, Skv, causal, window, prefix, key_tile(D)) * B * H *
         BQ * ((D + 3) & ~3);
}

// One call's operands and gradients (q, k, v, o, dO; dq, dk, dv), their
// element strides and its shape.
struct Call {
  const void *q, *k, *v, *o, *dO;
  void *dq, *dk, *dv;
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  int B, H, Hkv, Sq, Skv, D, causal, window, prefix;
};

// Every row of a (B, heads, S, ·) view whole chunks of e elements (the
// stride of an axis of length 1 is never used).
inline bool rows_ok(const Call& c, const Strides& st, int heads, int e) {
  return (c.B == 1 || st.b % e == 0) && (heads == 1 || st.h % e == 0) &&
         st.s % e == 0;
}
inline bool aligned(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// 16-byte staging of q, k, v, dO and 16-byte rows of dk, dv: the tile
// kernel's VEC.
inline bool vec_tile(const Call& c, int esize) {
  const int ev = 16 / esize;
  return c.D % ev == 0 && rows_ok(c, c.sq, c.H, ev) &&
         rows_ok(c, c.sk, c.Hkv, ev) && rows_ok(c, c.sv, c.Hkv, ev) &&
         rows_ok(c, c.sdo, c.H, ev) && rows_ok(c, c.sdk, c.Hkv, ev) &&
         rows_ok(c, c.sdv, c.Hkv, ev) && aligned(c.q) && aligned(c.k) &&
         aligned(c.v) && aligned(c.dO) && aligned(c.dk) && aligned(c.dv);
}

// The tensor-core route's rule: bf16, D a multiple of 16 up to 128,
// 16-byte staging of q, k, v, dO and 16-byte rows of dq, dk, dv, and no
// prefix.
inline bool tc_route(const Call& c, int bf16) {
  return bf16 && c.D % 16 == 0 && c.D <= 128 && c.prefix == 0 &&
         vec_tile(c, 2) && rows_ok(c, c.sdq, c.H, 8) && aligned(c.dq);
}

// Δ into `delta` (B·H·Sq floats).
template <typename T>
int launch_delta(const Call& c, float* delta, cudaStream_t stream) {
  const int64_t rows = (int64_t)c.B * c.H * c.Sq;
  const unsigned blocks = static_cast<unsigned>((rows + 15) / 16);
  const T* o = static_cast<const T*>(c.o);
  const T* dO = static_cast<const T*>(c.dO);
  if (c.D % 4 == 0 && rows_ok(c, c.so, c.H, 4) && rows_ok(c, c.sdo, c.H, 4) &&
      aligned(c.o) && aligned(c.dO))
    flash_attention_bwd_delta<T, true><<<blocks, 256, 0, stream>>>(
        o, dO, delta, c.H, c.Sq, c.D, c.so, c.sdo, rows);
  else
    flash_attention_bwd_delta<T, false><<<blocks, 256, 0, stream>>>(
        o, dO, delta, c.H, c.Sq, c.D, c.so, c.sdo, rows);
  return static_cast<int>(cudaGetLastError());
}

// The tile kernel's instance at (T, DMAX): its key tile is key_tile(DMAX).
template <typename T, int DMAX, bool VEC>
inline auto tile_kernel() {
  return &flash_attention_bwd_tile<T, DMAX, key_tile(DMAX), VEC>;
}

// The FFMA route: Δ, the tile kernel, the dQ sums.
template <typename T, int DMAX>
int launch(const Call& c, const float* lse, float* scratch, float scale,
           cudaStream_t stream) {
  const int B = c.B, H = c.H, Hkv = c.Hkv, Sq = c.Sq, Skv = c.Skv, D = c.D;
  constexpr int BKT = key_tile(DMAX);
  const int nkt = (Skv + BKT - 1) / BKT;
  const int64_t rows = (int64_t)B * H * Sq;
  float* part = scratch;
  float* delta = scratch + partial_floats(B, H, Sq, Skv, D, c.causal,
                                          c.window, c.prefix);
  int rc = launch_delta<T>(c, delta, stream);
  if (rc != 0) return rc;
  auto kern = vec_tile(c, sizeof(T)) ? tile_kernel<T, DMAX, true>()
                                     : tile_kernel<T, DMAX, false>();
  const int smem = tile_bytes(D, sizeof(T), BKT);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto in = [](const void* p) { return static_cast<const T*>(p); };
  const auto out = [](void* p) { return static_cast<T*>(p); };
  kern<<<dim3(B * Hkv, nkt), THREADS, smem, stream>>>(
      in(c.q), in(c.k), in(c.v), in(c.dO), lse, delta, out(c.dk), out(c.dv),
      part, H, Hkv, Sq, Skv, D, c.sq, c.sk, c.sv, c.sdo, c.sdk, c.sdv,
      c.causal, c.window, c.prefix, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  const int64_t n4 = rows * (((D + 3) & ~3) / 4);
  const unsigned blocks = static_cast<unsigned>((n4 + 255) / 256);
  if (D % 4 == 0 && rows_ok(c, c.sdq, H, 4) && aligned(c.dq))
    flash_attention_bwd_dq_sum<T, true><<<blocks, 256, 0, stream>>>(
        part, out(c.dq), H, Sq, Skv, D, c.causal, c.window, c.prefix, BKT,
        c.sdq, scale, rows);
  else
    flash_attention_bwd_dq_sum<T, false><<<blocks, 256, 0, stream>>>(
        part, out(c.dq), H, Sq, Skv, D, c.causal, c.window, c.prefix, BKT,
        c.sdq, scale, rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_width(const Call& c, const float* lse, float* scratch, float scale,
             cudaStream_t cs) {
  if (c.D <= 64) return launch<T, 64>(c, lse, scratch, scale, cs);
  if (c.D <= 128) return launch<T, 128>(c, lse, scratch, scale, cs);
  return launch<T, 256>(c, lse, scratch, scale, cs);
}

// Registers a thread, local (spill) bytes and dynamic shared bytes of the
// tile kernel at head dim D, its 16-byte-staging instance.
template <typename T, int DMAX>
int tile_attrs(int D, int* out) {
  cudaFuncAttributes a;
  const cudaError_t e =
      cudaFuncGetAttributes(&a, tile_kernel<T, DMAX, true>());
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = tile_bytes(D, sizeof(T), key_tile(DMAX));
  return static_cast<int>(e);
}

template <typename T>
int tile_attrs_by_width(int D, int* out) {
  if (D <= 64) return tile_attrs<T, 64>(D, out);
  if (D <= 128) return tile_attrs<T, 128>(D, out);
  return tile_attrs<T, 256>(D, out);
}

// ---- bf16 backward on the tensor cores -----------------------------------
//
// For bf16 operands the reference widens to float32 and contracts; a
// bf16 × bf16 product is exact in float32, so q·kᵀ and dO·vᵀ on
// `wgmma … .f32.bf16.bf16` are the reference's logits and dP but for the
// order of the sums.  The other three products take P or dS, which the
// reference keeps in float32: one bf16 term of them keeps 8 bits (most of
// a bf16 ulp of the gradient), so each is split in two bf16 terms,
// hi = bf16(x) and lo = bf16(x − hi), both through the tensor cores into
// one float32 accumulator: 16 bits, an error near 2⁻¹⁷ of the accumulator
// (the forward's p·v, flash_attention.cu).
//
// What bounds it on this card: bf16 tensor operations (989 TFLOP/s)
// against the bytes of q, k, v, o, dO, lse and the gradients (3.35
// TB/s).  Five products over the open pairs (the bound's count): at
// internlm2's causal training shape (B 4, 16 query heads over 8 kv heads
// of D 128, S 1024) 43.0 GFLOP, 0.0435 ms; at zamba2's (32 heads of D 80)
// 53.7 GFLOP on 182 MB, 0.0543 ms.
//
// Three kernels, no atomics and no scratch but Δ, every sum in a fixed
// order (bitwise repeatable):
//   1. Δ, as the FFMA route's (`flash_attention_bwd_delta`);
//   2. `flash_attention_bwd_dkdv_wgmma`: one block of one warpgroup per
//      (b·kv head, key tile of 64) walks the query tiles of 64 that the
//      mask leaves open (`q_tiles`), for each query head of its group in
//      order, with the keys as wgmma's M: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ
//      (`m64n64k16`, both operands from shared memory), Pᵀ = exp(Sᵀ·scale −
//      lse) and dSᵀ = Pᵀ ∘ (dPᵀ − Δ) on the accumulator fragment (lse and Δ
//      belong to its columns: staged with the query tile), then
//      dV += Pᵀ·dO and dK += dSᵀ·Q (`m64nDk16`, Pᵀ and dSᵀ from registers
//      in two terms, dO and Q read MN-major).  dK and dV stay in registers
//      over the walk (summed over the group on chip) and are scaled and
//      rounded once.  Causal key tiles run low first: they see the most
//      query tiles;
//   3. `flash_attention_bwd_dq_wgmma`: the forward's skeleton without the
//      online softmax: one block of two warpgroups per (b·h, query tile of
//      128) walks the kv tiles its rows can see, S = Q·Kᵀ and dP = dO·Vᵀ,
//      P and dS from the rows' lse and Δ, then dQ += dS·K with dS from
//      registers in two terms and K read MN-major; dS·K of tile t − 1 is on
//      the tensor cores while tile t's dS is formed.  Causal query tiles
//      run heaviest (last) first.
// So seven products a head where the FFMA route forms five (q·kᵀ and
// dO·vᵀ twice), ten bf16 products counting the split terms; in return no
// dQ shares (the FFMA route writes and reads 285 MB of them at
// internlm2's shape) and no atomics.
//
// Layout: each staged tile serves both as a K-major operand (D
// contracted) and as an MN-major one (its rows contracted): `Lay` below.
// Every copy is a 16-byte cp.async; rows past Sq or Skv are zero-filled,
// and only tiles that the diagonal, the window's edge or a length cuts run
// the mask test; a masked pair gives P = 0 and dS = 0 exactly.  No wgmma
// sits under a thread-dependent branch, and each issue is fenced for its
// registers (the forward's rules: else ptxas serialises every wgmma,
// C7520).
// Registers: the dK/dV kernel holds dK and dV (D/2 each) and Sᵀ and dPᵀ
// (32 each), which become the two terms of Pᵀ and dSᵀ in place (255 a
// thread at D 128, no spills: two 128-thread blocks an SM); the dQ kernel
// dQ (D/2), S and dP, and dS's terms.  Shared memory: at D 128 (the
// 128-byte swizzle) 98 KB and 193 KB; at D 80 (the 32-byte swizzle, 16
// columns a block, one copy of each tile) 62 KB and 121 KB.
//
// Tried and not kept (same times, NVIDIA H100 80GB HBM3, 700 W): S and
// dP in two commit groups with P formed while dP is on the tensor cores,
// dV issued before dS is split, and exp2f with log2 e folded into the
// scale.

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int BKEY = 64;          // dK/dV kernel: keys a block
constexpr int BQT = 64;           // dK/dV kernel: queries a walked tile
constexpr int KV_THREADS = 128;   // one warpgroup
constexpr int KV_NST = 2;         // query tiles in its ring
constexpr int BQ = 128;           // dQ kernel: query rows a block
constexpr int BKV = 64;           // dQ kernel: keys a kv tile
constexpr int Q_THREADS = 256;    // two warpgroups, 64 rows each
constexpr int Q_NST = 4;          // kv tiles in its ring

// A staged tile of rows of D bf16: its columns in blocks of W bytes, each
// block rows × W bytes under the W-byte swizzle, W the largest of 128, 64
// and 32 that divides a row (128 at D 64 and 128, 32 at D 80).  That is at
// once the canonical K-major layout of the W-byte swizzle (8-row atoms W
// bytes wide; a k-step's 32 bytes lie in one block) and its canonical
// MN-major one (W bytes of the rows' axis by 8 rows, blocks rows·W bytes
// apart), so each tile is staged once and read through two descriptors.
template <int D> struct Lay {
  static_assert(D % 16 == 0 && D <= 128, "D a multiple of 16 up to 128");
  static constexpr int W = (2 * D) % 128 == 0 ? 128
                           : (2 * D) % 64 == 0 ? 64 : 32;
  static constexpr int MODE = W == 128 ? 1 : W == 64 ? 2 : 3;
  static constexpr int TILE = 64 * 2 * D;     // bytes of 64 rows
  static_assert(TILE % 1024 == 0, "1024-byte aligned tiles");
};

// Rows [row0, row0 + n) of one head into a tile at `dst`; rows past S
// (the head's length) are zero-filled.  NT: the block's threads.
template <int D, int NT>
__device__ __forceinline__ void stage_tile(uint32_t dst,
                                           const bf16* __restrict__ src,
                                           int64_t ss, int row0, int n,
                                           int S) {
  constexpr int CPR = D / 8, W = Lay<D>::W, WC = W / 16;
  for (int i = threadIdx.x; i < n * CPR; i += NT) {
    const int r = i / CPR, ch = i % CPR;
    const int pos = row0 + r;
    const bool in = pos < S;
    hopper::cp_async16(
        dst + (ch / WC) * (n * W) + hopper::swizzle(r * W + ch % WC * 16, W),
        in ? src + (int64_t)pos * ss + ch * 8 : src, in ? 16 : 0);
  }
}

// K-major descriptor: rows [row0, row0 + 64) of an n-row tile, k-step ks
// (columns 16ks .. 16ks + 15).
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int n, int row0,
                                           int ks) {
  constexpr int W = Lay<D>::W;
  return hopper::smem_desc(
      tile + (32 * ks / W) * (n * W) + row0 * W + (32 * ks) % W, 16, 8 * W,
      Lay<D>::MODE);
}

// MN-major descriptor: rows 16kk .. 16kk + 15 of an n-row tile as the
// contracted axis, all D columns.
template <int D>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int n, int kk) {
  constexpr int W = Lay<D>::W;
  return hopper::smem_desc(tile + kk * 16 * W, n * W, 8 * W, Lay<D>::MODE);
}

__device__ __forceinline__ bool open_pair(int qpos, int kpos, int Sq,
                                          int Skv, int causal, int window) {
  return qpos < Sq && kpos < Skv && (!causal || kpos <= qpos) &&
         (window <= 0 || qpos - kpos < window);
}

// A 64 × 64 accumulator fragment in two bf16 terms, as the A fragments
// of four k-steps: k-step kk, register r holds accumulator registers
// 8kk + 2r and 8kk + 2r + 1.
__device__ __forceinline__ void split_frag(const float (&x)[32],
                                           uint32_t (&hi)[4][4],
                                           uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i)
    split_pair(x[2 * i], x[2 * i + 1], hi[i / 4][i % 4], lo[i / 4][i % 4]);
}
__device__ __forceinline__ void fence_frag(uint32_t (&f)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) hopper::reg_fence(f[kk]);
}

// Block (b·Hkv + kv head, key tile); see the design above.  Accumulator
// register 4j + e of Sᵀ, dPᵀ: key kr + 8·(e / 2), query 8j + qc + e % 2;
// of dK, dV: key kr + 8·(e / 2), column 8j + qc + e % 2.
template <int D>
__global__ void __launch_bounds__(KV_THREADS, 2)
flash_attention_bwd_dkdv_wgmma(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dO,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Hkv, int Sq,
    int Skv, Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk,
    Strides sdv, int causal, int window, float scale) {
  constexpr int TILE = Lay<D>::TILE, ND = D / 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = hopper::smem_u32(smem_raw);
  const uint32_t s0 = (base + 1023) & ~1023u;
  // K, V, then KV_NST stages of (Q, dO), then each stage's lse and Δ
  const uint32_t sK = s0, sV = s0 + TILE, sQ0 = s0 + 2 * TILE;
  float* lds = reinterpret_cast<float*>(smem_raw + (s0 - base) +
                                        (2 + 2 * KV_NST) * TILE);

  const int group = H / Hkv;
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int k0 = blockIdx.y * BKEY;
  int first, last;
  q_tiles(blockIdx.y, (Sq + BQT - 1) / BQT, causal, window, first, last);
  const int per_head = last - first, n_it = group * per_head;
  const int tid = threadIdx.x, lane = tid & 31;
  const int kr = k0 + 16 * (tid >> 5) + (lane >> 2);
  const int qc = 2 * (lane & 3);

  // iteration it: query head hk·group + it / per_head, query tile
  // first + it % per_head
  const auto head_of = [&](int it) { return hk * group + it / per_head; };
  const auto q0_of = [&](int it) { return (first + it % per_head) * BQT; };
  const auto stage_q = [&](int it) {
    const int h = head_of(it), q0 = q0_of(it);
    const uint32_t st = sQ0 + (it % KV_NST) * 2 * TILE;
    stage_tile<D, KV_THREADS>(st, q + b * sq.b + h * sq.h, sq.s, q0, BQT,
                              Sq);
    stage_tile<D, KV_THREADS>(st + TILE, dO + b * sdo.b + h * sdo.h, sdo.s,
                              q0, BQT, Sq);
  };
  // the query tile's lse and Δ for thread tid < BQT (0 past Sq)
  const auto load_ld = [&](int it, float& l, float& d) {
    l = d = 0.f;
    const int qpos = q0_of(it) + tid;
    if (tid < BQT && qpos < Sq) {
      const int64_t row = (int64_t)(b * H + head_of(it)) * Sq + qpos;
      l = lse[row];
      d = delta[row];
    }
  };
  const auto store_ld = [&](int it, float l, float d) {
    float* st = lds + 2 * BQT * (it % KV_NST);
    if (tid < BQT) {
      st[tid] = l;
      st[BQT + tid] = d;
    }
  };

  stage_tile<D, KV_THREADS>(sK, k + b * sk.b + hk * sk.h, sk.s, k0, BKEY,
                            Skv);
  stage_tile<D, KV_THREADS>(sV, v + b * sv.b + hk * sv.h, sv.s, k0, BKEY,
                            Skv);
  stage_q(0);
  hopper::cp_async_commit();
  {
    float l, d;
    load_ld(0, l, d);
    store_ld(0, l, d);
  }

  float dva[ND], dka[ND], sacc[32], pacc[32];
  uint32_t ph[4][4], pl[4][4], dh[4][4], dl[4][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) dva[i] = dka[i] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int q0 = q0_of(it);
    const uint32_t sQ = sQ0 + (it % KV_NST) * 2 * TILE, sdO = sQ + TILE;
    const float* lq = lds + 2 * BQT * (it % KV_NST);
    float l_next = 0.f, d_next = 0.f;
    if (it + 1 < n_it) load_ld(it + 1, l_next, d_next);
    hopper::cp_async_wait<0>();       // this query tile has landed
    hopper::fence_proxy_async();
    __syncthreads();                  // and the last one's stage is free
    if (it + 1 < n_it) {
      stage_q(it + 1);
      store_ld(it + 1, l_next, d_next);
    }
    hopper::cp_async_commit();

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ.  The accumulators are zeroed first so
    // that the last tile's values are dead once split.
#pragma unroll
    for (int i = 0; i < 32; ++i) sacc[i] = pacc[i] = 0.f;
    hopper::reg_fence(sacc);
    hopper::reg_fence(pacc);
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      hopper::wgmma_bf16_n64(sacc, desc_k<D>(sK, BKEY, 0, ks),
                             desc_k<D>(sQ, BQT, 0, ks), ks > 0);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      hopper::wgmma_bf16_n64(pacc, desc_k<D>(sV, BKEY, 0, ks),
                             desc_k<D>(sdO, BQT, 0, ks), ks > 0);
    hopper::wgmma_commit();
    hopper::reg_fence(sacc);
    hopper::reg_fence(pacc);
    hopper::wgmma_wait<0>();
    hopper::reg_fence(sacc);
    hopper::reg_fence(pacc);

    // Pᵀ and dSᵀ in place, each column's lse and Δ from shared memory
    const bool edge = q0 + BQT > Sq || k0 + BKEY > Skv ||
                      (causal && k0 + BKEY - 1 > q0) ||
                      (window > 0 && q0 + BQT - 1 - k0 >= window);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 L = *reinterpret_cast<const float2*>(lq + 8 * j + qc);
      const float2 Dl =
          *reinterpret_cast<const float2*>(lq + BQT + 8 * j + qc);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        float p = expf(sacc[i] * scale - (e & 1 ? L.y : L.x));
        if (edge && !open_pair(q0 + 8 * j + qc + (e & 1), kr + 8 * (e >> 1),
                               Sq, Skv, causal, window))
          p = 0.f;
        sacc[i] = p;
        pacc[i] = p * (pacc[i] - (e & 1 ? Dl.y : Dl.x));
      }
    }
    split_frag(sacc, ph, pl);
    split_frag(pacc, dh, dl);

    // dV += Pᵀ·dO and dK += dSᵀ·Q: a k-step of 16 queries, hi then lo
    hopper::reg_fence(dva);
    hopper::reg_fence(dka);
    fence_frag(ph);
    fence_frag(pl);
    fence_frag(dh);
    fence_frag(dl);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = desc_mn<D>(sdO, BQT, kk);
      const uint64_t qb = desc_mn<D>(sQ, BQT, kk);
      hopper::WgmmaRsBf16MnB<D>::run(dva, ph[kk], db);
      hopper::WgmmaRsBf16MnB<D>::run(dva, pl[kk], db);
      hopper::WgmmaRsBf16MnB<D>::run(dka, dh[kk], qb);
      hopper::WgmmaRsBf16MnB<D>::run(dka, dl[kk], qb);
    }
    hopper::wgmma_commit();
    hopper::reg_fence(dva);
    hopper::reg_fence(dka);
    hopper::wgmma_wait<0>();
    hopper::reg_fence(dva);
    hopper::reg_fence(dka);
    fence_frag(ph);
    fence_frag(pl);
    fence_frag(dh);
    fence_frag(dl);
  }

  // dK = scale · dSᵀ·Q and dV, rounded once
  bf16* dkh = dk + b * sdk.b + hk * sdk.h;
  bf16* dvh = dv + b * sdv.b + hk * sdv.h;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int key = kr + 8 * hf;
    if (key >= Skv) continue;
    bf16* rk = dkh + (int64_t)key * sdk.s + qc;
    bf16* rv = dvh + (int64_t)key * sdv.s + qc;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int i = 4 * j + 2 * hf;
      *reinterpret_cast<__nv_bfloat162*>(rk + 8 * j) =
          __floats2bfloat162_rn(dka[i] * scale, dka[i + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(rv + 8 * j) =
          __floats2bfloat162_rn(dva[i], dva[i + 1]);
    }
  }
}

// Block (b·h, query tile); see the design above.  Accumulator register
// 4j + e of S, dP: row r0 + 8·(e / 2), key k0 + 8j + kc + e % 2; of dQ:
// row r0 + 8·(e / 2), column 8j + kc + e % 2.  EQ: the launch has
// Sq == Skv (every self-attention), and the kernel keeps one length, so
// its code is that of a kernel of one length; a second length held over
// the walk cost this kernel 6 registers and 2–3 % of its time at the LM
// shapes (NVIDIA H100 80GB HBM3, 700 W).
template <int D, bool EQ>
__global__ void __launch_bounds__(Q_THREADS, 1)
flash_attention_bwd_dq_wgmma(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dO,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int H, int group, int Sq, int Skv_arg,
    Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdq, int causal,
    int window, float scale) {
  const int Skv = EQ ? Sq : Skv_arg;
  constexpr int TILE = Lay<D>::TILE, NO = D / 2;
  constexpr int STAGE = 2 * TILE;     // a kv tile's K and V
  extern __shared__ uint8_t smem_raw[];
  const uint32_t s0 = (hopper::smem_u32(smem_raw) + 1023) & ~1023u;
  // Q and dO (128 rows each), then Q_NST stages of (K, V)
  const uint32_t sQ = s0, sdO = s0 + 2 * TILE, sKV = s0 + 4 * TILE;

  const int bh = blockIdx.x, b = bh / H, h = bh % H, hk = h / group;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int qw = q0 + 64 * wg;                      // the warpgroup's rows
  const int r0 = qw + 16 * ((tid >> 5) & 3) + (lane >> 2);
  const int kc = 2 * (lane & 3);

  const bf16* kh = k + b * sk.b + hk * sk.h;
  const bf16* vh = v + b * sv.b + hk * sv.h;

  // kv positions [lo, hi) the block sees, lo on a tile; both warpgroups
  // run every tile (a wgmma under a thread-dependent branch serialises
  // them all), the first one's rows all masked in the last causal tile
  const int lo = (window > 0 ? max(0, q0 - (window - 1)) : 0) / BKV * BKV;
  const int hi = causal ? min(Skv, q0 + BQ) : Skv;
  const int n = (hi - lo + BKV - 1) / BKV;

  const auto stage_kv = [&](int t) {
    const uint32_t st = sKV + (t % Q_NST) * STAGE;
    stage_tile<D, Q_THREADS>(st, kh, sk.s, lo + t * BKV, BKV, Skv);
    stage_tile<D, Q_THREADS>(st + TILE, vh, sv.s, lo + t * BKV, BKV, Skv);
  };
  stage_tile<D, Q_THREADS>(sQ, q + b * sq.b + h * sq.h, sq.s, q0, BQ, Sq);
  stage_tile<D, Q_THREADS>(sdO, dO + b * sdo.b + h * sdo.h, sdo.s, q0, BQ,
                           Sq);
  stage_kv(0);
  hopper::cp_async_commit();
  if (n > 1) stage_kv(1);
  hopper::cp_async_commit();

  // the thread's two rows' lse and Δ (0 past Sq)
  float L[2], Dl[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = r0 + 8 * hf;
    L[hf] = r < Sq ? lse[(int64_t)bh * Sq + r] : 0.f;
    Dl[hf] = r < Sq ? delta[(int64_t)bh * Sq + r] : 0.f;
  }

  float sacc[32], pacc[32], dqa[NO];
  uint32_t dh[4][4], dl[4][4];
#pragma unroll
  for (int i = 0; i < NO; ++i) dqa[i] = 0.f;

  // Waits for tile t, then starts tile t + 2's copies into the stage of
  // tile t − 2, which both warpgroups are done with.
  const auto next_tile = [&](int t) {
    hopper::cp_async_wait<1>();
    hopper::fence_proxy_async();
    __syncthreads();
    if (t + 2 < n) stage_kv(t + 2);
    hopper::cp_async_commit();
  };
  // S = Q·Kᵀ and dP = dO·Vᵀ of tile t
  const auto issue_sdp = [&](int t) {
    const uint32_t kb = sKV + (t % Q_NST) * STAGE, vb = kb + TILE;
#pragma unroll
    for (int i = 0; i < 32; ++i) sacc[i] = pacc[i] = 0.f;
    hopper::reg_fence(sacc);
    hopper::reg_fence(pacc);
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      hopper::wgmma_bf16_n64(sacc, desc_k<D>(sQ, BQ, 64 * wg, ks),
                             desc_k<D>(kb, BKV, 0, ks), ks > 0);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      hopper::wgmma_bf16_n64(pacc, desc_k<D>(sdO, BQ, 64 * wg, ks),
                             desc_k<D>(vb, BKV, 0, ks), ks > 0);
    hopper::wgmma_commit();
    hopper::reg_fence(sacc);
    hopper::reg_fence(pacc);
  };
  // dQ += dS·K of tile t: a k-step of 16 keys, hi then lo
  const auto issue_dq = [&](int t) {
    const uint32_t kb = sKV + (t % Q_NST) * STAGE;
    hopper::reg_fence(dqa);
    fence_frag(dh);
    fence_frag(dl);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = desc_mn<D>(kb, BKV, kk);
      hopper::WgmmaRsBf16MnB<D>::run(dqa, dh[kk], db);
      hopper::WgmmaRsBf16MnB<D>::run(dqa, dl[kk], db);
    }
    hopper::wgmma_commit();
    hopper::reg_fence(dqa);
    fence_frag(dh);
    fence_frag(dl);
  };
  // dS = P ∘ (dP − Δ) of tile t into pacc, P = exp(S·scale − lse)
  const auto form_ds = [&](int t) {
    const int k0 = lo + t * BKV;
    const bool edge = k0 + BKV > Skv || (causal && k0 + BKV - 1 > qw) ||
                      (window > 0 && qw + 63 - k0 >= window);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hf = (i >> 1) & 1;
      float p = expf(sacc[i] * scale - L[hf]);
      if (edge && !open_pair(r0 + 8 * hf, k0 + 8 * (i >> 2) + kc + (i & 1),
                             Sq, Skv, causal, window))
        p = 0.f;
      pacc[i] = p * (pacc[i] - Dl[hf]);
    }
  };

  // Tile 0 alone; then tile t's S and dP issued, tile t − 1's dS·K
  // issued, and tile t's dS formed while dS·K(t − 1) is on the tensor
  // cores; then the last dS·K.
  next_tile(0);
  issue_sdp(0);
  hopper::wgmma_wait<0>();
  hopper::reg_fence(sacc);
  hopper::reg_fence(pacc);
  form_ds(0);
  split_frag(pacc, dh, dl);
  for (int t = 1; t < n; ++t) {
    next_tile(t);
    issue_sdp(t);
    issue_dq(t - 1);
    hopper::wgmma_wait<1>();          // S(t) and dP(t) are done
    hopper::reg_fence(sacc);
    hopper::reg_fence(pacc);
    form_ds(t);
    hopper::wgmma_wait<0>();          // dS(t − 1)·K(t − 1) is done
    hopper::reg_fence(dqa);
    fence_frag(dh);
    fence_frag(dl);
    split_frag(pacc, dh, dl);
  }
  issue_dq(n - 1);
  hopper::wgmma_wait<0>();
  hopper::reg_fence(dqa);

  bf16* dqh = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int qpos = r0 + 8 * hf;
    if (qpos >= Sq) continue;
    bf16* row = dqh + (int64_t)qpos * sdq.s + kc;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int i = 4 * j + 2 * hf;
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) =
          __floats2bfloat162_rn(dqa[i] * scale, dqa[i + 1] * scale);
    }
  }
}

template <int D> constexpr int kv_smem() {
  return (2 + 2 * KV_NST) * Lay<D>::TILE + KV_NST * 2 * BQT * 4 + 1024;
}
template <int D> constexpr int q_smem() {
  return (4 + 2 * Q_NST) * Lay<D>::TILE + 1024;
}

template <int D>
int launch(const Call& c, const float* lse, const float* delta, float scale,
           cudaStream_t stream) {
  auto kv = flash_attention_bwd_dkdv_wgmma<D>;
  auto dq = c.Sq == c.Skv ? flash_attention_bwd_dq_wgmma<D, true>
                          : flash_attention_bwd_dq_wgmma<D, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kv, cudaFuncAttributeMaxDynamicSharedMemorySize, kv_smem<D>());
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             q_smem<D>());
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto in = [](const void* p) { return static_cast<const bf16*>(p); };
  const auto out = [](void* p) { return static_cast<bf16*>(p); };
  kv<<<dim3(c.B * c.Hkv, (c.Skv + BKEY - 1) / BKEY), KV_THREADS,
       kv_smem<D>(), stream>>>(in(c.q), in(c.k), in(c.v), in(c.dO), lse,
                               delta, out(c.dk), out(c.dv), c.H, c.Hkv, c.Sq,
                               c.Skv, c.sq, c.sk, c.sv, c.sdo, c.sdk, c.sdv,
                               c.causal, c.window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  dq<<<dim3(c.B * c.H, (c.Sq + BQ - 1) / BQ), Q_THREADS, q_smem<D>(),
       stream>>>(in(c.q), in(c.k), in(c.v), in(c.dO), lse, delta, out(c.dq),
                 c.H, c.H / c.Hkv, c.Sq, c.Skv, c.sq, c.sk, c.sv, c.sdo,
                 c.sdq, c.causal, c.window, scale);
  return static_cast<int>(cudaGetLastError());
}

// Registers a thread, local (spill) bytes and the launch's dynamic shared
// bytes of the dK/dV (which 0) or dQ kernel at D, the latter for equal
// lengths (which 1) or Sq ≠ Skv (which 2).
template <int D>
int attrs(int which, int* out) {
  cudaFuncAttributes a;
  const cudaError_t e =
      which == 2 ? cudaFuncGetAttributes(&a,
                                         flash_attention_bwd_dq_wgmma<D, false>)
      : which    ? cudaFuncGetAttributes(&a,
                                         flash_attention_bwd_dq_wgmma<D, true>)
                 : cudaFuncGetAttributes(&a, flash_attention_bwd_dkdv_wgmma<D>);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = which ? q_smem<D>() : kv_smem<D>();
  return static_cast<int>(e);
}

#define TC_WIDTHS(X) X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128)

int by_width(const Call& c, const float* lse, const float* delta,
             float scale, cudaStream_t st) {
  switch (c.D) {
#define TC_CASE(W) \
  case W:          \
    return launch<W>(c, lse, delta, scale, st);
    TC_WIDTHS(TC_CASE)
#undef TC_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int attrs_by_width(int D, int which, int* out) {
  switch (D) {
#define TC_CASE(W) \
  case W:          \
    return attrs<W>(which, out);
    TC_WIDTHS(TC_CASE)
#undef TC_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tc

Call make_call(const void* q, const void* k, const void* v, const void* o,
               const void* dO, void* dq, void* dk, void* dv, int B, int H,
               int Hkv, int Sq, int Skv, int D, const long long* strides,
               int causal, int window, int prefix) {
  Strides st[8];
  for (int i = 0; i < 8; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  return Call{q,     k,     v,     o,     dO,    dq,     dk,     dv,
              st[0], st[1], st[2], st[3], st[4], st[5],  st[6],  st[7],
              B,     H,     Hkv,   Sq,    Skv,   D,      causal, window,
              prefix};
}

}  // namespace bwd

}  // namespace

// Float32 scratch the backward of these operands needs (the arguments
// of flash_attention_bwd less lse, scratch, scale and stream): Δ (B·H·Sq)
// on the tensor-core route; on the FFMA route the dQ shares of every open
// (key tile, query tile) pair of every query head, then Δ.
extern "C" long long flash_attention_bwd_scratch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dO, void* dq, void* dk, void* dv, int bf16, int B, int H,
    int Hkv, int Sq, int Skv, int D, const long long* strides, int causal,
    int window, int prefix) {
  const bwd::Call c = bwd::make_call(q, k, v, o, dO, dq, dk, dv, B, H, Hkv,
                                     Sq, Skv, D, strides, causal, window,
                                     prefix);
  const long long delta = (long long)B * H * Sq;
  if (bwd::tc_route(c, bf16)) return delta;
  return bwd::partial_floats(B, H, Sq, Skv, D, causal, window, prefix) +
         delta;
}

// Registers a thread, local (spill) bytes and dynamic shared bytes of the
// FFMA route's tile kernel at head dim D (its 16-byte-staging instance),
// float32 (bf16 = 0) or bf16 (bf16 = 1), into out[0..2].  Returns the CUDA
// error code.
extern "C" int flash_attention_bwd_tile_attrs(int D, int bf16, int* out) {
  if (D <= 0 || D > 256) return static_cast<int>(cudaErrorInvalidValue);
  return bf16 ? bwd::tile_attrs_by_width<__nv_bfloat16>(D, out)
              : bwd::tile_attrs_by_width<float>(D, out);
}

// Registers a thread, local (spill) bytes and dynamic shared bytes of the
// tensor-core route's dK/dV kernel (which 0) or dQ kernel at head dim D,
// its equal-length instance (which 1) or its Sq ≠ Skv one (which 2), into
// out[0..2].  Returns the CUDA error code.
extern "C" int flash_attention_bwd_tc_attrs(int D, int which, int* out) {
  return bwd::tc::attrs_by_width(D, which, out);
}

// Backward of attention.  q, o, dO, dq: (B, H, Sq, D); k, v, dk, dv:
// (B, Hkv, Skv, D) with H % Hkv == 0; each by element strides (batch,
// head, position) with a contiguous last axis, in the order q, k, v, o,
// dO, dq, dk, dv; all float32 (bf16 = 0) or all bf16 (bf16 = 1).  lse:
// the forward's contiguous float32 (B·H, Sq) row log-sum-exp; scratch:
// flash_attention_bwd_scratch(...) floats, 16-byte aligned.  causal,
// window, prefix as the forward's (window ≤ 0: none; prefix > 0 takes
// causal; each takes Sq == Skv).  D ≤ 256, Skv ≤ 65,535 key tiles
// (`key_tile(D)` keys each).  Launches three kernels on `stream` (the
// route by shape: see the top of this file), allocates nothing, returns
// the CUDA error code (0 on success).
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dO, const void* lse, void* scratch, void* dq, void* dk,
    void* dv, int bf16, int B, int H, int Hkv, int Sq, int Skv, int D,
    const long long* strides, int causal, int window, int prefix,
    float scale, void* stream) {
  if (B == 0 || H == 0 || Sq == 0 || D == 0) return 0;
  const int bk = bwd::key_tile(D);
  if (D > 256 || Hkv <= 0 || H % Hkv != 0 || Skv <= 0 ||
      (Skv + bk - 1) / bk > bwd::MAX_KEY_TILES ||
      ((causal || window > 0) && Sq != Skv) || prefix < 0 ||
      (prefix > 0 && !causal))
    return static_cast<int>(cudaErrorInvalidValue);
  const bwd::Call c = bwd::make_call(q, k, v, o, dO, dq, dk, dv, B, H, Hkv,
                                     Sq, Skv, D, strides, causal, window,
                                     prefix);
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* sc = static_cast<float*>(scratch);
  if (bwd::tc_route(c, bf16)) {
    const int rc = bwd::launch_delta<__nv_bfloat16>(c, sc, cs);
    if (rc != 0) return rc;
    return bwd::tc::by_width(c, l, sc, scale, cs);
  }
  if (bf16) return bwd::by_width<__nv_bfloat16>(c, l, sc, scale, cs);
  return bwd::by_width<float>(c, l, sc, scale, cs);
}
