// Flash attention for Hopper (sm_90a): online-softmax attention of Sq
// query rows over Skv keys, float32 accumulation, optional causal,
// prefix-LM and sliding-window masks (equal lengths only), grouped kv
// heads.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:82
// `flash_attention` (body `_flash_kernel`, :28), which takes one length
// for q and kv; this one also takes a kv length of its own (an encoder-
// decoder's cross-attention: Sq decoder rows over Skv encoder frames).
// For each (batch, head) and query row:
//
//   s_j = (q · k_j) · scale,  masked where kpos > max(qpos, P − 1)
//                              (causal; P the prefix, 0 by default) or
//                              qpos − kpos ≥ window (window > 0)
//   out = Σ_j softmax(s)_j · v_j          in q's dtype
//
// The prefix-LM mask is the reference's (repro/models/layers.py:208–211,
// PaliGemma's): positions below P see each other both ways, every later
// position sees what the causal mask shows it — `kpos ≤ qpos or (qpos < P
// and kpos < P)`, which is `kpos ≤ max(qpos, P − 1)`.  The TPU kernel has
// no prefix (the reference computes that attention in jnp); only the FFMA
// template takes one.
//
// q, k, v and out are addressed by (batch, head, position) element
// strides with a contiguous last axis, so the DiT's (B, S, H, D)
// projections are read as a (B, H, S, D) view without a transposed copy.
// Query head h reads kv head h / (H / Hkv) (the GQA front end without
// repeating k and v).
//
// Two forward kernels, picked by shape (the rule is `flash_attention` at
// the end of the forward): bf16 q, k, v with D a multiple of 16 up to 128,
// 16-byte staging (below), at most 65,535 query tiles of 128 and no prefix
// go to the tensor-core kernel `flash_attention_bf16_tc_kernel` (its
// design is written above it); everything else — float32 (the DiT path),
// bf16 at another D, unaligned views, any prefix — goes to the FFMA
// template
// `flash_attention_kernel`.  A failed launch of either returns its error.
//
// The FFMA template.  What bounds it on this card: float32 operations.  At
// the DiT's self-attention shape (32 sequences × 12 heads, S 256, D 64) a
// launch does 4·S²·D per head = 6.4 GFLOP on 100 MB of operands, ~64 FLOP
// per byte, above the ~20 FLOP per byte where float32 CUDA-core math
// (67 TFLOP/s) overtakes HBM (3.35 TB/s): 0.096 ms.  For float32 inputs
// tensor cores (TF32 or bf16) are excluded on purpose: the reference
// contracts q·k and p·v in full float32, so every product is an IEEE
// float32 FFMA.  For bf16 inputs a bf16 tensor-core product is exact in
// float32, so the tensor-core kernel runs q·kᵀ there, and p·v with p
// split in two bf16 terms.
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
// Only the kv tiles a mask leaves partly open are visited (causal, prefix
// and window bounds per query tile); inside them every masked logit is dropped
// exactly (probability 0), and a tile no mask touches skips the mask
// test.  Partial tiles (Sq or Skv not a multiple of the tile) are
// zero-filled and masked.  The row maximum and sum reduce over the 8 lanes that share a
// row with shuffles.  The output is acc / max(l, 1e-30), as the TPU kernel
// finalises it.  expf and IEEE division: no fast-math.

#include <math.h>

#include "flash_attention.cuh"

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

// Shared bytes of a launch: the query tile, two k and two v tiles, and the
// probability tile (BKV + 8 floats a row: conflict-free stores and
// 16-byte reads).
__host__ __device__ inline int smem_bytes(int D, int esize, int BQ,
                                          int BKV) {
  return (BQ + 4 * BKV) * row_pitch(D, esize) + BQ * (BKV + 8) * 4;
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

// One block per (batch·head, RG·TR query rows), RG = THREADS / 8; thread
// (rg, cg) owns query rows rg + RG·i (i < TR), keys cg + 8j of each kv tile
// (j < BKV / 8) and output columns 32c + 4cg + (0..3).  VEC: D and every
// stride a multiple of 16 bytes' elements, every base 16-byte aligned.
template <typename T, int DMAX, bool VEC>
__global__ void __launch_bounds__(Config<DMAX>::THREADS, Config<DMAX>::MINB)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       float* __restrict__ lse, int H, int group, int Sq,
                       int Skv, int D, Strides sq, Strides sk, Strides sv,
                       Strides so, int causal, int window, int prefix,
                       float scale) {
  constexpr int TR = Config<DMAX>::TR, BKV = Config<DMAX>::BKV;
  constexpr int RG = Config<DMAX>::THREADS / 8;  // row groups
  constexpr int BQ = RG * TR, TK = BKV / 8, NC = DMAX / 32;
  constexpr int PP = BKV + 8, NT = Config<DMAX>::THREADS;

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

  // kv range this query tile can see: [lo, hi) (a prefix opens keys
  // below P to every query: prefix is 0 unless causal).
  int hi = Skv;
  if (causal) hi = min(Skv, max(q0 + BQ, prefix));
  int lo = 0;
  if (window > 0) lo = max(0, q0 - (window - 1));
  lo = (lo / BKV) * BKV;

  stage<T, DMAX, VEC, NT>(Qs, pitch, qh, sq.s, q0, BQ, Sq, D);
  stage<T, DMAX, VEC, NT>(Ks, pitch, kh, sk.s, lo, BKV, Skv, D);
  stage<T, DMAX, VEC, NT>(Vs, pitch, vh, sv.s, lo, BKV, Skv, D);
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
      stage<T, DMAX, VEC, NT>(Ks + nxt, pitch, kh, sk.s, k0 + BKV, BKV, Skv,
                              D);
      stage<T, DMAX, VEC, NT>(Vs + nxt, pitch, vh, sv.s, k0 + BKV, BKV, Skv,
                              D);
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
    const bool open_tile = !causal && window <= 0 && k0 + BKV <= Skv;
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int qpos = q0 + rg + RG * i;
      const int last = max(qpos, prefix - 1);  // the causal mask's last key
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < TK; ++j) {
        const int kpos = k0 + cg + 8 * j;
        const bool open = open_tile ||
                          (kpos < Skv && (!causal || kpos <= last) &&
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
    if (qpos >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    // the row's log-sum-exp of the scaled logits, for the backward only
    if (lse != nullptr && cg == 0)
      lse[(int64_t)bh * Sq + qpos] = m[i] + logf(l[i]);
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

// 16-byte staging: D and every batch, head and row stride whole 16-byte
// chunks of elements, every base 16-byte aligned (a stride of an axis of
// length 1 is never used).
bool vec_staging(int esize, const void* q, const void* k, const void* v,
                 const void* o, int B, int H, int Hkv, int D,
                 const Strides& sq, const Strides& sk, const Strides& sv,
                 const Strides& so) {
  const int ev = 16 / esize;
  const auto rows_ok = [&](const Strides& st, int heads) {
    return (B == 1 || st.b % ev == 0) && (heads == 1 || st.h % ev == 0) &&
           st.s % ev == 0;
  };
  const auto aligned = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  };
  return D % ev == 0 && rows_ok(sq, H) && rows_ok(so, H) && rows_ok(sk, Hkv) &&
         rows_ok(sv, Hkv) && aligned(q) && aligned(k) && aligned(v) &&
         aligned(o);
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int Hkv, int Sq, int Skv, int D, Strides sq,
           Strides sk, Strides sv, Strides so, int causal, int window,
           int prefix, float scale, bool vec, cudaStream_t stream) {
  using C = Config<DMAX>;
  constexpr int BQ = C::THREADS / 8 * C::TR, BKV = C::BKV;
  const int smem = smem_bytes(D, sizeof(T), BQ, BKV);
  auto kern = vec ? flash_attention_kernel<T, DMAX, true>
                  : flash_attention_kernel<T, DMAX, false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kern<<<grid, Config<DMAX>::THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, H / Hkv, Sq, Skv,
      D, sq, sk, sv, so, causal, window, prefix, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_width(const void* q, const void* k, const void* v, void* o, float* lse,
             int B, int H, int Hkv, int Sq, int Skv, int D, Strides sq,
             Strides sk, Strides sv, Strides so, int causal, int window,
             int prefix, float scale, bool vec, cudaStream_t st) {
  if (D <= 32)
    return launch<T, 32>(q, k, v, o, lse, B, H, Hkv, Sq, Skv, D, sq, sk, sv,
                         so, causal, window, prefix, scale, vec, st);
  if (D <= 64)
    return launch<T, 64>(q, k, v, o, lse, B, H, Hkv, Sq, Skv, D, sq, sk, sv,
                         so, causal, window, prefix, scale, vec, st);
  if (D <= 128)
    return launch<T, 128>(q, k, v, o, lse, B, H, Hkv, Sq, Skv, D, sq, sk, sv,
                          so, causal, window, prefix, scale, vec, st);
  return launch<T, 256>(q, k, v, o, lse, B, H, Hkv, Sq, Skv, D, sq, sk, sv,
                        so, causal, window, prefix, scale, vec, st);
}

// ---- bf16 forward on the tensor cores ------------------------------------
//
// For bf16 q, k and v the reference widens to float32 and contracts
// (repro/kernels/flash_attention.py:42–46, 65): a bf16 × bf16 product is
// exact in float32, so q·kᵀ on `wgmma … .f32.bf16.bf16` computes the
// reference's logits but for the order of the sums.  p·v needs care: the
// reference keeps p in float32, and one bf16 p keeps 8 of its bits (an
// error near 2⁻⁹ of the output, most of a bf16 ulp).  So p is split in
// two bf16 terms, p_hi = bf16(p) and p_lo = bf16(p − p_hi), and both go
// through the tensor cores into the same float32 accumulator: 16 bits of
// p, an error near 2⁻¹⁷ of the accumulator.
//
// What bounds it on this card: the larger of bf16 tensor operations
// (989 TFLOP/s) and the bytes of q, k, v and the output (3.35 TB/s).  At
// internlm2's causal shape (B 4, 16 query heads over 8 kv heads of D 128,
// S 1024) the open pairs need 17.2 GFLOP counted once, 0.0174 ms (25.8
// counting the split p·v twice); at zamba2's (32 heads of D 80) 21.5
// GFLOP (32.2), but 83.9 MB of operands, 0.0250 ms.
//
// The design (one block of 256 threads per (query tile of 128, b·h); each
// of its two warpgroups owns 64 query rows, every thread also a loader):
//   * q is staged once, k and v through a ring of NST = 4 kv tiles of 64
//     keys by 16-byte cp.async, two tiles ahead of the one computed;
//   * q and k lie K-major (D contiguous) in the 128-byte swizzle, in
//     blocks of 64 columns; a D off a multiple of 64 (80) leaves the last
//     block's rows partly unused, but only the D/16 k-steps that hold data
//     are issued (no zero-padded tensor work);
//   * S = q·kᵀ: D/16 `wgmma m64n64k16` from shared memory, float32;
//   * the online softmax runs on the accumulator fragment: a thread holds
//     2 rows × 16 keys; the row maximum reduces over the 4 lanes that
//     share a row; each thread keeps its own share of the row sum, added
//     over the 4 lanes at the end; masked logits get probability 0 exactly,
//     and only tiles that touch the diagonal, the window's edge or S run
//     the mask test;
//   * O += P·V: P stays in registers (the accumulator fragment, packed in
//     bf16 pairs, is the A fragment of `wgmma m64nDk16` with A from
//     registers); V is the B operand as it lies (keys × D, D contiguous:
//     MN-major), staged in the swizzle whose width divides 2·D bytes
//     (128, 64 or 32) and read through wgmma's transposed-B form, so V is
//     never transposed; two products a k-step, p_hi and p_lo;
//   * a warpgroup issues S(t), rescales O, issues P(t−1)·V(t−1), runs the
//     softmax of tile t while that product is on the tensor cores, and
//     splits P(t) once it retires (FlashAttention-3's order): its own
//     exponentials overlap its own products;
//   * causal query tiles run heaviest first (grid (b·h, tile), tile index
//     reversed); a block visits only the kv tiles its rows can see;
//   * the output is acc / max(l, 1e-30) in bf16 (IEEE division), the
//     optional float32 lse m + log(l), as the FFMA template writes them.
// Registers: S 32, O D/2, P 32 (16 each term): one block an SM.  Shared:
// q 16 KB and each kv tile's k 8 KB a 64-column block, its v 128·D
// bytes: 161 KB at D 128, 137 KB at D 80.

namespace tc {

constexpr int THREADS = 256;        // two warpgroups
constexpr int BQ = 128;             // query rows a block, 64 a warpgroup
constexpr int BKV = 64;             // keys a kv tile
constexpr int NST = 4;              // kv tiles in the ring
constexpr int MAX_TILES = 65535;    // query tiles: grid y

using bf16 = __nv_bfloat16;

template <int D> struct Tile {
  static_assert(D % 16 == 0 && D <= 128, "D a multiple of 16 up to 128");
  static constexpr int KB = (D + 63) / 64;  // 128-byte blocks of a q/k row
  // V's swizzle width: the largest of 128, 64, 32 bytes that divides a row
  static constexpr int VW = (2 * D) % 128 == 0 ? 128
                            : (2 * D) % 64 == 0 ? 64 : 32;
  static constexpr int VLAYOUT = VW == 128 ? 1 : VW == 64 ? 2 : 3;
  static constexpr int VB = 2 * D / VW;     // V's column blocks
  static constexpr int Q_BYTES = KB * BQ * 128;
  static constexpr int K_BYTES = KB * BKV * 128;
  static constexpr int V_BYTES = VB * BKV * VW;
  static constexpr int STAGE_BYTES = K_BYTES + V_BYTES;
  static constexpr int SMEM = Q_BYTES + NST * STAGE_BYTES + 1024;
  static_assert(STAGE_BYTES % 1024 == 0, "1024-byte aligned tiles");
};

// Rows [row0, row0 + n) of one head, K-major in the 128-byte swizzle:
// 16-byte chunk ch of row r in block ch / 8 (n × 128 bytes each) at
// sw128(r, ch % 8).  Rows past S (the head's length) are zero-filled.
template <int D>
__device__ __forceinline__ void stage_k_major(uint32_t dst,
                                              const bf16* __restrict__ src,
                                              int64_t ss, int row0, int n,
                                              int S) {
  constexpr int CPR = D / 8;
  for (int i = threadIdx.x; i < n * CPR; i += THREADS) {
    const int r = i / CPR, ch = i % CPR;
    const int pos = row0 + r;
    const bool in = pos < S;
    hopper::cp_async16(dst + (ch / 8) * (n * 128) + hopper::sw128(r, ch % 8),
                       in ? src + (int64_t)pos * ss + ch * 8 : src,
                       in ? 16 : 0);
  }
}

// Keys [row0, row0 + BKV) of v, MN-major: rows of VW bytes in VB blocks
// (BKV × VW bytes each), each under the VW-byte swizzle.  Keys past S are
// zero-filled.
template <int D>
__device__ __forceinline__ void stage_mn_major(uint32_t dst,
                                               const bf16* __restrict__ src,
                                               int64_t ss, int row0, int S) {
  constexpr int CPR = D / 8, VW = Tile<D>::VW, WC = VW / 16;
  for (int i = threadIdx.x; i < BKV * CPR; i += THREADS) {
    const int r = i / CPR, ch = i % CPR;
    const int pos = row0 + r;
    const bool in = pos < S;
    hopper::cp_async16(
        dst + (ch / WC) * (BKV * VW) + hopper::swizzle(r * VW + ch % WC * 16,
                                                       VW),
        in ? src + (int64_t)pos * ss + ch * 8 : src, in ? 16 : 0);
  }
}

// Block (b·h, query tile); see the design above.  All operands staged by
// 16-byte cp.async (the launcher checks the rule).
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_bf16_tc_kernel(const bf16* __restrict__ q,
                               const bf16* __restrict__ k,
                               const bf16* __restrict__ v,
                               bf16* __restrict__ o, float* __restrict__ lse,
                               int H, int group, int Sq, int Skv, Strides sq,
                               Strides sk, Strides sv, Strides so, int causal,
                               int window, float scale) {
  using T = Tile<D>;
  constexpr int NO = D / 2;         // O accumulator registers a thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t s0 = (hopper::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = s0, sKV = s0 + T::Q_BYTES;

  const int bh = blockIdx.x, b = bh / H, h = bh % H, hk = h / group;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int qw = q0 + 64 * wg;                      // the warpgroup's rows
  const int r0 = qw + 16 * ((tid >> 5) & 3) + (lane >> 2);  // + 8 · half

  const bf16* qh = q + b * sq.b + h * sq.h;
  const bf16* kh = k + b * sk.b + hk * sk.h;
  const bf16* vh = v + b * sv.b + hk * sv.h;

  // kv positions [lo, hi) the block sees, lo on a tile.  Both warpgroups
  // run every tile: a wgmma under a branch that depends on the thread
  // makes ptxas serialize every wgmma of the kernel (C7520), so the first
  // warpgroup also runs the block's last diagonal tile, all masked for its
  // rows (skipping its softmax measured no faster: the block barrier holds
  // the warpgroup for the other one's diagonal tile anyway).
  const int lo = (window > 0 ? max(0, q0 - (window - 1)) : 0) / BKV * BKV;
  const int hi = causal ? min(Skv, q0 + BQ) : Skv;
  const int n = (hi - lo + BKV - 1) / BKV;

  const auto stage_kv = [&](int t) {
    const uint32_t st = sKV + (t % NST) * T::STAGE_BYTES;
    stage_k_major<D>(st, kh, sk.s, lo + t * BKV, BKV, Skv);
    stage_mn_major<D>(st + T::K_BYTES, vh, sv.s, lo + t * BKV, Skv);
  };
  stage_k_major<D>(sQ, qh, sq.s, q0, BQ, Sq);
  stage_kv(0);
  hopper::cp_async_commit();
  if (n > 1) stage_kv(1);
  hopper::cp_async_commit();

  float sacc[32], oacc[NO];
  uint32_t ph[4][4], pl[4][4];      // P: 4 k-steps × 4 registers, 2 terms
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NO; ++i) oacc[i] = 0.f;
  const auto fence_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hopper::reg_fence(ph[kk]);
      hopper::reg_fence(pl[kk]);
    }
  };

  // Waits for tile t, then starts tile t + 2's copies into the stage of
  // tile t − 2, which both warpgroups are done with.
  const auto next_tile = [&](int t) {
    hopper::cp_async_wait<1>();     // tile t has landed (tile t + 1 flies)
    hopper::fence_proxy_async();
    __syncthreads();
    if (t + 2 < n) stage_kv(t + 2);
    hopper::cp_async_commit();
  };
  // S = q·kᵀ of tile t: D/16 k-steps.  Each issue is fenced on both sides
  // for its registers, so the compiler moves no access of them across it.
  const auto issue_s = [&](int t) {
    const uint32_t kb = sKV + (t % NST) * T::STAGE_BYTES;
    hopper::reg_fence(sacc);
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t off = 32 * (ks % 4);
      hopper::wgmma_bf16_n64(
          sacc,
          hopper::sw128_desc(sQ + (ks / 4) * (BQ * 128) + wg * 64 * 128 + off),
          hopper::sw128_desc(kb + (ks / 4) * (BKV * 128) + off), ks > 0);
    }
    hopper::wgmma_commit();
    hopper::reg_fence(sacc);
  };
  // O += P·V of tile t: two products a k-step of 16 keys, p_hi and p_lo.
  const auto issue_pv = [&](int t) {
    const uint32_t vs = sKV + (t % NST) * T::STAGE_BYTES + T::K_BYTES;
    hopper::reg_fence(oacc);
    fence_p();
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = hopper::smem_desc(vs + kk * 16 * T::VW, BKV * T::VW,
                                            8 * T::VW, T::VLAYOUT);
      hopper::WgmmaRsBf16MnB<D>::run(oacc, ph[kk], db);
      hopper::WgmmaRsBf16MnB<D>::run(oacc, pl[kk], db);
    }
    hopper::wgmma_commit();
    hopper::reg_fence(oacc);
    fence_p();
  };
  // The online softmax of tile t on S, in place (accumulator register
  // 4j + e: row r0 + 8·(e / 2), key k0 + 8j + 2·(lane % 4) + e % 2): S
  // becomes P in float32, alpha each row's rescale factor for O.  Only a
  // tile that the diagonal, the window's edge or S cuts runs the mask
  // test; a masked logit is -inf and gets exp(-inf) = 0 exactly (a key
  // past Skv too: its zero-filled row gives logit 0, which the test
  // masks).
  float alpha[2];
  const auto softmax = [&](int t) {
    const int k0 = lo + t * BKV;
#pragma unroll
    for (int i = 0; i < 32; ++i) sacc[i] *= scale;
    if (k0 + BKV > Skv || (causal && k0 + BKV - 1 > qw) ||
        (window > 0 && qw + 63 - k0 >= window)) {
      const int c0 = k0 + 2 * (lane & 3);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int qpos = r0 + 8 * ((i >> 1) & 1);
        const int kpos = c0 + 8 * (i >> 2) + (i & 1);
        if (!(kpos < Skv && (!causal || kpos <= qpos) &&
              (window <= 0 || qpos - kpos < window)))
          sacc[i] = -INFINITY;
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          mx = fmaxf(mx, sacc[4 * j + 2 * hf + e]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hf], mx);
      // a row with nothing open yet (m_new = -inf) subtracts 0: its
      // masked logits still give 0, and alpha = 0 leaves O and l at 0
      const float m_sub = m_new == -INFINITY ? 0.f : m_new;
      alpha[hf] = expf(m[hf] - m_sub);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sacc[4 * j + 2 * hf + e];
          x = expf(x - m_sub);
          rsum += x;
        }
      l[hf] = l[hf] * alpha[hf] + rsum;
      m[hf] = m_new;
    }
  };
  // P in two bf16 terms, as A fragments: k-step kk, register r holds
  // accumulator registers 8kk + 2r and 8kk + 2r + 1.
  const auto split_p = [&]() {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      split_pair(sacc[2 * i], sacc[2 * i + 1], ph[i / 4][i % 4],
                 pl[i / 4][i % 4]);
  };
  const auto rescale_o = [&]() {
#pragma unroll
    for (int i = 0; i < NO; ++i) oacc[i] *= alpha[(i >> 1) & 1];
  };

  // Tile 0 alone; then tile t's S issued, O rescaled, tile t − 1's P·V
  // issued, and the softmax of t run while P(t − 1)·V(t − 1) is on the
  // tensor cores; then the last P·V.  No wgmma sits under a branch, and
  // between an issue and the wait that retires it no other instruction
  // touches its registers (else ptxas serializes every wgmma: C7513,
  // C7514, C7520).
  next_tile(0);
  issue_s(0);
  hopper::wgmma_wait<0>();
  hopper::reg_fence(sacc);
  softmax(0);
  split_p();
  for (int t = 1; t < n; ++t) {
    next_tile(t);
    issue_s(t);
    rescale_o();
    issue_pv(t - 1);
    hopper::wgmma_wait<1>();        // S(t) is done
    hopper::reg_fence(sacc);
    softmax(t);
    hopper::wgmma_wait<0>();        // P(t − 1)·V(t − 1) is done
    hopper::reg_fence(oacc);
    fence_p();
    split_p();
  }
  rescale_o();
  issue_pv(n - 1);
  hopper::wgmma_wait<0>();
  hopper::reg_fence(oacc);

  if (qw >= Sq) return;
  bf16* oh = o + b * so.b + h * so.h;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float lt = l[hf] + __shfl_xor_sync(0xffffffffu, l[hf], 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int qpos = r0 + 8 * hf;
    if (qpos >= Sq) continue;
    const float denom = fmaxf(lt, 1e-30f);
    // the row's log-sum-exp of the scaled logits, for the backward only
    if (lse != nullptr && (lane & 3) == 0)
      lse[(int64_t)bh * Sq + qpos] = m[hf] + logf(lt);
    bf16* row = oh + (int64_t)qpos * so.s + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const __nv_bfloat162 pair = __floats2bfloat162_rn(
          oacc[4 * j + 2 * hf] / denom, oacc[4 * j + 2 * hf + 1] / denom);
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) = pair;
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int Hkv, int Sq, int Skv, Strides sq, Strides sk,
           Strides sv, Strides so, int causal, int window, float scale,
           cudaStream_t stream) {
  constexpr int smem = Tile<D>::SMEM;
  auto kern = flash_attention_bf16_tc_kernel<D>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, H, H / Hkv, Sq,
      Skv, sq, sk, sv, so, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

int by_width(const void* q, const void* k, const void* v, void* o, float* lse,
             int B, int H, int Hkv, int Sq, int Skv, int D, Strides sq,
             Strides sk, Strides sv, Strides so, int causal, int window,
             float scale, cudaStream_t st) {
  switch (D) {
#define TC_CASE(W)                                                        \
  case W:                                                                 \
    return launch<W>(q, k, v, o, lse, B, H, Hkv, Sq, Skv, sq, sk, sv, so, \
                     causal, window, scale, st);
    TC_CASE(16) TC_CASE(32) TC_CASE(48) TC_CASE(64) TC_CASE(80) TC_CASE(96)
    TC_CASE(112) TC_CASE(128)
#undef TC_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tc

}  // namespace

// q, o: (B, H, Sq, D); k, v: (B, Hkv, Skv, D) with H % Hkv == 0; each by
// element strides (batch, head, position) with a contiguous last axis;
// all float32 (bf16 = 0) or all bf16 (bf16 = 1).  D ≤ 256, B·H ≤ 65,535.
// window ≤ 0 means no window; prefix > 0 (the prefix-LM mask's P) takes
// causal; causal, window and prefix take Sq == Skv (the launcher checks
// it).  lse: null, or a contiguous float32 (B·H, Sq) that
// receives each query row's log-sum-exp of its scaled logits (what the
// backward recomputes the probabilities from).  Launches on `stream`,
// allocates nothing, returns the CUDA error code (0 on success).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, void* lse, int bf16, int B, int H,
                               int Hkv, int Sq, int Skv, int D, long long sqb,
                               long long sqh, long long sqs, long long skb,
                               long long skh, long long sks, long long svb,
                               long long svh, long long svs, long long sob,
                               long long soh, long long sos, int causal,
                               int window, int prefix, float scale,
                               void* stream) {
  if (B == 0 || H == 0 || Sq == 0 || D == 0) return 0;
  if (Skv <= 0 || ((causal || window > 0) && Sq != Skv) || prefix < 0 ||
      (prefix > 0 && !causal))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides sq{sqb, sqh, sqs}, sk{skb, skh, sks}, sv{svb, svh, svs},
      so{sob, soh, sos};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const bool vec = vec_staging(bf16 ? 2 : 4, q, k, v, o, B, H, Hkv, D, sq,
                               sk, sv, so);
  // the design by shape: the tensor-core kernel for bf16 at D a multiple
  // of 16 up to 128 with 16-byte staging and no prefix, else the FFMA
  // template
  if (bf16 && D % 16 == 0 && D <= 128 && vec && prefix == 0 &&
      (Sq + tc::BQ - 1) / tc::BQ <= tc::MAX_TILES)
    return tc::by_width(q, k, v, o, l, B, H, Hkv, Sq, Skv, D, sq, sk, sv, so,
                        causal, window, scale, st);
  if (bf16)
    return by_width<__nv_bfloat16>(q, k, v, o, l, B, H, Hkv, Sq, Skv, D, sq,
                                   sk, sv, so, causal, window, prefix, scale,
                                   vec, st);
  return by_width<float>(q, k, v, o, l, B, H, Hkv, Sq, Skv, D, sq, sk, sv, so,
                         causal, window, prefix, scale, vec, st);
}
