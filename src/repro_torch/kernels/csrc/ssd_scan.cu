// Mamba2 SSD chunked scan for Hopper (sm_90a), from the zero state, and
// its backward (ssd_scan_bwd, after the forward below).
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py:86 `ssd_scan` (body
// `_ssd_kernel`, :25).  For each (batch, head) with rate A and each chunk
// of q positions, all in float32:
//
//   cum_i   = Σ_{k ≤ i} dt_k·A                               (in-chunk)
//   y_i     = Σ_{j ≤ i} (C_i·B_j) exp(cum_i − cum_j) dt_j x_j    intra
//           + exp(cum_i) · C_i · stateᵀ                            inter
//   state  ← exp(cum_last)·state + Σ_j exp(cum_last − cum_j) dt_j x_j ⊗ B_j
//
// y is written in x's dtype, the final (P, N) state in float32.
//
// What bounds it on this card: float32 operations.  At mamba2-2.7b's
// mixer shape (4 sequences × 80 heads, S 1024, P 64, N 128, chunk 128) the
// inputs need 13.5 GFLOP (C·Bᵀ once per (batch, chunk), the intra product
// on the causal triangle only) on ≈ 98 MB of operands, far above the ~20
// FLOP per byte where float32 CUDA-core math (67 TFLOP/s) overtakes HBM
// (3.35 TB/s): 0.20 ms.  Tensor cores are excluded on purpose: the
// reference computes every product in full float32, and three of the four
// products have a float32 operand (the masked scores, the carried state,
// x·w); C·Bᵀ, the one product of two inputs, is 0.5 % of the work once it
// is computed per chunk.
//
// Two kernels, launched back to back on one stream:
//
// 1. ssd_scan_prep_kernel, once per (batch, tile), not per head: writes a
//    float32 scratch of 3 × 128 × 128 floats a tile (192 KB; 6 MB at the
//    mixer shape, so it stays in L2):
//      CBt[j][i] = C_i·B_j   for j ≤ i < q, 0 elsewhere (C·Bᵀ, transposed)
//      Ct[n][i]  = C_i[n]    (C transposed, widened, zero padded)
//      Bf[j][n]  = B_j[n]    (B widened, zero padded)
//    so the scan reads every operand shared by the heads as float32 rows
//    laid out for its register tiles, whatever the inputs' dtype, strides
//    or alignment.  Grid (4 row quarters, tiles, batch) of 256 threads: a
//    block stages its 32 rows of C and the B rows up to its last row in
//    one pass (16-byte loads where aligned; 84 KB of dynamic shared
//    memory), then each thread sums 4 × 4 entries over n in order.
//
// 2. ssd_scan_kernel: one block of 128 threads per (batch, head).  The
//    recurrence is independent for each state row p (state[p, :] needs
//    only x[:, p]): the block's four warps are two column groups of 32
//    rows p × two row halves of the tile, so both groups share every
//    staged slab and the scores.  Each block walks its tiles in order;
//    per tile it streams 8-deep slabs through a 3-slot ring of 16-byte
//    cp.async, two slabs in flight while one is computed, one block
//    barrier a slab:
//      * inter slabs (8 rows n of Ct; none in the first tile, whose state
//        is zero): acc[i][p] += C[i][n]·state[p][n] against the state, kept
//        transposed in shared memory (St[n][p], 16-byte words swizzled so
//        that the state update's quarter warps hit 8 bank groups);
//      * then acc *= exp(cum_i), and score slabs (8 positions j: CBt rows
//        from the diagonal on, x rows): each warp turns 32 rows of CBt into
//        scores S_ij = CB_ij·exp(cum_i − cum_j)·dt_j in place, selected to
//        0 above the diagonal before any exp (there it may be inf, and
//        inf·0 is NaN); bf16 x is widened once into the slot; then
//        acc += S·x (a warp whose rows all lie above the slab skips it);
//      * y = acc in x's dtype; then update slabs (Bf rows, x rows): each
//        warp turns its 16 columns of x into x·w (w_j = dt_j·exp(cum_last −
//        cum_j)), upd[p][n] += (x·w)[j][p]·B[j][n];
//      * state ← exp(cum_last)·state + upd.
//    Every product is a register tile of 8 × 8 a thread: two 16-byte
//    shared loads of each operand per 64 FFMA, 4 FFMA per float read,
//    conflict-free (a quarter warp reads distinct 16-byte bank groups or
//    one broadcast word); only one accumulator is live at a time.  Warp 0
//    loads the next tile's dt a tile ahead and computes the cumulative
//    log-decay with shuffles.
//
// Budget at the mixer shape (bf16; float32 in brackets):
//   shared memory  3 slots × 7 KB [8 KB] + the state 32 KB + 2 KB of
//                  per-position scalars = 55 KB [58 KB] a block, dynamic,
//                  with the largest carveout;
//   registers      at most 168 a thread (__launch_bounds__(128, 3));
//   blocks per SM  3 (12 warps), by registers and shared memory;
//   waves          4 × 80 = 320 blocks on 132 × 3 = 396 slots: one wave,
//                  at most 3 blocks an SM against 2.42 on average;
//   L2 re-reads    per block and tile Ct 64 KB (not in the first tile),
//                  CBt from the diagonal on 34 KB, Bf 64 KB, x twice 32 KB
//                  [64 KB]: 476 MB [558 MB] a call, against 98 MB of
//                  operands.
// The variants tried and not kept (one block a column group, bf16 C and
// B widened as read, the scores and the update in one pass, 16-deep
// slabs) are in PERF.md.
//
// Chunks of up to 128 positions are one tile each (tile = chunk); longer
// chunks walk tiles of 128.  A last partial tile is masked, P < 64 and
// N < 128 zero padded.  x, B, C and y are addressed by (batch, head,
// position) element strides with a contiguous last axis, so the mixer's
// slices of its projection are read without copies; x rows off 16-byte
// alignment (or P not a multiple of a 16-byte word) are staged element by
// element, as are y rows.  expf and IEEE arithmetic: no fast-math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <initializer_list>

#include "hopper.cuh"

namespace {

constexpr int QT = 128;            // positions per tile (the largest chunk)
constexpr int PM = 64;             // head dim capacity
constexpr int NM = 128;            // state dim capacity
constexpr int PG = 32;             // state rows p of a column group
constexpr int KS = 8;              // depth of a staged slab
constexpr int THREADS = 128;       // two column groups × two row halves
constexpr int MIN_BLOCKS = 3;
constexpr unsigned FULL = 0xffffffffu;

constexpr int PREP_THREADS = 256;
constexpr int PREP_ROWS = 32;      // rows i of C·Bᵀ per prep block
constexpr int PREP_PITCH = NM + 4; // a staged row of the prep, in floats
constexpr int PREP_SMEM = (PREP_ROWS + QT) * PREP_PITCH * 4;

// Byte layouts for inputs of type T.  The scratch of one (batch, tile),
// float32: CBt[j][i], Ct[n][i], Bf[j][n].  A ring slot: CBt rows (turned
// into the scores in place) with x rows as staged (T) and, for bf16, x
// widened once (XF); or Ct rows; or Bf rows with x rows and x·w (XF).
// Then the state and the per-position scalars.
template <typename T>
struct Layout {
  static constexpr int TILE_BYTES = 3 * QT * NM * 4;
  static constexpr int OFF_CT = QT * QT * 4;
  static constexpr int OFF_BF = OFF_CT + NM * QT * 4;
  static constexpr int SLAB = KS * QT * 4;        // CBt, Ct or Bf rows
  static constexpr int OFF_X = SLAB;              // x rows (T)
  static constexpr int OFF_XF = OFF_X + KS * PM * sizeof(T);  // float32
  static constexpr int SLOT = OFF_XF + KS * PM * 4;
  // St[n][p] (float32), cum, dt, w, exp(cum) per position, exp(cum_last)
  static constexpr int FIXED = NM * PM * 4 + 4 * QT * 4 + 16;
  static constexpr int NSLOT = 3;
  static constexpr int SMEM = NSLOT * SLOT + FIXED;
  // MIN_BLOCKS blocks an SM: 228 KB less 1 KB reserved per block
  static_assert(MIN_BLOCKS * (SMEM + 1024) <= 228 * 1024, "shared memory");
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float* o, float v) { *o = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* o, float v) {
  *o = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void put4(float* v, const float4& q) {
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

// 8 consecutive staged values as float32 (bf16 widened exactly).
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  put4(v, ld4(p));
  put4(v + 4, ld4(p + 4));
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// The state columns n of update-tile lane nb, e = 0 .. 7: two runs of 4
// columns half a row apart, so a quarter warp reads 8 distinct 16-byte
// words of a Bf row.
__device__ __forceinline__ int state_col(int nb, int e) {
  return (e < 4 ? 0 : NM / 2) + 4 * nb + (e & 3);
}

// Element (n, p) of the state St, kept transposed (row n of PM floats):
// the 16-byte word p / 4 of row n is stored at word (p / 4) ^ key(n),
// key(n) = (n / 4) % 8, the nb of the update-tile lanes that own row n,
// so the 8 lanes of a quarter warp, which update 8 rows at one p, hit 8
// bank groups; a row's words stay within their aligned 128 bytes, so
// reads along a row stay conflict-free.
__device__ __forceinline__ int st_idx(int n, int p) {
  return n * PM + ((((p >> 2) ^ ((n >> 2) & 7))) << 2) + (p & 3);
}

// 8 values to 8 consecutive (16-byte aligned) outputs.
__device__ __forceinline__ void store8(float* o, const float (&v)[8]) {
  reinterpret_cast<float4*>(o)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(o)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&t);
}
__device__ __forceinline__ void store8(__nv_bfloat16* o,
                                       const float (&v)[8]) {
  *reinterpret_cast<uint4*>(o) =
      make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                 pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

__device__ __forceinline__ void fma8x8(float (&c)[8][8], const float (&a)[8],
                                       const float (&b)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) c[i][j] = fmaf(a[i], b[j], c[i][j]);
}

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  void* y;
  float* state;
  float* starts;           // (B, H, ntiles, P, N) float32, or null
  unsigned char* scratch;  // (batch, ntiles, 3, 128, 128) float32
  int H, S, P, N, tile, ntiles;
  int vec_x, vec_y, vec_bc;  // x / y / B and C rows move as 16-byte words
  int64_t sxb, sxh, sxs;   // x (batch, head, position) strides
  int64_t sdb, sdh, sds;   // dt
  int64_t sbb, sbs;        // B (batch, position)
  int64_t scb, scs;        // C
  int64_t syb, syh, sys;   // y
};

__device__ __forceinline__ int tile_rows(const Args& a, int k) {
  return min(a.tile, a.S - k * a.tile);
}

// Rows of a (rows, N) matrix of T, `rs` elements apart, into shared rows
// of PREP_PITCH floats, widened and zero padded to NM columns (rows past
// `valid` are zero); rows from `g0` on also into the scratch rows `gdst`
// (NM floats apart).  With `vec` (N a whole number of 16-byte words, every
// row 16-byte aligned) each thread moves whole 16-byte words.
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, float* gdst, int g0,
                                           const T* src, int64_t rs,
                                           int rows, int valid, int N,
                                           bool vec, int tid) {
  if (vec) {
    constexpr int V = 16 / sizeof(T), W = NM / V;
    for (int e = tid; e < rows * W; e += PREP_THREADS) {
      const int r = e / W, c = (e % W) * V;
      float v[8];
      if (r < valid && c < N) {
        if (sizeof(T) == 2)
          load8(reinterpret_cast<const __nv_bfloat16*>(src + r * rs + c), v);
        else
          put4(v, *reinterpret_cast<const float4*>(src + r * rs + c));
      } else {
#pragma unroll
        for (int q = 0; q < V; ++q) v[q] = 0.f;
      }
#pragma unroll
      for (int q = 0; q < V; q += 4) {
        const float4 w = make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
        *reinterpret_cast<float4*>(&dst[r * PREP_PITCH + c + q]) = w;
        if (gdst && r >= g0)
          *reinterpret_cast<float4*>(&gdst[r * NM + c + q]) = w;
      }
    }
  } else {
    for (int e = tid; e < rows * NM; e += PREP_THREADS) {
      const int r = e / NM, n = e % NM;
      const float v = (r < valid && n < N) ? to_f32(src[r * rs + n]) : 0.f;
      dst[r * PREP_PITCH + n] = v;
      if (gdst && r >= g0) gdst[r * NM + n] = v;
    }
  }
}

// C·Bᵀ, C transposed and B of one (batch, tile) into the scratch: block
// (quarter, tile, batch) computes rows i0 .. i0 + 31 of C·Bᵀ (columns j
// up to i0 + 31, the rest is above the diagonal), the same columns of Ct
// and rows of Bf, from C rows i0 .. and B rows 0 .. i0 + 31 staged whole.
template <typename T>
__global__ void __launch_bounds__(PREP_THREADS)
    ssd_scan_prep_kernel(Args a) {
  using L = Layout<T>;
  extern __shared__ __align__(16) float psm[];
  float* Cs = psm;                                 // PREP_ROWS × PREP_PITCH
  float* Bs = psm + PREP_ROWS * PREP_PITCH;        // QT × PREP_PITCH
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int quarter = blockIdx.x, i0 = quarter * PREP_ROWS;
  const int k = blockIdx.y, b = blockIdx.z;
  const int t0 = k * a.tile, qv = tile_rows(a, k);
  unsigned char* out =
      a.scratch + ((int64_t)b * a.ntiles + k) * L::TILE_BYTES;
  float* CBt = reinterpret_cast<float*>(out);
  float* Ct = reinterpret_cast<float*>(out + L::OFF_CT);
  float* Bf = reinterpret_cast<float*>(out + L::OFF_BF);
  const T* Bg = static_cast<const T*>(a.B) + b * a.sbb + (int64_t)t0 * a.sbs;
  const T* Cg = static_cast<const T*>(a.C) + b * a.scb + (int64_t)t0 * a.scs;

  stage_rows(Cs, static_cast<float*>(nullptr), 0, Cg + (int64_t)i0 * a.scs,
             a.scs, PREP_ROWS, qv - i0, a.N, a.vec_bc, tid);
  stage_rows(Bs, Bf, i0, Bg, a.sbs, i0 + PREP_ROWS, qv, a.N, a.vec_bc, tid);
  __syncthreads();
  for (int e = tid; e < NM * PREP_ROWS; e += PREP_THREADS) {
    const int n = e / PREP_ROWS, r = e % PREP_ROWS;
    Ct[n * QT + i0 + r] = Cs[r * PREP_PITCH + n];
  }

  // this thread's entries: rows i0 + 4·warp + r, columns lane + 32·c for
  // c ≤ quarter (columns past the block's rows lie above the diagonal)
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  for (int n = 0; n < NM; n += 4) {
    float4 cv[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      cv[r] = ld4(&Cs[(4 * warp + r) * PREP_PITCH + n]);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (c <= quarter) bv[c] = ld4(&Bs[(lane + 32 * c) * PREP_PITCH + n]);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (c <= quarter)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][c] = dot4(cv[r], bv[c], acc[r][c]);
  }
  const int i = i0 + 4 * warp;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int j = lane + 32 * c;
    float v[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      v[r] = (j <= i + r && i + r < qv) ? acc[r][c] : 0.f;
    *reinterpret_cast<float4*>(&CBt[j * QT + i]) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

// Warp 0: the tile's dt (4 positions a lane, 0 past the tile), the
// cumulative log-decay and the weights of the tile's positions.
__device__ __forceinline__ void scan_dt(const float (&d)[4], float A,
                                        int lane, float* cum, float* dts,
                                        float* wts, float* ecum,
                                        float* decay) {
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    dts[4 * lane + e] = d[e];
    v[e] = d[e] * A;
  }
  v[1] += v[0];
  v[2] += v[1];
  v[3] += v[2];
  float tot = v[3];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_up_sync(FULL, tot, off);
    if (lane >= off) tot += t;
  }
  // the lanes before this one, as the scan summed them (no subtraction:
  // cum_i − cum_j already cancels digits of |cum|)
  const float before = __shfl_up_sync(FULL, tot, 1);
  const float excl = lane == 0 ? 0.f : before;
  const float last = __shfl_sync(FULL, v[3] + excl, 31);   // cum[QT-1]
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int j = 4 * lane + e;
    const float c = v[e] + excl;
    cum[j] = c;
    wts[j] = d[e] * expf(last - c);
    ecum[j] = expf(c);
  }
  if (lane == 0) *decay = expf(last);
}

// BYTES contiguous bytes (a multiple of 16·THREADS) global → shared,
// asynchronously, 16 bytes a copy.
template <int BYTES>
__device__ __forceinline__ void copy_slab(uint32_t dst, const void* src,
                                          int tid) {
  static_assert(BYTES % (16 * THREADS) == 0, "whole 16-byte copies");
  const unsigned char* s = static_cast<const unsigned char*>(src);
#pragma unroll
  for (int m = 0; m < BYTES / (16 * THREADS); ++m) {
    const int c = tid + m * THREADS;
    hopper::cp_async16(dst + 16 * c, s + 16 * c, 16);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    ssd_scan_kernel(Args a) {
  using L = Layout<T>;
  constexpr int NSLOT = L::NSLOT;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;                      // NSLOT × SLOT
  float* St = reinterpret_cast<float*>(smem + NSLOT * L::SLOT);  // [n][p]
  float* cum = St + NM * PM;
  float* dts = cum + QT;
  float* wts = dts + QT;
  float* ecum = wts + QT;
  float* decay = ecum + QT;

  // warp w: column group gw (state rows p 32·gw ..), row half rw
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gw = warp >> 1, rw = warp & 1;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int pv = min(PG, a.P - PG * gw);          // valid columns of group
  const T* x = static_cast<const T*>(a.x) + b * a.sxb + h * a.sxh;
  const float* dt = a.dt + b * a.sdb + h * a.sdh;
  T* y = static_cast<T*>(a.y) + b * a.syb + h * a.syh + PG * gw;
  const unsigned char* scr =
      a.scratch + (int64_t)b * a.ntiles * L::TILE_BYTES;
  const float A = a.A[h];
  const int ni = (a.N + KS - 1) / KS;             // inter slabs of a tile

  // y tile: rows 64·rw + 8·rl .. + 7, columns 32·gw + 8·cb .. + 7.  State
  // tile of the group's 64 threads: rows p 32·gw + 8·pb .. + 7 (warp:
  // 16 of them), columns n state_col(nb, 0 .. 7).
  const int rl = lane >> 2, cb = lane & 3;
  const int pb = (tid & 63) >> 4, nb = tid & 15;
  const int row0 = 64 * rw + 8 * rl, col0 = PG * gw + 8 * cb;
  const int prow0 = PG * gw + 8 * pb;

  for (int e = tid; e < NM * PM; e += THREADS) St[e] = 0.f;

  const auto load_dt = [&](int k, float (&d)[4]) {
    const int t0 = k * a.tile, qv = tile_rows(a, k);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 4 * lane + e;
      d[e] = j < qv ? dt[(int64_t)(t0 + j) * a.sds] : 0.f;
    }
  };
  const auto slabs = [&](int k) { return (tile_rows(a, k) + KS - 1) / KS; };
  const auto steps = [&](int k) { return (k ? ni : 0) + 2 * slabs(k); };

  // Stage step t of tile k into a slot: the inter slabs (Ct rows), then
  // the score slabs (CBt rows from the diagonal on, x rows), then the
  // update slabs (Bf rows, x rows).
  const auto stage = [&](int k, int t, int slot) {
    unsigned char* dsl = ring + slot * L::SLOT;
    const uint32_t dst = hopper::smem_u32(dsl);
    const unsigned char* src = scr + (int64_t)k * L::TILE_BYTES;
    const int kni = k ? ni : 0;
    if (t < kni) {
      copy_slab<L::SLAB>(dst, src + L::OFF_CT + t * L::SLAB, tid);
      return;
    }
    const int u = t - kni, nj = slabs(k), qv = tile_rows(a, k);
    const int j0 = (u < nj ? u : u - nj) * KS;
    if (u < nj) {
      const unsigned char* cbt = src + j0 * QT * 4;
#pragma unroll
      for (int m = 0; m < L::SLAB / (16 * THREADS); ++m) {
        const int c = tid + m * THREADS;
        if ((c % (QT / 4)) >= j0 / 4)        // only columns i ≥ j0 are read
          hopper::cp_async16(dst + 16 * c, cbt + 16 * c, 16);
      }
    } else {
      copy_slab<L::SLAB>(dst, src + L::OFF_BF + j0 * NM * 4, tid);
    }
    const T* xs = x + (int64_t)(k * a.tile + j0) * a.sxs;
    if (a.vec_x) {
      constexpr int V = 16 / sizeof(T), W = PM / V;
#pragma unroll
      for (int c = tid; c < KS * W; c += THREADS) {
        const int jj = c / W, w = c % W;
        const bool ok = j0 + jj < qv && w * V < a.P;
        hopper::cp_async16(dst + L::OFF_X + 16 * c,
                           ok ? xs + (int64_t)jj * a.sxs + w * V : x,
                           ok ? 16 : 0);
      }
    } else {
      T* xd = reinterpret_cast<T*>(dsl + L::OFF_X);
      for (int e = tid; e < KS * PM; e += THREADS) {
        const int jj = e / PM, p = e % PM;
        if (j0 + jj < qv && p < a.P)
          xd[e] = xs[(int64_t)jj * a.sxs + p];
        else
          from_f32(xd + e, 0.f);
      }
    }
  };

  // The ring: step g is computed in slot g % NSLOT while steps g + 1 ..
  // g + NSLOT − 1 are in flight; one block barrier a step.
  int slot = 0, ik = 0, it = 0;          // (ik, it): the next step to stage
  const auto stage_next = [&](int into) {
    if (ik < a.ntiles) {
      stage(ik, it, into);
      if (++it == steps(ik)) {
        ++ik;
        it = 0;
      }
    }
    hopper::cp_async_commit();
  };
  const auto begin_step = [&]() {
    hopper::cp_async_wait<NSLOT - 2>();
    __syncthreads();           // this step landed; step g − 1 is consumed
    stage_next((slot + NSLOT - 1) % NSLOT);
    return ring + slot * L::SLOT;
  };

  float dnext[4];
  if (warp == 0) {
    float d[4];
    load_dt(0, d);
    scan_dt(d, A, lane, cum, dts, wts, ecum, decay);
    if (a.ntiles > 1) load_dt(1, dnext);
  }
  for (int d = 0; d < NSLOT - 1; ++d) stage_next(d);

  for (int k = 0; k < a.ntiles; ++k) {
    const int qv = tile_rows(a, k), nj = slabs(k);
    const bool rows = 64 * rw < qv;        // this warp has rows in the tile
    if (a.starts) {          // the state at the tile's start, for the backward
      // (St is complete: the last tile's update ended in a block barrier)
      float* so = a.starts + ((int64_t)bh * a.ntiles + k) * a.P * a.N;
      for (int e = tid; e < a.P * a.N; e += THREADS)
        so[e] = k ? St[st_idx(e % a.N, e / a.N)] : 0.f;
    }
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    // inter: acc[i][p] = Σ_n C[i][n]·state[p][n], then times exp(cum_i)
    for (int t = 0; k && t < ni; ++t) {
      const float* Ct = reinterpret_cast<const float*>(begin_step());
      if (rows) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          float av[8], bv[8];
          load8(Ct + kk * QT + row0, av);
          const int n = t * KS + kk;
          put4(bv, ld4(&St[st_idx(n, col0)]));
          put4(bv + 4, ld4(&St[st_idx(n, col0 + 4)]));
          fma8x8(acc, av, bv);
        }
      }
      slot = (slot + 1) % NSLOT;
    }
    if (k) {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float e = ecum[row0 + r];
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] *= e;
      }
    }

    // intra: the two warps of a row half turn its rows of CBt into the
    // scores (32 rows each), then acc[i][p] += Σ_j S[j][i]·x[j][p]
    for (int s = 0; s < nj; ++s) {
      unsigned char* sl = begin_step();
      float* S = reinterpret_cast<float*>(sl);
      // x as float32: bf16 widened once here, one 16-byte word a thread
      const float* xf = reinterpret_cast<const float*>(
          sl + (sizeof(T) == 2 ? L::OFF_XF : L::OFF_X));
      if (sizeof(T) == 2) {
#pragma unroll
        for (int c = tid; c < KS * PM / 8; c += THREADS) {
          float v[8];
          load8(reinterpret_cast<const T*>(sl + L::OFF_X) + 8 * c, v);
          store8(reinterpret_cast<float*>(sl + L::OFF_XF) + 8 * c, v);
        }
      }
      const int j0 = s * KS, i = 64 * rw + 32 * gw + lane;
      if (64 * rw + 32 * gw + 31 >= j0) {                // warp-uniform
        const float ci = cum[i];
#pragma unroll
        for (int jj = 0; jj < KS; ++jj) {
          const int j = j0 + jj;
          float& sc = S[jj * QT + i];
          // select before exp: above the diagonal exp may be inf
          sc = (j <= i && i < qv) ? sc * expf(ci - cum[j]) * dts[j] : 0.f;
        }
      } else {
#pragma unroll
        for (int jj = 0; jj < KS; ++jj) S[jj * QT + i] = 0.f;
      }
      if (sizeof(T) == 2)
        __syncthreads();       // every warp reads every row of x
      else                     // the row half's two warps (rw and 2 + rw)
        asm volatile("bar.sync %0, 64;\n" :: "r"(1 + rw) : "memory");
      if (rows && 64 * rw + 63 >= j0) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          float av[8], bv[8];
          load8(&S[kk * QT + row0], av);
          load8(xf + kk * PM + col0, bv);
          fma8x8(acc, av, bv);
        }
      }
      slot = (slot + 1) % NSLOT;
    }

    // y of the tile
    if (rows) {
      T* yt = y + (int64_t)k * a.tile * a.sys;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int row = row0 + r;
        if (row >= qv) continue;
        T* yr = yt + (int64_t)row * a.sys + 8 * cb;
        if (a.vec_y && 8 * cb + 8 <= pv) {
          store8(yr, acc[r]);
        } else {
#pragma unroll
          for (int c = 0; c < 8; ++c)
            if (8 * cb + c < pv) from_f32(yr + c, acc[r][c]);
        }
      }
    }

    // update: each warp turns its own 16 columns of x into x·w, then
    // upd[p][n] = Σ_j (x·w)[j][p]·B[j][n]
    float upd[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) upd[i][j] = 0.f;
    for (int s = 0; s < nj; ++s) {
      unsigned char* sl = begin_step();
      const float* Bf = reinterpret_cast<const float*>(sl);
      const T* xr = reinterpret_cast<const T*>(sl + L::OFF_X);
      float* xw = reinterpret_cast<float*>(sl + L::OFF_XF);
#pragma unroll
      for (int e = lane; e < KS * 16; e += 32) {
        const int jj = e >> 4, p = PG * gw + 16 * rw + (e & 15);
        xw[jj * PM + p] = to_f32(xr[jj * PM + p]) * wts[s * KS + jj];
      }
      __syncwarp();            // each warp reads only the columns it wrote
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        float av[8], bv[8];
        load8(&xw[kk * PM + prow0], av);
        put4(bv, ld4(Bf + kk * NM + 4 * nb));
        put4(bv + 4, ld4(Bf + kk * NM + NM / 2 + 4 * nb));
        fma8x8(upd, av, bv);
      }
      slot = (slot + 1) % NSLOT;
    }

    // state ← exp(cum_last)·state + upd (no thread reads St until the
    // next tile's first barrier)
    const float dec = *decay;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int n = state_col(nb, e);
      float4* p0 = reinterpret_cast<float4*>(&St[st_idx(n, prow0)]);
      float4* p1 = reinterpret_cast<float4*>(&St[st_idx(n, prow0 + 4)]);
      float4 s0 = *p0, s1 = *p1;
      s0.x = dec * s0.x + upd[0][e];
      s0.y = dec * s0.y + upd[1][e];
      s0.z = dec * s0.z + upd[2][e];
      s0.w = dec * s0.w + upd[3][e];
      s1.x = dec * s1.x + upd[4][e];
      s1.y = dec * s1.y + upd[5][e];
      s1.z = dec * s1.z + upd[6][e];
      s1.w = dec * s1.w + upd[7][e];
      *p0 = s0;
      *p1 = s1;
    }
    __syncthreads();           // every warp is done with the tile's scalars
    if (warp == 0 && k + 1 < a.ntiles) {
      scan_dt(dnext, A, lane, cum, dts, wts, ecum, decay);
      if (k + 2 < a.ntiles) load_dt(k + 2, dnext);
    }
  }

  float* so = a.state + (int64_t)bh * a.P * a.N;   // (B, H, P, N)
  for (int e = tid; e < PM * NM; e += THREADS) {
    const int p = e / NM, n = e % NM;
    if (p < a.P && n < a.N) so[(int64_t)p * a.N + n] = St[st_idx(n, p)];
  }
}

bool aligned(const void* p, int elt, std::initializer_list<long long> strides) {
  if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  for (const long long s : strides)
    if ((s * elt) % 16) return false;
  return true;
}

// The opt-in above 48 KB of shared memory holds per function and device,
// so each template instance asks once per device (a repeat is harmless).
constexpr int MAX_DEVICES = 64;

// A kernel's dynamic shared memory above the 48 KB default, and the
// largest carveout (the scan's MIN_BLOCKS blocks an SM need all 228 KB):
// asked once per kernel and device.
template <typename T, bool PREP>
cudaError_t opt_in() {
  static std::atomic<bool> opted_in[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < MAX_DEVICES && opted_in[dev].load()))
    return e;
  const void* kern =
      PREP ? reinterpret_cast<const void*>(ssd_scan_prep_kernel<T>)
           : reinterpret_cast<const void*>(ssd_scan_kernel<T>);
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           PREP ? PREP_SMEM : Layout<T>::SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && dev < MAX_DEVICES) opted_in[dev].store(true);
  return e;
}

template <typename T>
int launch_scan(const Args& a, int batch, cudaStream_t stream) {
  const cudaError_t e = opt_in<T, false>();
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_scan_kernel<T><<<batch * a.H, THREADS, Layout<T>::SMEM, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int blocks_per_sm() {
  int n = 0;
  if (opt_in<T, false>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, ssd_scan_kernel<T>, THREADS, Layout<T>::SMEM) != cudaSuccess)
    return -1;
  return n;
}

template <typename T>
int launch_prep(const Args& a, int batch, cudaStream_t stream) {
  const cudaError_t e = opt_in<T, true>();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(QT / PREP_ROWS, a.ntiles, batch);
  ssd_scan_prep_kernel<T><<<grid, PREP_THREADS, PREP_SMEM, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int launch_prep(const Args& a, int batch, bool bf16, cudaStream_t stream) {
  return bf16 ? launch_prep<__nv_bfloat16>(a, batch, stream)
              : launch_prep<float>(a, batch, stream);
}


// ---------------------------------------------------------------------------
// Backward: ssd_scan_bwd.  It replaces no TPU kernel: the TPU kernel has no
// VJP, and the reference trains through XLA's autodiff of the plain chunked
// algorithm (repro/models/mamba2.py:90 ssd_chunked).  From dy, the
// gradient of the final state dS (or zero) and the forward's tile-start
// states S0, per chunk with L_ij = exp(cum_i − cum_j) (i ≥ j), M = C·Bᵀ∘L:
//
//   g_j   = Σ_{i≥j} M_ij dy_i + exp(cum_last − cum_j)·dS B_j
//   dx_j  = dt_j g_j;  ddt_j = x_j·g_j + A·da_j,  da = reverse-cumsum(∂/∂cum)
//   dC_i  = Σ_j (dP∘L)_ij B_j + exp(cum_i) S0ᵀ dy_i,  dP_ij = dt_j dy_i·x_j
//   dB_j  = Σ_i (dP∘L)_ij C_i + dt_j exp(cum_last − cum_j) dSᵀ x_j
//   dA    = Σ da·dt;  dS ← exp(cum_last)·dS + Σ_i exp(cum_i) dy_i ⊗ C_i
//
// What bounds it: float32 operations, 27.1 GFLOP at the mixer shape (2× the
// forward: two triangle products and four (q × P)·(P × N) products a head
// and chunk, and the head-summed (dP∘L)·B, ·C and C·Bᵀ a chunk): 0.40 ms.
// Three launches: the forward's prep (C·Bᵀ, C and B widened, per (batch,
// tile)); ssd_scan_bwd_kernel, one 256-thread block per (batch, head)
// walking the tiles in reverse with dS in shared memory, so nothing is
// scanned again; ssd_scan_bwd_reduce_kernel, which adds the heads' partials
// (the head's dP∘L tile and its inter and state terms of dB and dC) and the
// batches' dA in a fixed order: no atomics, two calls give the same bits.
// This first design is simple: scalar shared loads from odd-pitch rows
// (conflict-free whichever axis is a product's row), full squares where the
// forward skips the masked triangle, one 211 KB block an SM, and 1 GB of
// partials at the mixer shape.  Tensor cores are excluded, as above.
// ---------------------------------------------------------------------------

constexpr int BT = 256;            // threads of the backward kernels
constexpr int XP = PM + 1;         // pitch of x, dy rows [position][p]
constexpr int SP = NM + 1;         // pitch of state rows [p][n]
constexpr int MP = QT + 1;         // pitch of M rows [j][i] (and C rows)
constexpr int RROWS = 32;          // rows of a reduce block
// bytes of the scan's shared memory: x, dy, M (later C), dS, S0, the
// row partials, nine per-position arrays and ten block slots
constexpr int BWD_SMEM =
    (2 * QT * XP + QT * MP + 2 * PM * SP + 16 * QT + 9 * QT + 10) * 4;
constexpr int RED_SMEM = (2 * RROWS * MP + QT * SP) * 4;
static_assert(BWD_SMEM <= 227 * 1024, "backward shared memory");

struct BwdArgs {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  const void* dy;
  const float* dstate;     // (B, H, P, N) float32, or null (zero)
  const float* starts;     // (B, H, ntiles, P, N) float32
  const unsigned char* scratch;   // the prep's (B, ntiles, 3, QT, NM)
  void* dx;
  float* ddt;
  float* dA;
  void* dB;                // (B, S, N) contiguous, x's dtype
  void* dC;
  float* dcb;              // (B, H, ntiles, QT, QT): per head (dP∘L)[j][i]
  float* dcp;              // (B, H, ntiles, QT, NM): per head dC inter part
  float* dbp;              // (B, H, ntiles, QT, NM): per head dB state part
  float* dap;              // (B, H): per (batch, head) Σ da·dt
  int H, S, P, N, tile, ntiles;
  int64_t sxb, sxh, sxs;   // x
  int64_t sdb, sdh, sds;   // dt
  int64_t scb, scs;        // C
  int64_t syb, syh, sys;   // dy
  int64_t sgb, sgh, sgs;   // dx
  int64_t stb, sth, sts;   // ddt
};

// Sum of v over the 16 lanes of a half warp (the lanes of one mg); the
// half's lane 0 holds the sum in a fixed order.
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// One block of 256 threads per (batch, head), the tiles in reverse, the
// gradient of the state at the tile's end (dS) carried in shared memory.
// Thread (mg, ng) = (tid / 16, tid % 16) owns rows mg + 16r and columns
// ng + 16c of each product: odd pitches keep every shared read of a warp
// on distinct banks (or one broadcast word) whichever axis is the row.
template <typename T>
__global__ void __launch_bounds__(BT, 1) ssd_scan_bwd_kernel(BwdArgs a) {
  using L = Layout<T>;
  extern __shared__ __align__(16) float bsm[];
  float* xs = bsm;                          // x[j][p]
  float* dys = xs + QT * XP;                // dy[i][p]
  float* Mt = dys + QT * XP;                // M[i][j] at [j][i]; then C'[i][n]
  float* dSs = Mt + QT * MP;                // dS[p][n]
  float* S0s = dSs + PM * SP;               // S0[p][n]
  float* rowpart = S0s + PM * SP;           // [mg][i]
  float* cum = rowpart + 16 * QT;
  float* dts = cum + QT;
  float* wts = dts + QT;                    // dt_j·exp(cum_last − cum_j)
  float* ecum = wts + QT;                   // exp(cum_i)
  float* dte = ecum + QT;                   // exp(cum_last − cum_j)
  float* dcum = dte + QT;                   // intra terms of ∂/∂cum
  float* dci = dcum + QT;                   // inter term
  float* sj = dci + QT;                     // state terms, per j
  float* xg = sj + QT;                      // x_j·g_j
  float* red = xg + QT;                     // [0, 8) warp sums, [8]
                                            // exp(cum_last), [9] ⟨dS, S0⟩

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mg = tid >> 4, ng = tid & 15;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const T* x = static_cast<const T*>(a.x) + b * a.sxb + h * a.sxh;
  const T* dy = static_cast<const T*>(a.dy) + b * a.syb + h * a.syh;
  const float* dt = a.dt + b * a.sdb + h * a.sdh;
  const T* Cg = static_cast<const T*>(a.C) + b * a.scb;
  T* dx = static_cast<T*>(a.dx) + b * a.sgb + h * a.sgh;
  float* ddt = a.ddt + b * a.stb + h * a.sth;
  const float A = a.A[h];

  for (int e = tid; e < PM * SP; e += BT) {
    const int p = e / SP, n = e % SP;
    dSs[e] = (a.dstate && p < a.P && n < a.N)
                 ? a.dstate[((int64_t)bh * a.P + p) * a.N + n]
                 : 0.f;
  }
  float dA_acc = 0.f;                       // warp 0: Σ da·dt, this lane's

  for (int k = a.ntiles - 1; k >= 0; --k) {
    const int t0 = k * a.tile, qv = min(a.tile, a.S - t0);
    const float* tscr = reinterpret_cast<const float*>(
        a.scratch + ((int64_t)b * a.ntiles + k) * L::TILE_BYTES);
    const float* CBt = tscr;                             // [j][i]
    const float* Bf = tscr + L::OFF_BF / 4;              // [j][n]
    const int64_t tb = ((int64_t)bh * a.ntiles + k);

    // stage x, dy (widened, zero past the tile and past P) and S0
    for (int e = tid; e < QT * PM; e += BT) {
      const int j = e / PM, p = e % PM;
      const bool ok = j < qv && p < a.P;
      xs[j * XP + p] = ok ? to_f32(x[(int64_t)(t0 + j) * a.sxs + p]) : 0.f;
      dys[j * XP + p] = ok ? to_f32(dy[(int64_t)(t0 + j) * a.sys + p]) : 0.f;
    }
    const float* s0 = a.starts + tb * a.P * a.N;
    for (int e = tid; e < PM * NM; e += BT) {
      const int p = e / NM, n = e % NM;
      S0s[p * SP + n] = (p < a.P && n < a.N) ? s0[p * a.N + n] : 0.f;
    }
    if (warp == 0) {                        // the forward's log-decays
      float d[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * lane + e;
        d[e] = j < qv ? dt[(int64_t)(t0 + j) * a.sds] : 0.f;
      }
      scan_dt(d, A, lane, cum, dts, wts, ecum, red + 8);
      __syncwarp();
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dte[4 * lane + e] = expf(cum[QT - 1] - cum[4 * lane + e]);
    }
    __syncthreads();

    // dP[j][i] = dt_j·(x_j·dy_i); M = C·Bᵀ∘L; the per-head (dP∘L) out;
    // t = dP∘M summed along both axes: ∂/∂cum_i += Σ_j t, ∂/∂cum_j −= Σ_i t
    {
      float acc[8][8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
#pragma unroll 4
      for (int p = 0; p < PM; ++p) {
        float av[8], bv[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) av[r] = xs[(mg + 16 * r) * XP + p];
#pragma unroll
        for (int c = 0; c < 8; ++c) bv[c] = dys[(ng + 16 * c) * XP + p];
        fma8x8(acc, av, bv);
      }
      float* dcb = a.dcb + tb * QT * QT;
      float rows[8], cols[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) rows[c] = 0.f;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int j = mg + 16 * r;
        const float cj = cum[j], dj = dts[j];
        cols[r] = 0.f;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int i = ng + 16 * c;
          const bool ok = j <= i && i < qv;
          // select before exp: above the diagonal exp may be inf
          const float l = ok ? expf(cum[i] - cj) : 0.f;
          const float m = CBt[j * QT + i] * l;
          const float dp = acc[r][c] * dj;
          Mt[j * MP + i] = m;
          dcb[j * QT + i] = dp * l;
          const float t = dp * m;
          rows[c] += t;
          cols[r] += t;
        }
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float v = half_warp_sum(cols[r]);
        if (ng == 0) dcum[mg + 16 * r] = -v;
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) rowpart[mg * QT + ng + 16 * c] = rows[c];
    }
    __syncthreads();
    if (tid < QT) {
      float s = 0.f;
      for (int m = 0; m < 16; ++m) s += rowpart[m * QT + tid];
      dcum[tid] += s;
    }

    // g[j][p] = Σ_i M[i][j] dy[i][p] + exp(cum_last − cum_j) Σ_n B[j][n]
    // dS[p][n];  dx = dt·g, x·g
    {
      float acc[8][4], st[8][4];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = st[r][c] = 0.f;
#pragma unroll 4
      for (int i = 0; i < QT; ++i) {
        float av[8], bv[4];
#pragma unroll
        for (int r = 0; r < 8; ++r) av[r] = Mt[(mg + 16 * r) * MP + i];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = dys[i * XP + ng + 16 * c];
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
      }
      for (int n = 0; n < NM; n += 4) {
        float4 bv4[8];
#pragma unroll
        for (int r = 0; r < 8; ++r)
          bv4[r] = ld4(Bf + (mg + 16 * r) * NM + n);
#pragma unroll
        for (int nn = 0; nn < 4; ++nn) {
          float dv[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) dv[c] = dSs[(ng + 16 * c) * SP + n + nn];
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const float bb = nn == 0 ? bv4[r].x : nn == 1 ? bv4[r].y
                           : nn == 2 ? bv4[r].z : bv4[r].w;
#pragma unroll
            for (int c = 0; c < 4; ++c) st[r][c] = fmaf(bb, dv[c], st[r][c]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int j = mg + 16 * r;
        const float dj = dts[j], ej = dte[j];
        float part = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int p = ng + 16 * c;
          const float g = acc[r][c] + ej * st[r][c];
          if (j < qv && p < a.P)
            from_f32(dx + (int64_t)(t0 + j) * a.sgs + p, dj * g);
          part = fmaf(xs[j * XP + p], g, part);
        }
        part = half_warp_sum(part);
        if (ng == 0) xg[j] = part;
      }
    }

    // dC inter part [i][n] = exp(cum_i) Σ_p dy[i][p] S0[p][n], and its
    // ∂/∂cum_i = Σ_n (that)·C[i][n]
    {
      float acc[8][8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
#pragma unroll 4
      for (int p = 0; p < PM; ++p) {
        float av[8], bv[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) av[r] = dys[(mg + 16 * r) * XP + p];
#pragma unroll
        for (int c = 0; c < 8; ++c) bv[c] = S0s[p * SP + ng + 16 * c];
        fma8x8(acc, av, bv);
      }
      float* dcp = a.dcp + tb * QT * NM;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = mg + 16 * r;
        const float ei = ecum[i];
        float part = 0.f;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int n = ng + 16 * c;
          const float v = ei * acc[r][c];
          dcp[i * NM + n] = v;
          if (i < qv && n < a.N)
            part = fmaf(v, to_f32(Cg[(int64_t)(t0 + i) * a.scs + n]), part);
        }
        part = half_warp_sum(part);
        if (ng == 0) dci[i] = part;
      }
    }

    // dB state part [j][n] = dt_j exp(cum_last − cum_j) Σ_p x[j][p] dS[p][n],
    // and its Σ_n (that)·B[j][n]
    {
      float acc[8][8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
#pragma unroll 4
      for (int p = 0; p < PM; ++p) {
        float av[8], bv[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) av[r] = xs[(mg + 16 * r) * XP + p];
#pragma unroll
        for (int c = 0; c < 8; ++c) bv[c] = dSs[p * SP + ng + 16 * c];
        fma8x8(acc, av, bv);
      }
      float* dbp = a.dbp + tb * QT * NM;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int j = mg + 16 * r;
        const float wj = wts[j];
        float part = 0.f;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int n = ng + 16 * c;
          const float v = wj * acc[r][c];
          dbp[j * NM + n] = v;
          part = fmaf(v, Bf[j * NM + n], part);
        }
        part = half_warp_sum(part);
        if (ng == 0) sj[j] = part;
      }
    }

    // ⟨dS, S0⟩ (the state term's ∂/∂cum_last, times exp(cum_last))
    {
      float s = 0.f;
      for (int e = tid; e < PM * NM; e += BT) {
        const int p = e / NM, n = e % NM;
        s = fmaf(dSs[p * SP + n], S0s[p * SP + n], s);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
      if (lane == 0) red[warp] = s;
    }
    __syncthreads();

    // C'[i][n] = exp(cum_i)·C[i][n] over M (done with M)
    float* Cp = Mt;
    for (int e = tid; e < QT * NM; e += BT) {
      const int i = e / NM, n = e % NM;
      Cp[i * MP + n] = (i < qv && n < a.N)
                           ? ecum[i] * to_f32(Cg[(int64_t)(t0 + i) * a.scs + n])
                           : 0.f;
    }
    if (tid == 0) {
      float s = 0.f;
      for (int w = 0; w < BT / 32; ++w) s += red[w];
      red[9] = s;
    }
    __syncthreads();

    // the carry: dS ← exp(cum_last)·dS + Σ_i dy[i][p] C'[i][n]
    {
      float acc[4][8];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
#pragma unroll 4
      for (int i = 0; i < QT; ++i) {
        float av[4], bv[8];
#pragma unroll
        for (int r = 0; r < 4; ++r) av[r] = dys[i * XP + mg + 16 * r];
#pragma unroll
        for (int c = 0; c < 8; ++c) bv[c] = Cp[i * MP + ng + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
      }
      const float dec = red[8];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          float* s = &dSs[(mg + 16 * r) * SP + ng + 16 * c];
          *s = fmaf(dec, *s, acc[r][c]);
        }
    }

    // warp 0: ∂/∂cum → da (reverse cumulative sum) → ddt, dA
    if (warp == 0) {
      float ts = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) ts += sj[4 * lane + e];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ts += __shfl_xor_sync(FULL, ts, off);
      ts = __shfl_sync(FULL, ts, 0);
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * lane + e;
        v[e] = dcum[j] + dci[j] - sj[j];
        if (j == qv - 1) v[e] += ts + red[8] * red[9];
      }
      v[2] += v[3];
      v[1] += v[2];
      v[0] += v[1];
      float tot = v[0];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_down_sync(FULL, tot, off);
        if (lane + off < 32) tot += t;
      }
      const float after = __shfl_down_sync(FULL, tot, 1);
      const float excl = lane == 31 ? 0.f : after;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * lane + e;
        const float da = v[e] + excl;
        if (j < qv) ddt[(int64_t)(t0 + j) * a.sts] = fmaf(da, A, xg[j]);
        dA_acc = fmaf(da, dts[j], dA_acc);
      }
    }
    __syncthreads();
  }
  if (warp == 0) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      dA_acc += __shfl_xor_sync(FULL, dA_acc, off);
    if (lane == 0) a.dap[bh] = dA_acc;
  }
}

// Block (quarter, tile, batch): rows i0 = 32·quarter .. + 31 of the tile.
// Sums the heads' parts in head order, then
//   dC[i][n] = Σ_h dcp + Σ_j (Σ_h dcb[j][i]) B[j][n]
//   dB[j][n] = Σ_h dbp + Σ_i (Σ_h dcb[j][i]) C[i][n]
// and block (0, 0, 0) adds dA[h] = Σ_b dap[b][h] in batch order.
template <typename T>
__global__ void __launch_bounds__(BT) ssd_scan_bwd_reduce_kernel(BwdArgs a) {
  using L = Layout<T>;
  extern __shared__ __align__(16) float rsm[];
  float* R1 = rsm;                   // [ii][j] = Σ_h dcb[j][i0 + ii]
  float* R2 = R1 + RROWS * MP;       // [jj][i] = Σ_h dcb[i0 + jj][i]
  float* Cs = R2 + RROWS * MP;       // C[i][n], widened
  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * RROWS, k = blockIdx.y, b = blockIdx.z;
  const int t0 = k * a.tile, qv = min(a.tile, a.S - t0);
  const int64_t tile_q = (int64_t)QT * QT, tile_n = (int64_t)QT * NM;
  const int64_t hstep = (int64_t)a.ntiles;           // tiles between heads
  const int64_t first = (int64_t)b * a.H * a.ntiles + k;   // (b, 0, k)
  const T* Cg = static_cast<const T*>(a.C) + b * a.scb;
  const float* Bf = reinterpret_cast<const float*>(
                        a.scratch + ((int64_t)b * a.ntiles + k) *
                                        L::TILE_BYTES) + L::OFF_BF / 4;

  for (int e = tid; e < RROWS * QT; e += BT) {
    const int ii = e % RROWS, j = e / RROWS;    // R1: 32 consecutive i
    const int jj = e / QT, i = e % QT;          // R2: a row of 128 i
    float s1 = 0.f, s2 = 0.f;
    for (int hh = 0; hh < a.H; ++hh) {
      const float* d = a.dcb + (first + hh * hstep) * tile_q;
      s1 += d[j * QT + i0 + ii];
      s2 += d[(i0 + jj) * QT + i];
    }
    R1[ii * MP + j] = s1;
    R2[jj * MP + i] = s2;
  }
  for (int e = tid; e < QT * NM; e += BT) {
    const int i = e / NM, n = e % NM;
    Cs[i * SP + n] = (i < qv && n < a.N)
                         ? to_f32(Cg[(int64_t)(t0 + i) * a.scs + n])
                         : 0.f;
  }
  __syncthreads();

  // thread: column n, rows rr = tid / NM + 2u
  const int n = tid % NM, r0 = tid / NM;
  constexpr int RU = RROWS / (BT / NM);
  float dc[RU], db[RU];
#pragma unroll
  for (int u = 0; u < RU; ++u) {
    const int row = i0 + r0 + 2 * u;
    float s1 = 0.f, s2 = 0.f;
    for (int hh = 0; hh < a.H; ++hh) {
      const int64_t off = (first + hh * hstep) * tile_n + row * NM + n;
      s1 += a.dcp[off];
      s2 += a.dbp[off];
    }
    dc[u] = s1;
    db[u] = s2;
  }
  for (int j = 0; j < QT; ++j) {
    const float bj = Bf[j * NM + n], cj = Cs[j * SP + n];
#pragma unroll
    for (int u = 0; u < RU; ++u) {
      dc[u] = fmaf(R1[(r0 + 2 * u) * MP + j], bj, dc[u]);
      db[u] = fmaf(R2[(r0 + 2 * u) * MP + j], cj, db[u]);
    }
  }
  T* dC = static_cast<T*>(a.dC) + ((int64_t)b * a.S + t0) * a.N;
  T* dB = static_cast<T*>(a.dB) + ((int64_t)b * a.S + t0) * a.N;
#pragma unroll
  for (int u = 0; u < RU; ++u) {
    const int row = i0 + r0 + 2 * u;
    if (row < qv && n < a.N) {
      from_f32(dC + (int64_t)row * a.N + n, dc[u]);
      from_f32(dB + (int64_t)row * a.N + n, db[u]);
    }
  }
  if (blockIdx.x == 0 && k == 0 && b == 0) {
    for (int hh = tid; hh < a.H; hh += BT) {
      float s = 0.f;
      for (int bb = 0; bb < (int)gridDim.z; ++bb) s += a.dap[bb * a.H + hh];
      a.dA[hh] = s;
    }
  }
}

// Dynamic shared memory above 48 KB, asked once per kernel and device.
template <int ID>
cudaError_t opt_in_kernel(const void* kern, int bytes) {
  static std::atomic<bool> opted_in[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < MAX_DEVICES && opted_in[dev].load()))
    return e;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && dev < MAX_DEVICES) opted_in[dev].store(true);
  return e;
}

template <typename T, int ID>
int launch_bwd(const BwdArgs& a, int batch, cudaStream_t stream) {
  cudaError_t e = opt_in_kernel<ID>(
      reinterpret_cast<const void*>(ssd_scan_bwd_kernel<T>), BWD_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_scan_bwd_kernel<T><<<batch * a.H, BT, BWD_SMEM, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = opt_in_kernel<ID + 1>(
      reinterpret_cast<const void*>(ssd_scan_bwd_reduce_kernel<T>),
      RED_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(QT / RROWS, a.ntiles, batch);
  ssd_scan_bwd_reduce_kernel<T><<<grid, BT, RED_SMEM, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Blocks of the scan kernel an SM holds at once on the current device
// (float32 or bf16 inputs), or -1 if the query fails.
extern "C" int ssd_scan_blocks_per_sm(int bf16) {
  return bf16 ? blocks_per_sm<__nv_bfloat16>() : blocks_per_sm<float>();
}

// x, y: (B, H, S, P); dt: (B, H, S) float32; A: (H,) float32 contiguous;
// B, C: (B, S, N); each by element strides with a contiguous last axis
// (y by its own strides; dt's position stride may be anything).  x, B, C
// and y all float32 (bf16 = 0) or all bf16 (bf16 = 1).  state: (B, H, P,
// N) float32 contiguous.  starts: null, or (B, H, ceil(S / tile), P, N)
// float32 contiguous, which receives the state at the start of each tile
// (what the backward reads).  scratch: (B, ceil(S / tile), 3, 128, 128)
// float32 contiguous, overwritten.  P ≤ 64,
// N ≤ 128, 1 ≤ tile ≤ 128: the scan walks S in tiles of `tile` positions
// (a last partial tile is masked).  Launches the prep and the scan kernels
// on `stream`, allocates nothing, returns the CUDA error code (0 on
// success).
extern "C" int ssd_scan(const void* x, const float* dt, const float* A,
                        const void* B, const void* C, void* y, float* state,
                        float* starts, void* scratch, int bf16, int batch,
                        int H, int S,
                        int P, int N, int tile, long long sxb, long long sxh,
                        long long sxs, long long sdb, long long sdh,
                        long long sds, long long sbb, long long sbs,
                        long long scb, long long scs, long long syb,
                        long long syh, long long sys, void* stream) {
  if (batch == 0 || H == 0) return 0;
  if (P < 1 || P > PM || N < 1 || N > NM || tile < 1 || tile > QT || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int elt = bf16 ? 2 : 4;
  const int ntiles = (S + tile - 1) / tile;
  const int vec_x = P % (16 / elt) == 0 && aligned(x, elt, {sxb, sxh, sxs});
  const int vec_y = aligned(y, elt, {syb, syh, sys});
  const int vec_bc = N % (16 / elt) == 0 && aligned(B, elt, {sbb, sbs}) &&
                     aligned(C, elt, {scb, scs});
  const Args a{x,   dt,  A,   B,   C,   y,   state, starts,
               static_cast<unsigned char*>(scratch),
               H,   S,   P,   N,   tile, ntiles, vec_x, vec_y, vec_bc,
               sxb, sxh, sxs, sdb, sdh, sds, sbb, sbs, scb, scs, syb, syh,
               sys};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc = launch_prep(a, batch, bf16, st);
  if (rc != 0) return rc;
  return bf16 ? launch_scan<__nv_bfloat16>(a, batch, st)
              : launch_scan<float>(a, batch, st);
}

// The prep kernel alone (for its check against its plain version): B, C
// and scratch as above.
extern "C" int ssd_scan_prep(const void* B, const void* C, void* scratch,
                             int bf16, int batch, int S, int N, int tile,
                             long long sbb, long long sbs, long long scb,
                             long long scs, void* stream) {
  if (batch == 0) return 0;
  if (N < 1 || N > NM || tile < 1 || tile > QT || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.B = B;
  a.C = C;
  a.scratch = static_cast<unsigned char*>(scratch);
  a.S = S;
  a.N = N;
  a.tile = tile;
  a.ntiles = (S + tile - 1) / tile;
  a.sbb = sbb;
  a.sbs = sbs;
  a.scb = scb;
  a.scs = scs;
  const int elt = bf16 ? 2 : 4;
  a.vec_bc = N % (16 / elt) == 0 && aligned(B, elt, {sbb, sbs}) &&
             aligned(C, elt, {scb, scs});
  return launch_prep(a, batch, bf16, static_cast<cudaStream_t>(stream));
}

// Backward of ssd_scan from dy (and d_state, or null for zero): x, dt, A,
// B, C as the forward took them, dy and dx by (batch, head, position)
// strides with a contiguous last axis, ddt by its three strides; starts
// the forward's tile-start states (B, H, ceil(S / tile), P, N).  Writes
// dx (x's dtype), ddt (float32), dA (H,) float32, dB and dC ((B, S, N)
// contiguous, x's dtype).  scratch as the forward's; dcb (B, H, tiles,
// 128, 128), dcp and dbp (B, H, tiles, 128, 128) and dap (B, H), all
// float32, are overwritten.  Three launches on `stream` (the prep, the
// scan in reverse, the head and batch sums); returns the CUDA error code.
extern "C" int ssd_scan_bwd(
    const void* x, const float* dt, const float* A, const void* B,
    const void* C, const void* dy, const float* dstate, const float* starts,
    void* dx, float* ddt, float* dA, void* dB, void* dC, void* scratch,
    float* dcb, float* dcp, float* dbp, float* dap, int bf16, int batch,
    int H, int S, int P, int N, int tile, long long sxb, long long sxh,
    long long sxs, long long sdb, long long sdh, long long sds,
    long long sbb, long long sbs, long long scb, long long scs,
    long long syb, long long syh, long long sys, long long sgb,
    long long sgh, long long sgs, long long stb, long long sth,
    long long sts, void* stream) {
  if (batch == 0 || H == 0) return 0;
  if (P < 1 || P > PM || N < 1 || N > NM || tile < 1 || tile > QT || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int elt = bf16 ? 2 : 4;
  const int ntiles = (S + tile - 1) / tile;
  Args pa{};
  pa.B = B;
  pa.C = C;
  pa.scratch = static_cast<unsigned char*>(scratch);
  pa.S = S;
  pa.N = N;
  pa.tile = tile;
  pa.ntiles = ntiles;
  pa.sbb = sbb;
  pa.sbs = sbs;
  pa.scb = scb;
  pa.scs = scs;
  pa.vec_bc = N % (16 / elt) == 0 && aligned(B, elt, {sbb, sbs}) &&
              aligned(C, elt, {scb, scs});
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = launch_prep(pa, batch, bf16, st);
  if (rc != 0) return rc;
  const BwdArgs a{x,   dt,  A,   B,   C,   dy,  dstate, starts,
                  static_cast<const unsigned char*>(scratch),
                  dx,  ddt, dA,  dB,  dC,  dcb, dcp, dbp, dap,
                  H,   S,   P,   N,   tile, ntiles,
                  sxb, sxh, sxs, sdb, sdh, sds, scb, scs, syb, syh, sys,
                  sgb, sgh, sgs, stb, sth, sts};
  return bf16 ? launch_bwd<__nv_bfloat16, 10>(a, batch, st)
              : launch_bwd<float, 20>(a, batch, st);
}
