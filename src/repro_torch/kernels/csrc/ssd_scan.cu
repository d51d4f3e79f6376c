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
// gradient of the final state (or zero) and the forward's tile-start
// states S0, per (batch, head, tile) with L_ij = exp(cum_i − cum_j) (i ≥ j),
// M = C·Bᵀ∘L, G_ji = x_j·dy_i and dS the gradient of the tile's end state:
//
//   g_j   = Σ_{i≥j} M_ij dy_i + exp(cum_last − cum_j)·dS B_j;  dx_j = dt_j g_j
//   dC_i  = Σ_h Σ_j (dt_j G_ji L_ij) B_j + Σ_h exp(cum_i) S0ᵀ dy_i
//   dB_j  = Σ_h Σ_i (dt_j G_ji L_ij) C_i + Σ_h dt_j exp(cum_last − cum_j) dSᵀ x_j
//   ∂/∂cum_m = R_m − dt_m (Q'_m + s'_m) + dci_m  (+ the end terms at the last
//   position), R_i = Σ_j dt_j G_ji M_ij, Q'_j = Σ_i G_ji M_ij, s'_j = x_j·(state
//   term of g_j), dci_i = C_i·(dC inter part)_i;  da = reverse-cumsum;
//   ddt_j = x_j·g_j + A·da_j with x_j·g_j = Q'_j + s'_j;  dA = Σ da·dt
//   dS at the end of tile k−1 = exp(cum_last,k)·dS_k + Σ_i exp(cum_i) dy_i ⊗ C_i
//
// What bounds it: float32 operations, 27.1 GFLOP at the mixer shape (4 × 80
// heads, S 1024, P 64, N 128, chunk 128; per (batch, head, tile) the two
// triangle products and four (q × P)·(P × N) products, per (batch, tile)
// C·Bᵀ and the head-summed products): 0.40 ms.  Tensor cores are excluded,
// as above: every product but x·dyᵀ has a float32 operand.
//
// The only sequential dependency is the carry of dS, so it is computed first,
// and every (batch, tile, head) is then independent.  Five launches:
//  1. the forward's prep (C·Bᵀ, C transposed and B, per (batch, tile));
//  2. ssd_scan_bwd_states_kernel, one block per (head, tile ≥ 1, batch):
//     U_k = Σ_i exp(cum_i) dy_i ⊗ C_i of its tile (4.7 GFLOP at the mixer
//     shape; tile 0's is not needed) into the slot of tile k − 1, and
//     exp(cum_last) of the tile;
//  3. ssd_scan_bwd_carry_kernel: per (batch, head) and state element the
//     reverse walk dS_end[k − 1] = exp(cum_last,k)·dS_end[k] + U_k over the
//     8 tiles, in place: the end-of-tile state gradients (B, H, tiles, P, N);
//  4. ssd_scan_bwd_main_kernel, blocks of four roles over one grid: per
//     (batch, tile, group of HG heads) three blocks that loop over the
//     group's heads and keep the group's sum of one head-summed term in
//     shared memory — Σ_h dt_j G L [j][i] (and per head R, Q'), Σ_h dC inter
//     [i][n] (and per head dci), Σ_h dB state [j][n] (and per head s') — and
//     per (batch, tile, head) one block for g: the state term, then the
//     triangle term, dx, and exp(cum_last)·⟨dS, S0⟩;
//  5. ssd_scan_bwd_sums_kernel: per (batch, tile, 16 rows) the groups' sums
//     in group order, then dC = Σ dC inter + (Σ dt G L)·B and dB = Σ dB state
//     + (Σ dt G L)ᵀ·C; per head ∂/∂cum, its reverse cumulative sum, ddt, and
//     dA over batches and tiles in a fixed order.
// No atomics: every sum runs in a fixed order, so two calls give the same
// bits.
//
// Every product is the forward's register tile: 8 × 8 a thread, a warp 32
// rows × 64 columns, both operands staged k-major in shared memory (a copy
// transposed where the product contracts along the other axis: x and dy per
// head, B and C·Bᵀ∘L from the prep's scratch, dS), two 16-byte loads of each
// operand per 64 FFMA, conflict-free (a quarter warp reads one broadcast
// word of the row operand and 8 distinct words of the other).  The masked
// triangle is skipped by warps: the G L blocks' warps whose columns lie wholly
// above their rows do nothing, and the triangle term of g starts its sum over
// i at the warp's first row.  The g and states blocks split the sum over k
// between two halves of the block (even and odd slabs) and add the halves
// once, in order.  C and B come widened from the scratch, never from the
// inputs.  The head-summed terms leave the chip once per group of HG heads
// (5 groups at the mixer shape), not once per head.
//
// Budget (bf16 and float32 alike): 98.6 KB of dynamic shared memory a block
// in launches 2 and 4 (the group blocks: the sum 64 KB + half of P of each
// operand 32 KB; the g and states blocks: two operands, 96 KB), 16.1 KB in
// launch 5; at most 128 registers a thread (__launch_bounds__(256, 2); the
// main kernel spills ~200 bytes): 2 blocks, 16 warps an SM.  At the mixer
// shape the main launch has 3 × 4 × 8 × 5 = 480 group blocks (16 heads
// each) before 2,560 g blocks, so the last blocks to run are the short
// ones; the states launch has 2,240 blocks, the carry 10,240 short ones.
// Head partials: 3 × 64 KB per (batch, tile, group), 31.5 MB written and
// read once; the end-of-tile state gradients 83.9 MB.
//
// Against the first design of this backward (one block per (batch, head)
// walking the tiles in reverse): the sequential walk is now only the
// carry, an elementwise pass, so 2,560 + 480 blocks fill the card in
// balanced waves instead of 320 blocks of one 211 KB block an SM; scalar
// loads from odd pitches became the register tile's 16-byte loads; the
// full squares became warp-level triangle skips; 1 GB of per-head
// partials became 63 MB of group sums; C is read widened from the
// scratch, never per head from the inputs, and the reverse cumulative sum
// moved to the sums kernel, a warp per (batch, tile) of a head.  Times are
// in PERF.md.
// ---------------------------------------------------------------------------

constexpr int BT = 256;            // threads of the backward kernels
constexpr int HG = 16;             // heads of a group block
constexpr int SL = 8;              // depth of a k slab
constexpr int PH = PM / 2;         // state rows p a group block stages at once
constexpr int SC = 5 * QT + 16;    // per-position scalars and block slots
constexpr int RROWS = 16;          // rows of a sums block
constexpr int MP = QT + 1;         // pitch of its (Σ dt G L) rows
constexpr int BWD_SMEM = (QT * QT + QT * PM + SC) * 4;
constexpr int RED_SMEM = 2 * RROWS * MP * 4;
static_assert(QT * QT + 2 * PH * QT <= QT * QT + QT * PM &&
                  QT * PM + QT * NM <= QT * QT + QT * PM,
              "every role fits the main layout");
static_assert(2 * (BWD_SMEM + 1024) <= 228 * 1024, "two blocks an SM");

struct BwdArgs {
  const void* x;
  const float* dt;
  const float* A;
  const void* dy;
  const float* dstate;     // (B, H, P, N) float32, or null (zero)
  const float* starts;     // (B, H, ntiles, P, N) float32
  const unsigned char* scratch;   // the prep's (B, ntiles, 3, QT, NM)
  void* dx;
  float* ddt;
  float* dA;
  void* dB;                // (B, S, N) contiguous, x's dtype
  void* dC;
  float* dsend;            // (B, H, ntiles, P, N): dS at each tile's end
  float* decay;            // (B, H, ntiles): exp(cum_last) of each tile
  float* part;             // (B, ntiles, groups, 3, QT, QT): the groups' sums
  float* vec;              // (B, H, ntiles, 4, QT): R, Q', dci, s'
  float* ex;               // (B, H, ntiles): exp(cum_last)·⟨dS, S0⟩
  int H, S, P, N, tile, ntiles, groups;
  int vec_x, vec_dy, vec_dx, vec_s;   // 16-byte rows of x, dy, dx; N % 4 == 0
  int64_t sxb, sxh, sxs;   // x
  int64_t sdb, sdh, sds;   // dt
  int64_t syb, syh, sys;   // dy
  int64_t sgb, sgh, sgs;   // dx
  int64_t stb, sth, sts;   // ddt
};

// Rows of this thread's 8 × 8 tile (m0 = row0 of the warp + 4·(lane / 8)):
// m0 .. m0 + 3 and m0 + 16 .. m0 + 19; columns (n0 = col0 of the warp +
// 4·(lane % 8)): n0 .. n0 + 3 and n0 + 32 .. n0 + 35.
__device__ __forceinline__ int trow(int m0, int r) {
  return m0 + (r & 3) + ((r >> 2) << 4);
}
__device__ __forceinline__ int tcol(int n0, int c) {
  return n0 + (c & 3) + ((c >> 2) << 5);
}

__device__ __forceinline__ void zero8x8(float (&c)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) c[i][j] = 0.f;
}

// acc[r][c] += Σ_k A[k][trow(m0, r)]·B[k][tcol(n0, c)] over the slabs s0,
// s0 + ds, .. < s1 of SL rows k; A rows AP floats apart, B rows BP.
template <int AP, int BP>
__device__ __forceinline__ void outer(float (&acc)[8][8], const float* A,
                                      const float* B, int m0, int n0, int s0,
                                      int s1, int ds) {
  for (int s = s0; s < s1; s += ds) {
#pragma unroll
    for (int kk = 0; kk < SL; ++kk) {
      const float* ak = A + (s * SL + kk) * AP + m0;
      const float* bk = B + (s * SL + kk) * BP + n0;
      float av[8], bv[8];
      put4(av, ld4(ak));
      put4(av + 4, ld4(ak + 16));
      put4(bv, ld4(bk));
      put4(bv + 4, ld4(bk + 32));
      fma8x8(acc, av, bv);
    }
  }
}

// The tile to / from rows of PITCH floats.
template <int PITCH>
__device__ __forceinline__ void tile_store(float* dst, const float (&v)[8][8],
                                           int m0, int n0) {
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    float* row = dst + trow(m0, r) * PITCH + n0;
    *reinterpret_cast<float4*>(row) =
        make_float4(v[r][0], v[r][1], v[r][2], v[r][3]);
    *reinterpret_cast<float4*>(row + 32) =
        make_float4(v[r][4], v[r][5], v[r][6], v[r][7]);
  }
}
template <int PITCH>
__device__ __forceinline__ void tile_add(float (&v)[8][8], const float* src,
                                         int m0, int n0) {
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float* row = src + trow(m0, r) * PITCH + n0;
    const float4 a = ld4(row), b = ld4(row + 32);
    v[r][0] += a.x;
    v[r][1] += a.y;
    v[r][2] += a.z;
    v[r][3] += a.w;
    v[r][4] += b.x;
    v[r][5] += b.y;
    v[r][6] += b.z;
    v[r][7] += b.w;
  }
}

// One 16-byte word of T as float32 (bf16 widened exactly).
__device__ __forceinline__ void load_word(const float* p, float (&v)[4]) {
  put4(v, *reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ void load_word(const __nv_bfloat16* p,
                                          float (&v)[8]) {
  load8(p, v);
}

// Sum over the 8 lanes of a quarter warp (lane bits 0..2), in a fixed
// order; every lane holds the sum.
__device__ __forceinline__ float quarter_sum(float v) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}
// Sum over the 4 lanes of one lane % 8 (lane bits 3..4).
__device__ __forceinline__ float column_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 8);
  return v + __shfl_xor_sync(FULL, v, 16);
}

// Warp 0: tile scalars at sc (cum, dt, dt·exp(cum_last − cum), exp(cum),
// exp(cum_last − cum) per position, then exp(cum_last)), as the forward
// computes them (dt 0 past the tile).
__device__ __forceinline__ void tile_scalars(const float* dt, int64_t sds,
                                             float A, int t0, int qv,
                                             int lane, float* sc) {
  float d[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int j = 4 * lane + e;
    d[e] = j < qv ? dt[(int64_t)(t0 + j) * sds] : 0.f;
  }
  float* cum = sc;
  scan_dt(d, A, lane, cum, sc + QT, sc + 2 * QT, sc + 3 * QT, sc + 5 * QT);
  __syncwarp();
#pragma unroll
  for (int e = 0; e < 4; ++e)
    sc[4 * QT + 4 * lane + e] = expf(cum[QT - 1] - cum[4 * lane + e]);
}

// Rows [0, QT) of a (rows, P) matrix of T (rows rs elements apart,
// contiguous) into dst[row][p] (rows of PM floats), widened, times
// scale[row] if given, zero at rows ≥ valid and columns ≥ P.  With vec (P a
// whole number of 16-byte words, rows 16-byte aligned) a thread moves 16
// bytes a step, threads along the row.
template <typename T>
__device__ __forceinline__ void stage_nat(float* dst, const T* src, int64_t rs,
                                          int valid, int P,
                                          const float* scale, bool vec,
                                          int tid) {
  constexpr int V = 16 / sizeof(T), W = PM / V;
  if (vec) {
    for (int e = tid; e < QT * W; e += BT) {
      const int r = e / W, p = (e % W) * V;
      float v[V];
      if (r < valid && p < P) {
        load_word(src + r * rs + p, v);
        const float s = scale ? scale[r] : 1.f;
#pragma unroll
        for (int q = 0; q < V; ++q) v[q] *= s;
      } else {
#pragma unroll
        for (int q = 0; q < V; ++q) v[q] = 0.f;
      }
#pragma unroll
      for (int q = 0; q < V; q += 4)
        *reinterpret_cast<float4*>(dst + r * PM + p + q) =
            make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
    }
  } else {
    for (int e = tid; e < QT * PM; e += BT) {
      const int r = e / PM, p = e % PM;
      float v = 0.f;
      if (r < valid && p < P) {
        v = to_f32(src[r * rs + p]);
        if (scale) v *= scale[r];
      }
      dst[e] = v;
    }
  }
}

// Columns [p0, p0 + PH) of the same matrix transposed: dst[pp][row] (rows of
// QT floats) = src[row][p0 + pp]; threads along the rows, so the stores are
// conflict-free.
template <typename T>
__device__ __forceinline__ void stage_t(float* dst, const T* src, int64_t rs,
                                        int valid, int P, int p0, bool vec,
                                        int tid) {
  constexpr int V = 16 / sizeof(T), W = PH / V;
  if (vec) {
    for (int e = tid; e < QT * W; e += BT) {
      const int r = e % QT, pp = (e / QT) * V, p = p0 + pp;
      float v[V];
      if (r < valid && p < P) {
        load_word(src + r * rs + p, v);
      } else {
#pragma unroll
        for (int q = 0; q < V; ++q) v[q] = 0.f;
      }
#pragma unroll
      for (int q = 0; q < V; ++q) dst[(pp + q) * QT + r] = v[q];
    }
  } else {
    for (int e = tid; e < QT * PH; e += BT) {
      const int r = e % QT, pp = e / QT, p = p0 + pp;
      dst[pp * QT + r] = (r < valid && p < P) ? to_f32(src[r * rs + p]) : 0.f;
    }
  }
}

// Rows [p0, p0 + np) of a (P, N) float32 state into dst[pp][n] (rows of NM
// floats), zero padded; vec: N % 4 == 0.
__device__ __forceinline__ void stage_state(float* dst, const float* src,
                                            int P, int N, int p0, int np,
                                            bool vec, int tid) {
  if (vec) {
    for (int e = tid; e < np * (NM / 4); e += BT) {
      const int pp = e / (NM / 4), n = (e % (NM / 4)) * 4, p = p0 + pp;
      const float4 v = (p < P && n < N) ? ld4(src + (int64_t)p * N + n)
                                        : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(dst + pp * NM + n) = v;
    }
  } else {
    for (int e = tid; e < np * NM; e += BT) {
      const int pp = e / NM, n = e % NM, p = p0 + pp;
      dst[e] = (p < P && n < N) ? src[(int64_t)p * N + n] : 0.f;
    }
  }
}

// The whole state transposed: dst[n][p] (rows of PM floats).
__device__ __forceinline__ void stage_state_t(float* dst, const float* src,
                                              int P, int N, bool vec,
                                              int tid) {
  if (vec) {
    for (int e = tid; e < PM * (NM / 4); e += BT) {
      const int p = e % PM, n = (e / PM) * 4;
      const float4 v = (p < P && n < N) ? ld4(src + (int64_t)p * N + n)
                                        : make_float4(0.f, 0.f, 0.f, 0.f);
      dst[(n + 0) * PM + p] = v.x;
      dst[(n + 1) * PM + p] = v.y;
      dst[(n + 2) * PM + p] = v.z;
      dst[(n + 3) * PM + p] = v.w;
    }
  } else {
    for (int e = tid; e < PM * NM; e += BT) {
      const int p = e % PM, n = e / PM;
      dst[n * PM + p] = (p < P && n < N) ? src[(int64_t)p * N + n] : 0.f;
    }
  }
}

// A 128 × 128 float32 tile of the scratch transposed: dst[c][r] = src[r][c].
__device__ __forceinline__ void stage_scr_t(float* dst, const float* src,
                                            int tid) {
  for (int e = tid; e < QT * (QT / 4); e += BT) {
    const int r = e % QT, c = (e / QT) * 4;
    const float4 v = ld4(src + r * QT + c);
    dst[(c + 0) * QT + r] = v.x;
    dst[(c + 1) * QT + r] = v.y;
    dst[(c + 2) * QT + r] = v.z;
    dst[(c + 3) * QT + r] = v.w;
  }
}

// M[i][j] = C_i·B_j·exp(cum_i − cum_j) for j ≤ i < qv, else 0, from the
// scratch's C·Bᵀ transposed (CBt[j][i]); the select comes before the exp
// (above the diagonal it may be inf).
__device__ __forceinline__ void stage_m(float* M, const float* CBt,
                                        const float* cum, int qv, int tid) {
  for (int e = tid; e < QT * (QT / 4); e += BT) {
    const int j = e % QT, i0 = (e / QT) * 4;
    float v[4];
    put4(v, ld4(CBt + j * QT + i0));
    const float cj = cum[j];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = i0 + q;
      const float l = (j <= i && i < qv) ? expf(cum[i] - cj) : 0.f;
      M[i * QT + j] = v[q] * l;
    }
  }
}

// Launch 2: block (head, tile k ≥ 1, batch) writes U_k[p][n] = Σ_i
// exp(cum_i) dy[i][p] C[i][n] into the state-gradient slot of tile k − 1
// (the carry adds the rest there) and exp(cum_last) of tile k.  Warps 0–3
// sum the even slabs of i, warps 4–7 the odd ones, each a 32 × 64 tile of
// the (P, N) product; the halves are added once, in order.
template <typename T>
__global__ void __launch_bounds__(BT, 2)
    ssd_scan_bwd_states_kernel(BwdArgs a) {
  using L = Layout<T>;
  extern __shared__ __align__(16) float bsm[];
  float* At = bsm;                          // [i][p] exp(cum_i)·dy
  float* Bt = At + QT * PM;                 // [i][n] C
  float* sc = bsm + QT * QT + QT * PM;      // scalars
  float* red = At;                          // [p][n] the odd slabs' sums
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x, k = blockIdx.y + 1, b = blockIdx.z;
  const int t0 = k * a.tile, qv = min(a.tile, a.S - t0);
  const float* tscr = reinterpret_cast<const float*>(
      a.scratch + ((int64_t)b * a.ntiles + k) * L::TILE_BYTES);
  const int64_t tb = ((int64_t)b * a.H + h) * a.ntiles + k;

  if (warp == 0)
    tile_scalars(a.dt + b * a.sdb + h * a.sdh, a.sds, a.A[h], t0, qv, lane,
                 sc);
  stage_scr_t(Bt, tscr + L::OFF_CT / 4, tid);
  __syncthreads();
  stage_nat(At, static_cast<const T*>(a.dy) + b * a.syb + h * a.syh +
                    (int64_t)t0 * a.sys,
            a.sys, qv, a.P, sc + 3 * QT, a.vec_dy, tid);
  __syncthreads();

  const int hk = warp >> 2, wr = (warp >> 1) & 1, wc = warp & 1;
  const int m0 = 32 * wr + 4 * (lane >> 3), n0 = 64 * wc + 4 * (lane & 7);
  float acc[8][8];
  zero8x8(acc);
  if (32 * wr < a.P) outer<PM, NM>(acc, At, Bt, m0, n0, hk, (qv + SL - 1) / SL, 2);
  __syncthreads();
  if (hk) tile_store<NM>(red, acc, m0, n0);
  __syncthreads();
  if (!hk) {
    tile_add<NM>(acc, red, m0, n0);
    float* u = a.dsend + (tb - 1) * a.P * a.N;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int p = trow(m0, r);
      if (p >= a.P) continue;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int n = tcol(n0, c);
        if (n < a.N) u[(int64_t)p * a.N + n] = acc[r][c];
      }
    }
  }
  if (tid == 0) a.decay[tb] = sc[5 * QT];
}

// Launch 3: block (element chunk, batch·H + head) walks the tiles in
// reverse for BT elements of the state: slot k receives dS at tile k's end
// (d_state for the last), then r ← exp(cum_last,k)·r + U_k from slot k − 1.
__global__ void __launch_bounds__(BT) ssd_scan_bwd_carry_kernel(BwdArgs a) {
  const int64_t pn = (int64_t)a.P * a.N;
  const int64_t e = (int64_t)blockIdx.x * BT + threadIdx.x;
  if (e >= pn) return;
  const int64_t bh = blockIdx.y;
  float r = a.dstate ? a.dstate[bh * pn + e] : 0.f;
  float* d = a.dsend + bh * a.ntiles * pn + e;
  const float* dec = a.decay + bh * a.ntiles;
  for (int k = a.ntiles - 1; k >= 0; --k) {
    const float u = k ? d[(k - 1) * pn] : 0.f;
    d[k * pn] = r;
    if (k) r = fmaf(dec[k], r, u);
  }
}

// A group block (role, batch, tile, group of HG heads): for each head, the
// (q × q) or (q × N) product over p, in two halves of P staged transposed,
// into a register tile; then the role's epilogue adds the head's term into
// the group's sum, kept in shared memory (each thread its own tile), and
// writes the head's per-position vector:
//   role 0: G[j][i] = x_j·dy_i → Σ_h dt_j G L [j][i]; R_i, Q'_j;
//   role 1: dy·S0 [i][n] → Σ_h exp(cum_i)·(dy·S0) (dC inter); dci_i;
//   role 2: x·dS [j][n] → Σ_h dt_j exp(cum_last − cum_j)·(x·dS) (dB state);
//           s'_j.
// Warps: 4 row quarters × 2 column halves of the 128 × 128 tile; a warp
// whose rows lie past the tile, or (role 0) whose columns lie wholly above
// its rows, computes nothing.
template <typename T>
__device__ __forceinline__ void group_block(const BwdArgs& a, float* sm,
                                            int role, int b, int k, int g) {
  using L = Layout<T>;
  float* gsum = sm;                         // [m][n] the group's sum
  float* At = gsum + QT * QT;               // [pp][m]
  float* Bt = At + PH * QT;                 // [pp][n]
  float* sc = sm + QT * QT + QT * PM;
  float* red = At;                          // per-head sums across warps
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp >> 1, wc = warp & 1;
  const int m0 = 32 * wr + 4 * (lane >> 3), n0 = 64 * wc + 4 * (lane & 7);
  const int t0 = k * a.tile, qv = min(a.tile, a.S - t0);
  const bool active =
      32 * wr < qv && (role != 0 || (64 * wc + 63 >= 32 * wr && 64 * wc < qv));
  const float* tscr = reinterpret_cast<const float*>(
      a.scratch + ((int64_t)b * a.ntiles + k) * L::TILE_BYTES);
  const int64_t pn = (int64_t)a.P * a.N;
  const int h0 = g * HG, h1 = min(a.H, h0 + HG);
  const float* cum = sc;
  const float* dts = sc + QT;
  const float* wts = sc + 2 * QT;
  const float* ecum = sc + 3 * QT;
  const float* dte = sc + 4 * QT;

  for (int h = h0; h < h1; ++h) {
    const T* x = static_cast<const T*>(a.x) + b * a.sxb + h * a.sxh +
                 (int64_t)t0 * a.sxs;
    const T* dy = static_cast<const T*>(a.dy) + b * a.syb + h * a.syh +
                  (int64_t)t0 * a.sys;
    const int64_t tb = ((int64_t)b * a.H + h) * a.ntiles + k;
    float tmp[8][8];
    zero8x8(tmp);
    for (int p0 = 0; p0 < a.P; p0 += PH) {
      __syncthreads();         // the last readers of At, Bt (red) are done
      if (p0 == 0 && warp == 0)
        tile_scalars(a.dt + b * a.sdb + h * a.sdh, a.sds, a.A[h], t0, qv,
                     lane, sc);
      if (role == 0) {
        stage_t(At, x, a.sxs, qv, a.P, p0, a.vec_x, tid);
        stage_t(Bt, dy, a.sys, qv, a.P, p0, a.vec_dy, tid);
      } else {
        stage_t(At, role == 1 ? dy : x, role == 1 ? a.sys : a.sxs, qv, a.P,
                p0, role == 1 ? a.vec_dy : a.vec_x, tid);
        stage_state(Bt, (role == 1 ? a.starts : a.dsend) + tb * pn, a.P, a.N,
                    p0, PH, a.vec_s, tid);
      }
      __syncthreads();
      if (active)
        outer<QT, NM>(tmp, At, Bt, m0, n0, 0,
                      (min(PH, a.P - p0) + SL - 1) / SL, 1);
    }
    __syncthreads();           // the products are done with At (red)
    const bool first = h == h0;
    if (role == 0) {
      float* red_r = red;                   // [wr][i]
      float* red_q = red + 4 * QT;          // [wc][j]
      float cs[8];             // R of this thread's columns
#pragma unroll
      for (int c = 0; c < 8; ++c) cs[c] = 0.f;
      if (active) {
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int j = trow(m0, r);
          const float cj = cum[j], dj = dts[j];
          const float* cbt = tscr + j * QT + n0;
          float4* s0 = reinterpret_cast<float4*>(gsum + j * QT + n0);
          float rs = 0.f;      // Q'_j, this thread's columns
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            float cb[4], dp[4];
            put4(cb, ld4(cbt + 32 * hf));
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int c = 4 * hf + q, i = tcol(n0, c);
              // select before exp: above the diagonal exp may be inf
              const float l = (j <= i && i < qv) ? expf(cum[i] - cj) : 0.f;
              const float gl = tmp[r][c] * l;
              const float t = gl * cb[q];
              dp[q] = gl * dj;
              rs += t;
              cs[c] = fmaf(dj, t, cs[c]);
            }
            float4* sp = s0 + 8 * hf;
            float4 o = first ? make_float4(0.f, 0.f, 0.f, 0.f) : *sp;
            o.x += dp[0];
            o.y += dp[1];
            o.z += dp[2];
            o.w += dp[3];
            *sp = o;
          }
          rs = quarter_sum(rs);
          if ((lane & 7) == 0) red_q[wc * QT + j] = rs;
        }
      } else {
#pragma unroll
        for (int r = 0; r < 8; ++r)
          if ((lane & 7) == 0) red_q[wc * QT + trow(m0, r)] = 0.f;
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float v = column_sum(cs[c]);
        if (lane < 8) red_r[wr * QT + tcol(n0, c)] = v;
      }
      __syncthreads();
      if (tid < QT) {
        float* v = a.vec + tb * 4 * QT;
        v[tid] = ((red_r[tid] + red_r[QT + tid]) + red_r[2 * QT + tid]) +
                 red_r[3 * QT + tid];
        v[QT + tid] = red_q[tid] + red_q[QT + tid];
      }
    } else {
      // role 1: dci_i = exp(cum_i)·Σ_n (dy·S0)[i][n] C[i][n], and
      //         exp(cum_i)·(dy·S0) into the sum;
      // role 2: s'_j = exp(cum_last − cum_j)·Σ_n (x·dS)[j][n] B[j][n], and
      //         dt_j exp(cum_last − cum_j)·(x·dS) into the sum
      float rs[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) rs[r] = 0.f;
      if (active) {
        if (role == 1) {
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const float* ct = tscr + L::OFF_CT / 4 + tcol(n0, c) * QT + m0;
            float cv[8];
            put4(cv, ld4(ct));
            put4(cv + 4, ld4(ct + 16));
#pragma unroll
            for (int r = 0; r < 8; ++r) rs[r] = fmaf(tmp[r][c], cv[r], rs[r]);
          }
        } else {
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const float* bf = tscr + L::OFF_BF / 4 + trow(m0, r) * NM + n0;
            float bv[8];
            put4(bv, ld4(bf));
            put4(bv + 4, ld4(bf + 32));
#pragma unroll
            for (int c = 0; c < 8; ++c) rs[r] = fmaf(tmp[r][c], bv[c], rs[r]);
          }
        }
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int m = trow(m0, r);
          rs[r] *= role == 1 ? ecum[m] : dte[m];
          const float w = role == 1 ? ecum[m] : wts[m];
          float4* s0 = reinterpret_cast<float4*>(gsum + m * QT + n0);
          float4* s1 = reinterpret_cast<float4*>(gsum + m * QT + n0 + 32);
          float4 o0 = first ? make_float4(0.f, 0.f, 0.f, 0.f) : *s0;
          float4 o1 = first ? make_float4(0.f, 0.f, 0.f, 0.f) : *s1;
          o0.x = fmaf(w, tmp[r][0], o0.x);
          o0.y = fmaf(w, tmp[r][1], o0.y);
          o0.z = fmaf(w, tmp[r][2], o0.z);
          o0.w = fmaf(w, tmp[r][3], o0.w);
          o1.x = fmaf(w, tmp[r][4], o1.x);
          o1.y = fmaf(w, tmp[r][5], o1.y);
          o1.z = fmaf(w, tmp[r][6], o1.z);
          o1.w = fmaf(w, tmp[r][7], o1.w);
          *s0 = o0;
          *s1 = o1;
        }
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float v = quarter_sum(rs[r]);
        if ((lane & 7) == 0) red[wc * QT + trow(m0, r)] = v;
      }
      __syncthreads();
      if (tid < QT)
        a.vec[(tb * 4 + (role == 1 ? 2 : 3)) * QT + tid] =
            red[tid] + red[QT + tid];
    }
  }
  // the group's sum out once (zeros where no warp wrote)
  float* out = a.part +
               ((((int64_t)b * a.ntiles + k) * a.groups + g) * 3 + role) *
                   QT * QT;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int m = trow(m0, r);
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 v0 = active ? ld4(gsum + m * QT + n0) : z;
    const float4 v1 = active ? ld4(gsum + m * QT + n0 + 32) : z;
    *reinterpret_cast<float4*>(out + m * QT + n0) = v0;
    *reinterpret_cast<float4*>(out + m * QT + n0 + 32) = v1;
  }
}

// 4 consecutive outputs of T (dx), 16-byte (float32) or 8-byte (bf16)
// aligned.
__device__ __forceinline__ void store4(float* o, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(o) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* o, float a, float b,
                                       float c, float d) {
  *reinterpret_cast<uint2*>(o) = make_uint2(pack_bf16(a, b), pack_bf16(c, d));
}

// A g block (batch, tile, head): g = exp(cum_last − cum_j)·(B dSᵀ)_j (sum
// over n) + Σ_{i≥j} M_ij dy_i (sum over i ≥ the warp's first row), each
// split between the block's halves; dx = dt·g; and ex = exp(cum_last)·⟨dS,
// S0⟩.  Warps 0–3 and 4–7: the row quarters of the (q × P) tile.
template <typename T>
__device__ __forceinline__ void g_block(const BwdArgs& a, float* sm, int b,
                                        int k, int h) {
  using L = Layout<T>;
  float* R0 = sm;                           // [n][j] Bᵀ, then [i][j] M
  float* R1 = sm + QT * QT;                 // [n][p] dSᵀ, then [i][p] dy
  float* sc = sm + QT * QT + QT * PM;
  float* red = R0;                          // [j][p] the odd slabs' sums
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hk = warp >> 2, wr = warp & 3;
  const int m0 = 32 * wr + 4 * (lane >> 3), n0 = 4 * (lane & 7);
  const int t0 = k * a.tile, qv = min(a.tile, a.S - t0);
  const float* tscr = reinterpret_cast<const float*>(
      a.scratch + ((int64_t)b * a.ntiles + k) * L::TILE_BYTES);
  const int64_t tb = ((int64_t)b * a.H + h) * a.ntiles + k;
  const int64_t pn = (int64_t)a.P * a.N;
  const float* ds = a.dsend + tb * pn;
  const float* s0 = a.starts + tb * pn;
  const bool rows = 32 * wr < qv;

  if (warp == 0)
    tile_scalars(a.dt + b * a.sdb + h * a.sdh, a.sds, a.A[h], t0, qv, lane,
                 sc);
  stage_scr_t(R0, tscr + L::OFF_BF / 4, tid);
  stage_state_t(R1, ds, a.P, a.N, a.vec_s, tid);
  float dd = 0.f;                           // ⟨dS, S0⟩, this thread's part
  if (a.vec_s) {
    for (int64_t e = 4 * tid; e < pn; e += 4 * BT)
      dd = dot4(ld4(ds + e), ld4(s0 + e), dd);
  } else {
    for (int64_t e = tid; e < pn; e += BT) dd = fmaf(ds[e], s0[e], dd);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) dd += __shfl_xor_sync(FULL, dd, off);
  if (lane == 0) sc[5 * QT + 8 + warp] = dd;
  __syncthreads();

  float acc[8][8];
  zero8x8(acc);
  if (rows) outer<QT, PM>(acc, R0, R1, m0, n0, hk, (a.N + SL - 1) / SL, 2);
  __syncthreads();
  if (hk) tile_store<PM>(red, acc, m0, n0);
  __syncthreads();
  if (hk) {
    zero8x8(acc);
  } else {
    tile_add<PM>(acc, red, m0, n0);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float e = sc[4 * QT + trow(m0, r)];
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] *= e;
    }
  }
  __syncthreads();             // done with R0 (red) and R1
  stage_m(R0, tscr, sc, qv, tid);
  stage_nat(R1, static_cast<const T*>(a.dy) + b * a.syb + h * a.syh +
                    (int64_t)t0 * a.sys,
            a.sys, qv, a.P, static_cast<const float*>(nullptr), a.vec_dy,
            tid);
  __syncthreads();
  if (rows)
    outer<QT, PM>(acc, R0, R1, m0, n0, 4 * wr + hk, (qv + SL - 1) / SL, 2);
  __syncthreads();
  if (hk) tile_store<PM>(red, acc, m0, n0);
  __syncthreads();
  if (!hk) {
    tile_add<PM>(acc, red, m0, n0);
    T* dx = static_cast<T*>(a.dx) + b * a.sgb + h * a.sgh +
            (int64_t)t0 * a.sgs;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int j = trow(m0, r);
      if (j >= qv) continue;
      const float dj = sc[QT + j];
      T* row = dx + (int64_t)j * a.sgs;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = n0 + 32 * half;
        const float* g = acc[r] + 4 * half;
        if (a.vec_dx) {
          if (p < a.P)
            store4(row + p, dj * g[0], dj * g[1], dj * g[2], dj * g[3]);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (p + q < a.P) from_f32(row + p + q, dj * g[q]);
        }
      }
    }
  }
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < BT / 32; ++w) s += sc[5 * QT + 8 + w];
    a.ex[tb] = sc[5 * QT] * s;
  }
}

// Launch 4: the group blocks first (role fastest, then group, tile,
// batch), then the g blocks (head fastest).
template <typename T>
__global__ void __launch_bounds__(BT, 2)
    ssd_scan_bwd_main_kernel(BwdArgs a, int batch) {
  extern __shared__ __align__(16) float bsm[];
  const int ngb = 3 * batch * a.ntiles * a.groups;
  const int idx = blockIdx.x;
  if (idx < ngb) {
    const int role = idx % 3, rest = idx / 3;
    const int g = rest % a.groups, bk = rest / a.groups;
    group_block<T>(a, bsm, role, bk / a.ntiles, bk % a.ntiles, g);
  } else {
    const int i = idx - ngb, h = i % a.H, bk = i / a.H;
    g_block<T>(a, bsm, bk / a.ntiles, bk % a.ntiles, h);
  }
}

// Launch 5, one head's ddt and dA (block h < H): warp w
// takes the (batch, tile) items w, w + 8, ..: ∂/∂cum_j = R_j + dci_j −
// dt_j·(Q'_j + s'_j), plus Σ_j dt_j s'_j + exp(cum_last)·⟨dS, S0⟩ at the
// last position; its reverse cumulative sum da; ddt = x·g + A·da; dA sums
// da·dt over the warp's items in order, then over the warps in order.
__device__ __forceinline__ void ddt_block(const BwdArgs& a, float* red,
                                          int batch, int h) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float A = a.A[h];
  float dA_acc = 0.f;
  for (int it = warp; it < batch * a.ntiles; it += BT / 32) {
    const int b = it / a.ntiles, k = it % a.ntiles;
    const int t0 = k * a.tile, qv = min(a.tile, a.S - t0);
    const int64_t tb = ((int64_t)b * a.H + h) * a.ntiles + k;
    const float* v = a.vec + tb * 4 * QT;
    const float* dt = a.dt + b * a.sdb + h * a.sdh;
    float* ddt = a.ddt + b * a.stb + h * a.sth;
    float d[4], xg[4], u[4], es = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 4 * lane + e;
      d[e] = j < qv ? dt[(int64_t)(t0 + j) * a.sds] : 0.f;
      const float s = v[3 * QT + j];
      xg[e] = v[QT + j] + s;
      es = fmaf(d[e], s, es);
      u[e] = (v[j] + v[2 * QT + j]) - d[e] * xg[e];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) es += __shfl_xor_sync(FULL, es, off);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (4 * lane + e == qv - 1) u[e] += es + a.ex[tb];
    u[2] += u[3];
    u[1] += u[2];
    u[0] += u[1];
    float tot = u[0];
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
      const float da = u[e] + excl;
      if (j < qv) ddt[(int64_t)(t0 + j) * a.sts] = fmaf(da, A, xg[e]);
      dA_acc = fmaf(da, d[e], dA_acc);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    dA_acc += __shfl_xor_sync(FULL, dA_acc, off);
  if (lane == 0) red[warp] = dA_acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < BT / 32; ++w) s += red[w];
    a.dA[h] = s;
  }
}

// Launch 5: the first H blocks one head's ddt and dA each (they start
// first; the rest is short).  Then block (eighth, tile, batch): rows i0 =
// 16·eighth .. + 15 of the tile.  Sums the groups' parts in group order,
// then
//   dC[i][n] = Σ dC inter + Σ_j (Σ dt G L)[j][i] B[j][n]
//   dB[j][n] = Σ dB state + Σ_i (Σ dt G L)[j][i] C[i][n]
template <typename T>
__global__ void __launch_bounds__(BT)
    ssd_scan_bwd_sums_kernel(BwdArgs a, int batch) {
  using L = Layout<T>;
  extern __shared__ __align__(16) float rsm[];
  if ((int)blockIdx.x < a.H) {
    ddt_block(a, rsm, batch, blockIdx.x);
    return;
  }
  const int blk = blockIdx.x - a.H;
  float* R1 = rsm;                   // [ii][j] = Σ dtGL[j][i0 + ii]
  float* R2 = R1 + RROWS * MP;       // [jj][i] = Σ dtGL[i0 + jj][i]
  const int tid = threadIdx.x;
  const int i0 = (blk % (QT / RROWS)) * RROWS;
  const int k = (blk / (QT / RROWS)) % a.ntiles;
  const int b = blk / ((QT / RROWS) * a.ntiles);
  const int t0 = k * a.tile, qv = min(a.tile, a.S - t0);
  const int64_t tile_q = (int64_t)QT * QT;
  const float* pk = a.part + ((int64_t)b * a.ntiles + k) * a.groups * 3 * tile_q;
  const float* tscr = reinterpret_cast<const float*>(
      a.scratch + ((int64_t)b * a.ntiles + k) * L::TILE_BYTES);
  const float* Bf = tscr + L::OFF_BF / 4;
  const float* Ct = tscr + L::OFF_CT / 4;

  for (int e = tid; e < RROWS * QT; e += BT) {
    const int ii = e % RROWS, j = e / RROWS;    // R1: RROWS consecutive i
    const int jj = e / QT, i = e % QT;          // R2: a row of 128 i
    float s1 = 0.f, s2 = 0.f;
    for (int g = 0; g < a.groups; ++g) {
      const float* d = pk + g * 3 * tile_q;
      s1 += d[j * QT + i0 + ii];
      s2 += d[(i0 + jj) * QT + i];
    }
    R1[ii * MP + j] = s1;
    R2[jj * MP + i] = s2;
  }
  __syncthreads();

  // thread: column n, rows r0 + 2u
  const int n = tid % NM, r0 = tid / NM;
  constexpr int RU = RROWS / (BT / NM);
  float dc[RU], db[RU];
#pragma unroll
  for (int u = 0; u < RU; ++u) {
    const int row = i0 + r0 + 2 * u;
    float s1 = 0.f, s2 = 0.f;
    for (int g = 0; g < a.groups; ++g) {
      const float* d = pk + g * 3 * tile_q + row * NM + n;
      s1 += d[tile_q];
      s2 += d[2 * tile_q];
    }
    dc[u] = s1;
    db[u] = s2;
  }
  // C[j][n] is Ct's row n: 16-byte loads along j
  const float* ct = Ct + n * QT;
#pragma unroll 4
  for (int j0 = 0; j0 < QT; j0 += 4) {
    float cv[4];
    put4(cv, ld4(ct + j0));
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + q;
      const float bj = Bf[j * NM + n];
#pragma unroll
      for (int u = 0; u < RU; ++u) {
        dc[u] = fmaf(R1[(r0 + 2 * u) * MP + j], bj, dc[u]);
        db[u] = fmaf(R2[(r0 + 2 * u) * MP + j], cv[q], db[u]);
      }
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
}

// Dynamic shared memory above 48 KB, and the largest carveout, asked once
// per kernel and device.
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

// Launches 2 and 3: the end-of-tile state gradients into a.dsend.
template <typename T, int ID>
int launch_states(const BwdArgs& a, int batch, cudaStream_t stream) {
  cudaError_t e;
  if (a.ntiles > 1) {
    e = opt_in_kernel<ID>(
        reinterpret_cast<const void*>(ssd_scan_bwd_states_kernel<T>),
        BWD_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    ssd_scan_bwd_states_kernel<T>
        <<<dim3(a.H, a.ntiles - 1, batch), BT, BWD_SMEM, stream>>>(a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int64_t pn = (int64_t)a.P * a.N;
  ssd_scan_bwd_carry_kernel<<<dim3((unsigned)((pn + BT - 1) / BT),
                                   batch * a.H),
                              BT, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Launches 4 and 5.
template <typename T, int ID>
int launch_bwd(const BwdArgs& a, int batch, cudaStream_t stream) {
  cudaError_t e = opt_in_kernel<ID + 1>(
      reinterpret_cast<const void*>(ssd_scan_bwd_main_kernel<T>), BWD_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = 3 * batch * a.ntiles * a.groups + batch * a.ntiles * a.H;
  ssd_scan_bwd_main_kernel<T><<<blocks, BT, BWD_SMEM, stream>>>(a, batch);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = opt_in_kernel<ID + 2>(
      reinterpret_cast<const void*>(ssd_scan_bwd_sums_kernel<T>), RED_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_scan_bwd_sums_kernel<T>
      <<<(QT / RROWS) * a.ntiles * batch + a.H, BT, RED_SMEM, stream>>>(
          a, batch);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int ID>
int bwd_blocks_per_sm() {
  int n = 0;
  if (opt_in_kernel<ID + 1>(
          reinterpret_cast<const void*>(ssd_scan_bwd_main_kernel<T>),
          BWD_SMEM) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, ssd_scan_bwd_main_kernel<T>, BT, BWD_SMEM) != cudaSuccess)
    return -1;
  return n;
}

// The prep and the backward's arguments from the C entries' (every pointer
// may be null where the entry does not need it).
Args prep_args(const void* B, const void* C, void* scratch, int bf16, int S,
               int N, int tile, long long sbb, long long sbs, long long scb,
               long long scs) {
  Args pa{};
  pa.B = B;
  pa.C = C;
  pa.scratch = static_cast<unsigned char*>(scratch);
  pa.S = S;
  pa.N = N;
  pa.tile = tile;
  pa.ntiles = (S + tile - 1) / tile;
  pa.sbb = sbb;
  pa.sbs = sbs;
  pa.scb = scb;
  pa.scs = scs;
  const int elt = bf16 ? 2 : 4;
  pa.vec_bc = N % (16 / elt) == 0 && aligned(B, elt, {sbb, sbs}) &&
              aligned(C, elt, {scb, scs});
  return pa;
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
  const Args a = prep_args(B, C, scratch, bf16, S, N, tile, sbb, sbs, scb,
                           scs);
  return launch_prep(a, batch, bf16, static_cast<cudaStream_t>(stream));
}

// The end-of-tile gradients of the state alone (the backward's first three
// launches, for their check against their plain version): dt, A, B, C, dy
// and dstate (or null) as ssd_scan_bwd takes them; dsend (B, H, ceil(S /
// tile), P, N) float32 contiguous receives the gradient of the state at the
// end of each tile; decay (B, H, ceil(S / tile)) float32 and scratch (as the
// forward's) are overwritten.  Returns the CUDA error code.
extern "C" int ssd_scan_bwd_states(
    const float* dt, const float* A, const void* B, const void* C,
    const void* dy, const float* dstate, float* dsend, float* decay,
    void* scratch, int bf16, int batch, int H, int S, int P, int N, int tile,
    long long sdb, long long sdh, long long sds, long long sbb,
    long long sbs, long long scb, long long scs, long long syb,
    long long syh, long long sys, void* stream) {
  if (batch == 0 || H == 0) return 0;
  if (P < 1 || P > PM || N < 1 || N > NM || tile < 1 || tile > QT || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int elt = bf16 ? 2 : 4;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args pa = prep_args(B, C, scratch, bf16, S, N, tile, sbb, sbs, scb,
                            scs);
  int rc = launch_prep(pa, batch, bf16, st);
  if (rc != 0) return rc;
  BwdArgs a{};
  a.dt = dt;
  a.A = A;
  a.dy = dy;
  a.dstate = dstate;
  a.scratch = static_cast<const unsigned char*>(scratch);
  a.dsend = dsend;
  a.decay = decay;
  a.H = H;
  a.S = S;
  a.P = P;
  a.N = N;
  a.tile = tile;
  a.ntiles = pa.ntiles;
  a.vec_dy = P % (16 / elt) == 0 && aligned(dy, elt, {syb, syh, sys});
  a.sdb = sdb;
  a.sdh = sdh;
  a.sds = sds;
  a.syb = syb;
  a.syh = syh;
  a.sys = sys;
  return bf16 ? launch_states<__nv_bfloat16, 10>(a, batch, st)
              : launch_states<float, 20>(a, batch, st);
}

// Blocks of the backward's main kernel an SM holds at once on the current
// device (float32 or bf16 inputs), or -1 if the query fails.
extern "C" int ssd_scan_bwd_blocks_per_sm(int bf16) {
  return bf16 ? bwd_blocks_per_sm<__nv_bfloat16, 10>()
              : bwd_blocks_per_sm<float, 20>();
}

// Backward of ssd_scan from dy (and d_state, or null for zero): x, dt, A,
// B, C as the forward took them, dy and dx by (batch, head, position)
// strides with a contiguous last axis, ddt by its three strides; starts
// the forward's tile-start states (B, H, ceil(S / tile), P, N).  Writes
// dx (x's dtype), ddt (float32), dA (H,) float32, dB and dC ((B, S, N)
// contiguous, x's dtype).  Scratch, all float32 contiguous and
// overwritten: scratch as the forward's; dsend (B, H, tiles, P, N), decay
// and ex (B, H, tiles); part (B, tiles, ceil(H / 16), 3, 128, 128); vec (B,
// H, tiles, 4, 128).  Five launches on `stream` (the prep, the tiles' state
// sums, their carry, the main kernel, the sums); returns the CUDA error
// code.
extern "C" int ssd_scan_bwd(
    const void* x, const float* dt, const float* A, const void* B,
    const void* C, const void* dy, const float* dstate, const float* starts,
    void* dx, float* ddt, float* dA, void* dB, void* dC, void* scratch,
    float* dsend, float* decay, float* part, float* vec, float* ex, int bf16,
    int batch, int H, int S, int P, int N, int tile, long long sxb,
    long long sxh, long long sxs, long long sdb, long long sdh,
    long long sds, long long sbb, long long sbs, long long scb,
    long long scs, long long syb, long long syh, long long sys,
    long long sgb, long long sgh, long long sgs, long long stb,
    long long sth, long long sts, void* stream) {
  if (batch == 0 || H == 0) return 0;
  if (P < 1 || P > PM || N < 1 || N > NM || tile < 1 || tile > QT || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int elt = bf16 ? 2 : 4;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args pa = prep_args(B, C, scratch, bf16, S, N, tile, sbb, sbs, scb,
                            scs);
  int rc = launch_prep(pa, batch, bf16, st);
  if (rc != 0) return rc;
  const BwdArgs a{x,   dt,  A,   dy,  dstate, starts,
                  static_cast<const unsigned char*>(scratch),
                  dx,  ddt, dA,  dB,  dC,  dsend, decay, part, vec, ex,
                  H,   S,   P,   N,   tile, pa.ntiles, (H + HG - 1) / HG,
                  P % (16 / elt) == 0 && aligned(x, elt, {sxb, sxh, sxs}),
                  P % (16 / elt) == 0 && aligned(dy, elt, {syb, syh, sys}),
                  P % 4 == 0 && aligned(dx, elt, {sgb, sgh, sgs}),
                  N % 4 == 0,
                  sxb, sxh, sxs, sdb, sdh, sds, syb, syh, sys,
                  sgb, sgh, sgs, stb, sth, sts};
  rc = bf16 ? launch_states<__nv_bfloat16, 10>(a, batch, st)
            : launch_states<float, 20>(a, batch, st);
  if (rc != 0) return rc;
  return bf16 ? launch_bwd<__nv_bfloat16, 10>(a, batch, st)
              : launch_bwd<float, 20>(a, batch, st);
}
