// Mamba2 SSD chunked scan for Hopper (sm_90a), from the zero state.
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
// mixer shape (4 sequences × 80 heads, S 1024, P 64, N 128, chunk 128) a
// call does ≈ 16 GFLOP on ≈ 98 MB of operands, ~165 FLOP per byte, far
// above the ~20 FLOP per byte where float32 CUDA-core math (67 TFLOP/s)
// overtakes HBM (3.35 TB/s).  Tensor cores (TF32 or bf16) are excluded on
// purpose: the reference computes every product in full float32.
//
// Design (a plain, correct body — no wgmma, no TMA): one block of 256
// threads per (batch, head) walks the chunks in order.  The (P, N) state
// lives in registers (4 × 8 values a thread) for the whole sequence.  Per
// chunk, x, B and C are converted to float32 and staged in shared memory
// (rows padded by 4 floats: conflict-free float4 reads down a column of
// rows), with the state transposed beside them; rows that are 16-byte
// aligned (the mixer's are) load as 16-byte words, several in flight per
// thread — element by element the staging took half the kernel's time.
// Warp 0 loads dt and computes the cumulative log-decay with shuffles.  The chunk's output
// rows go in passes of 32: the masked scores
// S_ij = (C_i·B_j)·exp(cum_i − cum_j)·dt_j of the pass (only the 32-column
// blocks at or below the diagonal) land in shared memory, then each
// thread adds S·x and exp(cum_i)·C·stateᵀ for 2 rows × 4 columns.  The
// state update accumulates Σ_j (x_j·w_j) ⊗ B_j with w_j = dt_j ·
// exp(cum_last − cum_j) in registers.  Above the diagonal cum_i − cum_j is
// positive and exp can overflow: the score is selected to 0 there, never
// computed as exp(·)·mask (inf·0 = NaN).  x, B, C and y are addressed by
// (batch, head, position) element strides with a contiguous last axis,
// so the mixer's slices of its projection are read without copies.
// Positions past S (a last partial tile) and P < 64, N < 128 are zero
// padded.  expf and IEEE arithmetic: no fast-math.
//
// Shared memory: 223,232 bytes (one block per SM), above the 48 KB
// default: the launcher opts in and returns the CUDA error if refused.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <initializer_list>

namespace {

constexpr int THREADS = 256;
constexpr int QT = 128;            // positions per tile (the largest chunk)
constexpr int PM = 64;             // head dim capacity
constexpr int NM = 128;            // state dim capacity
constexpr int RT = 32;             // output rows per pass (= column block)
constexpr int BP = NM + 4;         // padded row of the B and C tiles
constexpr int XP = PM + 4;         // padded row of x and of the state^T
constexpr int SP = QT + 4;         // padded row of the score tile
constexpr unsigned FULL = 0xffffffffu;

constexpr size_t SMEM_FLOATS =
    2 * QT * BP + QT * XP + NM * XP + RT * SP + 3 * QT;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float* o, float v) { *o = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* o, float v) {
  *o = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void fma4(float4& acc, float s, const float4& v) {
  acc.x = fmaf(s, v.x, acc.x);
  acc.y = fmaf(s, v.y, acc.y);
  acc.z = fmaf(s, v.z, acc.z);
  acc.w = fmaf(s, v.w, acc.w);
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// The 16-byte word `raw` as float32 values: 4 floats or 8 bf16.
__device__ __forceinline__ void unpack(const uint4& raw, float* v, float) {
  v[0] = __uint_as_float(raw.x);
  v[1] = __uint_as_float(raw.y);
  v[2] = __uint_as_float(raw.z);
  v[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack(const uint4& raw, float* v,
                                       __nv_bfloat16) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  void* y;
  float* state;
  int H, S, P, N, tile;
  int vec_x, vec_bc;       // rows of x / of B and C load as 16-byte words
  int64_t sxb, sxh, sxs;   // x (batch, head, position) strides
  int64_t sdb, sdh, sds;   // dt
  int64_t sbb, sbs;        // B (batch, position)
  int64_t scb, scs;        // C
  int64_t syb, syh, sys;   // y
};

// Stage positions [t0, t0 + qv) of a matrix whose rows (one a position,
// `cols` ≤ CAP valid columns, contiguous) lie `rs` elements apart into
// dst as float32 (row pitch `pitch`), zero padded to QT × CAP.  With
// `vec` (cols == CAP, every row 16-byte aligned) each thread moves whole
// 16-byte words, 16 / sizeof(T) elements at a time, several in flight.
template <typename T, int CAP>
__device__ __forceinline__ void stage(float* dst, int pitch,
                                      const T* __restrict__ src, int64_t rs,
                                      int t0, int qv, int cols, bool vec) {
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    constexpr int WORDS = CAP / V;               // per row
#pragma unroll 4
    for (int i = threadIdx.x; i < QT * WORDS; i += THREADS) {
      const int j = i / WORDS, c = (i % WORDS) * V;
      float v[V];
      if (j < qv) {
        unpack(*reinterpret_cast<const uint4*>(src + (int64_t)(t0 + j) * rs
                                               + c),
               v, T());
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) v[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < V; e += 4)
        *reinterpret_cast<float4*>(&dst[j * pitch + c + e]) =
            make_float4(v[e], v[e + 1], v[e + 2], v[e + 3]);
    }
  } else {
    for (int i = threadIdx.x; i < QT * CAP; i += THREADS) {
      const int j = i / CAP, c = i % CAP;
      dst[j * pitch + c] = (j < qv && c < cols)
                               ? to_f32(src[(int64_t)(t0 + j) * rs + c])
                               : 0.f;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1) ssd_scan_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* Bs = reinterpret_cast<float*>(smem4);   // QT × BP
  float* Cs = Bs + QT * BP;                      // QT × BP
  float* Xs = Cs + QT * BP;                      // QT × XP
  float* St = Xs + QT * XP;                      // NM × XP: state^T
  float* Ps = St + NM * XP;                      // RT × SP: scores
  float* cum = Ps + RT * SP;                     // QT
  float* dts = cum + QT;                         // QT
  float* wts = dts + QT;                         // QT

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const T* x = static_cast<const T*>(a.x) + b * a.sxb + h * a.sxh;
  const float* dt = a.dt + b * a.sdb + h * a.sdh;
  const T* Bg = static_cast<const T*>(a.B) + b * a.sbb;
  const T* Cg = static_cast<const T*>(a.C) + b * a.scb;
  T* y = static_cast<T*>(a.y) + b * a.syb + h * a.syh;
  const float A = a.A[h];

  // This thread's slice of the state: rows sp0..sp0+3, columns
  // sn0..sn0+3 and NM/2+sn0..NM/2+sn0+3.
  const int sp0 = 4 * (tid >> 4), sn0 = 4 * (tid & 15);
  float st[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) st[i][e] = 0.f;

  for (int t0 = 0; t0 < a.S; t0 += a.tile) {
    const int qv = min(a.tile, a.S - t0);

    // dt, the cumulative log-decay and the state weights (warp 0)
    if (warp == 0) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * lane + e;
        const float d = j < qv ? dt[(int64_t)(t0 + j) * a.sds] : 0.f;
        dts[j] = d;
        v[e] = d * A;
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
      // the lanes before this one, as the scan summed them (no
      // subtraction: cum_i − cum_j already cancels digits of |cum|)
      const float before = __shfl_up_sync(FULL, tot, 1);
      const float excl = lane == 0 ? 0.f : before;
      const float last = __shfl_sync(FULL, v[3] + excl, 31);   // cum[QT-1]
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * lane + e;
        const float c = v[e] + excl;
        cum[j] = c;
        wts[j] = dts[j] * expf(last - c);
      }
    }
    // x, B, C as float32, zero padded; the state transposed
    stage<T, PM>(Xs, XP, x, a.sxs, t0, qv, a.P, a.vec_x);
    stage<T, NM>(Bs, BP, Bg, a.sbs, t0, qv, a.N, a.vec_bc);
    stage<T, NM>(Cs, BP, Cg, a.scs, t0, qv, a.N, a.vec_bc);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int n = (e < 4 ? 0 : NM / 2) + sn0 + (e & 3);
      *reinterpret_cast<float4*>(&St[n * XP + sp0]) =
          make_float4(st[0][e], st[1][e], st[2][e], st[3][e]);
    }
    __syncthreads();

    const int passes = (qv + RT - 1) / RT;
    for (int r = 0; r < passes; ++r) {
      const int i0 = r * RT;
      {
        // scores of rows i0 + 4·ti + a, columns lane + 32·k (k ≤ r)
        const int ti = tid >> 5;
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[i][k] = 0.f;
        for (int n = 0; n < NM; n += 4) {
          float4 cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            cv[i] = ld4(&Cs[(i0 + 4 * ti + i) * BP + n]);
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (k <= r) bv[k] = ld4(&Bs[(lane + 32 * k) * BP + n]);
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (k <= r)
#pragma unroll
              for (int i = 0; i < 4; ++i)
                acc[i][k] = dot4(cv[i], bv[k], acc[i][k]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = i0 + 4 * ti + i;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (k > r) continue;
            const int j = lane + 32 * k;
            // select before exp: above the diagonal exp may be inf
            Ps[(4 * ti + i) * SP + j] =
                (j <= row && row < qv)
                    ? acc[i][k] * expf(cum[row] - cum[j]) * dts[j]
                    : 0.f;
          }
        }
      }
      __syncthreads();
      {
        // output rows i0 + 2·ti + a, columns 4·tp..4·tp+3
        const int ti = tid >> 4, tp = tid & 15;
        float4 intra[2], inter[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          intra[i] = make_float4(0.f, 0.f, 0.f, 0.f);
          inter[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
        const int jend = (r + 1) * RT;
        for (int j = 0; j < jend; j += 4) {
          float4 pv[2], xv[4];
#pragma unroll
          for (int i = 0; i < 2; ++i) pv[i] = ld4(&Ps[(2 * ti + i) * SP + j]);
#pragma unroll
          for (int c = 0; c < 4; ++c) xv[c] = ld4(&Xs[(j + c) * XP + 4 * tp]);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c) fma4(intra[i], comp(pv[i], c), xv[c]);
        }
        for (int n = 0; n < NM; n += 4) {
          float4 cv[2], sv[4];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            cv[i] = ld4(&Cs[(i0 + 2 * ti + i) * BP + n]);
#pragma unroll
          for (int c = 0; c < 4; ++c) sv[c] = ld4(&St[(n + c) * XP + 4 * tp]);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c) fma4(inter[i], comp(cv[i], c), sv[c]);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = i0 + 2 * ti + i;
          if (row >= qv) continue;
          const float e = expf(cum[row]);
          T* yr = y + (int64_t)(t0 + row) * a.sys;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int p = 4 * tp + c;
            if (p < a.P) from_f32(yr + p, comp(intra[i], c) + e * comp(inter[i], c));
          }
        }
      }
      __syncthreads();
    }

    // state ← exp(cum_last)·state + Σ_j (x_j·w_j) ⊗ B_j
    {
      float upd[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e) upd[i][e] = 0.f;
      for (int j = 0; j < qv; ++j) {
        const float w = wts[j];
        const float4 xv = ld4(&Xs[j * XP + sp0]);
        const float xw[4] = {xv.x * w, xv.y * w, xv.z * w, xv.w * w};
        const float4 b0 = ld4(&Bs[j * BP + sn0]);
        const float4 b1 = ld4(&Bs[j * BP + NM / 2 + sn0]);
        const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 8; ++e) upd[i][e] = fmaf(xw[i], bb[e], upd[i][e]);
      }
      const float decay = expf(cum[QT - 1]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e) st[i][e] = decay * st[i][e] + upd[i][e];
    }
    __syncthreads();
  }

  float* so = a.state + (int64_t)bh * a.P * a.N;    // (B, H, P, N)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = sp0 + i;
    if (p >= a.P) continue;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int n = (e < 4 ? 0 : NM / 2) + sn0 + (e & 3);
      if (n < a.N) so[(int64_t)p * a.N + n] = st[i][e];
    }
  }
}

// The opt-in above 48 KB of shared memory holds per function and device,
// so each template instance asks once per device (a repeat is harmless).
constexpr int MAX_DEVICES = 64;

template <typename T>
int launch(const Args& a, int batch, cudaStream_t stream) {
  const size_t smem = sizeof(float) * SMEM_FLOATS;
  auto kern = ssd_scan_kernel<T>;
  static std::atomic<bool> opted_in[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= MAX_DEVICES || !opted_in[dev].load()) {
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < MAX_DEVICES) opted_in[dev].store(true);
  }
  kern<<<batch * a.H, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: (B, H, S, P); dt: (B, H, S) float32; A: (H,) float32 contiguous;
// B, C: (B, S, N); each by element strides with a contiguous last axis
// (y by its own strides; dt's position stride may be anything).  x, B, C
// and y all float32 (bf16 = 0) or all bf16 (bf16 = 1).  state: (B, H, P,
// N) float32 contiguous.  P ≤ 64, N ≤ 128, 1 ≤ tile ≤ 128: the scan walks
// S in tiles of `tile` positions (a last partial tile is masked).
// Launches on `stream`, allocates nothing, returns the CUDA error code
// (0 on success).
extern "C" int ssd_scan(const void* x, const float* dt, const float* A,
                        const void* B, const void* C, void* y, float* state,
                        int bf16, int batch, int H, int S, int P, int N,
                        int tile, long long sxb, long long sxh, long long sxs,
                        long long sdb, long long sdh, long long sds,
                        long long sbb, long long sbs, long long scb,
                        long long scs, long long syb, long long syh,
                        long long sys, void* stream) {
  if (batch == 0 || H == 0) return 0;
  if (P < 1 || P > PM || N < 1 || N > NM || tile < 1 || tile > QT || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int elt = bf16 ? 2 : 4;
  const auto aligned = [elt](const void* p, std::initializer_list<long long>
                                                strides) {
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
    for (const long long s : strides)
      if ((s * elt) % 16) return false;
    return true;
  };
  const int vec_x = P == PM && aligned(x, {sxb, sxh, sxs});
  const int vec_bc = N == NM && aligned(B, {sbb, sbs}) && aligned(C, {scb, scs});
  Args a{x,   dt,  A,   B,   C,      y,   state, H,   S,   P,   N,
         tile, vec_x, vec_bc, sxb, sxh, sxs, sdb, sdh, sds, sbb, sbs,
         scb, scs, syb, syh, sys};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(a, batch, st)
              : launch<float>(a, batch, st);
}
