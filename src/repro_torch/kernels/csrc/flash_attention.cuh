// What the flash attention kernels of flash_attention.cu (the forward)
// and flash_attention_bwd.cu (the backward) share: element strides, the
// staged row's pitch, staging q, k, v or dO rows into shared memory,
// reading them back as float32, and splitting a float32 pair in two bf16
// terms for the tensor cores.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

struct Strides {
  int64_t b, h, s;
};

// A staged q, k or v row: D elements in an odd number of 16-byte chunks,
// so that 8 neighbouring rows start in 8 different bank groups.
__host__ __device__ inline int row_pitch(int D, int esize) {
  return (((D * esize + 15) / 16) | 1) * 16;
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

// Rows [row0, row0 + n) of one head into shared memory as they lie, rows
// past S zero-filled: 16-byte cp.async (VEC), else element by element with
// the chunk past D zero-filled.  NT: the block's threads.
template <typename T, int DMAX, bool VEC, int NT>
__device__ __forceinline__ void stage(uint8_t* dst, int pitch,
                                      const T* __restrict__ src, int64_t ss,
                                      int row0, int n, int S, int D) {
  using R = typename std::conditional<sizeof(T) == 4, uint32_t,
                                      uint16_t>::type;  // raw bits
  constexpr int EV = 16 / sizeof(T);      // elements per chunk
  constexpr int CPR = DMAX / EV;          // chunks per row, at most
  const int cpr = (D + EV - 1) / EV;
  for (int i = threadIdx.x; i < n * CPR; i += NT) {
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

// Two bf16 terms of (p0, p1), packed as an A-fragment register each:
// hi = bf16(p), lo = bf16(p − hi); the low half holds p0.
__device__ __forceinline__ void split_pair(float p0, float p1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(p0 - hf.x, p1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

}  // namespace
