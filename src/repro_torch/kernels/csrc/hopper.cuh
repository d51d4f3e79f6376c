// Hopper (sm_90a) building blocks for the port's hand-written kernels:
// shared-memory addresses, asynchronous copies (cp.async), the proxy
// fence, and warpgroup matrix multiplies (wgmma) on K-major operand
// tiles laid out with the 128-byte swizzle.
//
// The swizzled K-major tile: rows (M or N) of 128 bytes of K, the 16-byte
// chunk c of row r stored at chunk position c ^ (r % 8), 8-row atoms of
// 1024 bytes, the tile 1024-byte aligned.  One m64nNk32 (8-bit) or
// m64nNk16 (bf16) instruction reads 32 bytes of K per row; the next one
// starts 32 bytes further, which is descriptor + 2 (16-byte units).

#pragma once

#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// chunk position of 16-byte chunk c of row r in a swizzled tile
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return static_cast<uint32_t>(r * 128 + ((c ^ (r & 7)) << 4));
}

// wgmma matrix descriptor of a swizzled K-major tile at shared address
// `addr`: the leading byte offset is unused by swizzled K-major layouts,
// the stride byte offset is one 8-row atom (1024 bytes).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// 16 bytes global -> shared, asynchronous; src_bytes 0 zero-fills.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint32_t a,
                                             uint32_t b, uint32_t c,
                                             uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "r"(a), "r"(b), "r"(c), "r"(d) : "memory");
}

// Generic-proxy shared-memory writes (st.shared, cp.async) made visible
// to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across a
// wgmma fence or wait.
template <int N>
__device__ __forceinline__ void reg_fence(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// m64n128 accumulator fragment: 64 registers a thread.  Register
// 4j + h of lane l in warp w of the warpgroup holds row
// 16w + l/4 + 8·(h/2), column 8j + 2·(l%4) + h%2.
#define HOPPER_D4(c, i) c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3])
#define HOPPER_D16(c, i) HOPPER_D4(c, i), HOPPER_D4(c, i + 4), \
    HOPPER_D4(c, i + 8), HOPPER_D4(c, i + 12)
#define HOPPER_D64(c) HOPPER_D16(c, 0), HOPPER_D16(c, 16), \
    HOPPER_D16(c, 32), HOPPER_D16(c, 48)
#define HOPPER_D64_OPERANDS                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "    \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "    \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
#define HOPPER_SCALE_D "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"

// d (+)= A·B over 32 bytes of K: int8 × int8 -> exact int32.
// scale_d 0 overwrites d, 1 accumulates.
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(HOPPER_SCALE_D
               "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
               HOPPER_D64_OPERANDS "%64, %65, p;\n}\n"
               : HOPPER_D64("+r")
               : "l"(da), "l"(db), "r"(scale_d));
}

// e4m3 × e4m3 -> float32 accumulator (the tensor core's own summation).
__device__ __forceinline__ void wgmma_e4m3(float (&d)[64], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(HOPPER_SCALE_D
               "wgmma.mma_async.sync.aligned.m64n128k32.f32.e4m3.e4m3 "
               HOPPER_D64_OPERANDS "%64, %65, p, 1, 1;\n}\n"
               : HOPPER_D64("+f")
               : "l"(da), "l"(db), "r"(scale_d));
}

// bf16 × bf16 -> float32 over 16 values of K, both operands K-major.
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(HOPPER_SCALE_D
               "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
               HOPPER_D64_OPERANDS "%64, %65, p, 1, 1, 0, 0;\n}\n"
               : HOPPER_D64("+f")
               : "l"(da), "l"(db), "r"(scale_d));
}

}  // namespace hopper
