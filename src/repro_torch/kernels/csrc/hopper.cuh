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

// wgmma matrix descriptor of a swizzled tile at shared address `addr`,
// any swizzle: `layout` 1 (128-byte), 2 (64-byte) or 3 (32-byte), the
// offsets in bytes.  A K-major tile ignores `lbo` and takes the 8-row atom
// as `sbo`.  An MN-major tile (M or N contiguous, rows along K) is a
// column of blocks, each a swizzle width of M or N by every K row:
// `lbo` steps from block to block, `sbo` from 8 K rows to the next 8.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

// The descriptor of a K-major tile in the 128-byte swizzle: the leading
// byte offset unused, the stride byte offset one 8-row atom (1024 bytes).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return smem_desc(addr, 16, 1024, 1);
}

// Byte offset `o` in a tile with rows of `width` bytes (32, 64 or 128)
// under that width's swizzle: 16-byte chunk c of row r lands at chunk
// c ^ (r's bits that the swizzle folds in), the tile 1024-byte aligned.
// At width 128 this is sw128.
__device__ __forceinline__ uint32_t swizzle(uint32_t o, int width) {
  return o ^ ((o >> 3) & static_cast<uint32_t>((width / 16 - 1) << 4));
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
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
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

// m64n64 accumulator: 32 registers, laid out as the m64n128 one's first
// 32 (columns 0..63).
#define HOPPER_D8(c, i) HOPPER_D4(c, i), HOPPER_D4(c, i + 4)
#define HOPPER_D24(c) HOPPER_D16(c, 0), HOPPER_D8(c, 16)
#define HOPPER_D32(c) HOPPER_D16(c, 0), HOPPER_D16(c, 16)
#define HOPPER_D40(c) HOPPER_D32(c), HOPPER_D8(c, 32)
#define HOPPER_D48(c) HOPPER_D32(c), HOPPER_D16(c, 32)
#define HOPPER_D56(c) HOPPER_D48(c), HOPPER_D8(c, 48)
#define HOPPER_REGS8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define HOPPER_REGS16 HOPPER_REGS8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define HOPPER_REGS24 \
  HOPPER_REGS16 ", %16, %17, %18, %19, %20, %21, %22, %23"
#define HOPPER_REGS32 \
  HOPPER_REGS24 ", %24, %25, %26, %27, %28, %29, %30, %31"
#define HOPPER_REGS40 \
  HOPPER_REGS32 ", %32, %33, %34, %35, %36, %37, %38, %39"
#define HOPPER_REGS48 \
  HOPPER_REGS40 ", %40, %41, %42, %43, %44, %45, %46, %47"
#define HOPPER_REGS56 \
  HOPPER_REGS48 ", %48, %49, %50, %51, %52, %53, %54, %55"
#define HOPPER_REGS64 \
  HOPPER_REGS56 ", %56, %57, %58, %59, %60, %61, %62, %63"

// bf16 × bf16 -> float32, 64 columns, both operands K-major in shared
// memory.
__device__ __forceinline__ void wgmma_bf16_n64(float (&d)[32], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
               HOPPER_REGS32 "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
               : HOPPER_D32("+f")
               : "l"(da), "l"(db), "r"(scale_d));
}

// d += A·B over 16 values of K, bf16 × bf16 -> float32, N columns: A from
// registers (4 a thread, each two bf16 of one row, in the m64n16
// accumulator's order: a[0] row l/4, columns 2·(l%4) + {0, 1}; a[1] the
// same 8 rows down; a[2], a[3] the same 8 columns on), B MN-major in
// shared memory (the transposed form: N contiguous).  d has N / 2
// registers a thread.
template <int N> struct WgmmaRsBf16MnB;
#define HOPPER_WGMMA_RS_MN(N, REGS, DLIST, A0, A1, A2, A3, B, S)           \
  template <> struct WgmmaRsBf16MnB<N> {                                    \
    static __device__ __forceinline__ void run(float (&d)[N / 2],         \
                                               const uint32_t (&a)[4],    \
                                               uint64_t db) {             \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #S ", 0;\n"       \
                   "wgmma.mma_async.sync.aligned.m64n" #N                  \
                   "k16.f32.bf16.bf16 {" REGS "}, {%" #A0 ", %" #A1       \
                   ", %" #A2 ", %" #A3 "}, %" #B ", p, 1, 1, 1;\n}\n"       \
                   : DLIST                                                 \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),  \
                     "r"(1));                                              \
    }                                                                      \
  };
HOPPER_WGMMA_RS_MN(16, HOPPER_REGS8, HOPPER_D8("+f", 0), 8, 9, 10, 11, 12,
                   13)
HOPPER_WGMMA_RS_MN(32, HOPPER_REGS16, HOPPER_D16("+f", 0), 16, 17, 18, 19,
                   20, 21)
HOPPER_WGMMA_RS_MN(48, HOPPER_REGS24, HOPPER_D24("+f"), 24, 25, 26, 27, 28,
                   29)
HOPPER_WGMMA_RS_MN(64, HOPPER_REGS32, HOPPER_D32("+f"), 32, 33, 34, 35, 36,
                   37)
HOPPER_WGMMA_RS_MN(80, HOPPER_REGS40, HOPPER_D40("+f"), 40, 41, 42, 43, 44,
                   45)
HOPPER_WGMMA_RS_MN(96, HOPPER_REGS48, HOPPER_D48("+f"), 48, 49, 50, 51, 52,
                   53)
HOPPER_WGMMA_RS_MN(112, HOPPER_REGS56, HOPPER_D56("+f"), 56, 57, 58, 59, 60,
                   61)
HOPPER_WGMMA_RS_MN(128, HOPPER_REGS64, HOPPER_D64("+f"), 64, 65, 66, 67, 68,
                   69)
#undef HOPPER_WGMMA_RS_MN

}  // namespace hopper
