// Hopper (sm_90a) building blocks of the port's tensor-core kernels: PTX
// wrappers for cp.async, ldmatrix, the async-proxy fence and wgmma, and the
// swizzled 16-bit shared-memory tile that wgmma reads. Included by
// flash_wgmma.cuh (K2, K3, K4a, K4b) and conv3x3_stats.cu (K5).
//
// The element type T of a product is bf16 (__nv_bfloat16) or fp16 (__half):
// wgmma.mma_async takes both with the same shapes, layouts, swizzle and
// transpose bits, and only the type in the instruction (.f32.bf16.bf16 or
// .f32.f16.f16) and the float-to-pair rounding (pack2) differ.
//
// A wgmma product is issued by one warpgroup (128 threads) on a 64-row
// tile: A (64 x 16 a k step) from shared memory through a descriptor or
// from registers, B (16 x N) from shared memory, D (64 x N) float32 in
// registers. A thread's accumulator register i holds row r0 + 8 ((i >> 1)
// & 1) and column 8 (i / 4) + cq + (i & 1), r0 = 16 warp + lane / 4, cq =
// 2 (lane % 4); the register form of A is that of mma.m16n8k16, one warp a
// 16-row slice: four 16-bit pairs, rows r0 and r0 + 8 by columns cq and cq +
// 8 of the k step.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace sm90 {

using bf16 = __nv_bfloat16;
using f16 = __half;

constexpr int kRows = 64;      // rows of a wgmma tile (M, or K of a B tile)
constexpr int kThreads = 128;  // one warpgroup

// ------------------------------------------------------------ PTX wrappers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; src_bytes 0 writes zeros and reads
// nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Generic-proxy writes to shared memory (cp.async, st.shared) made visible
// to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// Four 8 x 8 16-bit matrices from shared memory: lanes 8 m .. 8 m + 7 give
// the 16-byte row addresses of matrix m, and r[m] holds row lane / 4,
// columns 2 (lane % 4) and 2 (lane % 4) + 1 of it. With lane l addressing
// row l % 16 and columns 8 (l / 16) .. + 7 of a 16 x 16 slice, r is that
// slice's register A fragment.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across its issue or its wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N, int M>
__device__ __forceinline__ void fence_regs(float (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_regs(r[i]);
}

__device__ __forceinline__ void fence_regs(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Two float32 as a pair of T (bf16 or fp16), the first in the low half
// (round to nearest).
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same_v<T, f16>) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    static_assert(std::is_same_v<T, bf16>, "T is bf16 or fp16");
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// A wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle (1: 128 bytes, 2: 64 bytes).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t swizzle) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (swizzle << 62);
}

// ------------------------------------------------------------ wgmma

// The asm of each product, with TY the element type's PTX name ("bf16" or
// "f16"); the wrappers below pick it from T.
#define SM90_ACC32                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),     \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),     \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),     \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31])
#define SM90_ACC16                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define SM90_D32                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7,"                       \
  "%8, %9, %10, %11, %12, %13, %14, %15,"                  \
  "%16, %17, %18, %19, %20, %21, %22, %23,"                \
  "%24, %25, %26, %27, %28, %29, %30, %31}, "
#define SM90_D16                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7,"                       \
  "%8, %9, %10, %11, %12, %13, %14, %15}, "
#define SM90_WGMMA_SS_N64(TY)                                               \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                 \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "  \
               SM90_D32 "%32, %33, p, 1, 1, %35, %36;\n}\n"                 \
               : SM90_ACC32                                                 \
               : "l"(da), "l"(db), "r"(accumulate), "n"(kTA), "n"(kTB))
#define SM90_WGMMA_SS_N32(TY)                                               \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                 \
               "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " "  \
               SM90_D16 "%16, %17, p, 1, 1, %19, %20;\n}\n"                 \
               : SM90_ACC16                                                 \
               : "l"(da), "l"(db), "r"(accumulate), "n"(kTA), "n"(kTB))
#define SM90_WGMMA_RS_N64(TY)                                               \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                 \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "  \
               SM90_D32 "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"     \
               : SM90_ACC32                                                 \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),       \
                 "r"(accumulate), "n"(kTB))
#define SM90_WGMMA_RS_N32(TY)                                               \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                 \
               "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " "  \
               SM90_D16 "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"     \
               : SM90_ACC16                                                 \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),       \
                 "r"(accumulate), "n"(kTB))

// D (64 x 64, float32) += A (64 x 16) * B (16 x 64), both T in shared
// memory through their descriptors; kTA / kTB: 0 K-major, 1 MN-major.
template <typename T, int kTA, int kTB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  if constexpr (std::is_same_v<T, f16>)
    SM90_WGMMA_SS_N64("f16");
  else
    SM90_WGMMA_SS_N64("bf16");
}

// D (64 x 32, float32) += A (64 x 16) * B (16 x 32), both T in shared
// memory through their descriptors; kTA / kTB: 0 K-major, 1 MN-major.
template <typename T, int kTA, int kTB>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int accumulate) {
  if constexpr (std::is_same_v<T, f16>)
    SM90_WGMMA_SS_N32("f16");
  else
    SM90_WGMMA_SS_N32("bf16");
}

// D (64 x 64, float32) += A (64 x 16, T pairs in registers) * B (16 x 64,
// T in shared memory); kTB: 0 K-major, 1 MN-major.
template <typename T, int kTB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  if constexpr (std::is_same_v<T, f16>)
    SM90_WGMMA_RS_N64("f16");
  else
    SM90_WGMMA_RS_N64("bf16");
}

// D (64 x 32, float32) += A (64 x 16, T pairs in registers) * B (16 x 32,
// T in shared memory); kTB: 0 K-major, 1 MN-major.
template <typename T, int kTB>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  if constexpr (std::is_same_v<T, f16>)
    SM90_WGMMA_RS_N32("f16");
  else
    SM90_WGMMA_RS_N32("bf16");
}

#undef SM90_WGMMA_RS_N32
#undef SM90_WGMMA_RS_N64
#undef SM90_WGMMA_SS_N32
#undef SM90_WGMMA_SS_N64
#undef SM90_D16
#undef SM90_D32
#undef SM90_ACC16
#undef SM90_ACC32

// The products at a tile's column-block width: n64, or n32.
template <typename T, int N, int kTA, int kTB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (N == 64)
    wgmma_ss_n64<T, kTA, kTB>(d, da, db, accumulate);
  else
    wgmma_ss_n32<T, kTA, kTB>(d, da, db, accumulate);
}

template <typename T, int N, int kTB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  if constexpr (N == 64)
    wgmma_rs_n64<T, kTB>(d, a, db, accumulate);
  else
    wgmma_rs_n32<T, kTB>(d, a, db, accumulate);
}

// --------------------------------------------------------------- tiles

// A [64, D] tile of 16-bit elements (bf16 or fp16) in shared memory,
// 1024-byte aligned: kBlocks column blocks of kCols values, each 64 rows
// of kRowBytes, swizzled.
template <int D>
struct Tile {
  static constexpr int kCols = D < 64 ? D : 64;
  static constexpr int kBlocks = D / kCols;
  static constexpr int kRowBytes = kCols * 2;  // 128, or 64 at D 32
  static constexpr int kBlockBytes = kRows * kRowBytes;
  static constexpr int kBytes = kBlocks * kBlockBytes;
  static constexpr uint64_t kSwizzle = kRowBytes == 128 ? 1 : 2;
  // The hardware XORs bits 4-6 (128-byte swizzle) or 4-5 (64-byte) of an
  // address with bits 7-9 (or 7-8).
  static constexpr uint32_t kSwizzleMask = kRowBytes == 128 ? 0x70 : 0x30;
  // 8 rows: the stride between the 8-row groups of the swizzle atom.
  static constexpr uint32_t kGroupBytes = 8 * kRowBytes;

  // Byte offset of element (r, c); c even.
  static __device__ __forceinline__ uint32_t offset(int r, int c) {
    const uint32_t off =
        (c / kCols) * kBlockBytes + r * kRowBytes + (c % kCols) * 2;
    return off ^ ((off >> 3) & kSwizzleMask);
  }

  // The tile as a K-major operand (rows are M or N, columns K): the 16
  // columns of k step kk.
  static __device__ __forceinline__ uint64_t k_major(uint32_t base, int kk) {
    const int c = kk * 16;
    return make_desc(base + (c / kCols) * kBlockBytes + (c % kCols) * 2, 16,
                     kGroupBytes, kSwizzle);
  }

  // The tile as an MN-major operand (rows are K, columns N): rows
  // [16 kk, 16 kk + 16) of column block b. N is one swizzle atom wide, so
  // the only stride the product walks is the one between 8-row groups;
  // both offsets carry it.
  static __device__ __forceinline__ uint64_t mn_major(uint32_t base, int b,
                                                     int kk) {
    return make_desc(base + b * kBlockBytes + kk * 16 * kRowBytes,
                     kGroupBytes, kGroupBytes, kSwizzle);
  }
};

}  // namespace sm90
