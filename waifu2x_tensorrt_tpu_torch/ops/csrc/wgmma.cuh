// Warpgroup tensor-core primitives for sm_90a (Hopper's wgmma): the
// shared-memory matrix descriptor of the 128-byte-swizzled K-major layout,
// its address function, the fence / commit / wait steps of an asynchronous
// product, and m64n32 products with both operands in shared memory or A
// from registers (bf16 -> fp32 k16, s8 -> s32 k32). Used by kernel F
// (mma_probe.cu); written to be included by any kernel that runs its
// products on wgmma.
//
// Operand layout (K-major, 128-byte swizzle, PTX ISA "matrix descriptor"):
// a (rows x kbytes) operand is cut into column blocks of 128 bytes of K;
// block j holds every row's bytes [128 j, 128 j + 128) as rows x 128 bytes,
// row r at r * 128, and its 16-byte chunk c at chunk c ^ (r % 8). Blocks
// are 1024-byte aligned, so the hardware's swizzle (address bits 4-6 XOR
// bits 7-9) is this one. One k step (32 bytes of K: k16 bf16, k32 s8) of
// rows [0, 64) or [0, N) is the descriptor of the block's base plus 32 s
// bytes for step s of the block; 8-row groups lie 1024 bytes apart (SBO).
// The accumulator of an m64nN product (PTX ISA "wgmma D fragment"): thread
// t of the warpgroup, warp w = t / 32, lane = 4 g + q, holds N / 2 values;
// value i is row 16 w + g + 8 ((i / 2) % 2), column 8 (i / 4) + 2 q + i % 2.
#pragma once

#include <stdint.h>

namespace w2x {
namespace wg {

// byte offset of (row, kbyte) in a K-major 128-byte-swizzled operand of
// `rows` rows (rows a multiple of 8)
__host__ __device__ __forceinline__ uint32_t sw128_offset(uint32_t row,
                                                          uint32_t kbyte,
                                                          uint32_t rows) {
  return (kbyte >> 7) * rows * 128 + row * 128 +
         ((((kbyte >> 4) & 7) ^ (row & 7)) << 4) + (kbyte & 15);
}

// descriptor of the K-major 128-byte-swizzled operand whose k step starts
// at shared address `saddr`: start address >> 4 (bits 0-13), leading byte
// offset 16 (unused by this layout; bits 16-29), stride byte offset 1024
// between 8-row groups (bits 32-45), base offset 0, layout 1 = 128-byte
// swizzle (bits 62-63)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// st.shared writes become visible to wgmma's (async proxy) reads after this
// and a barrier
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// before the first wgmma of a group whose registers other instructions used
__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups of the warpgroup are in flight
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins an accumulator register at this point of the program: the compiler
// may not move its reads above a wait, nor its writes below an issue.
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void fence_operand(int& r) {
  asm volatile("" : "+r"(r)::"memory");
}
template <typename Acc, int N>
__device__ __forceinline__ void fence_operands(Acc (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_operand(d[i]);
}

// d = a b (+ d when `accumulate`): Mma<N, float> is m64nNk16 with bf16
// operands, Mma<N, int> m64nNk32 with s8 operands, a (64 x 32 bytes of K)
// and b (N x 32 bytes of K) from shared memory (descriptors), d 64 x N
// (N / 2 values a thread, in the fragment map above)
template <int N, typename Acc>
struct Mma;

template <>
struct Mma<32, float> {
  static __device__ __forceinline__ void run(float (&d)[16], uint64_t da,
                                             uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
        "%13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(accumulate));
  }
};

template <>
struct Mma<32, int> {
  static __device__ __forceinline__ void run(int (&d)[16], uint64_t da,
                                             uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
        "%13, %14, %15"
        "}, %16, %17, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15])
        : "l"(da), "l"(db), "r"(accumulate));
  }
};

// d = a b (+ d when `accumulate`) with a from registers: MmaRegA<N, float>
// is m64nNk16 with bf16 operands, MmaRegA<N, int> m64nNk32 with s8. Warp w
// of the warpgroup gives rows 16 w .. 16 w + 15 of a; with lane = 4 g + q,
// a[0] holds bytes 4 q .. 4 q + 3 of the k step's 32 bytes of row g, a[1]
// the same of row g + 8, a[2] and a[3] bytes 16 + 4 q .. of rows g and
// g + 8 (PTX ISA "wgmma register fragment A", the mma.sync m16n8k16 /
// m16n8k32 A layout). b is read from shared memory (descriptor).
template <int N, typename Acc>
struct MmaRegA;

template <>
struct MmaRegA<32, float> {
  static __device__ __forceinline__ void run(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
        "%13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(accumulate));
  }
};

template <>
struct MmaRegA<32, int> {
  static __device__ __forceinline__ void run(int (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
        "%13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(accumulate));
  }
};

}  // namespace wg
}  // namespace w2x
