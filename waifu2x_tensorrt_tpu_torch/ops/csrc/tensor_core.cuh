// Warp-level tensor-core and async-copy primitives for sm_80+ (used by
// the bf16 paths of kernels A, B and E): ldmatrix fragment loads,
// mma.sync m16n8k16 with bf16 operands and fp32 accumulators, and 16-byte
// cp.async copies. The warpgroup (wgmma) primitives of sm_90a are in
// wgmma.cuh.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 .bf16), lane = 4 * g + t:
//   A (16 x 16, row-major), 4 regs of 2 bf16: a0 = (row g, k 2t..2t+1),
//     a1 = (row g+8, k 2t..), a2 = (row g, k 2t+8..), a3 = (row g+8, k 2t+8..)
//   B (16 x 8, "col"), 2 regs: b0 = (k 2t..2t+1, col g), b1 = (k 2t+8.., g)
//   C/D (16 x 8 fp32): c0, c1 = (row g, cols 2t, 2t+1); c2, c3 = row g+8
// So the accumulators of two neighbouring n8 tiles, rounded to bf16 in
// pairs, are the A fragment of one k16 step (to_a_frag): a product's
// output feeds the next product from registers.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace w2x {
namespace tc {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lane l gives the row address of matrix l / 8,
// row l % 8. Register i holds matrix i's (row g, cols 2t, 2t+1).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// As ldsm_x4, each matrix transposed: register i holds matrix i's
// (rows 2t, 2t+1 of column g).
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a * b on the tensor cores (bf16 operands, fp32 accumulate)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 values rounded (to nearest even) to a bf16 pair, lo in the low
// half: the lower k / column index
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The accumulators of n8 tiles 2s and 2s+1 as the A fragment of k16 step s
// (values rounded to bf16).
__device__ __forceinline__ void to_a_frag(uint32_t (&a)[4], const float (&lo)[4],
                                          const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace tc
}  // namespace w2x
