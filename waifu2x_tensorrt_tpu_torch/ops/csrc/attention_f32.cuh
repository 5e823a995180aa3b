// The fp32 window-attention core of kernels A, B and E on the CUDA cores:
// one warp computes one head for 4 RR query rows of a 64-token window
// (RR = 4: 16 rows, RR = 2: 8), with the scores and probabilities in
// registers.
//
// For rows r0..r0+4RR-1 and one head of dim 32, operands fp32 in shared
// memory (q and k rows at stride LDQK, v rows at stride LDV):
//   s = bias_h + (q * scale) k^T          4RR x 64 fp32, registers
//   p = softmax(s) over the kept entries  masked entries exactly 0
//   o = p v                               4RR x 32, returned in registers
// as fp32 FMA on the CUDA cores (no TF32: "fp32 means fp32"). The rounding
// points are those of window_attention_qkv_plain (ops/window_attention.py)
// and of the TPU kernels' bodies (_kernel_qkv, _block_body) in fp32: q *
// scale is an fp32 product, scores, softmax and p v are fp32; only the
// order of the fp32 sums differs.
//
// Lane l = 8 * rg + cg owns rows r0 + rg + 4 i (i < RR) and, of the
// scores, columns cg + 8 jj (jj = 0..7), of the output columns 4 cg ..
// 4 cg + 3. q k^T reads q and k as float4 (128-bit shared loads, 4 RR
// FMAs a k load); the k rows 8 lanes read at once, and the q rows of the 4
// lane groups, are neighbours, which the odd 16-byte stride LDQK puts in
// different bank groups. A row's
// max and sum reduce over its 8 lanes by shuffles. p v takes each
// probability from its lane by a shuffle and v's row as a float4, so no
// probability is stored.
#pragma once

#include "common.cuh"

namespace w2x {
namespace attn_f32 {

constexpr int LDQK = HD + 4;   // q and k row stride (floats): 9 x 16 bytes
constexpr int LDV = HD;        // v row stride
// jnp.asarray(32 ** -0.5, float32)
constexpr float kScale = 0.17677669529663687f;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float group_max(float v) {  // over 8 lanes
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
}

__device__ __forceinline__ float group_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v + __shfl_xor_sync(0xffffffffu, v, 4);
}

// Which of this lane's 8 RR score entries of rows r0.. cross a shift
// seam: bit 8i + jj stands for row r0 + rg + 4i, column cg + 8 jj; `row`
// for the row seam (flag bit 0), `col` for the column seam (bit 1). From
// keep_entry, so the law stays bit-exact with kernel_math; both 0 for
// shift 0. Independent of the window: computed once a kernel.
struct Crossings {
  uint32_t row, col;
};

template <int RR>
__device__ __forceinline__ Crossings crossings(int r0, int shift) {
  const int lane = threadIdx.x & 31, rg = lane >> 3, cg = lane & 7;
  Crossings c{0u, 0u};
#pragma unroll
  for (int i = 0; i < RR; ++i)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int row = r0 + rg + 4 * i, col = cg + 8 * jj;
      const uint32_t bit = 1u << (8 * i + jj);
      if (!keep_entry(1, row, col, shift)) c.row |= bit;
      if (!keep_entry(2, row, col, shift)) c.col |= bit;
    }
  return c;
}

// keep bits of a window with these flags: keep_entry(flags, i, j, shift)
__device__ __forceinline__ uint32_t keep_bits(Crossings c, int flags) {
  return ~(((flags & 1) ? c.row : 0u) | ((flags & 2) ? c.col : 0u));
}

// A head's (64, 64) fp32 relative bias (global) at this lane's 8 RR score
// entries of rows r0...
template <int RR>
__device__ __forceinline__ void load_bias(float (&b)[RR][8],
                                          const float* __restrict__ bias,
                                          int r0) {
  const int lane = threadIdx.x & 31, rg = lane >> 3, cg = lane & 7;
#pragma unroll
  for (int i = 0; i < RR; ++i)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
      b[i][jj] = __ldg(bias + (r0 + rg + 4 * i) * NTOK + cg + 8 * jj);
}

// One head for rows r0..r0+4RR-1. q, k: row 0 of the head's q and k
// blocks (64 rows at stride LDQK, 16-byte aligned); v: row 0 of its v
// block (stride LDV). bias: load_bias of the head; keep: keep_bits of the
// window. o[i][e] = output row r0 + rg + 4i, column 4 cg + e.
template <int RR>
__device__ __forceinline__ void head_attention(const float* q, const float* k,
                                               const float* v, int r0,
                                               const float (&bias)[RR][8],
                                               uint32_t keep,
                                               float (&o)[RR][4]) {
  const int lane = threadIdx.x & 31, rg = lane >> 3, cg = lane & 7;
  // scores start from the bias, or from -inf where the shift mask drops
  // the entry: the row max then skips it and its exp is exactly 0
  float s[RR][8];
#pragma unroll
  for (int i = 0; i < RR; ++i)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
      s[i][jj] = (keep >> (8 * i + jj) & 1) ? bias[i][jj] : -INFINITY;
  // s += (q * scale) k^T, four d at a time
  const float* qr = q + (r0 + rg) * LDQK;
  const float* kr = k + cg * LDQK;
#pragma unroll
  for (int d = 0; d < HD; d += 4) {
    float qa[RR][4];
#pragma unroll
    for (int i = 0; i < RR; ++i) {
      const float4 t = ld4(qr + 4 * i * LDQK + d);
      qa[i][0] = t.x * kScale;
      qa[i][1] = t.y * kScale;
      qa[i][2] = t.z * kScale;
      qa[i][3] = t.w * kScale;
    }
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float4 kv = ld4(kr + 8 * jj * LDQK + d);
#pragma unroll
      for (int i = 0; i < RR; ++i) {
        s[i][jj] = fmaf(qa[i][0], kv.x, s[i][jj]);
        s[i][jj] = fmaf(qa[i][1], kv.y, s[i][jj]);
        s[i][jj] = fmaf(qa[i][2], kv.z, s[i][jj]);
        s[i][jj] = fmaf(qa[i][3], kv.w, s[i][jj]);
      }
    }
  }
  // exact softmax over the kept entries
#pragma unroll
  for (int i = 0; i < RR; ++i) {
    float m = s[i][0];
#pragma unroll
    for (int jj = 1; jj < 8; ++jj) m = fmaxf(m, s[i][jj]);
    m = group_max(m);
    float sum = 0.f;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      s[i][jj] = expf(s[i][jj] - m);
      sum += s[i][jj];
    }
    sum = group_sum(sum);
    // p = e / sum, correctly rounded: the row's correctly rounded
    // reciprocal, a product, and one exact-remainder correction
    // (Markstein; tests/test_torch_block_math.py)
    const float r = __frcp_rn(sum);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float x = s[i][jj] * r;
      s[i][jj] = fmaf(fmaf(-x, sum, s[i][jj]), r, x);
    }
  }
  // o = p v: token j = c + 8 jj in ascending order; its probability comes
  // from lane 8 rg + c, its v row as one float4 (all lanes one row)
#pragma unroll
  for (int i = 0; i < RR; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  const float* vc = v + 4 * cg;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float4 vv = ld4(vc + (c + 8 * jj) * LDV);
#pragma unroll
      for (int i = 0; i < RR; ++i) {
        const float p = __shfl_sync(0xffffffffu, s[i][jj], (rg << 3) | c);
        o[i][0] = fmaf(p, vv.x, o[i][0]);
        o[i][1] = fmaf(p, vv.y, o[i][1]);
        o[i][2] = fmaf(p, vv.z, o[i][2]);
        o[i][3] = fmaf(p, vv.w, o[i][3]);
      }
    }
}

}  // namespace attn_f32
}  // namespace w2x
