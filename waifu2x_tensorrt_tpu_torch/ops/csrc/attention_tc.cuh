// The bf16 window-attention core of kernels A and E on the tensor cores:
// one warp computes one head for 16 query rows of a 64-token window, with
// the scores and probabilities in registers.
//
// For rows r0..r0+15 and one head of dim 32, operands bf16 in shared
// memory:
//   s = bias_h + round(q * scale) k^T    16 x 64 fp32, registers
//   p = softmax(s) over the kept entries  masked entries exactly 0
//   o = round(round(p) v)                 16 x 32, written as bf16
// on mma.sync m16n8k16 (tensor_core.cuh): q and k through ldmatrix, v
// through ldmatrix.trans, the probabilities turned straight into A
// fragments. The rounding points are those of window_attention_qkv_plain
// (ops/window_attention.py) and of the TPU kernel's body (_kernel_qkv):
// q * scale rounded to bf16 with the scale itself rounded, fp32 scores
// and softmax, p rounded to bf16 before the fp32-accumulated p v, one
// final rounding. Only the order of the fp32 sums differs. Kernel B's bf16
// heads loop (swin_block.cu) computes the same from q fragments of its
// own.
#pragma once

#include "common.cuh"
#include "tensor_core.cuh"

namespace w2x {
namespace attn {

using bf16 = __nv_bfloat16;

// The phase clock of the main build: clock(i) marks the end of phase i
// and compiles to nothing (see window_attention.cu for the measuring one).
struct NoClock {
  __device__ __forceinline__ void operator()(int) {}
};

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// Which of this thread's 32 score entries cross a shift seam: bit 4j + e
// stands for s[j][e], row r0 + g (e < 2) or r0 + g + 8 (e >= 2), column
// 8j + 2t + (e & 1); `row` for the row seam (flag bit 0, bottom), `col`
// for the column seam (bit 1, right). Independent of the window, so a
// kernel computes them once; from keep_entry, so the law stays bit-exact
// with kernel_math.shift_crossing / keep_from_flags. Both are 0 for
// shift 0.
struct Crossings {
  uint32_t row, col;
};

__device__ __forceinline__ Crossings crossings(int r0, int shift) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  Crossings c{0u, 0u};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = r0 + g + (e & 2) * 4, col = 8 * j + 2 * t + (e & 1);
      const uint32_t bit = 1u << (4 * j + e);
      if (!keep_entry(1, i, col, shift)) c.row |= bit;
      if (!keep_entry(2, i, col, shift)) c.col |= bit;
    }
  return c;
}

// keep bits of a window with these flags: keep_entry(flags, i, j, shift)
__device__ __forceinline__ uint32_t keep_bits(Crossings c, int flags) {
  return ~(((flags & 1) ? c.row : 0u) | ((flags & 2) ? c.col : 0u));
}

// A head's (64, 64) fp32 relative bias (global, 8-byte aligned) at this
// thread's 32 score entries, in the accumulator layout of the scores: a
// kernel that keeps one head per warp loads it once.
__device__ __forceinline__ void bias_frag(float (&b)[8][4],
                                          const float* __restrict__ bias,
                                          int r0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * t;
    const float2 ba = __ldg(reinterpret_cast<const float2*>(
        bias + (r0 + g) * NTOK + col));
    const float2 bb = __ldg(reinterpret_cast<const float2*>(
        bias + (r0 + g + 8) * NTOK + col));
    b[j][0] = ba.x;
    b[j][1] = ba.y;
    b[j][2] = bb.x;
    b[j][3] = bb.y;
  }
}

// One head for the 16 rows of this warp. q: the warp's first q row (16
// rows, stride ldq); k, v: row 0 of the head's k and v (64 rows, stride
// ldkv); row strides multiples of 8 elements, so every ldmatrix row
// address is 16-byte aligned. bias: the head's bias_frag; keep: keep_bits
// of the window. Writes the 16 x 32 output, rounded to bf16, to o (stride
// ldo), which may be q: every lane has read q before any writes. clock(1),
// (2), (3) mark the ends of q k^T, the softmax and p v.
template <class Clock>
__device__ __forceinline__ void head_attention(const bf16* q, int ldq,
                                               const bf16* k, const bf16* v,
                                               int ldkv,
                                               const float (&bias)[8][4],
                                               uint32_t keep, bf16* o,
                                               int ldo, Clock& clock) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // scores against the 64 tokens, started from the bias, or from -inf
  // where the shift mask drops the entry: the row max then skips it and
  // its exp is exactly 0, without branches
  float s[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[j][e] = (keep >> (4 * j + e) & 1) ? bias[j][e] : -INFINITY;
  // q * scale rounded to bf16 (jnp.asarray(32 ** -0.5, bf16): the scale
  // itself is rounded), as the A fragments of the two k16 steps
  const float scale = round_to<bf16>(0.17677669529663687f);
  uint32_t qa[2][4];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    tc::ldsm_x4(qa[kk], q + (lane & 15) * ldq + (lane >> 4) * 8 + kk * 16);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&qa[kk][r]));
      qa[kk][r] = tc::pack_bf16(f.x * scale, f.y * scale);
    }
  }
  // s += (q * scale) k^T
  const bf16* krow = k + ((lane & 7) + ((lane >> 4) << 3)) * ldkv +
                     ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      uint32_t b[4];
      tc::ldsm_x4(b, krow + j * 8 * ldkv + kk * 16);
      tc::mma_bf16(s[j], qa[kk], b[0], b[1]);
      tc::mma_bf16(s[j + 1], qa[kk], b[2], b[3]);
    }
  clock(1);
  // exact softmax over the kept entries
  float ma = -INFINITY, mb = -INFINITY;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (e & 2)
        mb = fmaxf(mb, s[j][e]);
      else
        ma = fmaxf(ma, s[j][e]);
    }
  ma = quad_max(ma);
  mb = quad_max(mb);
  float sa = 0.f, sb = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = expf(s[j][e] - ((e & 2) ? mb : ma));
      if (e & 2)
        sb += s[j][e];
      else
        sa += s[j][e];
    }
  sa = quad_sum(sa);
  sb = quad_sum(sb);
  // p = e / sum, correctly rounded: the row's correctly rounded
  // reciprocal, a product, and one exact-remainder correction (Markstein;
  // tests/test_torch_block_math.py)
  const float ia = __frcp_rn(sa), ib = __frcp_rn(sb);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float d = (e & 2) ? sb : sa, r = (e & 2) ? ib : ia;
      const float x = s[j][e] * r;
      s[j][e] = fmaf(fmaf(-x, d, s[j][e]), r, x);
    }
  uint32_t pa[4][4];  // probabilities, rounded to bf16, as A fragments
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    tc::to_a_frag(pa[kk], s[2 * kk], s[2 * kk + 1]);
  clock(2);
  // o = p v (16 x 32)
  const bf16* vrow = v + ((lane & 7) + ((lane >> 3) & 1) * 8) * ldkv +
                     (lane >> 4) * 8;
  float acc[4][4] = {};
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; j += 2) {
      uint32_t b[4];
      tc::ldsm_x4_trans(b, vrow + kk * 16 * ldkv + j * 8);
      tc::mma_bf16(acc[j], pa[kk], b[0], b[1]);
      tc::mma_bf16(acc[j + 1], pa[kk], b[2], b[3]);
    }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = 8 * j + 2 * t;
    *reinterpret_cast<uint32_t*>(o + g * ldo + col) =
        tc::pack_bf16(acc[j][0], acc[j][1]);
    *reinterpret_cast<uint32_t*>(o + (g + 8) * ldo + col) =
        tc::pack_bf16(acc[j][2], acc[j][3]);
  }
  clock(3);
}

}  // namespace attn
}  // namespace w2x
