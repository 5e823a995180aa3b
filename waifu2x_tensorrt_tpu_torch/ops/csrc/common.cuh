// Shared device code of the port's Swin kernels (kernel A, window
// attention; kernel B, the fused Swin block): dtype conversion, the
// cyclic-shift mask law, the exact softmax and the per-window attention
// core, a 64-row GEMM and a two-pass LayerNorm.
//
// Layout: one CTA owns one 8x8 window (64 tokens) with NTHREADS threads;
// activations stay in shared memory, weights are read from global memory
// (they are a few hundred KB and stay resident in the 50 MB L2).
//
// Rounding points follow the TPU kernels (waifu2x_tensorrt_tpu/ops/
// window_attention.py _kernel_qkv, swin_block.py _block_body): q*scale is
// rounded to the compute dtype T before the QK dot, products accumulate in
// fp32, probabilities are rounded to T before the PV dot. The exact forms
// (max-subtracted softmax, erf GELU, two-pass LayerNorm) are used for
// every T.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace w2x {

constexpr int WS = 8;          // window side
constexpr int NTOK = 64;       // tokens per window
constexpr int HD = 32;         // head dim
constexpr int NTHREADS = 256;  // threads per CTA
constexpr int SLD = NTOK + 1;  // row stride of the fp32 score tile

template <typename T>
struct Cvt;
template <>
struct Cvt<float> {
  static __device__ __forceinline__ float to_f(float v) { return v; }
  static __device__ __forceinline__ float from_f(float v) { return v; }
};
template <>
struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float v) {
    return __float2bfloat16_rn(v);
  }
};

template <typename T>
__device__ __forceinline__ float to_f(T v) { return Cvt<T>::to_f(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v) { return Cvt<T>::from_f(v); }
// round an fp32 value to T and back (the ".astype(dtype)" of the JAX code)
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return Cvt<T>::to_f(Cvt<T>::from_f(v));
}

// Row stride (elements) of a shared-memory row of `cols` T values, padded
// to an odd number of 32-bit words so that threads reading one column of
// different rows hit different banks (cols is a multiple of 32 here).
template <typename T>
__host__ __device__ constexpr int padded_ld(int cols) {
  return cols + (sizeof(T) == 4 ? 1 : 2);
}

// The Swin cyclic-shift mask law, bit-exact with
// waifu2x_tensorrt_tpu/ops/kernel_math.py shift_crossing/keep_from_flags:
// flags bit0 = window wraps the bottom edge, bit1 = the right edge.
__device__ __forceinline__ bool keep_entry(int flags, int i, int j,
                                           int shift) {
  if (!shift) return true;
  const int edge = WS - shift;
  const bool row_cross = ((i / WS) >= edge) != ((j / WS) >= edge);
  const bool col_cross = ((i % WS) >= edge) != ((j % WS) >= edge);
  const bool bottom = (flags & 1) != 0;
  const bool right = (flags & 2) != 0;
  return !((bottom && row_cross) || (right && col_cross));
}

// Window attention of one window, all heads, on the packed [q | k | v]
// rows in `buf` (64 rows, stride ld, columns [0, 3C)). Head h's output
// (rounded to T) overwrites q's columns [h*HD, (h+1)*HD): q_h is dead once
// the scores of head h exist. `scores` is 64 x SLD fp32 scratch; `bias`
// the (nh, 64, 64) fp32 relative-position bias in global memory.
template <typename T>
__device__ void attention_core(T* buf, int ld, float* scores,
                               const float* __restrict__ bias, int flags,
                               int C, int nh, int shift) {
  const int tid = threadIdx.x;
  // jnp.asarray(32 ** -0.5, dtype): the scale itself is rounded to T
  const float scale = round_to<T>(0.17677669529663687f);
  for (int h = 0; h < nh; ++h) {
    const int qo = h * HD, ko = C + h * HD, vo = 2 * C + h * HD;
    {  // scores = (q * scale) k^T + bias: 16 per thread (4 rows x 4 cols)
      const int tx = tid & 15, ty = tid >> 4;
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
      for (int d = 0; d < HD; ++d) {
        float qv[4], kv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
          qv[a] = round_to<T>(to_f(buf[(ty * 4 + a) * ld + qo + d]) * scale);
#pragma unroll
        for (int b = 0; b < 4; ++b) kv[b] = to_f(buf[(tx + 16 * b) * ld + ko + d]);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(qv[a], kv[b], acc[a][b]);
      }
      const float* bh = bias + (size_t)h * NTOK * NTOK;
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int i = ty * 4 + a, j = tx + 16 * b;
          scores[i * SLD + j] = acc[a][b] + bh[i * NTOK + j];
        }
    }
    __syncthreads();
    {  // exact softmax per row, 4 threads per row; masked entries -> 0
      const int i = tid >> 2, part = tid & 3;
      float* row = scores + i * SLD;
      float m = -INFINITY;
      for (int jj = 0; jj < NTOK / 4; ++jj) {
        const int j = part + 4 * jj;
        if (keep_entry(flags, i, j, shift)) m = fmaxf(m, row[j]);
      }
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      float s = 0.f;
      for (int jj = 0; jj < NTOK / 4; ++jj) {
        const int j = part + 4 * jj;
        const float e = keep_entry(flags, i, j, shift) ? expf(row[j] - m) : 0.f;
        row[j] = e;
        s += e;
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      for (int jj = 0; jj < NTOK / 4; ++jj) {
        const int j = part + 4 * jj;
        row[j] = round_to<T>(row[j] / s);  // probabilities in T before PV
      }
    }
    __syncthreads();
    {  // out = p v: 8 rows x 1 column per thread
      const int d = tid & 31, ib = (tid >> 5) * 8;
      float acc[8];
#pragma unroll
      for (int a = 0; a < 8; ++a) acc[a] = 0.f;
      for (int j = 0; j < NTOK; ++j) {
        const float vv = to_f(buf[j * ld + vo + d]);
#pragma unroll
        for (int a = 0; a < 8; ++a)
          acc[a] = fmaf(scores[(ib + a) * SLD + j], vv, acc[a]);
      }
#pragma unroll
      for (int a = 0; a < 8; ++a) buf[(ib + a) * ld + qo + d] = from_f<T>(acc[a]);
    }
    __syncthreads();
  }
}

// 64-row GEMM with the A operand in shared memory and W in global memory:
// v[r][n] = sum_k A[r][k] * W[k][n] + b[n] (fp32 accumulate, fp32 bias),
// handed to epi(r, n, v). W is row-major (K, N) in T; N is a multiple of
// 32. Output tiles of 64 columns, 4 rows x 4 columns per thread.
template <typename T, typename Epi>
__device__ void gemm64(const T* A, int lda, const T* __restrict__ W,
                       const float* __restrict__ b, int K, int N, Epi epi) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int n0 = 0; n0 < N; n0 += 64) {
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
    bool live[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) live[c] = n0 + tx + 16 * c < N;
    for (int k = 0; k < K; ++k) {
      float av[4], wv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) av[a] = to_f(A[(ty * 4 + a) * lda + k]);
      const T* wrow = W + (size_t)k * N + n0 + tx;
#pragma unroll
      for (int c = 0; c < 4; ++c) wv[c] = live[c] ? to_f(wrow[16 * c]) : 0.f;
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(av[a], wv[c], acc[a][c]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int n = n0 + tx + 16 * c;
        if (live[c]) epi(ty * 4 + a, n, acc[a][c] + b[n]);
      }
  }
}

// Two-pass fp32 LayerNorm (eps 1e-5) of 64 rows of C values, 4 threads per
// row; src(r, k) yields the input as float, the result is rounded to T
// into dst (row stride ldd).
template <typename T, typename Src>
__device__ void layernorm64(Src src, int C, const float* __restrict__ scale,
                            const float* __restrict__ bias, T* dst, int ldd) {
  const int r = threadIdx.x >> 2, part = threadIdx.x & 3;
  float s = 0.f;
  for (int k = part; k < C; k += 4) s += src(r, k);
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  const float mean = s / (float)C;
  float ss = 0.f;
  for (int k = part; k < C; k += 4) {
    const float d = src(r, k) - mean;
    ss = fmaf(d, d, ss);
  }
  ss += __shfl_xor_sync(0xffffffffu, ss, 1);
  ss += __shfl_xor_sync(0xffffffffu, ss, 2);
  const float inv = 1.f / sqrtf(ss / (float)C + 1e-5f);
  for (int k = part; k < C; k += 4)
    dst[r * ldd + k] = from_f<T>((src(r, k) - mean) * inv * scale[k] + bias[k]);
}

}  // namespace w2x
