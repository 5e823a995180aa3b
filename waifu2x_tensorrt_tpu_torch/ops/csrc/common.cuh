// Shared device code of the port's Swin kernels (kernels A and E, window
// attention; kernel B, the fused Swin block): the window geometry, dtype
// conversion and rounding, and the cyclic-shift mask law.
//
// The attention cores built on it are attention_tc.cuh (bf16, tensor
// cores) and attention_f32.cuh (fp32, CUDA cores). Rounding points follow
// the TPU kernels (waifu2x_tensorrt_tpu/ops/window_attention.py
// _kernel_qkv, swin_block.py _block_body): q*scale is rounded to the
// compute dtype T before the QK dot, products accumulate in fp32,
// probabilities are rounded to T before the PV dot. The exact forms
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

}  // namespace w2x
