// Kernels A and E: shifted-window attention on the packed qkv layout (A)
// and on unpacked heads (E, below the first kernel).
//
// Kernel A replaces the TPU kernel waifu2x_tensorrt_tpu/ops/window_attention.py
// fused_window_attention_qkv (pallas_call at :212, body _kernel_qkv :122):
// qkv (BW, 64, 3C) -> out (BW, 64, C), heads as C-slices of 32, relative
// bias (nh, 64, 64) fp32, the shift mask built from per-window flag bits.
//
// What bounds it on the H100: per window it reads 64*3C and writes 64*C
// values (bf16 at C=96: 48 KB) and does 2*64*64*32 MACs per head, so with
// tensor cores it would be bound by HBM bytes; this first version runs
// the dots as fp32 FMA loops on the CUDA cores and is bound by those
// (about 0.8 MMAC per window at C=96).
// What the design does about it: one CTA per window keeps q, k, v, the
// 64x64 scores and the probabilities in shared memory, so HBM sees the
// qkv once and the output once — the (BW, nh, 64, 64) score tensor of the
// dense path never leaves the SM. Moving the two dots to mma/wgmma is
// later work.
#include "common.cuh"

namespace w2x {

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
window_attention_kernel(const T* __restrict__ qkv,
                        const float* __restrict__ bias,
                        const int* __restrict__ flags, T* __restrict__ out,
                        int C, int nh, int shift) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* scores = reinterpret_cast<float*>(smem);
  T* buf = reinterpret_cast<T*>(smem + NTOK * SLD * sizeof(float));
  const int C3 = 3 * C;
  const int ld = padded_ld<T>(C3);
  const size_t w = blockIdx.x;
  const T* src = qkv + w * NTOK * C3;
  for (int idx = threadIdx.x; idx < NTOK * C3; idx += NTHREADS)
    buf[(idx / C3) * ld + idx % C3] = src[idx];
  __syncthreads();
  attention_core<T>(buf, ld, scores, bias, flags[w], C, nh, shift);
  T* dst = out + w * NTOK * C;
  for (int idx = threadIdx.x; idx < NTOK * C; idx += NTHREADS)
    dst[idx] = buf[(idx / C) * ld + idx % C];
}

template <typename T>
int launch_window_attention(const void* qkv, const void* bias,
                            const void* flags, void* out, int bw, int C,
                            int nh, int shift, cudaStream_t stream) {
  const size_t smem =
      NTOK * SLD * sizeof(float) + (size_t)NTOK * padded_ld<T>(3 * C) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      window_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  window_attention_kernel<T><<<bw, NTHREADS, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(bias),
      static_cast<const int*>(flags), static_cast<T*>(out), C, nh, shift);
  return (int)cudaGetLastError();
}

// Kernel E: the same attention on unpacked heads.
//
// Replaces the TPU kernel waifu2x_tensorrt_tpu/ops/window_attention.py
// fused_window_attention (pallas_call at :267, body _kernel :77): q, k, v
// (BW, nh, 64, 32) -> out (BW, nh, 64, 32). A layout adapter onto kernel
// A's attention core: one CTA per (window, head) copies that head's
// contiguous (64, 32) q, k and v blocks into the packed [q | k | v] rows
// the core reads (C = 32, one head, the bias of head h), so the mask law
// and the softmax exist once. Bounded like kernel A, by the fp32 FMA loops
// of the two dots; per CTA 3 * 4 KB in and 4 KB out in bf16.
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
window_attention_heads_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v,
                              const float* __restrict__ bias,
                              const int* __restrict__ flags,
                              T* __restrict__ out, int nh, int shift) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* scores = reinterpret_cast<float*>(smem);
  T* buf = reinterpret_cast<T*>(smem + NTOK * SLD * sizeof(float));
  constexpr int ld = padded_ld<T>(3 * HD);
  const size_t blk = blockIdx.x;  // window * nh + head
  const size_t off = blk * NTOK * HD;
  for (int idx = threadIdx.x; idx < NTOK * HD; idx += NTHREADS) {
    const int t = idx / HD, d = idx % HD;
    buf[t * ld + d] = q[off + idx];
    buf[t * ld + HD + d] = k[off + idx];
    buf[t * ld + 2 * HD + d] = v[off + idx];
  }
  __syncthreads();
  const int w = (int)(blk / nh), h = (int)(blk % nh);
  attention_core<T>(buf, ld, scores, bias + (size_t)h * NTOK * NTOK, flags[w],
                    HD, 1, shift);
  for (int idx = threadIdx.x; idx < NTOK * HD; idx += NTHREADS)
    out[off + idx] = buf[(idx / HD) * ld + idx % HD];
}

template <typename T>
int launch_window_attention_heads(const void* q, const void* k, const void* v,
                                  const void* bias, const void* flags,
                                  void* out, int bw, int nh, int shift,
                                  cudaStream_t stream) {
  // 41.5 KB at fp32: under the 48 KB a launch may take without opting in
  const size_t smem =
      NTOK * SLD * sizeof(float) + (size_t)NTOK * padded_ld<T>(3 * HD) * sizeof(T);
  window_attention_heads_kernel<T><<<(unsigned)((size_t)bw * nh), NTHREADS,
                                     smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<const int*>(flags), static_cast<T*>(out), nh, shift);
  return (int)cudaGetLastError();
}

}  // namespace w2x

extern "C" int w2x_window_attention_heads(const void* q, const void* k,
                                          const void* v, const void* bias,
                                          const void* flags, void* out,
                                          int bw, int nh, int shift,
                                          int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return w2x::launch_window_attention_heads<__nv_bfloat16>(
        q, k, v, bias, flags, out, bw, nh, shift, s);
  return w2x::launch_window_attention_heads<float>(q, k, v, bias, flags, out,
                                                   bw, nh, shift, s);
}

extern "C" int w2x_window_attention_qkv(const void* qkv, const void* bias,
                                        const void* flags, void* out, int bw,
                                        int C, int nh, int shift, int is_bf16,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return w2x::launch_window_attention<__nv_bfloat16>(qkv, bias, flags, out,
                                                       bw, C, nh, shift, s);
  return w2x::launch_window_attention<float>(qkv, bias, flags, out, bw, C, nh,
                                             shift, s);
}
