// Kernel B: one whole pre-norm Swin block on window tokens.
//
// Replaces the TPU kernel waifu2x_tensorrt_tpu/ops/swin_block.py
// fused_swin_block (pallas_call at :269, body _block_body :42):
//   LN1 -> qkv GEMM + bias -> per-head window attention (rel bias, shift
//   mask, exact softmax) -> proj GEMM + bias -> residual -> LN2 -> fc1
//   (C -> 2C) -> erf GELU -> fc2 -> residual
// on x (BW, 64, C), C = 32 * nh (96/3 and 192/6 on the flagship).
//
// What bounds it on the H100: 512*C^2 MACs of GEMM per window (19 GMAC
// per block per 16-tile chunk at either stage) against 2 * 64*C values of
// HBM traffic, so it is compute-bound; this first version runs the GEMMs
// as fp32 FMA loops on the CUDA cores, with the weights read through L2.
// What the design does about it: the TPU kernel kept every weight resident
// in VMEM; at C=192 the weights are ~0.59 MB in bf16, more than the 227 KB
// of shared memory a CTA may use. So one CTA per window keeps the window's
// ACTIVATIONS in shared memory (the qkv / MLP-hidden buffer, the LN output
// or residual, the 64x64 scores: 209 KB at C=192 fp32, 113 KB in bf16) and
// reads the weights from global memory, where all blocks' weights stay in
// the 50 MB L2. Activations touch HBM once in, once out. Tensor-core GEMMs
// (mma/wgmma) and weight tiles staged by TMA are later work.
//
// Rounding points mirror _block_body (swin_block.py:67-177): LN output
// rounded to T; GEMMs accumulate in fp32, add the fp32 bias, then round
// to T; the residual adds round to T; GELU runs on the fp32
// pre-activation. Exact forms for every T (see common.cuh).
#include "common.cuh"

namespace w2x {

struct BlockParams {
  const float* n1s;
  const float* n1b;
  const void* qkvk;  // (C, 3C) in T
  const float* qkvb;
  const void* projk;  // (C, C) in T
  const float* projb;
  const float* n2s;
  const float* n2b;
  const void* fc1k;  // (C, 2C) in T
  const float* fc1b;
  const void* fc2k;  // (2C, C) in T
  const float* fc2b;
};

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
swin_block_kernel(const T* __restrict__ x, BlockParams p,
                  const float* __restrict__ bias,
                  const int* __restrict__ flags, T* __restrict__ out, int C,
                  int nh, int shift) {
  extern __shared__ __align__(16) unsigned char smem[];
  // shared memory: scores (64 x SLD f32) | hbuf (64 x ldh T) | buf (64 x ld T)
  //   hbuf holds LN1's output, then the first residual x1
  //   buf  holds [q | k | v], then [attn | - | LN2 out], then the MLP hidden
  float* scores = reinterpret_cast<float*>(smem);
  const int ldh = padded_ld<T>(C);
  const int ld = padded_ld<T>(3 * C);
  T* hbuf = reinterpret_cast<T*>(smem + NTOK * SLD * sizeof(float));
  T* buf = hbuf + NTOK * ldh;
  const size_t w = blockIdx.x;
  const T* xw = x + w * NTOK * C;
  T* ow = out + w * NTOK * C;

  // LN1(x) -> hbuf
  layernorm64<T>([&](int r, int k) { return to_f(xw[r * C + k]); }, C, p.n1s,
                 p.n1b, hbuf, ldh);
  __syncthreads();
  // qkv = LN1(x) Wqkv + b -> buf[:, 0:3C)
  gemm64<T>(hbuf, ldh, static_cast<const T*>(p.qkvk), p.qkvb, C, 3 * C,
            [&](int r, int n, float v) { buf[r * ld + n] = from_f<T>(v); });
  __syncthreads();
  // attention -> buf[:, 0:C)
  attention_core<T>(buf, ld, scores, bias, flags[w], C, nh, shift);
  // x1 = x + (attn Wproj + b) -> hbuf
  gemm64<T>(buf, ld, static_cast<const T*>(p.projk), p.projb, C, C,
            [&](int r, int n, float v) {
              hbuf[r * ldh + n] = from_f<T>(to_f(xw[r * C + n]) + round_to<T>(v));
            });
  __syncthreads();
  // LN2(x1) -> buf[:, 2C:3C)
  layernorm64<T>([&](int r, int k) { return to_f(hbuf[r * ldh + k]); }, C,
                 p.n2s, p.n2b, buf + 2 * C, ld);
  __syncthreads();
  // g = gelu(LN2(x1) Wfc1 + b) -> buf[:, 0:2C)
  gemm64<T>(buf + 2 * C, ld, static_cast<const T*>(p.fc1k), p.fc1b, C, 2 * C,
            [&](int r, int n, float v) {
              const float g = 0.5f * v * (1.f + erff(v * 0.7071067811865476f));
              buf[r * ld + n] = from_f<T>(g);
            });
  __syncthreads();
  // out = x1 + (g Wfc2 + b)
  gemm64<T>(buf, ld, static_cast<const T*>(p.fc2k), p.fc2b, 2 * C, C,
            [&](int r, int n, float v) {
              ow[r * C + n] = from_f<T>(to_f(hbuf[r * ldh + n]) + round_to<T>(v));
            });
}

template <typename T>
int launch_swin_block(const void* x, const BlockParams& p, const void* bias,
                      const void* flags, void* out, int bw, int C, int nh,
                      int shift, cudaStream_t stream) {
  const size_t smem = NTOK * SLD * sizeof(float) +
                      (size_t)NTOK * padded_ld<T>(C) * sizeof(T) +
                      (size_t)NTOK * padded_ld<T>(3 * C) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      swin_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  swin_block_kernel<T><<<bw, NTHREADS, smem, stream>>>(
      static_cast<const T*>(x), p, static_cast<const float*>(bias),
      static_cast<const int*>(flags), static_cast<T*>(out), C, nh, shift);
  return (int)cudaGetLastError();
}

}  // namespace w2x

extern "C" int w2x_swin_block(const void* x, const void* n1s, const void* n1b,
                              const void* qkvk, const void* qkvb,
                              const void* projk, const void* projb,
                              const void* n2s, const void* n2b,
                              const void* fc1k, const void* fc1b,
                              const void* fc2k, const void* fc2b,
                              const void* bias, const void* flags, void* out,
                              int bw, int C, int nh, int shift, int is_bf16,
                              void* stream) {
  w2x::BlockParams p;
  p.n1s = static_cast<const float*>(n1s);
  p.n1b = static_cast<const float*>(n1b);
  p.qkvk = qkvk;
  p.qkvb = static_cast<const float*>(qkvb);
  p.projk = projk;
  p.projb = static_cast<const float*>(projb);
  p.n2s = static_cast<const float*>(n2s);
  p.n2b = static_cast<const float*>(n2b);
  p.fc1k = fc1k;
  p.fc1b = static_cast<const float*>(fc1b);
  p.fc2k = fc2k;
  p.fc2b = static_cast<const float*>(fc2b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return w2x::launch_swin_block<__nv_bfloat16>(x, p, bias, flags, out, bw,
                                                 C, nh, shift, s);
  return w2x::launch_swin_block<float>(x, p, bias, flags, out, bw, C, nh,
                                       shift, s);
}
