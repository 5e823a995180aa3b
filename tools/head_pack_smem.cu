// Kernel D's shared-memory candidate, a measurement variant that the port
// does not build (tools/kernel_variants.py builds and times it beside the
// register-only kernel of waifu2x_tensorrt_tpu_torch/ops/csrc/head_pack.cu).
//
// A CTA walks runs of HP_XB input pixels of one row (grid-stride), two
// shared-memory buffers in turn: while it permutes run i, the 16-byte
// cp.async copies of run i + 1 are in flight. The permutation is the
// register kernel's (a thread: P pixels x one output sub-row ry, three
// 16-byte stores), reading its r-value runs from shared memory instead of
// device memory, so no index needs a divide by 3. Needs z 16-byte aligned.
#include "common.cuh"
#include "tensor_core.cuh"

namespace w2x {

constexpr int HP_THREADS = 256;
constexpr int HP_XB = 64;  // input pixels a run

template <typename T>  // as in head_pack.cu
__device__ __forceinline__ T clamp01(T v) {
  const float f = to_f(v);
  if (f > 0.f) return f > 1.f ? from_f<T>(1.f) : v;
  return f == f ? from_f<T>(0.f) : v;
}

template <typename T, int R>
__global__ void __launch_bounds__(HP_THREADS)
head_pack_smem_kernel(const T* __restrict__ z, T* __restrict__ out, int W,
                      int nxb, int runs) {
  constexpr int P = 48 / (R * 3 * (int)sizeof(T));
  constexpr int CRR = 3 * R * R;
  constexpr int VEC = 16 / (int)sizeof(T);
  __shared__ __align__(16) T buf[2][HP_XB * CRR];

  auto stage = [&](int run, int slot) {
    const int row = run / nxb, x0 = (run - row * nxb) * HP_XB;
    const int n = min(HP_XB, W - x0) * CRR / VEC;  // 16-byte pieces
    const T* src = z + ((size_t)row * W + x0) * CRR;
    for (int i = threadIdx.x; i < n; i += HP_THREADS)
      tc::cp_async16(&buf[slot][i * VEC], src + i * VEC);
  };

  int slot = 0;
  if (blockIdx.x < runs) stage(blockIdx.x, 0);
  tc::cp_async_commit();
  for (int run = blockIdx.x; run < runs; run += gridDim.x, slot ^= 1) {
    if (run + (int)gridDim.x < runs) stage(run + gridDim.x, slot ^ 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    const int row = run / nxb, x0 = (run - row * nxb) * HP_XB;
    const int items = min(HP_XB, W - x0) / P * R;
    for (int item = threadIdx.x; item < items; item += HP_THREADS) {
      const int ry = item % R, px = (item / R) * P;
      __align__(16) T o[P * R * 3];
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int c = 0; c < 3; ++c)
#pragma unroll
          for (int rx = 0; rx < R; ++rx)
            o[(p * R + rx) * 3 + c] =
                clamp01(buf[slot][(px + p) * CRR + c * R * R + ry * R + rx]);
      uint4* dst = reinterpret_cast<uint4*>(
          out + ((size_t)row * R + ry) * (size_t)(W * R * 3) +
          (x0 + px) * R * 3);
      const uint4* s = reinterpret_cast<const uint4*>(o);
#pragma unroll
      for (int j = 0; j < 3; ++j) dst[j] = s[j];
    }
    __syncthreads();  // the buffer is refilled next
  }
}

template <typename T, int R>
int launch(const void* z, void* out, int B, int H, int W,
           cudaStream_t stream) {
  const int nxb = (W + HP_XB - 1) / HP_XB, runs = B * H * nxb;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int blocks = min(runs, sms * 8);  // 8 CTAs an SM
  head_pack_smem_kernel<T, R><<<blocks, HP_THREADS, 0, stream>>>(
      static_cast<const T*>(z), static_cast<T*>(out), W, nxb, runs);
  return (int)cudaGetLastError();
}

}  // namespace w2x

extern "C" int w2x_head_pack(const void* z, void* out, int B, int H, int W,
                             int r, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (r != 2 && r != 4) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return r == 4 ? w2x::launch<__nv_bfloat16, 4>(z, out, B, H, W, s)
                  : w2x::launch<__nv_bfloat16, 2>(z, out, B, H, W, s);
  return r == 4 ? w2x::launch<float, 4>(z, out, B, H, W, s)
                : w2x::launch<float, 2>(z, out, B, H, W, s);
}
