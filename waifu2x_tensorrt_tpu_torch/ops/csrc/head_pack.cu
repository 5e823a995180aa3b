// Kernel D: the packed-x head — [0,1] clamp + depth-to-space(r) into the
// packed-x16 layout.
//
// Replaces the TPU kernel waifu2x_tensorrt_tpu/ops/head_pack.py
// pack_head_x16 (pallas_call at :120): z (B, H, W, 3r^2) -> (B, rH, rW/16,
// 48), whose row-major bytes are those of (B, rH, rW, 3). Output value
// (b, y*r + ry, x*r + rx, c) is clamp(z[b, y, x, c*r^2 + ry*r + rx], 0, 1).
// The TPU version runs the shuffle as one-hot MXU products, its way of
// permuting lanes; here it is a plain gather, exact for every dtype.
//
// What bounds it on the H100: nothing but HBM bytes — it reads and writes
// each value once and computes a compare (about 100 MB each way for a
// 16-tile bf16 chunk at tile 256, r = 4; ~60 us at 3.35 TB/s).
// What the design does about it: one CTA takes HP_XB input pixels of one
// input row, a contiguous run of HP_XB * 3r^2 values, which it reads
// coalesced into shared memory (clamped on the way); it then writes the r
// output sub-rows it covers, each a contiguous run of HP_XB * r * 3
// values, so the writes are coalesced too. Each thread access moves 16
// bytes (reads of an input that is not 16-byte aligned, one value).
#include "common.cuh"

namespace w2x {

constexpr int HP_XB = 64;        // input pixels per CTA
constexpr int HP_THREADS = 256;  // threads per CTA

// clamp to [0, 1] in T; NaN passes through, as with torch.clamp
template <typename T>
__device__ __forceinline__ T clamp01(T v) {
  const float f = to_f(v);
  return f < 0.f ? from_f<T>(0.f) : (f > 1.f ? from_f<T>(1.f) : v);
}

// output value e of sub-row ry of a CTA's output run, from its tile
template <typename T, int R>
__device__ __forceinline__ T packed_value(const T* tile, int ry, int e) {
  const int X = e / 3, c = e - 3 * X;  // output pixel (CTA-local), channel
  const int xl = X / R, rx = X - R * xl;
  return tile[xl * 3 * R * R + c * R * R + ry * R + rx];
}

template <typename T, int R>
__global__ void __launch_bounds__(HP_THREADS)
head_pack_kernel(const T* __restrict__ z, T* __restrict__ out, int W,
                 int nxb) {
  constexpr int CRR = 3 * R * R;
  constexpr int VEC = 16 / sizeof(T);  // values per 16-byte access
  __shared__ __align__(16) T tile[HP_XB * CRR];
  const size_t row = blockIdx.x / nxb;  // b * H + y
  const int x0 = (blockIdx.x % nxb) * HP_XB;
  const int nx = min(HP_XB, W - x0);
  const T* src = z + (row * W + x0) * CRR;
  const int n_in = nx * CRR;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && n_in % VEC == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* t4 = reinterpret_cast<uint4*>(tile);
    for (int i = threadIdx.x; i < n_in / VEC; i += HP_THREADS) {
      uint4 v = s4[i];
      T* e = reinterpret_cast<T*>(&v);
#pragma unroll
      for (int j = 0; j < VEC; ++j) e[j] = clamp01(e[j]);
      t4[i] = v;
    }
  } else {
    for (int i = threadIdx.x; i < n_in; i += HP_THREADS)
      tile[i] = clamp01(src[i]);
  }
  __syncthreads();
  const int seg = nx * R * 3;  // values of one output sub-row in this CTA
  const size_t rstride = (size_t)W * R * 3;  // values between sub-rows
  // out is a fresh 16-byte-aligned allocation and W % (16 / R) == 0, so
  // every sub-row run starts 16-byte aligned and is a whole number of
  // 16-byte vectors (3 * R * W and 3 * R * nx are multiples of 48)
  T* dst = out + (row * R * rstride + (size_t)x0 * R * 3);
  const int nv = seg / VEC;
  for (int i = threadIdx.x; i < R * nv; i += HP_THREADS) {
    const int ry = i / nv, e0 = (i - ry * nv) * VEC;
    uint4 v;
    T* o = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int j = 0; j < VEC; ++j) o[j] = packed_value<T, R>(tile, ry, e0 + j);
    reinterpret_cast<uint4*>(dst + ry * rstride)[e0 / VEC] = v;
  }
}

template <typename T>
int launch_head_pack(const void* z, void* out, int B, int H, int W, int r,
                     cudaStream_t stream) {
  const int nxb = (W + HP_XB - 1) / HP_XB;
  const unsigned blocks = (unsigned)((size_t)B * H * nxb);
  const T* zt = static_cast<const T*>(z);
  T* ot = static_cast<T*>(out);
  if (r == 4)
    head_pack_kernel<T, 4><<<blocks, HP_THREADS, 0, stream>>>(zt, ot, W, nxb);
  else if (r == 2)
    head_pack_kernel<T, 2><<<blocks, HP_THREADS, 0, stream>>>(zt, ot, W, nxb);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace w2x

extern "C" int w2x_head_pack(const void* z, void* out, int B, int H, int W,
                             int r, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return w2x::launch_head_pack<__nv_bfloat16>(z, out, B, H, W, r, s);
  return w2x::launch_head_pack<float>(z, out, B, H, W, r, s);
}
