// Kernel D: the packed-x head — [0,1] clamp + depth-to-space(r) into the
// packed-x16 layout.
//
// Replaces the TPU kernel waifu2x_tensorrt_tpu/ops/head_pack.py
// pack_head_x16 (pallas_call at :120): z (B, H, W, 3r^2) -> (B, rH, rW/16,
// 48), whose row-major bytes are those of (B, rH, rW, 3). Output value
// (b, y*r + ry, x*r + rx, c) is clamp(z[b, y, x, c*r^2 + ry*r + rx], 0, 1).
// The TPU version runs the shuffle as one-hot MXU products, its way of
// permuting lanes; here it is a register permutation, exact for every dtype.
//
// What bounds it on the H100: nothing but HBM bytes — it reads and writes
// each value once and computes a compare (about 100 MB each way for a
// 16-tile bf16 chunk at tile 256, r = 4; ~60 us at 3.35 TB/s).
// What the design does about it: one pass through registers, no shared
// memory and no barrier. A thread owns one item: P neighbouring input
// pixels of one row and one output sub-row ry. It reads, for each pixel and
// channel c, the run of r values at c*r^2 + ry*r (one vector load each:
// 8 bytes at r 4 in bf16), and writes the item's P*r*3 output values, which
// are contiguous in output sub-row ry, as three 16-byte stores (P makes
// them 48 bytes in every case). ry is the fastest index of the item, so
// the r threads of a pixel read its r^2 values of a channel as one
// contiguous span (a warp's loads cover whole 32-byte sectors) and a
// warp's three stores cover 32/r runs of 48 contiguous bytes in each of r
// sub-rows. The permutation is fixed at compile time (no divides); the
// only runtime division is one by W a thread. A thread takes HP_ITEMS
// items, all loads first (two a thread measured no faster: 2048 threads an
// SM already hold 48 KB of loads in flight). Index math is 32-bit except
// the two final element offsets.
#include <climits>

#include "common.cuh"

namespace w2x {

constexpr int HP_THREADS = 256;  // threads per CTA
constexpr int HP_ITEMS = 1;      // items per thread

// clamp to [0, 1] in T as torch.clamp does on the card: NaN passes
// through, and -0.0 becomes +0.0 (max(-0.0, 0.0) is +0.0 there)
template <typename T>
__device__ __forceinline__ T clamp01(T v) {
  const float f = to_f(v);
  if (f > 0.f) return f > 1.f ? from_f<T>(1.f) : v;
  return f == f ? from_f<T>(0.f) : v;
}

// The compile-time shape of one item: P pixels whose P*R*3 output values
// are 48 bytes (three 16-byte stores).
template <typename T, int R>
struct HeadPackItem {
  static constexpr int P = 48 / (R * 3 * (int)sizeof(T));  // pixels
  static constexpr int CRR = 3 * R * R;                    // values a pixel
  static constexpr int NOUT = P * R * 3;                   // values stored
  static_assert(P >= 1 && NOUT * sizeof(T) == 48, "48-byte item");
};

// R values of T as one vector load (ALIGNED) or R scalar loads
template <typename T, int R, bool ALIGNED>
__device__ __forceinline__ void load_run(T (&v)[R], const T* p) {
  constexpr int BYTES = R * (int)sizeof(T);
  if constexpr (ALIGNED && BYTES == 16) {
    *reinterpret_cast<uint4*>(v) = __ldg(reinterpret_cast<const uint4*>(p));
  } else if constexpr (ALIGNED && BYTES == 8) {
    *reinterpret_cast<uint2*>(v) = __ldg(reinterpret_cast<const uint2*>(p));
  } else if constexpr (ALIGNED && BYTES == 4) {
    *reinterpret_cast<uint32_t*>(v) =
        __ldg(reinterpret_cast<const unsigned int*>(p));
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) v[i] = p[i];
  }
}

// ALIGNED: z is R * sizeof(T)-byte aligned, so every run load is one vector
template <typename T, int R, bool ALIGNED>
__global__ void __launch_bounds__(HP_THREADS)
head_pack_kernel(const T* __restrict__ z, T* __restrict__ out, int W,
                 int items) {
  using It = HeadPackItem<T, R>;
  constexpr int P = It::P;
  __align__(16) T v[HP_ITEMS][P][3][R];  // [item][pixel][channel][rx]
  int pix[HP_ITEMS], ry[HP_ITEMS];
  const int first = blockIdx.x * (HP_THREADS * HP_ITEMS) + threadIdx.x;
#pragma unroll
  for (int k = 0; k < HP_ITEMS; ++k) {
    const int item = first + k * HP_THREADS;
    if (item >= items) break;
    ry[k] = item % R;         // R is 2 or 4: a mask
    pix[k] = (item / R) * P;  // first pixel (b * H + y) * W + x; W % P == 0
    const T* src = z + (size_t)pix[k] * It::CRR + ry[k] * R;
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        load_run<T, R, ALIGNED>(v[k][p][c], src + p * It::CRR + c * R * R);
  }
#pragma unroll
  for (int k = 0; k < HP_ITEMS; ++k) {
    if (first + k * HP_THREADS >= items) break;
    __align__(16) T o[It::NOUT];  // output order: pixel, rx, channel
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int rx = 0; rx < R; ++rx)
#pragma unroll
        for (int c = 0; c < 3; ++c)
          o[(p * R + rx) * 3 + c] = clamp01(v[k][p][c][rx]);
    const int row = pix[k] / W, x = pix[k] - row * W;
    // out is a fresh 16-byte-aligned allocation, a sub-row holds W*R*3
    // values (W % (16 / R) == 0: a multiple of 48 bytes) and x * R * 3 is
    // a multiple of 48 bytes (x % P == 0): the stores are aligned
    uint4* dst = reinterpret_cast<uint4*>(
        out + ((size_t)row * R + ry[k]) * (size_t)(W * R * 3) + x * R * 3);
    const uint4* s = reinterpret_cast<const uint4*>(o);
#pragma unroll
    for (int j = 0; j < 3; ++j) dst[j] = s[j];
  }
}

template <typename T, int R>
int launch_head_pack(const T* z, T* out, int B, int H, int W,
                     cudaStream_t stream) {
  constexpr int P = HeadPackItem<T, R>::P;
  const long long pixels = (long long)B * H * W, items = pixels / P * R;
  if (pixels > INT_MAX || items > INT_MAX - HP_THREADS * HP_ITEMS)
    return (int)cudaErrorInvalidValue;
  const int n = (int)items;
  const unsigned blocks =
      (unsigned)((n + HP_THREADS * HP_ITEMS - 1) / (HP_THREADS * HP_ITEMS));
  if (reinterpret_cast<uintptr_t>(z) % (R * sizeof(T)) == 0)
    head_pack_kernel<T, R, true><<<blocks, HP_THREADS, 0, stream>>>(z, out, W,
                                                                     n);
  else
    head_pack_kernel<T, R, false><<<blocks, HP_THREADS, 0, stream>>>(z, out,
                                                                      W, n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_head_pack(const void* z, void* out, int B, int H, int W, int r,
                     cudaStream_t stream) {
  const T* zt = static_cast<const T*>(z);
  T* ot = static_cast<T*>(out);
  if (r == 4) return launch_head_pack<T, 4>(zt, ot, B, H, W, stream);
  if (r == 2) return launch_head_pack<T, 2>(zt, ot, B, H, W, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace w2x

extern "C" int w2x_head_pack(const void* z, void* out, int B, int H, int W,
                             int r, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return w2x::launch_head_pack<__nv_bfloat16>(z, out, B, H, W, r, s);
  return w2x::launch_head_pack<float>(z, out, B, H, W, r, s);
}
