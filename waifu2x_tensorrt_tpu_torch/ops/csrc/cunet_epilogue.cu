// Kernel H: cunet's convolution epilogue — the bias, the leaky ReLU, the
// cropped skip add and the [0, 1] clamp in one pass over the conv output.
//
// Replaces no TPU kernel: on the TPU, XLA fused this epilogue into the
// convolutions (waifu2x_tensorrt_tpu/models/cunet.py writes it as plain
// jnp ops). On the card, cuDNN's convolution leaves the bias to PyTorch,
// which adds it in a pass of its own over the channels_last output, and
// the leaky ReLU (x * a, then max) and each skip add took one more pass
// apiece. Its plain twin is ops/cunet_epilogue.py bias_act_plain.
//
// Per element, in fp32, rounded to T where torch's ops round:
//   y = T(c + bias[ch])                   the bias add
//   act:   y = max(y, T(y * a))           the leaky ReLU, a = 0.1 in T
//   skip:  y = T(skip[n, h + crop, w + crop, ch] + y)
//   clamp: y = clamp(y, 0, 1)             NaN kept, -0.0 -> +0.0
// Each operation rounds on its own (__fadd_rn / __fmul_rn: a contracted
// FMA would break byte identity), so the bytes are those of torch's
// add_, mul, maximum, add and clamp on the card.
//
// What bounds it on the H100: bytes. It reads the conv output once (and
// the crop of the skip once) and writes the activation once, over it. At
// the cunet2x-1080p-stream cell's largest maps, 16 tiles of 256 in bf16:
// (16, 476, 476, 64), 0.93 GB, 0.277 ms at 3.35 TB/s; with the skip,
// (16, 444, 444, 64), 1.21 GB, 0.361 ms.
// What the design does about it:
// - 16-byte loads and stores along C (8 bf16 or 4 fp32 values; cunet's C
//   is 32, 64, 128 or 256), neighbouring threads on neighbouring
//   addresses;
// - a grid-stride loop over the map's 16-byte vectors by as many CTAs of
//   256 threads as are resident on the SMs at once. The stride is a
//   multiple of the vectors a pixel holds, so a thread keeps the same
//   channels throughout and holds their bias in registers. Two vectors a
//   step, both loaded before either is stored (in place, each thread
//   reads a vector before it writes it, and no other thread touches it);
// - the skip is read from the full tensor through its own row stride and
//   the crop offset: no contiguous copy of the crop;
// - 32-bit index math: the wrapper refuses maps of 2^31 values or more.
//   The vector path counts vectors, so its index stays below 2^31 after
//   its last step; the scalar path's counts values and is unsigned, so
//   index + grid stride (< 2^31 + 2^31) cannot wrap;
// - a map whose C is not a multiple of a vector (C = 3: the two
//   conv_bottoms), or whose pointers are not 16-byte aligned, takes a
//   scalar path: one element a step, its channel from its index.
#include "common.cuh"

namespace w2x {
namespace cunet {
namespace {

constexpr int kThreads = 256;

struct BiasActArgs {
  void* data;        // (N, H, W, C): the conv output, without its bias;
                     // the activation is written over it
  const void* bias;  // (C,)
  const void* skip;  // (N, H + 2 crop, W + 2 crop, C), or null
  int n, h, w, c, crop;
  float slope;  // the leaky ReLU's a, rounded to T
  int act, clamp;
};

template <typename T>
__device__ __forceinline__ float epilogue(const BiasActArgs& a, float c,
                                          float b, float s, bool skip) {
  float y = round_to<T>(__fadd_rn(c, b));
  if (a.act) {
    const float t = round_to<T>(__fmul_rn(y, a.slope));
    y = t > y ? t : y;  // torch.maximum: a NaN y stays
  }
  if (skip) y = round_to<T>(__fadd_rn(s, y));
  if (a.clamp) y = y > 0.f ? fminf(y, 1.f) : (y == y ? 0.f : y);
  return y;
}

// The skip's pixel under pixel p = (n H + y) W + x of the map.
__device__ __forceinline__ int skip_pixel(const BiasActArgs& a, int p) {
  const int row = p / a.w, x = p - row * a.w;
  const int n = row / a.h, y = row - n * a.h;
  return ((n * (a.h + 2 * a.crop) + y + a.crop) * (a.w + 2 * a.crop) + x
          + a.crop);
}

// 16 bytes as V values of T in fp32, and back.
template <typename T>
struct Vec;
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int V = 8;
  static __device__ __forceinline__ void unpack(uint4 u, float f[V]) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // element 2k is the low half of word k
      f[2 * k] = __uint_as_float(w[k] << 16);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint4 pack(const float f[V]) {
    unsigned w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(f[2 * k]))
             | (unsigned)__bfloat16_as_ushort(
                   __float2bfloat16_rn(f[2 * k + 1])) << 16;
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};
template <>
struct Vec<float> {
  static constexpr int V = 4;
  static __device__ __forceinline__ void unpack(uint4 u, float f[V]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 pack(const float f[V]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <typename T>
__device__ __forceinline__ uint4 apply(const BiasActArgs& a, uint4 cu,
                                       uint4 su, const float (&b)[Vec<T>::V],
                                       bool skip) {
  constexpr int V = Vec<T>::V;
  float c[V], s[V];
  Vec<T>::unpack(cu, c);
  Vec<T>::unpack(su, s);
#pragma unroll
  for (int k = 0; k < V; ++k) c[k] = epilogue<T>(a, c[k], b[k], s[k], skip);
  return Vec<T>::pack(c);
}

// The vector path: C a multiple of V, kThreads a multiple of C / V, every
// pointer 16-byte aligned.
template <typename T>
__global__ void __launch_bounds__(kThreads) bias_act_kernel(
    const BiasActArgs a) {
  constexpr int V = Vec<T>::V;
  uint4* data = static_cast<uint4*>(a.data);
  const uint4* skip = static_cast<const uint4*>(a.skip);
  const bool has_skip = skip != nullptr;
  const int groups = a.c / V;           // vectors a pixel
  const int g = threadIdx.x % groups;   // this thread's vector of a pixel
  float b[V];
  const T* bias = static_cast<const T*>(a.bias) + g * V;
#pragma unroll
  for (int k = 0; k < V; ++k) b[k] = to_f(bias[k]);
  const int total = a.n * a.h * a.w * groups;
  const int stride = gridDim.x * kThreads;
  const uint4 none = make_uint4(0u, 0u, 0u, 0u);
  for (int v0 = blockIdx.x * kThreads + threadIdx.x; v0 < total;
       v0 += 2 * stride) {
    const int v1 = v0 + stride;
    const bool two = v1 < total;
    const uint4 c0 = data[v0];
    const uint4 c1 = two ? data[v1] : none;
    uint4 s0 = none, s1 = none;
    if (has_skip) {
      s0 = __ldg(skip + skip_pixel(a, v0 / groups) * groups + g);
      if (two) s1 = __ldg(skip + skip_pixel(a, v1 / groups) * groups + g);
    }
    data[v0] = apply<T>(a, c0, s0, b, has_skip);
    if (two) data[v1] = apply<T>(a, c1, s1, b, has_skip);
  }
}

// The scalar path: any C and alignment.
template <typename T>
__global__ void __launch_bounds__(kThreads) bias_act_scalar_kernel(
    const BiasActArgs a) {
  T* data = static_cast<T*>(a.data);
  const T* bias = static_cast<const T*>(a.bias);
  const T* skip = static_cast<const T*>(a.skip);
  const bool has_skip = skip != nullptr;
  const unsigned c = a.c, total = (unsigned)(a.n * a.h * a.w) * c;
  for (unsigned i = blockIdx.x * kThreads + threadIdx.x; i < total;
       i += gridDim.x * kThreads) {
    const unsigned p = i / c, ch = i - p * c;
    const float s = has_skip ? to_f(skip[skip_pixel(a, (int)p) * c + ch])
                             : 0.f;
    data[i] = from_f<T>(epilogue<T>(a, to_f(data[i]), to_f(bias[ch]), s,
                                    has_skip));
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
int launch_bias_act(const BiasActArgs& a, cudaStream_t stream) {
  constexpr int V = Vec<T>::V;
  const bool vec = a.c >= V && a.c % V == 0 && kThreads % (a.c / V) == 0
                   && aligned16(a.data)
                   && (a.skip == nullptr || aligned16(a.skip));
  void (*kernel)(const BiasActArgs) =
      vec ? bias_act_kernel<T> : bias_act_scalar_kernel<T>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)a.n * a.h * a.w * a.c;
  // a vector-path thread takes two vectors a step
  const long long per_block = vec ? 2LL * kThreads * V : kThreads;
  const long long want = (total + per_block - 1) / per_block;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int grid = (int)(want < resident ? want : resident);
  if (grid > 0) kernel<<<grid, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace cunet
}  // namespace w2x

extern "C" int w2x_bias_act(void* data, const void* bias, const void* skip,
                            int n, int h, int w, int c, int crop,
                            float slope, int act, int clamp, int is_bf16,
                            void* stream) {
  const w2x::cunet::BiasActArgs a{data, bias, skip, n, h, w, c, crop,
                                  slope, act, clamp};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return w2x::cunet::launch_bias_act<__nv_bfloat16>(a, s);
  return w2x::cunet::launch_bias_act<float>(a, s);
}
