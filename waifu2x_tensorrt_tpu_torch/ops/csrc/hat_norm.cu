// Kernel I: HAT's residual sums and their LayerNorm in one pass.
//
// Replaces no TPU kernel: the JAX package has no HAT. In models/hat.py
// every LayerNorm reads a residual sum that a torch add (or addcmul) wrote
// one pass earlier, and torch's LayerNorm over C = 180 ran at about six
// times its bytes. Kernel I forms the sum and its LayerNorm together,
// reading each row once. Its plain twin is ops/hat_norm.py add_norm_plain.
//
// Per row of C bf16 values, in fp32, rounded to bf16 where torch's ops
// round (so y is bit-equal to the ops it replaces):
//   norm:        n = LN(x)
//   add:         y = bf16(x + r),                   n = LN(y)
//   scaled add:  t = bf16(x + r), y = bf16(t + z s[b]), n = LN(y)
// with s[b] the row's image's (C,) channel weights (HAB's channel
// attention times its conv scale; torch.addcmul's fp32 product and sum,
// one rounding). LN(y) = (y - mean) rstd gamma + beta, mean and the
// biased variance over the row in fp32 (two passes over the registers),
// rstd = rsqrt(var + eps), gamma and beta bf16, one rounding at the end:
// torch's bf16 layer_norm up to the order of its fp32 sums.
// Rows lie at a pitch P >= C (HAT's and DAT's trunk at 16-byte rows: P =
// 192 for C = 180): channels [C, P) are pad, left out of the sums and
// written as zeros in y and n, whatever x, r and z hold there (C and P
// multiples of 4, so each quad below is all real or all pad).
//
// What bounds it on the H100: bytes. With U one (16, 256, 256, 180) bf16
// map (377.5 MB, a chunk of the hat4x-480p-stream cell), a launch moves
// 2U (norm), 4U (add: x, r, y, n) or 5U (scaled add: and z): 0.225, 0.451
// and 0.563 ms at 3.35 TB/s.
// What the design does about it:
// - one warp takes a pair of rows: 2 P values, 4 P bytes, a multiple of
//   16 when P is a multiple of 4 (P / 4 vectors of 16 bytes, 48 at
//   P = 192, 45 at an unpadded 180, whose row alone is 360 bytes, only
//   8-byte aligned). Lane l loads
//   vectors l, l + 32, ... of the pair, neighbouring lanes on
//   neighbouring addresses; a vector is two quads of 4 values, each in
//   one row (a vector may straddle the two rows);
// - every load of a pair is issued first; then the pair stays in
//   registers: the sums of both rows reduce by warp shuffles (two at a
//   time), then the squared deviations, then the outputs are written
//   (71-80 registers at C 180, 3 CTAs of 8 warps an SM). The norm
//   alone, reading one map, loads two pairs before it finishes the
//   first; two pairs in flight took the scaled add to 145 registers and
//   gained nothing for the add. Nothing is read twice from device
//   memory but gamma, beta (held in registers, packed, for the lane's
//   fixed channels) and s (8 bytes a quad, from L1);
// - a grid-stride loop over the pairs by as many warps as are resident;
//   an odd row count leaves the last pair one row (8-byte accesses for
//   the vector that straddles into the missing row);
// - 32-bit row counts, 64-bit offsets (the wrapper refuses maps of 2^31
//   values or more).
#include "common.cuh"

namespace w2x {
namespace hat {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

enum Mode { kNorm = 0, kAdd = 1, kScaledAdd = 2 };

struct AddNormArgs {
  const bf16* x;      // (rows, C)
  const bf16* r;      // (rows, C), null for kNorm
  const bf16* z;      // (rows, C), kScaledAdd only
  const bf16* s;      // (rows / hw, P), kScaledAdd only
  const bf16* gamma;  // (C,)
  const bf16* beta;   // (C,)
  bf16* y;            // (rows, P): the sum; null for kNorm
  bf16* n;            // (rows, P): its LayerNorm
  int rows, c, p, hw;  // c real channels of a row of pitch p; hw: rows
                       // an image (H W)
  float eps;
};

__device__ __forceinline__ float lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ unsigned pack2(float a, float b) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(a))
         | (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(b)) << 16;
}

// Value j (0-7) of a 16-byte vector held as four words.
__device__ __forceinline__ float elem(const uint4& u, int j) {
  const unsigned w = j < 2 ? u.x : j < 4 ? u.y : j < 6 ? u.z : u.w;
  return (j & 1) ? hi(w) : lo(w);
}

// The vector at index vi (16-byte units) of a pair, whole, or its first
// half alone (the second quad lies in a missing row), or nothing.
__device__ __forceinline__ uint4 load(const bf16* base, long long vi,
                                      int quads) {
  if (quads == 2) return __ldg(reinterpret_cast<const uint4*>(base) + vi);
  uint4 u = make_uint4(0u, 0u, 0u, 0u);
  if (quads == 1) {
    const uint2 h = __ldg(reinterpret_cast<const uint2*>(base) + 2 * vi);
    u.x = h.x;
    u.y = h.y;
  }
  return u;
}

__device__ __forceinline__ void store(bf16* base, long long vi, int quads,
                                      const float v[8]) {
  const uint4 u = make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]),
                             pack2(v[4], v[5]), pack2(v[6], v[7]));
  if (quads == 2)
    reinterpret_cast<uint4*>(base)[vi] = u;
  else if (quads == 1)
    reinterpret_cast<uint2*>(base)[2 * vi] = make_uint2(u.x, u.y);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// A lane's fixed place in every pair of rows: for each of its NV vectors
// and their two quads, the row in the pair (0 / 1), the first channel
// (a pad quad's is C or more) and gamma and beta there (4 bf16 each,
// packed; zero for a pad quad).
template <int NV>
struct Lane {
  int row_of[NV][2], ch[NV][2];
  uint2 g[NV][2], b[NV][2];
};

// One pair's loads: the lane's vectors of x (r, z), s for each quad, and
// how many quads of each vector lie in the map. All of a pair's loads are
// issued before any of its arithmetic (load_pair, then finish_pair): the
// branches on the quads otherwise kept the compiler from hoisting the
// second vector's loads above the first one's sums (75% of the bytes
// bound against 80-82% for the add and the scaled add, PERF.md).
template <int NV>
struct Loaded {
  uint4 x[NV], r[NV], z[NV];
  uint2 s[NV][2];
  int quads[NV];
};

template <int NV, int MODE>
__device__ __forceinline__ void load_pair(const AddNormArgs& a,
                                          const Lane<NV>& ln, int lane,
                                          int p, Loaded<NV>& in) {
  const int vecs = a.p / 4;
  const int row0 = 2 * p;
  const bool two = row0 + 1 < a.rows;
  int image0 = 0, image1 = 0;
  if constexpr (MODE == kScaledAdd) {
    image0 = row0 / a.hw;
    image1 = two ? (row0 + 1) / a.hw : image0;
  }
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int k = lane + 32 * i;
    // quads of this vector inside the map: a row-1 quad needs row 1
    const int quads = k >= vecs ? 0
                      : two     ? 2
                                : (ln.row_of[i][0] ? 0 : ln.row_of[i][1] ? 1
                                                                          : 2);
    in.quads[i] = quads;
    const long long vi = (long long)p * vecs + k;
    in.x[i] = load(a.x, vi, quads);
    if constexpr (MODE != kNorm) in.r[i] = load(a.r, vi, quads);
    if constexpr (MODE == kScaledAdd) {
      in.z[i] = load(a.z, vi, quads);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        in.s[i][h] = h < quads  // s is (B, P): a pad quad's is read too
            ? __ldg(reinterpret_cast<const uint2*>(
                  a.s + (long long)(ln.row_of[i][h] ? image1 : image0) * a.p
                  + ln.ch[i][h]))
            : make_uint2(0u, 0u);
    }
  }
}

template <int NV, int MODE>
__device__ __forceinline__ void finish_pair(const AddNormArgs& a,
                                            const Lane<NV>& ln, int lane,
                                            int p, const Loaded<NV>& in) {
  const int vecs = a.p / 4;
  const float fc = (float)a.c;
  float v[NV][8];
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float y = elem(in.x[i], 4 * h + j);
        if constexpr (MODE != kNorm)
          y = round_to<bf16>(__fadd_rn(y, elem(in.r[i], 4 * h + j)));
        if constexpr (MODE == kScaledAdd) {
          const unsigned sw = j < 2 ? in.s[i][h].x : in.s[i][h].y;
          y = round_to<bf16>(__fadd_rn(
              y, __fmul_rn(elem(in.z[i], 4 * h + j), (j & 1) ? hi(sw)
                                                             : lo(sw))));
        }
        // a pad quad holds zero, whatever the inputs hold there
        v[i][4 * h + j] = ln.ch[i][h] < a.c ? y : 0.f;
        part += v[i][4 * h + j];  // 0 outside the map and in the pad
      }
      if (ln.row_of[i][h])
        sum1 += part;
      else
        sum0 += part;
    }
  const float mean0 = warp_sum(sum0) / fc, mean1 = warp_sum(sum1) / fc;
  float sq0 = 0.f, sq1 = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (h < in.quads[i] && ln.ch[i][h] < a.c) {
        const float m = ln.row_of[i][h] ? mean1 : mean0;
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float d = v[i][4 * h + j] - m;
          part += d * d;
        }
        if (ln.row_of[i][h])
          sq1 += part;
        else
          sq0 += part;
      }
  const float rstd0 = rsqrtf(warp_sum(sq0) / fc + a.eps);
  const float rstd1 = rsqrtf(warp_sum(sq1) / fc + a.eps);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const long long vi = (long long)p * vecs + lane + 32 * i;
    if constexpr (MODE != kNorm) store(a.y, vi, in.quads[i], v[i]);
    float o[8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m = ln.row_of[i][h] ? mean1 : mean0;
      const float rs = ln.row_of[i][h] ? rstd1 : rstd0;
      const unsigned gw[2] = {ln.g[i][h].x, ln.g[i][h].y};
      const unsigned bw[2] = {ln.b[i][h].x, ln.b[i][h].y};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float gj = (j & 1) ? hi(gw[j >> 1]) : lo(gw[j >> 1]);
        const float bj = (j & 1) ? hi(bw[j >> 1]) : lo(bw[j >> 1]);
        o[4 * h + j] = ln.ch[i][h] < a.c
                           ? fmaf(gj, rs * (v[i][4 * h + j] - m), bj)
                           : 0.f;
      }
    }
    store(a.n, vi, in.quads[i], o);
  }
}

// NV: 16-byte vectors a lane of a pair of rows (P / 4 <= 32 NV).
template <int NV, int MODE>
__global__ void __launch_bounds__(kThreads) add_norm_kernel(
    const AddNormArgs a) {
  const int lane = threadIdx.x & 31;
  const int vecs = a.p / 4;  // 16-byte vectors a pair of rows
  Lane<NV> ln;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = 8 * (lane + 32 * i) + 4 * h;  // first value in the pair
      ln.row_of[i][h] = e >= a.p;
      ln.ch[i][h] = e - ln.row_of[i][h] * a.p;
      const bool live = lane + 32 * i < vecs && ln.ch[i][h] < a.c;
      const uint2 none = make_uint2(0u, 0u);
      ln.g[i][h] = live ? __ldg(reinterpret_cast<const uint2*>(a.gamma)
                                + ln.ch[i][h] / 4) : none;
      ln.b[i][h] = live ? __ldg(reinterpret_cast<const uint2*>(a.beta)
                                + ln.ch[i][h] / 4) : none;
    }
  }
  // pairs a warp has in flight: the norm alone reads one map, so it
  // takes two pairs at a time to keep as many bytes in flight as the add
  // (a second pair in the add and the scaled add costs more registers
  // than it gains: PERF.md)
  constexpr int kPairs = MODE == kNorm ? 2 : 1;
  const int pairs = (a.rows + 1) / 2;
  const int stride = gridDim.x * kWarps;
  for (int p = blockIdx.x * kWarps + (threadIdx.x >> 5); p < pairs;
       p += kPairs * stride) {
    Loaded<NV> in[kPairs];
#pragma unroll
    for (int q = 0; q < kPairs; ++q)
      if (p + q * stride < pairs)
        load_pair<NV, MODE>(a, ln, lane, p + q * stride, in[q]);
#pragma unroll
    for (int q = 0; q < kPairs; ++q)
      if (p + q * stride < pairs)
        finish_pair<NV, MODE>(a, ln, lane, p + q * stride, in[q]);
  }
}

using Kernel = void (*)(const AddNormArgs);

template <int MODE>
Kernel pick(int c) {
  return c <= 128 ? add_norm_kernel<1, MODE> : add_norm_kernel<2, MODE>;
}

// The kernel for the pitch P (a multiple of 4 up to 256: HAT's 192,
// HAT-S's 144) and the mode, or null.
Kernel kernel_for(int c, int mode) {
  if (c <= 0 || c % 4 || c > 256) return nullptr;
  if (mode == kNorm) return pick<kNorm>(c);
  if (mode == kAdd) return pick<kAdd>(c);
  if (mode == kScaledAdd) return pick<kScaledAdd>(c);
  return nullptr;
}

}  // namespace
}  // namespace hat
}  // namespace w2x

// x, r, z, y, n (rows, P) and s (rows / hw, P) bf16, 16-byte aligned;
// gamma, beta (C,) bf16; C real channels of each row of pitch P, both
// multiples of 4, P up to 256. r null: norm only (y unused); z null:
// add; both set: scaled add (s set).
extern "C" int w2x_add_norm(const void* x, const void* r, const void* z,
                            const void* s, const void* gamma,
                            const void* beta, void* y, void* n, int rows,
                            int c, int p, int hw, float eps, void* stream) {
  using namespace w2x::hat;
  const int mode = r == nullptr ? kNorm : z == nullptr ? kAdd : kScaledAdd;
  const Kernel kernel = kernel_for(p, mode);
  if (kernel == nullptr || rows < 0 || hw <= 0 || c <= 0 || c % 4 ||
      c > p)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  const long long pairs = ((long long)rows + 1) / 2;
  const long long want = (pairs + kWarps - 1) / kWarps;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int grid = (int)(want < resident ? want : resident);
  const AddNormArgs a{static_cast<const bf16*>(x),
                      static_cast<const bf16*>(r),
                      static_cast<const bf16*>(z),
                      static_cast<const bf16*>(s),
                      static_cast<const bf16*>(gamma),
                      static_cast<const bf16*>(beta),
                      static_cast<bf16*>(y),
                      static_cast<bf16*>(n),
                      rows, c, p, hw, eps};
  if (grid > 0)
    kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// Registers a thread and resident CTAs an SM of the kernel for the pitch
// P and the mode (0 norm, 1 add, 2 scaled add).
extern "C" int w2x_add_norm_info(int c, int mode, int* regs,
                                 int* ctas_per_sm) {
  using namespace w2x::hat;
  const Kernel kernel = kernel_for(c, mode);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, (const void*)kernel);
  if (e != cudaSuccess) return (int)e;
  *regs = attr.numRegs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, kernel, kThreads, 0);
}
