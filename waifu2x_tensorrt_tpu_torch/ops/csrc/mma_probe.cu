// Kernel F: the int8/bf16 tensor-core probe — R serialized matrix products
// with a carry, which time the tensor cores on s8 against bf16.
//
// Replaces the TPU kernel probes/int8_pallas_probe.py run (pallas_call at
// :71, body _kernel): a2 (2, M, K) holds one lhs twice and b is (K, N);
// for i = 0..R-1, acc = dot(a2[i % 2], b) + carry(acc), from acc = 0,
// written as (M, N). s8 x s8 -> s32 with carry = acc >> 31 (arithmetic:
// 0 or -1); bf16 x bf16 -> fp32 with carry = acc * 0 (0, or NaN once acc
// is not finite). The TPU kernel's second copy exists only to stop Mosaic
// hoisting the dot, and the probe stacks the same lhs twice. This kernel,
// like its plain twin (ops/mma_probe.py), reads a2[0] only: every product
// is dot(a2[0], b), the TPU kernel's function for the probe's a2.
//
// What bounds it on the H100: operations. 2 M K N R of them over the
// dense tensor-core peak of the type (1,979 TOP/s s8, 989 TFLOP/s bf16):
// 0.556 and 1.112 ms at the ideal shape (512, 1024, 512), R 2048. Bytes
// are negligible: each CTA reads its operand slabs from device memory once
// and keeps them in shared memory for all R products.
// What the design does about it:
// - The (M, N) output is cut into CTA tiles of BM x 32 (BM 64 where that
//   still gives >= 128 CTAs, else 32), and each CTA loops over the R
//   products itself. A carry is local to its output element, so no
//   grid-wide sync is needed; split-K would need one per product, so there
//   is none.
// - The CTA's A row slab (BM x K) and B column slab (32 x K) stay resident
//   in shared memory across all R products. B is transposed while it is
//   staged from 16-byte row loads (K contiguous per column): the s8 mma
//   takes B "col", and ldmatrix.trans moves 16-bit elements only. Rows are padded by 16 bytes,
//   so ldmatrix is free of bank conflicts. K * sizeof(T) <= 2048 bytes keeps
//   a 64 x 32 tile within 227 KB (198 KB at the bf16 ideal shape).
// - 4 warps (one per SM sub-partition) in 2 x 2, each a 32 x 16 (BM 64) or
//   16 x 16 (BM 32) warp tile: per 32-byte k step a warp loads MT A
//   fragments and one B fragment pair by ldmatrix.x4 and issues 2 MT
//   mma.sync (m16n8k32 s8, m16n8k16 bf16).
// - Each product accumulates into fresh registers, so its K chain depends
//   on nothing before it; only then is the carry of the previous acc added.
//   Successive products' mma chains therefore do not serialize.
// - Nothing can be skipped: mma and ldmatrix are asm volatile (not hoisted
//   out of the R loop), and the carry is taken as written, acc >> 31 and
//   fmaf(acc, 0.f, d) (the library builds without --use_fast_math).
// mma.sync is not the full tensor-core rate on Hopper; wgmma is (later
// work).
#include "common.cuh"
#include "tensor_core.cuh"

namespace w2x {

constexpr int MP_THREADS = 128;      // 4 warps, 2 x 2
constexpr int MP_BN = 32;            // CTA tile columns
constexpr int MP_PAD = 16;           // bytes of padding per shared row
constexpr int MP_MAX_KBYTES = 2048;  // K * sizeof(T) at most
constexpr int MP_MAX_DEVICES = 64;

using bf16 = __nv_bfloat16;

template <typename T>
struct ProbeAcc;
template <>
struct ProbeAcc<int8_t> {
  using type = int;
};
template <>
struct ProbeAcc<bf16> {
  using type = float;
};

__device__ __forceinline__ void probe_mma(int (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  tc::mma_s8(d, a, b0, b1);
}

__device__ __forceinline__ void probe_mma(float (&d)[4],
                                          const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  tc::mma_bf16(d, a, b0, b1);
}

// d + carry(acc), the TPU kernel's loop body after its dot
__device__ __forceinline__ int carry_add(int acc, int d) {
  return d + (acc >> 31);
}

__device__ __forceinline__ float carry_add(float acc, float d) {
  return fmaf(acc, 0.f, d);
}

// MT: m16 tiles per warp; the CTA tile is (32 MT) x 32
template <typename T, int MT>
__global__ void __launch_bounds__(MP_THREADS)
mma_probe_kernel(const T* __restrict__ a, const T* __restrict__ b,
                 typename ProbeAcc<T>::type* __restrict__ out, int K, int N,
                 int reps) {
  using Acc = typename ProbeAcc<T>::type;
  constexpr int BM = 32 * MT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int kb = K * (int)sizeof(T);  // bytes of one operand row
  const int ld = kb + MP_PAD;          // shared row stride in bytes
  unsigned char* sa = smem;            // BM rows of A
  unsigned char* sb = smem + BM * ld;  // MP_BN rows of B^T
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * MP_BN;

  // stage the A slab by 16-byte copies; the B slab transposed, each thread
  // reading 16 bytes of a row of b (VEC columns at one k) and scattering
  // them down the rows of the K-major slab (one element per load left the
  // stage bound by load latency, ~0.13 ms a call at K 1024). Unrolling
  // these loops slowed the s8 products of the R loop: they stay rolled.
  const unsigned char* ga =
      reinterpret_cast<const unsigned char*>(a + (size_t)m0 * K);
  const int chunks = kb / 16;
  for (int i = threadIdx.x; i < BM * chunks; i += MP_THREADS) {
    const int r = i / chunks, c = i - r * chunks;
    *reinterpret_cast<uint4*>(sa + r * ld + c * 16) =
        *reinterpret_cast<const uint4*>(ga + (size_t)r * kb + c * 16);
  }
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int ROW_VECS = MP_BN / VEC;  // 16-byte pieces of a slab row
  T* sbt = reinterpret_cast<T*>(sb);
  const int ldt = ld / (int)sizeof(T);
  for (int i = threadIdx.x; i < K * ROW_VECS; i += MP_THREADS) {
    const int k = i / ROW_VECS, n = (i - k * ROW_VECS) * VEC;
    const uint4 raw =
        *reinterpret_cast<const uint4*>(b + (size_t)k * N + n0 + n);
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < VEC; ++j) sbt[(n + j) * ldt + k] = v[j];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const unsigned char* arow =
      sa + (wm * 16 * MT + (lane & 15)) * ld + (lane >> 4) * 16;
  const unsigned char* brow =
      sb + (wn * 16 + (lane & 7) + ((lane >> 4) << 3)) * ld +
      ((lane >> 3) & 1) * 16;
  Acc acc[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = Acc(0);

#pragma unroll 1
  for (int r = 0; r < reps; ++r) {
    Acc d[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[mt][j][e] = Acc(0);
#pragma unroll 2
    for (int k0 = 0; k0 < kb; k0 += 32) {
      uint32_t af[MT][4], bfr[4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        tc::ldsm_x4(af[mt], arow + mt * 16 * ld + k0);
      tc::ldsm_x4(bfr, brow + k0);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        probe_mma(d[mt][0], af[mt], bfr[0], bfr[1]);
        probe_mma(d[mt][1], af[mt], bfr[2], bfr[3]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[mt][j][e] = carry_add(acc[mt][j][e], d[mt][j][e]);
  }

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int row = m0 + wm * 16 * MT + mt * 16 + g;
      const int col = n0 + wn * 16 + j * 8 + 2 * t;
      Acc* o = out + (size_t)row * N + col;
      o[0] = acc[mt][j][0];
      o[1] = acc[mt][j][1];
      o[(size_t)8 * N] = acc[mt][j][2];
      o[(size_t)8 * N + 1] = acc[mt][j][3];
    }
}

template <typename T, int MT>
int launch_mma_probe(const void* a2, const void* b, void* out, int M, int K,
                     int N, int reps, cudaStream_t stream) {
  constexpr int BM = 32 * MT;
  static bool configured[MP_MAX_DEVICES] = {};  // one per instantiation
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MP_MAX_DEVICES || !configured[dev]) {
    err = cudaFuncSetAttribute(mma_probe_kernel<T, MT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (BM + MP_BN) * (MP_MAX_KBYTES + MP_PAD));
    if (err != cudaSuccess) return (int)err;
    if (dev < MP_MAX_DEVICES) configured[dev] = true;
  }
  const size_t smem = (size_t)(BM + MP_BN) * (K * sizeof(T) + MP_PAD);
  const dim3 grid(N / MP_BN, M / BM);
  mma_probe_kernel<T, MT><<<grid, MP_THREADS, smem, stream>>>(
      static_cast<const T*>(a2), static_cast<const T*>(b),
      static_cast<typename ProbeAcc<T>::type*>(out), K, N, reps);
  return (int)cudaGetLastError();
}

}  // namespace w2x

// a2 (2, M, K) and b (K, N) row-major, s8 (dtype 0) or bf16 (dtype 1);
// out (M, N) s32 or fp32. M, K, N multiples of 32, K * sizeof(T) <= 2048,
// a2 and b 16-byte aligned.
extern "C" int w2x_mma_probe(const void* a2, const void* b, void* out, int M,
                             int K, int N, int reps, int dtype, void* stream) {
  const int elem = dtype == 0 ? 1 : 2;
  if ((dtype != 0 && dtype != 1) || M <= 0 || N <= 0 || K <= 0 || M % 32 ||
      N % 32 || K % 32 || reps < 0 || K * elem > w2x::MP_MAX_KBYTES ||
      M / 32 > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 64-row CTA tiles where they still give at least 128 CTAs (about one
  // per SM), else 32-row tiles for more CTAs
  const bool wide = M % 64 == 0 && (M / 64) * (N / w2x::MP_BN) >= 128;
  using w2x::launch_mma_probe;
  if (dtype == 0)
    return wide ? launch_mma_probe<int8_t, 2>(a2, b, out, M, K, N, reps, s)
                : launch_mma_probe<int8_t, 1>(a2, b, out, M, K, N, reps, s);
  return wide ? launch_mma_probe<w2x::bf16, 2>(a2, b, out, M, K, N, reps, s)
              : launch_mma_probe<w2x::bf16, 1>(a2, b, out, M, K, N, reps, s);
}
