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
// - The products run on wgmma (wgmma.cuh), the only way to Hopper's full
//   tensor-core rate: one warpgroup a CTA issues m64n32k16 (bf16) or
//   m64n32k32 (s8), kbytes / 32 of them a product, in one commit group, B
//   read from shared memory by matrix descriptors.
// - The (M, N) output is cut into CTA tiles of 64 x 32 (wgmma's M; rows
//   past M are zero and not stored): 128 CTAs at the ideal shape, about
//   one an SM, and 288 at the qkv shape.
// - Where K * sizeof(T) <= 512 bytes, A stays in registers for all R
//   products (64 a thread at most): shared memory then serves B alone,
//   and the small CTAs (2-3 an SM at the qkv shape) hide each other's
//   waits. Larger K reads A from shared memory too: the two operands of a
//   64 x 32 product then need 192 bytes of shared memory a clock at the
//   bf16 peak, 1.5x the SM's 128, so that path cannot pass 67% of the
//   peak. (64 x 96 tiles helped that path at the qkv and fc1 shapes, but
//   A in registers beat both, and no probe shape needs them since.)
// - Each CTA loops over the R products itself; a carry is local to its
//   output element, so no grid-wide sync is needed.
// - The B column slab (32 x K), and the A row slab (64 x K) where A is
//   not in registers, are staged once in the 128-byte-swizzled K-major
//   layout the descriptors read: A by 16-byte copies, B transposed from
//   16-byte row loads (K contiguous per column; s8 operands of wgmma must
//   be K-major). K * sizeof(T) <= 2048 bytes keeps a 64 x 32 tile within
//   227 KB (193 KB at the bf16 ideal shape).
// - Each product is awaited (wgmma.wait_group 0) before its carry is
//   added. Two accumulator sets in turn (product r + 1 in flight while the
//   carry of product r is added) made ptxas serialize every wgmma (notes
//   C7514 / C7515: accumulator registers used while a wgmma is in flight),
//   2-3.2x slower (tools/kernel_variants.py).
// - Nothing can be skipped: every wgmma is asm volatile (not hoisted out
//   of the R loop), and the carry is taken as written, acc >> 31 and
//   fmaf(acc, 0.f, d) (the library builds without --use_fast_math).
#include "common.cuh"
#include "tensor_core.cuh"
#include "wgmma.cuh"

namespace w2x {

constexpr int MP_THREADS = 128;      // one warpgroup
constexpr int MP_BM = 64;            // CTA tile rows: wgmma's M
constexpr int MP_BN = 32;            // CTA tile columns: wgmma's N
constexpr int MP_ACC = MP_BN / 2;    // accumulator values a thread
constexpr int MP_MAX_KBYTES = 2048;  // K * sizeof(T) at most
constexpr int MP_SMEM_ALIGN = 1024;  // the swizzle atom
// K * sizeof(T) up to which A stays in registers (64 a thread)
constexpr int MP_REGA_MAX_KBYTES = 512;

using bf16 = __nv_bfloat16;

template <typename T>
struct Probe;
template <>
struct Probe<int8_t> {
  using Acc = int;
  // d + carry(acc), the TPU kernel's loop body after its dot
  static __device__ __forceinline__ int carry_add(int acc, int d) {
    return d + (acc >> 31);
  }
};
template <>
struct Probe<bf16> {
  using Acc = float;
  static __device__ __forceinline__ float carry_add(float acc, float d) {
    return fmaf(acc, 0.f, d);
  }
};

// One product a2[0] @ b into d, then its carry into acc: `steps` k steps
// (kbytes / 32) of wgmma m64n32, A from registers (af) or shared memory,
// committed as one group and awaited. The loop is unrolled to the most
// steps there can be and left at `steps`: a k loop that runs at run time,
// one or four steps a pass, was 10-90% slower (tools/kernel_variants.py).
template <typename T, bool REG_A, int NA>
__device__ __forceinline__ void product_carry(
    typename Probe<T>::Acc (&acc)[MP_ACC], typename Probe<T>::Acc (&d)[MP_ACC],
    const uint32_t (&af)[NA][4], uint32_t sa, uint32_t sb, int steps) {
  using Acc = typename Probe<T>::Acc;
  wg::fence_operands(d);
  wg::fence();  // the carry read d since its last product
#pragma unroll
  for (int s = 0; s < (REG_A ? NA : MP_MAX_KBYTES / 32); ++s) {
    if (s >= steps) break;
    const uint32_t blk = s >> 2, k = (s & 3) * 32;  // 4 steps a block
    const uint64_t db = wg::desc_sw128(sb + blk * (MP_BN * 128) + k);
    if constexpr (REG_A)
      wg::MmaRegA<MP_BN, Acc>::run(d, af[s], db, s > 0);
    else
      wg::Mma<MP_BN, Acc>::run(
          d, wg::desc_sw128(sa + blk * (MP_BM * 128) + k), db, s > 0);
  }
  wg::commit();
  wg::wait<0>();
  wg::fence_operands(d);
#pragma unroll
  for (int i = 0; i < MP_ACC; ++i)
    acc[i] = Probe<T>::carry_add(acc[i], d[i]);
}

// A CTA computes the 64 x 32 output tile (blockIdx.y, blockIdx.x) over all
// reps products; REG_A: A in registers (K * sizeof(T) <= MP_REGA_MAX_KBYTES)
template <typename T, bool REG_A>
__global__ void __launch_bounds__(MP_THREADS, 1)
mma_probe_kernel(const T* __restrict__ a, const T* __restrict__ b,
                 typename Probe<T>::Acc* __restrict__ out, int M, int K,
                 int N, int reps) {
  using Acc = typename Probe<T>::Acc;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = tc::smem_u32(smem_raw);
  unsigned char* sa =
      smem_raw + (((raw + MP_SMEM_ALIGN - 1) & ~(MP_SMEM_ALIGN - 1)) - raw);
  const int kb = K * (int)sizeof(T);      // bytes of one operand row
  const int kpad = (kb + 127) & ~127;     // whole 128-byte blocks
  unsigned char* sb = sa + (REG_A ? 0 : MP_BM * kpad);  // B^T: 32 rows
  const int m0 = blockIdx.y * MP_BM, n0 = blockIdx.x * MP_BN;

  // stage the A slab by 16-byte copies (rows past M as zeros); the B slab
  // transposed, each thread reading 16 bytes of a row of b (VEC columns at
  // one k) and scattering them down the rows of the K-major slab
  const unsigned char* ga =
      reinterpret_cast<const unsigned char*>(a + (size_t)m0 * K);
  const int pieces = kb / 16;
  for (int i = threadIdx.x; i < (REG_A ? 0 : MP_BM * pieces);
       i += MP_THREADS) {
    const int r = i / pieces, c = i - r * pieces;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (m0 + r < M)
      v = *reinterpret_cast<const uint4*>(ga + (size_t)r * kb + c * 16);
    *reinterpret_cast<uint4*>(sa + wg::sw128_offset(r, c * 16, MP_BM)) = v;
  }
  // or A's register fragments (wgmma.cuh MmaRegA), rows past M as zeros
  constexpr int NA = REG_A ? MP_REGA_MAX_KBYTES / 32 : 1;
  uint32_t af[NA][4];
  if constexpr (REG_A) {
    const int row = 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2);
    const int q4 = 4 * (threadIdx.x & 3);
#pragma unroll
    for (int s = 0; s < NA; ++s) {
      if (s >= kb / 32) break;
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // rows row, row + 8; bytes +0, +16
        const int r = row + 8 * (j & 1), byte = 32 * s + 16 * (j >> 1) + q4;
        af[s][j] = m0 + r < M ? *reinterpret_cast<const uint32_t*>(
                                    ga + (size_t)r * kb + byte)
                              : 0u;
      }
    }
  }
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int ROW_VECS = MP_BN / VEC;  // 16-byte pieces of a slab row
  for (int i = threadIdx.x; i < K * ROW_VECS; i += MP_THREADS) {
    const int k = i / ROW_VECS, n = (i - k * ROW_VECS) * VEC;
    const uint4 raw16 =
        *reinterpret_cast<const uint4*>(b + (size_t)k * N + n0 + n);
    const T* v = reinterpret_cast<const T*>(&raw16);
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      *reinterpret_cast<T*>(
          sb + wg::sw128_offset(n + j, k * (int)sizeof(T), MP_BN)) = v[j];
  }
  wg::fence_proxy_async();
  __syncthreads();  // (and wgmma.fence in product_carry for af)

  const uint32_t sa32 = tc::smem_u32(sa), sb32 = tc::smem_u32(sb);
  Acc acc[MP_ACC], d[MP_ACC];
#pragma unroll
  for (int i = 0; i < MP_ACC; ++i) acc[i] = d[i] = Acc(0);
#pragma unroll 1
  for (int r = 0; r < reps; ++r)
    product_carry<T, REG_A>(acc, d, af, sa32, sb32, kb / 32);

  // the accumulator fragment map of wgmma.cuh
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < MP_ACC; i += 2) {
    const int row = m0 + 16 * warp + g + 8 * ((i >> 1) & 1);
    const int col = n0 + 8 * (i >> 2) + 2 * q;
    if (row < M) {
      Acc* o = out + (size_t)row * N + col;
      o[0] = acc[i];
      o[1] = acc[i + 1];
    }
  }
}

template <typename T, bool REG_A>
int launch_mma_probe(const void* a2, const void* b, void* out, int M, int K,
                     int N, int reps, cudaStream_t stream) {
  // the B slab, and the A slab unless A is in registers, in whole 128-byte
  // blocks of K, from a 1024-byte-aligned base
  const int smem = ((REG_A ? 0 : MP_BM) + MP_BN) *
                       ((K * (int)sizeof(T) + 127) & ~127) +
                   MP_SMEM_ALIGN;
  const cudaError_t err = cudaFuncSetAttribute(
      mma_probe_kernel<T, REG_A>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(N / MP_BN, (M + MP_BM - 1) / MP_BM);
  mma_probe_kernel<T, REG_A><<<grid, MP_THREADS, smem, stream>>>(
      static_cast<const T*>(a2), static_cast<const T*>(b),
      static_cast<typename Probe<T>::Acc*>(out), M, K, N, reps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_mma_probe(const void* a2, const void* b, void* out, int M, int K,
                     int N, int reps, cudaStream_t stream) {
  if (K * (int)sizeof(T) <= MP_REGA_MAX_KBYTES)  // A in registers
    return launch_mma_probe<T, true>(a2, b, out, M, K, N, reps, stream);
  return launch_mma_probe<T, false>(a2, b, out, M, K, N, reps, stream);
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
  if (dtype == 0)
    return w2x::launch_mma_probe<int8_t>(a2, b, out, M, K, N, reps, s);
  return w2x::launch_mma_probe<w2x::bf16>(a2, b, out, M, K, N, reps, s);
}
