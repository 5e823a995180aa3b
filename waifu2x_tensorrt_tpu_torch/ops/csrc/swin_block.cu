// Kernel B: one whole pre-norm Swin block on window tokens.
//
// Replaces the TPU kernel waifu2x_tensorrt_tpu/ops/swin_block.py
// fused_swin_block (pallas_call at :269, body _block_body :42):
//   LN1 -> qkv GEMM + bias -> per-head window attention (rel bias, shift
//   mask, exact softmax) -> proj GEMM + bias -> residual -> LN2 -> fc1
//   (C -> 2C) -> erf GELU -> fc2 -> residual
// on x (BW, 64, C), C = 32 * nh (96/3 and 192/6 on the flagship).
//
// Both instantiations read x and write out as (B, H, W, C) activations
// (H, W multiples of 8) rolled by `roll` pixels (Geometry, WindowRows
// below): window win is (b, wy, wx) of B x H/8 x W/8, and its token
// (i, j) lies at row (8 wy + i + roll) mod H and column (8 wx + j + roll)
// mod W of image b. Reading and writing through that address function is
// the cyclic roll, the window partition and their inverses in one step,
// so the model calls the kernel on its activation with no copy around it.
// A token is C contiguous values, so the loads and stores keep their
// 16-byte and 32-bit accesses. The windowed (BW, 64, C) layout is the
// case H = W = 8, roll 0.
//
// What bounds it on the H100: 1024 * C^2 + 524288 * nh FLOP per window
// (45 GFLOP per launch at BW 4096, C 96; 42 at BW 1024, C 192) against
// 4 * 64 * C bytes of activations in and out (101 MB; 50 MB), so the
// tensor cores bound it: ~0.046 ms and ~0.042 ms at 989 TFLOP/s.
//
// Two instantiations, chosen by dtype:
//
// bf16 (swin_block_tc_kernel, the main path): all six products (qkv,
// q k^T, p v, proj, fc1, fc2) on the tensor cores with mma.sync m16n8k16
// (bf16 operands, fp32 accumulators) fed by ldmatrix. mma.sync, not
// wgmma, is a design choice of this first tensor-core version: its
// fragments are per-warp and need no shared-memory descriptors, so the
// per-head attention and the chunked MLP can chain one product's output
// into the next from registers; wgmma is later work.
//   - One CTA holds TC_WPC = 2 windows (8 warps); each warp owns 16 rows of
//     one window and keeps them in registers or in its own rows of shared
//     memory. Only K and V are shared by the 4 warps of a window.
//   - The weights stream through a 2-stage ring of shared-memory tiles
//     (cp.async, 16-byte copies), read in nn.Linear's (out, in) layout, K
//     contiguous, which is what ldmatrix wants for the B operand. Each tile
//     serves both windows of the CTA, so L2 weight reads per launch halve
//     against one CTA per window. One CTA barrier per tile.
//   - x arrives by cp.async into the LN rows; both LayerNorms are two-pass
//     fp32 in the accumulator layout (a row's quad reduces by shuffles).
//   - Attention one head at a time without touching shared memory for
//     scores: q_h (16 x 32) is computed per warp and converted from
//     accumulators to an A fragment; the 16 x 64 fp32 score tile lives in
//     registers, starting from the relative bias; the shift mask and the
//     exact max-subtracted softmax run without branches (a masked entry's
//     exp is computed, then dropped), and p = e / sum is the correctly
//     rounded quotient through the row's reciprocal and one exact-remainder
//     FMA step; the bf16 probabilities feed p v from registers; each
//     head's bf16 output feeds proj at once: proj = sum_h O_h Wproj[h], so
//     neither the scores nor the concatenated heads are stored.
//   - The MLP runs in 32-column hidden chunks: fc1 chunk -> GELU -> bf16
//     -> accumulate into fc2's 16 x C accumulators; the 64 x 2C hidden is
//     never stored.
//   - A ragged last CTA (BW odd) computes its empty slot on a copy of the
//     last window and stores nothing for it.
//   - Shared memory: 2 weight stages + per window the LN rows (64 x C+8)
//     and [K | V] (64 x 2C+8): 104 KB at C 96 (two CTAs per SM, 128
//     registers a thread), 203 KB at C 192 (one CTA per SM, 255).
//   What holds it near 12% of the bound (phase clocks of
//   tools/block_phase_clock.py, PERF.md): latency. A CTA's cycles go to
//   fc1 + GELU (~25%), q_h and the softmax (~27%), and the loads,
//   LayerNorms and stores (~25%), with 16 (C 96) or 8 (C 192) warps per
//   SM to hide short dependent mma.sync chains and the CUDA-core work
//   between them.
//
// fp32 (swin_block_f32_kernel, the CLI's tf32 precision): bf16's dataflow
// with register-tiled fp32 FMA on the CUDA cores in place of mma.sync (no
// TF32: the fp32 checks hold it to 1e-4 of the plain twin). Its bound is
// operations at the CUDA cores' 67 TFLOP/s: 0.673 ms at (BW 4096, C 96),
// 0.625 ms at (1024, 192), ~8x above bytes.
//   - What holds a register-tiled product back on this card is the shared
//     memory's 128 bytes a clock: a warp's 128-bit load costs 4 of them
//     whatever its lanes share, so a thread's TM x TN output tile needs
//     TM TN / (TM + TN) >= 4 FMAs per loaded value to keep the FMA pipes
//     fed. Registers cap the tile: proj's (and fc2's) 64 x C sum lives in
//     registers for the whole heads loop (MLP chunks).
//   - So 4 warps a window: each thread owns rows rg + 16 i (i < 4) and
//     columns 4 cg + 32 s + e of a product (4 x 12 of proj at C 96, 4 x 24
//     at C 192; q, k and v of a head in one 4 x 12 product). Two windows a
//     CTA at C <= 96 (8 warps, 112 KB, 128 registers: 2 CTAs = 16 warps an
//     SM), one above (4 warps, 98 KB at C 192, up to 255 registers for the
//     96-register proj sum: 2 CTAs = 8 warps an SM). C 192 with 8 warps a
//     window and 2 x 24 tiles ran 11% slower (tools/kernel_variants.py).
//   - The weights stream through a 2-stage ring of shared-memory K-tiles
//     ((in, out) rows, 16-byte cp.async) in the order they are consumed;
//     each tile serves every row of the CTA, so no window reads the
//     weights from L2 for itself. One CTA barrier a tile. A's rows (the
//     LayerNorm output) are stored with XOR-swizzled 16-byte chunks, so a
//     warp's 4 row reads hit 4 bank groups. LayerNorms reduce a row over
//     its 8 lanes by shuffles.
//   - Attention one head at a time: q, k and v of the head only (26 KB a
//     window), each warp its 16 rows in two calls of
//     attn_f32::head_attention (attention_f32.cuh, shared with kernels A
//     and E: scores in registers, masked without branches, softmax by
//     shuffles); the head's output overwrites its q rows and goes into
//     proj at once: proj = sum_h O_h Wproj[h] in registers.
//   - x1 = x + proj waits in the output rows (each thread reads back its
//     own values) while the MLP runs in HC-column hidden chunks: fc1
//     chunk -> GELU -> the chunk's rows (in the dead q | k | v space) ->
//     into fc2's accumulators. The 64 x 2C hidden is never stored.
//   - A ragged last CTA (odd BW, two windows a CTA) computes its empty
//     slot on a copy of the last window and stores nothing for it.
//   Measured on an H100 (tools/kernel_times.py, PERF.md section 6): 1.69
//   ms at (BW 4096, C 96), 40% of the bound, and 1.57 ms at (1024, 192),
//   40% (1.50 ms with windowed addressing, before the activation layout:
//   its row wraps cost registers at C 192): 0.58x and 0.93x a chain of
//   fp32 library calls for the same block, against 4.58 / 6.35 ms for the
//   first port's kernel. Its phase clocks and the layouts it was chosen
//   against (tools/kernel_variants.py --kernel B32): PERF.md.
//
// Rounding points mirror _block_body (swin_block.py:67-177) in both: LN
// output rounded to T; GEMMs accumulate in fp32, add the fp32 bias, then
// round to T; q*scale rounded to T; probabilities rounded to T before
// p v; each head's output rounded to T before proj; GELU on the fp32
// pre-activation; the residual adds round to T. Only the order of the
// fp32 sums differs between the two and from the plain twin.
#include <type_traits>

#include "attention_f32.cuh"
#include "common.cuh"
#include "tensor_core.cuh"

namespace w2x {

struct BlockParams {
  const float* n1s;
  const float* n1b;
  const void* qkvk;  // T = float: (C, 3C); bf16: (3C, C) = (out, in)
  const float* qkvb;
  const void* projk;  // float: (C, C) (in, out); bf16: (out, in)
  const float* projb;
  const float* n2s;
  const float* n2b;
  const void* fc1k;  // float: (C, 2C); bf16: (2C, C)
  const float* fc1b;
  const void* fc2k;  // float: (2C, C); bf16: (C, 2C)
  const float* fc2b;
};

constexpr int kMaxDevices = 64;

// Every C the kernels are instantiated for (with_width below dispatches
// over them), one bf16 and one fp32 kernel each: the kernels that
// set_smem_limit keeps a flag for.
constexpr int kWidths[] = {32, 64, 96, 128, 160, 192};
constexpr int kNumWidths = sizeof(kWidths) / sizeof(kWidths[0]);
constexpr int kKernels = 2 * kNumWidths;

constexpr bool is_width(int c) {
  for (int w : kWidths)
    if (w == c) return true;
  return false;
}

// f(std::integral_constant<int, C>{}) for C of kWidths, else an error.
template <int I = 0, class F>
int with_width(int C, F&& f) {
  if constexpr (I == kNumWidths) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (C == kWidths[I]) return f(std::integral_constant<int, kWidths[I]>{});
    return with_width<I + 1>(C, f);
  }
}

namespace {

// Raise a kernel's dynamic shared-memory limit to `bytes`, once per kernel
// and device. The flags are kept here, in a function of internal linkage
// that is no template: a static local of a template (or inline) function
// is a GNU unique symbol, which the dynamic loader binds once per process
// even under RTLD_LOCAL, so every copy of this library loaded into one
// process (a variant built with other flags, a build in another directory)
// would share one flag, and a second copy would skip the attribute for its
// own kernel and fail to launch. Keyed by the kernel's host stub, which is
// this copy's own.
int set_smem_limit(const void* kernel, int bytes) {
  static const void* done[kMaxDevices][kKernels] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const void** mine = dev < kMaxDevices ? done[dev] : nullptr;
  for (int i = 0; mine && i < kKernels; ++i)
    if (mine[i] == kernel) return 0;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return (int)err;
  for (int i = 0; mine && i < kKernels; ++i)
    if (!mine[i]) {
      mine[i] = kernel;
      break;
    }
  return 0;
}

}  // namespace

// x and out of a launch: (B, H, W, C), H and W multiples of 8, rolled by
// `roll` (0 <= roll < 8) pixels up and left.
struct Geometry {
  int h, w, roll;
};

// Where the tokens of window `win` lie: token r (row r / 8, column r % 8
// of the window) is the activation's token index token(r), (b H + y) W +
// x. Since roll < 8 <= H, W, one wrap at the bottom and right edges
// suffices. 32-bit: the wrapper keeps B H W C below 2^31.
struct WindowRows {
  int img, y0, x0, h, w;
  __device__ __forceinline__ WindowRows(const Geometry& g, int win)
      : h(g.h), w(g.w) {
    const int nwx = g.w / WS, nw = (g.h / WS) * nwx;
    const int b = win / nw, k = win - b * nw, wy = k / nwx;
    img = b * g.h * g.w;
    y0 = WS * wy + g.roll;
    x0 = WS * (k - wy * nwx) + g.roll;
  }
  __device__ __forceinline__ int token(int r) const {
    int y = y0 + r / WS, x = x0 + r % WS;
    if (y >= h) y -= h;
    if (x >= w) x -= w;
    return img + y * w + x;
  }
};

// v, which the compiler may not assume equal to v: a WindowRows built on
// it is computed anew rather than kept in registers from an earlier one
// (the fp32 kernel builds one before the heads loop and two after it; kept
// live across the loop, its values cost that loop spilled registers).
__device__ __forceinline__ int opaque(int v) {
  asm volatile("" : "+r"(v));
  return v;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores, weights staged in shared memory
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

// Phase clocks, in a measurement build only (nvcc -DW2X_PHASE_CLOCK; see
// tools/block_phase_clock.py): thread 0 of every CTA adds the clock64()
// cycles since the previous clock point into w2x_phase_cycles[i] at point
// i (0 x + LN1, 1 K | V tiles, per head 8 bias + q (fp32: q, k, v), 9
// q k^T (fp32: the attention), 10 softmax, 11 p v, 2 proj, 3 x1 + LN2,
// per MLP chunk 12 fc1 + GELU, 4 fc2, 5 output store), its waits at the
// weight-tile barriers into [6] and 1 into [7] (the CTA count). The main
// build compiles none of it.
#ifdef W2X_PHASE_CLOCK
__device__ unsigned long long w2x_phase_cycles[16];
#define W2X_CLOCK_START()                                         \
  long long w2x_t = clock64();                                    \
  if (threadIdx.x == 0) atomicAdd(&w2x_phase_cycles[7], 1ull)
#define W2X_CLOCK_PHASE(i)                                        \
  do {                                                            \
    const long long now = clock64();                              \
    if (threadIdx.x == 0)                                         \
      atomicAdd(&w2x_phase_cycles[i],                             \
                (unsigned long long)(now - w2x_t));               \
    w2x_t = now;                                                  \
  } while (0)
#define W2X_CLOCK_BEGIN_WAIT() const long long w2x_w = clock64()
#define W2X_CLOCK_END_WAIT()                                      \
  if (threadIdx.x == 0)                                           \
  atomicAdd(&w2x_phase_cycles[6], (unsigned long long)(clock64() - w2x_w))
#else
#define W2X_CLOCK_START()
#define W2X_CLOCK_PHASE(i)
#define W2X_CLOCK_BEGIN_WAIT()
#define W2X_CLOCK_END_WAIT()
#endif

constexpr int TC_WPC = 2;                 // windows per CTA
constexpr int TC_WARPS = 4 * TC_WPC;      // 4 warps x 16 rows per window
constexpr int TC_THREADS = 32 * TC_WARPS;

template <int C>
struct TcLayout {
  static constexpr int NH = C / HD;
  static constexpr int LDH = C + 8;       // LN-output rows (elements)
  static constexpr int LDKV = 2 * C + 8;  // [K | V] rows; later x1
  static constexpr int LDS = HD + 8;      // rows of a 32-column weight slab
  // Row strides are an odd number of 16-byte units, so the 8 row addresses
  // of one ldmatrix fall in 8 different bank groups.
  static_assert(C % HD == 0 && C >= HD && C <= 192, "C = 32 * nh <= 192");
  static_assert((LDH * 2 / 16) % 2 == 1 && (LDKV * 2 / 16) % 2 == 1 &&
                    (LDS * 2 / 16) % 2 == 1,
                "ldmatrix row strides must be odd multiples of 16 bytes");
  // A weight tile: 64 rows of Wqkv (K | V) as 64 x LDH, or a pair for one
  // head / MLP chunk: 32 rows (HD x LDH) + a C x 32 column slab (C x LDS).
  static constexpr int KV_TILE = 64 * LDH;
  static constexpr int PAIR_TILE = HD * LDH + C * LDS;
  static constexpr int STAGE = KV_TILE > PAIR_TILE ? KV_TILE : PAIR_TILE;
  static constexpr int WIN = NTOK * (LDH + LDKV);  // per window
  static constexpr size_t SMEM = (size_t)(2 * STAGE + TC_WPC * WIN) * 2;
  static constexpr int KV_TILES = 2 * C / 64;
  static constexpr int MLP_TILES = 2 * C / HD;
  static constexpr int TILES = KV_TILES + NH + MLP_TILES;
};

// rows x cols (cols % 8 == 0) of a bf16 matrix with row stride lds into
// shared memory with row stride ldd; every thread of the CTA takes part
template <int ROWS, int COLS>
__device__ __forceinline__ void tile_async(bf16* dst, int ldd, const bf16* src,
                                           int lds) {
  constexpr int PER_ROW = COLS / 8;
  for (int i = threadIdx.x; i < ROWS * PER_ROW; i += TC_THREADS) {
    const int r = i / PER_ROW, c = (i - r * PER_ROW) * 8;
    tc::cp_async16(dst + r * ldd + c, src + (size_t)r * lds + c);
  }
}

// The weight tiles in the order the block consumes them, double-buffered:
// acquire(t) waits for tile t and syncs the CTA -- after which every warp
// is done with tile t-1 -- and starts tile t+1's copy into t-1's stage.
// One CTA barrier per tile.
template <int C>
struct WeightStream {
  using L = TcLayout<C>;
  bf16* stages;
  const bf16* wqkv;   // (3C, C)
  const bf16* wproj;  // (C, C)
  const bf16* wfc1;   // (2C, C)
  const bf16* wfc2;   // (C, 2C)

  __device__ void load(int t) {
    bf16* st = stages + (t & 1) * L::STAGE;
    if (t < L::KV_TILES) {  // rows C + 64t .. of Wqkv: K then V columns
      tile_async<64, C>(st, L::LDH, wqkv + (size_t)(C + 64 * t) * C, C);
    } else if (t < L::KV_TILES + L::NH) {  // head h: Wq rows, Wproj columns
      const int h = t - L::KV_TILES;
      tile_async<HD, C>(st, L::LDH, wqkv + (size_t)h * HD * C, C);
      tile_async<C, HD>(st + HD * L::LDH, L::LDS, wproj + h * HD, C);
    } else {  // MLP chunk j: Wfc1 rows, Wfc2 columns
      const int j = t - L::KV_TILES - L::NH;
      tile_async<HD, C>(st, L::LDH, wfc1 + (size_t)j * HD * C, C);
      tile_async<C, HD>(st + HD * L::LDH, L::LDS, wfc2 + j * HD, 2 * C);
    }
    tc::cp_async_commit();
  }
  __device__ const bf16* acquire(int t) {
    W2X_CLOCK_BEGIN_WAIT();
    tc::cp_async_wait<0>();
    __syncthreads();
    W2X_CLOCK_END_WAIT();
    if (t + 1 < L::TILES) load(t + 1);
    return stages + (t & 1) * L::STAGE;
  }
};

// acc (16 x 8*NT) += A (16 x K, shared, row stride lda) * W^T, where W is
// (8*NT x K) in shared memory with row stride ldw (the (out, in) layout).
template <int NT, int K>
__device__ __forceinline__ void mma_smem(float (&acc)[NT][4], const bf16* a,
                                         int lda, const bf16* w, int ldw) {
  static_assert(NT % 2 == 0 && K % 16 == 0, "tile shape");
  const int lane = threadIdx.x & 31;
  const bf16* arow = a + (lane & 15) * lda + (lane >> 4) * 8;
  const bf16* wrow = w + ((lane & 7) + ((lane >> 4) << 3)) * ldw +
                     ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t af[4];
    tc::ldsm_x4(af, arow + k0);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t b[4];
      tc::ldsm_x4(b, wrow + j * 8 * ldw + k0);
      tc::mma_bf16(acc[j], af, b[0], b[1]);
      tc::mma_bf16(acc[j + 1], af, b[2], b[3]);
    }
  }
}

// acc (16 x 8*NT) += A (16 x 32, two k16 fragments in registers) * W^T,
// W (8*NT x 32) in shared memory with row stride ldw
template <int NT>
__device__ __forceinline__ void mma_regs_k32(float (&acc)[NT][4],
                                             const uint32_t (&a)[2][4],
                                             const bf16* w, int ldw) {
  const int lane = threadIdx.x & 31;
  const bf16* wrow = w + ((lane & 7) + ((lane >> 4) << 3)) * ldw +
                     ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t b[4];
      tc::ldsm_x4(b, wrow + j * 8 * ldw + s * 16);
      tc::mma_bf16(acc[j], a[s], b[0], b[1]);
      tc::mma_bf16(acc[j + 1], a[s], b[2], b[3]);
    }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.7071067811865476f));
}

// Two-pass fp32 LayerNorm of this thread's two rows, held in the
// accumulator layout (v[j][0..1]: row a, columns 8j+2t and 8j+2t+1;
// v[j][2..3]: row b); each row's quad reduces with shuffles. The result is
// rounded to bf16 into the rows da and db (same columns).
template <int NC>
__device__ __forceinline__ void layernorm_frag(const float (&v)[NC][4],
                                               const float* __restrict__ s,
                                               const float* __restrict__ b,
                                               bf16* da, bf16* db) {
  constexpr float c = (float)(NC * 8);
  const int t = threadIdx.x & 3;
  float sa = 0.f, sb = 0.f;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    sa += v[j][0] + v[j][1];
    sb += v[j][2] + v[j][3];
  }
  const float ma = quad_sum(sa) / c, mb = quad_sum(sb) / c;
  float qa = 0.f, qb = 0.f;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    float d;
    d = v[j][0] - ma; qa = fmaf(d, d, qa);
    d = v[j][1] - ma; qa = fmaf(d, d, qa);
    d = v[j][2] - mb; qb = fmaf(d, d, qb);
    d = v[j][3] - mb; qb = fmaf(d, d, qb);
  }
  const float ia = 1.f / sqrtf(quad_sum(qa) / c + 1e-5f);
  const float ib = 1.f / sqrtf(quad_sum(qb) / c + 1e-5f);
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int col = 8 * j + 2 * t;
    const float s0 = s[col], s1 = s[col + 1], b0 = b[col], b1 = b[col + 1];
    *reinterpret_cast<uint32_t*>(da + col) = tc::pack_bf16(
        (v[j][0] - ma) * ia * s0 + b0, (v[j][1] - ma) * ia * s1 + b1);
    *reinterpret_cast<uint32_t*>(db + col) = tc::pack_bf16(
        (v[j][2] - mb) * ib * s0 + b0, (v[j][3] - mb) * ib * s1 + b1);
  }
}

template <int C>
__global__ void __launch_bounds__(TC_THREADS, C <= 96 ? 2 : 1)
swin_block_tc_kernel(const bf16* __restrict__ x, BlockParams p,
                     const float* __restrict__ bias,
                     const int* __restrict__ flags, bf16* __restrict__ out,
                     int bw, int shift, Geometry geo) {
  using L = TcLayout<C>;
  constexpr int NC = C / 8;  // n8 tiles across C
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int slot = warp >> 2;       // window slot of this warp in the CTA
  const int r0 = (warp & 3) * 16;   // this warp's first row in its window
  const int win_raw = blockIdx.x * TC_WPC + slot;
  const bool live = win_raw < bw;   // the last CTA may hold one window
  const int win = live ? win_raw : bw - 1;
  bf16* hbuf = smem + 2 * L::STAGE + slot * L::WIN;  // 64 x LDH: x, LN1, LN2
  bf16* kv = hbuf + NTOK * L::LDH;                   // 64 x LDKV: K | V, x1
  bf16* hrows = hbuf + r0 * L::LDH;                  // this warp's rows
  const int ra = r0 + g, rb = r0 + g + 8;  // this thread's two rows
  W2X_CLOCK_START();

  // this warp's 16 rows of x -> hbuf (one copy group), then weight tile 0
  {
    const WindowRows rows(geo, win);
#pragma unroll
    for (int i = lane; i < 16 * (C / 8); i += 32) {
      const int r = i / (C / 8), c = (i - r * (C / 8)) * 8;
      tc::cp_async16(hrows + r * L::LDH + c, x + rows.token(r0 + r) * C + c);
    }
  }
  tc::cp_async_commit();
  WeightStream<C> ws{smem, static_cast<const bf16*>(p.qkvk),
                     static_cast<const bf16*>(p.projk),
                     static_cast<const bf16*>(p.fc1k),
                     static_cast<const bf16*>(p.fc2k)};
  ws.load(0);
  tc::cp_async_wait<1>();  // x has landed (tile 0 may still be in flight)
  __syncwarp();
  {  // LN1(x) in place
    float xv[NC][4];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int col = 8 * j + 2 * t;
      const float2 a = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(hbuf + ra * L::LDH + col));
      const float2 b = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(hbuf + rb * L::LDH + col));
      xv[j][0] = a.x;
      xv[j][1] = a.y;
      xv[j][2] = b.x;
      xv[j][3] = b.y;
    }
    layernorm_frag<NC>(xv, p.n1s, p.n1b, hbuf + ra * L::LDH,
                       hbuf + rb * L::LDH);
  }
  __syncwarp();
  W2X_CLOCK_PHASE(0);

  // K | V = LN1(x) Wqkv[C:3C] + b for this warp's rows -> kv
  for (int tile = 0; tile < L::KV_TILES; ++tile) {
    const bf16* wt = ws.acquire(tile);
    float acc[8][4];
    zero(acc);
    mma_smem<8, C>(acc, hrows, L::LDH, wt, L::LDH);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * tile + 8 * j + 2 * t;
      const float b0 = p.qkvb[C + col], b1 = p.qkvb[C + col + 1];
      *reinterpret_cast<uint32_t*>(kv + ra * L::LDKV + col) =
          tc::pack_bf16(acc[j][0] + b0, acc[j][1] + b1);
      *reinterpret_cast<uint32_t*>(kv + rb * L::LDKV + col) =
          tc::pack_bf16(acc[j][2] + b0, acc[j][3] + b1);
    }
  }
  W2X_CLOCK_PHASE(1);

  // keep bits of this thread's 32 score entries: bit 4j + e of s[j][e]
  uint32_t keep = 0xffffffffu;
  if (shift) {
    const int fl = flags[win];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = (e & 2) ? rb : ra, col = 8 * j + 2 * t + (e & 1);
        if (!keep_entry(fl, i, col, shift)) keep &= ~(1u << (4 * j + e));
      }
  }
  // jnp.asarray(32 ** -0.5, bf16): the scale itself is rounded
  const float scale = round_to<bf16>(0.17677669529663687f);
  const bf16* krow = kv + ((lane & 7) + ((lane >> 4) << 3)) * L::LDKV +
                     ((lane >> 3) & 1) * 8;
  const bf16* vrow = kv + ((lane & 7) + ((lane >> 3) & 1) * 8) * L::LDKV + C +
                     (lane >> 4) * 8;

  float pacc[NC][4];  // proj accumulators: sum over heads of O_h Wproj[h]
  zero(pacc);
  for (int h = 0; h < L::NH; ++h) {
    // the acquire barrier also orders the K | V stores before these reads
    const bf16* wt = ws.acquire(L::KV_TILES + h);
    float s[8][4];  // scores of rows ra, rb against the 64 tokens, from
    {               // the relative bias (loaded first: its latency hides
      const float* bh = bias + (size_t)h * NTOK * NTOK;  // behind q_h)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 8 * j + 2 * t;
        const float2 ba = *reinterpret_cast<const float2*>(bh + ra * NTOK + col);
        const float2 bb = *reinterpret_cast<const float2*>(bh + rb * NTOK + col);
        s[j][0] = ba.x;
        s[j][1] = ba.y;
        s[j][2] = bb.x;
        s[j][3] = bb.y;
      }
    }
    uint32_t qa[2][4];
    {  // q_h = LN1(x) Wq[h] + b, rounded, times scale, rounded
      float q[4][4];
      zero(q);
      mma_smem<4, C>(q, hrows, L::LDH, wt, L::LDH);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = h * HD + 8 * j + 2 * t;
        const float b0 = p.qkvb[col], b1 = p.qkvb[col + 1];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = round_to<bf16>(q[j][e] + ((e & 1) ? b1 : b0));
          q[j][e] = v * scale;  // rounded by to_a_frag
        }
      }
      tc::to_a_frag(qa[0], q[0], q[1]);
      tc::to_a_frag(qa[1], q[2], q[3]);
    }
    W2X_CLOCK_PHASE(8);
    // s += (q * scale) k^T
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        uint32_t b[4];
        tc::ldsm_x4(b, krow + j * 8 * L::LDKV + h * HD + k * 16);
        tc::mma_bf16(s[j], qa[k], b[0], b[1]);
        tc::mma_bf16(s[j + 1], qa[k], b[2], b[3]);
      }
    W2X_CLOCK_PHASE(9);
    // exact softmax over the kept entries (masked -> exactly 0), without
    // branches: a masked entry's exp is computed and then dropped
    float ma = -INFINITY, mb = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = (keep >> (4 * j + e) & 1) ? s[j][e] : -INFINITY;
        if (e & 2)
          mb = fmaxf(mb, v);
        else
          ma = fmaxf(ma, v);
      }
    ma = quad_max(ma);
    mb = quad_max(mb);
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = expf(s[j][e] - ((e & 2) ? mb : ma));
        s[j][e] = (keep >> (4 * j + e) & 1) ? v : 0.f;
        if (e & 2)
          sb += s[j][e];
        else
          sa += s[j][e];
      }
    sa = quad_sum(sa);
    sb = quad_sum(sb);
    // p = e / sum, correctly rounded: the row's correctly rounded
    // reciprocal, a product, and one exact-remainder correction (Markstein)
    const float ia = __frcp_rn(sa), ib = __frcp_rn(sb);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float d = (e & 2) ? sb : sa, r = (e & 2) ? ib : ia;
        const float q = s[j][e] * r;
        s[j][e] = fmaf(fmaf(-q, d, s[j][e]), r, q);
      }
    uint32_t pa[4][4];  // probabilities, rounded to bf16, as A fragments
#pragma unroll
    for (int k = 0; k < 4; ++k) tc::to_a_frag(pa[k], s[2 * k], s[2 * k + 1]);
    W2X_CLOCK_PHASE(10);
    // O_h = P V_h (16 x 32)
    float o[4][4];
    zero(o);
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        uint32_t b[4];
        tc::ldsm_x4_trans(b, vrow + k * 16 * L::LDKV + h * HD + j * 8);
        tc::mma_bf16(o[j], pa[k], b[0], b[1]);
        tc::mma_bf16(o[j + 1], pa[k], b[2], b[3]);
      }
    uint32_t oa[2][4];  // O_h rounded to bf16
    tc::to_a_frag(oa[0], o[0], o[1]);
    tc::to_a_frag(oa[1], o[2], o[3]);
    W2X_CLOCK_PHASE(11);
    mma_regs_k32<NC>(pacc, oa, wt + HD * L::LDH, L::LDS);
    W2X_CLOCK_PHASE(2);
  }

  // x1 = x + round(attn Wproj + b), in place of pacc
  {
    const WindowRows rows(geo, win);
    const bf16* xa_row = x + rows.token(ra) * C;
    const bf16* xb_row = x + rows.token(rb) * C;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int col = 8 * j + 2 * t;
      const float b0 = p.projb[col], b1 = p.projb[col + 1];
      const float2 xa = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(xa_row + col));
      const float2 xb = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(xb_row + col));
      pacc[j][0] = round_to<bf16>(xa.x + round_to<bf16>(pacc[j][0] + b0));
      pacc[j][1] = round_to<bf16>(xa.y + round_to<bf16>(pacc[j][1] + b1));
      pacc[j][2] = round_to<bf16>(xb.x + round_to<bf16>(pacc[j][2] + b0));
      pacc[j][3] = round_to<bf16>(xb.y + round_to<bf16>(pacc[j][3] + b1));
    }
  }
  __syncwarp();  // this warp's ldmatrix reads of LN1 rows are done
  layernorm_frag<NC>(pacc, p.n2s, p.n2b, hbuf + ra * L::LDH,
                     hbuf + rb * L::LDH);
  W2X_CLOCK_PHASE(3);

  // MLP in 32-column hidden chunks: fc1 -> GELU -> bf16 -> into fc2.
  // After the first chunk's barrier no warp reads K or V: x1 goes there.
  const bf16* wt = ws.acquire(L::KV_TILES + L::NH);
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int col = 8 * j + 2 * t;
    *reinterpret_cast<uint32_t*>(kv + ra * L::LDKV + col) =
        tc::pack_bf16(pacc[j][0], pacc[j][1]);
    *reinterpret_cast<uint32_t*>(kv + rb * L::LDKV + col) =
        tc::pack_bf16(pacc[j][2], pacc[j][3]);
  }
  __syncwarp();
  float oacc[NC][4];
  zero(oacc);
  for (int c = 0; c < L::MLP_TILES; ++c) {
    if (c) wt = ws.acquire(L::KV_TILES + L::NH + c);
    float z[4][4];
    zero(z);
    mma_smem<4, C>(z, hrows, L::LDH, wt, L::LDH);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = HD * c + 8 * j + 2 * t;
      const float b0 = p.fc1b[col], b1 = p.fc1b[col + 1];
      z[j][0] = gelu_erf(z[j][0] + b0);
      z[j][1] = gelu_erf(z[j][1] + b1);
      z[j][2] = gelu_erf(z[j][2] + b0);
      z[j][3] = gelu_erf(z[j][3] + b1);
    }
    uint32_t ga[2][4];
    tc::to_a_frag(ga[0], z[0], z[1]);
    tc::to_a_frag(ga[1], z[2], z[3]);
    W2X_CLOCK_PHASE(12);
    mma_regs_k32<NC>(oacc, ga, wt + HD * L::LDH, L::LDS);
    W2X_CLOCK_PHASE(4);
  }

  // out = x1 + round(g Wfc2 + b)
  if (!live) return;
  const WindowRows rows(geo, win);
  bf16* oa_row = out + rows.token(ra) * C;
  bf16* ob_row = out + rows.token(rb) * C;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int col = 8 * j + 2 * t;
    const float b0 = p.fc2b[col], b1 = p.fc2b[col + 1];
    const float2 xa = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(kv + ra * L::LDKV + col));
    const float2 xb = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(kv + rb * L::LDKV + col));
    *reinterpret_cast<uint32_t*>(oa_row + col) =
        tc::pack_bf16(xa.x + round_to<bf16>(oacc[j][0] + b0),
                      xa.y + round_to<bf16>(oacc[j][1] + b1));
    *reinterpret_cast<uint32_t*>(ob_row + col) =
        tc::pack_bf16(xb.x + round_to<bf16>(oacc[j][2] + b0),
                      xb.y + round_to<bf16>(oacc[j][3] + b1));
  }
  W2X_CLOCK_PHASE(5);
}

template <int C>
int launch_swin_block_tc(const void* x, const BlockParams& p,
                         const void* bias, const void* flags, void* out,
                         int bw, int shift, Geometry geo,
                         cudaStream_t stream) {
  using L = TcLayout<C>;
  static_assert(is_width(C), "set_smem_limit's table counts kWidths only");
  const int err = set_smem_limit((const void*)swin_block_tc_kernel<C>,
                                 (int)L::SMEM);
  if (err) return err;
  const int grid = (bw + TC_WPC - 1) / TC_WPC;
  swin_block_tc_kernel<C><<<grid, TC_THREADS, L::SMEM, stream>>>(
      static_cast<const bf16*>(x), p, static_cast<const float*>(bias),
      static_cast<const int*>(flags), static_cast<bf16*>(out), bw, shift,
      geo);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: register-tiled FMA on the CUDA cores, weights staged in shared memory
// ---------------------------------------------------------------------------

// C <= F32_PAIR_C: two windows a CTA, else one; the MLP hidden chunk of
// each
constexpr int F32_PAIR_C = 96;
constexpr int F32_HC_PAIR = 32;
constexpr int F32_HC_SINGLE = 64;
constexpr int F32_TW = 128;        // threads a window: 4 warps
constexpr int F32_MIN_CTAS = 2;    // resident CTAs an SM the registers allow
constexpr int F32_CG = 8;          // column groups of a product tile
constexpr int F32_KP = 16;         // K rows of a proj or fc2 tile
constexpr int F32_STAGE_ROWS = 16; // a stage: 16 rows of max(C, 96) floats
// attention rows a lane a call (16 or 8 rows a warp), two windows a CTA
// and one
constexpr int F32_RR_PAIR = 4;
constexpr int F32_RR_SINGLE = 2;

// The largest multiple of 16 that divides k with k_tile x n <= stage: the K
// rows of one weight tile of a (k, n) product.
constexpr int ktile(int k, int n, int stage) {
  int best = 16;
  for (int kt = 16; kt <= k && kt * n <= stage; kt += 16)
    if (k % kt == 0) best = kt;
  return best;
}

template <int C>
struct F32Layout {
  static constexpr int NH = C / HD;
  static constexpr bool PAIR = C <= F32_PAIR_C;
  static constexpr int WPC = PAIR ? 2 : 1;  // windows per CTA
  static constexpr int TW = F32_TW;  // threads a window
  static constexpr int THREADS = WPC * TW;
  static constexpr int WARPS = TW / 32;         // warps per window
  static constexpr int ROWS_W = NTOK / WARPS;   // attention rows a warp
  // rows a lane in one attention call (4 RR rows a call), at most a
  // warp's rows
  static constexpr int RR_MOST = PAIR ? F32_RR_PAIR : F32_RR_SINGLE;
  static constexpr int RR = 4 * RR_MOST <= ROWS_W ? RR_MOST : ROWS_W / 4;
  static constexpr int CALLS = ROWS_W / (4 * RR);
  // A product's output tile (64 x N a window): thread t of the window owns
  // rows rg + RG * i (i < TM) and columns 4 cg + 32 s + e (e < 4), with
  // cg = t % CG, rg = t / CG.
  static constexpr int CG = F32_CG;
  static constexpr int RG = TW / CG;
  static constexpr int TM = NTOK / RG;
  static constexpr int NSC = C / 32;  // 32-column segments across C
  // q, k and v of a head in one product
  static constexpr int QN = 3 * HD;
  static constexpr int HC = PAIR ? F32_HC_PAIR : F32_HC_SINGLE;
  static constexpr int NCH = 2 * C / HC;
  static constexpr int STAGE = F32_STAGE_ROWS * (C > 3 * HD ? C : 3 * HD);
  static constexpr int KQ = ktile(C, QN, STAGE);  // K rows: a qkv tile
  static constexpr int KF = ktile(C, HC, STAGE);  // an fc1 tile
  static constexpr int KP = F32_KP;               // a proj or fc2 tile
  static constexpr int QKV_TILES = (3 * HD / QN) * (C / KQ);  // a head
  static constexpr int HEAD_TILES = QKV_TILES + HD / KP;
  static constexpr int CHUNK_TILES = C / KF + HC / KP;
  static constexpr int TILES = NH * HEAD_TILES + NCH * CHUNK_TILES;
  static constexpr int LDG = HC + 4;  // GELU rows, in the q | k | v space
  // a window's shared memory: h (64 x C, LN1 then LN2 output, 16-byte
  // chunks swizzled), then q, k and v of the current head
  static constexpr int QKV = NTOK * (2 * attn_f32::LDQK + attn_f32::LDV);
  static constexpr int WIN = NTOK * C + QKV;
  static constexpr size_t SMEM = (size_t)(2 * STAGE + WPC * WIN) * sizeof(float);
  static_assert(C % HD == 0 && C >= HD && C <= 192, "C = 32 * nh <= 192");
  // a 32-column segment is 8 lanes x 4 columns, and a row's 8 lanes
  // reduce by the shuffles of attn_f32::group_sum
  static_assert(CG * 4 == 32 && RG * TM == NTOK && CALLS * 4 * RR == ROWS_W,
                "tiling");
  static_assert(KQ * QN <= STAGE && KF * HC <= STAGE && KP * C <= STAGE &&
                    C % KQ == 0 && C % KF == 0,
                "weight tiles");
  static_assert(NTOK * LDG <= QKV, "the GELU rows fit the q | k | v space");
  static_assert(F32_MIN_CTAS * (SMEM + 1024) <= 228 * 1024,
                "F32_MIN_CTAS CTAs an SM");
  static_assert(QN % 32 == 0 && 3 * HD % QN == 0 && HC % 32 == 0,
                "product widths");
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// Rows rg + RG * i of a 64-row fp32 matrix in shared memory with row
// stride LD; with SWZ, 16-byte chunk c of row r lies at chunk c ^ (r & 7),
// so the 4 rows one warp reads at once fall in 4 different bank groups.
template <int RG, int LD, bool SWZ>
struct SmemRows {
  const float* p;
  int rg;
  __device__ __forceinline__ float4 load(int i, int k) const {
    const int r = rg + RG * i;
    const int c = SWZ ? ((k >> 2) ^ (r & 7)) : (k >> 2);
    return ld4(p + r * LD + 4 * c);
  }
};

__device__ __forceinline__ int swizzled(int r, int col, int ld) {
  return r * ld + 4 * ((col >> 2) ^ (r & 7)) + (col & 3);
}

// acc[i][4 s + e] += sum over k < KT of A[row i][k0 + k] * B[k][4 cg + 32 s
// + e]: B is a K-tile in shared memory (row stride ldb). k ascends, one
// FMA at a time, so each sum runs in K order across tiles. A float4 of A
// serves 4 NS FMAs a k, a float4 of B TM FMAs.
template <int TM, int NS, int KT, class A>
__device__ __forceinline__ void product(float (&acc)[TM][4 * NS], const A& a,
                                        int k0, const float* b, int ldb,
                                        int cg) {
#pragma unroll
  for (int k = 0; k < KT; k += 4) {
    float4 av[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) av[i] = a.load(i, k0 + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float bv[4 * NS];
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const float4 t = ld4(b + (k + kk) * ldb + 4 * cg + 32 * s);
        bv[4 * s] = t.x;
        bv[4 * s + 1] = t.y;
        bv[4 * s + 2] = t.z;
        bv[4 * s + 3] = t.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float ai = kk == 0 ? av[i].x
                         : kk == 1 ? av[i].y
                         : kk == 2 ? av[i].z
                                   : av[i].w;
#pragma unroll
        for (int n = 0; n < 4 * NS; ++n) acc[i][n] = fmaf(ai, bv[n], acc[i][n]);
      }
    }
  }
}

template <int TM, int N>
__device__ __forceinline__ void zero_tile(float (&acc)[TM][N]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int n = 0; n < N; ++n) acc[i][n] = 0.f;
}

// Two-pass fp32 LayerNorm (eps 1e-5) of this thread's rows, held in the
// product layout (a row's C values over its 8 lanes cg, reduced by
// shuffles); the result goes to h (swizzled).
template <int C>
__device__ __forceinline__ void layernorm_rows(
    const float (&v)[F32Layout<C>::TM][C / 8], const float* __restrict__ sc,
    const float* __restrict__ bi, float* h, int rg, int cg) {
  using L = F32Layout<C>;
#pragma unroll
  for (int i = 0; i < L::TM; ++i) {
    const int r = rg + L::RG * i;
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < C / 8; ++n) sum += v[i][n];
    const float mean = attn_f32::group_sum(sum) / (float)C;
    float sq = 0.f;
#pragma unroll
    for (int n = 0; n < C / 8; ++n) {
      const float d = v[i][n] - mean;
      sq = fmaf(d, d, sq);
    }
    const float inv = 1.f / sqrtf(attn_f32::group_sum(sq) / (float)C + 1e-5f);
#pragma unroll
    for (int s = 0; s < L::NSC; ++s) {
      const int col = 4 * cg + 32 * s;
      float y[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        y[e] = (v[i][4 * s + e] - mean) * inv * sc[col + e] + bi[col + e];
      st4(h + swizzled(r, col, C), y);
    }
  }
}

// The weight tiles in the order the block consumes them, double-buffered
// (see WeightStream): per head its q, k, v tiles (K-tiles of the head's
// 32-column slices of Wqkv), then its two proj tiles (its 32 rows of
// Wproj); per MLP chunk its fc1 tiles (K-tiles of HC columns of Wfc1) and
// its fc2 tiles (its HC rows of Wfc2). GEMM weights in (in, out).
template <int C>
struct WeightStreamF32 {
  using L = F32Layout<C>;
  float* stages;
  const float* wqkv;   // (C, 3C)
  const float* wproj;  // (C, C)
  const float* wfc1;   // (C, 2C)
  const float* wfc2;   // (2C, C)

  // ROWS x COLS floats of a row-major matrix (row stride lds) -> dst (row
  // stride ldd), 16 bytes a copy; every thread of the CTA takes part
  template <int ROWS, int COLS>
  __device__ static void copy(float* dst, int ldd, const float* src,
                              int lds) {
    constexpr int PER_ROW = COLS / 4;
    for (int i = threadIdx.x; i < ROWS * PER_ROW; i += L::THREADS) {
      const int r = i / PER_ROW, c = (i - r * PER_ROW) * 4;
      tc::cp_async16(dst + r * ldd + c, src + (size_t)r * lds + c);
    }
  }

  __device__ void load(int t) {
    float* st = stages + (t & 1) * L::STAGE;
    if (t < L::NH * L::HEAD_TILES) {
      const int h = t / L::HEAD_TILES, i = t - h * L::HEAD_TILES;
      if (i < L::QKV_TILES) {
        constexpr int PER_PART = C / L::KQ;
        const int k0 = (i % PER_PART) * L::KQ;
        const float* w = wqkv + (size_t)k0 * 3 * C + h * HD;
        if (L::QN == HD)  // part i / PER_PART alone: (KQ, 32)
          copy<L::KQ, HD>(st, HD, w + (i / PER_PART) * C, 3 * C);
        else  // q | k | v: (KQ, 96)
          for (int part = 0; part < 3; ++part)
            copy<L::KQ, HD>(st + part * HD, 3 * HD, w + part * C, 3 * C);
      } else {
        const int k0 = h * HD + (i - L::QKV_TILES) * L::KP;
        copy<L::KP, C>(st, C, wproj + (size_t)k0 * C, C);
      }
    } else {
      const int u = t - L::NH * L::HEAD_TILES;
      const int j = u / L::CHUNK_TILES, i = u - j * L::CHUNK_TILES;
      if (i < C / L::KF) {
        copy<L::KF, L::HC>(st, L::HC, wfc1 + (size_t)i * L::KF * 2 * C +
                                          j * L::HC, 2 * C);
      } else {
        const int k0 = j * L::HC + (i - C / L::KF) * L::KP;
        copy<L::KP, C>(st, C, wfc2 + (size_t)k0 * C, C);
      }
    }
    tc::cp_async_commit();
  }
  // wait for tile t and sync the CTA (after which every thread is done
  // with tile t - 1), start tile t + 1 into t - 1's stage
  __device__ const float* acquire(int t) {
    W2X_CLOCK_BEGIN_WAIT();
    tc::cp_async_wait<0>();
    __syncthreads();
    W2X_CLOCK_END_WAIT();
    if (t + 1 < L::TILES) load(t + 1);
    return stages + (t & 1) * L::STAGE;
  }
};

template <int C>
__global__ void __launch_bounds__(F32Layout<C>::THREADS, F32_MIN_CTAS)
swin_block_f32_kernel(const float* __restrict__ x, BlockParams p,
                      const float* __restrict__ bias,
                      const int* __restrict__ flags, float* __restrict__ out,
                      int bw, int shift, Geometry geo) {
  using L = F32Layout<C>;
  constexpr int TM = L::TM, NSC = L::NSC;
  constexpr int RR = L::RR, CALLS = L::CALLS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int slot = threadIdx.x / L::TW, t = threadIdx.x % L::TW;
  const int cg = t % L::CG, rg = t / L::CG;
  const int lane = t & 31, rw0 = (t >> 5) * L::ROWS_W;  // attention rows
  const int win_raw = blockIdx.x * L::WPC + slot;
  const bool live = win_raw < bw;  // the last CTA may hold one window
  const int win = live ? win_raw : bw - 1;
  float* hbuf = smem + 2 * L::STAGE + slot * L::WIN;
  float* qb = hbuf + NTOK * C;  // later the GELU rows of an MLP chunk
  float* kb = qb + NTOK * attn_f32::LDQK;
  float* vb = kb + NTOK * attn_f32::LDQK;
  WeightStreamF32<C> ws{smem, static_cast<const float*>(p.qkvk),
                        static_cast<const float*>(p.projk),
                        static_cast<const float*>(p.fc1k),
                        static_cast<const float*>(p.fc2k)};
  W2X_CLOCK_START();
  ws.load(0);

  float acc[TM][C / 8];  // x, then proj's sum over heads, x1, the MLP's
  {                      // sum over chunks
    const WindowRows rows(geo, win);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int s = 0; s < NSC; ++s) {
        const float4 v =
            ld4(x + rows.token(rg + L::RG * i) * C + 4 * cg + 32 * s);
        acc[i][4 * s] = v.x;
        acc[i][4 * s + 1] = v.y;
        acc[i][4 * s + 2] = v.z;
        acc[i][4 * s + 3] = v.w;
      }
    layernorm_rows<C>(acc, p.n1s, p.n1b, hbuf, rg, cg);
  }
  W2X_CLOCK_PHASE(0);
  const SmemRows<L::RG, C, true> a_h{hbuf, rg};
  uint32_t keep[CALLS];
  {
    const int fl = __ldg(flags + win);
#pragma unroll
    for (int c = 0; c < CALLS; ++c)
      keep[c] = attn_f32::keep_bits(
          attn_f32::crossings<RR>(rw0 + 4 * RR * c, shift), fl);
  }

  zero_tile(acc);
  int tile = 0;
  for (int h = 0; h < L::NH; ++h) {
    // q, k, v of head h = LN1(x) Wqkv[:, head h] + b -> qb, kb, vb
#pragma unroll
    for (int part0 = 0; part0 < 3; part0 += L::QN / HD) {
      float z[TM][L::QN / 8];
      zero_tile(z);
      for (int kt = 0; kt < C / L::KQ; ++kt)
        product<TM, L::QN / 32, L::KQ>(z, a_h, kt * L::KQ,
                                       ws.acquire(tile++), L::QN, cg);
#pragma unroll
      for (int s = 0; s < L::QN / 32; ++s) {
        const int part = part0 + s, d = 4 * cg;
        float* dst = part == 0 ? qb : part == 1 ? kb : vb;
        const int ld = part == 2 ? attn_f32::LDV : attn_f32::LDQK;
        const float* b = p.qkvb + part * C + h * HD + d;
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] = z[i][4 * s + e] + b[e];
          st4(dst + (rg + L::RG * i) * ld + d, v);
        }
      }
    }
    __syncthreads();  // the head's q, k and v rows are in place
    W2X_CLOCK_PHASE(8);
    // O_h for this warp's rows -> their q rows (dead once read)
#pragma unroll
    for (int c = 0; c < CALLS; ++c) {
      const int r0 = rw0 + 4 * RR * c;
      float b[RR][8], o[RR][4];
      attn_f32::load_bias<RR>(b, bias + (size_t)h * NTOK * NTOK, r0);
      attn_f32::head_attention<RR>(qb, kb, vb, r0, b, keep[c], o);
      __syncwarp();
#pragma unroll
      for (int i = 0; i < RR; ++i)
        st4(qb + (r0 + (lane >> 3) + 4 * i) * attn_f32::LDQK + 4 * (lane & 7),
            o[i]);
    }
    W2X_CLOCK_PHASE(9);
    // proj += O_h Wproj[h] (the first tile's barrier orders the O stores)
    const SmemRows<L::RG, attn_f32::LDQK, false> a_o{qb, rg};
    for (int kt = 0; kt < HD / L::KP; ++kt)
      product<TM, NSC, L::KP>(acc, a_o, kt * L::KP, ws.acquire(tile++), C,
                              cg);
    W2X_CLOCK_PHASE(2);
  }

  // x1 = x + (attn Wproj + b): to the output rows, which hold it until the
  // end (the same thread reads it back), and on to LN2 -> h
  {
    const WindowRows rows(geo, opaque(win));
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int s = 0; s < NSC; ++s) {
        const int off = rows.token(rg + L::RG * i) * C + 4 * cg + 32 * s;
        const float4 xv = ld4(x + off);
        const float* b = p.projb + 4 * cg + 32 * s;
        float* v = &acc[i][4 * s];
        v[0] = xv.x + (v[0] + b[0]);
        v[1] = xv.y + (v[1] + b[1]);
        v[2] = xv.z + (v[2] + b[2]);
        v[3] = xv.w + (v[3] + b[3]);
        if (live) *reinterpret_cast<float4*>(out + off) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
  }
  layernorm_rows<C>(acc, p.n2s, p.n2b, hbuf, rg, cg);
  W2X_CLOCK_PHASE(3);

  // MLP in hidden chunks: fc1 chunk -> GELU -> the GELU rows -> into fc2
  zero_tile(acc);
  const SmemRows<L::RG, L::LDG, false> a_g{qb, rg};
  for (int j = 0; j < L::NCH; ++j) {
    float z[TM][L::HC / 8];
    zero_tile(z);
    for (int kt = 0; kt < C / L::KF; ++kt)
      product<TM, L::HC / 32, L::KF>(z, a_h, kt * L::KF, ws.acquire(tile++),
                                     L::HC, cg);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int s = 0; s < L::HC / 32; ++s) {
        const int col = 4 * cg + 32 * s;
        float g[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          g[e] = gelu_erf(z[i][4 * s + e] + p.fc1b[j * L::HC + col + e]);
        st4(qb + (rg + L::RG * i) * L::LDG + col, g);
      }
    W2X_CLOCK_PHASE(12);
    for (int kt = 0; kt < L::HC / L::KP; ++kt)
      product<TM, NSC, L::KP>(acc, a_g, kt * L::KP, ws.acquire(tile++), C,
                              cg);
    W2X_CLOCK_PHASE(4);
  }

  // out = x1 + (g Wfc2 + b)
  if (!live) return;
  const WindowRows rows(geo, opaque(win));
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int s = 0; s < NSC; ++s) {
      const int off = rows.token(rg + L::RG * i) * C + 4 * cg + 32 * s;
      const float4 x1 = ld4(out + off);
      const float* b = p.fc2b + 4 * cg + 32 * s;
      const float* v = &acc[i][4 * s];
      *reinterpret_cast<float4*>(out + off) =
          make_float4(x1.x + (v[0] + b[0]), x1.y + (v[1] + b[1]),
                      x1.z + (v[2] + b[2]), x1.w + (v[3] + b[3]));
    }
  W2X_CLOCK_PHASE(5);
}

template <int C>
int launch_swin_block_f32(const void* x, const BlockParams& p,
                          const void* bias, const void* flags, void* out,
                          int bw, int shift, Geometry geo,
                          cudaStream_t stream) {
  using L = F32Layout<C>;
  static_assert(is_width(C), "set_smem_limit's table counts kWidths only");
  const int err = set_smem_limit((const void*)swin_block_f32_kernel<C>,
                                 (int)L::SMEM);
  if (err) return err;
  const int grid = (bw + L::WPC - 1) / L::WPC;
  swin_block_f32_kernel<C><<<grid, L::THREADS, L::SMEM, stream>>>(
      static_cast<const float*>(x), p, static_cast<const float*>(bias),
      static_cast<const int*>(flags), static_cast<float*>(out), bw, shift,
      geo);
  return (int)cudaGetLastError();
}

}  // namespace w2x

// GEMM weights: (in, out) for fp32 (is_bf16 = 0), (out, in) for bf16;
// C = 32 * nh, one of kWidths. x and out: (B, h, w, C) rolled by roll
// (Geometry), bw = B (h / 8) (w / 8) windows; the windowed (BW, 64, C)
// layout is h = w = 8, roll 0.
extern "C" int w2x_swin_block(const void* x, const void* n1s, const void* n1b,
                              const void* qkvk, const void* qkvb,
                              const void* projk, const void* projb,
                              const void* n2s, const void* n2b,
                              const void* fc1k, const void* fc1b,
                              const void* fc2k, const void* fc2b,
                              const void* bias, const void* flags, void* out,
                              int bw, int C, int nh, int shift, int h, int w,
                              int roll, int is_bf16, void* stream) {
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
  if (nh * w2x::HD != C) return (int)cudaErrorInvalidValue;
  if (h < w2x::WS || w < w2x::WS || h % w2x::WS || w % w2x::WS || roll < 0 ||
      roll >= w2x::WS || bw % ((h / w2x::WS) * (w / w2x::WS)))
    return (int)cudaErrorInvalidValue;
  const w2x::Geometry geo{h, w, roll};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return w2x::with_width(C, [&](auto width) {
    constexpr int kC = decltype(width)::value;
    return is_bf16 ? w2x::launch_swin_block_tc<kC>(x, p, bias, flags, out, bw,
                                                   shift, geo, s)
                   : w2x::launch_swin_block_f32<kC>(x, p, bias, flags, out,
                                                    bw, shift, geo, s);
  });
}

// Registers and local (spill) bytes per thread and resident CTAs per SM
// of the fp32 kernel for C (with its dynamic shared memory).
extern "C" int w2x_swin_block_f32_info(int C, int* regs, int* local_bytes,
                                       int* ctas_per_sm) {
  return w2x::with_width(C, [&](auto width) {
    constexpr int kC = decltype(width)::value;
    const void* kernel = (const void*)w2x::swin_block_f32_kernel<kC>;
    cudaFuncAttributes a;
    cudaError_t err = cudaFuncGetAttributes(&a, kernel);
    if (err != cudaSuccess) return (int)err;
    *regs = a.numRegs;
    *local_bytes = (int)a.localSizeBytes;
    const int code = w2x::set_smem_limit(kernel, (int)w2x::F32Layout<kC>::SMEM);
    if (code) return code;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas_per_sm, kernel, w2x::F32Layout<kC>::THREADS,
        w2x::F32Layout<kC>::SMEM);
  });
}

#ifdef W2X_PHASE_CLOCK
// Copy the phase clocks out (16 counters) and clear them.
extern "C" int w2x_read_phase_cycles(unsigned long long* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, w2x::w2x_phase_cycles,
                                         sizeof(w2x::w2x_phase_cycles));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[16] = {};
  return (int)cudaMemcpyToSymbol(w2x::w2x_phase_cycles, zero, sizeof(zero));
}

// Registers per thread, static shared memory, and resident CTAs per SM of
// the bf16 kernel for C (with its dynamic shared memory).
template <int C>
static int tc_info(int* regs, int* ctas_per_sm) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, w2x::swin_block_tc_kernel<C>);
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  err = cudaFuncSetAttribute(w2x::swin_block_tc_kernel<C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)w2x::TcLayout<C>::SMEM);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, w2x::swin_block_tc_kernel<C>, w2x::TC_THREADS,
      w2x::TcLayout<C>::SMEM);
}

extern "C" int w2x_swin_block_tc_info(int C, int* regs, int* ctas_per_sm) {
  switch (C) {
    case 96:
      return tc_info<96>(regs, ctas_per_sm);
    case 192:
      return tc_info<192>(regs, ctas_per_sm);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
#endif
