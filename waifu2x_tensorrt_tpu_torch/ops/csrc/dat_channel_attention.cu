// Kernel J: DAT's channel attention on the (B, H, W, 3C) qkv activation.
//
// Replaces no TPU kernel: the JAX package has no DAT. Added because no
// kernel of the port computes this attention, and torch's chain for it
// (F.normalize of q and k, transposes, a bmm over all tokens, the
// softmax, a second bmm and the permute back) makes about six passes
// over the maps where the work needs four. Its plain twin is
// ops/channel_attention.py channel_attention_plain.
//
// Per tile b and head h (d = C / nh channels, N = H W tokens), with q, k
// and v read by address from qkv (token n, part p, channel c of head h:
// qkv[(b N + n) 3C + p C + h d + c]):
//   G = q^T k (d x d), |q_i|^2 and |k_j|^2 over the N tokens, in fp32;
//   A = softmax_j(tau_h G_ij / (max(|q_i|, 1e-12) max(|k_j|, 1e-12)));
//   a[n, h d + i] = sum_j A_ij v[n, h d + j].
// Three launches a call, each deterministic (no float atomics; every sum
// in a fixed order):
//   channel_attention_stats_kernel: a CTA per (tile, SLICE tokens), a
//     warp per head; q and k of STAGE tokens staged in shared memory
//     (4-byte cp.async: a head's 60 bytes of a token are 4-byte but not
//     16-byte aligned; rows padded to 32 channels with zeros, 16-byte
//     chunks XOR-swizzled as kernel G's), G by mma.sync m16n8k16 (bf16
//     in, fp32 accumulators) fed by transposing ldmatrix, the sums of
//     squares from the same fragments; the CTA's partials (G, |q|^2,
//     |k|^2) go to a scratch row of its own;
//   channel_attention_softmax_kernel: a CTA per (tile, head) sums the
//     partials in slice order, normalises, scales by tau and takes the
//     exact max-subtracted softmax of each row (a warp a row), writing A
//     rounded to bf16;
//   channel_attention_apply_kernel: a CTA per (tile, APPLY tokens) stages
//     v and the tile's A and forms a = v A^T by mma.sync, one rounding.
// Rounding points (the twin's): fp32 G and sums of squares of the bf16 q
// and k, sqrt, the clamp, tau (G / (|q| |k|)) and the softmax in fp32
// (p = e / sum correctly rounded), p rounded to bf16 before the
// fp32-accumulated p v, one final rounding. Only the order of the fp32
// sums differs from the twin.
//
// What bounds it on the H100: per call over a chunk of 16 256 x 256 tiles
// (6 heads of 30, C 180), q, k and v read once and a written once are
// 4 x 377.5 MB = 1.51 GB, 0.45 ms at 3.35 TB/s; the products (G and a v,
// 2 x 2 N d^2 a head) are 22.6 GFLOP, 0.023 ms at 989 TFLOP/s. Bytes
// bound it. The scratch (64 partials a tile and head, 4.4 KB each) adds
// 27 MB of writes and reads, mostly from L2. It runs at about 31% of
// the bound (PERF.md), the stats and apply kernels each about a third of
// their bytes' rate; two or three stages in flight in the stats kernel,
// and apply CTAs of 64 or 256 tokens, moved it by 3% or less.
#include <math.h>

#include "tensor_core.cuh"

namespace w2x {
namespace dat {

using bf16 = __nv_bfloat16;

constexpr int HD = 32;              // head dim as padded in shared memory
constexpr int ROW_WORDS = HD / 2;   // 32-bit words a shared-memory row
constexpr int GRAM = HD * HD;       // entries of a padded Gram matrix
constexpr int PART = GRAM + 2 * HD; // a partial: G, |q_i|^2, |k_j|^2
constexpr int MAX_HEADS = 8;
constexpr int SLICE = 1024;         // tokens a stats CTA
constexpr int STAGE = 64;           // tokens staged at once
constexpr int APPLY = 128;          // tokens an apply CTA
constexpr int APPLY_THREADS = APPLY * 2;  // a warp a 16-token block

// Element offset of 16-byte chunk ch (0..3) of shared-memory row r, the
// chunks XOR-swizzled by (r / 2) % 4 (kernel G's layout: the 8 rows of an
// ldmatrix matrix lie in 8 distinct 4-bank groups).
__device__ __forceinline__ int swz(int r, int ch) {
  return r * HD + ((ch ^ ((r >> 1) & 3)) << 3);
}

// 4-byte asynchronous copy; valid false fills the destination with zeros
// (source size 0) and reads nothing.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   tc::smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// x^2 + y^2 of a packed bf16 pair.
__device__ __forceinline__ float sumsq(uint32_t r) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r));
  return fmaf(f.x, f.x, f.y * f.y);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Partials of one SLICE of tokens of one tile: part[(b, slice, head)] =
// (G, |q_i|^2, |k_j|^2) over the slice, row-major, padded to HD.
__global__ void __launch_bounds__(32 * MAX_HEADS)
    channel_attention_stats_kernel(const bf16* __restrict__ qkv,
                                   float* __restrict__ part, int n, int C,
                                   int nh) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* rows = reinterpret_cast<bf16*>(smem);  // [q|k][head][token] rows
  const int d = C / nh, words = d / 2;
  const int slice = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, head = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, mi = lane >> 3, r8 = lane & 7;
  const bf16* tile = qkv + (size_t)b * n * 3 * C;
  const int per_tok = 2 * nh;  // rows a token: q and k of every head
  float acc[2][4][4] = {};
  float sq[2][2] = {}, sk[4] = {};
  const int end = min((slice + 1) * SLICE, n);
  for (int s0 = slice * SLICE; s0 < end; s0 += STAGE) {
    // token-major, so that consecutive threads read consecutive words
    for (int it = threadIdx.x; it < STAGE * per_tok * ROW_WORDS;
         it += blockDim.x) {
      const int word = it % ROW_WORDS, r = it / ROW_WORDS;
      const int ph = r % per_tok, tok = r / per_tok;  // ph = part nh + head
      const bool valid = s0 + tok < end && word < words;
      const bf16* src =
          valid ? tile + (size_t)(s0 + tok) * 3 * C + ph * d + 2 * word : qkv;
      cp_async4(rows + swz(ph * STAGE + tok, word >> 2) + 2 * (word & 3), src,
                valid);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    __syncthreads();
    const bf16* qs = rows + head * STAGE * HD;
    const bf16* ks = rows + (nh + head) * STAGE * HD;
#pragma unroll
    for (int kb = 0; kb < STAGE / 16; ++kb) {
      // A = q^T (channels x tokens) and B = k (tokens x channels), both
      // from token rows through transposing loads
      uint32_t a[2][4], bk[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        tc::ldsm_x4_trans(
            a[mt], qs + swz(kb * 16 + r8 + 8 * (mi >> 1), 2 * mt + (mi & 1)));
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t r4[4];
        tc::ldsm_x4_trans(
            r4, ks + swz(kb * 16 + r8 + 8 * (mi & 1), 2 * p + (mi >> 1)));
        bk[2 * p][0] = r4[0];
        bk[2 * p][1] = r4[1];
        bk[2 * p + 1][0] = r4[2];
        bk[2 * p + 1][1] = r4[3];
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          tc::mma_bf16(acc[mt][nt], a[mt], bk[nt][0], bk[nt][1]);
      // this lane's q of channels 16 mt + g (+8), k of channel 8 nt + g
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        sq[mt][0] += sumsq(a[mt][0]) + sumsq(a[mt][2]);
        sq[mt][1] += sumsq(a[mt][1]) + sumsq(a[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) sk[nt] += sumsq(bk[nt][0]) + sumsq(bk[nt][1]);
    }
    __syncthreads();
  }
  float* out = part + ((size_t)(b * gridDim.x + slice) * nh + head) * PART;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int i = 16 * mt + g, j = 8 * nt + 2 * t;
      out[i * HD + j] = acc[mt][nt][0];
      out[i * HD + j + 1] = acc[mt][nt][1];
      out[(i + 8) * HD + j] = acc[mt][nt][2];
      out[(i + 8) * HD + j + 1] = acc[mt][nt][3];
    }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const float lo = quad_sum(sq[mt][0]), hi = quad_sum(sq[mt][1]);
    if (t == 0) {
      out[GRAM + 16 * mt + g] = lo;
      out[GRAM + 16 * mt + 8 + g] = hi;
    }
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const float v = quad_sum(sk[nt]);
    if (t == 0) out[GRAM + HD + 8 * nt + g] = v;
  }
}

// A of one (tile, head): the slices' partials summed in slice order, the
// normalised and scaled Gram matrix and its row softmax, rounded to bf16
// (rows and columns past d zero). A warp a row, a lane a column.
__global__ void __launch_bounds__(GRAM)
    channel_attention_softmax_kernel(const float* __restrict__ part,
                                     const float* __restrict__ tau,
                                     bf16* __restrict__ attn, int slices,
                                     int nh, int d) {
  __shared__ float norm[2 * HD];
  const int head = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const float* p = part + ((size_t)b * slices * nh + head) * PART;
  const size_t step = (size_t)nh * PART;  // the next slice, same head
  float gram = 0.f;
  for (int s = 0; s < slices; ++s) gram += p[s * step + tid];
  if (tid < 2 * HD) {
    float v = 0.f;
    for (int s = 0; s < slices; ++s) v += p[s * step + GRAM + tid];
    norm[tid] = fmaxf(sqrtf(v), 1e-12f);
  }
  __syncthreads();
  const int i = tid / HD, j = tid % HD;
  const float x = j < d ? tau[head] * (gram / (norm[i] * norm[HD + j]))
                        : -INFINITY;
  float m = x;
#pragma unroll
  for (int o = 16; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  const float e = j < d ? expf(x - m) : 0.f;
  float l = e;
#pragma unroll
  for (int o = 16; o; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
  const float pr = (i < d && j < d) ? __fdiv_rn(e, l) : 0.f;
  attn[((size_t)(b * nh + head) * HD + i) * HD + j] = __float2bfloat16_rn(pr);
}

// a = v A^T for APPLY tokens of one tile, every head: v rows and the
// tile's A staged in shared memory, a warp a 16-token block.
__global__ void __launch_bounds__(APPLY_THREADS)
    channel_attention_apply_kernel(const bf16* __restrict__ qkv,
                                   const bf16* __restrict__ attn,
                                   bf16* __restrict__ out, int n, int C,
                                   int nh) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* vs = reinterpret_cast<bf16*>(smem);  // [head][token] rows
  bf16* as = vs + nh * APPLY * HD;           // [head][i] rows of A
  const int d = C / nh, words = d / 2;
  const int b = blockIdx.y, t0 = blockIdx.x * APPLY;
  const int tid = threadIdx.x, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* tile = qkv + (size_t)b * n * 3 * C;
  for (int it = tid; it < APPLY * nh * ROW_WORDS; it += APPLY_THREADS) {
    const int word = it % ROW_WORDS, r = it / ROW_WORDS;
    const int head = r % nh, tok = r / nh;
    const bool valid = t0 + tok < n && word < words;
    const bf16* src = valid ? tile + (size_t)(t0 + tok) * 3 * C + 2 * C +
                                  head * d + 2 * word
                            : qkv;
    cp_async4(vs + swz(head * APPLY + tok, word >> 2) + 2 * (word & 3), src,
              valid);
  }
  const bf16* ab = attn + (size_t)b * nh * GRAM;
  for (int it = tid; it < nh * HD * 4; it += APPLY_THREADS)
    tc::cp_async16(as + swz(it >> 2, it & 3), ab + (it >> 2) * HD + (it & 3) * 8);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();
  const int r0 = (tid >> 5) * 16;  // this warp's tokens
  const int krow = (lane & 7) + ((lane >> 4) << 3);
  bf16* ta = out + ((size_t)b * n + t0 + r0 + g) * C;
  bf16* tb = ta + (size_t)8 * C;
  const bool ra = t0 + r0 + g < n, rb = t0 + r0 + g + 8 < n;
  for (int head = 0; head < nh; ++head) {
    const bf16* ah = as + head * GRAM;
    const bf16* vh = vs + head * APPLY * HD;
    uint32_t bf[2][4][2], va[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
      for (int jn = 0; jn < 4; jn += 2) {
        uint32_t r4[4];
        tc::ldsm_x4(r4, ah + swz(krow + jn * 8, 2 * kk + ((lane >> 3) & 1)));
        bf[kk][jn][0] = r4[0];
        bf[kk][jn][1] = r4[1];
        bf[kk][jn + 1][0] = r4[2];
        bf[kk][jn + 1][1] = r4[3];
      }
      tc::ldsm_x4(va[kk], vh + swz(r0 + (lane & 15), 2 * kk + (lane >> 4)));
    }
    float acc[4][4] = {};
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        tc::mma_bf16(acc[nt], va[kk], bf[kk][nt][0], bf[kk][nt][1]);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = 8 * nt + 2 * t;
      if (col < d) {
        if (ra)
          *reinterpret_cast<uint32_t*>(ta + head * d + col) =
              tc::pack_bf16(acc[nt][0], acc[nt][1]);
        if (rb)
          *reinterpret_cast<uint32_t*>(tb + head * d + col) =
              tc::pack_bf16(acc[nt][2], acc[nt][3]);
      }
    }
  }
}

namespace {

constexpr int kMaxDevices = 64;

// Raise a kernel's dynamic shared-memory limit, once per kernel and
// device (as set_smem_limit in hat_attention.cu).
int set_smem_limit(const void* kernel, int bytes) {
  static const void* done[kMaxDevices][2] = {};
  static int sizes[kMaxDevices][2] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const void** mine = dev < kMaxDevices ? done[dev] : nullptr;
  for (int i = 0; mine && i < 2; ++i)
    if (mine[i] == kernel && sizes[dev][i] >= bytes) return 0;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return (int)err;
  for (int i = 0; mine && i < 2; ++i)
    if (!mine[i] || mine[i] == kernel) {
      mine[i] = kernel;
      sizes[dev][i] = bytes;
      break;
    }
  return 0;
}

int stats_smem(int nh) { return 2 * nh * STAGE * HD * 2; }
int apply_smem(int nh) { return nh * (APPLY + HD) * HD * 2; }

}  // namespace

int slices(int n) { return (n + SLICE - 1) / SLICE; }

}  // namespace dat
}  // namespace w2x

// Scratch floats a call needs for its partials (the attention matrices
// need b nh 32 x 32 bf16 more): b * slices * nh * PART.
extern "C" long long w2x_channel_attention_scratch(int b, int n, int nh) {
  using namespace w2x::dat;
  return (long long)b * slices(n) * nh * PART;
}

// qkv (b, n, 3C) bf16 (n = H W tokens a tile), tau (nh) fp32, part: the
// scratch floats above, attn (b, nh, 32, 32) bf16 scratch, out (b, n, C)
// bf16; nh at most 8, head dim C / nh even and at most 32.
extern "C" int w2x_channel_attention(const void* qkv, const void* tau,
                                     void* part, void* attn, void* out,
                                     int b, int n, int C, int nh,
                                     void* stream) {
  using namespace w2x::dat;
  if (nh <= 0 || nh > MAX_HEADS || C % nh || (C / nh) % 2 || C / nh > HD ||
      n <= 0 || b < 0 || b > 65535)
    return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = set_smem_limit((const void*)channel_attention_stats_kernel,
                           stats_smem(nh));
  if (!err)
    err = set_smem_limit((const void*)channel_attention_apply_kernel,
                         apply_smem(nh));
  if (err) return err;
  const int sl = slices(n);
  channel_attention_stats_kernel<<<dim3(sl, b), 32 * nh, stats_smem(nh), s>>>(
      static_cast<const bf16*>(qkv), static_cast<float*>(part), n, C, nh);
  channel_attention_softmax_kernel<<<dim3(nh, b), GRAM, 0, s>>>(
      static_cast<const float*>(part), static_cast<const float*>(tau),
      static_cast<bf16*>(attn), sl, nh, C / nh);
  channel_attention_apply_kernel<<<dim3((n + APPLY - 1) / APPLY, b),
                                   APPLY_THREADS, apply_smem(nh), s>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(attn),
      static_cast<bf16*>(out), n, C, nh);
  return (int)cudaGetLastError();
}
