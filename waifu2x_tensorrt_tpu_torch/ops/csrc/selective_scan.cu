// Kernel K: MambaIR's 2D selective scan (the core of its SS2D) in two
// kernels, a scan and a combine.
//
// Replaces no TPU kernel: the JAX package has no MambaIR. No other kernel
// of the port carries state along a sequence. Its plain twin is
// ops/selective_scan.py selective_scan_plain.
//
// For an (H, W) map of L = H W tokens, D channels and N = 16 states, each
// direction k = 0..3 reads the tokens in its own order (0 row-major, 1
// column-major, 2 and 3 those reversed) and runs, per channel d and state
// n, with h = 0 before the first token:
//   delta_l = softplus(dt_w[k, d, :] . dt_l + dt_b[k, d])   (R = 12 wide)
//   h_l     = exp(delta_l A[k, d, n]) h_{l-1} + delta_l u_l B_l[n]
//   y_l     = sum_n h_l[n] C_l[n] + Ds[k, d] u_l
// where [dt_l | B_l | C_l] are direction k's 44 values of the x_proj GEMM
// at the token (x_dbl, (B, H, W, 4 x 44) bf16, direction-major) and u_l
// the token's (B, H, W, D) bf16 input. Each direction's y is mapped back
// to its token's (h, w); the four are summed in fp32, in the published
// order ((y_0 + y_2) + y_1) + y_3, and SS2D's gate (z, the out_norm
// weight and bias) is applied to the sum: g = LN_D(y) SiLU(z), the
// LayerNorm over the D channels in fp32, written once in bf16, which is
// what the block's out_proj reads.
//
// What bounds it on the H100: the transcendental unit. A state update is
// one exp (ex2 on the SFU, 16 a clock an SM) and three fp32 operations;
// the scan is serial along each of the B x 4 x D sequences. A chunk of
// the cell (16 tiles of 256 x 256, D = 360) is 2.4 x 10^10 updates a
// call: 5.8 ms at the SFU's 4.18 x 10^12 a second, while its bytes (u
// and x_dbl read, y written) take 0.56 ms at 3.35 TB/s.
// What the design does about it:
// - the scan kernel: a CTA of 4 warps takes 32 channels of one direction
//   of one tile (B x 4 x ceil(D / 32) CTAs, 768 at the cell's chunk, 5.8
//   an SM); in the recurrence lane l takes channel l and warp w the
//   states [4 w, 4 w + 4), their A log2(e) in registers, so an SM holds
//   23 warps to hide each step's latencies, and a step's B and C are two
//   broadcast loads a warp (a first version, a lane a channel with all 16
//   states, held 5.8 warps an SM and waited on them: 26.4 ms a call; a
//   second spread a channel over 4 lanes, summed y by shuffles and stored
//   it every step: 27.4 ms, 10 of them in the stores; PERF.md);
// - the CTA stages 32 tokens at a time with cp.async: the tile's token of
//   each step by index arithmetic in its direction's order (no flipped or
//   transposed copy), its 44 x_dbl values and the 32 channels of u; the
//   next 32 tokens' copies are in flight while the current ones are
//   scanned;
// - each stage in two passes: first every token's delta (the dt dot and
//   softplus by ex2 and lg2: x itself above 20, exp(x) below -15, as
//   torch's softplus; a thread a channel, its 12 dt weights and bias in
//   registers, the 4 warps on every 4th token), u and the B and C values
//   in fp32 in shared memory, the tokens independent of each other; then
//   the recurrence, per state one ex2.approx of delta A log2(e), h =
//   fma(dA, h, delta u B), each warp's part of y (its 4 states' h C) into
//   shared memory: only h carries from token to token;
// - at the end of a stage each direction's y_l + D u_l (the 4 parts summed
//   in a fixed order) is written in fp32 to its own plane of a (4, B, H,
//   W, D) scratch at the token's place, a token's 32 channels one 128-byte
//   row, no atomics: the combine kernel then sums the four
//   planes in the published order, a warp a token (float4 loads), with the
//   gate's LayerNorm by warp shuffles, so the result is the same on every
//   run.
// 32-bit token and channel counts, 64-bit offsets (the wrapper refuses a
// map of 2^31 values or more).
#include "common.cuh"

namespace w2x {
namespace scan {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kRank = 12;                     // dt_rank R
constexpr int kState = 16;                    // d_state N
constexpr int kE = kRank + 2 * kState;        // x_dbl values a direction
constexpr int kTile = 32;                     // tokens staged at a time
constexpr int kWarps = 4;                     // a CTA: 32 channels
constexpr int kThreads = 32 * kWarps;
constexpr int kXVecs = kE / 4;                // 8-byte x_dbl pieces a token
constexpr int kMaxGroups = 4;                 // float4s a lane of a row:
                                              // D up to 512 in the combine
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
static_assert(kE % 4 == 0, "x_dbl staging in 8-byte pieces");

struct ScanArgs {
  const bf16* u;        // (B, H, W, D)
  const bf16* xdbl;     // (B, H, W, 4 kE)
  const float* dt_w;    // (4, D, R)
  const float* dt_b;    // (4, D)
  const float* a;       // (4, D, N): A = -exp(A_logs)
  const float* ds;      // (4, D)
  float* part;          // (4, B, H, W, D)
  int batch, h, w, d, groups;  // groups: CTAs a direction (ceil(D / 32))
};

struct CombineArgs {
  const float* part;    // (4, rows, D)
  const bf16* z;        // (rows, D)
  const float* gamma;   // (D,) out_norm
  const float* beta;
  bf16* out;            // (rows, D)
  int rows, d;
  float eps;
};

// One CTA's staging: raw bf16 as cp.async lands it, then fp32.
struct Stage {
  __align__(16) bf16 xraw[kTile * kE];
  __align__(16) bf16 uraw[kTile * 32];
  __align__(16) float bc[kTile * 2 * kState];
  __align__(16) float delta[kTile * 32];
  __align__(16) float u[kTile * 32];
  __align__(16) float ys[kTile * kWarps * 32];  // each warp's part of y
  int rows[2][kTile];
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lo(unsigned v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float hi(unsigned v) {
  return __uint_as_float(v & 0xffff0000u);
}
__device__ __forceinline__ float bf(const bf16* p) {
  return __uint_as_float(
      (unsigned)*reinterpret_cast<const unsigned short*>(p) << 16);
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
               :: "r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The token (row-major index h W + w) that direction k reads at step l.
__device__ __forceinline__ int token(int k, int l, int h, int w) {
  const int m = k >= 2 ? h * w - 1 - l : l;
  if (k & 1) {  // column-major: m = w' H + h'
    const int col = m / h;
    return (m - col * h) * w + col;
  }
  return m;
}

// The rows of the steps [base, base + kTile) into ``rows``.
__device__ __forceinline__ void tile_rows(int* rows, int k, int base,
                                          int len, int h, int w) {
  for (int t = threadIdx.x; t < kTile; t += kThreads)
    rows[t] = base + t < len ? token(k, base + t, h, w) : 0;
}

// cp.async of ``steps`` tokens' x_dbl slice and u into the raw buffers.
__device__ __forceinline__ void issue_tile(const ScanArgs& a, Stage& st,
                                           const int* rows, long long image,
                                           int k, int d0, int steps) {
  for (int q = threadIdx.x; q < steps * kXVecs; q += kThreads) {
    const int t = q / kXVecs, j = q - t * kXVecs;
    cp_async8(st.xraw + t * kE + 4 * j,
              a.xdbl + (image + rows[t]) * (4 * kE) + k * kE + 4 * j);
  }
  for (int q = threadIdx.x; q < steps * 4; q += kThreads) {
    const int t = q / 4, j = q - t * 4;
    const int ch = d0 + 8 * j;
    if (ch < a.d)
      cp_async16(st.uraw + t * 32 + 8 * j,
                 a.u + (image + rows[t]) * a.d + ch);
  }
}

// One CTA: 32 channels [d0, d0 + 32) of direction k of tile b; in the
// recurrence lane l takes channel d0 + l and warp w the states [4 w,
// 4 w + 4).
__global__ void __launch_bounds__(kThreads)
    selective_scan_kernel(const ScanArgs a) {
  __shared__ Stage st;
  const int tid = threadIdx.x, lane = tid & 31, wv = tid >> 5;
  const int g = blockIdx.x % a.groups;
  const int k = (blockIdx.x / a.groups) % 4;
  const int b = blockIdx.x / (4 * a.groups);
  const int d0 = 32 * g;
  const int len = a.h * a.w;
  const long long image = (long long)b * len;
  const int dc = min(d0 + lane, a.d - 1);  // a dead lane reads a live one
  float w[kRank], a2[4], hs[4];
#pragma unroll
  for (int r = 0; r < kRank; ++r)
    w[r] = a.dt_w[((long long)k * a.d + dc) * kRank + r];
  const float bias = a.dt_b[k * a.d + dc];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a2[i] = a.a[((long long)k * a.d + dc) * kState + 4 * wv + i] * kLog2e;
    hs[i] = 0.f;
  }
  // the epilogue: channels [d0 + 4 c4, d0 + 4 c4 + 4) of every 16th token
  const int c4 = tid & 7;
  const bool live4 = d0 + 4 * c4 < a.d;
  float4 ds4 = make_float4(0.f, 0.f, 0.f, 0.f);
  if (live4)
    ds4 = *reinterpret_cast<const float4*>(a.ds + k * a.d + d0 + 4 * c4);
  float* out = a.part + ((long long)k * a.batch + b) * len * a.d + d0
               + 4 * c4;

  const int tiles = (len + kTile - 1) / kTile;
  tile_rows(st.rows[0], k, 0, len, a.h, a.w);
  __syncthreads();
  issue_tile(a, st, st.rows[0], image, k, d0, min(kTile, len));
  cp_async_wait_all();
  __syncthreads();
  for (int i = 0; i < tiles; ++i) {
    const int* cur = st.rows[i & 1];
    const int base = i * kTile, steps = min(kTile, len - base);
    // pass 1: every token's delta, u, B and C in fp32
#pragma unroll 4
    for (int t = wv; t < steps; t += kWarps) {
      const uint2* x = reinterpret_cast<const uint2*>(st.xraw + t * kE);
      float p0 = bias, p1 = 0.f, p2 = 0.f;
#pragma unroll
      for (int v = 0; v < kRank / 4; ++v) {
        const uint2 xv = x[v];
        p0 = fmaf(w[4 * v], lo(xv.x), p0);
        p1 = fmaf(w[4 * v + 1], hi(xv.x), p1);
        p2 = fmaf(w[4 * v + 2], lo(xv.y), p2);
        p0 = fmaf(w[4 * v + 3], hi(xv.y), p0);
      }
      const float dt = (p0 + p1) + p2;
      const float e = ex2(dt * kLog2e);
      st.delta[t * 32 + lane] = dt > 20.f ? dt
                                : dt < -15.f ? e : lg2(1.f + e) * kLn2;
      st.u[t * 32 + lane] = bf(st.uraw + t * 32 + lane);
      st.bc[t * 2 * kState + lane] = bf(st.xraw + t * kE + kRank + lane);
    }
    __syncthreads();
    const bool more = i + 1 < tiles;
    if (more) {
      tile_rows(st.rows[(i + 1) & 1], k, base + kTile, len, a.h, a.w);
      __syncthreads();
      issue_tile(a, st, st.rows[(i + 1) & 1], image, k, d0,
                 min(kTile, len - base - kTile));
    }
    // pass 2: the recurrence; only h carries from token to token. B and
    // C of the warp's 4 states are one broadcast load each
#pragma unroll 4
    for (int t = 0; t < steps; ++t) {
      const float dl = st.delta[t * 32 + lane], uv = st.u[t * 32 + lane];
      const float4 bq = *reinterpret_cast<const float4*>(
          st.bc + t * 2 * kState + 4 * wv);
      const float4 cq = *reinterpret_cast<const float4*>(
          st.bc + t * 2 * kState + kState + 4 * wv);
      const float du = dl * uv;
      hs[0] = fmaf(ex2(dl * a2[0]), hs[0], du * bq.x);
      hs[1] = fmaf(ex2(dl * a2[1]), hs[1], du * bq.y);
      hs[2] = fmaf(ex2(dl * a2[2]), hs[2], du * bq.z);
      hs[3] = fmaf(ex2(dl * a2[3]), hs[3], du * bq.w);
      st.ys[(t * kWarps + wv) * 32 + lane] =
          fmaf(hs[0], cq.x, hs[1] * cq.y) + fmaf(hs[2], cq.z, hs[3] * cq.w);
    }
    __syncthreads();
    // the tile's y = sum of the 4 warps' parts + D u, 4 channels a
    // thread, whole 128-byte rows a token
    for (int t = tid >> 3; t < steps; t += kThreads / 8) {
      const float4* ys = reinterpret_cast<const float4*>(
          st.ys + t * kWarps * 32) + c4;
      const float4 y0 = ys[0], y1 = ys[8], y2 = ys[16], y3 = ys[24];
      const float4 uv = reinterpret_cast<const float4*>(st.u + t * 32)[c4];
      if (live4)
        *reinterpret_cast<float4*>(out + (long long)cur[t] * a.d) =
            make_float4(fmaf(ds4.x, uv.x, (y0.x + y1.x) + (y2.x + y3.x)),
                        fmaf(ds4.y, uv.y, (y0.y + y1.y) + (y2.y + y3.y)),
                        fmaf(ds4.z, uv.z, (y0.z + y1.z) + (y2.z + y3.z)),
                        fmaf(ds4.w, uv.w, (y0.w + y1.w) + (y2.w + y3.w)));
    }
    cp_async_wait_all();
    __syncthreads();
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// A warp a token row: y = ((P0 + P2) + P1) + P3 over its D channels (lane
// l on float4 groups l, l + 32, ...), then LN(y) SiLU(z) in bf16.
__global__ void __launch_bounds__(256)
    selective_scan_combine(const CombineArgs a) {
  const int lane = threadIdx.x & 31;
  const int groups = a.d / 4;
  const long long plane = (long long)a.rows * a.d;
  const int warps = gridDim.x * (blockDim.x / 32);
  for (int row = blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5);
       row < a.rows; row += warps) {
    const long long at = (long long)row * a.d;
    float v[kMaxGroups][4];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxGroups; ++i) {
      const int gi = lane + 32 * i;
      if (gi < groups) {
        const float4 p0 = __ldg(
            reinterpret_cast<const float4*>(a.part + at) + gi);
        const float4 p1 = __ldg(
            reinterpret_cast<const float4*>(a.part + plane + at) + gi);
        const float4 p2 = __ldg(
            reinterpret_cast<const float4*>(a.part + 2 * plane + at) + gi);
        const float4 p3 = __ldg(
            reinterpret_cast<const float4*>(a.part + 3 * plane + at) + gi);
        v[i][0] = ((p0.x + p2.x) + p1.x) + p3.x;
        v[i][1] = ((p0.y + p2.y) + p1.y) + p3.y;
        v[i][2] = ((p0.z + p2.z) + p1.z) + p3.z;
        v[i][3] = ((p0.w + p2.w) + p1.w) + p3.w;
        sum += (v[i][0] + v[i][1]) + (v[i][2] + v[i][3]);
      }
    }
    const float mean = warp_sum(sum) / (float)a.d;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxGroups; ++i)
      if (lane + 32 * i < groups)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float c = v[i][j] - mean;
          sq += c * c;
        }
    const float rstd = rsqrtf(warp_sum(sq) / (float)a.d + a.eps);
#pragma unroll
    for (int i = 0; i < kMaxGroups; ++i) {
      const int gi = lane + 32 * i;
      if (gi < groups) {
        const uint2 zq = __ldg(reinterpret_cast<const uint2*>(a.z + at)
                               + gi);
        const float4 gm = __ldg(reinterpret_cast<const float4*>(a.gamma)
                                + gi);
        const float4 bt = __ldg(reinterpret_cast<const float4*>(a.beta)
                                + gi);
        const float zs[4] = {lo(zq.x), hi(zq.x), lo(zq.y), hi(zq.y)};
        const float gs[4] = {gm.x, gm.y, gm.z, gm.w};
        const float bs[4] = {bt.x, bt.y, bt.z, bt.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[i][j] = fmaf(gs[j], (v[i][j] - mean) * rstd, bs[j])
                    * (zs[j] / (1.f + __expf(-zs[j])));
      }
    }
#pragma unroll
    for (int i = 0; i < kMaxGroups; ++i) {
      const int gi = lane + 32 * i;
      if (gi < groups) {
        __nv_bfloat162 lo2 = __floats2bfloat162_rn(v[i][0], v[i][1]);
        __nv_bfloat162 hi2 = __floats2bfloat162_rn(v[i][2], v[i][3]);
        uint2 o;
        o.x = *reinterpret_cast<unsigned*>(&lo2);
        o.y = *reinterpret_cast<unsigned*>(&hi2);
        reinterpret_cast<uint2*>(a.out + at)[gi] = o;
      }
    }
  }
}

}  // namespace
}  // namespace scan
}  // namespace w2x

// u, z and y (B, H, W, D) bf16; x_dbl (B, H, W, 4 x 44) bf16; dt_w (4, D,
// 12), dt_b (4, D), a (4, D, 16), ds (4, D), gamma and beta (D,) fp32;
// part (4, B, H, W, D) fp32 scratch; u, x_dbl and z 16-byte aligned, D a
// multiple of 8 up to 512. y = LN(sum) SiLU(z) with gamma, beta, eps.
extern "C" int w2x_selective_scan(const void* u, const void* xdbl,
                                  const void* dt_w, const void* dt_b,
                                  const void* a, const void* ds,
                                  const void* z, const void* gamma,
                                  const void* beta, void* part, void* y,
                                  int batch, int h, int w, int d, float eps,
                                  void* stream) {
  using namespace w2x::scan;
  if (batch <= 0 || h <= 0 || w <= 0 || d <= 0 || d % 8 ||
      d > 4 * 32 * kMaxGroups || z == nullptr || gamma == nullptr ||
      beta == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const int groups = (d + 31) / 32;
  const long long blocks = (long long)batch * 4 * groups;
  const long long rows = (long long)batch * h * w;
  if (blocks > 2147483647LL || rows > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const ScanArgs args{static_cast<const __nv_bfloat16*>(u),
                      static_cast<const __nv_bfloat16*>(xdbl),
                      static_cast<const float*>(dt_w),
                      static_cast<const float*>(dt_b),
                      static_cast<const float*>(a),
                      static_cast<const float*>(ds),
                      static_cast<float*>(part),
                      batch, h, w, d, groups};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  selective_scan_kernel<<<(int)blocks, kThreads, 0, st>>>(args);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const CombineArgs c{static_cast<const float*>(part),
                      static_cast<const __nv_bfloat16*>(z),
                      static_cast<const float*>(gamma),
                      static_cast<const float*>(beta),
                      static_cast<__nv_bfloat16*>(y), (int)rows, d, eps};
  const long long want = (rows + 7) / 8;  // 8 warps a CTA, a row a warp
  const int grid = (int)(want < 16LL * sms ? want : 16LL * sms);
  selective_scan_combine<<<grid, 256, 0, st>>>(c);
  return (int)cudaGetLastError();
}
