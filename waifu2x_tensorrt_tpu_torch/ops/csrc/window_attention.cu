// Kernels A and E: shifted-window attention on the packed qkv layout (A)
// and on unpacked heads (E).
//
// Kernel A replaces the TPU kernel waifu2x_tensorrt_tpu/ops/window_attention.py
// fused_window_attention_qkv (pallas_call at :212, body _kernel_qkv :122):
// qkv (BW, 64, 3C) -> out (BW, 64, C), heads as C-slices of 32, relative
// bias (nh, 64, 64) fp32, the shift mask built from per-window flag bits.
// Kernel E replaces fused_window_attention (pallas_call at :267, body
// _kernel :77): q, k, v (BW, nh, 64, 32) -> out (BW, nh, 64, 32).
//
// What bounds them on the H100: bytes. Per window A reads 64 * 3C values
// and writes 64 * C (bf16 at C 96: 49 KB) and does 2 * 64 * 64 * 32 MACs
// per head, about 130 FLOP per byte, well under the ~295 at which the
// tensor cores would be the limit: 201 MB in 0.0601 ms at (BW 4096, C 96)
// at 3.35 TB/s. E moves the same bytes in another layout.
//
// What the bf16 design does about it (attention_tc_kernel below): the work
// is a stream of (window, head) units, each 64 rows of q, k and v of 32
// values (12 KB; the same unit in both layouts, only the strides differ,
// so A and E are one kernel). A persistent grid of 4-warp CTAs, as many as
// are resident, walks the units through two unit buffers in shared
// memory: the next unit's rows arrive by 16-byte cp.async while this one
// computes, so HBM stays busy. Each warp computes the head for 16
// rows with the tensor-core core of attention_tc.cuh (scores in
// registers, never in shared memory), leaves its output in the dead q
// rows and stores them in 16-byte stores itself: one CTA barrier per unit.
// A unit per head rather than a window per CTA: a window's rows are up to
// 74.8 KB (C 192), which would leave one or two CTAs of an SM to cover
// HBM latency; a unit is 15 KB staged at every C. The grid is a multiple
// of nh, so a CTA always takes the same head and its warps keep their rows
// of the head's bias in registers (128 a thread, 4 CTAs = 16 warps an SM).
// Measured on an H100 (chip_smoke.py phases 3 and 8, PERF.md section 6):
// A 0.087 ms at (BW 4096, C 96), 69% of the bound, and 0.048 ms at (1024,
// 192), 63%; E 0.087 ms, 69%. The rest goes to the exact softmax's
// instructions and the CTA barrier of each unit
// (tools/attention_phase_clock.py). The fp32 instantiations keep
// attention_core on the CUDA cores (TF32 would break the 1e-4 checks),
// one CTA per window or (window, head).
#include "attention_tc.cuh"

namespace w2x {

constexpr int kMaxDevices = 64;
using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// bf16: tensor cores, a persistent grid over two cp.async unit buffers
// ---------------------------------------------------------------------------

constexpr int UNIT_THREADS = 128;  // 4 warps, 16 rows each
constexpr int MIN_CTAS = 4;  // registers sized for 4 CTAs = 16 warps an SM
constexpr int LDU = HD + 8;  // 80-byte rows: an odd multiple of 16 bytes,
                             // so one ldmatrix hits 8 bank groups
constexpr int UNIT = 3 * NTOK * LDU;  // a unit's q, k and v rows
constexpr size_t UNIT_SMEM = 2 * UNIT * sizeof(bf16);  // two unit buffers

// Where the units lie: unit w * nh + h is head h of window w; its row r
// of q starts at q + w * in_win + h * in_head + r * in_row (k and v
// likewise), its output row r at out + w * out_win + h * out_head +
// r * out_row. Every pointer and stride is 16-byte aligned.
struct Units {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* out;
  const float* bias;  // (nh, 64, 64)
  const int* flags;   // (BW,)
  int bw, nh;
  int in_win, in_head, in_row;
  int out_win, out_head, out_row;
};

// unit (w, h)'s rows -> st (q, k, v blocks of 64 rows at stride LDU): 768
// copies of 16 bytes, neighbouring threads on neighbouring addresses
__device__ __forceinline__ void load_unit(const Units& u, int w, int h,
                                          bf16* st) {
  const size_t off = (size_t)w * u.in_win + (size_t)h * u.in_head;
#pragma unroll
  for (int k = 0; k < 3 * NTOK * 4 / UNIT_THREADS; ++k) {
    const int i = threadIdx.x + k * UNIT_THREADS;
    const int part = i / (NTOK * 4), r = (i >> 2) % NTOK, c = (i & 3) * 8;
    const bf16* src = part == 0 ? u.q : part == 1 ? u.k : u.v;
    tc::cp_async16(st + (part * NTOK + r) * LDU + c,
                   src + off + (size_t)r * u.in_row + c);
  }
}

// Phase clocks, in a measurement build only (nvcc -DW2X_PHASE_CLOCK; see
// tools/attention_phase_clock.py): thread 0 of every CTA adds the clock64()
// cycles since its previous clock point into w2x_attn_cycles[i] at point
// i: 0 copy-in wait (cp.async completion, the CTA barrier, the next copy
// issued), 1 masked bias + q + q k^T, 2 softmax, 3 p v, 4 output store;
// [5] counts the units. The main build compiles none of it.
#ifdef W2X_PHASE_CLOCK
__device__ unsigned long long w2x_attn_cycles[8];
struct PhaseClock {
  long long t;
  __device__ PhaseClock() { t = clock64(); }
  __device__ __forceinline__ void operator()(int i) {
    const long long now = clock64();
    if (threadIdx.x == 0)
      atomicAdd(&w2x_attn_cycles[i], (unsigned long long)(now - t));
    t = now;
  }
};
#else
using PhaseClock = attn::NoClock;
#endif

// CTA b takes units b, b + gridDim.x, ...: the grid is a multiple of nh,
// so that is head h = b % nh of windows b / nh, b / nh + dw, ... (dw =
// gridDim.x / nh), and each warp loads its rows of the head's bias once.
// Each step waits for its unit's rows, syncs the CTA (after which every
// warp is done with the other buffer), starts the copy of the next unit
// into the other buffer, and computes: warp i takes rows 16i..16i+15.
__global__ void __launch_bounds__(UNIT_THREADS, MIN_CTAS)
attention_tc_kernel(const __grid_constant__ Units u, int shift) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* buf = reinterpret_cast<bf16*>(smem_raw);
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * 16;
  const int h = blockIdx.x % u.nh, dw = gridDim.x / u.nh;
  const attn::Crossings cross = attn::crossings(r0, shift);
  float bias[8][4];
  attn::bias_frag(bias, u.bias + h * NTOK * NTOK, r0);
  PhaseClock clock;
  const int w0 = blockIdx.x / u.nh;  // < bw: the grid is at most bw * nh
  load_unit(u, w0, h, buf);
  tc::cp_async_commit();
  int slot = 0;  // the buffer of this step's unit
  for (int w = w0; w < u.bw; w += dw) {
    tc::cp_async_wait<0>();
    __syncthreads();
    if (w + dw < u.bw) load_unit(u, w + dw, h, buf + (slot ^ 1) * UNIT);
    tc::cp_async_commit();
    clock(0);
    bf16* st = buf + slot * UNIT;
    bf16* q = st + r0 * LDU;
    attn::head_attention(q, LDU, st + NTOK * LDU, st + 2 * NTOK * LDU, LDU,
                         bias, attn::keep_bits(cross, __ldg(u.flags + w)), q,
                         LDU, clock);
    __syncwarp();
    // this warp's 16 output rows: 64 stores of 16 bytes
    bf16* dst = u.out + (size_t)w * u.out_win + (size_t)h * u.out_head;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int r = r0 + 8 * k + (lane >> 2), c = (lane & 3) * 8;
      *reinterpret_cast<uint4*>(dst + (size_t)r * u.out_row + c) =
          *reinterpret_cast<const uint4*>(st + r * LDU + c);
    }
    clock(4);
#ifdef W2X_PHASE_CLOCK
    if (threadIdx.x == 0) atomicAdd(&w2x_attn_cycles[5], 1ull);
#endif
    slot ^= 1;
  }
}

// Resident CTAs per SM of the kernel on the current device, after opting
// into its dynamic shared memory.
int ctas_per_sm(int* per_sm) {
  const cudaError_t err = cudaFuncSetAttribute(
      attention_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)UNIT_SMEM);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, attention_tc_kernel, UNIT_THREADS, UNIT_SMEM);
}

// Resident CTAs of the kernel on the current device (CTAs per SM x SMs),
// found once per device.
int resident_ctas(int* ctas) {
  static int cached[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < kMaxDevices && cached[dev]) {
    *ctas = cached[dev];
    return 0;
  }
  int per_sm = 0, sms = 0;
  const int code = ctas_per_sm(&per_sm);
  if (code) return code;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *ctas = per_sm * sms;
  if (dev < kMaxDevices) cached[dev] = *ctas;
  return 0;
}

// The grid: the units (bw * nh), at most the resident CTAs rounded down
// to a multiple of nh, so that each CTA keeps one head.
int launch_attention_tc(const Units& u, int shift, cudaStream_t stream) {
  int ctas = 0;
  const int err = resident_ctas(&ctas);
  if (err) return err;
  const int units = u.bw * u.nh, most = ctas - ctas % u.nh;
  const int grid = units < most ? units : most;
  attention_tc_kernel<<<grid, UNIT_THREADS, UNIT_SMEM, stream>>>(u, shift);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: attention_core on the CUDA cores
// ---------------------------------------------------------------------------

// Kernel A, fp32: one CTA per window, the packed rows in shared memory.
__global__ void __launch_bounds__(NTHREADS)
window_attention_f32_kernel(const float* __restrict__ qkv,
                            const float* __restrict__ bias,
                            const int* __restrict__ flags,
                            float* __restrict__ out, int C, int nh,
                            int shift) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* scores = reinterpret_cast<float*>(smem);
  float* buf = scores + NTOK * SLD;
  const int C3 = 3 * C;
  const int ld = padded_ld<float>(C3);
  const size_t w = blockIdx.x;
  const float* src = qkv + w * NTOK * C3;
  for (int idx = threadIdx.x; idx < NTOK * C3; idx += NTHREADS)
    buf[(idx / C3) * ld + idx % C3] = src[idx];
  __syncthreads();
  attention_core<float>(buf, ld, scores, bias, flags[w], C, nh, shift);
  float* dst = out + w * NTOK * C;
  for (int idx = threadIdx.x; idx < NTOK * C; idx += NTHREADS)
    dst[idx] = buf[(idx / C) * ld + idx % C];
}

int launch_window_attention_f32(const void* qkv, const void* bias,
                                const void* flags, void* out, int bw, int C,
                                int nh, int shift, cudaStream_t stream) {
  const size_t smem = NTOK * SLD * sizeof(float) +
                      (size_t)NTOK * padded_ld<float>(3 * C) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      window_attention_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  window_attention_f32_kernel<<<bw, NTHREADS, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(bias),
      static_cast<const int*>(flags), static_cast<float*>(out), C, nh, shift);
  return (int)cudaGetLastError();
}

// Kernel E, fp32: one CTA per (window, head) copies that head's (64, 32)
// q, k and v blocks into the packed [q | k | v] rows attention_core reads
// (C = 32, one head, the bias of head h).
__global__ void __launch_bounds__(NTHREADS)
window_attention_heads_f32_kernel(const float* __restrict__ q,
                                  const float* __restrict__ k,
                                  const float* __restrict__ v,
                                  const float* __restrict__ bias,
                                  const int* __restrict__ flags,
                                  float* __restrict__ out, int nh, int shift) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* scores = reinterpret_cast<float*>(smem);
  float* buf = scores + NTOK * SLD;
  constexpr int ld = padded_ld<float>(3 * HD);
  const size_t blk = blockIdx.x;  // window * nh + head
  const size_t off = blk * NTOK * HD;
  for (int idx = threadIdx.x; idx < NTOK * HD; idx += NTHREADS) {
    const int t = idx / HD, d = idx % HD;
    buf[t * ld + d] = q[off + idx];
    buf[t * ld + HD + d] = k[off + idx];
    buf[t * ld + 2 * HD + d] = v[off + idx];
  }
  __syncthreads();
  const int w = (int)(blk / nh), h = (int)(blk % nh);
  attention_core<float>(buf, ld, scores, bias + (size_t)h * NTOK * NTOK,
                        flags[w], HD, 1, shift);
  for (int idx = threadIdx.x; idx < NTOK * HD; idx += NTHREADS)
    out[off + idx] = buf[(idx / HD) * ld + idx % HD];
}

int launch_window_attention_heads_f32(const void* q, const void* k,
                                      const void* v, const void* bias,
                                      const void* flags, void* out, int bw,
                                      int nh, int shift, cudaStream_t stream) {
  // 41.5 KB: under the 48 KB a launch may take without opting in
  const size_t smem = NTOK * SLD * sizeof(float) +
                      (size_t)NTOK * padded_ld<float>(3 * HD) * sizeof(float);
  window_attention_heads_f32_kernel<<<(unsigned)((size_t)bw * nh), NTHREADS,
                                      smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(bias),
      static_cast<const int*>(flags), static_cast<float*>(out), nh, shift);
  return (int)cudaGetLastError();
}

}  // namespace w2x

// Kernel E. Every pointer 16-byte aligned (the wrapper checks).
extern "C" int w2x_window_attention_heads(const void* q, const void* k,
                                          const void* v, const void* bias,
                                          const void* flags, void* out,
                                          int bw, int nh, int shift,
                                          int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16)
    return w2x::launch_window_attention_heads_f32(q, k, v, bias, flags, out,
                                                  bw, nh, shift, s);
  using w2x::bf16;
  constexpr int blk = w2x::NTOK * w2x::HD;  // one head's rows, contiguous
  const w2x::Units u{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                     static_cast<const bf16*>(v), static_cast<bf16*>(out),
                     static_cast<const float*>(bias),
                     static_cast<const int*>(flags), bw, nh,
                     nh * blk, blk, w2x::HD, nh * blk, blk, w2x::HD};
  return w2x::launch_attention_tc(u, shift, s);
}

// Kernel A. Every pointer 16-byte aligned (the wrapper checks).
extern "C" int w2x_window_attention_qkv(const void* qkv, const void* bias,
                                        const void* flags, void* out, int bw,
                                        int C, int nh, int shift, int is_bf16,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16)
    return w2x::launch_window_attention_f32(qkv, bias, flags, out, bw, C, nh,
                                            shift, s);
  if (nh * w2x::HD != C) return (int)cudaErrorInvalidValue;
  using w2x::bf16;
  const bf16* x = static_cast<const bf16*>(qkv);
  const w2x::Units u{x, x + C, x + 2 * C, static_cast<bf16*>(out),
                     static_cast<const float*>(bias),
                     static_cast<const int*>(flags), bw, nh,
                     w2x::NTOK * 3 * C, w2x::HD, 3 * C,
                     w2x::NTOK * C, w2x::HD, C};
  return w2x::launch_attention_tc(u, shift, s);
}

// Registers per thread and resident CTAs per SM of the bf16 kernel.
extern "C" int w2x_attention_tc_info(int* regs, int* ctas_per_sm) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, w2x::attention_tc_kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  return w2x::ctas_per_sm(ctas_per_sm);
}

#ifdef W2X_PHASE_CLOCK
// Copy the phase clocks out (8 counters) and clear them.
extern "C" int w2x_read_attn_cycles(unsigned long long* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, w2x::w2x_attn_cycles,
                                         sizeof(w2x::w2x_attn_cycles));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[8] = {};
  return (int)cudaMemcpyToSymbol(w2x::w2x_attn_cycles, zero, sizeof(zero));
}
#endif
