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
// (tools/attention_phase_clock.py).
//
// fp32 (attention_f32_kernel, the CLI's tf32 precision and the ops API):
// the same stream of units on the CUDA cores, bound by bytes as well (402
// MB at (BW 4096, C 96): 0.120 ms; 0.060 ms at (1024, 192)). The grid,
// the two cp.async unit buffers (26 KB each: q and k rows at an odd
// 16-byte stride) and the one barrier a unit are bf16's; each warp runs
// attn_f32::head_attention (attention_f32.cuh, the core kernel B's fp32
// heads loop runs too) on its 16 rows, with scores and its rows of the
// head's bias in registers and fp32 FMA (no TF32: the fp32 checks hold
// it to 1e-4), and stores its output from registers. Measured on an
// H100 (tools/kernel_times.py, PERF.md section 6): A 0.31-0.32 ms at
// (BW 4096, C 96), 38-39% of the bound, 0.163 ms at (1024, 192), 37%; E
// 0.30-0.31 ms, 39-40%; 0.57-0.62x fp32 SDPA with a float mask. What
// holds it: shared memory delivers 128 bytes a clock, and q k^T reads k
// (and p v reads v and the shuffled probabilities) at 2-3 FMAs a value.
#include "attention_f32.cuh"
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
// r * out_row. Every pointer and stride is 16-byte aligned. T is the
// element type of q, k, v and out (bf16 or float).
template <typename T>
struct UnitsOf {
  const T* q;
  const T* k;
  const T* v;
  T* out;
  const float* bias;  // (nh, 64, 64)
  const int* flags;   // (BW,)
  int bw, nh;
  int in_win, in_head, in_row;
  int out_win, out_head, out_row;
};
using Units = UnitsOf<bf16>;

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

// ---------------------------------------------------------------------------
// fp32: the same persistent grid on the CUDA cores (attention_f32.cuh)
// ---------------------------------------------------------------------------

// A unit's q and k rows at stride LDQK, its v rows at LDV (26 KB); two
// unit buffers, 4 CTAs = 16 warps an SM.
constexpr int UNIT_F32 = NTOK * (2 * attn_f32::LDQK + attn_f32::LDV);
constexpr size_t UNIT_F32_SMEM = 2 * UNIT_F32 * sizeof(float);

// unit (w, h)'s rows -> st: 1536 copies of 16 bytes
__device__ __forceinline__ void load_unit(const UnitsOf<float>& u, int w,
                                          int h, float* st) {
  const size_t off = (size_t)w * u.in_win + (size_t)h * u.in_head;
#pragma unroll
  for (int k = 0; k < 3 * NTOK * 8 / UNIT_THREADS; ++k) {
    const int i = threadIdx.x + k * UNIT_THREADS;
    const int part = i / (NTOK * 8), r = (i >> 3) % NTOK, c = (i & 7) * 4;
    const float* src = part == 0 ? u.q : part == 1 ? u.k : u.v;
    tc::cp_async16(st + part * NTOK * attn_f32::LDQK +
                       r * (part == 2 ? attn_f32::LDV : attn_f32::LDQK) + c,
                   src + off + (size_t)r * u.in_row + c);
  }
}

// As attention_tc_kernel, in fp32: each warp keeps its rows of the head's
// bias in registers, computes its 16 rows in one call of
// attn_f32::head_attention (scores in registers) and stores them from
// registers, 16 bytes a lane.
constexpr int F32_RR = 4;  // rows a lane: 16 rows a warp

__global__ void __launch_bounds__(UNIT_THREADS, MIN_CTAS)
attention_f32_kernel(const __grid_constant__ UnitsOf<float> u, int shift) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* buf = reinterpret_cast<float*>(smem_raw);
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * 16;
  const int rg = lane >> 3, cg = lane & 7;
  const int h = blockIdx.x % u.nh, dw = gridDim.x / u.nh;
  constexpr int RR = F32_RR, CALLS = 4 / RR;
  attn_f32::Crossings cross[CALLS];
#pragma unroll
  for (int c = 0; c < CALLS; ++c)
    cross[c] = attn_f32::crossings<RR>(r0 + 4 * RR * c, shift);
  float bias[CALLS][RR][8];  // the head's, for the CTA's life
#pragma unroll
  for (int c = 0; c < CALLS; ++c)
    attn_f32::load_bias<RR>(bias[c], u.bias + h * NTOK * NTOK,
                            r0 + 4 * RR * c);
  const int w0 = blockIdx.x / u.nh;  // < bw: the grid is at most bw * nh
  load_unit(u, w0, h, buf);
  tc::cp_async_commit();
  int slot = 0;
  for (int w = w0; w < u.bw; w += dw) {
    tc::cp_async_wait<0>();
    __syncthreads();
    if (w + dw < u.bw) load_unit(u, w + dw, h, buf + (slot ^ 1) * UNIT_F32);
    tc::cp_async_commit();
    const float* q = buf + slot * UNIT_F32;
    const float* k = q + NTOK * attn_f32::LDQK;
    const float* v = k + NTOK * attn_f32::LDQK;
    const int fl = __ldg(u.flags + w);
    float* dst = u.out + (size_t)w * u.out_win + (size_t)h * u.out_head;
#pragma unroll
    for (int c = 0; c < CALLS; ++c) {
      const int rc = r0 + 4 * RR * c;
      float o[RR][4];
      attn_f32::head_attention<RR>(q, k, v, rc, bias[c],
                                   attn_f32::keep_bits(cross[c], fl), o);
#pragma unroll
      for (int i = 0; i < RR; ++i)
        *reinterpret_cast<float4*>(dst + (size_t)(rc + rg + 4 * i) *
                                             u.out_row + 4 * cg) =
            make_float4(o[i][0], o[i][1], o[i][2], o[i][3]);
    }
    slot ^= 1;
  }
}

// Resident CTAs of a persistent attention kernel on the current device
// (CTAs per SM x SMs): the shared-memory attribute is set and the
// occupancy found once per kernel and device, outside any later launch
// (and any capture that contains one).
struct Residency {
  const void* kernel;
  size_t smem;
  int cached[kMaxDevices];
};

// internal linkage: every copy of this library in a process keeps its own
namespace {
Residency tc_residency{(const void*)attention_tc_kernel, UNIT_SMEM, {}};
Residency f32_residency{(const void*)attention_f32_kernel, UNIT_F32_SMEM, {}};
}  // namespace

// Resident CTAs per SM of the kernel, after opting into its dynamic
// shared memory.
int ctas_per_sm(const Residency& r, int* per_sm) {
  const cudaError_t err = cudaFuncSetAttribute(
      r.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)r.smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, r.kernel, UNIT_THREADS, r.smem);
}

int resident_ctas(Residency& r, int* ctas) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < kMaxDevices && r.cached[dev]) {
    *ctas = r.cached[dev];
    return 0;
  }
  int per_sm = 0, sms = 0;
  const int code = ctas_per_sm(r, &per_sm);
  if (code) return code;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *ctas = per_sm * sms;
  if (dev < kMaxDevices) r.cached[dev] = *ctas;
  return 0;
}

// The grid: the units (bw * nh), at most the resident CTAs rounded down
// to a multiple of nh, so that each CTA keeps one head.
int grid_for(Residency& r, int bw, int nh, int* grid) {
  int ctas = 0;
  const int err = resident_ctas(r, &ctas);
  if (err) return err;
  const int units = bw * nh, most = ctas - ctas % nh;
  *grid = units < most ? units : most;
  return 0;
}

int launch_attention(const Units& u, int shift, cudaStream_t stream) {
  int grid = 0;
  const int err = grid_for(tc_residency, u.bw, u.nh, &grid);
  if (err) return err;
  attention_tc_kernel<<<grid, UNIT_THREADS, UNIT_SMEM, stream>>>(u, shift);
  return (int)cudaGetLastError();
}

int launch_attention(const UnitsOf<float>& u, int shift,
                     cudaStream_t stream) {
  int grid = 0;
  const int err = grid_for(f32_residency, u.bw, u.nh, &grid);
  if (err) return err;
  attention_f32_kernel<<<grid, UNIT_THREADS, UNIT_F32_SMEM, stream>>>(u,
                                                                     shift);
  return (int)cudaGetLastError();
}

// Units of kernel E (q, k, v (BW, nh, 64, 32): one head's rows contiguous)
// and of kernel A (qkv (BW, 64, 3C) -> out (BW, 64, C)), for T.
template <typename T>
UnitsOf<T> heads_units(const void* q, const void* k, const void* v,
                       const void* bias, const void* flags, void* out, int bw,
                       int nh) {
  constexpr int blk = NTOK * HD;
  return {static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(out),
          static_cast<const float*>(bias), static_cast<const int*>(flags),
          bw, nh, nh * blk, blk, HD, nh * blk, blk, HD};
}

template <typename T>
UnitsOf<T> qkv_units(const void* qkv, const void* bias, const void* flags,
                     void* out, int bw, int C, int nh) {
  const T* x = static_cast<const T*>(qkv);
  return {x, x + C, x + 2 * C, static_cast<T*>(out),
          static_cast<const float*>(bias), static_cast<const int*>(flags),
          bw, nh, NTOK * 3 * C, HD, 3 * C, NTOK * C, HD, C};
}

}  // namespace w2x

// Kernel E. Every pointer 16-byte aligned (the wrapper checks).
extern "C" int w2x_window_attention_heads(const void* q, const void* k,
                                          const void* v, const void* bias,
                                          const void* flags, void* out,
                                          int bw, int nh, int shift,
                                          int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return w2x::launch_attention(w2x::heads_units<w2x::bf16>(
        q, k, v, bias, flags, out, bw, nh), shift, s);
  return w2x::launch_attention(
      w2x::heads_units<float>(q, k, v, bias, flags, out, bw, nh), shift, s);
}

// Kernel A. Every pointer 16-byte aligned (the wrapper checks).
extern "C" int w2x_window_attention_qkv(const void* qkv, const void* bias,
                                        const void* flags, void* out, int bw,
                                        int C, int nh, int shift, int is_bf16,
                                        void* stream) {
  if (nh * w2x::HD != C) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return w2x::launch_attention(w2x::qkv_units<w2x::bf16>(
        qkv, bias, flags, out, bw, C, nh), shift, s);
  return w2x::launch_attention(
      w2x::qkv_units<float>(qkv, bias, flags, out, bw, C, nh), shift, s);
}

// Registers per thread and resident CTAs per SM of the bf16 kernel.
extern "C" int w2x_attention_tc_info(int* regs, int* ctas_per_sm) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, w2x::attention_tc_kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  return w2x::ctas_per_sm(w2x::tc_residency, ctas_per_sm);
}

// Registers and local (spill) bytes per thread and resident CTAs per SM
// of the fp32 kernel.
extern "C" int w2x_attention_f32_info(int* regs, int* local_bytes,
                                      int* ctas_per_sm) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, w2x::attention_f32_kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return w2x::ctas_per_sm(w2x::f32_residency, ctas_per_sm);
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
