// Kernel C: the gather finalize — blend, overlap-add and u8 cast in one
// pass over the output frame.
//
// Replaces the TPU kernel waifu2x_tensorrt_tpu/ops/finalize_epilogue.py
// make_finalize_epilogue (pallas_call at :201 in _cells_call, body
// _kernel :118). Each output element (y, x, ch) sums the blended values of
// the <= 4 tiles covering it — (float(v) * row_w) * col_w per tile — in
// fp32 in ASCENDING tile index (the tile grid is column-major,
// t = col * R + row), then clip(rint(acc * 255), 0, 255) -> u8. That is
// element-wise the addition sequence of the renderer's scan finalize
// (waifu2x_tensorrt_tpu/engine/renderer.py:413-483), so the bytes are
// identical. Every operation is rounded on its own (__fmul_rn /
// __fadd_rn): a contracted FMA would break byte identity.
//
// What bounds it on the H100: bytes. At 720p->4x it reads the values of
// the 18 bf16 tiles that cover the frame (3008 x 5440 x 3, 98 MB) and
// writes the 44 MB u8 frame: 0.0425 ms at 3.35 TB/s.
// What the design does about it: the arithmetic per byte is a few flops,
// so the index work must not outweigh it.
// - One thread per 16-byte window of an output row, written with one
//   uint4 store. blockIdx.y is the row: the covering tile rows and their
//   local row are the same for the whole CTA.
// - 32-bit index math; the row's base is the only 64-bit address. A
//   window's first byte costs one division by 3 and one by the column
//   stride; its 16 bytes span 6 pixels, each byte's pixel one select on
//   the first byte's channel. That channel cycles 0, 1, 2 over the lanes
//   of a warp: code specialised on it ran the warp three times (0.142 ms
//   at 720p -> 4x, 30% of the bound, on the H100: chip_smoke.py phase 4).
// - When the 6 pixels have the same covering tiles (all but a few windows
//   per tile edge), each covering tile gives 16 consecutive values of one
//   tile row: two 16-byte loads in bf16, four in fp32, where the address
//   is aligned (at 720p->4x always), scalar loads otherwise.
// - Windows that cross a tile's column edge, and the partial windows at
//   the ends of rows whose bytes are not 16-byte aligned, go byte by byte.
// Tiles are read where the model left them, through a device table of
// per-tile base pointers (TileStream hands finalize pieces of several
// chunks); no fp32 canvas, no stitch, no concat of the chunk outputs.
#include "common.cuh"

namespace w2x {
namespace {

struct FinalizeArgs {
  const long long* tiles;  // (T,) base address of each (oh, ow, 3) tile
  const float* row_w;      // (T, oh) row ramps
  const float* col_w;      // (T, ow) column ramps
  unsigned char* out;      // (out_h, out_w, 3) u8
  int out_h, out_w, R, C, sy, sx, oh, ow;
};

// The tiles lo..hi (at most two: overlap <= stride) that cover output
// coordinate p along one axis of the grid; hi < lo when none does (only
// past the canvas, which the plans never reach).
__device__ __forceinline__ int2 cover(int p, int stride, int n, int size) {
  const int hi = min((int)((unsigned)p / (unsigned)stride), n - 1);
  if (p - hi * stride >= size) return make_int2(hi + 1, hi);
  const int lo = (hi > 0 && p < (hi - 1) * stride + size) ? hi - 1 : hi;
  return make_int2(lo, hi);
}

// clip(rint(acc * 255), 0, 255) -> u8 in one conversion: cvt.rni rounds
// half to even and clamps to the u8 range (NaN -> 0, as fmaxf(NaN, 0)).
__device__ __forceinline__ unsigned quantize(float acc) {
  unsigned short q;
  asm("cvt.rni.u8.f32 %0, %1;" : "=h"(q) : "f"(__fmul_rn(acc, 255.f)));
  return q;
}

// 16 consecutive tile values as float. The bf16 tiles are read once and
// marked evict-first (__ldcs); see TileTraits.
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float v[16]) {
  if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
    const uint4 a = __ldcs(q), b = __ldcs(q + 1);
    const unsigned w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int k = 0; k < 8; ++k) {  // element 2k is the low half of word k
      v[2 * k] = __uint_as_float(w[k] << 16);
      v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) v[i] = __bfloat162float(p[i]);
  }
}

__device__ __forceinline__ void load16(const float* p, float v[16]) {
  if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4 f = __ldg(q + k);
      v[4 * k] = f.x;
      v[4 * k + 1] = f.y;
      v[4 * k + 2] = f.z;
      v[4 * k + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) v[i] = __ldg(p + i);
  }
}

// The 16 bytes of a window whose first byte is pixel x0, channel ch0, and
// whose 6 pixels x0..x0+5 share the covering columns cc; rc the row's
// covering rows. Byte i is pixel i / 3 + (ch0 + i % 3 >= 3) of the window:
// a select per byte, so that the lanes of a warp (whose ch0 cycle through
// 0, 1, 2) run one path.
template <typename T>
__device__ __forceinline__ uint4 window16(const FinalizeArgs& a, int y,
                                          int2 rc, int x0, int ch0,
                                          int2 cc) {
  const bool b1 = ch0 >= 1, b2 = ch0 >= 2;
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  for (int c = cc.x; c <= cc.y; ++c) {
    const int lx = x0 - c * a.sx;
    for (int r = rc.x; r <= rc.y; ++r) {  // ascending t = c * R + r
      const int t = c * a.R + r;
      const int ly = y - r * a.sy;
      float v[16];
      load16(reinterpret_cast<const T*>(a.tiles[t]) + (ly * a.ow + lx) * 3
                 + ch0, v);
      const float rw = __ldg(a.row_w + t * a.oh + ly);
      const float* cwp = a.col_w + t * a.ow + lx;
      float cw[6];
#pragma unroll
      for (int j = 0; j < 6; ++j) cw[j] = __ldg(cwp + j);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int j = i / 3;
        const float w = i % 3 == 0 ? cw[j]
                        : (i % 3 == 1 ? (b2 ? cw[j + 1] : cw[j])
                                      : (b1 ? cw[j + 1] : cw[j]));
        acc[i] = __fadd_rn(acc[i], __fmul_rn(__fmul_rn(v[i], rw), w));
      }
    }
  }
  unsigned w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    w[k] = quantize(acc[4 * k]) | quantize(acc[4 * k + 1]) << 8
           | quantize(acc[4 * k + 2]) << 16 | quantize(acc[4 * k + 3]) << 24;
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// One output byte (y, x, ch), covering rows rc and columns cc.
template <typename T>
__device__ unsigned char blend_byte(const FinalizeArgs& a, int y, int2 rc,
                                    int x, int ch, int2 cc) {
  float acc = 0.f;
  for (int c = cc.x; c <= cc.y; ++c) {
    const int lx = x - c * a.sx;
    for (int r = rc.x; r <= rc.y; ++r) {  // ascending t = c * R + r
      const int t = c * a.R + r;
      const int ly = y - r * a.sy;
      const T* tile = reinterpret_cast<const T*>(a.tiles[t]);
      const float v = to_f(tile[(ly * a.ow + lx) * 3 + ch]);
      acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v, __ldg(a.row_w + t * a.oh
                                                           + ly)),
                                     __ldg(a.col_w + t * a.ow + lx)));
    }
  }
  return (unsigned char)quantize(acc);
}

// Per tile type, as measured on the H100 at 720p -> 4x
// (tools/finalize_variants.py): bf16 runs faster with 5 resident CTAs of
// 256 threads an SM (48 registers; 6 spill) and evict-first loads and
// stores; fp32, twice the bytes a value, runs slower with them and keeps
// the plain ones.
template <typename T>
struct TileTraits {
  static constexpr int kMinBlocks = 1;
  static __device__ __forceinline__ void store(uint4* p, uint4 v) { *p = v; }
};
template <>
struct TileTraits<__nv_bfloat16> {
  static constexpr int kMinBlocks = 5;
  static __device__ __forceinline__ void store(uint4* p, uint4 v) {
    __stcs(p, v);
  }
};

// Grid (windows of a row / blockDim.x, rows): thread k of a row owns the
// row's k-th 16-byte window of device memory, i.e. row bytes
// [16k - m, 16k - m + 16) where m is the row's misalignment; the first and
// last windows may be partial.
template <typename T>
__global__ void __launch_bounds__(256, TileTraits<T>::kMinBlocks)
    finalize_gather_kernel(const FinalizeArgs a) {
  const int row_bytes = a.out_w * 3;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  for (int y = blockIdx.y; y < a.out_h; y += gridDim.y) {
    unsigned char* row = a.out + (size_t)y * row_bytes;
    const int s = 16 * k - (int)(reinterpret_cast<uintptr_t>(row) & 15);
    if (s >= row_bytes) continue;
    const int2 rc = cover(y, a.sy, a.R, a.oh);
    if (s >= 0 && s + 16 <= row_bytes) {
      const int x0 = (unsigned)s / 3u;
      const int ch0 = s - 3 * x0;
      const int2 ca = cover(x0, a.sx, a.C, a.ow);
      const int2 cb = cover(x0 + 5, a.sx, a.C, a.ow);
      if (ca.x == cb.x && ca.y == cb.y) {
        TileTraits<T>::store(reinterpret_cast<uint4*>(row + s),
                             window16<T>(a, y, rc, x0, ch0, ca));
        continue;
      }
    }
    // a partial window, or one across a tile's column edge: byte by byte
    const int lo = max(s, 0), hi = min(s + 16, row_bytes);
    int x = (unsigned)lo / 3u, ch = lo - 3 * x;
    int2 cc = cover(x, a.sx, a.C, a.ow);
    for (int i = lo; i < hi; ++i) {
      row[i] = blend_byte<T>(a, y, rc, x, ch, cc);
      if (++ch == 3) {
        ch = 0;
        ++x;
        if (i + 1 < hi) cc = cover(x, a.sx, a.C, a.ow);
      }
    }
  }
}

template <typename T>
int launch_finalize(const FinalizeArgs& a, cudaStream_t stream) {
  const int row_bytes = a.out_w * 3;
  const bool aligned = (reinterpret_cast<uintptr_t>(a.out) & 15) == 0
                       && row_bytes % 16 == 0;
  // windows a row touches: with a misalignment m <= 15, ceil((m + bytes) / 16)
  const int windows = aligned ? row_bytes / 16 : (row_bytes + 30) / 16;
  // the CTA width (a multiple of 32 in [64, 256]) that leaves the fewest
  // threads of a row without a window
  int threads = 256, spent = 0x7fffffff;
  for (int th = 256; th >= 64; th -= 32) {
    const int n = (windows + th - 1) / th * th;
    if (n < spent) {
      spent = n;
      threads = th;
    }
  }
  const dim3 grid((windows + threads - 1) / threads,
                  a.out_h < 65535 ? a.out_h : 65535);
  finalize_gather_kernel<T><<<grid, threads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace w2x

extern "C" int w2x_finalize_gather(const void* tiles, const void* row_w,
                                   const void* col_w, void* out, int out_h,
                                   int out_w, int R, int Cn, int sy, int sx,
                                   int oh, int ow, int is_bf16,
                                   void* stream) {
  const w2x::FinalizeArgs a{static_cast<const long long*>(tiles),
                            static_cast<const float*>(row_w),
                            static_cast<const float*>(col_w),
                            static_cast<unsigned char*>(out),
                            out_h, out_w, R, Cn, sy, sx, oh, ow};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return w2x::launch_finalize<__nv_bfloat16>(a, s);
  return w2x::launch_finalize<float>(a, s);
}
