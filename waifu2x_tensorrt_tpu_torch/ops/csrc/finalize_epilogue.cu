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
// What bounds it on the H100: bytes. At 720p->4x it reads the 18 bf16
// tiles' covering values (~1.2 elements per output element, ~53 MB) and
// writes the 44 MB u8 frame; the arithmetic is a few flops per byte.
// What the design does about it: one thread per output element, writing
// the u8 frame in place — no fp32 canvas, no stitch, no concat of the
// chunk outputs. Tiles are read where the model left them, through a
// device table of per-tile base pointers (TileStream hands finalize
// pieces of several chunks). The Mosaic layout rules of the TPU version
// (128-lane strips, ovy % 8, the missing f32->u8 cast) do not apply.
#include "common.cuh"

namespace w2x {

template <typename T>
__global__ void finalize_gather_kernel(const long long* __restrict__ tiles,
                                       const float* __restrict__ row_w,
                                       const float* __restrict__ col_w,
                                       unsigned char* __restrict__ out,
                                       int out_h, int out_w, int R, int Cn,
                                       int sy, int sx, int oh, int ow) {
  const long long total = (long long)out_h * out_w * 3;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int ch = (int)(idx % 3);
  const long long pix = idx / 3;
  const int x = (int)(pix % out_w);
  const int y = (int)(pix / out_w);
  // covering rows: r1 = the last origin at or above y, r1 - 1 when its
  // tile still reaches y (overlap <= stride: at most two); same for cols
  const int r1 = min(y / sy, R - 1);
  const int c1 = min(x / sx, Cn - 1);
  const int r0 = (r1 > 0 && y < (r1 - 1) * sy + oh) ? r1 - 1 : r1;
  const int c0 = (c1 > 0 && x < (c1 - 1) * sx + ow) ? c1 - 1 : c1;
  float acc = 0.f;
  for (int c = c0; c <= c1; ++c) {
    const int lx = x - c * sx;
    for (int r = r0; r <= r1; ++r) {  // ascending t = c * R + r
      const int ly = y - r * sy;
      if (ly >= oh || lx >= ow) continue;
      const int t = c * R + r;
      const T* tile = reinterpret_cast<const T*>(tiles[t]);
      const float v = to_f(tile[((size_t)ly * ow + lx) * 3 + ch]);
      const float contrib =
          __fmul_rn(__fmul_rn(v, row_w[(size_t)t * oh + ly]),
                    col_w[(size_t)t * ow + lx]);
      acc = __fadd_rn(acc, contrib);
    }
  }
  const float q = fminf(fmaxf(rintf(__fmul_rn(acc, 255.f)), 0.f), 255.f);
  out[idx] = (unsigned char)q;
}

template <typename T>
int launch_finalize(const void* tiles, const void* row_w, const void* col_w,
                    void* out, int out_h, int out_w, int R, int Cn, int sy,
                    int sx, int oh, int ow, cudaStream_t stream) {
  const long long total = (long long)out_h * out_w * 3;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  finalize_gather_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const long long*>(tiles), static_cast<const float*>(row_w),
      static_cast<const float*>(col_w), static_cast<unsigned char*>(out),
      out_h, out_w, R, Cn, sy, sx, oh, ow);
  return (int)cudaGetLastError();
}

}  // namespace w2x

extern "C" int w2x_finalize_gather(const void* tiles, const void* row_w,
                                   const void* col_w, void* out, int out_h,
                                   int out_w, int R, int Cn, int sy, int sx,
                                   int oh, int ow, int is_bf16,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return w2x::launch_finalize<__nv_bfloat16>(tiles, row_w, col_w, out,
                                               out_h, out_w, R, Cn, sy, sx,
                                               oh, ow, s);
  return w2x::launch_finalize<float>(tiles, row_w, col_w, out, out_h, out_w,
                                     R, Cn, sy, sx, oh, ow, s);
}
