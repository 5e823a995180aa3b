// Kernel G: HAT's and DAT's window attention on the (B, H, W, 3C) qkv
// activation.
//
// Replaces no TPU kernel: the JAX package has neither model. Added
// because no kernel of the port computes this attention (kernels A, B
// and E take 64-token windows at head dim 32). Its plain twin is
// ops/hat_attention.py hat_attention_plain.
//
// One CTA computes one head of one 256-query window. HAT's windows are
// 16 x 16 (hat_attention_kernel); DAT's DSTB splits its heads
// (hat_attention_rect_kernel): heads [0, nh / 2) attend in 8-row x
// 32-column windows rolled by (sy, sx) = (4, 16) on shifted blocks, heads
// [nh / 2, nh) in 32 x 8 windows rolled by (16, 4), each head's bias
// column indexed (dy + wh - 1)(2 ww - 1) + dx + ww - 1 in its own
// geometry (945 rows) and Swin's region law applied per axis. Both halves
// have 256 queries and keys a window, so the core below (the geometry a
// template parameter: Geo<WW, OV>, Window<WW>) is HAT's self attention
// with other address and bias steps. HAT's 16 x 16 windows:
//   self (OV = 0; HAT's HAB): the keys are the window's own 256 tokens of
//     the map rolled by -shift; masked pairs (Swin's region law of the
//     roll, windows of the last row / column) get -100 added, as HAT's
//     calculate_mask; bias index (dy + 15) * 31 + dx + 15, (dy, dx) =
//     query - key (calculate_rpi_sa);
//   overlapping (OV = 4; HAT's OCAB): the keys are the 24 x 24 = 576
//     tokens of the window with the same centre, k = v = 0 outside the
//     map (HAT's zero-padded unfold: such a key's score is its bias);
//     bias index (ey - oy - 7) * 39 + ex - ox - 7 with (ey, ex) the key's
//     and (oy, ox) the query's place in their windows, negative indices
//     counting from the end of the 1521-row table (calculate_rpi_oca).
// q, k and v are read by address from the qkv activation (token t, part
// p of q / k / v, head h: qkv[t * 3P + p * P + h * d ..], d the head
// dim, each part C = nh d real channels at a pitch P >= C: HAT's and
// DAT's trunk at 16-byte rows, P = 192 for C = 180), the roll and the
// window partition in the address, so nothing is copied around the
// kernel; the output, of pitch P, is written to the token each query
// came from (the roll back and the window merge), the last head's CTAs
// writing zeros to the pad channels [C, P) of their queries' tokens.
//
// Rounding points are those of attention_tc.cuh: q * scale rounded to
// bf16 (the scale d^-0.5 rounded to bf16 by the wrapper), fp32 scores and
// an exact max-subtracted softmax, p = e / sum correctly rounded and then
// rounded to bf16 before the fp32-accumulated p v, one final rounding.
// exp(s - max) is 2^(s log2(e) - max log2(e)) on the special-function
// unit (one op, relative error ~1e-6 at these arguments, far below
// bf16's 4e-3; results below fp32's normal range flush to 0, as their
// bf16 probabilities would round). The keys come in blocks of 64 and the
// scores of a block live in registers, so the softmax takes two passes
// over the keys: the first keeps each row's running max and its sum of
// exp (rescaled when the max moves), the second recomputes the scores
// and accumulates p v with p from the final max and sum. Only the order
// of the fp32 sums differs from the twin.
//
// What bounds it on the H100: per launch over the 4096 windows of a
// chunk of 16 256 x 256 tiles (6 heads of 30), the attention products
// are 193 GFLOP (self) and 435 GFLOP (overlapping), 0.20 and 0.44 ms at
// 989 TFLOP/s; q, k, v read once and the output written once are 1.51
// GB, 0.45 ms at 3.35 TB/s. So memory bounds both on paper, overlapping
// attention barely. The kernel does more than that work: the head dim is
// padded from 30 to 32 with zeros (exact), the first pass computes q k^T
// a second time (1.5x the products), the overlapping keys of neighbouring
// windows are read again (2.25x k and v, mostly from L2), every warp
// reads the head's k twice and v once from shared memory, and each
// score takes two exponentials (pass 1 and 2): 3.2 G a self launch, 0.87
// ms at the special-function units' 16 a clock an SM. Those last two,
// not the bound, hold it (2.39 / 4.97 ms a launch, PERF.md).
//
// Design: mma.sync m16n8k16 (bf16 in, fp32 accumulators) fed by
// ldmatrix, as kernels A and B; 8 warps, each owning 16 query rows at a
// time (two row blocks each), scores and probabilities in registers.
// q, k and v of the head (rows of 32 bf16, 64 bytes, the 16-byte chunks
// XOR-swizzled by row so that ldmatrix is free of bank conflicts) and the
// head's column of the bias table stage in shared memory through 4-byte
// cp.async copies (a head's 60 bytes of a token are 4-byte but not
// 16-byte aligned), the zero fill of the padding and of keys outside the
// map by the copies' source size. The overlapping window's keys are
// staged as 8 x 8 tiles, and its table rotated by 880 rows (HAT's
// negative indices made plain), so that within a key block every score's
// bias is one shared-memory load at a compile-time offset from a per-lane
// base (bias_base, bias_step); only the windows that the roll wraps (the
// last row and column of a shifted launch) evaluate the region mask.
// Shared memory: 53 KB (self and split) and 96 KB (overlapping); 107 /
// 100 / 117 registers, 2 CTAs an SM. A token's row and column in its
// window are shifts and masks of its index (the column counts are powers
// of two): the same math as signed divisions and remainders by WW cost
// the self kernel 8 registers and 20% of its time.
#include "attention_tc.cuh"

namespace w2x {
namespace hat {

using bf16 = __nv_bfloat16;

constexpr int WS = 16;             // HAT's (square) query window side
constexpr int NQ = WS * WS;        // queries a window, of every geometry
constexpr int HDP = 32;            // head dim as padded in shared memory
constexpr int ROW_WORDS = HDP / 2; // 32-bit words a shared-memory row
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int KB = 64;             // keys a score block
constexpr float MASK = -100.f;     // HAT's score between regions

// A geometry: query windows of WH x WW tokens (WW columns: 16 for HAT,
// 32 or 8 for DAT's two branches), self (OV = 0) or overlapping keys.
template <int WW, int OV>
struct Geo {
  static constexpr int WH = NQ / WW;      // query window rows
  static constexpr int WE = WS + 2 * OV;  // overlapping key window side
  static constexpr int NK = OV ? WE * WE : NQ;     // keys a window
  static constexpr int TW = OV ? WS + WE - 1 : 2 * WW - 1;  // table row
  static constexpr int NT = OV ? TW * TW : (2 * WH - 1) * TW;  // rows
  static constexpr int NKB = NK / KB;
  // staged table entry = HAT's index + SHIFT (overlapping: all >= 0)
  static constexpr int SHIFT = OV ? (WE - 2) * (TW + 1) : 0;
  static constexpr int SMEM = (NQ + 2 * NK) * HDP * 2 + NT * 4;
  static_assert(NK % KB == 0, "whole key blocks");
  static_assert(WW == 8 || WW == 16 || WW == 32, "8, 16 or 32 columns");
  static_assert(OV == 0 || WW == WS, "overlapping windows are square");
};

// log2 of a window's columns: token i of a window is (i >> LOG, i & (WW -
// 1)), shifts and masks as in the square kernel's first version.
template <int WW>
constexpr int LOG = WW == 8 ? 3 : WW == 16 ? 4 : 5;

// Element offset of 16-byte chunk ch (0..3) of shared-memory row r: the
// chunks of a row are XOR-swizzled by (r / 2) % 4, so the 8 rows that one
// ldmatrix matrix reads lie in 8 distinct 4-bank groups.
__device__ __forceinline__ int swz(int r, int ch) {
  return r * HDP + ((ch ^ ((r >> 1) & 3)) << 3);
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

// 2^x on the special-function unit (one MUFU op; results below the
// normal range flush to 0, which a bf16 probability rounds to anyway).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr float LOG2E = 1.4426950408889634f;

// Where one WH x WW window's tokens lie in the activation.
template <int WW>
struct Window {
  static constexpr int WH = NQ / WW;
  int b, wy, wx, h, w, sy, sx;
  // token index (b, y, x) of query i: the rolled map's (WH wy + i / WW,
  // WW wx + i % WW), read from (row + sy) mod h, (col + sx) mod w
  __device__ __forceinline__ int query_token(int i) const {
    int y = wy * WH + (i >> LOG<WW>) + sy, x = wx * WW + (i & (WW - 1)) + sx;
    if (y >= h) y -= h;
    if (x >= w) x -= w;
    return (b * h + y) * w + x;
  }
  // token index of key j (its row of shared memory), or -1 outside the
  // map. Self: the query order. Overlapping: 8 x 8 tiles of the 24 x 24
  // window, tile-major (block kb of 64 keys is tile (kb / 3, kb % 3)),
  // so that a key block's bias rows step by constants (bias_base).
  template <int OV>
  __device__ __forceinline__ int key_token(int j) const {
    if constexpr (OV == 0) {
      return query_token(j);
    } else {
      const int kb = j >> 6, ey = (kb / 3) * 8 + ((j >> 3) & 7),
                ex = (kb % 3) * 8 + (j & 7);
      const int y = wy * WS - OV + ey, x = wx * WS - OV + ex;
      return (y < 0 || y >= h || x < 0 || x >= w) ? -1 : (b * h + y) * w + x;
    }
  }
};

// The bias of score s[j][e] of a key block (row r0 + g + 8 (e >> 1) of
// the window, key 8 j + 2 t + (e & 1) of the block) sits at shared
// table entry bias_base(...) + bias_step(j, e): a per-lane base for the
// block and a compile-time step, so the gather is one load at an
// immediate offset.
//   self: query (qy, qx) = (r0 / WW, r0 % WW + g + 8 (e >> 1)) for WW
//     16 or 32 (a 16-row block lies in one window row), (r0 / 8 + (e >>
//     1), g) for WW 8; key (64 kb + 8 j) / WW, (8 j) % WW + 2 t + (e & 1));
//     row (qy - ky + WH - 1)(2 WW - 1) + qx - kx + WW - 1 (HAT's 16 x 16:
//     (qy - ky + 15) 31 + qx - kx + 15);
//   overlapping: key (8 (kb / 3) + j, 8 (kb % 3) + 2 t + (e & 1)) of the
//     24 x 24 window; row (ey - qy - 7) 39 + ex - qx - 7 + 880 of the
//     table as staged: HAT's index, whose negative values count from the
//     end, shifted by 880 = 22 * 40 so that every one is a plain index.
template <int WW, int OV>
__device__ __forceinline__ int bias_base(int r0, int g, int t, int kb) {
  using G = Geo<WW, OV>;
  if constexpr (OV == 0) {
    // r0 is a multiple of 16: at 16 columns qx is 0
    const int qy = r0 >> (WW >= 16 ? LOG<WW> : 3);
    const int qx = WW > 16 ? (r0 & (WW - 1)) : 0;
    return (qy - kb * (KB / WW) + G::WH - 1) * G::TW + qx + g - 2 * t + WW -
           1;
  } else {
    const int qy = r0 >> 4;
    return (8 * (kb / 3) - qy + WS - G::WE + 1) * G::TW + 8 * (kb % 3) +
           2 * t - g + WS - G::WE + 1 + G::SHIFT;
  }
}

template <int WW, int OV>
__device__ __forceinline__ constexpr int bias_step(int j, int e) {
  if constexpr (OV == 0) {
    const int qy = WW == 8 ? (e >> 1) : 0, qx = WW == 8 ? 0 : 8 * (e >> 1);
    return (qy - 8 * j / WW) * Geo<WW, OV>::TW + qx - 8 * j % WW - (e & 1);
  } else {
    return Geo<WW, OV>::TW * j + (e & 1) - 8 * (e >> 1);
  }
}

// Scores of this warp's 16 rows (r0..) against key block kb: the bias
// (MASKED: plus -100 where Swin's region law of the roll parts query and
// key, in the last row / column of windows, edges (WH - sy, WW - sx))
// and then + (q * scale) k^T, in the accumulator layout.
template <int WW, int OV, bool MASKED>
__device__ __forceinline__ void scores(float (&s)[8][4],
                                       const uint32_t (&qa)[2][4],
                                       const bf16* ks, const float* tbl,
                                       int r0, int kb, int edge_y,
                                       int edge_x, bool bottom, bool right) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* base = tbl + bias_base<WW, OV>(r0, g, t, kb);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = base[bias_step<WW, OV>(j, e)];
      if constexpr (MASKED) {
        // bias_base's and bias_step's coordinates, summed
        const int qy = (r0 >> (WW >= 16 ? LOG<WW> : 3)) +
                       (WW == 8 ? (e >> 1) : 0);
        const int qx = (WW > 16 ? (r0 & (WW - 1)) : 0) +
                       (WW == 8 ? g : g + 8 * (e >> 1));
        const int ky = kb * (KB / WW) + 8 * j / WW;
        const int kx = 8 * j % WW + 2 * t + (e & 1);
        const bool row_cross = (qy >= edge_y) != (ky >= edge_y);
        const bool col_cross = (qx >= edge_x) != (kx >= edge_x);
        if ((bottom && row_cross) || (right && col_cross)) v += MASK;
      }
      s[j][e] = v;
    }
  const int krow = kb * KB + (lane & 7) + ((lane >> 4) << 3);
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      uint32_t b[4];
      tc::ldsm_x4(b, ks + swz(krow + j * 8, 2 * kk + ((lane >> 3) & 1)));
      tc::mma_bf16(s[j], qa[kk], b[0], b[1]);
      tc::mma_bf16(s[j + 1], qa[kk], b[2], b[3]);
    }
}

// The attention of this warp's row blocks on the staged q, k, v and
// table: the two passes over the key blocks and the output's stores.
template <int WW, int OV, bool MASKED>
__device__ __forceinline__ void attend(const bf16* qs, const bf16* ks,
                                       const bf16* vs, const float* tbl,
                                       bf16* __restrict__ out,
                                       const Window<WW>& wd, int C, int P,
                                       int d, float scale, int edge_y,
                                       int edge_x, bool bottom, bool right) {
  using G = Geo<WW, OV>;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int head = blockIdx.x % (C / d);
  for (int rb = threadIdx.x >> 5; rb < NQ / 16; rb += WARPS) {
    const int r0 = rb * 16;
    uint32_t qa[2][4];  // q * scale, rounded to bf16, as A fragments
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      tc::ldsm_x4(qa[kk], qs + swz(r0 + (lane & 15), 2 * kk + (lane >> 4)));
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&qa[kk][r]));
        qa[kk][r] = tc::pack_bf16(f.x * scale, f.y * scale);
      }
    }
    // pass 1: each row's max and sum of exp (this lane's entries; the
    // max is the row's, shared by the quad)
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    for (int kb = 0; kb < G::NKB; ++kb) {
      float s[8][4];
      scores<WW, OV, MASKED>(s, qa, ks, tbl, r0, kb, edge_y, edge_x,
                             bottom, right);
      float bm[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) bm[e >> 1] = fmaxf(bm[e >> 1], s[j][e]);
      float nm[2];  // -max * log2(e): exp(s - max) = 2^(s log2(e) + nm)
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float mn = fmaxf(m[k], attn::quad_max(bm[k]));
        l[k] *= exp2_ftz((m[k] - mn) * LOG2E);
        m[k] = mn;
        nm[k] = -mn * LOG2E;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          l[e >> 1] += exp2_ftz(fmaf(s[j][e], LOG2E, nm[e >> 1]));
    }
    const float nm[2] = {-m[0] * LOG2E, -m[1] * LOG2E};
    l[0] = attn::quad_sum(l[0]);
    l[1] = attn::quad_sum(l[1]);
    const float inv[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
    // pass 2: p = e / sum, correctly rounded (the row's correctly rounded
    // reciprocal, a product and one exact-remainder correction, as
    // attention_tc.cuh), rounded to bf16, and o += p v
    float acc[4][4] = {};
    for (int kb = 0; kb < G::NKB; ++kb) {
      float s[8][4];
      scores<WW, OV, MASKED>(s, qa, ks, tbl, r0, kb, edge_y, edge_x,
                             bottom, right);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = e >> 1;
          const float ex = exp2_ftz(fmaf(s[j][e], LOG2E, nm[k]));
          const float x = ex * inv[k];
          s[j][e] = fmaf(fmaf(-x, l[k], ex), inv[k], x);
        }
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) tc::to_a_frag(pa[kk], s[2 * kk], s[2 * kk + 1]);
      const int vrow = kb * KB + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 4; j += 2) {
          uint32_t b[4];
          tc::ldsm_x4_trans(b, vs + swz(vrow + kk * 16, j + (lane >> 4)));
          tc::mma_bf16(acc[j], pa[kk], b[0], b[1]);
          tc::mma_bf16(acc[j + 1], pa[kk], b[2], b[3]);
        }
    }
    // the output of rows r0 + g and r0 + g + 8, head dims 8 j + 2 t (+1),
    // to the tokens the queries came from
    const size_t ta = (size_t)wd.query_token(r0 + g) * P;
    const size_t tb = (size_t)wd.query_token(r0 + g + 8) * P;
    const size_t oa = ta + head * d, ob = tb + head * d;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 8 * j + 2 * t;
      if (col < d) {
        *reinterpret_cast<uint32_t*>(out + oa + col) =
            tc::pack_bf16(acc[j][0], acc[j][1]);
        *reinterpret_cast<uint32_t*>(out + ob + col) =
            tc::pack_bf16(acc[j][2], acc[j][3]);
      }
    }
    if (head == C / d - 1)  // the pad of these tokens' rows (C, P even)
      for (int col = C + 2 * t; col < P; col += 8) {
        *reinterpret_cast<uint32_t*>(out + ta + col) = 0u;
        *reinterpret_cast<uint32_t*>(out + tb + col) = 0u;
      }
  }
}

// Stage q, k and v of the head (words past d / 2 and keys outside the
// map zero-filled) and the head's column of the table in shared memory;
// returns the table.
template <int WW, int OV>
__device__ __forceinline__ const float* stage(
    const bf16* __restrict__ qkv, const float* __restrict__ table,
    unsigned char* smem, const Window<WW>& wd, int C, int P, int nh,
    int head) {
  using G = Geo<WW, OV>;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  float* tbl = reinterpret_cast<float*>(qs + (NQ + 2 * G::NK) * HDP);
  const int d = C / nh, tid = threadIdx.x;
  const int words = d / 2;
  for (int it = tid; it < (NQ + 2 * G::NK) * ROW_WORDS; it += THREADS) {
    const int r = it / ROW_WORDS, word = it % ROW_WORDS;
    int tok, part;
    if (r < NQ) {
      tok = wd.query_token(r);
      part = 0;
    } else if (r < NQ + G::NK) {
      tok = wd.template key_token<OV>(r - NQ);
      part = 1;
    } else {
      tok = wd.template key_token<OV>(r - NQ - G::NK);
      part = 2;
    }
    const bool valid = tok >= 0 && word < words;
    const bf16* src =
        valid ? qkv + (size_t)tok * 3 * P + part * P + head * d + 2 * word
              : qkv;
    cp_async4(qs + swz(r, word >> 2) + 2 * (word & 3), src, valid);
  }
  tc::cp_async_commit();
  for (int i = tid; i < G::NT; i += THREADS) {
    const int row = i >= G::SHIFT ? i - G::SHIFT : i - G::SHIFT + G::NT;
    tbl[i] = __ldg(table + row * nh + head);
  }
  tc::cp_async_wait<0>();
  __syncthreads();
  return tbl;
}

// One CTA: head `head` of window `win` (row-major over the batch's
// windows) in the WH x WW geometry, rolled by (sy, sx).
template <int WW, int OV>
__device__ __forceinline__ void window_head(
    const bf16* __restrict__ qkv, const float* __restrict__ table,
    bf16* __restrict__ out, unsigned char* smem, int win, int head, int h,
    int w, int C, int P, int nh, int sy, int sx, float scale) {
  using G = Geo<WW, OV>;
  const int nwx = w / WW, nwy = h / G::WH;
  Window<WW> wd;
  wd.wx = win % nwx;
  win /= nwx;
  wd.wy = win % nwy;
  wd.b = win / nwy;
  wd.h = h;
  wd.w = w;
  wd.sy = sy;
  wd.sx = sx;
  const float* tbl = stage<WW, OV>(qkv, table, smem, wd, C, P, nh, head);
  const bf16* qs = reinterpret_cast<const bf16*>(smem);
  const bf16* ks = qs + NQ * HDP;
  const bf16* vs = ks + G::NK * HDP;
  const int d = C / nh;
  const int edge_y = G::WH - sy, edge_x = WW - sx;
  const bool bottom = sy && wd.wy == nwy - 1;
  const bool right = sx && wd.wx == nwx - 1;
  if constexpr (OV == 0) {
    if (bottom || right) {  // a window that the roll wraps: masked
      attend<WW, OV, true>(qs, ks, vs, tbl, out, wd, C, P, d, scale,
                           edge_y, edge_x, bottom, right);
      return;
    }
  }
  attend<WW, OV, false>(qs, ks, vs, tbl, out, wd, C, P, d, scale, edge_y,
                        edge_x, bottom, right);
}

// HAT: 16 x 16 windows, self (OV 0, shift 0 or 8) or overlapping (OV 4).
template <int OV>
__global__ void __launch_bounds__(THREADS, 2)
    hat_attention_kernel(const bf16* __restrict__ qkv,
                         const float* __restrict__ table,
                         bf16* __restrict__ out, int h, int w, int C, int P,
                         int nh, int shift, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  window_head<WS, OV>(qkv, table, out, smem, blockIdx.x / nh,
                      blockIdx.x % nh, h, w, C, P, nh, shift, shift, scale);
}

// DAT's split windows: heads [0, nh / 2) in (NQ / WW0) x WW0 windows
// rolled by (sy, sx), heads [nh / 2, nh) in the transposed windows rolled
// by (sx, sy). Both halves have NQ tokens a window, so h w / NQ windows
// each: the grid is the same (window, head) order as HAT's.
template <int WW0>
__global__ void __launch_bounds__(THREADS, 2)
    hat_attention_rect_kernel(const bf16* __restrict__ qkv,
                              const float* __restrict__ table,
                              bf16* __restrict__ out, int h, int w, int C,
                              int P, int nh, int sy, int sx, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int head = blockIdx.x % nh, win = blockIdx.x / nh;
  if (head < nh / 2)
    window_head<WW0, 0>(qkv, table, out, smem, win, head, h, w, C, P, nh,
                        sy, sx, scale);
  else
    window_head<NQ / WW0, 0>(qkv, table, out, smem, win, head, h, w, C, P,
                             nh, sx, sy, scale);
}


namespace {

constexpr int kMaxDevices = 64;

// Raise a kernel's dynamic shared-memory limit, once per kernel and
// device; kept in a function of internal linkage that is no template, for
// the reason set_smem_limit in swin_block.cu gives (each copy of the
// library keeps its own flags).
int set_smem_limit(const void* kernel, int bytes) {
  static const void* done[kMaxDevices][3] = {};  // self, overlap, rect
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const void** mine = dev < kMaxDevices ? done[dev] : nullptr;
  for (int i = 0; mine && i < 3; ++i)
    if (mine[i] == kernel) return 0;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return (int)err;
  for (int i = 0; mine && i < 3; ++i)
    if (!mine[i]) {
      mine[i] = kernel;
      break;
    }
  return 0;
}

template <int OV>
int launch(const void* qkv, const void* table, void* out, int b, int h,
           int w, int C, int P, int nh, int shift, float scale,
           cudaStream_t stream) {
  using G = Geo<WS, OV>;
  const int err = set_smem_limit((const void*)hat_attention_kernel<OV>,
                                 G::SMEM);
  if (err) return err;
  const long long grid = (long long)b * (h / WS) * (w / WS) * nh;
  if (grid == 0) return 0;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  hat_attention_kernel<OV><<<(unsigned)grid, THREADS, G::SMEM, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(table),
      static_cast<bf16*>(out), h, w, C, P, nh, shift, scale);
  return (int)cudaGetLastError();
}

constexpr int RECT_WW = 32;  // DAT: 8 x 32 windows, then 32 x 8
constexpr int RECT_SMEM = Geo<RECT_WW, 0>::SMEM;
static_assert(Geo<NQ / RECT_WW, 0>::SMEM == RECT_SMEM, "one size");

int launch_rect(const void* qkv, const void* table, void* out, int b, int h,
                int w, int C, int P, int nh, int sy, int sx, float scale,
                cudaStream_t stream) {
  const int err = set_smem_limit(
      (const void*)hat_attention_rect_kernel<RECT_WW>, RECT_SMEM);
  if (err) return err;
  const long long grid = (long long)b * (h / RECT_WW) * (w / RECT_WW) *
                         (RECT_WW * RECT_WW / NQ) * nh;
  if (grid == 0) return 0;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  hat_attention_rect_kernel<RECT_WW>
      <<<(unsigned)grid, THREADS, RECT_SMEM, stream>>>(
          static_cast<const bf16*>(qkv), static_cast<const float*>(table),
          static_cast<bf16*>(out), h, w, C, P, nh, sy, sx, scale);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace hat
}  // namespace w2x

// qkv (B, h, w, 3P) bf16, table (rows, nh) fp32, out (B, h, w, P) bf16;
// C real channels of each part of pitch P (C <= P, P even); h and w
// multiples of 16; head dim C / nh even and at most 32; overlap 0 (self,
// shift 0 or 8) or 4 (overlapping, shift 0); scale: the head dim's
// d^-0.5 rounded to bf16.
extern "C" int w2x_hat_attention(const void* qkv, const void* table,
                                 void* out, int b, int h, int w, int C,
                                 int P, int nh, int shift, int overlap,
                                 float scale, void* stream) {
  using namespace w2x::hat;
  if (nh <= 0 || C % nh || (C / nh) % 2 || C / nh > HDP || h % WS ||
      w % WS || h <= 0 || w <= 0 || P < C || P % 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (overlap == 0 && (shift == 0 || shift == WS / 2))
    return launch<0>(qkv, table, out, b, h, w, C, P, nh, shift, scale, s);
  if (overlap == 4 && shift == 0)
    return launch<4>(qkv, table, out, b, h, w, C, P, nh, shift, scale, s);
  return (int)cudaErrorInvalidValue;
}

// DAT's split windows: qkv (B, h, w, 3P) bf16, table (945, nh) fp32
// (each head's column indexed in its own geometry), out (B, h, w, P)
// bf16, C real channels a part of pitch P as above; heads [0, nh / 2) in
// wh x ww = 8 x 32 windows rolled by (sy, sx), the rest in 32 x 8
// windows rolled by (sx, sy); h and w multiples of 32; nh even; head dim
// even and at most 32; (sy, sx) (0, 0) or (4, 16).
extern "C" int w2x_hat_attention_rect(const void* qkv, const void* table,
                                      void* out, int b, int h, int w, int C,
                                      int P, int nh, int wh, int ww, int sy,
                                      int sx, float scale, void* stream) {
  using namespace w2x::hat;
  if (nh <= 0 || nh % 2 || C % nh || (C / nh) % 2 || C / nh > HDP ||
      wh != NQ / RECT_WW || ww != RECT_WW || h % RECT_WW || w % RECT_WW ||
      h <= 0 || w <= 0 || P < C || P % 2)
    return (int)cudaErrorInvalidValue;
  if (!((sy == 0 && sx == 0) || (sy == wh / 2 && sx == ww / 2)))
    return (int)cudaErrorInvalidValue;
  return launch_rect(qkv, table, out, b, h, w, C, P, nh, sy, sx, scale,
                     static_cast<cudaStream_t>(stream));
}

// Registers a thread and resident CTAs an SM of the kernel for overlap
// 0 or 4 (with its dynamic shared memory).
extern "C" int w2x_hat_attention_info(int overlap, int* regs,
                                      int* ctas_per_sm) {
  using namespace w2x::hat;
  const void* kernel = overlap ? (const void*)hat_attention_kernel<4>
                               : (const void*)hat_attention_kernel<0>;
  const int smem = overlap ? Geo<WS, 4>::SMEM : Geo<WS, 0>::SMEM;
  int err = set_smem_limit(kernel, smem);
  if (err) return err;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return (int)e;
  *regs = attr.numRegs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, kernel, THREADS, smem);
}
