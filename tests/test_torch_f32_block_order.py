"""Kernel B's fp32 kernel (``swin_block_f32_kernel``, ``ops/csrc/
swin_block.cu``) and the fp32 attention core of kernels A, B and E
(``ops/csrc/attention_f32.cuh``), replayed in torch in the kernels'
decomposition and sum order, against the JAX package's Pallas kernels in
interpret mode, fp32, atol 1e-4 (the fp32 Swin-stage rule of
``tests/test_pallas_ops.py``).

The block's replay reads the kernel's constants (windows a CTA, hidden
chunk widths, K-tile rows, stage size) from the source, stages the weight
tiles the kernel stages, in its order (each weight value exactly once),
and computes from the staged tiles only: per head q, k and v (every sum
over K ascending, one FMA at a time), the attention core, proj summed
over heads into one accumulator, x1, LayerNorm 2, and the MLP in hidden
chunks summed into fc2's accumulator. The attention core starts the
scores from the bias and sums d ascending, reduces a row's max and sum
over a lane's 8 columns and then across its 8 lanes, divides once, and
sums p v over tokens ascending. A LayerNorm sums a lane's columns and
then across 8 lanes. An FMA is exact up to its one rounding (the product
of two fp32 values is exact in fp64). The lane maps and the persistent
unit walk of A and E are checked to cover every entry once.

Test code only: nothing on the main path calls the replay.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waifu2x_tensorrt_tpu.ops.swin_block import (
    fused_swin_block as jax_fused_block,
)
from waifu2x_tensorrt_tpu.ops.window_attention import (
    fused_window_attention as jax_fused_heads,
    fused_window_attention_qkv as jax_fused_qkv,
)
import waifu2x_tensorrt_tpu_torch.ops as ops_pkg
from waifu2x_tensorrt_tpu_torch.ops.kernel_math import gelu, keep_mask

CSRC = Path(ops_pkg.__file__).parent / "csrc"
N, HD = 64, 32


def _constant(name, source="swin_block.cu"):
    """An integer constant of a kernel source, so the replay follows it."""
    src = (CSRC / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _widths():
    src = (CSRC / "swin_block.cu").read_text()
    body = re.search(r"constexpr int kWidths\[\] = \{([^}]*)\};", src)
    return [int(w) for w in body.group(1).split(",")]


def _ktile(k, n, stage):
    """F32Layout's ktile: the largest multiple of 16 dividing k with
    k_tile x n <= stage."""
    best, kt = 16, 16
    while kt <= k and kt * n <= stage:
        if k % kt == 0:
            best = kt
        kt += 16
    return best


def _layout(c):
    """F32Layout<C> from the source's constants."""
    kind = "PAIR" if c <= _constant("F32_PAIR_C") else "SINGLE"
    wpc = 2 if kind == "PAIR" else 1
    tw = _constant("F32_TW")
    qn = 3 * HD  # q, k and v of a head in one product
    hc = _constant(f"F32_HC_{kind}")
    stage = _constant("F32_STAGE_ROWS") * max(c, 3 * HD)
    lay = dict(wpc=wpc, tw=tw, warps=tw // 32, rows_w=N // (tw // 32),
               cg=_constant("F32_CG"), qn=qn, hc=hc, stage=stage,
               kq=_ktile(c, qn, stage), kf=_ktile(c, hc, stage),
               kp=_constant("F32_KP"))
    lay["rg"] = tw // lay["cg"]
    lay["tm"] = N // lay["rg"]
    return lay


def _tiles(c, lay):
    """WeightStreamF32::load's tiles in order: (matrix, K rows, columns)."""
    nh, kq, kf, kp, hc = c // HD, lay["kq"], lay["kf"], lay["kp"], lay["hc"]
    out = []
    for h in range(nh):
        for part0 in range(0, 3, lay["qn"] // HD):
            parts = range(part0, part0 + lay["qn"] // HD)
            cols = np.concatenate([np.arange(HD) + p * c + h * HD
                                   for p in parts])
            for k0 in range(0, c, kq):
                out.append(("qkv_kernel", np.arange(k0, k0 + kq), cols))
        for k0 in range(0, HD, kp):
            out.append(("proj_kernel", h * HD + np.arange(k0, k0 + kp),
                        np.arange(c)))
    for j in range(2 * c // hc):
        for k0 in range(0, c, kf):
            out.append(("fc1_kernel", np.arange(k0, k0 + kf),
                        j * hc + np.arange(hc)))
        for k0 in range(0, hc, kp):
            out.append(("fc2_kernel", j * hc + np.arange(k0, k0 + kp),
                        np.arange(c)))
    return out


def _fma(a, b, c):
    """fmaf(a, b, c) of fp32 tensors: the exact product, one rounding
    (through fp64)."""
    return (a.double() * b.double() + c.double()).float()


def _product(acc, a, w):
    """acc += a @ w, k ascending, one FMA at a time (a: (..., K), w: (K,
    n))."""
    for k in range(a.shape[-1]):
        acc = _fma(a[..., k:k + 1], w[k], acc)
    return acc


def _lane_sum(parts):
    """Sum of 8 lane partials (..., 8) by the shuffles xor 1, 2, 4."""
    idx = torch.arange(8)
    for m in (1, 2, 4):
        parts = parts + parts[..., idx ^ m]
    return parts[..., 0]


def _layernorm(v, scale, bias):
    """layernorm_rows: lane cg holds columns 4 cg + 32 s + e; it sums them
    (s, then e), the 8 lanes reduce by shuffles; two passes, eps 1e-5."""
    c = v.shape[-1]
    cols = v.reshape(*v.shape[:-1], c // 32, 8, 4)  # [s][cg][e]
    part = torch.zeros(v.shape[:-1] + (8,))
    for s in range(c // 32):
        for e in range(4):
            part = part + cols[..., s, :, e]
    mean = (_lane_sum(part) / c)[..., None]
    d = (cols - mean[..., None, None])
    part = torch.zeros(v.shape[:-1] + (8,))
    for s in range(c // 32):
        for e in range(4):
            part = _fma(d[..., s, :, e], d[..., s, :, e], part)
    inv = 1.0 / torch.sqrt(_lane_sum(part) / c + 1e-5)
    return _fma((v - mean) * inv[..., None], scale, bias)


def _attention(q, k, v, bias, keep):
    """attn_f32::head_attention for one head of every window: q, k, v (BW,
    64, 32), bias (64, 64), keep (BW, 64, 64) bool or None."""
    scale = torch.tensor(HD ** -0.5, dtype=torch.float32)
    s = bias.expand(q.shape[0], N, N).clone()
    if keep is not None:
        s = torch.where(keep, s, torch.tensor(float("-inf")))
    qs = q * scale
    for d in range(HD):
        s = _fma(qs[..., d:d + 1], k[:, None, :, d], s)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    # lane cg holds columns cg + 8 jj and sums them jj ascending
    lanes = e.reshape(*e.shape[:-1], 8, 8)  # [jj][cg]
    part = torch.zeros(e.shape[:-1] + (8,))
    for jj in range(8):
        part = part + lanes[..., jj, :]
    p = e / _lane_sum(part)[..., None]
    o = torch.zeros(q.shape)
    for j in range(N):
        o = _fma(p[..., j:j + 1], v[:, None, j], o)
    return o


def _block_replay(x, params, bias, flags, nh, shift):
    """swin_block_f32_kernel, from the staged tiles, in its sum order."""
    c = x.shape[-1]
    lay = _layout(c)
    tiles = iter(_tiles(c, lay))

    def stage():
        name, rows, cols = next(tiles)
        w = params[name][rows][:, cols]
        assert w.numel() <= lay["stage"]
        return rows, w

    keep = keep_mask(flags, 8, shift)
    h = _layernorm(x, params["n1_scale"], params["n1_bias"])
    pacc = torch.zeros_like(x)
    for head in range(nh):
        qkv = []
        for _part0 in range(0, 3, lay["qn"] // HD):
            z = torch.zeros(x.shape[:-1] + (lay["qn"],))
            for _ in range(c // lay["kq"]):
                rows, w = stage()
                z = _product(z, h[..., rows], w)
            qkv += list(z.split(HD, dim=-1))
        qkv = [t + params["qkv_bias"][p * c + head * HD:
                                      p * c + (head + 1) * HD]
               for p, t in enumerate(qkv)]
        o = _attention(*qkv, bias[head], keep)
        for _ in range(HD // lay["kp"]):
            rows, w = stage()
            pacc = _product(pacc, o[..., rows - head * HD], w)
    x1 = x + (pacc + params["proj_bias"])
    m = _layernorm(x1, params["n2_scale"], params["n2_bias"])
    oacc = torch.zeros_like(x)
    hc = lay["hc"]
    for j in range(2 * c // hc):
        z = torch.zeros(x.shape[:-1] + (hc,))
        for _ in range(c // lay["kf"]):
            rows, w = stage()
            z = _product(z, m[..., rows], w)
        g = gelu(z + params["fc1_bias"][j * hc:(j + 1) * hc])
        for _ in range(hc // lay["kp"]):
            rows, w = stage()
            oacc = _product(oacc, g[..., rows - j * hc], w)
    assert next(tiles, None) is None  # every staged tile was consumed
    return x1 + (oacc + params["fc2_bias"])


def _block_inputs(c, nh, bw, flag, seed):
    rng = np.random.default_rng(seed)

    def r(*shape, loc=0.0, scale=0.05):
        return rng.normal(loc, scale, shape).astype(np.float32)

    params = {
        "n1_scale": r(c, loc=1, scale=0.1), "n1_bias": r(c, scale=0.1),
        "qkv_kernel": r(c, 3 * c), "qkv_bias": r(3 * c),
        "proj_kernel": r(c, c), "proj_bias": r(c),
        "n2_scale": r(c, loc=1, scale=0.1), "n2_bias": r(c, scale=0.1),
        "fc1_kernel": r(c, 2 * c), "fc1_bias": r(2 * c),
        "fc2_kernel": r(2 * c, c), "fc2_bias": r(c),
    }
    bias = r(nh, N, N, scale=0.2)
    flags = np.full(bw, flag, np.int32)
    x = r(bw, N, c, scale=1.0)
    return x, params, bias, flags


@pytest.mark.parametrize("flag", range(4))
@pytest.mark.parametrize("shift", [0, 4])
@pytest.mark.parametrize("c", [64, 96, 192])
def test_block_replay_matches_pallas_interpret(c, shift, flag):
    """The fp32 block kernel's decomposition against the JAX kernel, BW 3
    (a ragged pair of windows a CTA at C <= 96)."""
    nh = c // HD
    x, params, bias, flags = _block_inputs(c, nh, 3, flag, c + shift + flag)
    want = np.array(jax_fused_block(
        jnp.array(x), {k: jnp.array(v) for k, v in params.items()},
        jnp.array(bias), jnp.array(flags), num_heads=nh, shift=shift,
        interpret=True))
    got = _block_replay(
        torch.tensor(x), {k: torch.tensor(v) for k, v in params.items()},
        torch.tensor(bias), torch.tensor(flags), nh, shift).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("c", _widths())
def test_weight_tiles_stage_each_weight_once(c):
    """At every C of the dispatch: the tiles stage every weight value
    exactly once, each within a stage, and the shared memory of
    F32_MIN_CTAS CTAs fits an SM."""
    lay = _layout(c)
    seen = {"qkv_kernel": np.zeros((c, 3 * c), int),
            "proj_kernel": np.zeros((c, c), int),
            "fc1_kernel": np.zeros((c, 2 * c), int),
            "fc2_kernel": np.zeros((2 * c, c), int)}
    for name, rows, cols in _tiles(c, lay):
        assert len(rows) * len(cols) <= lay["stage"]
        seen[name][np.ix_(rows, cols)] += 1
    for name, count in seen.items():
        assert (count == 1).all(), name
    pad = re.search(r"constexpr int LDQK = HD \+ (\d+);",
                    (CSRC / "attention_f32.cuh").read_text()).group(1)
    qkv_space = N * (2 * (HD + int(pad)) + HD)
    assert N * (lay["hc"] + 4) <= qkv_space  # the GELU rows fit
    smem = 4 * (2 * lay["stage"] + lay["wpc"] * (N * c + qkv_space))
    assert _constant("F32_MIN_CTAS") * (smem + 1024) <= 228 * 1024
    rr = _constant("F32_RR_PAIR" if lay["wpc"] == 2 else "F32_RR_SINGLE")
    assert lay["rg"] * lay["tm"] == N and lay["rows_w"] % (4 * rr) == 0


def _lanes_of_warp(r0, rr):
    """(rows, score columns, output columns) of each lane of one
    head_attention<RR> call on rows r0..r0+4RR-1."""
    lane = np.arange(32)
    rg, cg = lane >> 3, lane & 7
    rows = r0 + rg[:, None] + 4 * np.arange(rr)
    scols = cg[:, None] + 8 * np.arange(8)
    ocols = 4 * cg[:, None] + np.arange(4)
    return rows, scols, ocols


@pytest.mark.parametrize("source,name", [
    ("window_attention.cu", "F32_RR"), ("swin_block.cu", "F32_RR_PAIR"),
    ("swin_block.cu", "F32_RR_SINGLE")])
def test_attention_lanes_cover_each_entry_once(source, name):
    """The 4 warps of a window (16 rows a warp: kernels A and E, and B),
    in calls of 4 RR rows (RR from the source), own every score entry
    and every output value of the 64 x 64 and 64 x 32 tiles exactly
    once."""
    rows_w = N // 4
    rr = _constant(name, source)
    scores = np.zeros((N, N), int)
    outs = np.zeros((N, HD), int)
    for warp in range(N // rows_w):
        for call in range(rows_w // (4 * rr)):
            rows, scols, ocols = _lanes_of_warp(warp * rows_w + 4 * rr * call,
                                                rr)
            for ln in range(32):
                scores[np.ix_(rows[ln], scols[ln])] += 1
                outs[np.ix_(rows[ln], ocols[ln])] += 1
    assert (scores == 1).all() and (outs == 1).all()


@pytest.mark.parametrize("bw,nh,ctas", [(1, 3, 528), (37, 6, 528),
                                        (4096, 3, 528), (200, 5, 264)])
def test_unit_walk_covers_each_unit_once(bw, nh, ctas):
    """The persistent grid of A and E: grid = min(units, resident CTAs
    rounded down to a multiple of nh); CTA b takes head b % nh of windows
    b / nh, b / nh + grid / nh, ...: every (window, head) unit once."""
    units, most = bw * nh, ctas - ctas % nh
    grid = min(units, most)
    seen = np.zeros((bw, nh), int)
    for b in range(grid):
        for w in range(b // nh, bw, grid // nh):
            seen[w, b % nh] += 1
    assert (seen == 1).all()


def _attention_inputs(bw, nh, flag, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(0, 1, (bw, N, 3 * nh * HD)).astype(np.float32)
    bias = rng.normal(0, 0.2, (nh, N, N)).astype(np.float32)
    return qkv, bias, np.full(bw, flag, np.int32)


@pytest.mark.parametrize("flag", range(4))
@pytest.mark.parametrize("shift", [0, 4])
@pytest.mark.parametrize("layout", ["qkv", "heads"])
def test_attention_replay_matches_pallas_interpret(layout, shift, flag):
    """The fp32 attention core, head by head, against the JAX kernels A
    (packed qkv) and E (unpacked heads) at C 96, BW 5."""
    nh, bw = 3, 5
    qkv, bias, flags = _attention_inputs(bw, nh, flag, 10 * shift + flag)
    c = nh * HD
    heads = [qkv[..., p * c:(p + 1) * c].reshape(bw, N, nh, HD)
             .transpose(0, 2, 1, 3) for p in range(3)]
    if layout == "qkv":
        want = np.array(jax_fused_qkv(jnp.array(qkv), jnp.array(bias),
                                      jnp.array(flags), num_heads=nh,
                                      shift=shift, interpret=True))
        want = want.reshape(bw, N, nh, HD).transpose(0, 2, 1, 3)
    else:
        want = np.array(jax_fused_heads(
            *(jnp.array(np.ascontiguousarray(t)) for t in heads),
            jnp.array(bias), jnp.array(flags), shift=shift, interpret=True))
    keep = keep_mask(torch.tensor(flags), 8, shift)
    got = np.stack([_attention(
        *(torch.tensor(np.ascontiguousarray(t[:, h])) for t in heads),
        torch.tensor(bias[h]), keep).numpy() for h in range(nh)], axis=1)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
