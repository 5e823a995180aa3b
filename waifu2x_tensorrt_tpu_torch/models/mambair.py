"""MambaIR: the state-space image restorer, classic SR x4.

The port's module of Guo et al., "MambaIR: A Simple Baseline for Image
Restoration with State-Space Model" (ECCV 2024, arXiv:2402.15648;
csguoh/MambaIR ``basicsr/archs/mambair_arch.py``, class ``MambaIR``, with
the settings of ``options/test/test_MambaIR_SR_x4.yml`` and the
pixel-shuffle upsampler). The JAX package has no MambaIR; the benchmark's
plain reference (``benchmark_torch/reference/mambair.py``) is what the
CPU tests hold it to.

With x an (B, H, W, 3) tile batch in [0, 1] (NHWC at the boundaries), of
any H and W (MambaIR has no window: the scan runs over the whole tile):

- ``f0 = conv_first(x - mean)`` (3x3, 3 -> C), ``t = LN(f0)``
  (``patch_embed.norm``);
- per residual group ``layers.i``: ``t = t + conv3x3(blocks(t))``, six
  VSSBlocks ``residual_group.blocks.j``;
- ``f = conv_after_body(LN(t)) + f0`` (``norm``); the upsampler:
  LeakyReLU 0.01 of a 3x3 conv C -> NUM_FEAT, twice a 3x3 conv NUM_FEAT ->
  4 NUM_FEAT and a pixel shuffle by 2, ``conv_last`` (NUM_FEAT -> 3);
- the output ``y + mean``, unclamped (kernel C saturates).

VSSBlock, on x: ``x = x skip_scale + SS2D(ln_1(x))``, ``x = x skip_scale2
+ CAB(ln_2(x))``, the CAB HAT's (``models/hat._CAB``: 3x3 conv C -> C /
3, GELU, 3x3 conv back, times the sigmoid gate of its pooled map, C ->
C / 30 -> C).

SS2D, on n: ``[x | z] = in_proj(n)`` (C -> 2D, no bias; held as its two
halves), ``u = SiLU(dwconv3x3(x))`` (D channels, bias), ``x_dbl =
x_proj(u)`` (the four directions' D -> R + 2N maps as one GEMM, D -> 4
(R + 2N)), ``y = scan(u, x_dbl)`` (kernel K, ``ops/selective_scan``: the
four-direction selective scan over the whole tile, with ``dt_projs``,
``A = -exp(A_logs)`` and ``Ds``), ``out = out_proj(LN_D(y) SiLU(z))`` (D
-> C, no bias; ``out_norm``; kernel K applies the LayerNorm and the gate
to its fp32 sum y, the gated map is what it writes). LayerNorm eps 1e-5,
exact-erf GELU,
LeakyReLU 0.01, SiLU x sigmoid(x).

Every residual sum that feeds a LayerNorm is left pending and formed by
kernel I at that LayerNorm (``ops/hat_norm.add_norm``), as in
``models/hat.py``: ``x skip_scale + SS2D(...)`` at ln_2 (kernel I's
skip), ``x skip_scale2 + z w[b]`` at the next block's ln_1 (its skip
gate, the CAB's map z and gate w), a group's ``x + conv3x3(...)`` at the
next group's first ln_1 or at the final LN. A forward of the published
widths runs 74 such passes: 2 norms alone (``patch_embed.norm`` and the
first ln_1), 6 adds, 36 skips and 30 skip gates. Only a group's last
block output (``torch.addcmul``) and ``conv_after_body(...) + f0`` stay
torch ops; ``out_norm`` (over D = 2C = 360 channels) is kernel K's.

Only the widths a checkpoint can carry (``embed_dim``, ``depths``,
``d_state``, ``expand``) are arguments; ``dt_rank`` is the published
``ceil(C / 16)``, the CAB ratios, ``NUM_FEAT`` and scale 4 the module
constants. Module and parameter names are those of MambaIR's own state
dict (``convert.mambair_mapping``). Layers run through
``models/layers.py``; the scan's fp32 tables (the dt projections, A and
D) are made once, with the layers' operands. Kernel K is bf16 only (R 12,
N 16): in float32 and on the CPU the scan is its plain twin.

As in ``models/hat.py``, the trunk's C-wide maps are carried at the row
pitch P = ``layers.pitch(C)`` (192 for the published 180), their pad
channels zero; the D-wide maps of SS2D (360, whole 16-byte rows) keep
their width. A forward on the meta device (the FLOP count) runs at P = C
and leaves the scan out (``counts/mambair`` counts it).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from waifu2x_tensorrt_tpu_torch.models.hat import _CAB
from waifu2x_tensorrt_tpu_torch.models.layers import (
    cached,
    conv,
    linear,
    pitch,
    pixel_shuffle,
    weights,
    widen,
)
from waifu2x_tensorrt_tpu_torch.ops.hat_norm import add_norm
from waifu2x_tensorrt_tpu_torch.ops.selective_scan import selective_scan

# test_MambaIR_SR_x4.yml
SCALE = 4
MEAN = (0.4488, 0.4371, 0.4040)
D_STATE = 16
EXPAND = 2          # mlp_ratio, SS2D's expand
D_CONV = 3
NUM_FEAT = 64
DIRECTIONS = 4


def dt_rank(dim: int) -> int:
    """SS2D's ``dt_rank="auto"``: ceil(C / 16)."""
    return math.ceil(dim / 16)


def _add_norm(x, r, norm: nn.LayerNorm, **kw):
    """(sum, LN(sum)) by kernel I over the C channels of ``norm``, x of
    any pitch; ``kw``: its z, s and k."""
    w, b = weights(norm, x.dtype)
    return add_norm(x, r, w, b, norm.eps, **kw)


class SS2D(nn.Module):
    """The 2D selective-scan module: in_proj, the depthwise conv, x_proj,
    the four-direction scan, out_norm, the SiLU gate and out_proj."""

    def __init__(self, dim: int, d_state: int = D_STATE,
                 expand: int = EXPAND, device=None):
        super().__init__()
        d, r = expand * dim, dt_rank(dim)
        self.d_inner, self.dt_rank, self.d_state = d, r, d_state
        kw = {"device": device}
        self.in_proj = nn.Linear(dim, 2 * d, bias=False, **kw)
        self.conv2d = nn.Conv2d(d, d, D_CONV, padding=(D_CONV - 1) // 2,
                                groups=d, **kw)
        self.x_proj_weight = nn.Parameter(torch.zeros(
            DIRECTIONS, r + 2 * d_state, d, **kw))
        self.dt_projs_weight = nn.Parameter(torch.zeros(DIRECTIONS, d, r,
                                                        **kw))
        self.dt_projs_bias = nn.Parameter(torch.zeros(DIRECTIONS, d, **kw))
        self.A_logs = nn.Parameter(torch.zeros(DIRECTIONS * d, d_state,
                                               **kw))
        self.Ds = nn.Parameter(torch.ones(DIRECTIONS * d, **kw))
        self.out_norm = nn.LayerNorm(d, eps=1e-5, **kw)
        self.out_proj = nn.Linear(d, dim, bias=False, **kw)

    def prepared(self, dtype, p: int):
        """The in_proj halves (x, z) at input pitch p and the stacked
        x_proj in ``dtype``; the scan's fp32 tables (dt weights and bias,
        A = -exp(A_logs), D), each (4, D, ...), and out_norm's weight and
        bias in fp32 (kernel K's gate)."""
        def build():
            w = widen(self.in_proj.weight, 1, 1, p).to(dtype)
            d, n = self.d_inner, self.d_state
            return (w[:d], w[d:],
                    self.x_proj_weight.reshape(-1, d).to(dtype),
                    (self.dt_projs_weight.float().contiguous(),
                     self.dt_projs_bias.float().contiguous(),
                     -torch.exp(self.A_logs.float()).reshape(
                         DIRECTIONS, d, n),
                     self.Ds.float().reshape(DIRECTIONS, d)),
                    (self.out_norm.weight.float(),
                     self.out_norm.bias.float()))

        return cached(self, (dtype, p), build)

    def forward(self, n):
        """On the trunk map n (its pitch n's last axis)."""
        p = n.shape[-1]
        wx, wz, wxp, tables, norm = self.prepared(n.dtype, p)
        u = F.silu(conv(F.linear(n, wx), self.conv2d))
        g = selective_scan(u, F.linear(u, wxp), *tables,
                           (F.linear(n, wz), *norm, self.out_norm.eps))
        return linear(g, self.out_proj, pad=(p, 1, 0))


class VSSBlock(nn.Module):
    """MambaIR's visual state-space block: SS2D, then HAT's CAB, each on a
    skip-scaled residual."""

    def __init__(self, dim: int, d_state: int = D_STATE,
                 expand: int = EXPAND, device=None):
        super().__init__()
        self.ln_1 = nn.LayerNorm(dim, eps=1e-5, device=device)
        self.self_attention = SS2D(dim, d_state, expand, device=device)
        self.skip_scale = nn.Parameter(torch.ones(dim, device=device))
        self.conv_blk = _CAB(dim, device=device)
        self.ln_2 = nn.LayerNorm(dim, eps=1e-5, device=device)
        self.skip_scale2 = nn.Parameter(torch.ones(dim, device=device))

    def scales(self, dtype, p: int):
        """(skip_scale, skip_scale2) in ``dtype``, C wide (kernel I's k),
        and skip_scale2 at pitch p, its pad zero (for the torch ops)."""
        def build():
            k, k2 = self.skip_scale.to(dtype), self.skip_scale2.to(dtype)
            return k, k2, F.pad(k2, (0, p - k2.shape[0]))

        return cached(self, (dtype, "scales", p), build)

    def forward(self, x, n):
        """The block on x, n = ln_1(x): returns t = x skip_scale + SS2D(n)
        and the CAB's z and gate w of ln_2(t); the block's output t
        skip_scale2 + z w[b] is still to form."""
        k = self.scales(x.dtype, x.shape[-1])[0]
        t, n = _add_norm(x, self.self_attention(n), self.ln_2, k=k)
        return (t, *self.conv_blk.gate(n))

    def output(self, t, z, w):
        """The block's output of ``forward``'s (t, z, w), by torch ops."""
        k2 = self.scales(t.dtype, t.shape[-1])[2]
        return torch.addcmul(t * k2, z, w[:, None, None, :])


class _Blocks(nn.Module):
    def __init__(self, blocks):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)


class ResidualGroup(nn.Module):
    """VSSBlocks, a 3x3 conv and the group's residual."""

    def __init__(self, dim: int, depth: int, d_state: int = D_STATE,
                 expand: int = EXPAND, device=None):
        super().__init__()
        self.residual_group = _Blocks(
            VSSBlock(dim, d_state, expand, device=device)
            for _ in range(depth))
        self.conv = nn.Conv2d(dim, dim, 3, padding=1, device=device)

    def forward(self, x, r=None):
        """The group on x + r; returns x + r and the conv, whose sum is
        the group's output."""
        first, *rest = self.residual_group.blocks
        x, n = _add_norm(x, r, first.ln_1)
        prev, pending = first, first(x, n)
        for blk in rest:
            t, z, w = pending
            k2 = prev.scales(t.dtype, t.shape[-1])[1]
            t, n = _add_norm(t, None, blk.ln_1, z=z, s=w, k=k2)
            prev, pending = blk, blk(t, n)
        out = prev.output(*pending)
        return x, conv(out, self.conv, pad=(out.shape[-1], 1, 1))


class _PatchEmbed(nn.Module):
    def __init__(self, dim: int, device=None):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5, device=device)


class MambaIR(nn.Module):
    """MambaIR with the pixel-shuffle upsampler; output is input * SCALE
    (offset 0). ``dtype`` is the compute dtype (bfloat16 for the CLI's
    fp16; float32 runs only where kernel K is not needed: the CPU and the
    meta device). The published widths are the defaults."""

    def __init__(self, dtype: torch.dtype = torch.float32, *,
                 embed_dim: int = 180, depths: tuple = (6,) * 6,
                 d_state: int = D_STATE, expand: int = EXPAND,
                 device=None):
        super().__init__()
        c, nf = embed_dim, NUM_FEAT
        if not depths or min(depths) < 1:
            raise ValueError(f"depths {tuple(depths)}: every group holds "
                             f"a block")
        if c % 4 or (expand * c) % 8:
            raise ValueError(f"embed_dim {c}, expand {expand}: C a "
                             f"multiple of 4 and D = expand C of 8")
        self.scale = SCALE
        self.dtype = dtype
        self.embed_dim = c
        self.depths = tuple(depths)
        self.d_state = d_state
        self.expand = expand
        kw = {"device": device}
        self.conv_first = nn.Conv2d(3, c, 3, padding=1, **kw)
        self.patch_embed = _PatchEmbed(c, **kw)
        self.layers = nn.ModuleList(
            ResidualGroup(c, d, d_state, expand, **kw) for d in self.depths)
        self.norm = nn.LayerNorm(c, eps=1e-5, **kw)
        self.conv_after_body = nn.Conv2d(c, c, 3, padding=1, **kw)
        self.conv_before_upsample = nn.Sequential(
            nn.Conv2d(c, nf, 3, padding=1, **kw), nn.LeakyReLU(0.01))
        self.upsample = nn.Sequential(
            nn.Conv2d(nf, 4 * nf, 3, padding=1, **kw), nn.PixelShuffle(2),
            nn.Conv2d(nf, 4 * nf, 3, padding=1, **kw), nn.PixelShuffle(2))
        self.conv_last = nn.Conv2d(nf, 3, 3, padding=1, **kw)
        self.register_buffer("mean", torch.tensor(MEAN, device=device),
                             persistent=False)

    def forward(self, x):
        dt = self.dtype
        x = (x.float() - self.mean).to(dt)
        p = pitch(self.embed_dim, x.device)
        f0 = conv(x, self.conv_first, pad=(p, 1, 0))
        t, r = _add_norm(f0, None, self.patch_embed.norm)[1], None
        for layer in self.layers:
            t, r = layer(t, r)
        f = conv(_add_norm(t, r, self.norm)[1], self.conv_after_body,
                 pad=(p, 1, 1)) + f0
        u = F.leaky_relu(conv(f, self.conv_before_upsample[0],
                              pad=(p, 0, 1)), 0.01)
        for i in range(0, len(self.upsample), 2):
            u = pixel_shuffle(conv(u, self.upsample[i]), 2)
        y = conv(u, self.conv_last)
        # contiguous: kernel C reads tiles by address
        return (y.float() + self.mean).to(dt).contiguous()
