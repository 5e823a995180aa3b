"""HAT: the Hybrid Attention Transformer for super-resolution, SRx4.

The port's module of Chen et al., "Activating More Pixels in Image
Super-Resolution Transformer" (arXiv:2205.04437; XPixelGroup/HAT
``hat/archs/hat_arch.py``, class ``HAT``, with the pixel-shuffle
upsampler). The JAX package has no HAT; the benchmark's plain reference
(``benchmark_torch/reference/hat.py``) is what the CPU tests hold it to.

With x an (B, H, W, 3) tile batch in [0, 1] (NHWC at the boundaries, as
``models/swin_unet.py``), H and W multiples of the window:

- ``x = x - mean`` (HAT's img_range is 1), ``f0 = conv_first(x)``
  (3x3, 3 -> C),
  ``t = LN(f0)`` (``patch_embed.norm``);
- per residual hybrid attention group (RHAG, ``layers.i``):
  ``t = conv3x3(group(t)) + t``, where ``group`` is ``depth`` HABs and one
  OCAB;
- ``f = conv_after_body(LN(t)) + f0``; the upsampler: LeakyReLU 0.01 of a
  3x3 conv C -> NUM_FEAT, then twice a 3x3 conv NUM_FEAT -> 4 NUM_FEAT
  and a pixel shuffle by 2, then ``conv_last`` (NUM_FEAT -> 3);
- the output ``y + mean``, unclamped (kernel C saturates).

HAB (block j of a group; shift 0 for even j, WINDOW / 2 for odd):
``n = LN1(x)``; the channel-attention branch on n unshifted,
``c = CA(conv3x3(GELU(conv3x3(n))))`` (C -> C / COMPRESS -> C) with
``CA(z) = z sigmoid(W2 ReLU(W1 mean_hw(z)))`` (C -> C / SQUEEZE -> C),
pooled over the whole tile; the window attention branch
``a = proj(W-MSA(n))`` over shifted windows (kernel G, self geometry);
``x = x + a + CONV_SCALE c``; ``x = x + MLP(LN2(x))`` (erf GELU).
OCAB: ``x = x + proj(OCA(LN1(x)))`` (kernel G, overlapping geometry),
``x = x + MLP(LN2(x))``.

Every residual sum that feeds a LayerNorm is left pending, as the pair
(stream, term), and formed by kernel I (``ops/hat_norm.add_norm``) at that
LayerNorm, which writes the sum and its norm in one pass: a HAB's MLP
output at the next block's LN1, ``x + a + CONV_SCALE c`` at LN2 (the
scaled add), OCAB's ``x + proj(...)`` at its LN2, and a group's ``x +
conv3x3(...)`` at the next group's first LN1 or at the final LN. Only
OCAB's last ``x + MLP`` and ``conv_after_body(...) + f0`` stay torch
adds. A chunk of the published widths runs 86 such passes: 2 norms alone
(``patch_embed.norm`` and the first LN1), 48 adds and 36 scaled adds.

Only the widths a checkpoint can carry (``embed_dim``, ``depths``,
``num_heads``) are arguments; every other setting is the published one,
the module constants below (kernel G is built for window 16 and overlap 4
alone). Module and parameter names are those of HAT's own state dict (so
a HAT checkpoint converts by name, ``models/convert.hat_mapping``); the
channel-attention 1x1 convolutions are ``nn.Linear`` here.

Layers run through ``models/layers.py``: GEMM and conv weights, biases
and LayerNorm parameters in the compute dtype, cast once; the
relative-position tables stay fp32. Kernel G is bf16 only: in float32
(the CPU tests) the attention is its plain twin.

The trunk's C-wide maps (every map between ``conv_first`` and
``conv_before_upsample``, and each of q, k and v) are carried at the row
pitch P = ``layers.pitch(C)`` (192 for the published 180: 16-byte bf16
rows in whole 64-value steps, for the library's Hopper GEMMs and convs),
their pad channels zero: each layer that reads or writes them gets
operands padded to P (``pad=(P, out, inp)``), kernels G and I read and
write rows of pitch P and take the C real channels. The CAB's C / 3
inner map and the MLP's 2C hidden map keep their widths. A forward on
the meta device (the FLOP count) runs at P = C.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from waifu2x_tensorrt_tpu_torch.models.layers import (
    conv,
    linear,
    pitch,
    pixel_shuffle,
    weights,
)
from waifu2x_tensorrt_tpu_torch.ops.hat_attention import (
    WINDOW,
    hat_attention,
    table_rows,
)
from waifu2x_tensorrt_tpu_torch.ops.hat_norm import add_norm

# HAT_SRx4_ImageNet-pretrain.yml
SCALE = 4
MEAN = (0.4488, 0.4371, 0.4040)
OVERLAP = 4        # overlap_ratio 0.5: 24 x 24 key windows, 4 px a side
COMPRESS = 3       # compress_ratio
SQUEEZE = 30       # squeeze_factor
CONV_SCALE = 0.01
MLP_RATIO = 2
NUM_FEAT = 64


def _add_norm(x, r, norm: nn.LayerNorm, **scaled):
    """(x + r, LN(x + r)) by kernel I over the C channels of ``norm``, x
    of any pitch, r None: (x, LN(x)); ``scaled``: its z and s."""
    w, b = weights(norm, x.dtype)
    return add_norm(x, r, w, b, norm.eps, **scaled)


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, device=None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden, device=device)
        self.fc2 = nn.Linear(hidden, dim, device=device)

    def forward(self, x):
        """On a trunk map x (its pitch x's last axis)."""
        p = x.shape[-1]
        return linear(F.gelu(linear(x, self.fc1, pad=(p, 0, 1))), self.fc2,
                      pad=(p, 1, 0))


class _Attention(nn.Module):
    """HAT's ``WindowAttention``: qkv, proj and the (2 ws - 1)^2 table."""

    def __init__(self, dim: int, num_heads: int, device=None):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim, device=device)
        self.proj = nn.Linear(dim, dim, device=device)
        self.relative_position_bias_table = nn.Parameter(torch.zeros(
            table_rows(WINDOW, 0), num_heads, device=device))


class _ChannelAttention(nn.Module):
    def __init__(self, dim: int, device=None):
        super().__init__()
        self.attention = nn.Sequential(
            nn.AdaptiveAvgPool2d(1),
            nn.Linear(dim, dim // SQUEEZE, device=device), nn.ReLU(),
            nn.Linear(dim // SQUEEZE, dim, device=device), nn.Sigmoid())


class _CAB(nn.Module):
    def __init__(self, dim: int, device=None):
        super().__init__()
        self.cab = nn.Sequential(
            nn.Conv2d(dim, dim // COMPRESS, 3, padding=1, device=device),
            nn.GELU(),
            nn.Conv2d(dim // COMPRESS, dim, 3, padding=1, device=device),
            _ChannelAttention(dim, device=device))


class HAB(nn.Module):
    """Hybrid attention block: shifted-window self-attention beside the
    channel-attention convolutions, then the MLP."""

    def __init__(self, dim: int, num_heads: int, shift: int, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.shift = shift
        self.norm1 = nn.LayerNorm(dim, eps=1e-5, device=device)
        self.attn = _Attention(dim, num_heads, device=device)
        self.conv_block = _CAB(dim, device=device)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5, device=device)
        self.mlp = _Mlp(dim, dim * MLP_RATIO, device=device)

    def forward(self, x, r=None):
        """The block on x + r; returns x + r, the stream after the
        attention branches and the MLP output, the term still to add."""
        x, n = _add_norm(x, r, self.norm1)
        p, c = x.shape[-1], self.norm1.normalized_shape[0]
        cab = self.conv_block.cab
        z = conv(F.gelu(conv(n, cab[0], pad=(p, 0, 1))), cab[2],
                 pad=(p, 1, 0))
        ca = cab[3].attention
        w = z.mean(dim=(1, 2))
        w = torch.sigmoid(linear(F.relu(linear(w, ca[1], pad=(p, 0, 1))),
                                 ca[3], pad=(p, 1, 0)))
        a = hat_attention(
            linear(n, self.attn.qkv, pad=(p, 3, 1)),
            self.attn.relative_position_bias_table,
            num_heads=self.num_heads, shift=self.shift, channels=c)
        # x + a + CONV_SCALE CA(z) and LN2 in one pass over the map: the
        # scale rides on the per-image channel weights
        t, n = _add_norm(x, linear(a, self.attn.proj, pad=(p, 1, 1)),
                         self.norm2, z=z, s=w * CONV_SCALE)
        return x, t, self.mlp(n)


class OCAB(nn.Module):
    """Overlapping cross-attention block: window queries against the
    wider zero-padded window around them, then the MLP."""

    def __init__(self, dim: int, num_heads: int, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.norm1 = nn.LayerNorm(dim, eps=1e-5, device=device)
        self.qkv = nn.Linear(dim, 3 * dim, device=device)
        self.relative_position_bias_table = nn.Parameter(torch.zeros(
            table_rows(WINDOW, OVERLAP), num_heads, device=device))
        self.proj = nn.Linear(dim, dim, device=device)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5, device=device)
        self.mlp = _Mlp(dim, dim * MLP_RATIO, device=device)

    def forward(self, x, r):
        """The block on x + r."""
        x, n = _add_norm(x, r, self.norm1)
        p = x.shape[-1]
        a = hat_attention(linear(n, self.qkv, pad=(p, 3, 1)),
                          self.relative_position_bias_table,
                          num_heads=self.num_heads, overlap=OVERLAP,
                          channels=self.norm1.normalized_shape[0])
        x, n = _add_norm(x, linear(a, self.proj, pad=(p, 1, 1)), self.norm2)
        return x + self.mlp(n)


class _Group(nn.Module):
    def __init__(self, blocks, overlap_attn):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.overlap_attn = overlap_attn


class RHAG(nn.Module):
    """Residual hybrid attention group: HABs and an OCAB, a 3x3 conv and
    the group's residual."""

    def __init__(self, dim: int, depth: int, num_heads: int, device=None):
        super().__init__()
        self.residual_group = _Group(
            [HAB(dim, num_heads, 0 if j % 2 == 0 else WINDOW // 2,
                 device=device) for j in range(depth)],
            OCAB(dim, num_heads, device=device))
        self.conv = nn.Conv2d(dim, dim, 3, padding=1, device=device)

    def forward(self, x, r=None):
        """The group on x + r; returns x + r and the conv, whose sum is
        the group's output."""
        first, *rest = self.residual_group.blocks
        x, t, m = first(x, r)
        for blk in rest:
            _, t, m = blk(t, m)
        t = self.residual_group.overlap_attn(t, m)
        return x, conv(t, self.conv, pad=(t.shape[-1], 1, 1))


class _PatchEmbed(nn.Module):
    def __init__(self, dim: int, device=None):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5, device=device)


class HAT(nn.Module):
    """HAT with the pixel-shuffle upsampler; output is input * SCALE
    (offset 0). ``dtype`` is the compute dtype (bfloat16 for the CLI's
    fp16; float32 runs only where kernel G is not needed: the CPU and
    the meta device). The published widths are the defaults."""

    def __init__(self, dtype: torch.dtype = torch.float32, *,
                 embed_dim: int = 180, depths: tuple = (6,) * 6,
                 num_heads: int = 6, device=None):
        super().__init__()
        c, nf = embed_dim, NUM_FEAT
        if c % num_heads:
            raise ValueError(f"embed_dim {c} is not a multiple of "
                             f"{num_heads} heads")
        if not depths or min(depths) < 1:
            raise ValueError(f"depths {tuple(depths)}: every group holds "
                             f"a HAB")
        self.scale = SCALE
        self.dtype = dtype
        self.embed_dim = c
        self.depths = tuple(depths)
        self.num_heads = num_heads
        kw = {"device": device}
        self.conv_first = nn.Conv2d(3, c, 3, padding=1, **kw)
        self.patch_embed = _PatchEmbed(c, **kw)
        self.layers = nn.ModuleList(RHAG(c, d, num_heads, **kw)
                                    for d in self.depths)
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
        h, w = x.shape[1], x.shape[2]
        if h % WINDOW or w % WINDOW:
            raise ValueError(f"tile {h}x{w}: HAT takes multiples of the "
                             f"window {WINDOW}")
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
