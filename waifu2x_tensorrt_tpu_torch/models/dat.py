"""DAT: the Dual Aggregation Transformer for super-resolution, x4.

The port's module of Chen et al., "Dual Aggregation Transformer for Image
Super-Resolution" (ICCV 2023, arXiv:2308.03364; zhengchen1999/DAT
``basicsr/archs/dat_arch.py``, class ``DAT``, with the x4 settings of
``options/Test/test_DAT_x4.yml`` and the pixel-shuffle upsampler). The
JAX package has no DAT; the benchmark's plain reference
(``benchmark_torch/reference/dat.py``) is what the CPU tests hold it to.

With x an (B, H, W, 3) tile batch in [0, 1] (NHWC at the boundaries), H
and W multiples of ``TILE_DIVISOR`` (DAT pads to whole 32-px windows; the
port takes whole windows and pads nothing):

- ``f0 = conv_first(x - mean)`` (3x3, 3 -> C), ``t = LN(f0)``
  (``before_RG.1``);
- per residual group ``layers.i``: ``t = t + conv3x3(blocks(t))``, six
  DATBs ``blocks.j``;
- ``f = conv_after_body(LN(t)) + f0`` (``norm``); the upsampler:
  LeakyReLU 0.01 of a 3x3 conv C -> NUM_FEAT, twice a 3x3 conv NUM_FEAT ->
  4 NUM_FEAT and a pixel shuffle by 2, ``conv_last`` (NUM_FEAT -> 3);
- the output ``y + mean``, unclamped (kernel C saturates).

DATB j: ``x = x + attn(LN1(x))``, ``x = x + SGFN(LN2(x))``; ``attn`` is
the spatial block (DSTB) for even j, the channel block (DCTB) for odd j.

DSTB, on n: ``qkv = Linear(n)``; heads [0, nh/2) attend within 8-row x
32-column windows, the rest within 32 x 8 (kernel G, ``split``), with
each branch's relative bias from its DynamicPosBias MLP (``attns.{0,1}.
pos``, computed once at load into the fp32 ``table``), shifted by half
the window on the blocks of ``shifted``; ``cx = GELU(BN(dwconv3x3(v)))``
on the unshifted v; the adaptive interaction: ``out = proj(a
sigmoid(cm) + cx sigmoid(sm))``, ``cm`` the channel map of mean_hw(cx),
``sm`` the spatial map of a.

DCTB, on n: ``qkv = Linear(n)``; per head the d x d attention of q and k
L2-normalised over the tile's tokens, times the head's temperature,
softmax, applied to v (kernel J); cx as above; ``out = proj(a sigmoid(sm)
+ cx sigmoid(cm))``, now ``cm`` of mean_hw(a) and ``sm`` of cx.

Channel map: 1x1 C -> C/8, BN, GELU, 1x1 C/8 -> C; spatial map: 1x1 C ->
C/16, BN, GELU, 1x1 C/16 -> 1 (the 1x1 convs are ``nn.Linear`` here).
SGFN, on m: ``h = GELU(fc1(m))`` (C -> e C, e the expansion factor,
``fc1`` split in its two halves at load, so that h1 and h2 are maps of
their own), ``out = fc2(h1 dwconv3x3(LN(h2)))`` (``sg.norm``,
``sg.conv``).

Each BatchNorm is held in its inference form, ``FoldedBatchNorm``: the
affine ``weight`` and ``bias`` that ``convert.dat_from_torch`` folds from
the published running statistics; the program folds it further into the
conv or 1x1 layer before it when it casts that layer's operands.
LayerNorm and BatchNorm eps 1e-5, exact-erf GELU, LeakyReLU 0.01.

Every residual sum that feeds a LayerNorm is left pending and formed by
kernel I at that LayerNorm (``ops/hat_norm.add_norm``), as in
``models/hat.py``: a DATB's SGFN output at the next block's LN1, ``x +
attn`` at LN2, a group's ``x + conv3x3(...)`` at the next group's first
LN1 or at the final LN. A forward of the published widths runs 74 such
passes: 2 norms alone (``before_RG.1`` and the first LN1) and 72 adds.
Only a group's last ``x + SGFN`` and ``conv_after_body(...) + f0`` stay
torch adds; ``sg.norm`` (over e C / 2 = 360 channels, wider than kernel
I's rows) is torch's LayerNorm.

Only the widths a checkpoint can carry (``embed_dim``, ``depths``,
``num_heads``, ``expansion``) are arguments; the split size, ``NUM_FEAT``
and scale 4 are the published ones, the module constants
below (kernel G is built for the 8 x 32 / 32 x 8 split). Module and
parameter names are those of DAT's own state dict (``convert.
dat_mapping``). Layers run through ``models/layers.py``. Kernels G and J
are bf16 only: in float32 (the CPU tests) the attention is their plain
twins.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from waifu2x_tensorrt_tpu_torch.models.layers import (
    cached,
    conv,
    layer_norm,
    linear,
    pixel_shuffle,
    weights,
)
from waifu2x_tensorrt_tpu_torch.ops.channel_attention import (
    channel_attention,
)
from waifu2x_tensorrt_tpu_torch.ops.hat_attention import (
    RECT,
    hat_attention,
    table_rows,
)
from waifu2x_tensorrt_tpu_torch.ops.hat_norm import add_norm

# test_DAT_x4.yml
SCALE = 4
MEAN = (0.4488, 0.4371, 0.4040)
SPLIT = RECT           # split_size [8, 32]
EXPANSION = 4          # expansion_factor
NUM_FEAT = 64
TILE_DIVISOR = max(SPLIT)


def shifted(i: int, j: int) -> bool:
    """Does block j of group i shift its windows? DAT's rule (the spatial
    blocks 2, 6, ... of even groups, 0, 4, ... of odd ones)."""
    return ((i % 2 == 0 and j > 0 and (j - 2) % 4 == 0)
            or (i % 2 == 1 and j % 4 == 0))


def _add_norm(x, r, norm: nn.LayerNorm):
    """(x + r, LN(x + r)) by kernel I; r None: (x, LN(x))."""
    w, b = weights(norm, x.dtype)
    return add_norm(x, r, w, b, norm.eps)


class FoldedBatchNorm(nn.Module):
    """A BatchNorm2d in inference form: y = weight x + bias per channel
    (weight = gamma / sqrt(var + eps), bias = beta - mean weight)."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))


def _folded(owner: nn.Sequential, k: int, dtype: torch.dtype):
    """(weight, bias) in ``dtype`` of ``owner[k]`` (a conv or a linear)
    followed by the FoldedBatchNorm ``owner[k + 1]``, folded once and kept
    on ``owner``."""
    def build():
        layer, bn = owner[k], owner[k + 1]
        s = bn.weight.reshape(-1, *[1] * (layer.weight.dim() - 1))
        w = (layer.weight * s).to(dtype)
        if w.dim() == 4:
            w = w.contiguous(memory_format=torch.channels_last)
        return w, (layer.bias * bn.weight + bn.bias).to(dtype)

    return cached(owner, dtype, build)


def _dwconv(dim: int, device=None) -> nn.Sequential:
    return nn.Sequential(
        nn.Conv2d(dim, dim, 3, padding=1, groups=dim, device=device),
        FoldedBatchNorm(dim, device=device), nn.GELU())


def _interactions(dim: int, device=None):
    channel = nn.Sequential(
        nn.AdaptiveAvgPool2d(1), nn.Linear(dim, dim // 8, device=device),
        FoldedBatchNorm(dim // 8, device=device), nn.GELU(),
        nn.Linear(dim // 8, dim, device=device))
    spatial = nn.Sequential(
        nn.Linear(dim, dim // 16, device=device),
        FoldedBatchNorm(dim // 16, device=device), nn.GELU(),
        nn.Linear(dim // 16, 1, device=device))
    return channel, spatial


class _AIM(nn.Module):
    """The convolution branch and the adaptive interaction shared by both
    attention blocks: qkv, proj, the depthwise conv on v and the two
    interaction maps."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim, device=device)
        self.proj = nn.Linear(dim, dim, device=device)
        self.dwconv = _dwconv(dim, device=device)
        self.channel_interaction, self.spatial_interaction = _interactions(
            dim, device=device)

    def conv_branch(self, qkv):
        """GELU(BN(dwconv3x3(v))) of the unshifted v."""
        v = qkv[..., 2 * qkv.shape[-1] // 3:]
        return F.gelu(conv(v, self.dwconv[0],
                           operands=_folded(self.dwconv, 0, v.dtype)))

    def channel_map(self, z):
        """(B, C) channel weights (before the sigmoid) of mean_hw(z)."""
        ci = self.channel_interaction
        y = z.mean(dim=(1, 2))
        y = F.gelu(F.linear(y, *_folded(ci, 1, y.dtype)))
        return linear(y, ci[4])

    def spatial_map(self, z):
        """(B, H, W, 1) pixel weights (before the sigmoid) of z."""
        si = self.spatial_interaction
        y = F.gelu(F.linear(z, *_folded(si, 0, z.dtype)))
        return linear(y, si[3])


class _DynamicPosBias(nn.Module):
    """DAT's DynamicPosBias (residual=False): an MLP from a relative
    offset (dy, dx) to a bias a head."""

    def __init__(self, dim: int, num_heads: int, device=None):
        super().__init__()
        pd = dim // 4
        self.pos_proj = nn.Linear(2, pd, device=device)

        def stage(out):
            return nn.Sequential(nn.LayerNorm(pd, eps=1e-5, device=device),
                                 nn.ReLU(), nn.Linear(pd, out, device=device))

        self.pos1, self.pos2 = stage(pd), stage(pd)
        self.pos3 = stage(num_heads)

    def table(self, wh: int, ww: int) -> torch.Tensor:
        """The ((2 wh - 1)(2 ww - 1), heads) fp32 bias of every offset,
        dy-major (DAT's ``rpe_biases``)."""
        p = self.pos_proj.weight
        dy = torch.arange(1 - wh, wh, device=p.device)
        dx = torch.arange(1 - ww, ww, device=p.device)
        off = torch.stack(torch.meshgrid(dy, dx, indexing="ij")).flatten(1)
        x = F.linear(off.t().float(), p, self.pos_proj.bias)
        for seq in (self.pos1, self.pos2, self.pos3):
            norm, lin = seq[0], seq[2]
            x = F.linear(F.relu(F.layer_norm(x, norm.normalized_shape,
                                              norm.weight, norm.bias,
                                              norm.eps)),
                         lin.weight, lin.bias)
        return x


class _Branch(nn.Module):
    """One of DAT's ``Spatial_Attention`` branches: its position MLP."""

    def __init__(self, dim: int, num_heads: int, device=None):
        super().__init__()
        self.pos = _DynamicPosBias(dim // 4, num_heads, device=device)


def _refresh_table(module, incompatible_keys=None):
    module.refresh_table()


class SpatialAttention(_AIM):
    """DSTB attention (DAT's ``Adaptive_Spatial_Attention``)."""

    def __init__(self, dim: int, num_heads: int, shift: bool, device=None):
        super().__init__(dim, device=device)
        if num_heads % 2:
            raise ValueError(f"{num_heads} heads: the two branches take "
                             "half each")
        self.num_heads = num_heads
        self.shift = ((SPLIT[0] // 2, SPLIT[1] // 2) if shift else (0, 0))
        self.attns = nn.ModuleList(_Branch(dim // 2, num_heads // 2,
                                           device=device) for _ in range(2))
        self.register_buffer("table", torch.empty(
            table_rows(SPLIT, 0), num_heads, device=device),
            persistent=False)
        self.refresh_table()
        # the table depends on the weights alone: made at load
        self.register_load_state_dict_post_hook(_refresh_table)

    @torch.no_grad()
    def refresh_table(self) -> None:
        """The (945, nh) fp32 kernel-G table: columns [0, nh/2) branch 0's
        in 8 x 32 windows, the rest branch 1's in 32 x 8."""
        (wh, ww), a = SPLIT, self.attns
        self.table.copy_(torch.cat([a[0].pos.table(wh, ww),
                                    a[1].pos.table(ww, wh)], dim=1))

    def forward(self, n):
        qkv = linear(n, self.qkv)
        a = hat_attention(qkv, self.table, num_heads=self.num_heads,
                          window=SPLIT, shift=self.shift, split=True)
        cx = self.conv_branch(qkv)
        cm = torch.sigmoid(self.channel_map(cx))[:, None, None, :]
        y = a * cm + cx * torch.sigmoid(self.spatial_map(a))
        return linear(y, self.proj)


class ChannelAttention(_AIM):
    """DCTB attention (DAT's ``Adaptive_Channel_Attention``)."""

    def __init__(self, dim: int, num_heads: int, device=None):
        super().__init__(dim, device=device)
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1,
                                                   device=device))

    def forward(self, n):
        qkv = linear(n, self.qkv)
        a = channel_attention(qkv, self.temperature.reshape(-1),
                              num_heads=self.num_heads)
        cx = self.conv_branch(qkv)
        cm = torch.sigmoid(self.channel_map(a))[:, None, None, :]
        y = a * torch.sigmoid(self.spatial_map(cx)) + cx * cm
        return linear(y, self.proj)


class _SpatialGate(nn.Module):
    def __init__(self, dim: int, device=None):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5, device=device)
        self.conv = nn.Conv2d(dim, dim, 3, padding=1, groups=dim,
                              device=device)


class SGFN(nn.Module):
    """The spatial-gate feed-forward network."""

    def __init__(self, dim: int, hidden: int, device=None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden, device=device)
        self.sg = _SpatialGate(hidden // 2, device=device)
        self.fc2 = nn.Linear(hidden // 2, dim, device=device)

    def forward(self, m):
        def halves():
            w, b = self.fc1.weight, self.fc1.bias
            half = w.shape[0] // 2
            return (w[:half].to(m.dtype), b[:half].to(m.dtype),
                    w[half:].to(m.dtype), b[half:].to(m.dtype))

        w1, b1, w2, b2 = cached(self.fc1, m.dtype, halves)
        h1 = F.gelu(F.linear(m, w1, b1))
        h2 = F.gelu(F.linear(m, w2, b2))
        g = conv(layer_norm(h2, self.sg.norm), self.sg.conv)
        return linear(h1 * g, self.fc2)


class DATB(nn.Module):
    """Dual aggregation block: spatial (even j) or channel (odd j)
    attention, then the SGFN."""

    def __init__(self, dim: int, num_heads: int, expansion: int, i: int,
                 j: int, device=None):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5, device=device)
        self.attn = (SpatialAttention(dim, num_heads, shifted(i, j),
                                      device=device) if j % 2 == 0
                     else ChannelAttention(dim, num_heads, device=device))
        self.norm2 = nn.LayerNorm(dim, eps=1e-5, device=device)
        self.ffn = SGFN(dim, dim * expansion, device=device)

    def forward(self, x, r=None):
        """The block on x + r; returns x + r, the stream after the
        attention and the SGFN output, the term still to add."""
        x, n = _add_norm(x, r, self.norm1)
        t, n = _add_norm(x, self.attn(n), self.norm2)
        return x, t, self.ffn(n)


class ResidualGroup(nn.Module):
    def __init__(self, dim: int, depth: int, num_heads: int,
                 expansion: int, i: int, device=None):
        super().__init__()
        self.blocks = nn.ModuleList(DATB(dim, num_heads, expansion, i, j,
                                         device=device)
                                    for j in range(depth))
        self.conv = nn.Conv2d(dim, dim, 3, padding=1, device=device)

    def forward(self, x, r=None):
        """The group on x + r; returns x + r and the conv, whose sum is
        the group's output."""
        first, *rest = self.blocks
        x, t, m = first(x, r)
        for blk in rest:
            _, t, m = blk(t, m)
        return x, conv(t + m, self.conv)


class DAT(nn.Module):
    """DAT with the pixel-shuffle upsampler; output is input * SCALE
    (offset 0). ``dtype`` is the compute dtype (bfloat16 for the CLI's
    fp16; float32 runs only where kernels G and J are not needed: the
    CPU and the meta device). The published widths are the defaults."""

    def __init__(self, dtype: torch.dtype = torch.float32, *,
                 embed_dim: int = 180, depths: tuple = (6,) * 6,
                 num_heads: int = 6, expansion: int = EXPANSION,
                 device=None):
        super().__init__()
        c, nf = embed_dim, NUM_FEAT
        if c % num_heads or num_heads % 2 or c // 32 < 1:
            raise ValueError(f"embed_dim {c}, {num_heads} heads: an even "
                             "number of heads that divides a width of 32 "
                             "or more")
        if not depths or min(depths) < 1:
            raise ValueError(f"depths {tuple(depths)}: every group holds "
                             f"a block")
        self.scale = SCALE
        self.dtype = dtype
        self.embed_dim = c
        self.depths = tuple(depths)
        self.num_heads = num_heads
        self.expansion = expansion
        kw = {"device": device}
        self.conv_first = nn.Conv2d(3, c, 3, padding=1, **kw)
        self.before_RG = nn.Sequential(nn.Identity(),
                                       nn.LayerNorm(c, eps=1e-5, **kw))
        self.layers = nn.ModuleList(
            ResidualGroup(c, d, num_heads, expansion, i, **kw)
            for i, d in enumerate(self.depths))
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
        if h % TILE_DIVISOR or w % TILE_DIVISOR:
            raise ValueError(f"tile {h}x{w}: DAT takes multiples of "
                             f"{TILE_DIVISOR}")
        x = (x.float() - self.mean).to(dt)
        f0 = conv(x, self.conv_first)
        t, r = _add_norm(f0, None, self.before_RG[1])[1], None
        for layer in self.layers:
            t, r = layer(t, r)
        f = conv(_add_norm(t, r, self.norm)[1], self.conv_after_body) + f0
        u = F.leaky_relu(conv(f, self.conv_before_upsample[0]), 0.01)
        for i in range(0, len(self.upsample), 2):
            u = pixel_shuffle(conv(u, self.upsample[i]), 2)
        y = conv(u, self.conv_last)
        # contiguous: kernel C reads tiles by address
        return (y.float() + self.mean).to(dt).contiguous()
