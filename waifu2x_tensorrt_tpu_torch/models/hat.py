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

Only the widths a checkpoint can carry (``embed_dim``, ``depths``,
``num_heads``) are arguments; every other setting is the published one,
the module constants below (kernel G is built for window 16 and overlap 4
alone). Module and parameter names are those of HAT's own state dict (so
a HAT checkpoint converts by name, ``models/convert.hat_mapping``); the
channel-attention 1x1 convolutions are ``nn.Linear`` here.

Parameters are float32 as loaded. Each forward takes the GEMM and conv
weights, LayerNorm parameters and biases cast to its compute dtype from
``HAT.operands(dtype)``, built once a dtype and kept until a parameter
changes or moves; relative-position tables stay fp32. Kernel G is bf16
only: in float32 (the CPU tests) the attention is its plain twin.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from waifu2x_tensorrt_tpu_torch.ops.hat_attention import (
    WINDOW,
    hat_attention,
    table_rows,
)

# HAT_SRx4_ImageNet-pretrain.yml
SCALE = 4
MEAN = (0.4488, 0.4371, 0.4040)
OVERLAP = 4        # overlap_ratio 0.5: 24 x 24 key windows, 4 px a side
COMPRESS = 3       # compress_ratio
SQUEEZE = 30       # squeeze_factor
CONV_SCALE = 0.01
MLP_RATIO = 2
NUM_FEAT = 64


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, device=None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden, device=device)
        self.fc2 = nn.Linear(hidden, dim, device=device)


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

    def forward(self, x, ops: dict, name: str):
        n = _norm(x, ops, f"{name}.norm1")
        cab = f"{name}.conv_block.cab"
        z = _conv(F.gelu(_conv(n, ops, f"{cab}.0")), ops, f"{cab}.2")
        ca = f"{cab}.3.attention"
        w = z.mean(dim=(1, 2))
        w = torch.sigmoid(_linear(F.relu(_linear(w, ops, f"{ca}.1")), ops,
                                  f"{ca}.3"))
        a = hat_attention(
            _linear(n, ops, f"{name}.attn.qkv"),
            self.attn.relative_position_bias_table,
            num_heads=self.num_heads, shift=self.shift)
        # x + a + CONV_SCALE CA(z) in one pass over the map: the scale
        # rides on the per-image channel weights
        x = torch.addcmul(x + _linear(a, ops, f"{name}.attn.proj"), z,
                          (w * CONV_SCALE)[:, None, None, :])
        return x + _mlp(_norm(x, ops, f"{name}.norm2"), ops, f"{name}.mlp")


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

    def forward(self, x, ops: dict, name: str):
        a = hat_attention(
            _linear(_norm(x, ops, f"{name}.norm1"), ops, f"{name}.qkv"),
            self.relative_position_bias_table, num_heads=self.num_heads,
            overlap=OVERLAP)
        x = x + _linear(a, ops, f"{name}.proj")
        return x + _mlp(_norm(x, ops, f"{name}.norm2"), ops, f"{name}.mlp")


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

    def forward(self, x, ops: dict, name: str):
        g = f"{name}.residual_group"
        t = x
        for j, blk in enumerate(self.residual_group.blocks):
            t = blk(t, ops, f"{g}.blocks.{j}")
        t = self.residual_group.overlap_attn(t, ops, f"{g}.overlap_attn")
        return _conv(t, ops, f"{name}.conv") + x


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
        self._operands = {}  # dtype -> (stamp, {name: tensor})

    def operands(self, dtype: torch.dtype) -> dict:
        """Every weight and bias, and the LayerNorm parameters, in
        ``dtype`` (conv weights channels_last), by parameter name; the
        relative-position tables are not among them. Built at the first
        call and kept until a parameter changes or moves: the cache is
        stamped with the device and each parameter's storage and version
        counter, which ``load_state_dict`` bumps as it copies in place."""
        params = dict(self.named_parameters())
        stamp = (self.mean.device,
                 tuple((p.data_ptr(), p._version) for p in params.values()))
        hit = self._operands.get(dtype)
        if hit is not None and hit[0] == stamp:
            return hit[1]
        ops = {}
        with torch.inference_mode(False), torch.no_grad():
            for name, p in params.items():
                if name.endswith("relative_position_bias_table"):
                    continue
                t = p.to(dtype)
                ops[name] = (t.contiguous(memory_format=torch.channels_last)
                             if t.dim() == 4 else t.contiguous())
        self._operands[dtype] = (stamp, ops)
        return ops

    def forward(self, x):
        dt = self.dtype
        h, w = x.shape[1], x.shape[2]
        if h % WINDOW or w % WINDOW:
            raise ValueError(f"tile {h}x{w}: HAT takes multiples of the "
                             f"window {WINDOW}")
        ops = self.operands(dt)
        x = (x.float() - self.mean).to(dt)
        f0 = _conv(x, ops, "conv_first")
        t = _norm(f0, ops, "patch_embed.norm")
        for i, layer in enumerate(self.layers):
            t = layer(t, ops, f"layers.{i}")
        f = _conv(_norm(t, ops, "norm"), ops, "conv_after_body") + f0
        u = F.leaky_relu(_conv(f, ops, "conv_before_upsample.0"), 0.01)
        for i in range(0, len(self.upsample), 2):
            u = _pixel_shuffle(_conv(u, ops, f"upsample.{i}"), 2)
        y = _conv(u, ops, "conv_last")
        # contiguous: kernel C reads tiles by address
        return (y.float() + self.mean).to(dt).contiguous()


def _conv(x, ops: dict, name: str):
    """3x3 'same' NHWC conv through a channels_last NCHW view."""
    y = F.conv2d(x.permute(0, 3, 1, 2), ops[f"{name}.weight"],
                 ops[f"{name}.bias"], padding=1)
    return y.permute(0, 2, 3, 1)


def _linear(x, ops: dict, name: str):
    return F.linear(x, ops[f"{name}.weight"], ops[f"{name}.bias"])


def _norm(x, ops: dict, name: str):
    return F.layer_norm(x, (x.shape[-1],), ops[f"{name}.weight"],
                        ops[f"{name}.bias"], 1e-5)


def _mlp(x, ops: dict, name: str):
    return _linear(F.gelu(_linear(x, ops, f"{name}.fc1")), ops,
                   f"{name}.fc2")


def _pixel_shuffle(x, r: int):
    """Depth-to-space (B, H, W, C r r) -> (B, H r, W r, C), channel order
    (C, r, r) as torch.nn.PixelShuffle."""
    b, h, w, crr = x.shape
    c = crr // (r * r)
    x = x.reshape(b, h, w, c, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * r, w * r, c)
