"""SwinUNet: shifted-window-attention U-Net for 1x/2x/4x upscaling.

The port of ``waifu2x_tensorrt_tpu.models.swin_unet`` as torch
``nn.Module``s: conv stem at full resolution, Swin stages at 1/2 and 1/4
resolution (window 8, head dim 32, shifted windows on odd blocks, relative
position bias), a pixel-shuffle decoder with skips and a sub-pixel head.
Output size is exactly ``input * scale``: the model edge-pads to a
multiple of 32 and crops after decoding.

Layout: NHWC at every public boundary, as in the JAX package — tile
batches (B, H, W, 3), window tokens (BW, 64, C). Layers run through
``models/layers.py`` (GEMM and conv weights in the compute dtype, cast
once); LayerNorms, the biases of kernel B and the bias tables are fp32.
Each ``SwinBlock`` keeps kernel B's operands in the same cache.

``fused_block=True`` runs each Swin block through kernel B
(``ops/swin_block.py``) on the activation itself; otherwise the block is
the dense math with window attention through kernel A
(``ops/window_attention.py``). On CPU tensors both kernels' wrappers run
their plain twins.

``packed_x_head=True`` (scale > 1) ends in kernel D
(``ops/head_pack.py``): the clamped depth-to-space writes the packed-x16
layout (B, rH, rW/16, 48), whose bytes are those of the pixel output.
``SwinUNet.packed_x_twin()`` gives that head over the same parameters.

Parameter names are the left column of ``models/convert.swin_mapping``.
"""

from __future__ import annotations

import copy
import functools

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from waifu2x_tensorrt_tpu_torch.models.layers import (
    cached,
    conv,
    layer_norm,
    linear,
    pixel_shuffle,
)
from waifu2x_tensorrt_tpu_torch.ops.head_pack import PACK_X, pack_head_x16
from waifu2x_tensorrt_tpu_torch.ops.swin_block import (
    BlockOperands,
    block_operands,
    flags_tensor,
    swin_block_bhwc,
    window_merge,
    window_split,
)
from waifu2x_tensorrt_tpu_torch.ops.window_attention import (
    fused_window_attention_qkv,
)

_NEG_SLOPE = 0.1
WINDOW = 8


@functools.lru_cache(maxsize=None)
def _relative_position_index(ws: int) -> np.ndarray:
    """(ws*ws, ws*ws) index into the (2*ws-1)^2 relative-bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij"))
    coords = coords.reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int64)


@functools.lru_cache(maxsize=None)
def _relative_index_tensor(ws: int, device: torch.device):
    """``_relative_position_index`` on ``device``, uploaded once (so a
    captured graph reads no host memory)."""
    return torch.from_numpy(_relative_position_index(ws).reshape(-1)).to(
        device)


def _bias_from_table(table, nh: int, ws: int = WINDOW):
    """(nh, N, N) fp32 relative-position bias gathered from the table."""
    n = ws * ws
    bias = table[_relative_index_tensor(ws, table.device)].reshape(n, n, nh)
    return bias.permute(2, 0, 1).float().contiguous()


class WindowAttention(nn.Module):
    """Multi-head self-attention within (shifted) windows + relative bias;
    the attention core is kernel A."""

    def __init__(self, dim: int, num_heads: int, shift: int = 0,
                 window: int = WINDOW, *, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.shift = shift
        self.window = window
        self.qkv = nn.Linear(dim, 3 * dim, device=device)
        self.proj = nn.Linear(dim, dim, device=device)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads, device=device))

    def forward(self, x):
        b, h, w, c = x.shape
        ws = self.window
        if self.shift:
            x = torch.roll(x, (-self.shift, -self.shift), dims=(1, 2))
        xw = window_split(x, ws)
        nw, n = xw.shape[1], xw.shape[2]
        qkv = linear(xw, self.qkv)
        out = fused_window_attention_qkv(
            qkv.reshape(b * nw, n, 3 * c).contiguous(),
            _bias_from_table(self.relative_position_bias_table,
                             self.num_heads, ws),
            flags_tensor(b, h // ws, w // ws, x.device),
            num_heads=self.num_heads, shift=self.shift, ws=ws,
        ).reshape(b, nw, n, c)
        out = window_merge(linear(out, self.proj), h, w, ws)
        if self.shift:
            out = torch.roll(out, (self.shift, self.shift), dims=(1, 2))
        return out


class SwinBlock(nn.Module):
    """Pre-norm transformer block: W-MSA/SW-MSA + 2x-expansion GELU MLP.

    With ``fused_block`` the whole block is kernel B on the (B, H, W, C)
    activation: the kernel addresses each window's tokens through the
    cyclic roll and the window partition itself (the roll commutes with
    the pointwise LayerNorms, so rolling the raw input first equals the
    dense path's LN-then-roll)."""

    def __init__(self, dim: int, num_heads: int, shift: int = 0,
                 mlp_ratio: int = 2, fused_block: bool = False, *,
                 device=None):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.shift = shift
        self.fused_block = fused_block
        self.norm1 = nn.LayerNorm(dim, eps=1e-5, device=device)
        self.attn = WindowAttention(dim, num_heads, shift=shift,
                                    device=device)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5, device=device)
        self.mlp_fc1 = nn.Linear(dim, dim * mlp_ratio, device=device)
        self.mlp_fc2 = nn.Linear(dim * mlp_ratio, dim, device=device)

    def kernel_params(self) -> dict:
        """The block's parameters in the JAX layout (GEMM kernels as
        (in, out) views, fp32)."""
        return {
            "n1_scale": self.norm1.weight, "n1_bias": self.norm1.bias,
            "qkv_kernel": self.attn.qkv.weight.t(),
            "qkv_bias": self.attn.qkv.bias,
            "proj_kernel": self.attn.proj.weight.t(),
            "proj_bias": self.attn.proj.bias,
            "n2_scale": self.norm2.weight, "n2_bias": self.norm2.bias,
            "fc1_kernel": self.mlp_fc1.weight.t(),
            "fc1_bias": self.mlp_fc1.bias,
            "fc2_kernel": self.mlp_fc2.weight.t(),
            "fc2_bias": self.mlp_fc2.bias,
        }

    def operands(self, dtype: torch.dtype) -> BlockOperands:
        """Kernel B's operands for ``dtype`` on the parameters' device,
        kept until a parameter changes or moves (``layers.cached``)."""
        return cached(self, dtype, lambda: block_operands(
            self.kernel_params(),
            _bias_from_table(self.attn.relative_position_bias_table,
                             self.num_heads), dtype))

    def forward(self, x):
        if self.fused_block:
            return self._fused(x)
        dt = x.dtype
        y = layer_norm(x.float(), self.norm1).to(dt)
        x = x + self.attn(y)
        y = layer_norm(x.float(), self.norm2).to(dt)
        y = F.gelu(linear(y, self.mlp_fc1))
        return x + linear(y, self.mlp_fc2)

    def _fused(self, x):
        return swin_block_bhwc(x, self.operands(x.dtype), shift=self.shift,
                               ws=WINDOW)


class SwinStage(nn.Module):
    """``depth`` blocks alternating no-shift / shift-by-window//2; blocks
    are named block0, block1, ... (the swin_mapping names)."""

    def __init__(self, dim: int, num_heads: int, depth: int,
                 fused_block: bool = False, *, device=None):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"block{i}", SwinBlock(
                dim, num_heads, shift=0 if i % 2 == 0 else WINDOW // 2,
                fused_block=fused_block, device=device))

    def forward(self, x):
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
        return x


class SwinUNet(nn.Module):
    """U-Net over Swin stages; output is input*scale exactly (offset 0).

    ``dtype`` is the compute dtype (bfloat16 for the CLI's fp16, float32
    for tf32); inputs are cast to it. With ``packed_x_head`` (set on the
    twin that ``packed_x_twin`` returns) the output is (B, rH, rW/16, 48)
    from kernel D (clamp fused), and width * scale must be a multiple of
    16."""

    def __init__(self, scale: int = 4, out_channels: int = 3,
                 base_dim: int = 96, depths: tuple = (2, 2, 6, 2, 2),
                 clamp: bool = True, fused_block: bool = False,
                 dtype: torch.dtype = torch.float32, *, device=None):
        super().__init__()
        if scale not in (1, 2, 4):
            raise ValueError(f"unsupported scale {scale}")
        c = base_dim
        half = c // 2
        self.scale = scale
        self.out_channels = out_channels
        self.base_dim = base_dim
        self.depths = tuple(depths)
        self.clamp = clamp
        self.dtype = dtype
        self.packed_x_head = False
        kw = {"device": device}
        self.patch_conv1 = nn.Conv2d(3, half, 3, padding=1, **kw)
        self.patch_conv2 = nn.Conv2d(half, half, 3, padding=1, **kw)
        self.down1 = nn.Conv2d(half, c, 2, stride=2, **kw)
        self.swin1 = SwinStage(c, c // 32, depths[0], fused_block, **kw)
        self.down2 = nn.Conv2d(c, 2 * c, 2, stride=2, **kw)
        self.swin2 = SwinStage(2 * c, (2 * c) // 32, depths[2], fused_block,
                               **kw)
        self.up2 = nn.Linear(2 * c, 4 * c, **kw)
        self.swin3 = SwinStage(c, c // 32, depths[3], fused_block, **kw)
        self.up1 = nn.Linear(c, 4 * half, **kw)
        self.to_image = nn.Conv2d(half, out_channels * scale * scale, 3,
                                  padding=1, **kw)

    def packed_x_twin(self) -> "SwinUNet":
        """This module with the packed-x head: a shallow copy whose
        parameter and submodule tables are this module's own objects, so
        the two hold one copy of the weights."""
        twin = copy.copy(self)
        twin.packed_x_head = self.scale > 1
        return twin

    def forward(self, x):
        x = x.to(self.dtype)
        b, h, w, _ = x.shape
        # internal edge pad to a multiple of 32 (two stride-2 stages x
        # window 8), cropped after decoding
        ph, pw = (-h) % 32, (-w) % 32
        r = self.scale
        if self.packed_x_head:
            if (w * r) % PACK_X or ((w + pw) * r) % PACK_X:
                raise ValueError(f"packed_x_head needs width*scale % "
                                 f"{PACK_X} == 0, got {w}x{r}")
            if not self.clamp:
                raise ValueError("packed_x_head fuses the [0,1] clamp")
        if ph or pw:
            rows = torch.arange(h + ph, device=x.device).clamp_(max=h - 1)
            cols = torch.arange(w + pw, device=x.device).clamp_(max=w - 1)
            x = x[:, rows][:, :, cols]

        s = F.leaky_relu(conv(x, self.patch_conv1), _NEG_SLOPE)
        s = F.leaky_relu(conv(s, self.patch_conv2), _NEG_SLOPE)
        e1 = self.swin1(conv(s, self.down1))
        e2 = self.swin2(conv(e1, self.down2))

        d2 = pixel_shuffle(linear(e2, self.up2), 2) + e1
        d2 = self.swin3(d2)
        d1 = pixel_shuffle(linear(d2, self.up1), 2) + s

        # clamp before the depth-to-space (it commutes with the shuffle)
        z = conv(d1, self.to_image)
        if self.packed_x_head:  # kernel D: clamp + shuffle + pack-x16
            z = pack_head_x16(z.contiguous(), r=r)
            return (z[:, :h * r, :(w * r) // PACK_X].contiguous() if ph or pw
                    else z)
        if self.clamp:
            z = torch.clamp(z, 0.0, 1.0)
        if self.scale > 1:
            z = pixel_shuffle(z, self.scale)
        if ph or pw:
            # contiguous: finalize (kernel C) reads tiles by address
            z = z[:, :h * self.scale, :w * self.scale].contiguous()
        return z
