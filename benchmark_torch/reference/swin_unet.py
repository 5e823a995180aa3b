"""Plain reference of the swin_unet upscaler, float32, on NHWC tiles.

The architecture as the repository defines it (its ``SwinUNet``, after
nagadomi's waifu2x ``swin_unet``): a 3x3 conv stem of base_dim/2 channels
(leaky ReLU 0.1, twice), a 2x2 stride-2 conv to base_dim, depths[0] Swin
blocks, a 2x2 stride-2 conv to 2 base_dim, depths[2] Swin blocks, a dense
layer to 4 base_dim and a pixel shuffle plus the first stage's output,
depths[3] Swin blocks, a dense layer to 2 base_dim and a pixel shuffle
plus the stem's output, a 3x3 conv to 3 scale^2 channels, a clamp to
[0, 1] and a pixel shuffle by ``scale``. Inputs are edge-padded to a
multiple of 32 and the output cropped back. A Swin block is pre-norm:
LayerNorm (eps 1e-5), windowed multi-head attention (window 8, head dim
32, scale 32^-0.5, a learned relative-position bias, cyclic shift of 4 on
odd blocks with the standard Swin region mask), a residual, LayerNorm,
a dense 2x expansion with exact erf GELU and a dense projection, a
residual.

Parameters are the flat published layout the program's weight files use:
'/'-joined paths, conv kernels (kH, kW, in, out), dense kernels
(in, out), LayerNorm ``scale`` / ``bias``, relative-position tables
((2 window - 1)^2, heads). Departure from nunif: the repository's model
is this reconstruction, and it is what the benchmark holds the program
to.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

WINDOW = 8
HEAD_DIM = 32


def offset(config: dict) -> int:
    return 0


def _blocks(config: dict):
    """(stage name, width, depth) of the three Swin stages."""
    c, d = config["base_dim"], config["depths"]
    return (("swin1", c, d[0]), ("swin2", 2 * c, d[2]), ("swin3", c, d[3]))


def param_shapes(config: dict) -> dict:
    """{path: shape} of every parameter, in the published layout."""
    c = config["base_dim"]
    half = c // 2
    s = config["scale"]
    shapes = {
        "patch_conv1/kernel": (3, 3, 3, half), "patch_conv1/bias": (half,),
        "patch_conv2/kernel": (3, 3, half, half),
        "patch_conv2/bias": (half,),
        "down1/kernel": (2, 2, half, c), "down1/bias": (c,),
        "down2/kernel": (2, 2, c, 2 * c), "down2/bias": (2 * c,),
        "up2/kernel": (2 * c, 4 * c), "up2/bias": (4 * c,),
        "up1/kernel": (c, 4 * half), "up1/bias": (4 * half,),
        "to_image/kernel": (3, 3, half, 3 * s * s),
        "to_image/bias": (3 * s * s,),
    }
    n_rel = (2 * WINDOW - 1) ** 2
    for stage, dim, depth in _blocks(config):
        for i in range(depth):
            b = f"{stage}/block{i}"
            shapes.update({
                f"{b}/norm1/scale": (dim,), f"{b}/norm1/bias": (dim,),
                f"{b}/attn/qkv/kernel": (dim, 3 * dim),
                f"{b}/attn/qkv/bias": (3 * dim,),
                f"{b}/attn/proj/kernel": (dim, dim),
                f"{b}/attn/proj/bias": (dim,),
                f"{b}/attn/relative_position_bias":
                    (n_rel, dim // HEAD_DIM),
                f"{b}/norm2/scale": (dim,), f"{b}/norm2/bias": (dim,),
                f"{b}/mlp_fc1/kernel": (dim, 2 * dim),
                f"{b}/mlp_fc1/bias": (2 * dim,),
                f"{b}/mlp_fc2/kernel": (2 * dim, dim),
                f"{b}/mlp_fc2/bias": (dim,),
            })
    return shapes


def _q(t, quant):
    return t if quant is None else quant(t)


def conv(x, p, name, quant, stride=1, padding=0):
    """NCHW conv with a (kH, kW, in, out) kernel."""
    k = p[f"{name}/kernel"].permute(3, 2, 0, 1)
    return F.conv2d(_q(x, quant), _q(k, quant), p[f"{name}/bias"],
                    stride=stride, padding=padding)


def dense(x, p, name, quant):
    return _q(x, quant) @ _q(p[f"{name}/kernel"], quant) + p[f"{name}/bias"]


def _relative_index(device):
    ys, xs = torch.meshgrid(torch.arange(WINDOW), torch.arange(WINDOW),
                            indexing="ij")
    coords = torch.stack([ys.flatten(), xs.flatten()])  # (2, 64)
    rel = coords[:, :, None] - coords[:, None, :] + (WINDOW - 1)
    return (rel[0] * (2 * WINDOW - 1) + rel[1]).to(device)  # (64, 64)


def _shift_mask(h, w, shift, device):
    """(windows, 64, 64) bool: True where two tokens of a shifted window
    came from different regions of the unrolled map (Swin's img_mask)."""
    region = torch.zeros((h, w), dtype=torch.long, device=device)
    cuts = (slice(0, -WINDOW), slice(-WINDOW, -shift), slice(-shift, None))
    n = 0
    for ys in cuts:
        for xs in cuts:
            region[ys, xs] = n
            n += 1
    r = region.reshape(h // WINDOW, WINDOW, w // WINDOW, WINDOW)
    r = r.permute(0, 2, 1, 3).reshape(-1, WINDOW * WINDOW)
    return r[:, :, None] != r[:, None, :]


def _windows(x):
    b, h, w, c = x.shape
    x = x.reshape(b, h // WINDOW, WINDOW, w // WINDOW, WINDOW, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, -1, WINDOW * WINDOW, c)


def _unwindow(x, h, w):
    b, c = x.shape[0], x.shape[-1]
    x = x.reshape(b, h // WINDOW, w // WINDOW, WINDOW, WINDOW, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def swin_block(x, p, b, shift, quant):
    """One pre-norm Swin block on (B, H, W, C)."""
    bsz, h, w, c = x.shape
    nh = c // HEAD_DIM
    y = F.layer_norm(x, (c,), p[f"{b}/norm1/scale"], p[f"{b}/norm1/bias"],
                     1e-5)
    if shift:
        y = torch.roll(y, (-shift, -shift), dims=(1, 2))
    yw = _windows(y)  # (B, nW, 64, C)
    nw = yw.shape[1]
    qkv = dense(yw, p, f"{b}/attn/qkv", quant)
    qkv = qkv.reshape(bsz, nw, 64, 3, nh, HEAD_DIM).permute(3, 0, 1, 4, 2, 5)
    q, k, v = qkv[0] * HEAD_DIM ** -0.5, qkv[1], qkv[2]  # (B, nW, nh, 64, d)
    attn = _q(q, quant) @ _q(k, quant).transpose(-1, -2)
    table = p[f"{b}/attn/relative_position_bias"]
    bias = table[_relative_index(x.device)].permute(2, 0, 1)  # (nh, 64, 64)
    attn = attn + bias
    if shift:
        mask = _shift_mask(h, w, shift, x.device)  # (nW, 64, 64)
        attn = attn.masked_fill(mask[None, :, None], float("-inf"))
    attn = attn.softmax(-1)
    o = (_q(attn, quant) @ _q(v, quant)).permute(0, 1, 3, 2, 4)
    o = dense(o.reshape(bsz, nw, 64, c), p, f"{b}/attn/proj", quant)
    o = _unwindow(o, h, w)
    if shift:
        o = torch.roll(o, (shift, shift), dims=(1, 2))
    x = x + o
    y = F.layer_norm(x, (c,), p[f"{b}/norm2/scale"], p[f"{b}/norm2/bias"],
                     1e-5)
    y = F.gelu(dense(y, p, f"{b}/mlp_fc1", quant))
    return x + dense(y, p, f"{b}/mlp_fc2", quant)


def _stage(x, p, stage, depth, quant):
    for i in range(depth):
        x = swin_block(x, p, f"{stage}/block{i}",
                       0 if i % 2 == 0 else WINDOW // 2, quant)
    return x


def forward(p: dict, tiles: torch.Tensor, config: dict, quant=None):
    """(N, h, w, 3) float32 in [0, 1] -> (N, h*s, w*s, 3) float32."""
    s = config["scale"]
    n, h, w, _ = tiles.shape
    ph, pw = (-h) % 32, (-w) % 32
    x = tiles.permute(0, 3, 1, 2)
    if ph or pw:
        x = F.pad(x, (0, pw, 0, ph), mode="replicate")
    x = F.leaky_relu(conv(x, p, "patch_conv1", quant, padding=1), 0.1)
    stem = F.leaky_relu(conv(x, p, "patch_conv2", quant, padding=1), 0.1)
    nhwc = (0, 2, 3, 1)
    e1 = conv(stem, p, "down1", quant, stride=2).permute(*nhwc)
    (_, _, d0), (_, _, d2), (_, _, d3) = _blocks(config)
    e1 = _stage(e1, p, "swin1", d0, quant)
    e2 = conv(e1.permute(0, 3, 1, 2), p, "down2", quant, stride=2)
    e2 = _stage(e2.permute(*nhwc), p, "swin2", d2, quant)
    up = dense(e2, p, "up2", quant).permute(0, 3, 1, 2)
    d = F.pixel_shuffle(up, 2).permute(*nhwc) + e1
    d = _stage(d, p, "swin3", d3, quant)
    up = dense(d, p, "up1", quant).permute(0, 3, 1, 2)
    d = F.pixel_shuffle(up, 2) + stem
    z = torch.clamp(conv(d, p, "to_image", quant, padding=1), 0.0, 1.0)
    z = F.pixel_shuffle(z, s)[:, :, :h * s, :w * s]
    return z.permute(*nhwc)
