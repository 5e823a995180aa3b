"""Plain reference of DAT (Dual Aggregation Transformer) x4, float32, on
NHWC tiles.

Written from the published architecture (Chen et al., "Dual Aggregation
Transformer for Image Super-Resolution", ICCV 2023, arXiv:2308.03364;
zhengchen1999/DAT ``basicsr/archs/dat_arch.py``, class ``DAT`` with the
pixel-shuffle upsampler):

- ``x = (x - mean) img_range``; ``f0 = conv_first(x)`` (3x3); LayerNorm
  (``before_RG``);
- residual groups: ``depth`` DATBs, a 3x3 conv, plus the group's input;
- LayerNorm, ``conv_after_body`` plus ``f0``; a 3x3 conv to ``num_feat``
  and LeakyReLU 0.01; per factor 2 a 3x3 conv to 4 num_feat and a pixel
  shuffle; ``conv_last``; ``y / img_range + mean``, not clamped.

DATB j of group i: ``x = x + attn(LN1(x))``, ``x = x + SGFN(LN2(x))``.
For even j, the spatial attention (``Adaptive_Spatial_Attention``): qkv
by one dense layer; the first half of the channels of q, k and v as
num_heads / 2 heads in split_size[0] x split_size[1] windows, the second
half in the transposed windows; on the blocks DAT shifts
(``(i % 2 == 0 and j > 0 and (j - 2) % 4 == 0) or (i % 2 == 1 and j % 4
== 0)``), each half's map rolled by minus half its window, Swin's region
mask (-100 between regions, per axis) and the roll back; per head
``softmax(q k^T d^-0.5 + B[rpi]) v``, B the branch's DynamicPosBias (an
MLP over the offsets (dy, dx), dy-major: Linear 2 -> p, twice [LN, ReLU,
Linear p -> p], [LN, ReLU, Linear p -> heads], p = (C / 2) // 4 // 4);
beside it ``cx = GELU(BN(dwconv3x3(v)))`` on the whole v; the adaptive
interaction ``proj(a sigmoid(cm) + cx sigmoid(sm))``, ``cm`` = 1x1
(C/8 -> C) of GELU(BN(1x1 (C -> C/8) of the spatial mean of cx)), ``sm``
= 1x1 (C/16 -> 1) of GELU(BN(1x1 (C -> C/16) of a)). For odd j, the
channel attention (``Adaptive_Channel_Attention``): per head, q and k
(d x N) L2-normalised along the tokens (``F.normalize``), ``A =
softmax(q k^T temperature)``, ``a = A v``; the same cx; ``proj(a
sigmoid(sm) + cx sigmoid(cm))``, now ``cm`` of the mean of a and ``sm``
of cx. SGFN: ``h = GELU(fc1(m))``, its halves h1, h2; ``fc2(h1
dwconv3x3(LN(h2)))``. LayerNorm and BatchNorm eps 1e-5, exact-erf GELU.

Parameters: the flat published layout the program's weight files use,
the names of DAT's own state dict '/'-joined: conv kernels (kH, kW, in,
out) (a depthwise conv's in is 1), dense kernels (in, out) (the
interaction maps' 1x1 convs among them), LayerNorm ``scale`` / ``bias``,
``temperature`` ((heads, 1, 1)). Departures from the published code:
- every BatchNorm is its inference form, the affine ``scale`` and
  ``bias`` (the published running statistics folded in);
- no padding inside: tiles are whole windows (multiples of 32);
- the weights are seeded (there is no checkpoint in the repository).
``quant`` rounds the operands of every product of the forward: the
convolutions (depthwise ones included), the dense layers, q k^T and p v
of the windows, the Gram matrix and A v. The position MLP depends on the
weights alone and stays float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def offset(config: dict) -> int:
    return 0


def shifted(i: int, j: int) -> bool:
    return ((i % 2 == 0 and j > 0 and (j - 2) % 4 == 0)
            or (i % 2 == 1 and j % 4 == 0))


def param_shapes(config: dict) -> dict:
    """{path: shape} of every parameter, in the published layout."""
    c, nh = config["embed_dim"], config["num_heads"]
    nf = config["num_feat"]
    hid = c * config["expansion_factor"]
    pd = (c // 2) // 4 // 4
    shapes = {}

    def conv(name, cin, cout):
        shapes[f"{name}/kernel"] = (3, 3, cin, cout)
        shapes[f"{name}/bias"] = (cout,)

    def dense(name, cin, cout):
        shapes[f"{name}/kernel"] = (cin, cout)
        shapes[f"{name}/bias"] = (cout,)

    def norm(name, width=c):  # a LayerNorm or a folded BatchNorm
        shapes[f"{name}/scale"] = (width,)
        shapes[f"{name}/bias"] = (width,)

    conv("conv_first", 3, c)
    norm("before_RG/1")
    for i, depth in enumerate(config["depths"]):
        for j in range(depth):
            b = f"layers/{i}/blocks/{j}"
            norm(f"{b}/norm1")
            dense(f"{b}/attn/qkv", c, 3 * c)
            dense(f"{b}/attn/proj", c, c)
            conv(f"{b}/attn/dwconv/0", 1, c)
            norm(f"{b}/attn/dwconv/1")
            dense(f"{b}/attn/channel_interaction/1", c, c // 8)
            norm(f"{b}/attn/channel_interaction/2", c // 8)
            dense(f"{b}/attn/channel_interaction/4", c // 8, c)
            dense(f"{b}/attn/spatial_interaction/0", c, c // 16)
            norm(f"{b}/attn/spatial_interaction/1", c // 16)
            dense(f"{b}/attn/spatial_interaction/3", c // 16, 1)
            if j % 2 == 0:
                for a in range(2):
                    p = f"{b}/attn/attns/{a}/pos"
                    dense(f"{p}/pos_proj", 2, pd)
                    for k, out in ((1, pd), (2, pd), (3, nh // 2)):
                        norm(f"{p}/pos{k}/0", pd)
                        dense(f"{p}/pos{k}/2", pd, out)
            else:
                shapes[f"{b}/attn/temperature"] = (nh, 1, 1)
            norm(f"{b}/norm2")
            dense(f"{b}/ffn/fc1", c, hid)
            norm(f"{b}/ffn/sg/norm", hid // 2)
            conv(f"{b}/ffn/sg/conv", 1, hid // 2)
            dense(f"{b}/ffn/fc2", hid // 2, c)
        conv(f"layers/{i}/conv", c, c)
    norm("norm")
    conv("conv_after_body", c, c)
    conv("conv_before_upsample/0", c, nf)
    for k in range(int(math.log2(config["scale"]))):
        conv(f"upsample/{2 * k}", nf, 4 * nf)
    conv("conv_last", nf, 3)
    return shapes


def _q(t, quant):
    return t if quant is None else quant(t)


def conv(x, p, name, quant, groups=1):
    """3x3 'same' conv of an NHWC map, NHWC out."""
    k = p[f"{name}/kernel"].permute(3, 2, 0, 1)
    y = F.conv2d(_q(x.permute(0, 3, 1, 2), quant), _q(k, quant),
                 p[f"{name}/bias"], padding=1, groups=groups)
    return y.permute(0, 2, 3, 1)


def dense(x, p, name, quant):
    return _q(x, quant) @ _q(p[f"{name}/kernel"], quant) + p[f"{name}/bias"]


def norm(x, p, name):
    return F.layer_norm(x, (x.shape[-1],), p[f"{name}/scale"],
                        p[f"{name}/bias"], 1e-5)


def batch_norm(x, p, name):
    """A BatchNorm2d in inference form, over the last axis."""
    return x * p[f"{name}/scale"] + p[f"{name}/bias"]


def pos_table(p, name, wh, ww, device):
    """DynamicPosBias of every offset, dy-major: ((2 wh - 1)(2 ww - 1),
    heads)."""
    dy = torch.arange(1 - wh, wh, device=device)
    dx = torch.arange(1 - ww, ww, device=device)
    off = torch.stack(torch.meshgrid(dy, dx, indexing="ij")).flatten(1)
    x = dense(off.t().float(), p, f"{name}/pos_proj", None)
    for k in (1, 2, 3):
        x = dense(F.relu(norm(x, p, f"{name}/pos{k}/0")), p,
                  f"{name}/pos{k}/2", None)
    return x


def rpi(wh, ww, device):
    """DAT's ``relative_position_index``: (wh ww, wh ww) indices of
    query - key offsets, (dy + wh - 1)(2 ww - 1) + dx + ww - 1."""
    coords = torch.stack(torch.meshgrid(torch.arange(wh), torch.arange(ww),
                                        indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    return ((rel[..., 0] + wh - 1) * (2 * ww - 1) + rel[..., 1]
            + ww - 1).to(device)


def region_mask(h, w, wh, ww, sh, sw, device):
    """DAT's ``calculate_mask`` of one branch: (nW, wh ww, wh ww), -100
    between tokens of different regions of the rolled map, else 0."""
    img = torch.zeros((h, w), device=device)
    n = 0
    for ys in (slice(0, -wh), slice(-wh, -sh), slice(-sh, None)):
        for xs in (slice(0, -ww), slice(-ww, -sw), slice(-sw, None)):
            img[ys, xs] = n
            n += 1
    m = _windows(img[None, :, :, None], wh, ww)[0, :, :, 0]  # (nW, N)
    diff = m[:, None, :] - m[:, :, None]
    return torch.where(diff != 0, -100.0, 0.0)


def _windows(x, wh, ww):
    """(B, H, W, C) -> (B, nW, wh ww, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // wh, wh, w // ww, ww, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, -1, wh * ww, c)


def _unwindows(x, h, w, wh, ww):
    b, c = x.shape[0], x.shape[-1]
    x = x.reshape(b, h // wh, w // ww, wh, ww, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def _heads(t, nh):
    """(B, nW, N, C) -> (B, nW, nh, N, d)."""
    return t.reshape(*t.shape[:3], nh, -1).transpose(2, 3)


def _conv_branch(v, p, b, quant):
    """GELU(BN(dwconv3x3(v)))."""
    y = conv(v, p, f"{b}/attn/dwconv/0", quant, groups=v.shape[-1])
    return F.gelu(batch_norm(y, p, f"{b}/attn/dwconv/1"))


def _channel_map(z, p, b, quant):
    ci = f"{b}/attn/channel_interaction"
    y = dense(z.mean(dim=(1, 2)), p, f"{ci}/1", quant)
    return dense(F.gelu(batch_norm(y, p, f"{ci}/2")), p, f"{ci}/4", quant)


def _spatial_map(z, p, b, quant):
    si = f"{b}/attn/spatial_interaction"
    y = dense(z, p, f"{si}/0", quant)
    return dense(F.gelu(batch_norm(y, p, f"{si}/1")), p, f"{si}/3", quant)


def spatial_attention(n, p, b, shift, config, quant):
    bsz, h, w, c = n.shape
    nh = config["num_heads"] // 2
    sh, sw = config["split_size"]
    q, k, v = dense(n, p, f"{b}/attn/qkv", quant).split(c, dim=-1)
    half = c // 2
    outs = []
    for br, (wh, ww) in enumerate(((sh, sw), (sw, sh))):
        part = [t[..., br * half:(br + 1) * half] for t in (q, k, v)]
        if shift:
            part = [torch.roll(t, (-(wh // 2), -(ww // 2)), dims=(1, 2))
                    for t in part]
        qw, kw, vw = (_heads(_windows(t, wh, ww), nh) for t in part)
        table = pos_table(p, f"{b}/attn/attns/{br}/pos", wh, ww, n.device)
        bias = table[rpi(wh, ww, n.device)].permute(2, 0, 1)  # (nh, N, N)
        d = qw.shape[-1]
        s = (_q(qw * d ** -0.5, quant) @ _q(kw, quant).transpose(-1, -2)
             + bias)
        if shift:
            s = s + region_mask(h, w, wh, ww, wh // 2, ww // 2,
                                n.device)[None, :, None]
        o = _q(s.softmax(-1), quant) @ _q(vw, quant)
        o = _unwindows(o.transpose(2, 3).reshape(bsz, -1, wh * ww, half), h,
                       w, wh, ww)
        if shift:
            o = torch.roll(o, (wh // 2, ww // 2), dims=(1, 2))
        outs.append(o)
    a = torch.cat(outs, dim=-1)
    cx = _conv_branch(v, p, b, quant)
    y = (a * torch.sigmoid(_channel_map(cx, p, b, quant))[:, None, None]
         + cx * torch.sigmoid(_spatial_map(a, p, b, quant)))
    return dense(y, p, f"{b}/attn/proj", quant)


def channel_attention(n, p, b, config, quant):
    bsz, h, w, c = n.shape
    nh = config["num_heads"]
    qkv = dense(n, p, f"{b}/attn/qkv", quant)
    t = qkv.reshape(bsz, h * w, 3, nh, c // nh).permute(2, 0, 3, 4, 1)
    q, k, v = t[0], t[1], t[2]  # (B, nh, d, N)
    q, k = F.normalize(q, dim=-1), F.normalize(k, dim=-1)
    attn = (_q(q, quant) @ _q(k, quant).transpose(-2, -1)
            * p[f"{b}/attn/temperature"])
    o = _q(attn.softmax(-1), quant) @ _q(v, quant)  # (B, nh, d, N)
    a = o.permute(0, 3, 1, 2).reshape(bsz, h, w, c)
    cx = _conv_branch(qkv[..., 2 * c:], p, b, quant)
    y = (a * torch.sigmoid(_spatial_map(cx, p, b, quant))
         + cx * torch.sigmoid(_channel_map(a, p, b, quant))[:, None, None])
    return dense(y, p, f"{b}/attn/proj", quant)


def sgfn(m, p, b, quant):
    h1, h2 = F.gelu(dense(m, p, f"{b}/ffn/fc1", quant)).chunk(2, dim=-1)
    g = conv(norm(h2, p, f"{b}/ffn/sg/norm"), p, f"{b}/ffn/sg/conv", quant,
             groups=h2.shape[-1])
    return dense(h1 * g, p, f"{b}/ffn/fc2", quant)


def datb(x, p, i, j, config, quant):
    b = f"layers/{i}/blocks/{j}"
    n = norm(x, p, f"{b}/norm1")
    if j % 2 == 0:
        x = x + spatial_attention(n, p, b, shifted(i, j), config, quant)
    else:
        x = x + channel_attention(n, p, b, config, quant)
    return x + sgfn(norm(x, p, f"{b}/norm2"), p, b, quant)


def _pixel_shuffle(x, r):
    return F.pixel_shuffle(x.permute(0, 3, 1, 2), r).permute(0, 2, 3, 1)


def forward(p: dict, tiles: torch.Tensor, config: dict, quant=None):
    """(N, h, w, 3) float32 in [0, 1] -> (N, h*s, w*s, 3) float32; h and w
    multiples of the largest split size."""
    mean = torch.tensor(config["rgb_mean"], dtype=torch.float32,
                        device=tiles.device)
    rng = config["img_range"]
    x = (tiles - mean) * rng
    f0 = conv(x, p, "conv_first", quant)
    t = norm(f0, p, "before_RG/1")
    for i, depth in enumerate(config["depths"]):
        r = t
        for j in range(depth):
            r = datb(r, p, i, j, config, quant)
        t = conv(r, p, f"layers/{i}/conv", quant) + t
    f = conv(norm(t, p, "norm"), p, "conv_after_body", quant) + f0
    u = F.leaky_relu(conv(f, p, "conv_before_upsample/0", quant), 0.01)
    for k in range(int(math.log2(config["scale"]))):
        u = _pixel_shuffle(conv(u, p, f"upsample/{2 * k}", quant), 2)
    y = conv(u, p, "conv_last", quant)
    return y / rng + mean
