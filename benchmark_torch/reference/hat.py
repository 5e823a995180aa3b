"""Plain reference of HAT (Hybrid Attention Transformer) SRx4, float32, on
NHWC tiles.

Written from the published architecture (Chen et al., "Activating More
Pixels in Image Super-Resolution Transformer", arXiv:2205.04437;
XPixelGroup/HAT ``hat/archs/hat_arch.py``, class ``HAT`` with the
pixel-shuffle upsampler):

- ``x = (x - mean) img_range``; ``f0 = conv_first(x)`` (3x3); patch
  embedding = LayerNorm;
- residual hybrid attention groups (RHAG): ``depth`` HABs, one OCAB, a
  3x3 conv, plus the group's input;
- LayerNorm, ``conv_after_body`` plus ``f0``; a 3x3 conv to ``num_feat``
  and LeakyReLU 0.01; per factor 2 a 3x3 conv to 4 num_feat and a pixel
  shuffle; ``conv_last``; ``y / img_range + mean``, not clamped.

HAB: LayerNorm; window multi-head self-attention over ``window`` squares
of the map rolled by -shift on odd blocks (shift window / 2), with the
relative-position bias of ``calculate_rpi_sa`` and Swin's region mask
(-100 between regions), rolled back; beside it, on the same normalised
input unrolled, the channel attention block (3x3 conv to C / compress,
GELU, 3x3 conv to C, then times the sigmoid of a 1x1 conv to C / squeeze,
ReLU and a 1x1 conv back to C of the map's mean), times conv_scale; both
added to the input; LayerNorm, MLP (mlp_ratio expansion, GELU), residual.
OCAB: LayerNorm; queries of each window against the keys and values of
the window + overlap_ratio window wide square with the same centre, zero
outside the map (``nn.Unfold`` with zero padding), with the bias of
``calculate_rpi_oca`` (used as a Python index, negative counting from
the end); projection, residual; LayerNorm, MLP, residual. LayerNorms have
eps 1e-5, GELUs are the exact erf form, attention scales by
head_dim^-0.5.

Parameters: the flat published layout the program's weight files use,
the names of HAT's own state dict '/'-joined: conv kernels (kH, kW, in,
out), dense kernels (in, out) (the channel attention's 1x1 convs among
them), LayerNorm ``scale`` / ``bias``, relative-position tables
``relative_position_bias`` ((rows, heads)). Departures from the
published code: none but the weights, which are seeded (there is no
checkpoint in the repository).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def offset(config: dict) -> int:
    return 0


def _overlap_window(config: dict) -> int:
    ws = config["window"]
    return ws + int(ws * config["overlap_ratio"])


def param_shapes(config: dict) -> dict:
    """{path: shape} of every parameter, in the published layout."""
    c, nh = config["embed_dim"], config["num_heads"]
    ws, we = config["window"], _overlap_window(config)
    nf = config["num_feat"]
    hid = c * config["mlp_ratio"]
    mid, sq = c // config["compress_ratio"], c // config["squeeze_factor"]
    shapes = {}

    def conv(name, cin, cout):
        shapes[f"{name}/kernel"] = (3, 3, cin, cout)
        shapes[f"{name}/bias"] = (cout,)

    def dense(name, cin, cout):
        shapes[f"{name}/kernel"] = (cin, cout)
        shapes[f"{name}/bias"] = (cout,)

    def norm(name):
        shapes[f"{name}/scale"] = (c,)
        shapes[f"{name}/bias"] = (c,)

    def mlp(b):
        norm(f"{b}/norm2")
        dense(f"{b}/mlp/fc1", c, hid)
        dense(f"{b}/mlp/fc2", hid, c)

    conv("conv_first", 3, c)
    norm("patch_embed/norm")
    for i, depth in enumerate(config["depths"]):
        g = f"layers/{i}/residual_group"
        for j in range(depth):
            b = f"{g}/blocks/{j}"
            norm(f"{b}/norm1")
            dense(f"{b}/attn/qkv", c, 3 * c)
            dense(f"{b}/attn/proj", c, c)
            shapes[f"{b}/attn/relative_position_bias"] = ((2 * ws - 1) ** 2,
                                                          nh)
            conv(f"{b}/conv_block/cab/0", c, mid)
            conv(f"{b}/conv_block/cab/2", mid, c)
            dense(f"{b}/conv_block/cab/3/attention/1", c, sq)
            dense(f"{b}/conv_block/cab/3/attention/3", sq, c)
            mlp(b)
        o = f"{g}/overlap_attn"
        norm(f"{o}/norm1")
        dense(f"{o}/qkv", c, 3 * c)
        shapes[f"{o}/relative_position_bias"] = ((ws + we - 1) ** 2, nh)
        dense(f"{o}/proj", c, c)
        mlp(o)
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


def conv(x, p, name, quant):
    """3x3 'same' conv of an NHWC map, NHWC out."""
    k = p[f"{name}/kernel"].permute(3, 2, 0, 1)
    y = F.conv2d(_q(x.permute(0, 3, 1, 2), quant), _q(k, quant),
                 p[f"{name}/bias"], padding=1)
    return y.permute(0, 2, 3, 1)


def dense(x, p, name, quant):
    return _q(x, quant) @ _q(p[f"{name}/kernel"], quant) + p[f"{name}/bias"]


def norm(x, p, name):
    return F.layer_norm(x, (x.shape[-1],), p[f"{name}/scale"],
                        p[f"{name}/bias"], 1e-5)


def rpi_sa(ws: int, device):
    """HAT's ``calculate_rpi_sa``: (ws^2, ws^2) indices of query - key
    offsets into the (2 ws - 1)^2 table."""
    coords = torch.stack(torch.meshgrid(torch.arange(ws), torch.arange(ws),
                                        indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    rel = rel + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).to(device)


def rpi_oca(ws: int, we: int, device):
    """HAT's ``calculate_rpi_oca``: (ws^2, we^2) indices of key - query
    offsets, shifted by ws - we + 1, into the (ws + we - 1)^2 table (some
    negative: a Python index counts them from the end)."""
    def flat(n):
        return torch.stack(torch.meshgrid(torch.arange(n), torch.arange(n),
                                          indexing="ij")).flatten(1)

    rel = (flat(we)[:, None, :] - flat(ws)[:, :, None]).permute(1, 2, 0)
    rel = rel + (ws - we + 1)
    return (rel[..., 0] * (ws + we - 1) + rel[..., 1]).to(device)


def region_mask(h, w, ws, shift, device):
    """HAT's ``calculate_mask``: (nW, ws^2, ws^2), -100 between tokens of
    different regions of the rolled map, else 0."""
    img = torch.zeros((h, w), device=device)
    cuts = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    n = 0
    for ys in cuts:
        for xs in cuts:
            img[ys, xs] = n
            n += 1
    m = _windows(img[None, :, :, None], ws)[0, :, :, 0]  # (nW, ws^2)
    diff = m[:, None, :] - m[:, :, None]
    return torch.where(diff != 0, -100.0, 0.0)


def _windows(x, ws):
    """(B, H, W, C) -> (B, nW, ws^2, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, -1, ws * ws, c)


def _unwindows(x, h, w, ws):
    b, c = x.shape[0], x.shape[-1]
    x = x.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def _heads(t, nh):
    """(B, nW, N, C) -> (B, nW, nh, N, d)."""
    return t.reshape(*t.shape[:3], nh, -1).transpose(2, 3)


def _softmax_attend(q, k, v, bias, quant, mask=None):
    d = q.shape[-1]
    s = _q(q * d ** -0.5, quant) @ _q(k, quant).transpose(-1, -2) + bias
    if mask is not None:
        s = s + mask
    return _q(s.softmax(-1), quant) @ _q(v, quant)


def hab(x, p, b, shift, config, quant):
    bsz, h, w, c = x.shape
    nh, ws = config["num_heads"], config["window"]
    n = norm(x, p, f"{b}/norm1")
    cab = f"{b}/conv_block/cab"
    z = conv(F.gelu(conv(n, p, f"{cab}/0", quant)), p, f"{cab}/2", quant)
    y = F.relu(dense(z.mean(dim=(1, 2)), p, f"{cab}/3/attention/1", quant))
    z = z * torch.sigmoid(dense(y, p, f"{cab}/3/attention/3",
                                quant))[:, None, None]
    s = torch.roll(n, (-shift, -shift), dims=(1, 2)) if shift else n
    qkv = _windows(dense(s, p, f"{b}/attn/qkv", quant), ws)
    q, k, v = (_heads(t, nh) for t in qkv.split(c, dim=-1))
    table = p[f"{b}/attn/relative_position_bias"]
    bias = table[rpi_sa(ws, x.device)].permute(2, 0, 1)  # (nh, N, N)
    mask = (region_mask(h, w, ws, shift, x.device)[None, :, None]
            if shift else None)
    o = _softmax_attend(q, k, v, bias, quant, mask)
    o = _unwindows(o.transpose(2, 3).reshape(bsz, -1, ws * ws, c), h, w, ws)
    if shift:
        o = torch.roll(o, (shift, shift), dims=(1, 2))
    x = x + dense(o, p, f"{b}/attn/proj", quant) + z * config["conv_scale"]
    return x + _mlp(x, p, b, quant)


def ocab(x, p, b, config, quant):
    bsz, h, w, c = x.shape
    nh, ws, we = config["num_heads"], config["window"], _overlap_window(config)
    qkv = dense(norm(x, p, f"{b}/norm1"), p, f"{b}/qkv", quant)
    q = _heads(_windows(qkv[..., :c], ws), nh)
    kv = qkv[..., c:].permute(0, 3, 1, 2)  # (B, 2C, H, W)
    cols = F.unfold(kv, kernel_size=we, stride=ws, padding=(we - ws) // 2)
    cols = cols.reshape(bsz, 2, c, we * we, -1).permute(1, 0, 4, 3, 2)
    k, v = _heads(cols[0], nh), _heads(cols[1], nh)  # (B, nW, nh, we^2, d)
    table = p[f"{b}/relative_position_bias"]
    bias = table[rpi_oca(ws, we, x.device)].permute(2, 0, 1)
    o = _softmax_attend(q, k, v, bias, quant)
    o = _unwindows(o.transpose(2, 3).reshape(bsz, -1, ws * ws, c), h, w, ws)
    x = x + dense(o, p, f"{b}/proj", quant)
    return x + _mlp(x, p, b, quant)


def _mlp(x, p, b, quant):
    y = F.gelu(dense(norm(x, p, f"{b}/norm2"), p, f"{b}/mlp/fc1", quant))
    return dense(y, p, f"{b}/mlp/fc2", quant)


def _pixel_shuffle(x, r):
    return F.pixel_shuffle(x.permute(0, 3, 1, 2), r).permute(0, 2, 3, 1)


def forward(p: dict, tiles: torch.Tensor, config: dict, quant=None):
    """(N, h, w, 3) float32 in [0, 1] -> (N, h*s, w*s, 3) float32; h and w
    multiples of the window."""
    mean = torch.tensor(config["rgb_mean"], dtype=torch.float32,
                        device=tiles.device)
    rng = config["img_range"]
    ws = config["window"]
    x = (tiles - mean) * rng
    f0 = conv(x, p, "conv_first", quant)
    t = norm(f0, p, "patch_embed/norm")
    for i, depth in enumerate(config["depths"]):
        g = f"layers/{i}/residual_group"
        r = t
        for j in range(depth):
            r = hab(r, p, f"{g}/blocks/{j}", 0 if j % 2 == 0 else ws // 2,
                    config, quant)
        r = ocab(r, p, f"{g}/overlap_attn", config, quant)
        t = conv(r, p, f"layers/{i}/conv", quant) + t
    f = conv(norm(t, p, "norm"), p, "conv_after_body", quant) + f0
    u = F.leaky_relu(conv(f, p, "conv_before_upsample/0", quant), 0.01)
    for k in range(int(math.log2(config["scale"]))):
        u = _pixel_shuffle(conv(u, p, f"upsample/{2 * k}", quant), 2)
    y = conv(u, p, "conv_last", quant)
    return y / rng + mean
