"""Plain reference of MambaIR (the state-space image restorer) classic SR
x4, float32, on NHWC tiles.

Written from the published architecture (Guo et al., "MambaIR: A Simple
Baseline for Image Restoration with State-Space Model", ECCV 2024,
arXiv:2402.15648; csguoh/MambaIR ``basicsr/archs/mambair_arch.py``, class
``MambaIR`` with the pixel-shuffle upsampler, ``SS2D.forward_corev0``):

- ``x = (x - mean) img_range``; ``f0 = conv_first(x)`` (3x3); patch
  embedding = LayerNorm;
- residual groups: ``depth`` VSSBlocks, a 3x3 conv, plus the group's
  input;
- LayerNorm, ``conv_after_body`` plus ``f0``; a 3x3 conv to ``num_feat``
  and LeakyReLU 0.01; per factor 2 a 3x3 conv to 4 num_feat and a pixel
  shuffle; ``conv_last``; ``y / img_range + mean``, not clamped.

VSSBlock: ``x = x skip_scale + SS2D(ln_1(x))``; ``x = x skip_scale2 +
CAB(ln_2(x))``, the CAB a 3x3 conv to C / compress_ratio, GELU, a 3x3 conv
back to C, times the sigmoid of a 1x1 conv to C / squeeze_factor, ReLU
and a 1x1 conv back to C of the map's mean.

SS2D: ``[x | z] = in_proj(n)`` (no bias); ``u = SiLU(dwconv3x3(x))``;
the four sequences of u as ``forward_corev0`` makes them (row-major, the
transposed map row-major, i.e. column-major, and both flipped); per
direction k, ``[dt | B | C] = x_proj_weight[k] u``, ``delta =
softplus(dt_projs_weight[k] dt + dt_projs_bias[k])``, ``A = -exp(A_logs)``,
the selective scan ``h_l = exp(delta_l A) h_{l-1} + delta_l u_l B_l``,
``y_l = C_l . h_l + Ds u_l``; the flipped outputs flipped back, the
transposed ones transposed back, summed in the published order ((y_0 +
y_2) + y_1) + y_3; ``out_proj(out_norm(y) SiLU(z))`` (no bias).
LayerNorms have eps 1e-5, GELUs are the exact erf form.

The scan: ``scan_loop`` runs token by token with the (B, 4, D, N) state;
``scan_chunked`` (what ``forward`` runs) computes the same recurrence in
closed form within chunks of at most 256 tokens, h_t = E_t (h_0 +
sum_{s <= t} delta_s u_s B_s / E_s) with E_t = exp(A sum_{s <= t}
delta_s) from the chunk's start, and carries h from chunk to chunk; a
chunk is halved until A times its delta sum stays within fp32's exponent
range (``MAX_EXPONENT``).

Parameters: the flat published layout the program's weight files use,
the names of MambaIR's own state dict '/'-joined: conv kernels (kH, kW,
in, out) (the depthwise conv's (3, 3, 1, D)), dense kernels (in, out)
(the CAB's 1x1 convs among them), LayerNorm ``scale`` / ``bias``; the
stacked per-direction projections one dense kernel a direction
(``x_proj/<k>/kernel`` (D, R + 2N), ``dt_projs/<k>/kernel`` (R, D)),
``dt_projs_bias/value`` (4, D), ``A_logs/value`` (4 D, N), and the
per-channel scales ``Ds/scale`` (4 D), ``skip_scale/scale`` and
``skip_scale2/scale`` (C). Departures from the published code: drop-path
and dropout are absent (inference), and the weights are seeded (there is
no checkpoint in the repository); none changes the mathematics.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

DIRECTIONS = 4
CHUNK = 256          # tokens a chunk of the closed form, at most
MAX_EXPONENT = 60.0  # |A| times a chunk's delta sum, at most


def offset(config: dict) -> int:
    return 0


def _widths(config: dict) -> tuple:
    """(C, D, R, N): width, inner width, dt rank, state size."""
    c = config["embed_dim"]
    return (c, config["mlp_ratio"] * c, math.ceil(c / 16),
            config["d_state"])


def param_shapes(config: dict) -> dict:
    """{path: shape} of every parameter, in the published layout."""
    c, d, r, n = _widths(config)
    nf = config["num_feat"]
    mid, sq = c // config["compress_ratio"], c // config["squeeze_factor"]
    k = config["d_conv"]
    shapes = {}

    def conv(name, cin, cout):
        shapes[f"{name}/kernel"] = (3, 3, cin, cout)
        shapes[f"{name}/bias"] = (cout,)

    def dense(name, cin, cout):
        shapes[f"{name}/kernel"] = (cin, cout)
        shapes[f"{name}/bias"] = (cout,)

    def norm(name, width):
        shapes[f"{name}/scale"] = (width,)
        shapes[f"{name}/bias"] = (width,)

    conv("conv_first", 3, c)
    norm("patch_embed/norm", c)
    for i, depth in enumerate(config["depths"]):
        for j in range(depth):
            b = f"layers/{i}/residual_group/blocks/{j}"
            a = f"{b}/self_attention"
            norm(f"{b}/ln_1", c)
            shapes[f"{a}/in_proj/kernel"] = (c, 2 * d)
            shapes[f"{a}/conv2d/kernel"] = (k, k, 1, d)
            shapes[f"{a}/conv2d/bias"] = (d,)
            for kk in range(DIRECTIONS):
                shapes[f"{a}/x_proj/{kk}/kernel"] = (d, r + 2 * n)
            for kk in range(DIRECTIONS):
                shapes[f"{a}/dt_projs/{kk}/kernel"] = (r, d)
            shapes[f"{a}/dt_projs_bias/value"] = (DIRECTIONS, d)
            shapes[f"{a}/A_logs/value"] = (DIRECTIONS * d, n)
            shapes[f"{a}/Ds/scale"] = (DIRECTIONS * d,)
            norm(f"{a}/out_norm", d)
            shapes[f"{a}/out_proj/kernel"] = (d, c)
            shapes[f"{b}/skip_scale/scale"] = (c,)
            conv(f"{b}/conv_blk/cab/0", c, mid)
            conv(f"{b}/conv_blk/cab/2", mid, c)
            dense(f"{b}/conv_blk/cab/3/attention/1", c, sq)
            dense(f"{b}/conv_blk/cab/3/attention/3", sq, c)
            norm(f"{b}/ln_2", c)
            shapes[f"{b}/skip_scale2/scale"] = (c,)
        conv(f"layers/{i}/conv", c, c)
    norm("norm", c)
    conv("conv_after_body", c, c)
    conv("conv_before_upsample/0", c, nf)
    for kk in range(int(math.log2(config["scale"]))):
        conv(f"upsample/{2 * kk}", nf, 4 * nf)
    conv("conv_last", nf, 3)
    return shapes


def _q(t, quant):
    return t if quant is None else quant(t)


def conv(x, p, name, quant, groups=1):
    """3x3 'same' conv of an NHWC map, NHWC out."""
    k = p[f"{name}/kernel"].permute(3, 2, 0, 1)
    y = F.conv2d(_q(x.permute(0, 3, 1, 2), quant), _q(k, quant),
                 p[f"{name}/bias"], padding=k.shape[-1] // 2, groups=groups)
    return y.permute(0, 2, 3, 1)


def dense(x, p, name, quant, bias=True):
    y = _q(x, quant) @ _q(p[f"{name}/kernel"], quant)
    return y + p[f"{name}/bias"] if bias else y


def norm(x, p, name):
    return F.layer_norm(x, (x.shape[-1],), p[f"{name}/scale"],
                        p[f"{name}/bias"], 1e-5)


def scan_loop(us, delta, bm, cm, a):
    """The selective scan token by token: us and delta (B, K, L, D), bm
    and cm (B, K, L, N), a (K, D, N); returns the (B, K, L, D) sums
    C_l . h_l (without the D u term)."""
    b, k, length, d = us.shape
    h = us.new_zeros((b, k, d, a.shape[-1]))
    ys = torch.empty_like(us)
    for t in range(length):
        h = (torch.exp(delta[:, :, t, :, None] * a) * h
             + (delta[:, :, t] * us[:, :, t])[..., None]
             * bm[:, :, t, None, :])
        ys[:, :, t] = (h * cm[:, :, t, None, :]).sum(-1)
    return ys


def chunk_length(delta, a) -> int:
    """The chunk of ``scan_chunked``: ``CHUNK`` tokens, halved until
    |A| times every chunk's delta sum is at most ``MAX_EXPONENT``."""
    length = delta.shape[2]
    amax = float(a.abs().amax())
    t = CHUNK
    while t > 1:
        pad = (-length) % t
        sums = F.pad(delta, (0, 0, 0, pad)).unflatten(2, (-1, t)).sum(3)
        if amax * float(sums.amax()) <= MAX_EXPONENT:
            break
        t //= 2
    return t


def scan_chunked(us, delta, bm, cm, a):
    """``scan_loop`` in closed form within chunks (``chunk_length``),
    carrying h between them."""
    b, k, length, d = us.shape
    t = chunk_length(delta, a)
    h = us.new_zeros((b, k, d, a.shape[-1]))
    ys = torch.empty_like(us)
    for s0 in range(0, length, t):
        dl = delta[:, :, s0:s0 + t]
        e = torch.exp(dl.cumsum(2)[..., None] * a[:, None])  # (B,K,t,D,N)
        x = (dl * us[:, :, s0:s0 + t])[..., None] * bm[:, :, s0:s0 + t,
                                                       None, :]
        hs = torch.cumsum(x.div_(e), 2).add_(h[:, :, None]).mul_(e)
        ys[:, :, s0:s0 + t] = torch.einsum("bktdn,bktn->bktd", hs,
                                           cm[:, :, s0:s0 + t])
        h = hs[:, :, -1]
    return ys


def ss2d(n, p, a, config, quant, scan=scan_chunked):
    """SS2D on the (B, H, W, C) map n, by ``forward_corev0``'s layouts."""
    bsz, hgt, wid, _ = n.shape
    c, d, r, ns = _widths(config)
    length = hgt * wid
    xz = dense(n, p, f"{a}/in_proj", quant, bias=False)
    x, z = xz[..., :d], xz[..., d:]
    u = F.silu(conv(x, p, f"{a}/conv2d", quant, groups=d))
    uc = u.permute(0, 3, 1, 2)                                 # (B, D, H, W)
    x_hwwh = torch.stack([uc.reshape(bsz, d, length),
                          uc.transpose(2, 3).reshape(bsz, d, length)], 1)
    xs = torch.cat([x_hwwh, torch.flip(x_hwwh, dims=[-1])], 1)  # (B,4,D,L)
    wx = torch.stack([p[f"{a}/x_proj/{k}/kernel"].t()
                      for k in range(DIRECTIONS)])             # (4, E, D)
    wdt = torch.stack([p[f"{a}/dt_projs/{k}/kernel"].t()
                       for k in range(DIRECTIONS)])            # (4, D, R)
    x_dbl = torch.einsum("bkdl,kcd->bkcl", _q(xs, quant), _q(wx, quant))
    dts, bs, cs = torch.split(x_dbl, [r, ns, ns], dim=2)
    dts = torch.einsum("bkrl,kdr->bkdl", _q(dts, quant), _q(wdt, quant))
    delta = F.softplus(dts + p[f"{a}/dt_projs_bias/value"][None, :, :, None])
    amat = -torch.exp(p[f"{a}/A_logs/value"]).reshape(DIRECTIONS, d, ns)
    ys = scan(*(_q(t, quant).transpose(2, 3).contiguous()
                for t in (xs, delta, bs, cs)), amat).transpose(2, 3)
    ys = ys + p[f"{a}/Ds/scale"].reshape(DIRECTIONS, d)[None, :, :,
                                                         None] * xs
    inv_y = torch.flip(ys[:, 2:4], dims=[-1])
    wh_y = ys[:, 1].reshape(bsz, d, wid, hgt).transpose(2, 3).reshape(
        bsz, d, length)
    invwh_y = inv_y[:, 1].reshape(bsz, d, wid, hgt).transpose(2, 3).reshape(
        bsz, d, length)
    y = ys[:, 0] + inv_y[:, 0] + wh_y + invwh_y
    y = y.transpose(1, 2).reshape(bsz, hgt, wid, d)
    y = norm(y, p, f"{a}/out_norm") * F.silu(z)
    return dense(y, p, f"{a}/out_proj", quant, bias=False)


def cab(x, p, b, quant):
    z = conv(F.gelu(conv(x, p, f"{b}/0", quant)), p, f"{b}/2", quant)
    w = F.relu(dense(z.mean(dim=(1, 2)), p, f"{b}/3/attention/1", quant))
    return z * torch.sigmoid(dense(w, p, f"{b}/3/attention/3",
                                   quant))[:, None, None]


def vss_block(x, p, b, config, quant, scan=scan_chunked):
    x = (x * p[f"{b}/skip_scale/scale"]
         + ss2d(norm(x, p, f"{b}/ln_1"), p, f"{b}/self_attention", config,
                quant, scan))
    return (x * p[f"{b}/skip_scale2/scale"]
            + cab(norm(x, p, f"{b}/ln_2"), p, f"{b}/conv_blk/cab", quant))


def _pixel_shuffle(x, r):
    return F.pixel_shuffle(x.permute(0, 3, 1, 2), r).permute(0, 2, 3, 1)


def forward(p: dict, tiles: torch.Tensor, config: dict, quant=None,
            scan=scan_chunked):
    """(N, h, w, 3) float32 in [0, 1] -> (N, h*s, w*s, 3) float32."""
    mean = torch.tensor(config["rgb_mean"], dtype=torch.float32,
                        device=tiles.device)
    rng = config["img_range"]
    x = (tiles - mean) * rng
    f0 = conv(x, p, "conv_first", quant)
    t = norm(f0, p, "patch_embed/norm")
    for i, depth in enumerate(config["depths"]):
        r = t
        for j in range(depth):
            r = vss_block(r, p, f"layers/{i}/residual_group/blocks/{j}",
                          config, quant, scan)
        t = conv(r, p, f"layers/{i}/conv", quant) + t
    f = conv(norm(t, p, "norm"), p, "conv_after_body", quant) + f0
    u = F.leaky_relu(conv(f, p, "conv_before_upsample/0", quant), 0.01)
    for k in range(int(math.log2(config["scale"]))):
        u = _pixel_shuffle(conv(u, p, f"upsample/{2 * k}", quant), 2)
    y = conv(u, p, "conv_last", quant)
    return y / rng + mean
