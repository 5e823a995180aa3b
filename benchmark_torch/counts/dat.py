"""Work of the DAT forward and of kernels G and J, from shapes (2 FLOP a
multiply-add).

``flops_per_tile`` counts the products and convolutions of one tile: the
3x3 convolutions (first, the group convs, after the body, before and in
the upsampler, last), the depthwise 3x3 convolutions (every attention
block's on v, every SGFN's spatial gate), the dense layers (qkv, proj,
fc1 and fc2 of every block, the spatial interaction's two 1x1 layers at
every pixel, the channel interaction's two on the pooled vector), the
window attention products q k^T and p v of every spatial block (256 keys
a query) and the channel attention products of every channel block (the
d x d Gram matrix over the tile's tokens and A v). Means, norms,
LayerNorms, activations, gates, adds and the shuffles are not counted,
nor the position MLP, which the program runs once at load. A tile is
whole windows: DAT pads nothing inside. ``library_flops_per_tile`` is
the same count without the attention products: the work of the
convolutions and dense layers, which run as library (cuDNN and cuBLAS)
kernels.

Kernel G, one launch a spatial block (``attention_launches``: 18 a
forward, each over every window of a chunk, 256 tokens a window in both
halves of the heads); kernel J, one call a channel block
(``channel_launches``: 18 a forward, over every token of a chunk). Each:
FLOPs its products; bytes the q, k and v of every token read once and
the output written once, bfloat16. This counts the model's work, whatever
implements it.
"""

from __future__ import annotations

import math

ELEM = 2
WINDOW_TOKENS = 256  # 8 x 32 and 32 x 8 windows alike


def _windows(config: dict, n: int, th: int, tw: int) -> int:
    wh, ww = config["split_size"]
    return n * th * tw // (wh * ww)


def _window_flops(config: dict) -> int:
    """FLOPs of q k^T and p v of one window, all heads."""
    n = WINDOW_TOKENS
    return 2 * 2 * n * n * config["embed_dim"]


def _channel_flops(config: dict, tokens: int) -> int:
    """FLOPs of the Gram matrix and A v over ``tokens``, all heads."""
    c = config["embed_dim"]
    return 2 * 2 * tokens * c * (c // config["num_heads"])


def _blocks(config: dict) -> tuple:
    """(spatial, channel) blocks a forward."""
    spatial = sum((d + 1) // 2 for d in config["depths"])
    return spatial, sum(config["depths"]) - spatial


def _attention_per_tile(config: dict, th: int, tw: int) -> int:
    spatial, channel = _blocks(config)
    return (spatial * _windows(config, 1, th, tw) * _window_flops(config)
            + channel * _channel_flops(config, th * tw))


def _library_per_tile(config: dict, th: int, tw: int) -> int:
    c, nf, s = config["embed_dim"], config["num_feat"], config["scale"]
    px = th * tw
    hid = c * config["expansion_factor"]

    def conv3(pixels, cin, cout, groups=1):
        return 2 * pixels * 9 * (cin // groups) * cout

    aim = (2 * px * (3 * c * c + c * c)                    # qkv, proj
           + conv3(px, c, c, groups=c)                     # dwconv on v
           + 2 * 2 * c * (c // 8)                          # channel map
           + 2 * px * (c * (c // 16) + c // 16))           # spatial map
    sgfn = (2 * px * (c * hid + hid // 2 * c)              # fc1, fc2
            + conv3(px, hid // 2, hid // 2, groups=hid // 2))
    blocks = sum(config["depths"]) * (aim + sgfn)
    groups = blocks + len(config["depths"]) * conv3(px, c, c)
    up = sum(conv3(px * 4 ** k, nf, 4 * nf)
             for k in range(int(math.log2(s))))
    return (conv3(px, 3, c) + groups + conv3(px, c, c) + conv3(px, c, nf)
            + up + conv3(px * s * s, nf, 3))


def library_flops_per_tile(config: dict, th: int, tw: int) -> float:
    return float(_library_per_tile(config, th, tw))


def flops_per_tile(config: dict, th: int, tw: int) -> float:
    return float(_library_per_tile(config, th, tw)
                 + _attention_per_tile(config, th, tw))


def attention_launches(config: dict, n: int, th: int, tw: int) -> list:
    """(windows, kind) of each kernel-G launch of one forward of ``n``
    tiles, in order: one a spatial block, every window of the chunk
    (``windows`` counts each window once, all heads)."""
    w = _windows(config, n, th, tw)
    return [(w, "rect")] * _blocks(config)[0]


def kernel_g(windows: int, kind: str, config: dict):
    """(FLOPs, bytes) of one kernel-G launch over ``windows`` windows."""
    tokens = windows * WINDOW_TOKENS
    nbytes = tokens * 4 * config["embed_dim"] * ELEM
    return float(windows * _window_flops(config)), float(nbytes)


def channel_launches(config: dict, n: int, th: int, tw: int) -> list:
    """Tokens of each kernel-J call of one forward of ``n`` tiles, in
    order: one a channel block, over every token of the chunk."""
    return [n * th * tw] * _blocks(config)[1]


def kernel_j(tokens: int, config: dict):
    """(FLOPs, bytes) of one kernel-J call over ``tokens`` tokens."""
    nbytes = tokens * 4 * config["embed_dim"] * ELEM
    return float(_channel_flops(config, tokens)), float(nbytes)
