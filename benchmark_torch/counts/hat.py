"""Work of the HAT forward and of kernel G, from shapes (2 FLOP a
multiply-add).

``flops_per_tile`` counts the products and convolutions of one tile: the
3x3 convolutions (first, the two of every channel attention block, the
group convs, after the body, before and in the upsampler, last), the
dense layers (qkv, proj and the MLP of every HAB and OCAB, the channel
attention's two 1x1 layers on the pooled vector), and the attention
products q k^T and p v at the published head dim. Means, LayerNorms,
activations, adds and the shuffles are not counted. A tile is whole
windows: HAT pads nothing inside. ``library_flops_per_tile`` is the same
count without the attention products: the work of the convolutions and
dense layers, which run as library (cuDNN and cuBLAS) kernels.

Kernel G, one launch (``attention_launches``: one a HAB, self geometry,
and one an OCAB, overlapping geometry, each over all windows of a
chunk): FLOPs the two attention products; bytes the q, k and v of every
token read once and the output written once, bfloat16. This counts the
model's work, whatever implements it (the kernel pads the head dim to 32
and reads the overlapping keys of neighbouring windows again).
"""

from __future__ import annotations

import math

ELEM = 2


def _keys(config: dict, kind: str) -> int:
    ws = config["window"]
    we = ws + int(ws * config["overlap_ratio"]) if kind == "overlap" else ws
    return we * we


def _attention_flops(config: dict, kind: str) -> int:
    """FLOPs of q k^T and p v of one window, all heads."""
    n = config["window"] ** 2
    return 2 * 2 * n * _keys(config, kind) * config["embed_dim"]


def _attention_per_tile(config: dict, th: int, tw: int) -> int:
    windows = th * tw // config["window"] ** 2
    return sum(windows * (d * _attention_flops(config, "self")
                          + _attention_flops(config, "overlap"))
               for d in config["depths"])


def _library_per_tile(config: dict, th: int, tw: int) -> int:
    c, nf, s = config["embed_dim"], config["num_feat"], config["scale"]
    px = th * tw
    hid = c * config["mlp_ratio"]
    mid, sq = c // config["compress_ratio"], c // config["squeeze_factor"]

    def conv3(pixels, cin, cout):
        return 2 * pixels * 9 * cin * cout

    dense = 2 * px * (3 * c * c + c * c + 2 * c * hid)
    hab = dense + conv3(px, c, mid) + conv3(px, mid, c) + 2 * 2 * c * sq
    groups = sum(d * hab + dense + conv3(px, c, c) for d in config["depths"])
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
    tiles, in order: per group its HABs ("self"), then its OCAB
    ("overlap")."""
    w = n * th * tw // config["window"] ** 2
    return [la for d in config["depths"]
            for la in [(w, "self")] * d + [(w, "overlap")]]


def kernel_g(windows: int, kind: str, config: dict):
    """(FLOPs, bytes) of one kernel-G launch over ``windows`` windows."""
    tokens = windows * config["window"] ** 2
    nbytes = tokens * 4 * config["embed_dim"] * ELEM
    return float(windows * _attention_flops(config, kind)), float(nbytes)
