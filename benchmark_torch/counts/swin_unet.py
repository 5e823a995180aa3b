"""FLOPs of the swin_unet forward from its shapes (2 FLOP a multiply-add).

Counts the products and convolutions of one tile: the stem, the strided
convs, the dense layers, and in every Swin block the four GEMMs
(1024 C^2 a window of 64 tokens) and the attention products (2 x 2 x 64 x
64 x 32 = 524,288 a head and window). Elementwise work is not counted.
A tile is padded to a multiple of 32 first, as the model pads it.
"""

from __future__ import annotations

WINDOW_TOKENS = 64
HEAD_DIM = 32


def _padded(th: int, tw: int) -> int:
    return (-(-th // 32) * 32) * (-(-tw // 32) * 32)


def block_flops(c: int) -> int:
    """FLOPs of one Swin block a window at width ``c``."""
    return 1024 * c * c + 524_288 * (c // HEAD_DIM)


def block_launches(config: dict, n: int, th: int, tw: int) -> list:
    """(windows, width, heads) of each Swin block of one forward of ``n``
    tiles, in order: one kernel-B launch each."""
    c, d = config["base_dim"], config["depths"]
    px = _padded(th, tw)
    w1 = n * px // 4 // WINDOW_TOKENS
    w2 = n * px // 16 // WINDOW_TOKENS
    return ([(w1, c, c // HEAD_DIM)] * d[0] + [(w2, 2 * c, c // 16)] * d[2]
            + [(w1, c, c // HEAD_DIM)] * d[3])


def flops_per_tile(config: dict, th: int, tw: int) -> float:
    c = config["base_dim"]
    half = c // 2
    s = config["scale"]
    p = _padded(th, tw)
    convs = (2 * p * 3 * half * 9 + 2 * p * half * half * 9
             + 2 * (p // 4) * half * c * 4 + 2 * (p // 16) * c * 2 * c * 4
             + 2 * p * half * 3 * s * s * 9)
    dense = 2 * (p // 16) * 2 * c * 4 * c + 2 * (p // 4) * c * 4 * half
    blocks = sum(bw * block_flops(cc)
                 for bw, cc, _ in block_launches(config, 1, th, tw))
    return float(convs + dense + blocks)
