"""Work of the MambaIR forward and of kernel K, from shapes (2 FLOP a
multiply-add).

``library_flops_per_tile`` counts the products and convolutions of one
tile that the library (cuBLAS, cuDNN) runs: the 3x3 convolutions (first,
the CABs' two, the group convs, after the body, before and in the
upsampler, last), every block's depthwise 3x3 convolution on the D = 2C
inner map, its dense layers at every pixel (in_proj C -> 2D, the
four directions' x_proj D -> 4 (R + 2N) as one GEMM, out_proj D -> C)
and the CAB's pooled gate (C -> C / 30 -> C, once a tile).
``scan_flops_per_tile`` is kernel K's arithmetic: the dt projection (R
-> D, every token, channel and direction) and ``FLOPS_PER_UPDATE`` for
every state update (tokens x 4 directions x D x N): delta A (1), the
decay's product with h and delta u B added (3: delta u B is a product and
an add, the decay one product), C h added to y (2); the exp, softplus
and the D u term are not counted. ``flops_per_tile`` is their sum, for
``mfu_pct``. Means, norms, LayerNorms, activations, gates, adds and the
shuffles are not counted.

Kernel K, one call a block (``scan_launches``: 36 a forward, each over
every token of a chunk). Its bound (``kernel_k``) is the larger of its
unavoidable bytes over the HBM bandwidth (u and the x_proj outputs read
once, y written once, bfloat16) and its state updates over
``UPDATES_S``. This counts the model's work, whatever implements it.

``UPDATES_S``, the H100 SXM's ceiling for state updates, each one exp:
132 SMs x 1,980 MHz x 32 exps a clock an SM. Of those 32, 16 are the
special-function unit's ``ex2`` (the CUDA C++ Programming Guide's
arithmetic-instruction throughput table for compute capability 9.0: 16
results a clock an SM for the base-2 exponential), and 16 more are as
many again computed by a polynomial on the FMA pipes, which the data
sheet's 67 TFLOP/s fp32 (= 132 x 1,980 MHz x 128 lanes x 2 FLOP) could
carry beside them. It is deliberately above what any split of the exps
between the two units reaches (the FMA pipes also carry the update's
three other operations), so the share reads at most 100% whatever
kernel K's implementation.
"""

from __future__ import annotations

import math

ELEM = 2
DIRECTIONS = 4
FLOPS_PER_UPDATE = 6
UPDATES_S = 132 * 1.98e9 * (16 + 16)


def widths(config: dict) -> tuple:
    """(C, D, R, N): width, inner width, dt rank, state size."""
    c = config["embed_dim"]
    return (c, config["mlp_ratio"] * c, math.ceil(c / 16),
            config["d_state"])


def _blocks(config: dict) -> int:
    return sum(config["depths"])


def library_flops_per_tile(config: dict, th: int, tw: int) -> float:
    c, d, r, n = widths(config)
    nf, s = config["num_feat"], config["scale"]
    px = th * tw
    k = config["d_conv"]

    def conv3(pixels, cin, cout):
        return 2 * pixels * 9 * cin * cout

    mid, sq = c // config["compress_ratio"], c // config["squeeze_factor"]
    ss2d = (2 * px * (c * 2 * d + d * DIRECTIONS * (r + 2 * n) + d * c)
            + 2 * px * k * k * d)
    cab = conv3(px, c, mid) + conv3(px, mid, c) + 2 * 2 * c * sq
    groups = (_blocks(config) * (ss2d + cab)
              + len(config["depths"]) * conv3(px, c, c))
    up = sum(conv3(px * 4 ** i, nf, 4 * nf)
             for i in range(int(math.log2(s))))
    return float(conv3(px, 3, c) + groups + conv3(px, c, c)
                 + conv3(px, c, nf) + up + conv3(px * s * s, nf, 3))


def updates(tokens: int, config: dict) -> int:
    """State updates of one call over ``tokens`` tokens."""
    _, d, _, n = widths(config)
    return tokens * DIRECTIONS * d * n


def scan_flops_per_tile(config: dict, th: int, tw: int) -> float:
    _, d, r, _ = widths(config)
    tokens = th * tw
    per_call = (2 * tokens * DIRECTIONS * r * d
                + FLOPS_PER_UPDATE * updates(tokens, config))
    return float(_blocks(config) * per_call)


def flops_per_tile(config: dict, th: int, tw: int) -> float:
    return (library_flops_per_tile(config, th, tw)
            + scan_flops_per_tile(config, th, tw))


def scan_launches(config: dict, n: int, th: int, tw: int) -> list:
    """Tokens of each kernel-K call of one forward of ``n`` tiles, in
    order: one a block, over every token of the chunk."""
    return [n * th * tw] * _blocks(config)


def kernel_k(tokens: int, config: dict):
    """(bytes, compute-bound seconds) of one kernel-K call over
    ``tokens`` tokens."""
    _, d, r, n = widths(config)
    nbytes = tokens * (2 * d + DIRECTIONS * (r + 2 * n)) * ELEM
    return float(nbytes), updates(tokens, config) / UPDATES_S


def bound_s(tokens: int, config: dict, peaks: dict) -> float:
    """Kernel K's bound for one call: the larger of its bytes over the
    card's bandwidth and its compute bound."""
    nbytes, compute_s = kernel_k(tokens, config)
    return max(compute_s, nbytes / peaks["hbm_bytes_s"])
