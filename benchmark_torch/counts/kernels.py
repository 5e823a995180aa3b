"""Work of one launch of the port's hand-written kernels, from shapes.

Kernel B (the whole Swin block over ``bw`` windows of 64 tokens at width
``c``): FLOPs the four GEMMs and the attention products
(``swin_unet.block_flops``); bytes x in and out, the GEMM weights
(8 C^2) once, the fp32 biases and LayerNorm parameters (11 C), the
(heads, 64, 64) fp32 bias and the int32 flags.

Kernel C (blend, overlap-add and u8 of one frame): bytes each tile value
that covers the frame read once, each u8 output written once. The
covering values are (covered rows) x (covered columns) x 3, each counted
once a tile that covers it.

A launch's bound is the larger of its FLOPs over the tensor-core peak and
its bytes over the memory bandwidth (``peaks.json``). Activations and
tile values are bfloat16 (``ELEM`` bytes), as every cell serves them.
"""

from __future__ import annotations

from benchmark_torch.counts.swin_unet import block_flops

ELEM = 2


def kernel_b(bw: int, c: int, nh: int):
    """(FLOPs, bytes) of one kernel-B launch."""
    nbytes = (2 * bw * 64 * c * ELEM + 8 * c * c * ELEM + 11 * c * 4
              + nh * 64 * 64 * 4 + bw * 4)
    return float(bw * block_flops(c)), float(nbytes)


def kernel_c(plan):
    """(FLOPs, bytes) of one kernel-C launch on ``plan``
    (``reference.tiling.Plan``); its FLOPs are not tensor-core work."""
    out_h, out_w = plan.out_hw
    ot = plan.out_tile

    def covered(origins, n):
        return sum(min(o + ot, n) - o for o in sorted(set(origins)) if o < n)

    rows = covered([o[0] for o in plan.outputs], out_h)
    cols = covered([o[1] for o in plan.outputs], out_w)
    return 0.0, float(ELEM * 3 * rows * cols + out_h * out_w * 3)


def bound_s(flops: float, nbytes: float, peaks: dict) -> float:
    return max(flops / peaks["bf16_flops"], nbytes / peaks["hbm_bytes_s"])
