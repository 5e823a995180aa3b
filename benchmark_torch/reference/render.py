"""Plain reference render: u8 frame -> tiles -> model -> blend -> u8.

Plain PyTorch, imports nothing of the program. The model runs in float32
with TF32 off, ``BLOCK`` tiles at a time, so that it fits beside nothing
else; ``quant`` (``fp8_round``) rounds every operand of every product to
float8 e4m3 for the control. Blend: each tile's output times its row and
column ramps, summed onto a float32 canvas in tile order, then
round-half-even of x 255, clamped to [0, 255].
"""

from __future__ import annotations

import importlib

import torch

from benchmark_torch.reference import tiling

E4M3_MAX = 448.0
BLOCK = 4


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale that maps its
    largest magnitude to e4m3's largest value, returned in float32."""
    s = t.abs().amax().clamp_min(1e-30) / E4M3_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


def model_module(config: dict):
    """The reference module of the configuration's architecture,
    ``reference/<arch>.py``."""
    return importlib.import_module(f"benchmark_torch.reference."
                                   f"{config['arch']}")


def render(frame_u8: torch.Tensor, params: dict, config: dict,
           quant=None) -> torch.Tensor:
    """The (H*s, W*s, 3) u8 output of an (H, W, 3) u8 frame on its device.
    ``params``: the configuration's weights, flat, in the published
    (flax) layout."""
    arch = model_module(config)
    scale, tile = config["scale"], config["tile"]
    p = tiling.plan(tuple(frame_u8.shape[:2]), tile, scale,
                    arch.offset(config), config["overlap"])
    dev = frame_u8.device
    h, w = p.frame_hw
    x = frame_u8.to(torch.float32) * torch.tensor(1.0 / 255.0,
                                                  dtype=torch.float32)
    out_h, out_w = p.out_hw
    ot = p.out_tile
    canvas = torch.zeros((out_h + ot, out_w + ot, 3), dtype=torch.float32,
                         device=dev)
    ramp = torch.tensor(tiling.ramp(p.overlap_px, ot), dtype=torch.float32,
                        device=dev)
    ones = torch.ones(ot, dtype=torch.float32, device=dev)
    span = torch.arange(tile, device=dev)
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        for b0 in range(0, p.count, BLOCK):
            idx = range(b0, min(b0 + BLOCK, p.count))
            tiles = torch.stack([
                x[(span + p.inputs[t][0]).clamp(0, h - 1)][
                    :, (span + p.inputs[t][1]).clamp(0, w - 1)]
                for t in idx])
            with torch.no_grad():
                y = arch.forward(params, tiles, config, quant)
            for k, t in enumerate(idx):
                top, bottom, left, right = p.ramps[t]
                rw = ((ramp if top else ones) * (ramp.flip(0) if bottom
                                                  else ones))
                cw = ((ramp if left else ones) * (ramp.flip(0) if right
                                                   else ones))
                oy, ox = p.outputs[t]
                canvas[oy:oy + ot, ox:ox + ot] += (y[k] * rw[:, None, None]
                                                   * cw[None, :, None])
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    out = canvas[:out_h, :out_w]
    return torch.clamp(torch.round(out * 255.0), 0.0, 255.0).to(torch.uint8)
