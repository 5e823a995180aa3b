"""The tile plan of waifu2x-tensorrt's renderer, the benchmark's own copy.

Semantics of the C++ reference (z3lx/waifu2x-tensorrt,
``src/tensorrt/img2img_render.cpp`` ``calculateTiles`` and ``applyWeights``,
``img2img_load.cpp`` ``createTileWeights``): square input tiles stepping by
the covered footprint less the overlap, column-major order (x outer, y
inner), input rects centred on their footprint and edge-replicated past
the frame, output rects clamped to the canvas, and a linear blend ramp of
``lround(tile * scale * overlap)`` pixels on every edge that has a
neighbour. Used by the plain reference render and by the counts.
"""

from __future__ import annotations

import dataclasses
import math


def lround(x: float) -> int:
    """C's lround: half away from zero."""
    return int(math.floor(abs(x) + 0.5)) * (1 if x >= 0 else -1)


@dataclasses.dataclass(frozen=True)
class Plan:
    """Tiles of one frame geometry: ``inputs`` are (y, x) origins of the
    input tiles in frame coordinates (may lie outside the frame),
    ``outputs`` (y, x) origins of the output tiles, ``ramps`` per tile
    (top, bottom, left, right) booleans: which edges blend."""

    frame_hw: tuple
    scale: int
    tile: int
    out_tile: int
    overlap_px: int
    inputs: tuple
    outputs: tuple
    ramps: tuple

    @property
    def count(self) -> int:
        return len(self.inputs)

    @property
    def out_hw(self) -> tuple:
        return (self.frame_hw[0] * self.scale, self.frame_hw[1] * self.scale)


def plan(frame_hw, tile: int, scale: int, offset: int,
         overlap: float) -> Plan:
    """The plan of an (H, W) frame for square ``tile`` input tiles of a
    model that loses ``offset`` output pixels a side."""
    h, w = frame_hw
    out_tile = tile * scale - 2 * offset
    full = tile * scale
    covered = lround(out_tile / full * tile)
    in_ov = lround(tile * overlap)
    out_ov = lround(full * overlap)
    step_in = covered - in_ov
    if out_tile <= 0 or step_in <= 0:
        raise ValueError(f"tile {tile} too small for offset {offset}")
    nx = max(1, math.ceil((w - in_ov) / step_in))
    ny = max(1, math.ceil((h - in_ov) / step_in))
    border = (tile - covered) // 2
    out_h, out_w = h * scale, w * scale
    inputs, outputs, ramps = [], [], []
    for i in range(nx):
        for j in range(ny):
            inputs.append((-border + j * step_in, -border + i * step_in))
            y, x = j * (out_tile - out_ov), i * (out_tile - out_ov)
            cw = min(out_tile, out_w - x)
            ch = min(out_tile, out_h - y)
            ramps.append((y > 0, y + ch < out_h, x > 0, x + cw < out_w))
            outputs.append((y, x))
    return Plan((h, w), scale, tile, out_tile, lround(full * overlap),
                tuple(inputs), tuple(outputs), tuple(ramps))


def ramp(overlap_px: int, length: int) -> list:
    """Weights from an edge inwards: (p + 1) / (overlap + 1) for the first
    ``overlap`` positions, 1 after them."""
    n = overlap_px + 1
    return [(p + 1) / n if p < overlap_px else 1.0 for p in range(length)]
