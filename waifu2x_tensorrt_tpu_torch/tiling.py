"""Pure tile-geometry math: tile grids and seam blend weights.

A copy of ``waifu2x_tensorrt_tpu.tiling`` (the JAX package's ``__init__``
imports jax, so the port keeps its own): numpy for the plans, and the
8-way dihedral TTA transforms on numpy arrays and torch tensors.

Reference semantics reproduced here:
- ``calculate_tiles``  ≙ ``calculateTiles``  (src/tensorrt/img2img_render.cpp:7-66)
- ``tile_weight_ramps``≙ ``createTileWeights``(src/tensorrt/img2img_load.cpp:29-52)
  + the per-edge application conditions of ``applyWeights``
  (src/tensorrt/img2img_render.cpp:107-121)

Documented divergences from the reference (see SURVEY.md §5 "Known reference
bugs"):
- reference computes ``scaledOutputTileSize.height`` from the tile *width*
  (img2img_render.cpp:11-14); harmless there because tiles are square. We
  compute height from height. Identical results for every reachable config.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = [
    "DIHEDRAL_SHAPE_PRESERVING",
    "DIHEDRAL_SIZE",
    "DIHEDRAL_TRANSPOSING",
    "Rect",
    "TilePlan",
    "calculate_tiles",
    "dihedral_apply",
    "dihedral_inverse",
    "plan_tiles",
    "tile_weight_ramps",
]


def _lround(x: float) -> int:
    """C++ std::lround: round half away from zero."""
    return int(math.floor(x + 0.5)) if x >= 0 else -int(math.floor(-x + 0.5))


@dataclasses.dataclass(frozen=True)
class Rect:
    """Integer rectangle, (x, y) top-left origin, matching cv::Rect2i."""

    x: int
    y: int
    width: int
    height: int


def calculate_tiles(
    input_size: tuple[int, int],
    output_size: tuple[int, int],
    input_tile_size: tuple[int, int],
    output_tile_size: tuple[int, int],
    scaling: int,
    overlap: tuple[float, float],
) -> tuple[int, list[Rect], list[Rect]]:
    """Compute the tile decomposition of an image.

    Args:
      input_size: (W, H) of the input image.
      output_size: (W, H) of the output canvas (input * scaling).
      input_tile_size: (w, h) the model's input tensor spatial size.
      output_tile_size: (w, h) the model's output tensor spatial size. For
        models with valid-conv context shrink (cunet) this is smaller than
        ``input_tile * scaling``.
      scaling: integer upscale factor.
      overlap: (x, y) fractional tile overlap used for seam blending.

    Returns:
      (tile_count, input_rects, output_rects). ``input_rects`` may extend
      beyond the input image (negative origins / overhang); the consumer must
      edge-replicate pad. ``output_rects`` are clamped to the output canvas.
      Ordering matches the reference: x-major (column i outer loop, row j
      inner loop), img2img_render.cpp:43-63.
    """
    in_w, in_h = input_size
    out_w, out_h = output_size
    tin_w, tin_h = input_tile_size
    tout_w, tout_h = output_tile_size

    # The "ideal" output tile if the model had no context shrink.
    scaled_out_w = tin_w * scaling
    scaled_out_h = tin_h * scaling

    # The input-space footprint actually covered by one output tile.
    scaled_in_w = _lround(tout_w / scaled_out_w * tin_w)
    scaled_in_h = _lround(tout_h / scaled_out_h * tin_h)

    in_ov_x = _lround(tin_w * overlap[0])
    in_ov_y = _lround(tin_h * overlap[1])
    scaled_out_ov_x = _lround(scaled_out_w * overlap[0])
    scaled_out_ov_y = _lround(scaled_out_h * overlap[1])

    # A context shrink (cunet: offset 28/36 px per side) plus the blend
    # overlap can consume a too-small tile entirely: stride <= 0 would
    # divide by zero below (or emit zero-size output rects -> silently
    # blank canvases). Name the real constraint instead.
    if tout_w <= 0 or tout_h <= 0 \
            or scaled_in_w - in_ov_x <= 0 or scaled_in_h - in_ov_y <= 0:
        raise ValueError(
            f"tile {input_tile_size} is too small for this model: the "
            f"context shrink leaves an output tile of {output_tile_size} "
            f"and a stride of ({scaled_in_w - in_ov_x}, "
            f"{scaled_in_h - in_ov_y}) after the blend overlap "
            f"{overlap}; use a larger tile size")

    # Clamp to >=1: for images smaller than the overlap the reference's
    # ceil((in - ov)/(stride)) goes to 0 and it renders nothing
    # (img2img_render.cpp:31-34 — latent edge-case bug, not replicated).
    tiles_x = max(1, math.ceil((in_w - in_ov_x) / (scaled_in_w - in_ov_x)))
    tiles_y = max(1, math.ceil((in_h - in_ov_y) / (scaled_in_h - in_ov_y)))
    tile_count = tiles_x * tiles_y

    input_rects: list[Rect] = []
    output_rects: list[Rect] = []
    # Centered context border: the input tile extends (tin - scaled_in)/2
    # beyond its covered footprint on each side (C++ int division).
    border_x = (tin_w - scaled_in_w) // 2
    border_y = (tin_h - scaled_in_h) // 2
    for i in range(tiles_x):
        for j in range(tiles_y):
            input_rects.append(
                Rect(
                    -border_x + i * scaled_in_w - i * in_ov_x,
                    -border_y + j * scaled_in_h - j * in_ov_y,
                    tin_w,
                    tin_h,
                )
            )
            x = i * tout_w - i * scaled_out_ov_x
            y = j * tout_h - j * scaled_out_ov_y
            output_rects.append(
                Rect(
                    x,
                    y,
                    out_w - x if x + tout_w > out_w else tout_w,
                    out_h - y if y + tout_h > out_h else tout_h,
                )
            )

    return tile_count, input_rects, output_rects


def tile_weight_ramps(
    overlap_px: tuple[int, int],
    tile_size: tuple[int, int],
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Build the 1-D blend ramps for the four tile edges.

    The reference builds four full-tile 2-D fp32 masks
    (createTileWeights, img2img_load.cpp:29-52); because top/bottom masks vary
    only along rows and left/right only along columns, they factor exactly
    into 1-D ramps, which is what the TPU renderer consumes (outer product in
    the graph instead of 3 full-tile multiplies).

    Ramp law (img2img_load.cpp:33-45): with ``n = overlap + 1``, position
    ``p`` (0-based from the edge) gets weight ``(p + 1) / n`` for
    ``p < overlap`` and 1 beyond.

    Returns (top, bottom, left, right) ramps: top/bottom of length tile_h,
    left/right of length tile_w, float32.
    """
    ov_x, ov_y = overlap_px
    tw, th = tile_size

    def ramp(n_over: int, length: int) -> np.ndarray:
        w = np.ones(length, dtype=np.float32)
        n = n_over + 1
        for p in range(min(n_over, length)):
            w[p] = np.float32((p + 1) / n)
        return w

    top = ramp(ov_y, th)
    left = ramp(ov_x, tw)
    bottom = top[::-1].copy()
    right = left[::-1].copy()
    return top, bottom, left, right


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """Fully resolved per-frame tiling plan consumed by the jitted renderer.

    All arrays are host-side constants baked into the traced program:
      pad:             (top, bottom, left, right) edge-replicate padding of the
                       input frame so every input rect becomes a plain slice.
      input_origins:   (T, 2) int32 (y, x) origins into the *padded* input.
      output_origins:  (T, 2) int32 (y, x) origins into the *padded* output
                       canvas.
      row_weights:     (T, tile_out_h) float32 per-tile row blend ramp.
      col_weights:     (T, tile_out_w) float32 per-tile column blend ramp.
      canvas_size:     (H, W) of the padded output accumulation canvas; the
                       real output is its [0:out_h, 0:out_w] corner.
    """

    tile_count: int
    input_tile: tuple[int, int]  # (h, w)
    output_tile: tuple[int, int]  # (h, w)
    pad: tuple[int, int, int, int]
    input_origins: np.ndarray
    output_origins: np.ndarray
    row_weights: np.ndarray
    col_weights: np.ndarray
    canvas_size: tuple[int, int]
    output_size: tuple[int, int]  # (H, W) true output


def plan_tiles(
    input_hw: tuple[int, int],
    input_tile_hw: tuple[int, int],
    output_tile_hw: tuple[int, int],
    scaling: int,
    overlap: tuple[float, float],
) -> TilePlan:
    """Resolve the complete render-time tiling plan for one frame geometry.

    Combines calculate_tiles + blend-weight conditions
    (applyWeights, img2img_render.cpp:107-121: a ramp is applied on an edge
    only when the tile has a neighbour on that side) into renderer-ready
    constants. The output canvas is padded to the maximum tile extent so the
    scatter-add never clamps; contributions past the true output land in the
    pad margin and are cropped (equivalent to the reference's rect clamping,
    img2img_render.cpp:56-61, 329-330).
    """
    in_h, in_w = input_hw
    tin_h, tin_w = input_tile_hw
    tout_h, tout_w = output_tile_hw
    out_w, out_h = in_w * scaling, in_h * scaling

    tile_count, input_rects, output_rects = calculate_tiles(
        (in_w, in_h),
        (out_w, out_h),
        (tin_w, tin_h),
        (tout_w, tout_h),
        scaling,
        overlap,
    )

    # Input padding: one global edge-replicate pad so all rects are in-bounds.
    pad_left = max(0, max(-r.x for r in input_rects))
    pad_top = max(0, max(-r.y for r in input_rects))
    pad_right = max(0, max(r.x + r.width - in_w for r in input_rects))
    pad_bottom = max(0, max(r.y + r.height - in_h for r in input_rects))

    input_origins = np.array(
        [(r.y + pad_top, r.x + pad_left) for r in input_rects], dtype=np.int32
    )

    canvas_h = max(out_h, max(r.y + tout_h for r in output_rects))
    canvas_w = max(out_w, max(r.x + tout_w for r in output_rects))
    output_origins = np.array(
        [(r.y, r.x) for r in output_rects], dtype=np.int32
    )

    # Blend ramps, sized/positioned as in the reference: the ramp length is
    # derived from inputTile*scaling*overlap (img2img_load.cpp:262-265) even
    # when the model's output tile is smaller (cunet).
    ov_x = _lround(tin_w * scaling * overlap[0])
    ov_y = _lround(tin_h * scaling * overlap[1])
    top, bottom, left, right = tile_weight_ramps((ov_x, ov_y), (tout_w, tout_h))

    row_weights = np.ones((tile_count, tout_h), dtype=np.float32)
    col_weights = np.ones((tile_count, tout_w), dtype=np.float32)
    for t, r in enumerate(output_rects):
        # applyWeights conditions, img2img_render.cpp:110-120 (srcRect is the
        # clamped output rect, dstRect the true output rect).
        if r.x > 0:
            col_weights[t] *= left
        if r.y > 0:
            row_weights[t] *= top
        if r.x + r.width < out_w:
            col_weights[t] *= right
        if r.y + r.height < out_h:
            row_weights[t] *= bottom

    return TilePlan(
        tile_count=tile_count,
        input_tile=(tin_h, tin_w),
        output_tile=(tout_h, tout_w),
        pad=(pad_top, pad_bottom, pad_left, pad_right),
        input_origins=input_origins,
        output_origins=output_origins,
        row_weights=row_weights,
        col_weights=col_weights,
        canvas_size=(canvas_h, canvas_w),
        output_size=(out_h, out_w),
    )


# ---------------------------------------------------------------------------
# 8-way dihedral test-time augmentation.
#
# Reference enum (img2img_render.cpp:123-132) with OpenCV call semantics:
#   None                    identity
#   FlipHorizontal          cv flip code 0  -> flip rows      (np.flipud)
#   FlipVertical            cv flip code 1  -> flip columns   (np.fliplr)
#   Rotate90                cv rotate 90 CCW                  (rot90 k=1)
#   Rotate180                                                  (rot90 k=2)
#   Rotate270                                                  (rot90 k=3)
#   FlipHorizontalRotate90  flip rows, then rotate 90
#   FlipVerticalRotate90    flip cols, then rotate 90
# The 8 elements are the dihedral group D4: exact permutations, each
# inverse below round-trips.
# ---------------------------------------------------------------------------

DIHEDRAL_SIZE = 8

# Partition of D4 by shape action on a rectangular (H, W) image: the first
# four transforms preserve (H, W); the rot90 family transposes to (W, H).
# The rect-TTA render path batches each group at its own orientation.
DIHEDRAL_SHAPE_PRESERVING = (0, 1, 2, 4)
DIHEDRAL_TRANSPOSING = (3, 5, 6, 7)

# (flip_rows, flip_cols, rot90_k) applied in that order: flips first, then
# rotation, as applyAugmentation composes them.
_DIHEDRAL_FWD: tuple[tuple[bool, bool, int], ...] = (
    (False, False, 0),  # None
    (True, False, 0),  # FlipHorizontal (row flip)
    (False, True, 0),  # FlipVertical (col flip)
    (False, False, 1),  # Rotate90
    (False, False, 2),  # Rotate180
    (False, False, 3),  # Rotate270
    (True, False, 1),  # FlipHorizontalRotate90
    (False, True, 1),  # FlipVerticalRotate90
)


def _flip(img, axis: int):
    if isinstance(img, np.ndarray):
        return np.flip(img, axis=axis)
    return img.flip(axis)


def _rot90(img, k: int):
    """Rotate the (H, W) axes of an (..., H, W, C) array by k * 90 degrees
    counter-clockwise (np.rot90's sense on axes (-3, -2))."""
    if isinstance(img, np.ndarray):
        return np.rot90(img, k=k, axes=(-3, -2))
    return img.rot90(k, dims=(-3, -2))


def dihedral_apply(img, index: int):
    """Apply TTA transform ``index`` to an (..., H, W, C) numpy array or
    torch tensor. ``DIHEDRAL_TRANSPOSING`` indices turn (H, W) into
    (W, H)."""
    flip_r, flip_c, k = _DIHEDRAL_FWD[index]
    if flip_r:
        img = _flip(img, -3)
    if flip_c:
        img = _flip(img, -2)
    if k:
        img = _rot90(img, k)
    return img


def dihedral_inverse(img, index: int):
    """Exact inverse of ``dihedral_apply(., index)``: the rotation undone
    first, then the flip (reverseAugmentation, img2img_render.cpp:179-222)."""
    flip_r, flip_c, k = _DIHEDRAL_FWD[index]
    if k:
        img = _rot90(img, 4 - k)
    if flip_c:
        img = _flip(img, -2)
    if flip_r:
        img = _flip(img, -3)
    return img
