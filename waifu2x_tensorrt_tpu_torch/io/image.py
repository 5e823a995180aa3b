"""Still-image read/write (RGB uint8 HWC), alpha planes and image sizes.

The port's copy of ``waifu2x_tensorrt_tpu.io.image``. Pillow is imported
inside the functions: the render path itself never needs it, and a
machine without Pillow can still import the package.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def read_image(path: str | Path) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def read_rgba(path: str | Path) -> tuple[np.ndarray, np.ndarray | None]:
    """(rgb u8 HWC, alpha u8 HW or None when the image has no alpha).

    Alpha-channel extension: the reference never decodes alpha (its
    rawvideo pipes are rgb24; src/videoio/capture.cpp:55 carries a literal
    "TODO: ADD SUPPORT FOR ALPHA CHANNEL"). Covers RGBA/LA images and
    palette images with a transparency table. The RGB planes come back
    un-composited — transparent pixels keep their stored colors, which the
    render path replaces via ``fill_transparent`` before upscaling."""
    from PIL import Image

    with Image.open(path) as im:
        has_alpha = (
            im.mode in ("RGBA", "LA", "La", "PA")
            or "transparency" in im.info
        )
        if not has_alpha:
            return np.asarray(im.convert("RGB"), dtype=np.uint8), None
        rgba = np.asarray(im.convert("RGBA"), dtype=np.uint8)
    return np.ascontiguousarray(rgba[..., :3]), np.ascontiguousarray(
        rgba[..., 3])


def _box3(x: np.ndarray) -> np.ndarray:
    """3x3 box sum with zero padding (per-channel when 3-D)."""
    pad = ((1, 1), (1, 1)) + ((0, 0),) * (x.ndim - 2)
    p = np.pad(x, pad)
    h, w = x.shape[0], x.shape[1]
    out = np.zeros_like(x, dtype=np.float32)
    for dy in range(3):
        for dx in range(3):
            out += p[dy:dy + h, dx:dx + w]
    return out


def fill_transparent(rgb: np.ndarray, alpha: np.ndarray,
                     max_iters: int = 16) -> np.ndarray:
    """Bleed opaque colors into fully-transparent pixels (alpha == 0).

    Transparent pixels often store black/garbage RGB; upscaling them as-is
    blends that color across the alpha edge and produces dark halos once
    recomposited. Each iteration fills transparent pixels that touch a
    filled pixel with the 3x3 mean of their filled neighbours — a border
    bleed of ``max_iters`` px, covering the influence range that matters
    visually (the result only shows where upscaled alpha > 0). Opaque
    pixels are returned bit-identical; transparent pixels deeper than the
    bleed keep their stored colors (invisible at alpha 0). Work is
    cropped to the transparent region's bounding box (+bleed margin), so
    a small transparent patch on a 4K image costs the patch, not 4K."""
    known = alpha > 0
    if known.all() or not known.any():
        return rgb
    ty, tx = np.nonzero(~known)
    m = max_iters + 1
    y0 = max(int(ty.min()) - m, 0)
    y1 = min(int(ty.max()) + m + 1, alpha.shape[0])
    x0 = max(int(tx.min()) - m, 0)
    x1 = min(int(tx.max()) + m + 1, alpha.shape[1])
    kc = known[y0:y1, x0:x1]
    w = kc.astype(np.float32)
    out = rgb[y0:y1, x0:x1].astype(np.float32) * w[..., None]
    for _ in range(max_iters):
        ws = _box3(w)
        fill = (ws > 0) & ~(w > 0)
        if not fill.any():
            break
        out[fill] = _box3(out)[fill] / ws[fill][:, None]
        w[fill] = 1.0
    filled = (w > 0) & ~kc
    result = rgb.copy()
    crop = result[y0:y1, x0:x1]
    crop[filled] = np.clip(np.rint(out[filled]), 0, 255).astype(np.uint8)
    return result


def write_image(path: str | Path, rgb: np.ndarray) -> None:
    from PIL import Image

    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] not in (3, 4):
        raise ValueError(
            f"expected uint8 (H, W, 3|4), got {rgb.dtype} {rgb.shape}")
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(rgb, "RGBA" if rgb.shape[2] == 4 else "RGB").save(path)


def image_size(path: str | Path) -> tuple[int, int]:
    """(H, W) without decoding the full image."""
    from PIL import Image

    with Image.open(path) as im:
        w, h = im.size
    return h, w
