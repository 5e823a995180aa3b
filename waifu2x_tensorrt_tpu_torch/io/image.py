"""Still-image read/write (RGB uint8 HWC).

The port's copy of ``waifu2x_tensorrt_tpu.io.image.read_image`` /
``write_image``. Pillow is imported inside the functions: the render path
itself never needs it, and a machine without Pillow can still import the
package.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def read_image(path: str | Path) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def write_image(path: str | Path, rgb: np.ndarray) -> None:
    from PIL import Image

    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] not in (3, 4):
        raise ValueError(
            f"expected uint8 (H, W, 3|4), got {rgb.dtype} {rgb.shape}")
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(rgb, "RGBA" if rgb.shape[2] == 4 else "RGB").save(path)
