"""The port's alpha-plane helpers (``io/image.py``: ``read_rgba``,
``_box3``, ``fill_transparent``, ``image_size``) against the JAX
package's, byte for byte, on seeded inputs, on the CPU. The CLI's
``--alpha auto`` render is held against the JAX CLI's in
``tests/test_torch_io_cli.py``.
"""

import numpy as np
import pytest
from PIL import Image

from waifu2x_tensorrt_tpu.io import image as jimage
from waifu2x_tensorrt_tpu_torch.io import image


def _save(path, mode, seed):
    rng = np.random.default_rng(seed)
    if mode == "P":
        im = Image.new("P", (7, 5), 1)
        im.putpalette([0, 0, 0, 200, 30, 40] + [0] * (256 * 3 - 6))
        im.putpixel((2, 3), 0)
        im.save(path, transparency=0)
        return
    channels = {"RGB": 3, "RGBA": 4, "LA": 2, "L": 1}[mode]
    a = rng.integers(0, 256, (9, 11, channels), np.uint8)
    Image.fromarray(a[..., 0] if channels == 1 else a, mode).save(path)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "LA", "L", "P"])
def test_read_rgba_equals_the_reference(tmp_path, mode):
    p = tmp_path / f"{mode}.png"
    _save(p, mode, seed=len(mode))
    (rgb, a), (jrgb, ja) = image.read_rgba(p), jimage.read_rgba(p)
    np.testing.assert_array_equal(rgb, jrgb)
    assert rgb.flags.c_contiguous and rgb.dtype == np.uint8
    assert (a is None) == (ja is None) == (mode in ("RGB", "L"))
    if a is not None:
        np.testing.assert_array_equal(a, ja)
        assert a.flags.c_contiguous
    assert image.image_size(p) == jimage.image_size(p) == rgb.shape[:2]


def _alpha(kind, rng, h, w):
    a = np.full((h, w), 255, np.uint8)
    if kind == "binary":
        a = rng.integers(0, 2, (h, w), np.uint8) * 255
    elif kind == "half":
        a[:, w // 2:] = 0
    elif kind == "patch":
        a[h // 2:h // 2 + 5, w // 3:w // 3 + 7] = 0
    elif kind == "soft":
        a = rng.integers(0, 256, (h, w), np.uint8)
        a[a < 128] = 0
    elif kind == "one_opaque":
        a[:] = 0
        a[0, 0] = 255
    elif kind == "transparent":
        a[:] = 0
    return a


@pytest.mark.parametrize("kind,max_iters", [
    ("binary", 16), ("half", 16), ("patch", 16), ("soft", 16),
    ("one_opaque", 4), ("one_opaque", 16), ("opaque", 16),
    ("transparent", 16)])
def test_fill_transparent_equals_the_reference(kind, max_iters):
    rng = np.random.default_rng(len(kind) * 31 + max_iters)
    rgb = rng.integers(0, 256, (40, 52, 3), np.uint8)
    a = _alpha(kind, rng, 40, 52)
    got = image.fill_transparent(rgb, a, max_iters=max_iters)
    want = jimage.fill_transparent(rgb, a, max_iters=max_iters)
    assert got.dtype == want.dtype == np.uint8
    assert got.tobytes() == want.tobytes()
    np.testing.assert_array_equal(got[a > 0], rgb[a > 0])  # opaque kept


@pytest.mark.parametrize("shape", [(6, 7), (6, 7, 3)])
def test_box3_equals_the_reference(shape):
    x = np.random.default_rng(7).random(shape).astype(np.float32)
    assert image._box3(x).tobytes() == jimage._box3(x).tobytes()


def test_write_rgba_roundtrip(tmp_path):
    rgba = np.random.default_rng(3).integers(0, 256, (4, 5, 4), np.uint8)
    image.write_image(tmp_path / "o.png", rgba)
    rgb, a = image.read_rgba(tmp_path / "o.png")
    np.testing.assert_array_equal(rgb, rgba[..., :3])
    np.testing.assert_array_equal(a, rgba[..., 3])
