"""TTA, rect TTA, whole-frame tiles and bucketing of the PyTorch port on
the CPU against the JAX package's ``ChunkedPipeline`` at equal chunk
shapes.

- probe models whose arithmetic is exact in both frameworks (nearest
  upsample times a position-dependent mask of small integers over 64, so
  not dihedral-equivariant, with an optional cunet-like context crop):
  the port's square-TTA, rect-TTA and whole-frame renders are
  byte-identical to the JAX pipeline's, in fp32 and bf16;
- a small swin_unet (base_dim 32) with seeded weights read by both
  packages: square TTA, rect TTA and whole-frame through the golden gate
  (max <= 2 LSB, <= 1e-4 of values changed);
- TileStream under TTA, with bucketing and crop (``Upscaler.open_stream``):
  byte-identical to per-frame renders; ``open_stream`` is None for a
  rect-TTA geometry and refuses other frame sizes;
- ``bucket_frame`` equals the JAX package's on numpy and on torch.
"""

import flax.linen as fnn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waifu2x_tensorrt_tpu.engine import renderer as jrenderer
from waifu2x_tensorrt_tpu.engine.config import Precision as JPrecision
from waifu2x_tensorrt_tpu.engine.config import RenderConfig as JRenderConfig
from waifu2x_tensorrt_tpu.models import registry as jreg
from waifu2x_tensorrt_tpu_torch.engine.config import Precision, RenderConfig
from waifu2x_tensorrt_tpu_torch.engine.renderer import (
    ChunkedPipeline,
    TileStream,
    bucket_frame,
    make_chunked_fns,
)
from waifu2x_tensorrt_tpu_torch.engine.upscaler import Upscaler
from waifu2x_tensorrt_tpu_torch.models import registry as treg

SMALL = {"base_dim": 32, "depths": (1, 1, 2, 1, 1)}


class JaxProbe(fnn.Module):
    """Nearest upsample x (r % 7 + 1)(c % 5 + 1) / 64 over the OUTPUT
    position, then a center crop of ``offset``: exact in fp32, and every
    step rounds once in bf16, in both frameworks."""

    scale: int
    offset: int = 0

    @fnn.compact
    def __call__(self, x):
        y = jnp.repeat(jnp.repeat(x, self.scale, axis=1), self.scale, axis=2)
        r = (jnp.arange(y.shape[1]) % 7 + 1).astype(y.dtype)
        c = (jnp.arange(y.shape[2]) % 5 + 1).astype(y.dtype)
        y = y * r[None, :, None, None] * c[None, None, :, None]
        y = y * jnp.asarray(1 / 64, y.dtype)
        o = self.offset
        return y[:, o:-o, o:-o, :] if o else y


class TorchProbe(torch.nn.Module):
    def __init__(self, scale: int, offset: int = 0):
        super().__init__()
        self.scale, self.offset = scale, offset

    def forward(self, x):
        s, o = self.scale, self.offset
        y = x.repeat_interleave(s, dim=1).repeat_interleave(s, dim=2)
        r = (torch.arange(y.shape[1]) % 7 + 1).to(y.dtype)
        c = (torch.arange(y.shape[2]) % 5 + 1).to(y.dtype)
        y = y * r[None, :, None, None] * c[None, None, :, None]
        y = y * torch.tensor(1 / 64, dtype=y.dtype)
        return y[:, o:-o, o:-o, :] if o else y


def _cfgs(tile, batch, scale, tta, precision="tf32", blend=1 / 16):
    kw = dict(batch_size=batch, height=tile, width=tile, scaling=scale,
              overlap=(blend, blend), tta=tta)
    return (RenderConfig(precision=Precision(precision), **kw),
            JRenderConfig(precision=JPrecision(precision), **kw))


def _specs(scale, offset=0, divisor=1):
    tspec = treg.ModelSpec("probe/test", scale, -1, offset=offset,
                           tile_divisor=divisor)
    jspec = jreg.ModelSpec("probe/test", scale, -1, offset=offset,
                           tile_divisor=divisor)
    return tspec, jspec


@pytest.mark.parametrize("hw,tile,batch,scale,offset,tta,precision", [
    ((40, 56), 32, 3, 2, 0, True, "tf32"),   # square TTA, 4 tiles x 8
    ((40, 56), 32, 5, 2, 0, True, "fp16"),   # bf16 tiles and inverses
    ((30, 22), 32, 4, 2, 6, True, "tf32"),   # offset model under TTA
    ((24, 40), 0, 3, 2, 0, True, "tf32"),    # rect TTA: 2 x 2 chunks
    ((24, 40), 0, 4, 2, 0, True, "fp16"),    # rect TTA, bf16
    ((40, 24), 0, 3, 2, 6, True, "tf32"),    # rect TTA, offset, tall
    ((37, 53), 0, 2, 2, 6, False, "tf32"),   # whole frame, offset context
    ((33, 33), 0, 1, 4, 0, True, "tf32"),    # square whole frame + TTA
])
def test_probe_render_byte_identical_to_jax(hw, tile, batch, scale, offset,
                                            tta, precision):
    cfg, jcfg = _cfgs(tile, batch, scale, tta, precision)
    tspec, jspec = _specs(scale, offset, divisor=4 if offset else 1)
    frame = np.random.default_rng(sum(hw)).integers(0, 256, (*hw, 3),
                                                    np.uint8)
    jpl = jrenderer.ChunkedPipeline(JaxProbe(scale, offset), jspec, jcfg)
    want = np.asarray(jpl.render({}, jnp.asarray(frame)))
    pl = ChunkedPipeline(TorchProbe(scale, offset), tspec, cfg, "cpu")
    prep, _fin, plan, _n = pl.get(hw)
    jprep, _jf, jplan, _jn = jpl.get(hw)
    # equal chunk shapes: sizes and orientations, chunk by chunk
    assert plan.input_tile == jplan.input_tile
    assert [tuple(c.shape) for c in prep(torch.from_numpy(frame))] == \
        [tuple(c.shape) for c in jprep(jnp.asarray(frame))]
    got = pl.render(frame).numpy()
    assert got.shape == want.shape == (hw[0] * scale, hw[1] * scale, 3)
    np.testing.assert_array_equal(got, want)


def test_tta_is_not_the_plain_render():
    """The probe is not dihedral-equivariant: TTA changes the frame, so the
    byte-identity above pins the variant order and the inverses."""
    cfg_tta, _ = _cfgs(32, 3, 2, True)
    cfg, _ = _cfgs(32, 3, 2, False)
    spec, _ = _specs(2)
    frame = np.random.default_rng(4).integers(0, 256, (40, 56, 3), np.uint8)
    a = ChunkedPipeline(TorchProbe(2), spec, cfg_tta, "cpu").render(frame)
    b = ChunkedPipeline(TorchProbe(2), spec, cfg, "cpu").render(frame)
    assert (a != b).float().mean() > 0.5


def test_tta_rejects_packed_heads():
    cfg, _ = _cfgs(64, 2, 2, True)
    spec = treg.ModelSpec("swin_unet/art", 2, -1, offset=0, tile_divisor=1,
                          pack_x=16)
    with pytest.raises(ValueError, match="packed heads"):
        make_chunked_fns(spec, cfg, (64, 64), "cpu")


@pytest.fixture(scope="module")
def small_swin(tmp_path_factory):
    """JAX module, seeded N(0, 0.02) params of a small swin_unet
    (``init_params_host``), and a models dir holding them (the port builds
    its module from the file)."""
    module, _ = jreg.create_model("swin_unet/art", 2, -1, **SMALL)
    params = jreg.init_params_host(module, tile=64, seed=0)
    root = tmp_path_factory.mktemp("models")
    jreg.save_params(jreg.weights_path(root, "swin_unet/art", 2, -1), params)
    return module, params, root


def _gate(got, want, max_tol=2, frac_tol=1e-4):
    diff = np.abs(got.astype(int) - want.astype(int))
    frac = float((diff > 0).mean())
    return diff.max() <= max_tol and frac <= frac_tol, (diff.max(), frac)


@pytest.mark.parametrize("hw,tile,batch,tta", [
    ((48, 48), 32, 4, True),   # square TTA, 4 tiles x 8 variants
    ((24, 40), 0, 3, True),    # rect TTA
    ((40, 56), 0, 2, False),   # whole frame
])
def test_small_swin_matches_jax_pipeline(small_swin, hw, tile, batch, tta):
    module, params, root = small_swin
    cfg, jcfg = _cfgs(tile, batch, 2, tta)
    frame = np.random.default_rng(2).integers(0, 256, (*hw, 3), np.uint8)
    spec = jreg.get_spec("swin_unet/art", 2, -1)
    want = np.asarray(jrenderer.ChunkedPipeline(module, spec, jcfg).render(
        params, jnp.asarray(frame)))
    up = Upscaler(models_dir=root, device="cpu")
    up.load("swin_unet/art", 2, -1, cfg)
    ok, msg = _gate(up.render(frame), want)
    assert ok, msg


@pytest.mark.parametrize("hw,tile,batch,bucket", [
    ((40, 56), 32, 5, 0),     # 4 tiles x 8 = 32 steps: frames straddle
    ((37, 45), 32, 6, 16),    # bucketed to 48 x 48, outputs cropped
    ((30, 30), 0, 3, 0),      # square whole frame, 8 steps a frame
])
def test_tta_stream_equals_per_frame(hw, tile, batch, bucket):
    cfg, _ = _cfgs(tile, batch, 2, True)
    spec, _ = _specs(2)
    up = Upscaler(device="cpu")
    # the probe in place of a network: load's pipeline, then the probe
    up._spec = spec
    up._bucket = bucket
    up._pipeline = ChunkedPipeline(TorchProbe(2), spec, cfg, "cpu")
    rng = np.random.default_rng(6)
    frames = [rng.integers(0, 256, (*hw, 3), np.uint8) for _ in range(3)]
    per_frame = [up.render(f) for f in frames]
    stream = up.open_stream(hw)
    got = []
    for f in frames:
        got.extend(o.numpy() for o in stream.submit(f))
    got.extend(o.numpy() for o in stream.flush())
    assert len(got) == 3
    for g, w in zip(got, per_frame):
        assert g.shape == (hw[0] * 2, hw[1] * 2, 3)
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="stream expects"):
        stream.submit(np.zeros((hw[0] + 1, hw[1], 3), np.uint8))


def test_rect_tta_has_no_stream():
    cfg, _ = _cfgs(0, 2, 2, True)
    spec, _ = _specs(2)
    up = Upscaler(device="cpu")
    up._spec, up._pipeline = spec, ChunkedPipeline(TorchProbe(2), spec, cfg,
                                                   "cpu")
    assert up.can_stream
    assert up.open_stream((24, 40)) is None
    assert up.open_stream((24, 24)) is not None  # square whole frame
    with pytest.raises(ValueError, match="rectangular-TTA"):
        TileStream(up._pipeline, (24, 40))
    assert up.render(np.zeros((24, 40, 3), np.uint8)).shape == (48, 80, 3)


@pytest.mark.parametrize("hw,bucket", [((37, 45), 16), ((32, 48), 16),
                                       ((5, 3), 4), ((9, 9), 0)])
def test_bucket_frame_equals_jax(hw, bucket):
    frame = np.random.default_rng(1).integers(0, 256, (*hw, 3), np.uint8)
    want, want_hw = jrenderer.bucket_frame(frame, bucket)
    got, got_hw = bucket_frame(frame, bucket)
    assert got_hw == want_hw == hw
    np.testing.assert_array_equal(got, want)
    got_t, _ = bucket_frame(torch.from_numpy(frame), bucket)
    np.testing.assert_array_equal(got_t.numpy(), want)


def test_bucketed_render_crops_back(small_swin):
    """render with a bucket: the frame is padded, rendered and cropped to
    (H*s, W*s); the crop equals the padded frame's render's corner."""
    _m, _p, root = small_swin
    cfg, _ = _cfgs(32, 4, 2, False)
    up = Upscaler(models_dir=root, device="cpu")
    up.load("swin_unet/art", 2, -1, cfg, bucket=16)
    frame = np.random.default_rng(3).integers(0, 256, (37, 45, 3), np.uint8)
    got = up.render(frame)
    assert got.shape == (74, 90, 3)
    up.load("swin_unet/art", 2, -1, cfg)
    padded, _ = bucket_frame(frame, 16)
    np.testing.assert_array_equal(got, up.render(padded)[:74, :90])
