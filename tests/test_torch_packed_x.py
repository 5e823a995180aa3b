"""The packed-x head path of the port on the CPU, against its own pixel
path and the JAX package's packed-x path (``tests/test_renderer.py::
test_packed_x_pipeline_matches_pixel`` and ``tests/test_pallas_ops.py``
are the JAX package's own checks).

- ``SwinUNet`` with the packed-x head (base_dim 32, depths (2, 2, 2, 2, 2),
  tile 64, scales 2 and 4) gives the bytes of the pixel head, and the JAX
  ``SwinUNet(packed_x_head=True)`` within the full-model fp32 atol 3e-5 of
  ``tests/test_pallas_ops.py`` (6.2e-6 seen: flax's LayerNorm takes the
  fast variance, the port the two-pass form); unaligned widths raise;
- the twin holds the pixel module's parameter objects;
- the packed-x ``ChunkedPipeline`` at blend 0 gives the pixel pipeline's
  bytes and the JAX packed-x pipeline's within the golden gate; with a
  stand-in model (nearest upsampling, packed) both pipelines see the same
  chunk outputs and must agree byte for byte, blend ramps included;
- blend 1/16 at tile 32 routes to the pixel module;
- a ``TileStream`` through the twin equals its per-frame renders;
- ``Upscaler(device="cpu")`` with ``WAIFU2X_PACK_X=1`` builds the twin and
  renders the bytes it renders without it.
"""

import dataclasses

import flax.linen as fnn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waifu2x_tensorrt_tpu.engine.config import Precision as JPrecision
from waifu2x_tensorrt_tpu.engine.config import RenderConfig as JRenderConfig
from waifu2x_tensorrt_tpu.engine.renderer import (
    ChunkedPipeline as JChunkedPipeline,
)
from waifu2x_tensorrt_tpu.models import registry as jreg
from waifu2x_tensorrt_tpu.models.swin_unet import SwinUNet as FlaxSwinUNet
from waifu2x_tensorrt_tpu_torch.engine.config import Precision, RenderConfig
from waifu2x_tensorrt_tpu_torch.engine.renderer import (
    ChunkedPipeline,
    TileStream,
)
from waifu2x_tensorrt_tpu_torch.engine.upscaler import Upscaler
from waifu2x_tensorrt_tpu_torch.models import registry as treg

SMALL = dict(base_dim=32, depths=(2, 2, 2, 2, 2))


def _cfg(tile, batch, scale, blend, cls=RenderConfig, prec=Precision):
    return cls(precision=prec.TF32, batch_size=batch, height=tile,
               width=tile, scaling=scale, overlap=(blend, blend))


def _jcfg(*args):
    return _cfg(*args, cls=JRenderConfig, prec=JPrecision)


def _gate(got, ref, max_tol=2, frac_tol=1e-4):
    diff = np.abs(got.astype(int) - ref.astype(int))
    frac = float((diff > 0).mean())
    return diff.max() <= max_tol and frac <= frac_tol, (diff.max(), frac)


def _frame(hw, seed):
    return np.random.default_rng(seed).integers(0, 256, (*hw, 3), np.uint8)


@pytest.fixture(scope="module")
def small_models():
    """Per scale: flax module + params, and the port's pixel module and
    packed twin holding the same (bridged) weights."""
    out = {}
    for scale in (2, 4):
        fmod = FlaxSwinUNet(scale=scale, **SMALL)
        params = jreg.init_params(fmod, tile=32, seed=scale)
        pix, spec = treg.create_model("swin_unet/art", scale, -1, **SMALL)
        treg.load_into(pix, jreg._flatten(params))
        twin, spec_px = treg.packed_x_twin(pix, spec)
        out[scale] = (fmod, params, pix, spec, twin, spec_px)
    return out


@pytest.mark.parametrize("scale", [2, 4])
def test_packed_head_matches_pixel_and_flax(small_models, scale):
    fmod, params, pix, _spec, twin, _spx = small_models[scale]
    x = np.random.default_rng(scale).random((2, 64, 64, 3)).astype(
        np.float32)
    with torch.no_grad():
        got = twin(torch.tensor(x))
        want_pix = pix(torch.tensor(x))
    assert tuple(got.shape) == (2, 64 * scale, 64 * scale // 16, 48)
    assert got.numpy().tobytes() == want_pix.numpy().tobytes()
    fpx = FlaxSwinUNet(scale=scale, packed_x_head=True, **SMALL)
    want = np.array(fpx.apply({"params": params}, jnp.array(x)))
    assert want.shape == tuple(got.shape)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5, rtol=0)


def test_packed_head_rejects_unaligned_width(small_models):
    _f, _p, pix, _s, twin, _spx = small_models[2]
    with torch.no_grad(), pytest.raises(ValueError, match="16"):
        twin(torch.rand(1, 32, 36, 3))  # 36 * 2 % 16 != 0
    unclamped = twin.packed_x_twin()
    unclamped.clamp = False
    with torch.no_grad(), pytest.raises(ValueError, match="clamp"):
        unclamped(torch.rand(1, 32, 32, 3))
    assert pix.clamp  # the twin's own flags stay its own


def test_twin_shares_parameters(small_models):
    _f, _p, pix, spec, twin, spec_px = small_models[2]
    assert spec.pack_x == 1 and spec_px.pack_x == 16
    assert dataclasses.replace(spec_px, pack_x=1) == spec
    assert not pix.packed_x_head and twin.packed_x_head
    pairs = list(zip(pix.state_dict().items(), twin.state_dict().items()))
    assert len(pairs) == len(pix.state_dict())
    for (ka, a), (kb, b) in pairs:
        assert ka == kb and a.data_ptr() == b.data_ptr()
    assert all(a is b for a, b in zip(pix.parameters(), twin.parameters()))
    # the registry's own packed model has the twin's head and spec
    m, s = treg.create_model("swin_unet/art", 2, -1, packed_x_head=True,
                             **SMALL)
    assert m.packed_x_head and s == spec_px
    m1, s1 = treg.create_model("swin_unet/art", 1, 0, packed_x_head=True,
                               **SMALL)
    assert not m1.packed_x_head and s1.pack_x == 1  # scale 1: no pack


def test_pipeline_blend0_matches_pixel_and_jax(small_models):
    fmod, params, pix, spec, twin, spec_px = small_models[2]
    frame = _frame((70, 96), 9)
    # blend 0 -> output x-origins are multiples of 64: pack-aligned
    want = ChunkedPipeline(pix, spec, _cfg(32, 2, 2, 0.0), "cpu").render(
        frame).numpy()
    pl = ChunkedPipeline(pix, spec, _cfg(32, 2, 2, 0.0), "cpu",
                         module_pack_x=twin, spec_pack_x=spec_px)
    prep = pl.get(frame.shape[:2])[0]
    assert prep.use_pack_x, "aligned geometry should use the packed twin"
    got = pl.render(frame).numpy()
    np.testing.assert_array_equal(got, want)

    jspec = jreg.get_spec("swin_unet/art", 2, -1)
    jpl = JChunkedPipeline(
        fmod, jspec, _jcfg(32, 2, 2, 0.0),
        module_pack_x=FlaxSwinUNet(scale=2, packed_x_head=True, **SMALL),
        spec_pack_x=dataclasses.replace(jspec, pack_x=16))
    assert jpl.get(frame.shape[:2])[0].use_pack_x
    jgot = np.asarray(jpl.render(params, jnp.array(frame)))
    ok, msg = _gate(got, jgot)
    assert ok, msg


def test_unaligned_geometry_routes_to_pixel(small_models):
    _f, _p, pix, spec, twin, spec_px = small_models[2]
    frame = _frame((70, 96), 9)
    # blend 1/16 at tile 32 -> output x-stride 60: not 16-aligned
    msgs = []
    from waifu2x_tensorrt_tpu_torch.utils.logging import Logger, Severity

    log = Logger()
    log.set_message_callback(lambda sev, m: msgs.append((sev, m)))
    pl = ChunkedPipeline(pix, spec, _cfg(32, 2, 2, 1 / 16), "cpu",
                         module_pack_x=twin, spec_pack_x=spec_px,
                         logger=log)
    assert not pl.get(frame.shape[:2])[0].use_pack_x
    assert [s for s, _ in msgs] == [Severity.debug]
    want = ChunkedPipeline(pix, spec, _cfg(32, 2, 2, 1 / 16), "cpu").render(
        frame).numpy()
    np.testing.assert_array_equal(pl.render(frame).numpy(), want)


class NearestUp(torch.nn.Module):
    """Stand-in model: nearest upsampling, in the pixel layout or in the
    packed-x16 one."""

    def __init__(self, scale, packed=False):
        super().__init__()
        self.scale = scale
        self.packed = packed

    def forward(self, x):
        s = self.scale
        y = x.repeat_interleave(s, dim=1).repeat_interleave(s, dim=2)
        n, oh, ow, _ = y.shape
        return y.reshape(n, oh, ow // 16, 48) if self.packed else y


class JNearestUpPackX(fnn.Module):
    """The same stand-in for the JAX pipeline."""

    scale: int

    @fnn.compact
    def __call__(self, x):
        s = self.scale
        y = jnp.repeat(jnp.repeat(x, s, axis=1), s, axis=2)
        n, oh, ow, _ = y.shape
        return y.reshape(n, oh, ow // 16, 48)


class JNearestUp(fnn.Module):
    scale: int

    @fnn.compact
    def __call__(self, x):
        return jnp.repeat(jnp.repeat(x, self.scale, axis=1), self.scale,
                          axis=2)


@pytest.mark.parametrize("hw,tile,batch,scale,blend", [
    ((70, 100), 64, 3, 4, 1 / 16),   # ramps: x-stride 240, 16-aligned
    ((100, 130), 64, 4, 2, 0.0),
])
def test_stand_in_pipeline_and_stream_match_jax(hw, tile, batch, scale,
                                                blend):
    """Same chunk outputs on both sides: the port's packed-x pipeline,
    per frame and streamed, gives the JAX packed-x pipeline's bytes."""
    frame = _frame(hw, 3)
    spec = treg.get_spec("swin_unet/art", scale, -1)
    pl = ChunkedPipeline(NearestUp(scale), spec,
                         _cfg(tile, batch, scale, blend), "cpu",
                         module_pack_x=NearestUp(scale, packed=True),
                         spec_pack_x=dataclasses.replace(spec, pack_x=16))
    assert pl.get(hw)[0].use_pack_x
    got = pl.render(frame).numpy()

    jspec = jreg.get_spec("swin_unet/art", scale, -1)
    jpl = JChunkedPipeline(JNearestUp(scale), jspec,
                           _jcfg(tile, batch, scale, blend),
                           module_pack_x=JNearestUpPackX(scale),
                           spec_pack_x=dataclasses.replace(jspec, pack_x=16))
    assert jpl.get(hw)[0].use_pack_x
    want = np.asarray(jpl.render({}, jnp.array(frame)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.repeat(np.repeat(frame, scale, 0), scale, 1))

    stream = TileStream(pl, hw)
    outs = []
    for _ in range(3):
        outs.extend(stream.submit(frame))
    outs.extend(stream.flush())
    assert len(outs) == 3
    for o in outs:
        np.testing.assert_array_equal(o.numpy(), want)


def test_stream_through_twin_equals_per_frame(small_models):
    _f, _p, pix, spec, twin, spec_px = small_models[2]
    pl = ChunkedPipeline(pix, spec, _cfg(32, 3, 2, 0.0), "cpu",
                         module_pack_x=twin, spec_pack_x=spec_px)
    frames = [_frame((40, 64), k) for k in range(3)]
    per_frame = [pl.render(f).numpy() for f in frames]
    stream = TileStream(pl, (40, 64))
    assert stream._use_px
    got = []
    for f in frames:
        got.extend(o.numpy() for o in stream.submit(f))
    got.extend(o.numpy() for o in stream.flush())
    assert len(got) == 3
    for g, w in zip(got, per_frame):
        ok, msg = _gate(g, w)
        assert ok, msg


def test_upscaler_pack_x_env_renders_same_bytes(monkeypatch, tmp_path):
    frame = _frame((70, 96), 4)
    cfg = _cfg(32, 2, 2, 0.0)
    renders, msgs = [], []
    for env in (None, "1"):
        if env is None:
            monkeypatch.delenv("WAIFU2X_PACK_X", raising=False)
        else:
            monkeypatch.setenv("WAIFU2X_PACK_X", env)
        up = Upscaler(models_dir=tmp_path, allow_random_init=True,
                      device="cpu")
        up.set_message_callback(lambda sev, m: msgs.append(m))
        up.load("swin_unet/art", 2, -1, cfg)
        pl = up._pipeline
        assert (pl._module_px is not None) == (env == "1")
        if env == "1":
            assert pl.get(frame.shape[:2])[0].use_pack_x
            assert all(a is b for a, b in zip(pl._module.parameters(),
                                              pl._module_px.parameters()))
        renders.append(up.render(frame))
    assert any("packed_x=off" in m for m in msgs)
    assert any("packed_x=on" in m for m in msgs)
    np.testing.assert_array_equal(renders[1], renders[0])
