"""Whole-frame programs (``fuse_frame``) and ``flops_per_frame`` of the
PyTorch port on the CPU, against the JAX package.

- the port's ``Upscaler.load(..., fuse_frame=True)`` render against the
  JAX package's whole-frame program (``RendererCache``, what its
  ``Upscaler.load(fuse_frame=True)`` renders through), on cunet/art 2x
  and a narrow swin_unet 2x, both with seeded unit-scale weights (so the
  frame is not near-black), each with TTA off, TTA on and rect TTA (the
  whole of a non-square frame as one tile): the golden gate, max 2 LSB
  and at most 1e-4 of the values changed;
- the port's fused render against its own chunked render, at most 1 LSB
  (the JAX package's ``tests/test_upscaler.py::
  test_chunked_matches_monolithic``; the port's two run the same chunks,
  so they agree byte for byte);
- ``can_stream`` is False and ``open_stream`` None under ``fuse_frame``;
- ``ChunkedPipeline.flops_per_frame`` against the JAX package's, between
  0.85 and 1.0 of it: the port counts the products and convolutions of
  the plain path (``FlopCounterMode``), XLA's cost analysis also counts
  the elementwise work (LayerNorm, GELU, softmax, bias adds, the TTA
  mean), which is the larger share in a narrow swin; a swin with
  ``fused_block`` (kernel B on CUDA: its activations on the meta device
  need not be contiguous) counts what the dense blocks count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from waifu2x_tensorrt_tpu.engine import renderer as jrenderer
from waifu2x_tensorrt_tpu.engine.config import Precision as JPrecision
from waifu2x_tensorrt_tpu.engine.config import RenderConfig as JRenderConfig
from waifu2x_tensorrt_tpu.models import registry as jreg
from waifu2x_tensorrt_tpu_torch.engine.config import Precision, RenderConfig
from waifu2x_tensorrt_tpu_torch.engine.renderer import ChunkedPipeline
from waifu2x_tensorrt_tpu_torch.engine.upscaler import Upscaler
from waifu2x_tensorrt_tpu_torch.models import registry as treg

SMALL = {"base_dim": 32, "depths": (1, 1, 2, 1, 1)}
MODELS = {"cunet": ("cunet/art", 2, 1, {}),
          "swin": ("swin_unet/art", 2, -1, SMALL)}
# (tta, tile, frame): square tiles, square tiles under TTA, and rect TTA
MODES = {"plain": (False, 64, (50, 45)), "tta": (True, 64, (37, 41)),
         "rect_tta": (True, 0, (30, 26))}


def _unit_params(module, seed):
    """Seeded weights of the flax module's tree at unit scale: kernels
    N(0, 1/fan_in), biases N(0, 0.1) (shapes from ``jax.eval_shape``)."""
    x = jnp.zeros((1, 64, 64, 3))
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), x)["params"]
    rng = np.random.default_rng(seed)

    def draw(path, s):
        v = rng.standard_normal(s.shape).astype(np.float32)
        if path[-1].key == "kernel":
            return v / np.float32(np.sqrt(np.prod(s.shape[:-1])))
        return np.float32(0.1) * v

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """{name: (flax module, params, spec)} and a models dir holding the
    params, which both packages read."""
    root = tmp_path_factory.mktemp("models")
    out = {}
    for name, (family, scale, noise, arch) in MODELS.items():
        module, spec = jreg.create_model(family, scale, noise, **arch)
        params = _unit_params(module, seed=3)
        jreg.save_params(jreg.weights_path(root, family, scale, noise),
                         params)
        out[name] = (module, params, spec)
    return out, root


def _cfgs(tta, tile, scale):
    kw = dict(batch_size=3, height=tile, width=tile, scaling=scale,
              overlap=(1 / 16, 1 / 16), tta=tta)
    return (RenderConfig(precision=Precision.TF32, **kw),
            JRenderConfig(precision=JPrecision.TF32, **kw))


@pytest.fixture(scope="module")
def renders(models):
    """(port fused, port chunked, JAX fused, port fused Upscaler) per
    (model, mode), rendered once."""
    by_name, root = models
    cache = {}

    def get(name, mode):
        if (name, mode) not in cache:
            module, params, spec = by_name[name]
            family, scale, noise, _ = MODELS[name]
            tta, tile, hw = MODES[mode]
            cfg, jcfg = _cfgs(tta, tile, scale)
            frame = np.random.default_rng(sum(hw)).integers(
                0, 256, (*hw, 3), np.uint8)
            fused = Upscaler(models_dir=root, device="cpu")
            fused.load(family, scale, noise, cfg, fuse_frame=True)
            chunked = Upscaler(models_dir=root, device="cpu")
            chunked.load(family, scale, noise, cfg)
            want = jrenderer.RendererCache(module, spec, jcfg).render(
                params, frame)
            cache[name, mode] = (fused.render(frame), chunked.render(frame),
                                 np.asarray(want), fused)
        return cache[name, mode]

    return get


def _diff(a, b):
    d = np.abs(a.astype(int) - b.astype(int))
    return int(d.max()), float((d > 0).mean())


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", list(MODELS))
def test_fused_render_matches_jax_fused(renders, name, mode):
    got, _chunked, want, _up = renders(name, mode)
    hw = MODES[mode][2]
    assert got.shape == want.shape == (hw[0] * 2, hw[1] * 2, 3)
    dmax, frac = _diff(got, want)
    assert dmax <= 2 and frac <= 1e-4, (dmax, frac)
    assert got.std() > 1.0  # not a flat frame


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", list(MODELS))
def test_fused_render_matches_chunked(renders, name, mode):
    got, chunked, _want, _up = renders(name, mode)
    assert _diff(got, chunked)[0] <= 1


def test_fused_frame_has_no_stream(renders):
    _got, _chunked, _want, up = renders("cunet", "plain")
    assert not up.can_stream
    assert up.open_stream(MODES["plain"][2]) is None
    chunked = Upscaler(allow_random_init=True, device="cpu")
    with pytest.raises(RuntimeError, match="load"):
        chunked.open_stream((8, 8))


@pytest.mark.parametrize("name,tta,hw", [
    ("cunet", False, (90, 130)),
    ("swin", False, (90, 130)),
    ("swin", True, (40, 56)),
])
def test_flops_per_frame_against_jax(models, name, tta, hw):
    """Between 0.85 and 1.0 of XLA's count: the same products and
    convolutions, without the elementwise work."""
    by_name, _root = models
    module, params, spec = by_name[name]
    family, scale, noise, arch = MODELS[name]
    cfg, jcfg = _cfgs(tta, 64, scale)
    want = jrenderer.ChunkedPipeline(module, spec, jcfg).flops_per_frame(
        params, hw)
    tmodule, tspec = treg.create_model(family, scale, noise, **arch)
    got = ChunkedPipeline(tmodule, tspec, cfg, "cpu").flops_per_frame(hw)
    assert 0.85 * want <= got <= want, (got, want, got / want)


def test_flops_per_frame_of_fused_blocks():
    family, scale, noise, arch = MODELS["swin"]
    cfg, _jcfg = _cfgs(False, 64, scale)
    counts = []
    for fused in (False, True):
        module, spec = treg.create_model(family, scale, noise,
                                         fused_block=fused, **arch)
        counts.append(ChunkedPipeline(module, spec, cfg,
                                      "cpu").flops_per_frame((90, 130)))
    assert counts[1] == counts[0] > 0, counts
