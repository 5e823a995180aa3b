"""The port's cunet modules (``models/cunet.py``) on the CPU against the
JAX package's flax modules, weights through the bridge.

- ``SEBlock``, ``UNetConv``, ``UNet1`` (conv and deconv heads), ``UNet2``,
  ``CUNet`` and ``UpCUNet`` with seeded unit-scale weights in the flax
  tree's shapes, on seeded inputs: fp32 within atol 3e-5; bf16 by the
  rule |port16 - flax32| <= max(2 |flax16 - flax32|, 0.02);
- the k4s2p3 head (``ConvTranspose2d(padding=3)``) equals the VALID
  transposed conv cropped by 3, and the flax kernel's taps land flipped;
- leaky ReLU's bf16 slope is 0.1 rounded to bf16, as in the reference;
- ``Upscaler`` renders cunet/art 1x and 2x (tiles and whole frame) on the
  CPU as the JAX ``ChunkedPipeline`` does from the same ``.npz`` (seeded
  unit-scale weights, which give the frame content).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waifu2x_tensorrt_tpu.engine.config import Precision as JPrecision
from waifu2x_tensorrt_tpu.engine.config import RenderConfig as JRenderConfig
from waifu2x_tensorrt_tpu.engine.renderer import (
    ChunkedPipeline as JChunkedPipeline,
)
from waifu2x_tensorrt_tpu.models import cunet as jcunet
from waifu2x_tensorrt_tpu.models import registry as jreg
from waifu2x_tensorrt_tpu_torch.engine.config import Precision, RenderConfig
from waifu2x_tensorrt_tpu_torch.engine.upscaler import Upscaler
from waifu2x_tensorrt_tpu_torch.models import convert
from waifu2x_tensorrt_tpu_torch.models import cunet as tcunet
from waifu2x_tensorrt_tpu_torch.models import registry as treg
from waifu2x_tensorrt_tpu_torch.ops import cunet_epilogue

_TRANSFORM = {"conv": convert.inv_conv_weight,
              "deconv": convert.inv_conv_transpose_weight,
              "dense": lambda k: convert.inv_dense_weight(k)[:, :, None,
                                                             None]}


def _strip(entries, src_prefix, dst_prefix):
    return [(s[len(src_prefix):], d[len(dst_prefix):], k)
            for s, d, k in entries]


def _se_entries():
    return [("conv1", "fc1", "dense"), ("conv2", "fc2", "dense")]


def _unet_conv_entries(se):
    return _strip(convert._unet_conv_entries("p", "p", se), "p.", "p/")


def _unet1_entries(deconv):
    return _strip(convert._unet1_entries("u")
                  + [("u.conv_bottom", "u/conv_bottom",
                      "deconv" if deconv else "conv")], "u.", "u/")


def _unet2_entries():
    return _strip(convert._unet2_entries("u")
                  + [("u.conv_bottom", "u/conv_bottom", "conv")], "u.", "u/")


def _load(module, params, entries):
    """Load a flax sub-tree into the port's sub-module (strict)."""
    flat = jreg._flatten(params)
    state = {}
    for src, dst, kind in entries:
        state[f"{src}.weight"] = torch.from_numpy(
            np.array(_TRANSFORM[kind](flat[f"{dst}/kernel"])))
        state[f"{src}.bias"] = torch.from_numpy(np.array(flat[f"{dst}/bias"]))
    module.load_state_dict(state, strict=True)
    return module


def _unit_params(fmod, x, seed):
    """Seeded weights of the flax module's tree at unit scale: kernels
    N(0, 1/fan_in), biases N(0, 0.1) (shapes from ``jax.eval_shape``, so
    no init program runs)."""
    shapes = jax.eval_shape(fmod.init, jax.random.PRNGKey(0), x)["params"]
    rng = np.random.default_rng(seed)

    def draw(path, s):
        v = rng.standard_normal(s.shape).astype(np.float32)
        if path[-1].key == "kernel":
            return v / np.float32(np.sqrt(np.prod(s.shape[:-1])))
        return np.float32(0.1) * v

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _apply(fmod, params, x):
    return np.asarray(jax.jit(fmod.apply)({"params": params}, x),
                      np.float32)


def _check(flax_cls, kw, torch_mod, entries, shape, seed):
    x = np.random.default_rng(seed).random(shape, dtype=np.float32)
    fmod = flax_cls(**kw)
    params = _unit_params(fmod, jnp.asarray(x), seed)
    want = _apply(fmod, params, jnp.asarray(x))
    f16 = _apply(flax_cls(**kw, dtype=jnp.bfloat16), params,
                 jnp.asarray(x).astype(jnp.bfloat16))
    _load(torch_mod, params, entries)
    with torch.no_grad():
        got = torch_mod(torch.from_numpy(x)).numpy()
        got16 = torch_mod(torch.from_numpy(x).to(torch.bfloat16)).float()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-5)
    e_port = np.abs(got16.numpy() - want).max()
    e_flax = np.abs(f16 - want).max()
    assert e_port <= max(2 * e_flax, 0.02), (e_port, e_flax)


def test_se_block():
    _check(jcunet.SEBlock, {"features": 64}, tcunet.SEBlock(64),
           _se_entries(), (2, 9, 7, 64), 0)


@pytest.mark.parametrize("cin,mid,out,se", [(3, 32, 64, False),
                                            (64, 128, 64, True)])
def test_unet_conv(cin, mid, out, se):
    _check(jcunet.UNetConv, {"mid": mid, "out": out, "se": se},
           tcunet.UNetConv(cin, mid, out, se), _unet_conv_entries(se),
           (2, 12, 14, cin), 1)


@pytest.mark.parametrize("deconv", [False, True], ids=["conv", "deconv"])
def test_unet1(deconv):
    _check(jcunet.UNet1, {"deconv": deconv},
           tcunet.UNet1(3, 3, deconv=deconv), _unet1_entries(deconv),
           (2, 36, 40, 3), 2)


def test_unet2():
    _check(jcunet.UNet2, {}, tcunet.UNet2(3, 3), _unet2_entries(),
           (1, 44, 48, 3), 3)


@pytest.mark.parametrize("scale,tile", [(1, 60), (2, 40)])
def test_cascade_through_the_bridge(scale, tile):
    """CUNet (1x) / UpCUNet (2x): the flax tree, flattened, loaded through
    ``registry.load_into`` (``params_from_flax``)."""
    fmod, _ = jreg.create_model("cunet/art", scale, 1)
    fmod16, _ = jreg.create_model("cunet/art", scale, 1, dtype=jnp.bfloat16)
    x = np.random.default_rng(scale).random((2, tile, tile, 3),
                                            dtype=np.float32)
    params = _unit_params(fmod, jnp.asarray(x), scale)
    want = _apply(fmod, params, jnp.asarray(x))
    f16 = _apply(fmod16, params, jnp.asarray(x))
    out = tile * scale - 2 * {1: 28, 2: 36}[scale]
    assert want.shape == (2, out, out, 3)
    flat = jreg._flatten(params)
    for dtype in (torch.float32, torch.bfloat16):
        module, spec = treg.create_model("cunet/art", scale, 1, dtype=dtype)
        assert isinstance(module, tcunet.CUNet)
        assert (module.scale, module.offset) == (spec.scale, spec.offset)
        treg.load_into(module, flat)
        with torch.no_grad():
            got = module(torch.from_numpy(x)).float().numpy()
        assert got.shape == want.shape
        if dtype == torch.float32:
            np.testing.assert_allclose(got, want, rtol=0, atol=3e-5)
        else:
            e_port = np.abs(got - want).max()
            assert e_port <= max(2 * np.abs(f16 - want).max(), 0.02)


def test_k4s2p3_head_is_valid_deconv_cropped_by_3():
    """Small integers throughout, so both forms are exact and must agree
    bit for bit."""
    gen = torch.Generator().manual_seed(0)
    head = tcunet.UNet1(3, 3, deconv=True).conv_bottom
    assert head.padding == (3, 3) and head.kernel_size == (4, 4)
    with torch.no_grad():
        head.weight.copy_(torch.randint(-3, 4, head.weight.shape,
                                        generator=gen).float())
        head.bias.copy_(torch.randint(-3, 4, head.bias.shape,
                                      generator=gen).float())
    x = torch.randint(-4, 5, (2, 64, 9, 11), generator=gen).float()
    with torch.no_grad():
        a = head(x)
        b = torch.nn.functional.conv_transpose2d(x, head.weight, head.bias,
                                                 stride=2)
    assert a.shape == (2, 3, 14, 18) and b.shape == (2, 3, 20, 24)
    torch.testing.assert_close(a, b[:, :, 3:-3, 3:-3], rtol=0, atol=0)


def test_conv_transpose_taps_are_flipped():
    """A flax ConvTranspose kernel with one hot tap: torch's weight holds
    it at the flipped position, and both produce the same output."""
    import flax.linen as fnn

    k = np.zeros((2, 2, 1, 1), np.float32)
    k[0, 1, 0, 0] = 1.0
    w = convert.inv_conv_transpose_weight(k)
    assert w.shape == (1, 1, 2, 2) and w[0, 0, 1, 0] == 1.0
    x = np.arange(6, dtype=np.float32).reshape(1, 2, 3, 1) + 1
    want = np.asarray(fnn.ConvTranspose(1, (2, 2), strides=(2, 2),
                                        padding="VALID").apply(
        {"params": {"kernel": k, "bias": np.zeros(1, np.float32)}}, x))
    got = torch.nn.functional.conv_transpose2d(
        torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(w),
        stride=2).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)


def test_lrelu_slope_rounds_to_the_compute_dtype():
    """The leaky ReLU of the port's cunet epilogue (kernel H's twin)."""
    x = torch.tensor([-1.0, -3.0, 2.0], dtype=torch.bfloat16)
    slope = torch.tensor(0.1, dtype=torch.bfloat16)
    want = jcunet._lrelu(jnp.asarray(x.float().numpy(), jnp.bfloat16))
    got = cunet_epilogue.leaky_relu(x)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    assert got[0] == -slope  # -0.10009765625, not -0.1
    assert cunet_epilogue.leaky_relu(torch.tensor([-1.0]))[0] == \
        torch.tensor(-0.1)


@pytest.mark.parametrize("scale,noise,tile,hw,precision", [
    (1, 0, 64, (50, 45), "tf32"),
    (2, 1, 64, (37, 41), "tf32"),
    (2, 1, 0, (30, 26), "tf32"),     # whole frame, 36 px of context
    (2, 2, 64, (30, 26), "fp16"),
])
def test_upscaler_renders_cunet_like_jax(tmp_path, scale, noise, tile, hw,
                                         precision):
    """fp32: at most 1 LSB, on at most 1e-3 of the values (XLA's and
    oneDNN's convolutions sum in other orders, which flips the rounding of
    a value that lies within ~1e-6 of a half step). bf16: the bf16 rule in
    u8 units against the JAX fp32 render, max(2 x the JAX bf16 render's
    error, 0.02 x 255)."""
    module, spec = jreg.create_model("cunet/art", scale, noise)
    params = _unit_params(module, jnp.zeros((1, 64, 64, 3)), scale + noise)
    jreg.save_params(jreg.weights_path(tmp_path, "cunet/art", scale, noise),
                     params)
    kw = dict(batch_size=3, height=tile, width=tile, scaling=scale,
              overlap=(1 / 16, 1 / 16))
    frame = np.random.default_rng(0).integers(0, 256, (*hw, 3),
                                              np.uint8).astype(int)

    def jax_render(precision):
        mod, _ = jreg.create_model(
            "cunet/art", scale, noise,
            dtype=jnp.bfloat16 if precision == "fp16" else jnp.float32)
        return np.asarray(JChunkedPipeline(
            mod, spec, JRenderConfig(precision=JPrecision(precision), **kw)
        ).render(params, jnp.asarray(frame.astype(np.uint8)))).astype(int)

    up = Upscaler(models_dir=tmp_path, device="cpu")
    up.load("cunet/art", scale, noise,
            RenderConfig(precision=Precision(precision), **kw))
    got = up.render(frame.astype(np.uint8)).astype(int)
    want = jax_render("tf32")
    assert got.shape == want.shape == (hw[0] * scale, hw[1] * scale, 3)
    if precision == "tf32":
        diff = np.abs(got - want)
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    else:
        e_jax = np.abs(jax_render("fp16") - want).max()
        assert np.abs(got - want).max() <= max(2 * e_jax, 0.02 * 255)
