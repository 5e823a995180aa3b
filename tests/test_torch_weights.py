"""The weight bridge between the JAX package and the PyTorch port.

- a flax SwinUNet or CUNet/UpCUNet param tree, flattened, loads into the
  port's module through ``params_from_flax`` with ``strict=True``, every
  tensor in place (transposed-conv taps flipped, SE layers as 1x1 convs);
- the port's ``init_params(seed)`` equals the JAX ``init_params_host(seed)``
  array for array, in jax's sorted-key flatten order, for both families;
- a JAX ``save_params`` ``.npz`` loads through the port's ``load_params``.
"""

import jax
import numpy as np
import pytest
import torch

from waifu2x_tensorrt_tpu.models import registry as jreg
from waifu2x_tensorrt_tpu.models.swin_unet import SwinUNet as FlaxSwinUNet
from waifu2x_tensorrt_tpu_torch.models import convert
from waifu2x_tensorrt_tpu_torch.models import registry as treg
from waifu2x_tensorrt_tpu_torch.models.cunet import CUNet
from waifu2x_tensorrt_tpu_torch.models.convert import (
    params_from_flax,
    swin_depths_from_flax,
)

SMALL = dict(base_dim=32, depths=(2, 2, 2, 2, 2))


def _port_module(scale=2, **kw):
    module, _ = treg.create_model("swin_unet/art", scale, -1, **kw)
    return module


@pytest.mark.parametrize("scale", [2, 4])
def test_flax_tree_loads_strict(scale):
    flax_mod = FlaxSwinUNet(scale=scale, **SMALL)
    flat = jreg._flatten(jreg.init_params(flax_mod, tile=32, seed=0))
    assert swin_depths_from_flax(flat) == SMALL["depths"]
    state = params_from_flax(flat, scale)
    module = _port_module(scale, **SMALL)
    module.load_state_dict(state, strict=True)
    sd = module.state_dict()
    # spot checks of the layout transforms
    np.testing.assert_array_equal(
        sd["patch_conv1.weight"].numpy(),
        np.transpose(flat["patch_conv1/kernel"], (3, 2, 0, 1)))
    np.testing.assert_array_equal(
        sd["swin2.block1.attn.qkv.weight"].numpy(),
        flat["swin2/block1/attn/qkv/kernel"].T)
    np.testing.assert_array_equal(
        sd["swin3.block0.norm2.weight"].numpy(),
        flat["swin3/block0/norm2/scale"])
    np.testing.assert_array_equal(
        sd["swin1.block1.attn.relative_position_bias_table"].numpy(),
        flat["swin1/block1/attn/relative_position_bias"])
    assert len(state) == len(sd)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("arch", [SMALL, {}], ids=["small", "flagship"])
def test_init_params_equals_jax_host_init(seed, arch):
    want = jreg._flatten(jreg.init_params_host(
        FlaxSwinUNet(scale=4, **arch), tile=32, seed=seed))
    got = treg.init_params(_port_module(4, **arch), seed=seed)
    assert list(got) == list(want)  # jax's flatten order, key for key
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_jax_npz_loads_through_port(tmp_path):
    flax_mod = FlaxSwinUNet(scale=2, **SMALL)
    params = jreg.init_params(flax_mod, tile=32, seed=1)
    path = jreg.weights_path(tmp_path, "swin_unet/art", 2, -1)
    jreg.save_params(path, params)
    assert treg.weights_path(tmp_path, "swin_unet/art", 2, -1) == path
    flat = treg.load_params(path)
    want = jreg._flatten(params)
    assert sorted(flat) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(flat[k], want[k])
    module = _port_module(2, **SMALL)
    got, from_file = treg.load_or_init_params(
        module, tmp_path, "swin_unet/art", 2, -1)
    assert from_file
    treg.load_into(module, got)


def test_missing_weights_fail_hard(tmp_path):
    module = _port_module(2, **SMALL)
    with pytest.raises(FileNotFoundError, match="allow-random-weights"):
        treg.load_or_init_params(module, tmp_path, "swin_unet/art", 2, -1)
    flat, from_file = treg.load_or_init_params(
        module, tmp_path, "swin_unet/art", 2, -1, allow_random=True)
    assert not from_file and len(flat) == len(module.state_dict())


def test_registry_surface_matches_jax():
    for family in treg.MODEL_FAMILIES:
        for scale in (1, 2, 4):
            for noise in (-1, 0, 3):
                try:
                    want = jreg.get_spec(family, scale, noise)
                except ValueError as e:
                    with pytest.raises(ValueError, match=str(e)[:20]):
                        treg.get_spec(family, scale, noise)
                    continue
                got = treg.get_spec(family, scale, noise)
                assert (got.offset, got.tile_divisor) == \
                    (want.offset, want.tile_divisor)
                assert treg.model_file_stem(scale, noise) == \
                    jreg.model_file_stem(scale, noise)
    for scale in (1, 2):
        module, spec = treg.create_model("cunet/art", scale, 1)
        assert isinstance(module, CUNet) and not module.training
        assert (module.scale, module.offset) == (scale, spec.offset)
        assert treg.create_model("cunet/art", scale, 1,
                                 dtype=torch.bfloat16)[0].dtype == \
            torch.bfloat16
    assert jax.__name__ == "jax" and torch.__name__ == "torch"


@pytest.mark.parametrize("scale", [1, 2])
def test_cunet_flax_tree_loads_strict(scale):
    flax_mod, _ = jreg.create_model("cunet/art", scale, 1)
    flat = jreg._flatten(jreg.init_params_host(flax_mod, tile=64, seed=0))
    assert convert.is_cunet_tree(flat)
    state = params_from_flax(flat, scale)
    module, _ = treg.create_model("cunet/art", scale, 1)
    module.load_state_dict(state, strict=True)
    sd = module.state_dict()
    assert len(state) == len(sd) == 2 * len(convert.cunet_mapping(scale))
    np.testing.assert_array_equal(
        sd["unet1.conv1.conv.0.weight"].numpy(),
        np.transpose(flat["unet1/conv1/conv0/kernel"], (3, 2, 0, 1)))
    np.testing.assert_array_equal(  # (I, O, kH, kW), taps flipped
        sd["unet2.conv3_up.weight"].numpy(),
        np.transpose(flat["unet2/conv3_up/kernel"],
                     (2, 3, 0, 1))[:, :, ::-1, ::-1])
    np.testing.assert_array_equal(  # SE Dense (I, O) -> 1x1 conv (O, I, 1, 1)
        sd["unet2.conv4.conv.4.conv2.weight"].numpy(),
        flat["unet2/conv4/se/fc2/kernel"].T[:, :, None, None])
    head = "deconv" if scale == 2 else "conv"
    assert dict((s, k) for s, _d, k in convert.cunet_mapping(scale))[
        "unet1.conv_bottom"] == head


@pytest.mark.parametrize("scale", [1, 2])
def test_cunet_init_params_equals_jax_host_init(scale):
    flax_mod, _ = jreg.create_model("cunet/art", scale, 1)
    want = jreg._flatten(jreg.init_params_host(flax_mod, tile=64, seed=0))
    got = treg.init_params(treg.create_model("cunet/art", scale, 1)[0],
                           seed=0)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_cunet_npz_loads_through_port(tmp_path):
    flax_mod, _ = jreg.create_model("cunet/art", 2, 3)
    params = jreg.init_params_host(flax_mod, tile=64, seed=4)
    jreg.save_params(jreg.weights_path(tmp_path, "cunet/art", 2, 3), params)
    module, _ = treg.create_model("cunet/art", 2, 3)
    flat, from_file = treg.load_or_init_params(module, tmp_path,
                                               "cunet/art", 2, 3)
    assert from_file
    treg.load_into(module, flat)
    np.testing.assert_array_equal(
        module.unet1.conv_bottom.bias.detach().numpy(),
        np.asarray(params["unet1"]["conv_bottom"]["bias"]))


def test_cunet_mapping_and_transforms_equal_jax():
    """The port's copies of the JAX package's cunet table and transposed-conv
    transform."""
    from waifu2x_tensorrt_tpu.models import convert as jconvert

    for scale in (1, 2):
        assert convert.cunet_mapping(scale) == jconvert.cunet_mapping(scale)
    k = np.random.default_rng(0).standard_normal((4, 4, 5, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(convert.inv_conv_transpose_weight(k),
                                  jconvert.inv_conv_transpose_weight(k))
    # and it inverts the JAX package's torch -> flax transform
    np.testing.assert_array_equal(
        jconvert.conv_transpose_weight(convert.inv_conv_transpose_weight(k)),
        k)
