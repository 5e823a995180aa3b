"""The weight bridge between the JAX package and the PyTorch port.

- a flax SwinUNet param tree, flattened, loads into the port's module
  through ``params_from_flax`` with ``strict=True``, every tensor in place;
- the port's ``init_params(seed)`` equals the JAX ``init_params_host(seed)``
  array for array, in jax's sorted-key flatten order;
- a JAX ``save_params`` ``.npz`` loads through the port's ``load_params``.
"""

import jax
import numpy as np
import pytest
import torch

from waifu2x_tensorrt_tpu.models import registry as jreg
from waifu2x_tensorrt_tpu.models.swin_unet import SwinUNet as FlaxSwinUNet
from waifu2x_tensorrt_tpu_torch.models import registry as treg
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
    with pytest.raises(NotImplementedError, match="not yet ported"):
        treg.create_model("cunet/art", 2, 1)
    assert jax.__name__ == "jax" and torch.__name__ == "torch"
