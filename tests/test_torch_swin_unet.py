"""The port's SwinUNet against the flax dense forward of the JAX package,
fp32, on a small architecture (base_dim 32, depths (2, 2, 2, 2, 2)) with
flax-initialized weights bridged across: tile 64, and tile 72 (the
internal edge pad 72 -> 96). Tolerance atol 1e-4: flax's LayerNorm takes
the fast variance E[x^2] - mean^2, the port the two-pass form.

Each framework gets its own copy of every array (``jnp.array``,
``torch.tensor``, ``np.array``): on the CPU ``jnp.asarray`` and
``np.asarray`` share memory with their argument, and a comparison must
not depend on what the other side does to that memory.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waifu2x_tensorrt_tpu.models import registry as jreg
from waifu2x_tensorrt_tpu.models.swin_unet import SwinUNet as FlaxSwinUNet
from waifu2x_tensorrt_tpu_torch.models import registry as treg

SMALL = dict(base_dim=32, depths=(2, 2, 2, 2, 2))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "dense"])
@pytest.mark.parametrize("scale,tile", [(2, 64), (2, 72), (4, 64), (1, 40)])
def test_forward_matches_flax_dense(scale, tile, fused):
    noise = 0 if scale == 1 else -1
    flax_mod = FlaxSwinUNet(scale=scale, **SMALL)
    params = jreg.init_params(flax_mod, tile=32, seed=scale)
    x = np.random.default_rng(tile).random((2, tile, tile, 3)).astype(
        np.float32)
    want = np.array(flax_mod.apply({"params": params}, jnp.array(x)))
    module, _ = treg.create_model("swin_unet/art", scale, noise,
                                  fused_block=fused, **SMALL)
    treg.load_into(module, jreg._flatten(params))
    with torch.no_grad():
        got = module(torch.tensor(x)).numpy()
    assert got.shape == want.shape == (2, tile * scale, tile * scale, 3)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_fused_blocks_run_on_the_activation(monkeypatch):
    """With ``fused_block`` every Swin block of the flagship's depths (2,
    2, 6, 2, 2: 10 blocks) is one call of ``swin_block_bhwc`` on its
    (B, H, W, C) activation, and the forward still matches flax."""
    from waifu2x_tensorrt_tpu_torch.models import swin_unet

    arch = dict(base_dim=32, depths=(2, 2, 6, 2, 2))
    flax_mod = FlaxSwinUNet(scale=4, **arch)
    params = jreg.init_params(flax_mod, tile=32, seed=7)
    x = np.random.default_rng(7).random((1, 32, 32, 3)).astype(np.float32)
    want = np.array(flax_mod.apply({"params": params}, jnp.array(x)))
    module, _ = treg.create_model("swin_unet/art", 4, -1, fused_block=True,
                                  **arch)
    treg.load_into(module, jreg._flatten(params))
    shapes = []
    block = swin_unet.swin_block_bhwc

    def counted(x, operands, **kw):
        assert x.is_contiguous()
        shapes.append((tuple(x.shape), kw["shift"]))
        return block(x, operands, **kw)

    monkeypatch.setattr(swin_unet, "swin_block_bhwc", counted)
    with torch.no_grad():
        got = module(torch.tensor(x)).numpy()
    assert shapes == ([((1, 16, 16, 32), s) for s in (0, 4)]
                      + [((1, 8, 8, 64), s) for s in (0, 4) * 3]
                      + [((1, 16, 16, 32), s) for s in (0, 4)])
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_pixel_shuffle_is_torch_crd_order():
    from waifu2x_tensorrt_tpu_torch.ops.kernel_math import pixel_shuffle

    x = torch.arange(2 * 3 * 5 * 12, dtype=torch.float32).reshape(2, 3, 5, 12)
    want = torch.nn.functional.pixel_shuffle(
        x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    assert torch.equal(pixel_shuffle(x, 2), want)


def test_bf16_forward_runs_in_bf16():
    module, _ = treg.create_model("swin_unet/art", 2, -1,
                                  dtype=torch.bfloat16, fused_block=True,
                                  **SMALL)
    treg.load_into(module, treg.init_params(module, seed=0))
    with torch.no_grad():
        y = module(torch.rand(1, 32, 32, 3))
    assert y.dtype == torch.bfloat16 and y.shape == (1, 64, 64, 3)
    assert bool(torch.isfinite(y.float()).all())


@pytest.mark.parametrize("packed", [False, True], ids=["pixel", "packed-x"])
def test_padded_output_is_contiguous(packed):
    """A tile that is not a multiple of 32 (whole-frame tiles, tile 400) is
    edge-padded inside the model and cropped after decoding; the cropped
    output is one contiguous batch, as kernel C's tile table needs."""
    module, _ = treg.create_model("swin_unet/art", 2, -1,
                                  packed_x_head=packed, **SMALL)
    with torch.no_grad():
        y = module(torch.rand(2, 40, 56, 3))
    assert y.is_contiguous()
    assert y.shape == ((2, 80, 7, 48) if packed else (2, 80, 112, 3))
