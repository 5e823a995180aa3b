"""Kernel B's plain twin (``swin_block_plain``) and the port's SwinBlock
against the JAX package: the Pallas ``fused_swin_block`` in interpret mode
and the flax dense ``SwinBlock``, fp32, C=64 / 2 heads, shift 0 and 4
(atol 1e-4); in bf16 against the flax dense bf16 block by the repo's rule
|port_bf16 - flax_fp32| <= max(2 |flax_bf16 - flax_fp32|, 0.02).
``swin_block_bhwc`` (the block on a (B, H, W, C) activation) on the CPU
against the Pallas kernel on the JAX-rolled and split input, merged and
rolled back, on square and rectangular window grids.

Each framework gets its own copy of every array (``jnp.array``,
``torch.tensor``, ``np.array``): on the CPU ``jnp.asarray`` and
``np.asarray`` share memory with their argument, and a comparison must
not depend on what the other side does to that memory.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waifu2x_tensorrt_tpu.models.swin_unet import SwinBlock as FlaxSwinBlock
from waifu2x_tensorrt_tpu.models.swin_unet import (
    _shift_flags,
    _window_merge,
    _window_split,
)
from waifu2x_tensorrt_tpu.ops.swin_block import (
    fused_swin_block as jax_fused_block,
)
from waifu2x_tensorrt_tpu_torch.models.swin_unet import SwinBlock
from waifu2x_tensorrt_tpu_torch.ops.swin_block import (
    block_operands,
    fused_swin_block,
    swin_block_bhwc,
    swin_block_plain,
    swin_block_prepared,
)

C, NH, N = 64, 2, 64


def _kernel_params(rng):
    def r(*shape, loc=0.0, scale=0.05):
        return rng.normal(loc, scale, shape).astype(np.float32)

    return {
        "n1_scale": r(C, loc=1, scale=0.1), "n1_bias": r(C, scale=0.1),
        "qkv_kernel": r(C, 3 * C), "qkv_bias": r(3 * C),
        "proj_kernel": r(C, C), "proj_bias": r(C),
        "n2_scale": r(C, loc=1, scale=0.1), "n2_bias": r(C, scale=0.1),
        "fc1_kernel": r(C, 2 * C), "fc1_bias": r(2 * C),
        "fc2_kernel": r(2 * C, C), "fc2_bias": r(C),
    }


@pytest.mark.parametrize("shift", [0, 4])
def test_plain_matches_pallas_interpret(shift):
    rng = np.random.default_rng(shift)
    bw = 10
    params = _kernel_params(rng)
    bias = rng.normal(0, 0.2, (NH, N, N)).astype(np.float32)
    flags = rng.integers(0, 4, bw).astype(np.int32)
    x = rng.normal(0, 1, (bw, N, C)).astype(np.float32)
    want = np.array(jax_fused_block(
        jnp.array(x), {k: jnp.array(v) for k, v in params.items()},
        jnp.array(bias), jnp.array(flags), num_heads=NH, shift=shift,
        block_windows=4, interpret=True))
    got = swin_block_plain(
        torch.tensor(x), {k: torch.tensor(v)
                              for k, v in params.items()},
        torch.tensor(bias), torch.tensor(flags), num_heads=NH,
        shift=shift).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def _bridge_block(flax_params, block: SwinBlock):
    """Load one flax SwinBlock's params into the port's SwinBlock."""
    p = jax.tree_util.tree_map(np.asarray, flax_params)
    t = lambda a: torch.tensor(np.ascontiguousarray(a))  # noqa: E731
    sd = {
        "norm1.weight": t(p["norm1"]["scale"]),
        "norm1.bias": t(p["norm1"]["bias"]),
        "attn.qkv.weight": t(p["attn"]["qkv"]["kernel"].T),
        "attn.qkv.bias": t(p["attn"]["qkv"]["bias"]),
        "attn.proj.weight": t(p["attn"]["proj"]["kernel"].T),
        "attn.proj.bias": t(p["attn"]["proj"]["bias"]),
        "attn.relative_position_bias_table": t(
            p["attn"]["relative_position_bias"]),
        "norm2.weight": t(p["norm2"]["scale"]),
        "norm2.bias": t(p["norm2"]["bias"]),
        "mlp_fc1.weight": t(p["mlp_fc1"]["kernel"].T),
        "mlp_fc1.bias": t(p["mlp_fc1"]["bias"]),
        "mlp_fc2.weight": t(p["mlp_fc2"]["kernel"].T),
        "mlp_fc2.bias": t(p["mlp_fc2"]["bias"]),
    }
    block.load_state_dict(sd, strict=True)


def _flax_block_and_params(shift, seed=0):
    x = np.random.default_rng(seed + 5).random((2, 16, 24, C)).astype(
        np.float32)
    flax32 = FlaxSwinBlock(C, NH, shift=shift, dtype=jnp.float32)
    params = flax32.init(jax.random.PRNGKey(seed), jnp.array(x))["params"]
    # non-degenerate relative-position tables and LN params
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: np.array(a) + rng.normal(0, 0.05, a.shape).astype(
            np.float32), params)
    return x, params


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "dense"])
@pytest.mark.parametrize("shift", [0, 4])
def test_block_matches_flax_dense_fp32(shift, fused):
    x, params = _flax_block_and_params(shift)
    want = np.array(FlaxSwinBlock(C, NH, shift=shift).apply(
        {"params": params}, jnp.array(x)))
    block = SwinBlock(C, NH, shift=shift, fused_block=fused)
    _bridge_block(params, block)
    with torch.no_grad():
        got = block(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("shift", [0, 4])
def test_block_bf16_within_bf16_noise(shift):
    x, params = _flax_block_and_params(shift, seed=1)
    y32 = np.array(FlaxSwinBlock(C, NH, shift=shift).apply(
        {"params": params}, jnp.array(x)))
    yd16 = np.array(FlaxSwinBlock(C, NH, shift=shift, dtype=jnp.bfloat16)
                      .apply({"params": params},
                             jnp.array(x).astype(jnp.bfloat16)),
                      dtype=np.float32)
    block = SwinBlock(C, NH, shift=shift, fused_block=True)
    _bridge_block(params, block)
    with torch.no_grad():
        y16 = block(torch.tensor(x).bfloat16()).float().numpy()
    err_port = np.abs(y16 - y32).max()
    err_dense = np.abs(yd16 - y32).max()
    assert err_port <= max(2 * err_dense, 0.02), (err_port, err_dense)


def test_wrapper_runs_plain_twin_on_cpu():
    rng = np.random.default_rng(9)
    params = {k: torch.tensor(v) for k, v in _kernel_params(rng).items()}
    bias = torch.tensor(rng.normal(0, 0.2, (NH, N, N)).astype(np.float32))
    flags = torch.tensor(np.tile(_shift_flags(2, 3), 2))
    x = torch.tensor(rng.normal(0, 1, (12, N, C)).astype(np.float32))
    before = fused_swin_block.launches
    got = fused_swin_block(x, params, bias, flags, num_heads=NH, shift=4)
    want = swin_block_plain(x, params, bias, flags, num_heads=NH, shift=4)
    assert torch.equal(got, want)
    assert fused_swin_block.launches == before
    with pytest.raises(ValueError, match="qkv_kernel"):
        bad = dict(params, qkv_kernel=params["qkv_kernel"][:, :C])
        fused_swin_block(x, bad, bias, flags, num_heads=NH)


def _torch_operands(params, bias):
    return block_operands({k: torch.tensor(v) for k, v in params.items()},
                          torch.tensor(bias), torch.float32)


@pytest.mark.parametrize("b,h,w", [(2, 16, 24), (1, 8, 40), (3, 16, 16)])
@pytest.mark.parametrize("shift", [0, 4])
def test_bhwc_plain_matches_pallas_on_rolled_windows(shift, b, h, w):
    """The block on the activation (``swin_block_bhwc``, its plain twin on
    the CPU) is the JAX package's kernel B on the windows of the input
    rolled by -shift, merged and rolled back: the composition that the
    CUDA kernel's address function replaces."""
    rng = np.random.default_rng(20 + shift + h + w)
    params = _kernel_params(rng)
    bias = rng.normal(0, 0.2, (NH, N, N)).astype(np.float32)
    x = rng.normal(0, 1, (b, h, w, C)).astype(np.float32)
    xw = _window_split(jnp.roll(jnp.array(x), (-shift, -shift),
                                axis=(1, 2)), 8)
    yw = jax_fused_block(
        xw.reshape(-1, N, C), {k: jnp.array(v) for k, v in params.items()},
        jnp.array(bias), jnp.array(np.tile(_shift_flags(h // 8, w // 8), b)),
        num_heads=NH, shift=shift, block_windows=4, interpret=True)
    want = np.array(jnp.roll(_window_merge(yw.reshape(b, -1, N, C), h, w,
                                           8), (shift, shift), axis=(1, 2)))
    before = fused_swin_block.direct_launches
    got = swin_block_bhwc(torch.tensor(x), _torch_operands(params, bias),
                          shift=shift).numpy()
    assert fused_swin_block.direct_launches == before  # the plain twin
    assert got.shape == (b, h, w, C)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_windowed_layout_is_the_one_window_geometry():
    """An 8 x 8 activation without a roll is one window: the block on it
    is ``swin_block_prepared`` on its 64 tokens, byte for byte."""
    rng = np.random.default_rng(31)
    ops = _torch_operands(_kernel_params(rng),
                          rng.normal(0, 0.2, (NH, N, N)).astype(np.float32))
    x = torch.tensor(rng.normal(0, 1, (5, 8, 8, C)).astype(np.float32))
    flags = torch.zeros(5, dtype=torch.int32)
    want = swin_block_prepared(x.reshape(5, N, C), ops, flags)
    assert torch.equal(swin_block_bhwc(x, ops), want.reshape(5, 8, 8, C))


def test_bhwc_rejects_what_the_kernel_does_not_take():
    rng = np.random.default_rng(32)
    ops = _torch_operands(_kernel_params(rng),
                          rng.normal(0, 0.2, (NH, N, N)).astype(np.float32))
    x = torch.zeros((2, 16, 16, C))
    for bad in (torch.zeros((2, 12, 16, C)), torch.zeros((2, 16, 20, C)),
                torch.zeros((16, 16, C)), torch.zeros((2, 16, 16, 32))):
        with pytest.raises(ValueError):
            swin_block_bhwc(bad, ops, shift=4)
    with pytest.raises(ValueError):  # window 8, shift 0 or 4 only
        swin_block_bhwc(x, ops, shift=2)
