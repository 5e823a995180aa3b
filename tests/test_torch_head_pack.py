"""Kernel D's plain twin (``pack_head_plain``) against the JAX package's
``pack_head_x16`` (Pallas, interpret mode): bit for bit, f32 and bf16,
and its bytes equal the clamped pixel shuffle's, as
``tests/test_pallas_ops.py::test_pack_head_x16_matches_reference`` holds
the JAX kernel. The shuffle is a permutation and the clamp exact, so
there is no tolerance.

Each framework gets its own copy of every array (``jnp.array``,
``torch.tensor``, ``np.array``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waifu2x_tensorrt_tpu.ops.head_pack import (
    pack_head_x16 as jax_pack_head_x16,
)
from waifu2x_tensorrt_tpu_torch.models.swin_unet import _pixel_shuffle
from waifu2x_tensorrt_tpu_torch.ops.head_pack import (
    PACK_X,
    pack_head_plain,
    pack_head_x16,
)


def _bits(a):
    """Raw bits of a float32 / bfloat16 array (numpy or torch)."""
    if isinstance(a, torch.Tensor):
        a = (a.view(torch.int16) if a.dtype == torch.bfloat16
             else a.view(torch.int32)).numpy()
    else:
        a = np.array(a)
        a = a.view(np.int16 if a.itemsize == 2 else np.int32)
    return a


def _z(r, h, w, seed=0):
    rng = np.random.default_rng(seed)
    # values beyond [0, 1] on both sides, so the clamp bites
    return rng.uniform(-0.3, 1.3, (2, h, w, 3 * r * r)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r,h,w", [(4, 64, 64), (2, 64, 96)])
def test_plain_matches_pallas_interpret(r, h, w, dtype):
    z = _z(r, h, w)
    want = jax_pack_head_x16(jnp.array(z).astype(dtype), r=r, rows_block=16,
                             interpret=True)
    zt = torch.tensor(z).to(getattr(torch, dtype))
    got = pack_head_plain(zt, r)
    assert tuple(got.shape) == want.shape == (2, r * h, r * w // 16, 48)
    assert got.dtype == zt.dtype
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # the packed bytes are the clamped pixel tensor's
    pix = _pixel_shuffle(torch.clamp(zt, 0.0, 1.0), r)
    assert np.array_equal(_bits(got).tobytes(), _bits(pix).tobytes())


def test_wrapper_runs_plain_twin_on_cpu():
    zt = torch.tensor(_z(4, 8, 12, seed=1))
    before = pack_head_x16.launches
    got = pack_head_x16(zt, r=4)
    assert torch.equal(got, pack_head_plain(zt, 4))
    assert pack_head_x16.launches == before  # no kernel here
    assert got.shape == (2, 32, 48 // PACK_X, 48)
    with pytest.raises(TypeError):
        pack_head_x16(zt.half(), r=4)
    with pytest.raises(ValueError):  # 3r^2 channels expected
        pack_head_x16(zt, r=2)
    with pytest.raises(ValueError):  # 6 * 2 is not a multiple of 16
        pack_head_x16(torch.tensor(_z(2, 8, 6)), r=2)
    with pytest.raises(ValueError):
        pack_head_x16(torch.tensor(_z(2, 8, 8))[..., :9], r=3)


def _cu_constant(name):
    """An integer constant of csrc/head_pack.cu, so the replay below follows
    the kernel's source."""
    import re
    from pathlib import Path

    import waifu2x_tensorrt_tpu_torch.ops as ops_pkg

    src = (Path(ops_pkg.__file__).parent / "csrc" / "head_pack.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _register_emulation(z, r, itemsize):
    """numpy replay of csrc/head_pack.cu's thread mapping on z (B, H, W,
    3r^2): grid, thread -> items (item = block * THREADS * ITEMS + k *
    THREADS + thread), item -> (P pixels, sub-row ry), its P * 3 run loads
    (r values at c r^2 + ry r of each pixel) and its three 16-byte stores
    (the P r 3 values in order pixel, rx, channel). Checks that every run
    load is aligned to its r * itemsize bytes (on an aligned z), every
    store to 16 bytes, and that every output value is written exactly
    once. Returns the (B, rH, rW/16, 48) output."""
    threads, per = _cu_constant("HP_THREADS"), _cu_constant("HP_ITEMS")
    b, h, w, crr = z.shape
    p_px = 48 // (r * 3 * itemsize)
    assert p_px * r * 3 * itemsize == 48 and w % p_px == 0
    n_items = b * h * w // p_px * r
    blocks = -(-n_items // (threads * per))
    t = np.arange(blocks * threads)
    first = (t // threads) * (threads * per) + t % threads
    item = (first[:, None] + threads * np.arange(per)).reshape(-1)
    item = item[item < n_items]
    assert np.array_equal(np.sort(item), np.arange(n_items))
    ry, pix = item % r, (item // r) * p_px
    p, c, rx = np.meshgrid(np.arange(p_px), np.arange(3), np.arange(r),
                           indexing="ij")
    run = (pix[:, None, None, None] + p) * crr + c * r * r + ry[:, None, None,
                                                               None] * r
    assert (run[..., 0] * itemsize % (r * itemsize) == 0).all()
    src = run + rx  # (items, P, 3, r): element offsets of z
    # output order pixel, rx, channel
    vals = np.clip(z.reshape(-1)[src.transpose(0, 1, 3, 2).reshape(
        len(item), -1)], 0.0, 1.0)
    row, x = pix // w, pix % w
    dst0 = (row * r + ry) * (w * r * 3) + x * r * 3
    assert (dst0 * itemsize % 16 == 0).all()
    dst = dst0[:, None] + np.arange(p_px * r * 3)
    out = np.zeros(b * h * r * w * r * 3, z.dtype)
    writes = np.zeros(out.shape, np.int32)
    out[dst] = vals
    np.add.at(writes, dst.reshape(-1), 1)
    assert (writes == 1).all()
    return out.reshape(b, h * r, w * r // PACK_X, 3 * PACK_X)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r,b,h,w", [(4, 1, 5, 12), (4, 2, 9, 36),
                                     (2, 1, 3, 24), (2, 2, 11, 40)])
def test_kernel_mapping_matches_pallas_interpret(r, b, h, w, dtype):
    """The CUDA kernel's thread mapping, replayed in numpy, equals the JAX
    kernel bit for bit, at sizes whose item count is not a multiple of a
    CTA's items (partial last CTA). The replay clamps float32 values of the
    dtype's numbers, exact for bf16 inputs."""
    z = np.random.default_rng(r * w + h).uniform(
        -0.3, 1.3, (b, h, w, 3 * r * r)).astype(np.float32)
    zj = jnp.array(z).astype(dtype)
    want = jax_pack_head_x16(zj, r=r, rows_block=h, interpret=True)
    zf = np.array(zj.astype(jnp.float32))  # the dtype's values, in float32
    itemsize = 2 if dtype == "bfloat16" else 4
    got = _register_emulation(zf, r, itemsize)
    np.testing.assert_array_equal(
        _bits(jnp.array(got).astype(dtype)), _bits(want))
