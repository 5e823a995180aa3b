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
