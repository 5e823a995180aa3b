"""Kernel A's plain twin (``window_attention_qkv_plain``) against the JAX
package: the Pallas kernel ``fused_window_attention_qkv`` in interpret
mode and the jnp ``window_attention_reference``, fp32, at C=96 on a ragged
window count; and the shift-mask law, exactly.

Each framework gets its own copy of every array (``jnp.array``,
``torch.tensor``, ``np.array``): on the CPU ``jnp.asarray`` and
``np.asarray`` share memory with their argument, and a comparison must
not depend on what the other side does to that memory.

torch runs on one intra-op thread here. Its thread count changes which
CPU GEMM path computes the twin and so its rounding; under a loaded
host the twin twice came out up to 4.3e-5 off the Pallas kernel (whose
result did not move) in a test process that ran after other test files.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waifu2x_tensorrt_tpu.models.swin_unet import (
    _shift_attn_mask,
    _shift_flags,
)
from waifu2x_tensorrt_tpu.ops import kernel_math as jkm
from waifu2x_tensorrt_tpu.ops.window_attention import (
    _mask_from_flags,
    fused_window_attention_qkv as jax_fused_qkv,
    window_attention_reference,
)
from waifu2x_tensorrt_tpu_torch.ops import kernel_math as tkm
from waifu2x_tensorrt_tpu_torch.ops.window_attention import (
    fused_window_attention_qkv,
    window_attention_qkv_plain,
)

BW, NH, N, HD = 12, 3, 64, 32
C = NH * HD


@pytest.fixture(autouse=True)
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((BW, N, 3 * C)).astype(np.float32)
    bias = (rng.standard_normal((NH, N, N)) * 0.1).astype(np.float32)
    flags = np.tile(_shift_flags(2, 2), 3).astype(np.int32)  # 3 images 2x2
    return qkv, bias, flags


@pytest.mark.parametrize("shift", [0, 4])
def test_plain_matches_pallas_interpret(shift):
    qkv, bias, flags = _inputs(7 + shift)
    want = np.array(jax_fused_qkv(
        jnp.array(qkv), jnp.array(bias), jnp.array(flags),
        num_heads=NH, shift=shift, block_windows=8, interpret=True))
    got = window_attention_qkv_plain(
        torch.tensor(qkv), torch.tensor(bias),
        torch.tensor(flags), num_heads=NH, shift=shift).numpy()
    assert got.shape == want.shape == (BW, N, C)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("shift", [0, 4])
def test_plain_matches_jnp_reference(shift):
    qkv, bias, flags = _inputs(11 + shift)

    def unpack(off):  # (BW, N, 3C) -> (BW, nh, N, hd)
        x = qkv[:, :, off * C:(off + 1) * C].reshape(BW, N, NH, HD)
        return jnp.array(x.transpose(0, 2, 1, 3))

    ref = np.array(window_attention_reference(
        unpack(0), unpack(1), unpack(2), jnp.array(bias),
        jnp.array(flags), shift))
    want = ref.transpose(0, 2, 1, 3).reshape(BW, N, C)
    got = window_attention_qkv_plain(
        torch.tensor(qkv), torch.tensor(bias),
        torch.tensor(flags), num_heads=NH, shift=shift).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_wrapper_runs_plain_twin_on_cpu():
    qkv, bias, flags = _inputs(3)
    args = (torch.tensor(qkv), torch.tensor(bias),
            torch.tensor(flags))
    before = fused_window_attention_qkv.launches
    got = fused_window_attention_qkv(*args, num_heads=NH, shift=4)
    want = window_attention_qkv_plain(*args, num_heads=NH, shift=4)
    assert torch.equal(got, want)
    assert fused_window_attention_qkv.launches == before  # no kernel here
    with pytest.raises(ValueError):
        fused_window_attention_qkv(args[0][:, :32], *args[1:], num_heads=NH)


@pytest.mark.parametrize("shift", [1, 2, 4, 7])
def test_mask_law_bit_exact(shift):
    ws = 8
    t = np.arange(ws * ws)
    rj, cj = jkm.shift_crossing(jnp.array(t)[:, None],
                                jnp.array(t)[None, :], ws, shift)
    tt = torch.arange(ws * ws)
    rt, ct = tkm.shift_crossing(tt[:, None], tt[None, :], ws, shift)
    np.testing.assert_array_equal(rt.numpy(), np.array(rj))
    np.testing.assert_array_equal(ct.numpy(), np.array(cj))
    flags = np.arange(4, dtype=np.int32)
    want = np.array(_mask_from_flags(jnp.array(flags), ws, shift)) == 0
    got = tkm.keep_mask(torch.tensor(flags), ws, shift).numpy()
    np.testing.assert_array_equal(got, want)


def test_mask_matches_region_mask():
    """The flag mask equals the classical Swin region mask per window."""
    ref = _shift_attn_mask(24, 24, 8, 4) > -1
    got = tkm.keep_mask(torch.tensor(_shift_flags(3, 3)), 8, 4).numpy()
    np.testing.assert_array_equal(got, ref)


def test_softmax_masked_entries_exactly_zero():
    rng = np.random.default_rng(0)
    attn = torch.tensor(rng.standard_normal((4, 64, 64)).astype(
        np.float32) * 30)
    keep = tkm.keep_mask(torch.tensor([0, 1, 2, 3], dtype=torch.int32), 8, 4)
    p = tkm.softmax_lastdim(attn, keep)
    assert torch.all(p[~keep] == 0)
    torch.testing.assert_close(p.sum(-1), torch.ones(4, 64))
    want = np.array(jkm.softmax_lastdim(jnp.array(attn.numpy()),
                                          exact=True,
                                          keep=jnp.array(keep.numpy())))
    np.testing.assert_allclose(p.numpy(), want, atol=1e-6, rtol=0)
