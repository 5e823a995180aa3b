"""Kernel A's plain twin (``window_attention_qkv_plain``) and kernel E's
(``window_attention_plain``) against the JAX package: the Pallas kernels
``fused_window_attention_qkv`` and ``fused_window_attention`` in interpret
mode and the jnp ``window_attention_reference``, fp32, at C=96 (nh 3),
including ragged window counts; and the shift-mask law, exactly.

The fp32 tolerance is the bound ``_fp32_atol`` derives from the inputs:
twice the worst-case rounding error of one implementation, so that any
two summation orders stay inside it.

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
    fused_window_attention as jax_fused,
    fused_window_attention_qkv as jax_fused_qkv,
    window_attention_reference,
)
from waifu2x_tensorrt_tpu_torch import ops as tops
from waifu2x_tensorrt_tpu_torch.ops import kernel_math as tkm
from waifu2x_tensorrt_tpu_torch.ops.window_attention import (
    fused_window_attention,
    fused_window_attention_qkv,
    window_attention_plain,
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


def _heads(qkv, i):
    """Part i (0 q, 1 k, 2 v) of packed qkv as (BW, nh, N, hd)."""
    bw = qkv.shape[0]
    x = qkv[:, :, i * C:(i + 1) * C].reshape(bw, N, NH, HD)
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3))


def _fp32_atol(q, k, v, bias):
    """How far two fp32 implementations of the attention may lie apart
    when they sum in different orders: twice the first-order worst-case
    rounding error of one, evaluated on the inputs (q, k, v as (BW, nh,
    N, hd)) and maximised over the outputs.

    With u = 2^-24 and gamma_n = n u / (1 - n u), an n-term fp32 sum in any
    order errs by at most gamma_n * sum |terms|. So the score s_ij =
    scale q_i.k_j + b_ij (32 terms) errs by at most
    D_i = max_j (gamma_32 S_ij + u |s_ij|), S_ij = scale sum_d |q_id k_jd|.
    Through the softmax a score error e_j moves o = sum_j p_j v_j by
    sum_j p_j e_j (v_j - o), at most D_i sum_j p_j |v_j - o|. The 64-term
    product p.v adds gamma_64 sum_j p_j |v_j|, and the exp, the
    normalising sum's division and the final rounding 3 u of the same.
    On the standard-normal inputs here S_ij <= ~9 and the bound comes to
    about 5e-5 to 6e-5, while the two sides agree to ~6e-7 in most runs:
    the point of the bound is that no summation order can break it."""
    u = 2.0 ** -24

    def gamma(n):
        return n * u / (1 - n * u)

    q, k, v = (a.astype(np.float64) for a in (q, k, v))
    scale = q.shape[-1] ** -0.5
    s = np.einsum("whnd,whmd->whnm", q, k) * scale + bias[None]
    mag = np.einsum("whnd,whmd->whnm", np.abs(q), np.abs(k)) * scale
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    o = p @ v
    d = (gamma(q.shape[-1]) * mag + u * np.abs(s)).max(-1)[..., None]
    spread = np.einsum("whnm,whnmd->whnd", p,
                       np.abs(v[:, :, None] - o[:, :, :, None]))
    one = d * spread + (gamma(s.shape[-1]) + 3 * u) * (p @ np.abs(v))
    atol = 2 * float(one.max())
    # no looser than the fp32 Swin-stage tolerance of the JAX tests
    assert atol <= 1e-4, atol
    return atol


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
    atol = _fp32_atol(_heads(qkv, 0), _heads(qkv, 1), _heads(qkv, 2), bias)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


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


def _unpacked(seed, bw):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((bw, NH, N, HD)).astype(np.float32)
               for _ in range(3))
    bias = (rng.standard_normal((NH, N, N)) * 0.1).astype(np.float32)
    return q, k, v, bias


@pytest.mark.parametrize("shift,bw,flags", [
    (0, BW, "grid"), (4, BW, "grid"), (0, 10, "zero"), (4, 10, "all")],
    ids=["shift0", "shift4", "ragged-shift0", "ragged-shift4"])
def test_unpacked_plain_matches_pallas_interpret(shift, bw, flags):
    """Kernel E's twin against the JAX kernel (interpret) and the jnp
    reference; BW 10 is ragged for the JAX kernel's 4-window blocks."""
    q, k, v, bias = _unpacked(5 + shift + bw, bw)
    fl = {"grid": np.tile(_shift_flags(2, 2), 3),
          "zero": np.zeros(bw),
          "all": np.arange(bw) % 4}[flags].astype(np.int32)
    want = np.array(jax_fused(
        jnp.array(q), jnp.array(k), jnp.array(v), jnp.array(bias),
        jnp.array(fl), shift=shift, block_windows=4, interpret=True))
    ref = np.array(window_attention_reference(
        jnp.array(q), jnp.array(k), jnp.array(v), jnp.array(bias),
        jnp.array(fl), shift))
    got = window_attention_plain(
        torch.tensor(q), torch.tensor(k), torch.tensor(v),
        torch.tensor(bias), torch.tensor(fl), shift=shift).numpy()
    assert got.shape == want.shape == (bw, NH, N, HD)
    atol = _fp32_atol(q, k, v, bias)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    np.testing.assert_allclose(got, ref, atol=atol, rtol=0)


def test_unpacked_wrapper_runs_plain_twin_on_cpu():
    q, k, v, bias = _unpacked(2, 6)
    fl = torch.tensor(np.arange(6) % 4, dtype=torch.int32)
    args = tuple(torch.tensor(a) for a in (q, k, v, bias)) + (fl,)
    before = fused_window_attention.launches
    got = fused_window_attention(*args, shift=4)
    assert torch.equal(got, window_attention_plain(*args, shift=4))
    assert fused_window_attention.launches == before  # no kernel here
    # the ops package exports kernel E and its twin under the JAX names
    assert tops.fused_window_attention is fused_window_attention
    assert tops.window_attention_reference is window_attention_plain
    with pytest.raises(ValueError):  # head dim 16
        fused_window_attention(args[0][..., :16], *args[1:])
    with pytest.raises(ValueError):  # k of another shape
        fused_window_attention(args[0], args[1][:3], *args[2:])
    with pytest.raises(ValueError):  # shift 2
        fused_window_attention(*args, shift=2)


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
