"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Skipped without a CUDA device (the kernels have no CPU mode); on a
machine with one, run
``python -m pytest --noconftest tests/test_torch_cuda_kernels.py`` (the
conftest sets up JAX, which such a machine need not have).
Same checks as phases 3, 4 and 8 of ``chip_smoke.py``, at smaller
shapes: kernels A, B and E within fp32 max |d| <= 1e-4 (TF32 off) and the
bf16 rule |k16 - p32| <= max(2 |p16 - p32|, 0.02); kernel B's bf16
tensor-core kernel also at C 96 / 3 heads and C 192 / 6 heads with window
counts of 1, 37 and full CTAs, on prepared operands (the same bytes as
per-call ones, one launch counted), and with logits beyond 100 under the
shift mask; kernel C byte-identical
to the scan, with whole chunks and TileStream pieces; kernel D equal to
its plain twin and to the clamped pixel shuffle, byte for byte.
"""

import numpy as np
import pytest
import torch

# evaluated when each test runs, not at import
pytestmark = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA device")


@pytest.fixture(autouse=True)
def _no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _inputs(bw, c, nh, seed):
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).cuda()

    params = {
        "n1_scale": t(rng.normal(1, 0.1, c)), "n1_bias": t(rng.normal(0, 0.1, c)),
        "qkv_kernel": t(rng.normal(0, 0.05, (c, 3 * c))),
        "qkv_bias": t(rng.normal(0, 0.05, 3 * c)),
        "proj_kernel": t(rng.normal(0, 0.05, (c, c))),
        "proj_bias": t(rng.normal(0, 0.05, c)),
        "n2_scale": t(rng.normal(1, 0.1, c)), "n2_bias": t(rng.normal(0, 0.1, c)),
        "fc1_kernel": t(rng.normal(0, 0.05, (c, 2 * c))),
        "fc1_bias": t(rng.normal(0, 0.05, 2 * c)),
        "fc2_kernel": t(rng.normal(0, 0.05, (2 * c, c))),
        "fc2_bias": t(rng.normal(0, 0.05, c)),
    }
    bias = t(rng.normal(0, 0.2, (nh, 64, 64)))
    flags = torch.from_numpy(rng.integers(0, 4, bw).astype(np.int32)).cuda()
    return (t(rng.normal(0, 1, (bw, 64, c))),
            t(rng.normal(0, 1, (bw, 64, 3 * c))), params, bias, flags)


def _check(kern, plain, args, kw, n_act=1):
    """The first ``n_act`` arguments are the activations (cast to bf16
    for the bf16 rule)."""
    before = kern.launches
    k32 = kern(*args, **kw).float()
    p32 = plain(*args, **kw).float()
    assert kern.launches == before + 1
    assert (k32 - p32).abs().max().item() <= 1e-4
    a16 = tuple(a.bfloat16() for a in args[:n_act]) + tuple(args[n_act:])
    k16 = kern(*a16, **kw).float()
    p16 = plain(*a16, **kw).float()
    e_k = (k16 - p32).abs().max().item()
    e_p = (p16 - p32).abs().max().item()
    assert e_k <= max(2 * e_p, 0.02), (e_k, e_p)


@pytest.mark.parametrize("bw,c,nh", [(256, 96, 3), (64, 192, 6), (37, 64, 2)])
@pytest.mark.parametrize("shift", [0, 4])
def test_kernel_a_matches_plain(bw, c, nh, shift):
    from waifu2x_tensorrt_tpu_torch.ops import window_attention as wa

    _x, qkv, _p, bias, flags = _inputs(bw, c, nh, bw + shift)
    _check(wa.fused_window_attention_qkv, wa.window_attention_qkv_plain,
           (qkv, bias, flags), {"num_heads": nh, "shift": shift})


@pytest.mark.parametrize("bw,c,nh", [(256, 96, 3), (64, 192, 6), (37, 64, 2)])
@pytest.mark.parametrize("shift", [0, 4])
def test_kernel_b_matches_plain(bw, c, nh, shift):
    from waifu2x_tensorrt_tpu_torch.ops import swin_block as sb

    x, _q, params, bias, flags = _inputs(bw, c, nh, bw + shift + 1)
    _check(sb.fused_swin_block, sb.swin_block_plain,
           (x, params, bias, flags), {"num_heads": nh, "shift": shift})


@pytest.mark.parametrize("bw,c,nh", [
    (512, 96, 3), (256, 192, 6), (37, 96, 3), (37, 192, 6), (1, 96, 3),
    (1, 192, 6),
])
@pytest.mark.parametrize("shift", [0, 4])
def test_kernel_b_tensor_core_shapes(bw, c, nh, shift):
    """The bf16 tensor-core kernel at the flagship widths, with window
    counts that fill, half-fill (odd BW) or barely use a CTA of two
    windows; prepared operands give the same bytes as per-call ones."""
    from waifu2x_tensorrt_tpu_torch.ops import swin_block as sb

    x, _q, params, bias, flags = _inputs(bw, c, nh, bw + c + shift)
    kw = {"num_heads": nh, "shift": shift}
    _check(sb.fused_swin_block, sb.swin_block_plain,
           (x, params, bias, flags), kw)
    x16 = x.bfloat16()
    ops = sb.block_operands(params, bias, torch.bfloat16)
    assert ops.out_in
    before = sb.fused_swin_block.launches
    got = sb.swin_block_prepared(x16, ops, flags, shift=shift)
    assert sb.fused_swin_block.launches == before + 1
    assert torch.equal(got, sb.fused_swin_block(x16, params, bias, flags,
                                                **kw))


@pytest.mark.parametrize("c,nh", [(96, 3), (192, 6)])
def test_kernel_b_large_logits(c, nh):
    """q.k scaled up (the q and k columns of the qkv weights x 12: head-0
    logits beyond 100, where exp without the max-subtraction overflows
    fp32) under the shift mask in every window: the max-subtraction and
    the masked zeros must hold. v keeps its scale, so the output stays
    near unit size and the fp32 limit keeps its meaning."""
    from waifu2x_tensorrt_tpu_torch.ops import swin_block as sb

    x, _q, params, bias, flags = _inputs(64, c, nh, 7 + c)
    qk_scale = torch.ones(3 * c, device="cuda")
    qk_scale[:2 * c] = 12
    params = dict(params, qkv_kernel=params["qkv_kernel"] * qk_scale)
    flags = torch.full_like(flags, 3)  # every window masked both ways
    kw = {"num_heads": nh, "shift": 4}
    qkv = sb._dense(sb.layernorm(x, params["n1_scale"], params["n1_bias"]),
                    params["qkv_kernel"], params["qkv_bias"], x.dtype)
    logits = (qkv[..., :32] * 32 ** -0.5) @ qkv[..., c:c + 32].transpose(1, 2)
    assert logits.abs().max().item() > 100
    _check(sb.fused_swin_block, sb.swin_block_plain,
           (x, params, bias, flags), kw)
    out = sb.fused_swin_block(x.bfloat16(), params, bias, flags, **kw)
    assert torch.isfinite(out.float()).all()


def test_kernel_b_wrapper_checks():
    from waifu2x_tensorrt_tpu_torch.ops import swin_block as sb

    x, _q, params, bias, flags = _inputs(8, 96, 3, 3)
    ops = sb.block_operands(params, bias, torch.bfloat16)
    with pytest.raises(TypeError):  # operands built for another dtype
        sb.swin_block_prepared(x, ops, flags)
    with pytest.raises(ValueError):  # C of x and operands differ
        sb.swin_block_prepared(x[..., :64].bfloat16().contiguous(), ops,
                               flags)
    x16 = torch.empty(x.numel() + 1, dtype=torch.bfloat16, device="cuda")
    x16 = x16[1:].view(x.shape)
    x16.copy_(x)
    with pytest.raises(ValueError):  # not 16-byte aligned
        sb.swin_block_prepared(x16, ops, flags)


@pytest.mark.parametrize("bw,nh", [(256, 3), (64, 6), (37, 2)])
@pytest.mark.parametrize("shift", [0, 4])
def test_kernel_e_matches_plain(bw, nh, shift):
    from waifu2x_tensorrt_tpu_torch.ops import window_attention as wa

    _x, qkv, _p, bias, flags = _inputs(bw, nh * 32, nh, bw + shift + 2)
    q, k, v = (t.reshape(bw, 64, nh, 32).permute(0, 2, 1, 3).contiguous()
               for t in qkv.chunk(3, dim=-1))
    _check(wa.fused_window_attention, wa.window_attention_plain,
           (q, k, v, bias, flags), {"shift": shift}, n_act=3)


@pytest.mark.parametrize("r,w,dtype", [
    (4, 40, torch.float32), (2, 72, torch.bfloat16), (4, 256, torch.bfloat16),
])
def test_kernel_d_equals_plain(r, w, dtype):
    from waifu2x_tensorrt_tpu_torch.models.swin_unet import _pixel_shuffle
    from waifu2x_tensorrt_tpu_torch.ops import head_pack as hp

    rng = np.random.default_rng(r + w)
    z = torch.from_numpy(rng.uniform(-0.3, 1.3, (3, 24, w, 3 * r * r))
                         .astype(np.float32)).to("cuda", dtype)
    before = hp.pack_head_x16.launches
    got = hp.pack_head_x16(z, r=r)
    assert hp.pack_head_x16.launches == before + 1
    assert torch.equal(got, hp.pack_head_plain(z, r))
    pix = _pixel_shuffle(torch.clamp(z, 0.0, 1.0), r).contiguous()
    assert torch.equal(got.reshape(-1).view(torch.uint8),
                       pix.reshape(-1).view(torch.uint8))
    # an input that is not 16-byte aligned takes the one-value read path
    shifted = torch.empty(z.numel() + 1, dtype=dtype, device="cuda")
    shifted = shifted[1:].view(z.shape)
    shifted.copy_(z)
    assert torch.equal(hp.pack_head_x16(shifted, r=r), got)


@pytest.mark.parametrize("frame_hw,scale,batch,dtype", [
    ((100, 110), 2, 3, torch.float32),
    ((150, 260), 2, 5, torch.bfloat16),
    ((180, 330), 4, 16, torch.bfloat16),
])
def test_kernel_c_byte_identical_to_scan(frame_hw, scale, batch, dtype):
    from waifu2x_tensorrt_tpu_torch.engine.config import (
        Precision,
        RenderConfig,
    )
    from waifu2x_tensorrt_tpu_torch.engine.renderer import make_chunked_fns
    from waifu2x_tensorrt_tpu_torch.models.registry import get_spec
    from waifu2x_tensorrt_tpu_torch.ops.finalize_epilogue import (
        finalize_gather,
        finalize_scan,
    )

    cfg = RenderConfig(precision=Precision.FP16, batch_size=batch,
                       height=64, width=64, scaling=scale,
                       overlap=(1 / 16, 1 / 16))
    _p, fin, plan, sizes = make_chunked_fns(
        get_spec("swin_unet/art", scale, -1), cfg, frame_hw, "cuda")
    oh, ow = plan.output_tile
    rng = np.random.default_rng(0)
    outs = [torch.from_numpy(rng.random((n, oh, ow, 3), np.float32))
            .to("cuda", dtype) for n in sizes]
    want = finalize_scan(outs, plan)
    before = finalize_gather.launches
    assert torch.equal(fin(*outs), want)
    assert finalize_gather.launches == before + 1
    whole = torch.cat(outs, 0)
    padded = torch.cat([whole[:3], whole, whole[:2]], 0)
    cut = plan.tile_count // 2
    pieces = (padded[3:3 + cut], padded[3 + cut:3 + plan.tile_count])
    assert torch.equal(fin(*pieces), want)


def test_wrappers_reject_what_the_kernels_do_not_take():
    from waifu2x_tensorrt_tpu_torch.ops import window_attention as wa

    _x, qkv, _p, bias, flags = _inputs(8, 96, 3, 0)
    with pytest.raises(TypeError):
        wa.fused_window_attention_qkv(qkv.half(), bias, flags, num_heads=3)
    with pytest.raises(ValueError):
        wa.fused_window_attention_qkv(qkv[:, :, :96 * 3 - 3], bias, flags,
                                      num_heads=3)
    with pytest.raises(ValueError):
        wa.fused_window_attention_qkv(qkv.transpose(0, 1), bias, flags,
                                      num_heads=3)
    q = qkv[:, :, :96].reshape(8, 64, 3, 32).permute(0, 2, 1, 3)
    with pytest.raises(ValueError):  # not contiguous
        wa.fused_window_attention(q, q, q, bias, flags)
    qc = q.contiguous()
    with pytest.raises(TypeError):
        wa.fused_window_attention(qc, qc.bfloat16(), qc, bias, flags)

    from waifu2x_tensorrt_tpu_torch.ops import head_pack as hp

    z = torch.rand(2, 8, 8, 48, device="cuda")
    with pytest.raises(TypeError):
        hp.pack_head_x16(z.half(), r=4)
    with pytest.raises(ValueError):
        hp.pack_head_x16(z.transpose(1, 2), r=4)
