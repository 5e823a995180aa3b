"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Skipped without a CUDA device (the kernels have no CPU mode); on a
machine with one, run
``python -m pytest --noconftest tests/test_torch_cuda_kernels.py`` (the
conftest sets up JAX, which such a machine need not have).
Same checks as phases 3, 4 and 8 of ``chip_smoke.py``, at smaller
shapes: kernels A, B and E within fp32 max |d| <= 1e-4 (TF32 off) and the
bf16 rule |k16 - p32| <= max(2 |p16 - p32|, 0.02); the bf16 tensor-core
kernel of A and E at every C it takes, with one (window, head) unit, with
fewer units than resident CTAs and with more (each CTA walks several),
under each flags value and with logits beyond 100; kernel B's bf16
tensor-core kernel also at C 96 / 3 heads and C 192 / 6 heads with window
counts of 1, 37 and full CTAs, on prepared operands (the same bytes as
per-call ones, one launch counted), and with logits beyond 100 under the
shift mask; kernel C byte-identical
to the scan, with whole chunks and TileStream pieces that start
mid-chunk, at scale 2 and 4, in bf16 and fp32, on a single tile, 1-row
and 1-column grids, rows whose bytes are not a multiple of 16 and T up to
576, with a frame and tiles that are not 16-byte aligned, and with no
synchronizing call in ``finalize`` (``set_sync_debug_mode("error")``); kernel D equal to
its plain twin and to the clamped pixel shuffle, byte for byte, also with
item counts that leave the last CTA partly idle and with NaN, infinities
and -0.0 among the values; kernel F (the int8/bf16 probe) at the probe's
four shapes, at the smallest tile (M 32), at N 96 and 288 and with A in
registers and in shared memory, int8 equal to its plain twin and bf16
within the float32 sum bound ``fp32_sum_bound``.
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
    _check(wa.fused_window_attention, wa.window_attention_plain,
           (*_unpacked(qkv, nh), bias, flags), {"shift": shift}, n_act=3)


def _unpacked(qkv, nh):
    """Kernel E's q, k, v (BW, nh, 64, 32) from packed qkv."""
    bw = qkv.shape[0]
    return tuple(t.reshape(bw, 64, nh, 32).permute(0, 2, 1, 3).contiguous()
                 for t in qkv.chunk(3, dim=-1))


@pytest.mark.parametrize("bw,c,nh", [
    (1, 96, 3), (1, 192, 6), (600, 96, 3), (300, 192, 6), (37, 32, 1),
    (37, 128, 4), (37, 160, 5),
])
def test_kernel_a_tensor_core_shapes(bw, c, nh):
    """Every C from 32 to 192; one window, and more (window, head) units
    than resident CTAs (each CTA walks several through its ring, some one
    more than others); shift 4, flags of every kind."""
    from waifu2x_tensorrt_tpu_torch.ops import window_attention as wa

    _x, qkv, _p, bias, _f = _inputs(bw, c, nh, bw + c)
    flags = torch.arange(bw, dtype=torch.int32, device="cuda") % 4
    _check(wa.fused_window_attention_qkv, wa.window_attention_qkv_plain,
           (qkv, bias, flags), {"num_heads": nh, "shift": 4})


@pytest.mark.parametrize("bw,nh", [(1, 1), (1, 3), (5, 1), (37, 2),
                                   (500, 3), (200, 6)])
def test_kernel_e_tensor_core_shapes(bw, nh):
    """One (window, head) unit, fewer units than resident CTAs, and more
    (1500 and 1200: each CTA walks several, some one more than others)."""
    from waifu2x_tensorrt_tpu_torch.ops import window_attention as wa

    _x, qkv, _p, bias, _f = _inputs(bw, nh * 32, nh, bw + nh + 3)
    flags = torch.arange(bw, dtype=torch.int32, device="cuda") % 4
    _check(wa.fused_window_attention, wa.window_attention_plain,
           (*_unpacked(qkv, nh), bias, flags), {"shift": 4}, n_act=3)


@pytest.mark.parametrize("fl", range(4))
def test_kernels_a_e_every_flag(fl):
    """Every window with the same flags value under shift 4: no mask,
    the row seam, the column seam, both."""
    from waifu2x_tensorrt_tpu_torch.ops import window_attention as wa

    _x, qkv, _p, bias, flags = _inputs(64, 96, 3, 20 + fl)
    flags = torch.full_like(flags, fl)
    _check(wa.fused_window_attention_qkv, wa.window_attention_qkv_plain,
           (qkv, bias, flags), {"num_heads": 3, "shift": 4})
    _check(wa.fused_window_attention, wa.window_attention_plain,
           (*_unpacked(qkv, 3), bias, flags), {"shift": 4}, n_act=3)


@pytest.mark.parametrize("c,nh", [(96, 3), (192, 6)])
def test_kernels_a_e_large_logits(c, nh):
    """q and k scaled by 6 (logits beyond 100, where exp without the
    max-subtraction overflows fp32) under the shift mask in every window:
    the max-subtraction and the masked zeros must hold. v keeps its
    scale, so the output stays near unit size and the fp32 limit keeps
    its meaning."""
    from waifu2x_tensorrt_tpu_torch.ops import window_attention as wa

    _x, qkv, _p, bias, flags = _inputs(64, c, nh, 9 + c)
    qk_scale = torch.ones(3 * c, device="cuda")
    qk_scale[:2 * c] = 6
    qkv = (qkv * qk_scale).contiguous()
    flags = torch.full_like(flags, 3)
    logits = (qkv[..., :32] * 32 ** -0.5) @ qkv[..., c:c + 32].transpose(1, 2)
    assert logits.abs().max().item() > 100
    _check(wa.fused_window_attention_qkv, wa.window_attention_qkv_plain,
           (qkv, bias, flags), {"num_heads": nh, "shift": 4})
    _check(wa.fused_window_attention, wa.window_attention_plain,
           (*_unpacked(qkv, nh), bias, flags), {"shift": 4}, n_act=3)
    for out in (wa.fused_window_attention_qkv(qkv.bfloat16(), bias, flags,
                                              num_heads=nh, shift=4),
                wa.fused_window_attention(
                    *(t.bfloat16() for t in _unpacked(qkv, nh)), bias, flags,
                    shift=4)):
        assert torch.isfinite(out.float()).all()


@pytest.mark.parametrize("bw,c,nh", [(300, 96, 3), (100, 192, 6)])
def test_kernels_a_e_fp32(bw, c, nh):
    """The fp32 instantiations (attention_core on the CUDA cores) against
    the plain twin, max |d| <= 1e-4 with TF32 off, shift 4."""
    from waifu2x_tensorrt_tpu_torch.ops import window_attention as wa

    _x, qkv, _p, bias, flags = _inputs(bw, c, nh, bw + c + 5)
    got = wa.fused_window_attention_qkv(qkv, bias, flags, num_heads=nh,
                                        shift=4)
    want = wa.window_attention_qkv_plain(qkv, bias, flags, num_heads=nh,
                                         shift=4)
    assert (got - want).abs().max().item() <= 1e-4
    q, k, v = _unpacked(qkv, nh)
    got = wa.fused_window_attention(q, k, v, bias, flags, shift=4)
    want = wa.window_attention_plain(q, k, v, bias, flags, shift=4)
    assert (got - want).abs().max().item() <= 1e-4


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


@pytest.mark.parametrize("r,shape,dtype", [
    (4, (1, 1, 4), torch.bfloat16), (4, (2, 3, 20), torch.bfloat16),
    (4, (1, 7, 12), torch.float32), (2, (2, 3, 24), torch.bfloat16),
    (2, (1, 5, 8), torch.float32), (4, (3, 37, 132), torch.bfloat16),
])
def test_kernel_d_ragged_work_units(r, shape, dtype):
    """Item counts that are not a multiple of a CTA's threads x items
    (the last CTA partly idle), single rows and widths down to one item,
    and NaN, infinities and -0.0 among the values (NaN passes the clamp)."""
    from waifu2x_tensorrt_tpu_torch.ops import head_pack as hp

    rng = np.random.default_rng(sum(shape) + r)
    z = torch.from_numpy(rng.uniform(-0.3, 1.3, (*shape, 3 * r * r))
                         .astype(np.float32)).to("cuda", dtype)
    flat = z.view(-1)
    flat[::7] = float("nan")
    flat[1::11] = float("inf")
    flat[2::13] = -float("inf")
    flat[3::17] = -0.0
    got = hp.pack_head_x16(z, r=r)
    want = hp.pack_head_plain(z, r)
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


def _finalize_case(frame_hw, scale, batch, dtype, seed=0):
    from waifu2x_tensorrt_tpu_torch.engine.config import (
        Precision,
        RenderConfig,
    )
    from waifu2x_tensorrt_tpu_torch.engine.renderer import make_chunked_fns
    from waifu2x_tensorrt_tpu_torch.models.registry import get_spec

    cfg = RenderConfig(precision=Precision.FP16, batch_size=batch,
                       height=64, width=64, scaling=scale,
                       overlap=(1 / 16, 1 / 16))
    _p, fin, plan, sizes = make_chunked_fns(
        get_spec("swin_unet/art", scale, -1), cfg, frame_hw, "cuda")
    oh, ow = plan.output_tile
    rng = np.random.default_rng(seed)
    outs = [torch.from_numpy(rng.random((n, oh, ow, 3), np.float32))
            .to("cuda", dtype) for n in sizes]
    return fin, plan, outs


@pytest.mark.parametrize("frame_hw,scale,batch,dtype", [
    ((100, 110), 2, 3, torch.float32),
    ((150, 260), 2, 5, torch.bfloat16),
    ((180, 330), 4, 16, torch.bfloat16),
    ((70, 90), 4, 3, torch.float32),       # scale 4, 2 x 2 tiles
    ((61, 131), 2, 3, torch.bfloat16),     # rows of 786 bytes (not 16k)
    ((37, 53), 2, 2, torch.float32),       # one tile, rows of 318 bytes
    ((40, 200), 2, 3, torch.bfloat16),     # 1-row grid
    ((200, 40), 2, 3, torch.float32),      # 1-column grid
    ((540, 960), 2, 16, torch.bfloat16),   # T 144
    ((1080, 1920), 2, 64, torch.bfloat16),  # T 576 > 256
    ((1080, 1920), 2, 64, torch.float32),
])
def test_kernel_c_byte_identical_to_scan(frame_hw, scale, batch, dtype):
    from waifu2x_tensorrt_tpu_torch.ops.finalize_epilogue import (
        finalize_gather,
        finalize_scan,
    )

    fin, plan, outs = _finalize_case(frame_hw, scale, batch, dtype)
    want = finalize_scan(outs, plan)
    before = finalize_gather.launches
    assert torch.equal(fin(*outs), want)
    assert finalize_gather.launches == before + 1
    whole = torch.cat(outs, 0)
    pad = torch.zeros((3, *whole.shape[1:]), dtype=dtype, device="cuda")
    padded = torch.cat([pad, whole, pad[:2]], 0)
    T = plan.tile_count
    # pieces that start mid-chunk, cut at several points
    for cuts in ([T // 2], [1, T - 1] if T > 1 else [1], [T // 3, T // 2]):
        pieces, start = [], 3
        for end in [3 + c for c in cuts] + [3 + T]:
            if end > start:
                pieces.append(padded[start:end])
                start = end
        assert torch.equal(fin(*pieces), want), cuts


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_c_unaligned_frame_and_tiles(dtype):
    """A frame whose base is not 16-byte aligned (partial windows at both
    ends of every row) and tiles that are not (the scalar loads)."""
    from waifu2x_tensorrt_tpu_torch.ops.finalize_epilogue import (
        finalize_gather,
        finalize_scan,
        grid_geometry,
    )

    fin, plan, outs = _finalize_case((100, 110), 2, 3, dtype, seed=1)
    want = finalize_scan(outs, plan)
    oh, ow = plan.output_tile
    T = plan.tile_count
    whole = torch.cat(outs, 0)[:T]
    buf = torch.empty(whole.numel() + 1, dtype=dtype, device="cuda")
    shifted = buf[1:].view(whole.shape)
    shifted.copy_(whole)
    step = oh * ow * 3 * whole.element_size()
    for tiles in (whole, shifted):
        table = torch.tensor([tiles.data_ptr() + t * step for t in range(T)],
                             dtype=torch.int64, device="cuda")
        rw = torch.from_numpy(plan.row_weights).cuda()
        cw = torch.from_numpy(plan.col_weights).cuda()
        frame = torch.zeros(want.numel() + 5, dtype=torch.uint8,
                            device="cuda")
        out = frame[5:].view(want.shape)
        finalize_gather(table, rw, cw, out, (*grid_geometry(plan), oh, ow),
                        dtype == torch.bfloat16)
        assert torch.equal(out, want)
        assert not frame[:5].any()


def test_kernel_c_finalize_makes_no_synchronizing_call():
    from waifu2x_tensorrt_tpu_torch.ops.finalize_epilogue import (
        finalize_scan,
    )

    fin, plan, outs = _finalize_case((150, 260), 2, 5, torch.bfloat16)
    want = finalize_scan(outs, plan)
    fin(*outs)  # builds the kernels, warms the allocators
    torch.cuda.synchronize()
    got = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(4):
            got.append(fin(*outs))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for g in got:
        assert torch.equal(g, want)


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
    shifted = torch.empty(qkv.numel() + 1, dtype=torch.bfloat16,
                          device="cuda")
    shifted = shifted[1:].view(qkv.shape)
    shifted.copy_(qkv)
    with pytest.raises(ValueError):  # not 16-byte aligned
        wa.fused_window_attention_qkv(shifted, bias, flags, num_heads=3)

    from waifu2x_tensorrt_tpu_torch.ops import head_pack as hp

    z = torch.rand(2, 8, 8, 48, device="cuda")
    with pytest.raises(TypeError):
        hp.pack_head_x16(z.half(), r=4)
    with pytest.raises(ValueError):
        hp.pack_head_x16(z.transpose(1, 2), r=4)


@pytest.mark.parametrize("m,k,n", [(512, 1024, 512), (2048, 96, 288),
                                   (2048, 96, 384), (2048, 384, 96)])
def test_kernel_f_matches_plain(m, k, n):
    """The probe's shapes at R = 3: int8 equal, bf16 within the bound of
    two float32 sums of the same exact products."""
    from waifu2x_tensorrt_tpu_torch.ops.mma_probe import (
        fp32_sum_bound,
        mma_probe,
        mma_probe_plain,
    )
    from waifu2x_tensorrt_tpu_torch.probes.int8_probe import (
        make_inputs,
        stack2,
    )

    a8, b8, abf, bbf = make_inputs(m, k, n, np.random.default_rng(m + n),
                                   "cuda")
    for a, b in ((a8, b8), (abf, bbf)):
        before = mma_probe.launches
        got = mma_probe(stack2(a), b, 3)
        assert mma_probe.launches == before + 1
        want = mma_probe_plain(stack2(a), b, 3)
        if a.dtype == torch.int8:
            assert got.dtype == torch.int32 and torch.equal(got, want)
        else:
            assert got.dtype == torch.float32
            err = (got - want).abs().max().item()
            assert err <= fp32_sum_bound(a, b), err


@pytest.mark.parametrize("reps", [0, 1, 2, 7])
def test_kernel_f_extreme_int8(reps):
    """-128 entries (whole rows and columns of them, the largest |D|) at
    both CTA tilings (M 64: 32-row tiles; M 4096 x N 64: 64-row tiles)."""
    from waifu2x_tensorrt_tpu_torch.ops.mma_probe import (
        mma_probe,
        mma_probe_plain,
    )

    rng = np.random.default_rng(reps)
    for m, k, n in ((64, 2048, 32), (4096, 96, 64)):
        a = torch.from_numpy(rng.integers(-128, 128, (m, k), np.int8))
        b = torch.from_numpy(rng.integers(-128, 128, (k, n), np.int8))
        a[0], a[-1], b[:, 0], b[:, -1] = -128, -128, -128, 127
        a2, b = torch.stack([a, a]).cuda(), b.cuda()
        got = mma_probe(a2, b, reps)
        assert torch.equal(got, mma_probe_plain(a2, b, reps))
        assert got[0, 0].item() == (128 * 128 * k if reps else 0)


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_kernel_f_reads_the_first_copy(dtype):
    """With a2[1] unlike a2[0], the kernel and its plain twin both take
    every product from a2[0]: bf16 at R 2 returns a2[0] @ b, not
    a2[1] @ b."""
    from waifu2x_tensorrt_tpu_torch.ops.mma_probe import (
        fp32_sum_bound,
        mma_probe,
        mma_probe_plain,
    )
    from waifu2x_tensorrt_tpu_torch.probes.int8_probe import make_inputs

    a8, b8, abf, bbf = make_inputs(2048, 96, 288, np.random.default_rng(5),
                                   "cuda")
    a, b = (a8, b8) if dtype == torch.int8 else (abf, bbf)
    a2 = torch.stack([a, -a if dtype == torch.bfloat16 else a.flip(0)])
    for reps in (1, 2, 3):
        got, want = mma_probe(a2, b, reps), mma_probe_plain(a2, b, reps)
        if dtype == torch.int8:
            assert torch.equal(got, want)
        else:
            tol = fp32_sum_bound(a, b)
            assert (got - want).abs().max().item() <= tol
            exact = a.double() @ b.double()
            assert (got.double() - exact).abs().max().item() <= tol


def test_kernel_f_wrapper_checks():
    from waifu2x_tensorrt_tpu_torch.ops.mma_probe import mma_probe

    a2 = torch.zeros(2, 64, 96, dtype=torch.int8, device="cuda")
    b = torch.zeros(96, 32, dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError):  # b not contiguous
        mma_probe(a2, torch.zeros(32, 96, dtype=torch.int8,
                                  device="cuda").t(), 1)
    with pytest.raises(TypeError):  # float16 is not a probe type
        mma_probe(a2.half(), b.half(), 1)
    with pytest.raises(ValueError):  # one operand on the CPU
        mma_probe(a2, b.cpu(), 1)
    shifted = torch.zeros(2 * 64 * 96 + 8, dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError):  # not 16-byte aligned
        mma_probe(shifted[8:].view(2, 64, 96), b, 1)
    b_shifted = torch.zeros(96 * 32 + 8, dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError):  # b not 16-byte aligned
        mma_probe(a2, b_shifted[8:].view(96, 32), 1)


@pytest.mark.parametrize("m,k,n", [(32, 32, 32), (32, 96, 96),
                                   (32, 1024, 288), (96, 160, 96),
                                   (64, 64, 288), (32, 224, 64)])
def test_kernel_f_small_tiles(m, k, n):
    """The smallest tile (M 32: half of wgmma's 64 rows are zero padding
    and not stored), N 96 and 288, and K on both sides of the register-A
    limit of 512 bytes a row (A in registers up to bf16 K 224 and int8 K
    160 here, from shared memory at bf16 K 1024), with 1 to 64 k steps a
    product, at R 0, 1, 2 and 5."""
    from waifu2x_tensorrt_tpu_torch.ops.mma_probe import (
        fp32_sum_bound,
        mma_probe,
        mma_probe_plain,
    )
    from waifu2x_tensorrt_tpu_torch.probes.int8_probe import (
        make_inputs,
        stack2,
    )

    a8, b8, abf, bbf = make_inputs(m, k, n, np.random.default_rng(m * k + n),
                                   "cuda")
    for a, b in ((a8, b8), (abf, bbf)):
        for reps in (0, 1, 2, 5):
            got = mma_probe(stack2(a), b, reps)
            want = mma_probe_plain(stack2(a), b, reps)
            if a.dtype == torch.int8:
                assert torch.equal(got, want)
            else:
                err = (got - want).abs().max().item()
                assert err <= fp32_sum_bound(a, b), err
