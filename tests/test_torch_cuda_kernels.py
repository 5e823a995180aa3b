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
shift mask; kernel B on (B, H, W, C) activations (``swin_block_bhwc``:
the roll and the window partition in its addressing) byte-identical to
the roll, window split, windowed kernel, merge and roll back it
replaces, bf16 and fp32, C 96 and 192, shift 0 and 4, square and
rectangular window grids, batches 1, 3 and 16, one window and a count
that leaves the last CTA one window; kernel C byte-identical
to the scan, with whole chunks and TileStream pieces that start
mid-chunk, at scale 2 and 4, in bf16 and fp32, on a single tile, 1-row
and 1-column grids, rows whose bytes are not a multiple of 16 and T up to
576, with a frame and tiles that are not 16-byte aligned, and with no
synchronizing call in ``finalize`` (``set_sync_debug_mode("error")``);
kernel C on the plans of cunet (tile 256: stride 408, tile 440, a canvas
larger than the frame), of whole-frame tiles (T = 1) and of TTA (the fp32
mean of the 8 inverses), byte-identical to the CPU's finalize of the same
outputs; a cunet bf16 render on the card against the CPU's fp32 render
within 0.02 x 255 in u8; swin renders of tiles the model pads inside
(whole frame, tile 400) on the card against the CPU's, golden gate;
kernel D equal to
its plain twin and to the clamped pixel shuffle, byte for byte, also with
item counts that leave the last CTA partly idle and with NaN, infinities
and -0.0 among the values; kernel F (the int8/bf16 probe) at the probe's
four shapes, at the smallest tile (M 32), at N 96 and 288 and with A in
registers and in shared memory, int8 equal to its plain twin and bf16
within the float32 sum bound ``fp32_sum_bound``; ``fetch_async`` (the
CLI's fetch into pinned memory, no synchronizing call) and
``Upscaler.render_async`` (bucketed, cropped) equal to the synchronous
fetch and ``render``; captured programs (``engine/exe_cache.py``): a
flagship-width chunk through its CUDA graph byte-identical to the module
called eagerly at the same shape, N replays adding N times the capture's
launch counts, no synchronizing call in a replay or in a streamed frame
around replays, a ``fuse_frame`` 720p flagship frame within 1 LSB of the
chunked render; kernel B launched from the kernel library and from a
variant copy of it in one process, in bf16 and fp32, a first launch of
the variant's kernel inside a graph capture; kernel B's fp32 kernel
(register-tiled FMA) at every C from 32 to 192 with 1, 37, 512 and 4096
windows, shift 0 and 4 and every flags value, and with logits beyond 100,
on prepared operands equal byte for byte to per-call ones; kernel G
(HAT's window attention) by the bf16 rule against its plain twin, self
(shift 0 and 8) and overlapping, on a rectangular map whose windows
wrap and touch every border, and with scores past 100, refusing fp32,
and a captured HAT chunk byte-identical to the eager one, its kernel-G
and kernel-I launches recorded; kernel I (HAT's residual sums and their
LayerNorm) at the HAT cell's chunk and with odd row counts at C 12, 144,
180 and 256, in its three variants: y byte-equal to the twin's, n within
one bf16 ulp, refusing fp32, fp16, strided, unaligned and mixed-device
tensors; the fp32
kernel of A and E at ragged and flagship counts; a captured tf32 chunk
byte-identical to the eager one; the program's spans
(``utils/profiling.py``) on a traced stream: device seconds for every
stage, summing to at least the profiler's busy time and at most the
window, no ``w2x.*`` device event, one ``w2x.capture`` at a new chunk
shape and no timing event recorded inside a capture.
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


@pytest.mark.parametrize("c,nh", [(96, 3), (192, 6), (128, 4), (160, 5)])
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


def _fp32_close(got, want):
    assert got.dtype == want.dtype == torch.float32
    err = (got - want).abs().max().item()
    assert err <= 1e-4, err


@pytest.mark.parametrize("bw", [1, 37, 512, 4096])
@pytest.mark.parametrize("c", [32, 64, 96, 128, 160, 192])
def test_kernel_b_fp32_every_width(c, bw):
    """The fp32 kernel (register-tiled FMA on the CUDA cores, no TF32) at
    every C of the dispatch, with one window, a ragged count (the last CTA
    of two windows half empty at C <= 96) and full grids, shift 0 and 4,
    window i with flags (i + 1) % 4: max |d| <= 1e-4 against the plain
    twin with TF32 off, one launch a call; prepared operands give the
    bytes of per-call ones."""
    from waifu2x_tensorrt_tpu_torch.ops import swin_block as sb

    nh = c // 32
    x, _q, params, bias, _f = _inputs(bw, c, nh, bw + c)
    flags = (torch.arange(bw, dtype=torch.int32, device="cuda") + 1) % 4
    ops = sb.block_operands(params, bias, torch.float32)
    assert not ops.out_in
    for shift in (0, 4):
        before = sb.fused_swin_block.launches
        got = sb.fused_swin_block(x, params, bias, flags, num_heads=nh,
                                  shift=shift)
        assert sb.fused_swin_block.launches == before + 1
        _fp32_close(got, sb.swin_block_plain(x, params, bias, flags,
                                             num_heads=nh, shift=shift))
        assert torch.equal(sb.swin_block_prepared(x, ops, flags,
                                                  shift=shift), got)


@pytest.mark.parametrize("fl", range(4))
@pytest.mark.parametrize("c,nh", [(96, 3), (192, 6)])
def test_kernel_b_fp32_every_flag(c, nh, fl):
    """Every window with the same flags value under shift 4 (no mask, the
    row seam, the column seam, both) at the flagship widths, BW 37."""
    from waifu2x_tensorrt_tpu_torch.ops import swin_block as sb

    x, _q, params, bias, flags = _inputs(37, c, nh, 40 + fl + c)
    flags = torch.full_like(flags, fl)
    _fp32_close(sb.fused_swin_block(x, params, bias, flags, num_heads=nh,
                                    shift=4),
                sb.swin_block_plain(x, params, bias, flags, num_heads=nh,
                                    shift=4))


def _rolled_windows_block(x, ops, shift):
    """The composition that kernel B's addressing replaces: roll by
    -shift, window split, the windowed kernel, window merge, roll back."""
    from waifu2x_tensorrt_tpu_torch.ops import swin_block as sb

    b, h, w, c = x.shape
    if shift:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
    out = sb.swin_block_prepared(
        sb.window_split(x, 8).reshape(-1, 64, c).contiguous(), ops,
        sb.flags_tensor(b, h // 8, w // 8, x.device), shift=shift)
    out = sb.window_merge(out.reshape(b, -1, 64, c), h, w, 8)
    return torch.roll(out, (shift, shift), dims=(1, 2)) if shift else out


@pytest.mark.parametrize("b,nwy,nwx", [
    (1, 16, 16), (3, 8, 8), (16, 16, 16), (1, 46, 80), (3, 3, 5), (1, 1, 1)])
@pytest.mark.parametrize("c,nh", [(96, 3), (192, 6)])
@pytest.mark.parametrize("shift", [0, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_kernel_b_on_activations_is_the_rolled_windows_block(
        dtype, shift, c, nh, b, nwy, nwx):
    """Kernel B on a (B, H, W, C) activation (``swin_block_bhwc``) against
    the roll, split, windowed kernel, merge and roll back it replaces,
    byte for byte: each window sees the same 64 tokens in the same order.
    Grids of 16 x 16 and 8 x 8 windows (the flagship's tiles at C 96 and
    C 192), 46 x 80 (a 720p frame padded to 368 x 640), 3 x 5 with 3
    images (45 windows: the last bf16 CTA holds one) and one window (the
    roll wraps inside it). One launch, counted as direct."""
    from waifu2x_tensorrt_tpu_torch.ops import swin_block as sb

    _x, _q, params, bias, _f = _inputs(1, c, nh, c + nwy + nwx + shift)
    ops = sb.block_operands(params, bias, dtype)
    gen = torch.Generator(device="cuda").manual_seed(b * nwy * nwx + c)
    x = torch.randn((b, 8 * nwy, 8 * nwx, c), generator=gen,
                    device="cuda").to(dtype)
    before = (sb.fused_swin_block.launches,
              sb.fused_swin_block.direct_launches)
    got = sb.swin_block_bhwc(x, ops, shift=shift)
    assert (sb.fused_swin_block.launches,
            sb.fused_swin_block.direct_launches) == (before[0] + 1,
                                                     before[1] + 1)
    want = _rolled_windows_block(x, ops, shift)
    assert got.shape == x.shape and got.dtype == dtype
    assert torch.equal(got, want)


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
    """The fp32 kernel (attention_f32_kernel on the CUDA cores) against
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


@pytest.mark.parametrize("bw,c,nh", [
    (1, 32, 1), (1, 192, 6), (37, 96, 3), (37, 160, 5), (512, 64, 2),
    (512, 128, 4), (4096, 96, 3), (1024, 192, 6),
])
def test_kernels_a_e_fp32_shapes(bw, c, nh):
    """The fp32 kernel of A and E (the persistent unit walk on the CUDA
    cores) with one window, ragged counts, more units than resident CTAs
    and the flagship shapes, shift 0 and 4, window i with flags i % 4:
    max |d| <= 1e-4 against the plain twins, one launch a call."""
    from waifu2x_tensorrt_tpu_torch.ops import window_attention as wa

    _x, qkv, _p, bias, _f = _inputs(bw, c, nh, bw + c + 11)
    flags = torch.arange(bw, dtype=torch.int32, device="cuda") % 4
    heads = _unpacked(qkv, nh)
    for shift in (0, 4):
        before = wa.fused_window_attention_qkv.launches
        _fp32_close(wa.fused_window_attention_qkv(qkv, bias, flags,
                                                  num_heads=nh, shift=shift),
                    wa.window_attention_qkv_plain(qkv, bias, flags,
                                                  num_heads=nh, shift=shift))
        assert wa.fused_window_attention_qkv.launches == before + 1
        before = wa.fused_window_attention.launches
        _fp32_close(wa.fused_window_attention(*heads, bias, flags,
                                              shift=shift),
                    wa.window_attention_plain(*heads, bias, flags,
                                              shift=shift))
        assert wa.fused_window_attention.launches == before + 1


@pytest.mark.parametrize("r,w,dtype", [
    (4, 40, torch.float32), (2, 72, torch.bfloat16), (4, 256, torch.bfloat16),
])
def test_kernel_d_equals_plain(r, w, dtype):
    from waifu2x_tensorrt_tpu_torch.ops.kernel_math import pixel_shuffle
    from waifu2x_tensorrt_tpu_torch.ops import head_pack as hp

    rng = np.random.default_rng(r + w)
    z = torch.from_numpy(rng.uniform(-0.3, 1.3, (3, 24, w, 3 * r * r))
                         .astype(np.float32)).to("cuda", dtype)
    before = hp.pack_head_x16.launches
    got = hp.pack_head_x16(z, r=r)
    assert hp.pack_head_x16.launches == before + 1
    assert torch.equal(got, hp.pack_head_plain(z, r))
    pix = pixel_shuffle(torch.clamp(z, 0.0, 1.0), r).contiguous()
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


def _slice_case(family, scale, tile, frame_hw, batch, dtype, tta=False,
                seed=0):
    """Kernel C's finalize of one geometry of this slice (cunet tiles,
    whole frame, TTA) on the card and the same finalize on the CPU (the
    plain scan, after the same TTA mean), with seeded model outputs."""
    from waifu2x_tensorrt_tpu_torch.engine.config import (
        Precision,
        RenderConfig,
    )
    from waifu2x_tensorrt_tpu_torch.engine.renderer import make_chunked_fns
    from waifu2x_tensorrt_tpu_torch.models.registry import get_spec

    cfg = RenderConfig(precision=Precision.FP16, batch_size=batch,
                       height=tile, width=tile, scaling=scale,
                       overlap=(1 / 16, 1 / 16), tta=tta)
    spec = get_spec(family, scale, 1)
    prep, fin, plan, sizes = make_chunked_fns(spec, cfg, frame_hw, "cuda")
    _p, fin_cpu, _plan, _s = make_chunked_fns(spec, cfg, frame_hw, "cpu")
    frame = torch.zeros((*frame_hw, 3), dtype=torch.uint8, device="cuda")
    rng = np.random.default_rng(seed)
    # the chunk shapes prepare gives, as the model's outputs would be
    # (rect TTA: the transposed group at (ow, oh))
    oh, ow = plan.output_tile
    outs = []
    for c in prep(frame):
        shape = (oh, ow) if c.shape[1] == plan.input_tile[0] else (ow, oh)
        outs.append(torch.from_numpy(
            rng.random((c.shape[0], *shape, 3), np.float32)).to("cuda",
                                                               dtype))
    return fin, fin_cpu, plan, outs


@pytest.mark.parametrize("family,scale,tile,frame_hw,batch,dtype,tta", [
    # cunet 2x t256 on 512^2: 3 x 3 tiles, stride 408, tile 440, the
    # canvas (1256^2) larger than the frame (1024^2)
    ("cunet/art", 2, 256, (512, 512), 4, torch.bfloat16, False),
    ("cunet/art", 2, 256, (512, 512), 4, torch.float32, False),
    ("cunet/art", 1, 256, (300, 500), 4, torch.bfloat16, False),
    # whole frame (T 1): the output is the canvas at 512^2, cropped from
    # it at other sizes
    ("cunet/art", 2, 0, (512, 512), 1, torch.bfloat16, False),
    ("cunet/art", 2, 0, (301, 203), 1, torch.float32, False),
    ("swin_unet/art", 2, 0, (40, 56), 1, torch.bfloat16, False),
    # TTA: the fp32 mean of the 8 inverses as one chunk
    ("swin_unet/art", 4, 64, (100, 70), 8, torch.bfloat16, True),
    ("swin_unet/art", 2, 64, (61, 131), 5, torch.float32, True),
    ("swin_unet/art", 2, 0, (36, 52), 3, torch.bfloat16, True),  # rect
])
def test_kernel_c_on_this_slices_plans(family, scale, tile, frame_hw, batch,
                                       dtype, tta):
    from waifu2x_tensorrt_tpu_torch.ops.finalize_epilogue import (
        finalize_gather,
    )

    fin, fin_cpu, plan, outs = _slice_case(family, scale, tile, frame_hw,
                                           batch, dtype, tta)
    want = fin_cpu(*(o.cpu() for o in outs))
    before = finalize_gather.launches
    got = fin(*outs)
    assert finalize_gather.launches == before + 1
    assert tuple(got.shape) == (frame_hw[0] * scale, frame_hw[1] * scale, 3)
    assert torch.equal(got.cpu(), want)


def test_cunet_bf16_render_against_cpu_fp32():
    """A cunet 2x render in bf16 on the card (convs on cuDNN, kernel C)
    against the port's fp32 render on the CPU, by the bf16 rule's floor:
    at most 0.02 x 255 in u8 (the model has no kernel whose plain bf16
    twin could set a tighter bound). Seeded unit-scale weights (kernels
    N(0, 1/fan_in), biases N(0, 0.1)) give the frame content."""
    from waifu2x_tensorrt_tpu_torch.engine.config import (
        Precision,
        RenderConfig,
    )
    from waifu2x_tensorrt_tpu_torch.engine.renderer import ChunkedPipeline
    from waifu2x_tensorrt_tpu_torch.ops.finalize_epilogue import (
        finalize_gather,
    )
    from waifu2x_tensorrt_tpu_torch.models import registry

    frame = np.random.default_rng(3).integers(0, 256, (100, 90, 3), np.uint8)
    flat = None
    renders = {}
    for dtype, device in ((torch.bfloat16, "cuda"), (torch.float32, "cpu")):
        module, spec = registry.create_model("cunet/art", 2, 1, dtype=dtype,
                                             device=device)
        if flat is None:
            flat = {k: (v / (0.02 * np.sqrt(np.prod(v.shape[:-1])))
                        if k.endswith("/kernel") else 5 * v)
                    for k, v in registry.init_params(module, 1).items()}
        registry.load_into(module, flat)
        cfg = RenderConfig(
            precision=(Precision.FP16 if dtype == torch.bfloat16
                       else Precision.TF32),
            batch_size=4, height=64, width=64, scaling=2,
            overlap=(1 / 16, 1 / 16))
        before = finalize_gather.launches
        renders[device] = ChunkedPipeline(module, spec, cfg, device).render(
            frame).cpu().numpy().astype(int)
        assert finalize_gather.launches == before + (device == "cuda")
    assert renders["cpu"].std() > 10  # the frame has content
    assert np.abs(renders["cuda"] - renders["cpu"]).max() <= 0.02 * 255


@pytest.mark.parametrize("tile,hw", [(0, (40, 56)), (400, (120, 104))])
def test_swin_padded_tiles_render_on_card(tile, hw):
    """Tiles that are not a multiple of 32 (whole frame, tile 400): the
    model pads them inside and crops its output, which kernel C then reads
    by address. fp32 on the card (kernels B and C) against the CPU render,
    golden gate (max 2 LSB, at most 1e-4 of the values changed)."""
    from waifu2x_tensorrt_tpu_torch.engine.config import (
        Precision,
        RenderConfig,
    )
    from waifu2x_tensorrt_tpu_torch.engine.renderer import ChunkedPipeline
    from waifu2x_tensorrt_tpu_torch.models import registry

    cfg = RenderConfig(precision=Precision.TF32, batch_size=2, height=tile,
                       width=tile, scaling=2, overlap=(1 / 16, 1 / 16))
    frame = np.random.default_rng(5).integers(0, 256, (*hw, 3), np.uint8)
    renders = []
    for device, fused in (("cuda", True), ("cpu", False)):
        module, spec = registry.create_model(
            "swin_unet/art", 2, -1, fused_block=fused, device=device,
            base_dim=32, depths=(1, 1, 2, 1, 1))
        registry.load_into(module, registry.init_params(module, seed=0))
        renders.append(ChunkedPipeline(module, spec, cfg, device).render(
            frame).cpu().numpy().astype(int))
    diff = np.abs(renders[0] - renders[1])
    assert diff.max() <= 2 and (diff > 0).mean() <= 1e-4


@pytest.mark.parametrize("crop", [None, (33, 50)])
def test_fetch_async_copies_into_pinned_memory(crop):
    """``fetch_async`` (the CLI's fetch of a device frame): the copy into
    pinned host memory is queued with no synchronizing call, and
    ``np.asarray`` of the handle gives the frame's bytes, C-contiguous,
    also for a cropped (strided) view."""
    from waifu2x_tensorrt_tpu_torch.engine.upscaler import fetch_async

    x = torch.randint(0, 256, (40, 56, 3), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(3)).cuda()
    if crop is not None:
        x = x[:crop[0], :crop[1]]
    fetch_async(x)  # warms the pinned allocator
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        handle = fetch_async(x)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    got = np.asarray(handle)
    assert got.flags.c_contiguous and got.dtype == np.uint8
    np.testing.assert_array_equal(got, x.cpu().numpy())


def test_render_async_equals_render():
    from waifu2x_tensorrt_tpu_torch.engine.config import (
        Precision,
        RenderConfig,
    )
    from waifu2x_tensorrt_tpu_torch.engine.upscaler import Upscaler

    up = Upscaler(allow_random_init=True, device="cuda")
    up.load("swin_unet/art", 2, -1, RenderConfig(
        precision=Precision.FP16, batch_size=2, height=64, width=64,
        scaling=2, overlap=(1 / 16, 1 / 16)), bucket=16)
    frame = np.random.default_rng(6).integers(0, 256, (37, 45, 3), np.uint8)
    want = up.render(frame)
    got = np.asarray(up.render_async(frame))
    assert got.shape == (74, 90, 3) and got.flags.c_contiguous
    np.testing.assert_array_equal(got, want)


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


@pytest.mark.parametrize("family", ["swin", "cunet"])
def test_graph_module_on_card_matches_cpu(tmp_path, family):
    """``GraphModule`` (the ``--graph-exact`` executor) on CUDA against its
    CPU run on the same tiles: fp32 within 1e-4 (TF32 off), bf16 by the
    bf16 rule against the CPU's fp32."""
    from torch_mirror import export_torch_cunet, export_torch_swin

    from waifu2x_tensorrt_tpu_torch.models.onnx_backend import GraphModule
    from waifu2x_tensorrt_tpu_torch.models.onnx_graph import read_graph

    path = tmp_path / "m.onnx"
    if family == "swin":
        export_torch_swin(path, scale=2, base_dim=32, depths=(2, 2, 2, 2, 2),
                          tile=64, seed=3)
        tile = 64
    else:
        export_torch_cunet(path, scale=2, tile=76, seed=3)
        tile = 76
    graph = read_graph(path)
    x = torch.from_numpy(np.random.default_rng(3).uniform(
        0, 1, (3, tile, tile, 3)).astype(np.float32))
    with torch.inference_mode():
        p32 = GraphModule(graph)(x)
        k32 = GraphModule(graph, device="cuda")(x.cuda()).cpu()
        p16 = GraphModule(graph, torch.bfloat16)(x.bfloat16()).float()
        k16 = GraphModule(graph, torch.bfloat16, device="cuda")(
            x.cuda().bfloat16()).float().cpu()
    assert k32.shape == p32.shape and k32.is_contiguous()
    assert float((k32 - p32).abs().max()) <= 1e-4
    tol = max(2 * float((p16 - p32).abs().max()), 0.02)
    assert float((k16 - p32).abs().max()) <= tol


def _flagship_pipeline(batch=4, dtype="fp16", fuse_frame=False):
    """The flagship model (swin_unet/art 4x noise 3, full width, seed-0
    weights) behind an ``Upscaler`` at tile 256."""
    from waifu2x_tensorrt_tpu_torch.engine.config import (
        Precision,
        RenderConfig,
    )
    from waifu2x_tensorrt_tpu_torch.engine.upscaler import Upscaler

    up = Upscaler(allow_random_init=True, device="cuda")
    up.load("swin_unet/art", 4, 3, RenderConfig(
        precision=Precision(dtype), batch_size=batch, height=256, width=256,
        scaling=4, overlap=(1 / 16, 1 / 16)), fuse_frame=fuse_frame)
    return up


def test_captured_chunk_is_the_eager_chunk():
    """A flagship-width chunk (bf16, 4 tiles of 256) through its captured
    program: the first call is the eager run, later calls replay the
    graph, and both give the bytes of the module called eagerly at the
    same shape. Replays add the capture's launches (10 of kernel B) to the
    counters; the capture itself adds none. A replay, and a whole
    streamed frame around replays (pinned upload, kernel C), make no
    synchronizing call."""
    from waifu2x_tensorrt_tpu_torch.ops.swin_block import fused_swin_block

    up = _flagship_pipeline()
    pl = up._pipeline
    x = torch.rand((4, 256, 256, 3), generator=torch.Generator().manual_seed(
        8)).cuda().bfloat16()
    with torch.inference_mode():
        want = pl.model_prog.fn(x)
    before = fused_swin_block.launches
    direct = fused_swin_block.direct_launches
    first = pl.run_model(x)
    assert fused_swin_block.launches == before + 10  # the eager run only
    (graph,) = pl.model_prog.graphs.values()
    # every B launch of the chunk reads and writes the activation itself
    assert graph.launches == {"launches_B": 10, "direct_B": 10}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        replays = [pl.run_model(x) for _ in range(3)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert fused_swin_block.launches == before + 10 + 3 * 10
    assert fused_swin_block.direct_launches == direct + 10 + 3 * 10
    assert torch.equal(first, want)
    for r in replays:
        assert torch.equal(r, want)
        assert r.data_ptr() != graph.static_out.data_ptr()  # a copy

    stream = up.open_stream((300, 500))
    stream.warm()
    frames = [np.random.default_rng(i).integers(0, 256, (300, 500, 3),
                                                 np.uint8) for i in range(3)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [o for f in frames for o in stream.submit(f)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    outs += stream.flush()
    for f, o in zip(frames, outs):
        np.testing.assert_array_equal(o.cpu().numpy(), up.render(f))


def test_captured_fp32_chunk_is_the_eager_chunk():
    """The tf32 precision's chunk (fp32 kernel B, 4 tiles of 256 at the
    flagship width) through its captured program: the eager first call and
    the replays give the bytes of the module called eagerly, and each
    replay adds the capture's 10 launches of B."""
    from waifu2x_tensorrt_tpu_torch.ops.swin_block import fused_swin_block

    up = _flagship_pipeline(dtype="tf32")
    pl = up._pipeline
    x = torch.rand((4, 256, 256, 3), generator=torch.Generator().manual_seed(
        12)).cuda()
    with torch.inference_mode():
        want = pl.model_prog.fn(x)
    assert want.dtype == torch.float32
    before = fused_swin_block.launches
    first = pl.run_model(x)
    replays = [pl.run_model(x) for _ in range(2)]
    assert fused_swin_block.launches == before + 10 + 2 * 10
    assert torch.equal(first, want)
    for r in replays:
        assert torch.equal(r, want)


def test_fuse_frame_720p_against_the_chunked_render():
    """A 720p flagship frame (bf16, batch 16: chunks [16, 2]) as one
    captured whole-frame program, against the chunked pipeline's render
    of it: the same launches at the same shapes, so at most 1 LSB (the
    JAX package's bound between its two), in practice none. The second
    fused call replays the graph: the same bytes, and the capture's
    launches (B 20, C 1) counted once a replay."""
    from waifu2x_tensorrt_tpu_torch import ops

    fused = _flagship_pipeline(batch=16, fuse_frame=True)
    chunked = _flagship_pipeline(batch=16)
    frame = np.random.default_rng(9).integers(0, 256, (720, 1280, 3),
                                              np.uint8)
    want = chunked.render(frame)
    first = fused.render(frame)
    counters = ops.kernels()
    before = {k: w.launches for k, w in counters.items()}
    second = fused.render(frame)
    made = {k: w.launches - before[k] for k, w in counters.items()}
    assert made == {"A": 0, "B": 20, "C": 1, "D": 0, "E": 0, "F": 0, "G": 0,
                    "H": 0, "I": 0, "J": 0}
    assert first.shape == (2880, 5120, 3)
    np.testing.assert_array_equal(first, second)
    assert np.abs(first.astype(int) - want.astype(int)).max() <= 1
    prog = fused._fused.get((720, 1280))
    assert len(prog.graphs) == 1 and prog.pool.bytes > 0


def _launch_b(lib, x, ops, flags, shift):
    """Kernel B from the library ``lib`` (a copy of the kernel library
    loaded with ``ctypes``), as the wrapper calls it."""
    from waifu2x_tensorrt_tpu_torch.ops import build

    out = torch.empty_like(x)
    code = lib.w2x_swin_block(
        x.data_ptr(), *[t.data_ptr() for t in ops.tensors],
        ops.bias.data_ptr(), flags.data_ptr(), out.data_ptr(), x.shape[0],
        x.shape[2], ops.num_heads, shift, 8, 8, 0,
        int(x.dtype == torch.bfloat16), build.stream_handle(x.device))
    build.check(code, "swin block kernel")
    return out


@pytest.mark.parametrize("dtype,captured_first", [
    (torch.bfloat16, (False, True)), (torch.float32, (True, False))])
def test_kernel_b_launches_from_two_library_copies(dtype, captured_first):
    """Two copies of the kernel library in one process (the plain one and
    a variant built with an extra flag): kernel B launches from each, in
    bf16 and fp32, after the plain copy has launched the same kernel. One
    of the variant's first launches of a kernel (bf16 C 192, fp32) is
    inside a CUDA-graph capture, so its shared-memory limit is set there.
    Each copy sets its own limit (the flag that guards it is no longer a
    template's static local, which the loader shares between copies);
    every launch gives the plain library's bytes."""
    from waifu2x_tensorrt_tpu_torch.ops import build
    from waifu2x_tensorrt_tpu_torch.ops import swin_block as sb

    plain = build.load_library()
    variant = build.load_library(extra_flags=("-DW2X_SECOND_COPY",))
    assert variant is not plain
    for (c, nh), captured in zip(((96, 3), (192, 6)), captured_first):
        x, _q, params, bias, flags = _inputs(37, c, nh, c)
        x = x.to(dtype)
        ops = sb.block_operands(params, bias, dtype)
        want = _launch_b(plain, x, ops, flags, 4)
        if captured:
            static_x = x.clone()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                static_out = _launch_b(variant, static_x, ops, flags, 4)
            graph.replay()
            got = static_out.clone()
        else:
            got = _launch_b(variant, x, ops, flags, 4)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (c, captured)


def _small_swin(batch=3):
    """swin_unet/art 2x behind an ``Upscaler`` at tile 64 (bf16)."""
    from waifu2x_tensorrt_tpu_torch.engine.config import (
        Precision,
        RenderConfig,
    )
    from waifu2x_tensorrt_tpu_torch.engine.upscaler import Upscaler

    up = Upscaler(allow_random_init=True, device="cuda")
    up.load("swin_unet/art", 2, -1, RenderConfig(
        precision=Precision.FP16, batch_size=batch, height=64, width=64,
        scaling=2, overlap=(1 / 16, 1 / 16)))
    return up


def test_stage_spans_time_a_traced_stream():
    """A traced stream (warmed first, every output fetched, ending in a
    synchronize): prepare, model, finalize and fetch each have device
    seconds, their sum covers the profiler's busy time (every kernel and
    copy of the window lies inside a stage span on the one stream) and
    lies inside the window, and no ``w2x.*`` event is a device event."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from waifu2x_tensorrt_tpu_torch.engine.upscaler import fetch_async
    from waifu2x_tensorrt_tpu_torch.utils import profiling

    up = _small_swin()
    hw = (120, 200)
    frames = [np.random.default_rng(i).integers(0, 256, (*hw, 3), np.uint8)
              for i in range(4)]
    stream = up.open_stream(hw)
    stream.warm()
    torch.cuda.synchronize()
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        handles = [fetch_async(o) for f in frames for o in stream.submit(f)]
        handles += [fetch_async(o) for o in stream.flush()]
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    try:
        seconds = profiling.stage_seconds()
        assert len(handles) == len(frames)
        assert set(seconds) == {"prepare", "model", "finalize", "fetch"}
        assert all(t > 0 for t in seconds.values()), seconds
        device = sorted((e.time_range.start, e.time_range.end)
                        for e in prof.events()
                        if e.device_type == DeviceType.CUDA)
        assert device
        busy_us, end = 0.0, -np.inf
        for a, b in device:
            busy_us += max(0.0, b - max(a, end))
            end = max(end, b)
        total = sum(seconds.values())
        assert busy_us / 1e6 * 0.99 <= total <= window_s, (busy_us, seconds,
                                                           window_s)
        assert not [e.name for e in prof.events()
                    if e.name.startswith("w2x.")
                    and e.device_type == DeviceType.CUDA]
    finally:
        profiling.reset()


def test_first_call_at_a_new_chunk_shape_is_one_capture():
    """Under a profiler, the first call at a chunk shape is one
    ``w2x.capture`` span (kind, shape and the capture's figures) inside a
    ``w2x.model`` span whose events lie outside the capture; the next call
    is a replay that names kernel B's launches. A stage span entered while
    its stream captures records no event."""
    from torch.profiler import ProfilerActivity, profile

    from waifu2x_tensorrt_tpu_torch.utils import profiling

    up = _small_swin()
    pl = up._pipeline
    x = torch.rand((5, 64, 64, 3), generator=torch.Generator().manual_seed(
        2)).cuda().bfloat16()
    profiling.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            pl.run_chunk(x, False, (0, 1))
            pl.run_chunk(x, False, (2, 2))
            graph = torch.cuda.CUDAGraph()
            static = x.clone()
            with torch.cuda.graph(graph):
                with profiling.span("model", static.device) as counts:
                    static.mul_(2)
        torch.cuda.synchronize()
        record = profiling.records()
        assert [s.name for s in record] == ["model", "capture", "model",
                                            "model"]
        first, capture, replay, inside = record
        assert first.counts == {"n": 5, "program": "capture"}
        assert first.frames == (0, 1) and first.events is not None
        assert capture.counts["kind"] == "model"
        assert capture.counts["shape"] == "5x64x64x3"
        assert capture.counts["capture_s"] > 0 and capture.counts[
            "eager_s"] > 0 and capture.counts["pool_bytes"] >= 0
        assert capture.events is None
        assert replay.counts == {"n": 5, "program": "replay",
                                 "launches_B": 10, "direct_B": 10}
        assert inside.events is None and counts == {}
        assert set(profiling.stage_seconds()) == {"model"}
        names = [e.name for e in prof.events()]
        assert names.count("w2x.capture") == 1
        assert names.count("w2x.model") == 3
    finally:
        profiling.reset()


def _at_pitch(t, parts, p):
    """t's last axis, ``parts`` equal blocks, each carried at pitch p with
    NaN in its pad (a pad the kernels must neither read into the real
    channels nor pass on)."""
    c = t.shape[-1] // parts
    return torch.nn.functional.pad(t.unflatten(-1, (parts, c)), (0, p - c),
                                   value=float("nan")).flatten(-2)


def _padded_g(ha, qkv16, table, kw, k16):
    """Kernel G at pitch 192 (HAT's and DAT's trunk) on the same qkv: the
    pitch-180 output's bytes on the real channels, zeros in the pad, one
    launch counted in ``padded_launches``."""
    before = ha.hat_attention.padded_launches
    wide = ha.hat_attention(_at_pitch(qkv16, 3, 192), table, channels=180,
                            **kw)
    assert ha.hat_attention.padded_launches == before + 1
    assert wide.shape[-1] == 192
    assert torch.equal(wide[..., :180], k16)
    assert not wide[..., 180:].any()


@pytest.mark.parametrize("bhw", [(3, 48, 80), (2, 128, 96)],
                         ids=["rect-3x48x80", "2x128x96"])
@pytest.mark.parametrize("shift, overlap, pitch",
                         [(0, 0, 180), (8, 0, 180), (0, 4, 180),
                          (8, 0, 192), (0, 4, 192)],
                         ids=["self", "self-shift-8", "overlapping",
                              "self-shift-8-pitch-192",
                              "overlapping-pitch-192"])
def test_kernel_g_matches_its_twin(shift, overlap, pitch, bhw):
    """Kernel G (HAT's window attention) in bf16 against its plain twin at
    HAT's width (C 180, 6 heads of 30), shifted windows whose last row
    and column wrap, and overlapping windows zero-padded at every border:
    by the bf16 rule |k16 - p32| <= max(2 |p16 - p32|, 0.02), and with
    scores past 100 (q and k 4x larger) as well; one launch counted each
    call, overlapping ones also in ``overlap_launches``. At pitch 192
    (NaN in the pads) the pitch-180 bytes and a zero pad
    (``_padded_g``)."""
    from waifu2x_tensorrt_tpu_torch.ops import hat_attention as ha

    b, h, w = bhw
    g = torch.Generator(device="cuda").manual_seed(h + shift + overlap)
    qkv = torch.randn((b, h, w, 540), generator=g, device="cuda")
    table = 0.2 * torch.randn((ha.table_rows(16, overlap), 6), generator=g,
                              device="cuda")
    kw = {"num_heads": 6, "shift": shift, "overlap": overlap}
    for scale in (1.0, 4.0):
        x = qkv.clone()
        x[..., :360] *= scale
        before = (ha.hat_attention.launches,
                  ha.hat_attention.overlap_launches)
        k16 = ha.hat_attention(x.bfloat16(), table, **kw)
        assert (ha.hat_attention.launches,
                ha.hat_attention.overlap_launches) == (
            before[0] + 1, before[1] + bool(overlap))
        if pitch != 180:
            _padded_g(ha, x.bfloat16(), table, kw, k16)
        k16 = k16.float()
        p16 = ha.hat_attention_plain(x.bfloat16(), table, **kw).float()
        p32 = ha.hat_attention_plain(x, table, **kw)
        e_k = float((k16 - p32).abs().max())
        e_p = float((p16 - p32).abs().max())
        assert e_k <= max(2 * e_p, 0.02), (scale, e_k, e_p)


def test_kernel_g_refuses_fp32_on_the_card():
    from waifu2x_tensorrt_tpu_torch.ops import hat_attention as ha

    qkv = torch.zeros((1, 16, 16, 540), device="cuda")
    table = torch.zeros((ha.table_rows(16, 0), 6), device="cuda")
    with pytest.raises(TypeError, match="bf16 only"):
        ha.hat_attention(qkv, table, num_heads=6)


def test_hat_chunk_captured_is_the_eager_chunk():
    """A HAT chunk at full width (one group of 2 HABs and an OCAB, bf16,
    2 tiles of 64) through its captured program: replays give the bytes
    of the eager call and record kernel G's launches (3, 1 of them
    overlapping) and kernel I's (8: patch_embed.norm, 2 LN1 and 2 LN2 of
    the HABs, OCAB's 2 and the final norm), all on the trunk's pitch of
    192 (``padded_G``, ``padded_I``)."""
    from waifu2x_tensorrt_tpu_torch.engine import exe_cache
    from waifu2x_tensorrt_tpu_torch.models import registry

    module, _ = registry.create_model(
        "hat/photo", 4, -1, dtype=torch.bfloat16, device="cuda",
        hat_arch={"depths": (2,)})
    registry.load_into(module, registry.init_params(module, seed=1))
    exe_cache.configure("models", "cuda:0")
    prog = exe_cache.cached_program(module, tag="model|hat-test")
    x = torch.rand((2, 64, 64, 3), generator=torch.Generator().manual_seed(
        5)).cuda().bfloat16()
    with torch.inference_mode():
        want = module(x)
    first = prog(x)
    (graph,) = prog.graphs.values()
    assert graph.launches == {"launches_G": 3, "overlap_G": 1,
                              "padded_G": 3, "launches_I": 8,
                              "padded_I": 8}
    second = prog(x)
    assert torch.equal(first, want) and torch.equal(second, want)


def _add_norm_inputs(shape, variant, seed):
    """bf16 x, r, z, s, weight, bias and k of HAT's scale on the card: a
    residual stream of std 3, terms of std 1, channel weights in (0,
    0.01) (MambaIR's gate in (0, 1)), LN parameters and the skip weight k
    about 1 and 0 and 1."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*size, std=1.0, mean=0.0):
        return (mean + std * torch.randn(size, generator=g, device="cuda")
                ).bfloat16()

    b, c = shape[0], shape[-1]
    x = randn(*shape, std=3.0)
    r = randn(*shape) if variant in ("add", "scaled", "skip") else None
    z = randn(*shape) if variant in ("scaled", "skip_gate") else None
    s = None
    if z is not None:
        s = ((0.01 if variant == "scaled" else 1.0)
             * torch.rand((b, c), generator=g, device="cuda")).bfloat16()
    k = randn(c, std=0.1, mean=1.0) if variant.startswith("skip") else None
    return (x, r, z, s, randn(c, std=0.1, mean=1.0), randn(c, std=0.1),
            k)


def _within_one_ulp(got, want, y, weight, bias):
    """bf16 LayerNorm ``got`` within one bf16 ulp of ``want``, value by
    value, beyond 2^-16 of the terms the last step sums, |gamma (y - mean)
    rstd| + |beta| (an fp32-level difference of mean and rstd, which a
    value that cancels to near 0 shows as many of its own ulps; a bf16
    error in the terms would be 2^-8 of them)."""
    g, w = got.float(), want.float()
    ulp = torch.where(w == 0, 2.0 ** -133,
                      2.0 ** (torch.floor(torch.log2(w.abs())) - 7))
    y = y.double()
    d = (y - y.mean(-1, keepdim=True)) * torch.rsqrt(
        y.var(-1, unbiased=False, keepdim=True) + 1e-5)
    terms = (weight.double() * d).abs() + bias.double().abs()
    worst = float(((g - w).abs() / (ulp + 2.0 ** -16 * terms)).max())
    assert worst <= 1.0, worst


@pytest.mark.parametrize("variant", ["norm", "add", "scaled", "skip",
                                     "skip_gate"])
@pytest.mark.parametrize("shape, pitch", [
    ((16, 256, 256, 180), 180), ((3, 37, 29, 180), 180),
    ((3, 37, 29, 12), 12), ((3, 37, 29, 144), 144), ((2, 5, 7, 256), 256),
    ((16, 256, 256, 180), 192), ((3, 37, 29, 180), 192),
    ((3, 37, 29, 12), 16)],
    ids=["cell", "odd-rows", "c12", "c144", "c256", "cell-pitch-192",
         "odd-rows-pitch-192", "c12-pitch-16"])
def test_kernel_i_matches_its_twin(shape, pitch, variant):
    """Kernel I at the hat4x-480p-stream cell's chunk (16 tiles of 256,
    C 180) and with odd row counts (the last pair of rows one row; pairs
    across two images) at C 180, and at C 12 (one vector a lane), 144
    (HAT-S's width) and 256 (the widest it takes): y byte-equal to the
    twin's, n within one bf16 ulp (beyond an fp32-level difference of the
    terms, ``_within_one_ulp``), one launch counted. At a pitch P > C
    (NaN in the inputs' pads, s (B, P)): the same on the real channels,
    zeros in the pads of y and n, the launch also in
    ``padded_launches``. MambaIR's skip modes (x times the per-channel
    weight k, then + r or + z s[b]) also in ``skip_launches``."""
    from waifu2x_tensorrt_tpu_torch.ops import hat_norm as hn

    x, r, z, s, w, b, k = _add_norm_inputs(shape, variant, seed=shape[-1])
    c = shape[-1]
    if pitch != c:
        x, r, z = (None if t is None else _at_pitch(t, 1, pitch)
                   for t in (x, r, z))
        s = None if s is None else _at_pitch(s, 1, pitch).nan_to_num(1.0)
    want_y, want_n = hn.add_norm_plain(x, r, w, b, 1e-5, z=z, s=s, k=k)
    before = (hn.add_norm.launches, hn.add_norm.padded_launches,
              hn.add_norm.skip_launches)
    y, n = hn.add_norm(x, r, w, b, 1e-5, z=z, s=s, k=k)
    torch.cuda.synchronize()
    assert (hn.add_norm.launches, hn.add_norm.padded_launches,
            hn.add_norm.skip_launches) == (
        before[0] + 1, before[1] + (pitch != c), before[2] + (k is not None))
    assert (y is x) == (variant == "norm")
    _bytes_equal(y[..., :c], want_y[..., :c])
    _within_one_ulp(n[..., :c], want_n[..., :c], want_y[..., :c], w, b)
    assert not n[..., c:].any()
    assert y is x or not y[..., c:].any()


def test_kernel_i_refuses_what_it_does_not_take():
    from waifu2x_tensorrt_tpu_torch.ops import hat_norm as hn

    w = torch.ones(180, device="cuda")
    for dtype in (torch.float32, torch.float16):
        x = torch.zeros((2, 8, 8, 180), device="cuda", dtype=dtype)
        with pytest.raises(TypeError, match="bf16 only"):
            hn.add_norm(x, x, w.to(dtype), w.to(dtype), 1e-5)
    w = w.bfloat16()
    x = torch.zeros((2, 8, 16, 180), device="cuda").bfloat16()[:, :, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        hn.add_norm(x, None, w, w, 1e-5)
    x = torch.zeros(2 * 8 * 8 * 180 + 1, device="cuda").bfloat16()[1:]
    with pytest.raises(ValueError, match="aligned"):
        hn.add_norm(x.view(2, 8, 8, 180), None, w, w, 1e-5)
    x = torch.zeros((2, 8, 8, 180), device="cuda").bfloat16()
    with pytest.raises(ValueError, match="x on cuda"):
        hn.add_norm(x, None, w.cpu(), w, 1e-5)


def _bytes_equal(got, want):
    """Byte equality, NaNs compared by place (their payloads are the
    hardware's)."""
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    bits = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    g = got.view(bits[got.dtype])[~nan]
    w = want.view(bits[want.dtype])[~nan]
    assert torch.equal(g, w)


def _epilogue_inputs(shape, crop, dtype, seed, specials=False):
    """A bias-free conv output of ``shape``, its bias and a skip grown by
    ``crop`` a side (None: no skip), on the card; with ``specials`` some
    conv values are inf, -inf, -0.0 and NaN, and in channel 0 of the first
    row the bias, conv value and skip value are -0.0, so that the sum is
    -0.0 where a clamp would make it +0.0."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    n, h, w, c = shape
    conv = torch.randn(shape, generator=g, device="cuda").to(dtype)
    bias = (0.3 * torch.randn((c,), generator=g, device="cuda")).to(dtype)
    skip = None
    if crop is not None:
        skip = torch.randn((n, h + 2 * crop, w + 2 * crop, c), generator=g,
                           device="cuda").to(dtype)
    if specials:
        flat = conv.view(-1)
        for i, v in enumerate((float("inf"), float("-inf"), -0.0,
                               float("nan"))):
            flat[i * 7::97] = v
        bias[0] = -0.0
        conv[:, 0, :, 0] = -0.0
        if skip is not None:
            skip[:, crop, crop:crop + w, 0] = -0.0
    return conv, bias, skip


@pytest.mark.parametrize("in_place", [True, False], ids=["in-place", "out"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape,crop,act,clamp", [
    ((16, 476, 476, 64), None, True, False),
    ((16, 444, 444, 64), 16, True, False),
    ((16, 480, 480, 3), None, False, False),
    ((16, 440, 440, 3), 20, False, True)],
    ids=["act", "act-skip", "bias-bottom1", "skip20-clamp-bottom2"])
def test_kernel_h_is_its_twin_at_the_cell_shapes(shape, crop, act, clamp,
                                                   dtype, in_place):
    """Kernel H at the cunet2x-1080p-stream cell's maps (16 tiles of
    256): the largest, UNet2's conv1 and conv4_up, with the leaky ReLU and
    the skip of crop 16 (the vector path), and the two C-3 conv_bottoms,
    UNet1's with the bias alone and UNet2's with the skip of crop 20 and
    the clamp (the scalar path; with inf, -inf, -0.0 and NaN among the
    conv values): byte-equal to its plain twin on the card, over the conv
    output itself and over a copy of it (which leaves the conv output as
    it was)."""
    from waifu2x_tensorrt_tpu_torch.ops import cunet_epilogue as ce

    conv, bias, skip = _epilogue_inputs(shape, crop, dtype, seed=shape[1],
                                        specials=not act)
    kw = {"act": act, "skip": skip, "crop": crop or 0, "clamp": clamp}
    want = ce.bias_act_plain(conv.clone(), bias, **kw)
    before = ce.bias_act.launches
    target = conv if in_place else conv.clone()
    kept = conv.clone()
    got = ce.bias_act(target, bias, **kw)
    torch.cuda.synchronize()
    assert ce.bias_act.launches == before + 1
    assert got is target
    if not in_place:  # by bytes: the conv output may hold NaNs
        assert torch.equal(conv.view(torch.uint8), kept.view(torch.uint8))
    _bytes_equal(got, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("c", [3, 24, 32, 64, 128, 256])
@pytest.mark.parametrize("act,crop,clamp", [
    (True, None, False), (True, 4, False), (True, 16, False),
    (False, None, False), (False, 20, True), (False, 20, False)],
    ids=["act", "act-skip4", "act-skip16", "bias", "skip20-clamp",
         "skip20"])
@pytest.mark.parametrize("aligned", [True, False],
                         ids=["aligned", "unaligned"])
def test_kernel_h_matches_its_twin(dtype, c, act, crop, clamp, aligned):
    """Kernel H byte-equal to its twin on the card in every mode cunet
    uses, at every C cunet has (C 3: the scalar path; C 24 in bf16: three
    vectors a pixel, which 256 threads do not divide, the scalar path),
    odd map sizes (a ragged last step), with inf, -inf, -0.0 and NaN
    among the conv values, and over a conv output that is not 16-byte
    aligned (the scalar path at every C)."""
    from waifu2x_tensorrt_tpu_torch.ops import cunet_epilogue as ce

    conv, bias, skip = _epilogue_inputs((3, 37, 29, c), crop, dtype,
                                        seed=c + (crop or 0),
                                        specials=True)
    kw = {"act": act, "skip": skip, "crop": crop or 0, "clamp": clamp}
    want = ce.bias_act_plain(conv.clone(), bias, **kw)
    if not aligned:
        conv = torch.empty(conv.numel() + 1, dtype=dtype,
                           device="cuda")[1:].view(conv.shape).copy_(conv)
    got = ce.bias_act(conv, bias, **kw)
    torch.cuda.synchronize()
    _bytes_equal(got, want)


def test_kernel_h_refuses_what_it_does_not_take():
    from waifu2x_tensorrt_tpu_torch.ops import cunet_epilogue as ce

    conv = torch.zeros((2, 8, 8, 32), device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError, match="bf16 or fp32"):
        ce.bias_act(conv, torch.zeros(32, device="cuda",
                                      dtype=torch.float16))
    conv = torch.zeros((2, 8, 16, 32), device="cuda")[:, :, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        ce.bias_act(conv, torch.zeros(32, device="cuda"))
    with pytest.raises(ValueError, match="contiguous"):
        ce.bias_act(torch.zeros((2, 8, 8, 32), device="cuda"),
                    torch.zeros(32))


def _composed_cunet(m, x):
    """``models/cunet.py``'s forward as it was before kernel H: each conv
    with its bias (cuDNN, then PyTorch's bias add), then the leaky ReLU,
    the crop-adds and the clamp as torch ops."""
    import torch.nn as nn
    import torch.nn.functional as F

    dt = m.dtype
    a = float(torch.tensor(0.1, dtype=dt))

    def conv(x, layer, act=True):
        w = layer.weight.to(dt).contiguous(memory_format=torch.channels_last)
        f = (F.conv_transpose2d if isinstance(layer, nn.ConvTranspose2d)
             else F.conv2d)
        y = f(x.permute(0, 3, 1, 2), w, layer.bias.to(dt),
              stride=layer.stride, padding=layer.padding).permute(0, 2, 3, 1)
        return torch.maximum(y, y * a) if act else y

    def crop(x, p):
        return x[:, p:-p, p:-p, :]

    def unet_conv(u, x):
        x = conv(conv(x, u.conv[0]), u.conv[2])
        return u.conv[4](x) if u.se else x

    u1, u2 = m.unet1, m.unet2
    x1 = unet_conv(u1.conv1, x.to(dt))
    x2 = unet_conv(u1.conv2, conv(x1, u1.conv1_down))
    x3 = conv(crop(x1, 4) + conv(x2, u1.conv2_up), u1.conv3)
    z1 = conv(x3, u1.conv_bottom, act=False)
    y1 = unet_conv(u2.conv1, z1)
    y2 = unet_conv(u2.conv2, conv(y1, u2.conv1_down))
    y3 = unet_conv(u2.conv3, conv(y2, u2.conv2_down))
    y4 = unet_conv(u2.conv4, crop(y2, 4) + conv(y3, u2.conv3_up))
    y5 = conv(crop(y1, 16) + conv(y4, u2.conv4_up), u2.conv5)
    z = crop(z1, 20) + conv(y5, u2.conv_bottom, act=False)
    return torch.clamp(z, 0.0, 1.0) if m.clamp else z


@pytest.mark.parametrize("scale,dtype", [(2, torch.bfloat16),
                                         (2, torch.float32),
                                         (1, torch.bfloat16)],
                         ids=["2x-bf16", "2x-fp32", "1x-bf16"])
def test_cunet_forward_is_the_composed_forward(scale, dtype, monkeypatch):
    """cunet/art on the card with kernel H after every conv (22 launches a
    forward) gives the bytes of the forward it replaced (bias through
    PyTorch, leaky ReLU, crop-adds and clamp as torch ops), with seeded
    unit-scale weights on 4 tiles of 64. In fp32 with cuDNN's
    deterministic algorithms: the one cuDNN picks by default for UNet1's
    fp32 transposed-conv head sums in an order that changes from call to
    call, so two fp32 forwards of either version differ in the last
    bits."""
    from waifu2x_tensorrt_tpu_torch.models import registry
    from waifu2x_tensorrt_tpu_torch.ops import cunet_epilogue as ce

    if dtype == torch.float32:
        monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)

    module, _ = registry.create_model("cunet/art", scale, 1, dtype=dtype,
                                      device="cuda")
    flat = {k: (v / (0.02 * np.sqrt(np.prod(v.shape[:-1])))
                if k.endswith("/kernel") else 5 * v)
            for k, v in registry.init_params(module, 1).items()}
    registry.load_into(module, flat)
    x = torch.rand((4, 64, 64, 3), generator=torch.Generator().manual_seed(
        scale)).cuda()
    before = ce.bias_act.launches
    with torch.inference_mode():
        got = module(x)
        want = _composed_cunet(module, x)
    assert ce.bias_act.launches == before + 22
    assert float(got.float().std()) > 0.01  # the output has content
    _bytes_equal(got, want)


def test_cunet_chunk_captured_launches_h():
    """A cunet/art 2x chunk (bf16, 4 tiles of 64) through its captured
    program: replays give the bytes of the eager call, and the capture
    records kernel H's 22 launches, so each replay's span carries
    ``launches_H`` 22."""
    from waifu2x_tensorrt_tpu_torch.engine import exe_cache
    from waifu2x_tensorrt_tpu_torch.models import registry

    module, _ = registry.create_model("cunet/art", 2, 1,
                                      dtype=torch.bfloat16, device="cuda")
    registry.load_into(module, registry.init_params(module, seed=1))
    exe_cache.configure("models", "cuda:0")
    prog = exe_cache.cached_program(module, tag="model|cunet-test")
    x = torch.rand((4, 64, 64, 3), generator=torch.Generator().manual_seed(
        6)).cuda().bfloat16()
    with torch.inference_mode():
        want = module(x)
    first = prog(x)
    (graph,) = prog.graphs.values()
    assert graph.launches == {"launches_H": 22}
    second = prog(x)
    assert torch.equal(first, want) and torch.equal(second, want)


@pytest.mark.parametrize("bhw", [(2, 64, 96), (16, 256, 256)],
                         ids=["2x64x96", "cell-16x256x256"])
@pytest.mark.parametrize("shift, pitch", [((0, 0), 180), ((4, 16), 180),
                                          ((4, 16), 192)],
                         ids=["unshifted", "shifted", "shifted-pitch-192"])
def test_kernel_g_rect_matches_its_twin(shift, pitch, bhw):
    """Kernel G on DAT's split windows (heads 0-2 in 8 x 32 windows, 3-5
    in 32 x 8, C 180) in bf16 against its plain twin by the bf16 rule,
    unshifted and shifted (every window of the last row and column
    wraps), at a small map and at the DAT cell's chunk, and with scores
    past 100 (q and k 4x larger); one launch counted each call, also in
    ``rect_launches``. At pitch 192 (NaN in the pads) the pitch-180
    bytes and a zero pad (``_padded_g``)."""
    from waifu2x_tensorrt_tpu_torch.ops import hat_attention as ha

    b, h, w = bhw
    g = torch.Generator(device="cuda").manual_seed(h + shift[0])
    qkv = torch.randn((b, h, w, 540), generator=g, device="cuda")
    table = 0.5 * torch.randn((ha.table_rows(ha.RECT, 0), 6), generator=g,
                              device="cuda")
    kw = {"num_heads": 6, "window": ha.RECT, "shift": shift, "split": True}
    for scale in (1.0, 4.0):
        x = qkv.clone()
        x[..., :360] *= scale
        before = (ha.hat_attention.launches, ha.hat_attention.rect_launches)
        k16 = ha.hat_attention(x.bfloat16(), table, **kw)
        assert (ha.hat_attention.launches,
                ha.hat_attention.rect_launches) == (before[0] + 1,
                                                    before[1] + 1)
        if pitch != 180:
            _padded_g(ha, x.bfloat16(), table, kw, k16)
        k16 = k16.float()
        p16 = ha.hat_attention_plain(x.bfloat16(), table, **kw).float()
        p32 = ha.hat_attention_plain(x, table, **kw)
        e_k = float((k16 - p32).abs().max())
        e_p = float((p16 - p32).abs().max())
        assert e_k <= max(2 * e_p, 0.02), (scale, e_k, e_p)
        del x, k16, p16, p32
        torch.cuda.empty_cache()


@pytest.mark.parametrize("shape, pitch", [
    ((16, 256, 256), 180), ((3, 37, 29), 180), ((1, 8, 8), 180),
    ((16, 256, 256), 192), ((3, 37, 29), 192)],
    ids=["cell-16x256x256", "3x37x29", "1x8x8", "cell-16x256x256-pitch-192",
         "3x37x29-pitch-192"])
def test_kernel_j_matches_its_twin(shape, pitch):
    """Kernel J (DAT's channel attention, C 180, 6 heads of 30) in bf16
    against its plain twin by the bf16 rule, at the DAT cell's chunk, at
    token counts that leave the last slice and apply block partly empty,
    and at fewer tokens than one; temperatures 1 to 16; the same bytes
    on a second call (fixed-order sums, no float atomics); one call
    counted. At pitch 192 (NaN in the pads) the pitch-180 bytes on the
    real channels, zeros in the pad, the call also in
    ``padded_launches``."""
    from waifu2x_tensorrt_tpu_torch.ops import channel_attention as ca

    b, h, w = shape
    g = torch.Generator(device="cuda").manual_seed(h * w)
    qkv = torch.randn((b, h, w, 540), generator=g, device="cuda")
    qkv[..., :360] += 0.5 * torch.randn((b, 1, 1, 360), generator=g,
                                        device="cuda")  # correlated q, k
    tau = torch.tensor([1.0, 2.0, 4.0, 8.0, 12.0, 16.0], device="cuda")
    before = ca.channel_attention.launches
    k16 = ca.channel_attention(qkv.bfloat16(), tau, num_heads=6)
    again = ca.channel_attention(qkv.bfloat16(), tau, num_heads=6)
    assert ca.channel_attention.launches == before + 2
    assert torch.equal(k16, again)
    if pitch != 180:
        before = ca.channel_attention.padded_launches
        wide = ca.channel_attention(_at_pitch(qkv.bfloat16(), 3, pitch),
                                    tau, num_heads=6, channels=180)
        assert ca.channel_attention.padded_launches == before + 1
        assert wide.shape[-1] == pitch
        assert torch.equal(wide[..., :180], k16)
        assert not wide[..., 180:].any()
    p16 = ca.channel_attention_plain(qkv.bfloat16(), tau, num_heads=6)
    p32 = ca.channel_attention_plain(qkv, tau, num_heads=6)
    e_k = float((k16.float() - p32).abs().max())
    e_p = float((p16.float() - p32).abs().max())
    assert e_k <= max(2 * e_p, 0.02), (e_k, e_p)


def test_kernel_j_refuses_what_it_does_not_take():
    from waifu2x_tensorrt_tpu_torch.ops import channel_attention as ca

    tau = torch.ones(6, device="cuda")
    with pytest.raises(TypeError, match="bf16 only"):
        ca.channel_attention(torch.zeros((1, 8, 8, 540), device="cuda"),
                             tau, num_heads=6)
    with pytest.raises(ValueError, match="heads"):
        ca.channel_attention(torch.zeros((1, 8, 8, 540), device="cuda",
                                         dtype=torch.bfloat16),
                             torch.ones(3, device="cuda"), num_heads=3)


def test_dat_chunk_captured_is_the_eager_chunk():
    """A DAT chunk at full width (one group of a spatial and a channel
    block, bf16, 2 tiles of 64) through its captured program: replays
    give the bytes of the eager call and record kernel G's launch (1, on
    split rectangular windows), kernel J's call (1) and kernel I's
    launches (6: before_RG.1, the 2 LN1, the 2 LN2 and the final norm),
    all on the trunk's pitch of 192 (``padded_*``)."""
    from waifu2x_tensorrt_tpu_torch.engine import exe_cache
    from waifu2x_tensorrt_tpu_torch.models import registry

    module, _ = registry.create_model(
        "dat/photo", 4, -1, dtype=torch.bfloat16, device="cuda",
        dat_arch={"depths": (2,)})
    registry.load_into(module, registry.init_params(module, seed=1))
    exe_cache.configure("models", "cuda:0")
    prog = exe_cache.cached_program(module, tag="model|dat-test")
    x = torch.rand((2, 64, 64, 3), generator=torch.Generator().manual_seed(
        5)).cuda().bfloat16()
    with torch.inference_mode():
        want = module(x)
    first = prog(x)
    (graph,) = prog.graphs.values()
    assert graph.launches == {"launches_G": 1, "rect_G": 1, "padded_G": 1,
                              "launches_J": 1, "padded_J": 1,
                              "launches_I": 6, "padded_I": 6}
    second = prog(x)
    assert torch.equal(first, want) and torch.equal(second, want)


def _scan_inputs(shape, seed):
    """bf16 u and x_dbl, kernel K's fp32 tables and SS2D's gate (bf16 z,
    out_norm's fp32 weight and bias) on the card, at the benchmark's
    seeded scale (``chip_smoke._scan_inputs``): delta from about 0.001 to
    0.1, A from -1 to -16 (the published init), D about 1."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    b, h, w, d = shape

    def randn(*size):
        return torch.randn(size, generator=g, device="cuda")

    u = (0.3 + randn(b, h, w, d)).bfloat16()
    xdbl = randn(b, h, w, 4 * 44).bfloat16()
    a = -torch.arange(1, 17, device="cuda", dtype=torch.float32).expand(
        4, d, 16).contiguous()
    gate = (randn(b, h, w, d).bfloat16(), 1 + 0.1 * randn(d),
            0.1 * randn(d), 1e-5)
    return (u, xdbl, randn(4, d, 12) / 12 ** 0.5, -4.6 + 0.5 * randn(4, d),
            a, 1.0 + 0.1 * randn(4, d), gate)


@pytest.mark.parametrize("shape", [(2, 64, 48, 360), (1, 37, 29, 360),
                                   (3, 9, 70, 200), (1, 1, 1, 8)],
                         ids=["2x64x48", "1x37x29", "d200", "one-token"])
def test_kernel_k_matches_its_twin(shape):
    """Kernel K (MambaIR's selective scan, R 12, N 16, and SS2D's gate)
    against its plain twin: each direction's fp32 output (the scratch's
    four planes, y + D u at every token) within 1e-4 of the largest, over
    token counts that leave the last 32-token stage partly empty and rows
    of 29 and 70 (the state carried across stages and rows), D 200 (a
    last group of 8 channels) and one token; the gated bf16 map LN(y)
    SiLU(z) within twice the bf16 rounding of the twin's fp32 result;
    the same bytes on a second call; one call counted."""
    from waifu2x_tensorrt_tpu_torch.ops import selective_scan as ss

    ops = _scan_inputs(shape, seed=shape[1] * shape[2])
    b, h, w, d = shape
    before = ss.selective_scan.launches
    y = ss.selective_scan(*ops)
    again = ss.selective_scan(*ops)
    assert ss.selective_scan.launches == before + 2
    assert torch.equal(y.view(torch.int16), again.view(torch.int16))
    planes = ss._partials(y.device, 4 * y.numel())[:4 * y.numel()].view(
        4, b, h * w, d)
    ys = ss.scan_directions(*ops[:6])
    order = ss.scan_order(h, w, y.device)
    for k in range(4):
        want = torch.empty((b, h * w, d), device="cuda")
        want[:, order[k]] = ys[:, k]
        err = float((planes[k] - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max()), (k, err)
    want_y = ss.combine(ys, h, w, torch.float32, ops[6])
    e_k = float((y.float() - want_y).abs().max())
    e_p = float((want_y.bfloat16().float() - want_y).abs().max())
    assert e_k <= 2 * e_p, (e_k, e_p)


def test_kernel_k_refuses_what_it_does_not_take():
    from waifu2x_tensorrt_tpu_torch.ops import selective_scan as ss

    u, xdbl, dtw, dtb, a, ds, (z, gw, gb, eps) = _scan_inputs((1, 4, 4, 16),
                                                             seed=1)
    gate = (z, gw, gb, eps)
    with pytest.raises(TypeError, match="bf16 only"):
        ss.selective_scan(u.float(), xdbl.float(), dtw, dtb, a, ds,
                          (z.float(), gw, gb, eps))
    with pytest.raises(ValueError, match="R 12"):
        ss.selective_scan(u, xdbl[..., :4 * 40], dtw[..., :8], dtb, a, ds,
                          gate)
    with pytest.raises(ValueError, match="multiple of 8"):
        ss.selective_scan(u[..., :12].contiguous(), xdbl, dtw[:, :12],
                          dtb[:, :12], a[:, :12], ds[:, :12],
                          (z[..., :12].contiguous(), gw[:12], gb[:12], eps))
    with pytest.raises(TypeError, match="float32"):
        ss.selective_scan(u, xdbl, dtw.bfloat16(), dtb, a, ds, gate)
    with pytest.raises(ValueError, match="aligned"):
        ss.selective_scan(u[:, :, 1:3], xdbl[:, :, 1:3], dtw, dtb, a, ds,
                          (z[:, :, 1:3], gw, gb, eps))


def test_mambair_chunk_captured_is_the_eager_chunk():
    """A MambaIR chunk at full width (one group of two VSSBlocks, bf16, 2
    tiles of 64) through its captured program: replays give the bytes of
    the eager call and record kernel K's calls (2) and kernel I's
    launches (6: patch_embed.norm and the first ln_1 alone, the two
    ln_2 in the skip mode, the second ln_1 in the skip gate, the final
    norm's add), all on the trunk's pitch of 192 (``padded_I``), 3 of
    them skips (``skip_I``)."""
    from waifu2x_tensorrt_tpu_torch.engine import exe_cache
    from waifu2x_tensorrt_tpu_torch.models import registry

    module, _ = registry.create_model(
        "mambair/photo", 4, -1, dtype=torch.bfloat16, device="cuda",
        mambair_arch={"depths": (2,)})
    registry.load_into(module, registry.init_params(module, seed=1))
    exe_cache.configure("models", "cuda:0")
    prog = exe_cache.cached_program(module, tag="model|mambair-test")
    x = torch.rand((2, 64, 64, 3), generator=torch.Generator().manual_seed(
        5)).cuda().bfloat16()
    with torch.inference_mode():
        want = module(x)
    first = prog(x)
    (graph,) = prog.graphs.values()
    assert graph.launches == {"launches_K": 2, "launches_I": 6,
                              "padded_I": 6, "skip_I": 3}
    second = prog(x)
    assert torch.equal(first, want) and torch.equal(second, want)
