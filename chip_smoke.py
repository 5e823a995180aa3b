"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout; it builds the CUDA kernels from
``waifu2x_tensorrt_tpu_torch/ops/csrc`` into ``build/kernels/`` and drives
the port through its library entry points (``Upscaler.load`` / ``render``
/ ``open_stream``) on seeded random weights. Phases, one line each:

  1. device: name, ``nvidia-smi`` name and power limit, torch/CUDA versions
  2. kernel build (seconds)
  3. kernels A (window attention) and B (Swin block) against their plain
     PyTorch twins at the flagship shapes: fp32 max |d| <= 1e-4 (TF32 off),
     bf16 by the rule |k16 - p32| <= max(2 |p16 - p32|, 0.02), and B on
     prepared operands (``block_operands``, built once) equal byte for
     byte to B on per-call ones; median times: B on prepared operands in
     bf16 and fp32, A in bf16 and fp32 beside
     ``scaled_dot_product_attention`` with the bias and shift mask as one
     float mask (bf16 A's share of its bound and its ratio to SDPA, and
     the registers and resident warps of its tensor-core kernel), B beside
     a yardstick chain of bf16 library calls (layer_norm, linear, SDPA,
     gelu) that the port never calls
  4. kernel C (finalize) against the plain scan on the 720p -> 4x plan,
     chunk outputs split [16, 2] and in a TileStream split, and kernel C
     alone (``finalize_gather`` on a tile table built once):
     byte-identical; times of kernel C alone, of the wrapper per call
     (table upload included) and of the plain scan, with the spread of
     each one's samples, and of kernel C alone and the wrapper with the
     device's queue filled ahead (device time only), beside C's bound
     (the covering values, not every tile value); the host time of a call
     of each; kernel C alone on fp32 copies of the tiles (the same bytes)
  5. main path: swin_unet/art 4x noise 3, tile 256, batch 16, fp16 (bf16):
     one 720p frame -> (2880, 5120, 3) u8, then 10 streamed frames, one
     of them held against its single-frame render (max <= 2 LSB, <= 1e-3
     of the values changed)
  6. the whole network on the card, kernel path vs all-plain path:
     a. one frame in tf32 (fp32) with the seed-0 weights, through the
        golden gate (max <= 2 LSB, <= 1e-4 of pixels changed);
     b. the frame's 18 tiles before the clamp, with the seed-0 weights
        (whose output lies within +-0.09, so the u8 frame is near-black)
        and with seeded unit-scale weights: fp32 max |d| <= 1e-4 of
        max |plain|, the bf16 main path by the bf16 rule against plain
        fp32, and the Swin blocks' share of the output >= 1e-2 of
        max |plain|, so that the check can see them
  7. the phase-5 config with fused_block=False (the configuration that
     runs kernel A): one 720p frame, then 4 streamed frames, their output
     MP/s beside phase 5's; the stream must launch A 10 times per chunk
  8. kernels D (packed-x head) and E (window attention on unpacked heads)
     against their plain PyTorch twins: D at r=4 (16, 256, 256, 48) and
     r=2 (16, 256, 256, 12), bf16 and fp32, equal to the twin and, byte
     for byte, to clamp + pixel shuffle and to a chain of library calls
     (``_head_pack_chain``, D's yardstick, timed beside it); E at
     (BW 4096, nh 3), (BW 1024, nh 6) and BW 37, shifts 0 and 4, by
     phase 3's rules; times as in phase 3 (bf16 E's share of its bound
     and its ratio to SDPA, fp32 E); then one call of E through the
     ``ops`` package API
  9. the packed-x main path: phase 5's config with WAIFU2X_PACK_X=1 (set
     for this phase only): the 720p geometry must route through the
     packed twin, one 720p frame must be byte-identical to phase 5's
     render of it (the same math; only the head layout differs), then 10
     streamed frames, one of them held against its render as in phase 5
 10. kernel F (int8/bf16 mma probe) vs plain: at the probe's four shapes
     (the ideal 512 x 1024 x 512 and the stage-1 qkv, fc1 and fc2 GEMMs)
     in int8 and bf16, at R = 3 and R = 2048, int8 equal to the plain
     twin and bf16 within the float32 sum bound (``fp32_sum_bound``);
     kernel, plain and library times beside the bound; then the probe's
     own run (``int8_probe.run`` and ``run_library``, what ``python -m
     waifu2x_tensorrt_tpu_torch.probes.int8_probe`` prints): path (b),
     path (a) and the decision gate. A rate above 1.05x the dense peak of
     its type fails (the work was skipped), and so does a time at R that
     is not 1.8-2.2x the time at R/2 (the products were not all run).
     The kernel times are those of the probe's run

Times are per call: the median over 10 samples, each the CUDA-event time
of 10 calls in a row divided by 10 (kernel F's probe times its own
calls). Every kernel's time is printed beside its bound: the larger of
its bytes (each input read once, each output written once) over 3.35
TB/s and its operations over the peak rate of their type (989 TFLOP/s
for bf16 matrix products, 1,979 TOP/s for int8 ones, 67 TFLOP/s for fp32
work), computed from the shapes of the run; and beside the one PyTorch
call that computes the same function where there is one (SDPA for A and
E; none for B, C and D; for F, R times one ``torch._int_mm`` or bf16
``torch.matmul``, since no call runs R serialized products).

Phase 5 runs with WAIFU2X_PACK_X unset (the default path). Launch counters
are set to 0 just before phases 5, 7 and 9, phase 7's stream, E's API call
of phase 8 and the probe's run of phase 10, and read just after each
(phase 5: kernels B and C; phase 7: A; phase 8: E; phase 9: D, B and C;
phase 10: F); each kernel must have launched in its run. The ``kernels``
line counts A in phase 7's stream. Any failed check raises, so the script
exits non-zero; the last line is the JSON device record, printed only
when every phase passed. Without a CUDA
device it exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time


def _require_cuda():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(1)
    return torch


CALLS_PER_SAMPLE = 10
# ~10 ms of the device's clock: longer than the host takes to enqueue a
# sample's calls of any kernel here
QUEUE_CYCLES = 20_000_000


def _samples_ms(fn, iters=10, warmup=2, queued=False):
    """Sorted ms per call of ``fn`` over ``iters`` samples, each the
    CUDA-event time of CALLS_PER_SAMPLE calls in a row divided by their
    number, so that the host's work between launches hides behind the
    device's queue. With ``queued`` the device first spins QUEUE_CYCLES
    (``torch.cuda._sleep``) while the host enqueues the sample's calls, so
    the sample holds device time only, also for a call whose host work
    outlasts its device work."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        if queued:
            torch.cuda._sleep(QUEUE_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(CALLS_PER_SAMPLE):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / CALLS_PER_SAMPLE)
    return sorted(times)


def _median_ms(fn, iters=10, warmup=2, queued=False):
    """ms per call of ``fn``: the median of ``_samples_ms``."""
    times = _samples_ms(fn, iters, warmup, queued)
    return times[len(times) // 2]


def _block_inputs(torch, bw, c, nh, dtype, seed):
    import numpy as np

    rng = np.random.default_rng(seed)

    def t(a, dt=torch.float32):
        return torch.from_numpy(a.astype(np.float32)).to("cuda", dt)

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
    x = t(rng.normal(0, 1, (bw, 64, c)))
    qkv = t(rng.normal(0, 1, (bw, 64, 3 * c)))
    return x, qkv, params, bias, flags


# Published peaks of one H100 SXM (NVIDIA's data sheet, dense): HBM
# bytes/s and fp32 FLOP/s outside the tensor cores. The tensor cores' bf16
# and int8 peaks are BF16_PEAK and INT8_PEAK of the port's int8 probe.
HBM_BPS = 3.35e12
FP32_FLOPS = 67e12


def _bound(nbytes, tc_flops=0.0, fp32_flops=0.0, tc_rate=None):
    """(ms, "bytes" | "operations"): the least time for the work, the
    larger of its bytes (each input read once, each output written once)
    over the HBM rate and its operations over the peak rate of their type
    (matrix products on the tensor cores at ``tc_rate``, by default the
    bf16 peak; elementwise fp32 work on the CUDA cores; the two run side
    by side)."""
    from waifu2x_tensorrt_tpu_torch.probes.int8_probe import BF16_PEAK

    t_bytes = nbytes / HBM_BPS
    t_ops = max(tc_flops / (tc_rate or BF16_PEAK), fp32_flops / FP32_FLOPS)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _attention_work(bw, nh, elem):
    """(bytes, product FLOPs, fp32 FLOPs) of window attention over bw
    windows: q, k, v in and the output out (elem bytes each), the fp32 bias
    and int32 flags; QK^T and PV; ~6 fp32 operations per score (bias, max,
    subtract, exp, sum, divide)."""
    nbytes = 4 * bw * nh * 64 * 32 * elem + nh * 64 * 64 * 4 + bw * 4
    return nbytes, bw * nh * 2 * (2 * 64 * 64 * 32), bw * nh * 64 * 64 * 6


def _block_work(bw, c, nh, elem):
    """(bytes, product FLOPs, fp32 FLOPs) of kernel B: x in and out, the
    GEMM weights (8 C^2) once, fp32 biases and LayerNorm parameters, the
    bias and flags; the four GEMMs (1024 C^2 FLOP per window) and the
    attention products; fp32 work of the softmax, the erf GELU (~8 per
    hidden value) and the two LayerNorms with the residuals (~20 per
    value)."""
    a_bytes, a_flops, a_fp32 = _attention_work(bw, nh, elem)
    nbytes = (2 * bw * 64 * c * elem + 8 * c * c * elem + 11 * c * 4
              + nh * 64 * 64 * 4 + bw * 4)
    flops = bw * 1024 * c * c + a_flops
    fp32 = a_fp32 + bw * 64 * (2 * c * 8 + c * 20)
    return nbytes, flops, fp32


def _sdpa_mask(torch, bias, flags, shift, dtype):
    """The relative bias and the shift mask as one float mask (BW, nh, 64,
    64) for F.scaled_dot_product_attention: -inf where masked."""
    from waifu2x_tensorrt_tpu_torch.ops.kernel_math import keep_mask

    bw, nh = flags.shape[0], bias.shape[0]
    mask = bias[None].expand(bw, nh, 64, 64)
    keep = keep_mask(flags, 8, shift)
    if keep is not None:
        mask = torch.where(keep[:, None], mask, float("-inf"))
    return mask.to(dtype).contiguous()


def _block_chain(torch, params, c, nh):
    """Kernel B's block as a chain of bf16 library calls (F.layer_norm,
    F.linear, SDPA, F.gelu): a yardstick of what PyTorch's own kernels
    take for the block. The port never calls it."""
    import torch.nn.functional as F

    w = {k: (v.t() if k.endswith("_kernel") else v).to(torch.bfloat16)
         .contiguous() for k, v in params.items()}

    def block(x, mask):
        bw = x.shape[0]
        h = F.layer_norm(x, (c,), w["n1_scale"], w["n1_bias"])
        qkv = F.linear(h, w["qkv_kernel"], w["qkv_bias"])
        q, k, v = qkv.view(bw, 64, 3, nh, 32).permute(2, 0, 3, 1, 4)
        a = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        x1 = x + F.linear(a.transpose(1, 2).reshape(bw, 64, c),
                          w["proj_kernel"], w["proj_bias"])
        m = F.layer_norm(x1, (c,), w["n2_scale"], w["n2_bias"])
        g = F.gelu(F.linear(m, w["fc1_kernel"], w["fc1_bias"]))
        return x1 + F.linear(g, w["fc2_kernel"], w["fc2_bias"])

    return block


def phase_kernels_ab(torch, report):
    import torch.nn.functional as F

    from waifu2x_tensorrt_tpu_torch.ops import swin_block as sb
    from waifu2x_tensorrt_tpu_torch.ops import window_attention as wa

    cases = [(4096, 96, 3), (1024, 192, 6), (37, 96, 3)]
    worst = {"A": 0.0, "B": 0.0}
    times = {}
    for bw, c, nh in cases:
        x, qkv, params, bias, flags = _block_inputs(torch, bw, c, nh,
                                                   torch.float32, seed=c + bw)
        ops16 = sb.block_operands(params, bias, torch.bfloat16)
        ops32 = sb.block_operands(params, bias, torch.float32)
        for shift in (0, 4):
            for name, kern, plain, inp in (
                    ("A", wa.fused_window_attention_qkv,
                     wa.window_attention_qkv_plain, qkv),
                    ("B", sb.fused_swin_block, sb.swin_block_plain, x)):
                args = (inp, params, bias, flags) if name == "B" else (
                    inp, bias, flags)
                kw = {"num_heads": nh, "shift": shift}
                k32 = kern(*args, **kw).float()
                p32 = plain(*args, **kw).float()
                err32 = (k32 - p32).abs().max().item()
                a16 = (inp.bfloat16(),) + args[1:]
                k16 = kern(*a16, **kw).float()
                p16 = plain(*a16, **kw).float()
                same = True
                if name == "B":  # prepared operands: the same bytes
                    same = torch.equal(sb.swin_block_prepared(
                        a16[0], ops16, flags, shift=shift).float(), k16)
                torch.cuda.synchronize()
                e_k = (k16 - p32).abs().max().item()
                e_p = (p16 - p32).abs().max().item()
                ok = err32 <= 1e-4 and e_k <= max(2 * e_p, 0.02) and same
                print(f"  kernel {name} BW={bw} C={c} nh={nh} shift={shift}: "
                      f"fp32 max|d|={err32:.3e} (tol 1e-4); bf16 "
                      f"|k16-p32|={e_k:.3e} <= max(2*{e_p:.3e}, 0.02)"
                      + ("; prepared operands give the same bytes: "
                         f"{same}" if name == "B" else "")
                      + f": {'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    raise AssertionError(f"kernel {name} disagrees with its "
                                         "plain version")
                worst[name] = max(worst[name], err32)
                if shift == 4 and bw != 37:
                    x16 = a16[0]
                    mask = _sdpa_mask(torch, bias, flags, 4, torch.bfloat16)
                    if name == "A":
                        km = _median_ms(lambda: kern(*a16, **kw))
                        km32 = _median_ms(lambda: kern(*args, **kw))
                        q, k, v = (x16.view(bw, 64, 3, nh, 32)
                                   .permute(2, 0, 3, 1, 4))
                        lm = _median_ms(
                            lambda: F.scaled_dot_product_attention(
                                q, k, v, attn_mask=mask))
                        work = _attention_work(bw, nh, 2)
                        extra = {"library_ms": lm, "fp32_ms": km32}
                        label = (f"SDPA with a float mask {lm:.3f} ms "
                                 f"(kernel / SDPA {km / lm:.2f}x); fp32 "
                                 f"kernel {km32:.3f} ms; "
                                 + _occupancy_label(wa.tc_occupancy()))
                    else:
                        km = _median_ms(lambda: sb.swin_block_prepared(
                            x16, ops16, flags, shift=4))
                        km32 = _median_ms(lambda: sb.swin_block_prepared(
                            inp, ops32, flags, shift=4))
                        chain = _block_chain(torch, params, c, nh)
                        lm = _median_ms(lambda: chain(x16, mask))
                        work = _block_work(bw, c, nh, 2)
                        b32 = _bound(*_block_work(bw, c, nh, 4),
                                     tc_rate=FP32_FLOPS)
                        extra = {"library_ms": None, "library_chain_ms": lm,
                                 "fp32_ms": km32, "fp32_bound_ms": b32[0]}
                        label = (f"fp32 kernel {km32:.3f} ms (bound "
                                 f"{b32[0]:.4f} ms at 67 TFLOP/s); "
                                 f"yardstick, bf16 library chain "
                                 f"(layer_norm, linear, SDPA, gelu; never "
                                 f"called by the port) {lm:.3f} ms")
                    pm = _median_ms(lambda: plain(*a16, **kw))
                    bms, by = _bound(*work)
                    times[(name, c)] = dict(ms=km, plain_ms=pm, bound_ms=bms,
                                            bound_by=by, **extra)
                    print(f"  kernel {name} bf16 BW={bw} C={c}: kernel "
                          f"{km:.3f} ms (bound {bms:.4f} ms by {by}, "
                          f"{100 * bms / km:.1f}% of it), plain {pm:.3f} "
                          f"ms; {label} (median, CUDA events)", flush=True)
    report["A"] = dict(times[("A", 96)], max_abs_err=worst["A"],
                       **{f"c192_{k}": v for k, v in times[("A", 192)].items()})
    report["B"] = dict(times[("B", 96)], max_abs_err=worst["B"])
    return times


def _occupancy_label(occ):
    return (f"tensor-core kernel: {occ['registers']} registers a thread, "
            f"{occ['ctas_per_sm']} CTAs = {occ['warps_per_sm']} warps per SM")


def _finalize_case(torch):
    """Kernel C's case: the finalize of the flagship config's 720p -> 4x
    plan, its plan and seeded bf16 chunk outputs split [16, 2]."""
    import numpy as np

    from waifu2x_tensorrt_tpu_torch.engine.config import (
        Precision,
        RenderConfig,
    )
    from waifu2x_tensorrt_tpu_torch.engine.renderer import make_chunked_fns
    from waifu2x_tensorrt_tpu_torch.models.registry import get_spec

    spec = get_spec("swin_unet/art", 4, 3)
    cfg = RenderConfig(precision=Precision.FP16, batch_size=16, height=256,
                       width=256, scaling=4, overlap=(1 / 16, 1 / 16))
    _p, fin, plan, sizes = make_chunked_fns(spec, cfg, (720, 1280), "cuda")
    assert sizes == [16, 2], sizes
    oh, ow = plan.output_tile
    rng = np.random.default_rng(4)
    outs = [torch.from_numpy(rng.random((n, oh, ow, 3), np.float32))
            .to("cuda", torch.bfloat16) for n in sizes]
    return fin, plan, outs


def _finalize_work(plan, elem):
    """(bytes, product FLOPs, fp32 FLOPs) of kernel C on ``plan``'s tiles
    of ``elem`` bytes a value: each tile value that covers the frame read
    once, each u8 output written once; two multiplies and an add per
    covering value, a multiply, a rounding and two clamps per output. The
    covering values are (covered rows) x (covered columns) x 3, each
    counted once per tile that covers it: at 720p -> 4x (3 x 6 tiles of
    1024, stride 960) 3008 x 5440 x 3 = 49.1 M, 98.2 MB in bf16, and with
    the 44.2 MB frame 142.4 MB, 0.0425 ms at 3.35 TB/s."""
    import numpy as np

    oh, ow = plan.output_tile
    out_h, out_w = plan.output_size

    def covered(origins, size, n):
        return sum(min(int(o) + size, n) - int(o) for o in np.unique(origins)
                   if o < n)

    n_cover = 3 * (covered(plan.output_origins[:, 0], oh, out_h)
                   * covered(plan.output_origins[:, 1], ow, out_w))
    n_out = out_h * out_w * 3
    return elem * n_cover + n_out, 0.0, 3.0 * n_cover + 4.0 * n_out


def _finalize_alone(torch, plan, outs):
    """(call, out): one launch of kernel C through ``finalize_gather`` on
    a tile table, ramps and an output built once here, as ``finalize``
    builds them per call."""
    from waifu2x_tensorrt_tpu_torch.ops.finalize_epilogue import (
        finalize_gather,
        grid_geometry,
    )

    oh, ow = plan.output_tile
    step = oh * ow * 3 * outs[0].element_size()
    ptrs = [o.data_ptr() + i * step for o in outs for i in range(o.shape[0])]
    table = torch.tensor(ptrs[:plan.tile_count], dtype=torch.int64,
                         device="cuda")
    rw = torch.from_numpy(plan.row_weights).cuda()
    cw = torch.from_numpy(plan.col_weights).cuda()
    out = torch.empty((*plan.output_size, 3), dtype=torch.uint8,
                      device="cuda")
    geom = (*grid_geometry(plan), oh, ow)
    bf16 = outs[0].dtype == torch.bfloat16

    def call():
        return finalize_gather(table, rw, cw, out, geom, bf16)

    return call, out


def _head_pack_work(z):
    """(bytes, product FLOPs, fp32 FLOPs) of kernel D on z: z read once,
    as many bytes written once; no arithmetic."""
    return 2 * z.numel() * z.element_size(), 0.0, 0.0


def _head_pack_chain(z, r):
    """Kernel D's function as a chain of library calls the port never
    calls (clamp, ``pixel_shuffle`` on the NCHW view, the permute back and
    a copy): a yardstick whose bytes equal D's output."""
    import torch

    return torch.pixel_shuffle(z.clamp(0, 1).permute(0, 3, 1, 2),
                               r).permute(0, 2, 3, 1).contiguous()


def _spread(times):
    """The range of a sample list as a share of its median, in percent."""
    return 100 * (times[-1] - times[0]) / times[len(times) // 2]


def _host_us(torch, fn, n=50):
    """µs of host time per call of ``fn`` over ``n`` calls in a row (the
    device's work is not waited for)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return host


def phase_kernel_c(torch, report):
    from waifu2x_tensorrt_tpu_torch.ops.finalize_epilogue import finalize_scan

    fin, plan, outs = _finalize_case(torch)
    got = fin(*outs)
    want = finalize_scan(outs, plan)
    # TileStream split: the frame's 18 tiles as the tail of one chunk and
    # the head of the next
    big = torch.cat([torch.zeros_like(outs[0][:9]), *outs,
                     torch.zeros_like(outs[0][:5])], 0)
    a, b = big[:16], big[16:]
    got_s = fin(a[9:], b[:11])
    alone, got_k = _finalize_alone(torch, plan, outs)
    alone()
    torch.cuda.synchronize()
    frames = (got, got_s, got_k)
    same = all(torch.equal(g, want) for g in frames)
    err = max((g.int() - want.int()).abs().max().item() for g in frames)
    assert tuple(got.shape) == (2880, 5120, 3) and got.dtype == torch.uint8

    def wrapper():
        return fin(*outs)

    ks, ws = _samples_ms(alone), _samples_ms(wrapper)
    kq, wq = _samples_ms(alone, queued=True), _samples_ms(wrapper, queued=True)
    ps = _samples_ms(lambda: finalize_scan(outs, plan), iters=5)
    km, wm, kqm, wqm, pm = (t[len(t) // 2] for t in (ks, ws, kq, wq, ps))
    bms, by = _bound(*_finalize_work(plan, outs[0].element_size()))
    print(f"  kernel C 720p->4x (T={plan.tile_count}, [16, 2], stream split "
          f"and kernel alone): byte-identical={same}", flush=True)
    print(f"  kernel C alone {km:.4f} ms (spread {_spread(ks):.1f}%), "
          f"wrapper per call {wm:.4f} ms (spread {_spread(ws):.1f}%), plain "
          f"scan {pm:.3f} ms (spread {_spread(ps):.1f}%); median per call "
          "over 10 calls in a row, CUDA events", flush=True)
    print(f"  kernel C device time, queue filled ahead: alone {kqm:.4f} ms "
          f"(spread {_spread(kq):.1f}%), wrapper {wqm:.4f} ms (spread "
          f"{_spread(wq):.1f}%)", flush=True)
    print(f"  kernel C bound {bms:.4f} ms by {by}: kernel alone "
          f"{100 * bms / km:.1f}% of it ({100 * bms / kqm:.1f}% queued), "
          f"wrapper {100 * bms / wm:.1f}% ({100 * bms / wqm:.1f}% queued)",
          flush=True)
    print(f"  kernel C host time a call: alone {_host_us(torch, alone):.1f} "
          f"µs, wrapper {_host_us(torch, wrapper):.1f} µs", flush=True)
    # fp32 tiles (the CLI's tf32) of the same values: the same bytes
    outs32 = [o.float() for o in outs]
    alone32, got32 = _finalize_alone(torch, plan, outs32)
    alone32()
    same32 = torch.equal(got32, want)
    f32m = _median_ms(alone32)
    f32q = _median_ms(alone32, queued=True)
    b32, _ = _bound(*_finalize_work(plan, 4))
    print(f"  kernel C fp32 tiles: byte-identical={same32}; alone {f32m:.4f} "
          f"ms, {f32q:.4f} ms queued ({100 * b32 / f32q:.1f}% of its bound "
          f"{b32:.4f} ms)", flush=True)
    if not (same and same32):
        raise AssertionError("kernel C is not byte-identical to the scan")
    report["C"] = {"max_abs_err": float(err), "ms": km, "plain_ms": pm,
                   "bound_ms": bms, "bound_by": by, "library_ms": None,
                   "wrapper_ms": wm, "queued_ms": kqm,
                   "queued_wrapper_ms": wqm, "fp32_ms": f32m,
                   "fp32_queued_ms": f32q, "fp32_bound_ms": b32}


def _counters():
    from waifu2x_tensorrt_tpu_torch.ops.finalize_epilogue import (
        finalize_gather,
    )
    from waifu2x_tensorrt_tpu_torch.ops.head_pack import pack_head_x16
    from waifu2x_tensorrt_tpu_torch.ops.swin_block import fused_swin_block
    from waifu2x_tensorrt_tpu_torch.ops.window_attention import (
        fused_window_attention,
        fused_window_attention_qkv,
    )

    from waifu2x_tensorrt_tpu_torch.ops.mma_probe import mma_probe

    return {"A": fused_window_attention_qkv, "B": fused_swin_block,
            "C": finalize_gather, "D": pack_head_x16,
            "E": fused_window_attention, "F": mma_probe}


def _load(torch, precision, fused_block=None, batch=16):
    from waifu2x_tensorrt_tpu_torch.engine.config import RenderConfig
    from waifu2x_tensorrt_tpu_torch.engine.upscaler import Upscaler

    up = Upscaler(allow_random_init=True, device="cuda:0")
    cfg = RenderConfig(precision=precision, batch_size=batch, height=256,
                       width=256, scaling=4, overlap=(1 / 16, 1 / 16))
    up.load("swin_unet/art", 4, 3, cfg, fused_block=fused_block)
    return up


def _golden_gate(got, want, max_frac=1e-4):
    """(ok, max |d|, changed fraction) of two u8 frames: max <= 2 LSB and
    at most ``max_frac`` of the values changed."""
    import numpy as np

    diff = np.abs(got.astype(int) - want.astype(int))
    frac = float((diff > 0).mean())
    return diff.max() <= 2 and frac <= max_frac, int(diff.max()), frac


def _zero_counters():
    counters = _counters()
    for f in counters.values():
        f.launches = 0
    return counters


def phase_main_path(torch, smi, report):
    import numpy as np

    from waifu2x_tensorrt_tpu_torch.engine.config import Precision

    counters = _zero_counters()
    up = _load(torch, Precision.FP16)
    frame, frames = _phase5_frames()
    t0 = time.perf_counter()
    out = up.render(frame)
    first_s = time.perf_counter() - t0
    if out.shape != (2880, 5120, 3) or out.dtype != np.uint8:
        raise AssertionError(f"render gave {out.shape} {out.dtype}")
    print(f"  phase 5 render 720p -> {out.shape} {out.dtype} in "
          f"{first_s:.2f} s (first call), mean {out.mean():.3f}", flush=True)

    stream = up.open_stream((720, 1280))
    stream.warm()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = []
    for f in frames:
        outs.extend(stream.submit(f))
    outs.extend(stream.flush())
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n5 = {k: f.launches for k, f in counters.items()}
    if len(outs) != 10 or any(tuple(o.shape) != (2880, 5120, 3)
                              for o in outs):
        raise AssertionError("stream returned wrong outputs")
    fps = 10 / dt
    mps = fps * 2880 * 5120 / 1e6
    print(f"  phase 5 stream: 10 frames in {dt:.3f} s = {fps:.3f} frames/s, "
          f"{mps:.2f} output MP/s on {smi}", flush=True)
    print(f"  phase 5 launch counts (main path, fused_block=True): {n5}",
          flush=True)
    if n5["B"] <= 0 or n5["C"] <= 0 or n5["D"] != 0:
        raise AssertionError(f"phase 5 did not launch kernels B and C "
                             f"alone: {n5}")
    # frame 3's 18 tiles straddle two stream chunks (3 * 18 = 54 = 3 * 16
    # + 6): its streamed output against its single-frame render. The
    # render runs tiles 16-17 as a 2-tile chunk, for which cuBLAS and
    # cuDNN pick other bf16 kernels than for 16 tiles, so a few values
    # round the other way; a misplaced tile moves whole regions by more
    # than 2 LSB.
    ok, dmax, frac = _golden_gate(outs[3].cpu().numpy(), up.render(frames[3]),
                                  max_frac=1e-3)
    print(f"  phase 5 streamed frame 3 vs its single-frame render: max "
          f"{dmax} (tol 2), changed fraction {frac:.2e} (tol 1e-03): "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("streamed frame differs from its render")
    report["stream"] = {"frames_per_s": fps, "output_mp_per_s": mps,
                        "seconds_10_frames": dt}
    return n5, out


def _phase5_frames():
    """The first 720p frame of phase 5 and its 10 streamed frames."""
    import numpy as np

    rng = np.random.default_rng(5)
    frame = rng.integers(0, 256, (720, 1280, 3), np.uint8)
    return frame, [rng.integers(0, 256, (720, 1280, 3), np.uint8)
                   for _ in range(10)]


def phase_fused_block_false(torch, smi, report):
    """Phase 7: the phase-5 config with fused_block=False, one 720p frame,
    then 4 streamed frames; returns the launch counts of the stream."""
    import numpy as np

    from waifu2x_tensorrt_tpu_torch.engine.config import Precision

    counters = _zero_counters()
    up = _load(torch, Precision.FP16, fused_block=False)
    rng = np.random.default_rng(7)
    frame = rng.integers(0, 256, (720, 1280, 3), np.uint8)
    out = up.render(frame)
    n7 = {k: f.launches for k, f in counters.items()}
    if out.shape != (2880, 5120, 3) or out.dtype != np.uint8:
        raise AssertionError(f"phase 7 render gave {out.shape} {out.dtype}")
    print(f"  phase 7 fused_block=False render 720p -> {out.shape}; launch "
          f"counts of this run {n7}", flush=True)
    if n7["A"] <= 0 or n7["B"] != 0:
        raise AssertionError(f"phase 7 did not run kernel A alone: {n7}")

    frames = [rng.integers(0, 256, (720, 1280, 3), np.uint8)
              for _ in range(4)]
    stream = up.open_stream((720, 1280))
    stream.warm()
    torch.cuda.synchronize()
    counters = _zero_counters()
    t0 = time.perf_counter()
    outs = []
    for f in frames:
        outs.extend(stream.submit(f))
    outs.extend(stream.flush())
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n7s = {k: f.launches for k, f in counters.items()}
    if len(outs) != 4 or any(tuple(o.shape) != (2880, 5120, 3)
                             for o in outs):
        raise AssertionError("phase 7 stream returned wrong outputs")
    tiles = up._pipeline.get((720, 1280))[2].tile_count
    chunks = -(-len(frames) * tiles // 16)  # full chunks + the flushed tail
    mps = len(frames) / dt * 2880 * 5120 / 1e6
    print(f"  phase 7 fused_block=False stream: 4 frames in {dt:.3f} s = "
          f"{mps:.2f} output MP/s; fused_block=True (phase 5, same call) "
          f"{report['stream']['output_mp_per_s']:.2f} output MP/s, on {smi};"
          f" launch counts of the stream {n7s} over {chunks} chunks",
          flush=True)
    if n7s["A"] != 10 * chunks or any(v for k, v in n7s.items()
                                      if k not in ("A", "C")):
        raise AssertionError(f"phase 7 stream: not 10 launches of kernel A "
                             f"per chunk: {n7s}")
    report["stream_fused_block_false"] = {
        "frames_per_s": len(frames) / dt, "output_mp_per_s": mps,
        "seconds_4_frames": dt}
    return n7s


@contextlib.contextmanager
def _swin_block_as(fn, plain_finalize=False):
    """Inside the context every fused Swin block runs ``fn(x, operands,
    flags, shift=, ws=)`` in place of kernel B, and pipelines made there finalize with the plain scan in
    place of kernel C when ``plain_finalize`` is set."""
    import waifu2x_tensorrt_tpu_torch.engine.renderer as renderer
    import waifu2x_tensorrt_tpu_torch.models.swin_unet as swin
    from waifu2x_tensorrt_tpu_torch.ops.finalize_epilogue import finalize_scan

    saved = (swin.swin_block_prepared, renderer.make_finalize_epilogue)
    swin.swin_block_prepared = fn
    if plain_finalize:
        renderer.make_finalize_epilogue = (
            lambda plan, device: lambda *outs: finalize_scan(outs, plan))
    try:
        yield
    finally:
        swin.swin_block_prepared, renderer.make_finalize_epilogue = saved


def _plain_prepared(x, operands, flags, **kw):
    """Kernel B's plain twin on a block's prepared operands."""
    from waifu2x_tensorrt_tpu_torch.ops.swin_block import swin_block_plain

    return swin_block_plain(x, operands.params(), operands.bias, flags,
                            num_heads=operands.num_heads, **kw)


def _unit_scale_params(module, seed):
    """Seeded weights at unit scale: LayerNorm scales N(1, 0.1), GEMM and
    conv kernels N(0, 1/fan_in), biases N(0, 0.1), relative-position bias
    N(0, 0.2). The registry's N(0, 0.02) init keeps the output within
    0.09 of 0; at this scale it spans several units and the Swin blocks
    shape most of it."""
    import numpy as np

    from waifu2x_tensorrt_tpu_torch.models import registry

    flat = registry.init_params(module, seed=seed)  # N(0, 0.02) leaves
    for k, v in flat.items():
        if k.endswith("/scale"):
            flat[k] = 1 + 5 * v
        elif k.endswith("/kernel"):
            flat[k] = v / (0.02 * np.sqrt(np.prod(v.shape[:-1])))
        elif k.endswith("relative_position_bias"):
            flat[k] = 10 * v
        else:
            flat[k] = 5 * v
    return flat


def phase_network_gate(torch):
    import numpy as np

    from waifu2x_tensorrt_tpu_torch.engine.config import (
        Precision,
        RenderConfig,
    )
    from waifu2x_tensorrt_tpu_torch.engine.renderer import make_chunked_fns
    from waifu2x_tensorrt_tpu_torch.models import registry

    frame = np.random.default_rng(6).integers(0, 256, (720, 1280, 3),
                                              np.uint8)
    # a. the u8 frame, seed-0 weights: kernels B and C vs their plain twins
    got = _load(torch, Precision.TF32).render(frame)
    with _swin_block_as(_plain_prepared, plain_finalize=True):
        want = _load(torch, Precision.TF32).render(frame)
    ok, dmax, frac = _golden_gate(got, want)
    print(f"  phase 6a tf32 frame, kernel path vs all-plain path: max "
          f"{dmax} (tol 2), changed fraction {frac:.2e} (tol 1e-04), output "
          f"mean {got.mean():.3f} std {got.std():.3f}: "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("tf32 golden gate failed")

    # b. the model's output before the clamp, for both weight sets
    cfg = RenderConfig(precision=Precision.TF32, batch_size=16, height=256,
                       width=256, scaling=4, overlap=(1 / 16, 1 / 16))
    spec = registry.get_spec("swin_unet/art", 4, 3)
    prepare, _fin, _plan, _sizes = make_chunked_fns(spec, cfg, (720, 1280),
                                                    "cuda:0")
    tiles = prepare.flat(torch.from_numpy(frame).cuda())  # (18, 256, 256, 3)

    def forward(dtype, weights):
        module, _ = registry.create_model("swin_unet/art", 4, 3, dtype=dtype,
                                          fused_block=True, device="cuda:0")
        module.clamp = False
        registry.load_into(module, weights(module))
        with torch.inference_mode():
            return torch.cat([module(c).float() for c in tiles.split(16)])

    for label, weights in (
            ("seed-0", lambda m: registry.init_params(m, seed=0)),
            ("unit-scale", lambda m: _unit_scale_params(m, seed=1))):
        k32 = forward(torch.float32, weights)
        k16 = forward(torch.bfloat16, weights)
        with _swin_block_as(_plain_prepared):
            p32 = forward(torch.float32, weights)
            p16 = forward(torch.bfloat16, weights)
        with _swin_block_as(lambda x, *args, **kw: x):
            n32 = forward(torch.float32, weights)  # every Swin block left out
        top = p32.abs().max().item()
        rel32 = (k32 - p32).abs().max().item() / top
        share = (p32 - n32).abs().max().item() / top
        e_k = (k16 - p32).abs().max().item()
        e_p = (p16 - p32).abs().max().item()
        in_range = ((p32 >= 0) & (p32 <= 1)).float().mean().item()
        ok = rel32 <= 1e-4 and e_k <= max(2 * e_p, 0.02) and share >= 1e-2
        print(f"  phase 6b pre-clamp output of 18 tiles {tuple(k32.shape)}, "
              f"{label} weights (max |plain| {top:.4f}, {in_range:.3f} of "
              f"values in [0, 1]): fp32 max|d| {rel32:.3e} of max |plain| "
              f"(tol 1e-4); bf16 |k16-p32| {e_k:.3e} <= max(2*{e_p:.3e}, "
              f"0.02); Swin blocks' share {share:.3e} (>= 1e-2): "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"{label} weights: the network's kernel "
                                 "path disagrees with its plain path")


def phase_kernels_de(torch, report):
    """Phase 8: kernels D and E against their plain twins; returns the
    launch counts of E's one call through the ops package API."""
    from waifu2x_tensorrt_tpu_torch import ops
    from waifu2x_tensorrt_tpu_torch.models.swin_unet import _pixel_shuffle
    from waifu2x_tensorrt_tpu_torch.ops import head_pack as hp
    from waifu2x_tensorrt_tpu_torch.ops import window_attention as wa

    gen = torch.Generator(device="cuda").manual_seed(8)
    worst_d = 0.0
    for r in (4, 2):
        z32 = torch.rand((16, 256, 256, 3 * r * r), generator=gen,
                         device="cuda") * 1.6 - 0.3
        for z in (z32.bfloat16(), z32):
            k = hp.pack_head_x16(z, r=r)
            p = hp.pack_head_plain(z, r)
            pix = _pixel_shuffle(torch.clamp(z, 0.0, 1.0), r).contiguous()
            torch.cuda.synchronize()
            same = torch.equal(k, p) and torch.equal(
                k.reshape(-1).view(torch.uint8),
                pix.reshape(-1).view(torch.uint8))
            err = (k.float() - p.float()).abs().max().item()
            worst_d = max(worst_d, err)
            print(f"  kernel D r={r} {tuple(z.shape)} {z.dtype} -> "
                  f"{tuple(k.shape)}: equal to plain and bytes equal to "
                  f"clamp + pixel shuffle: {same} (max|d| {err:.1e})",
                  flush=True)
            chain = _head_pack_chain(z, r)
            if not (same and torch.equal(k.reshape(-1).view(torch.uint8),
                                         chain.reshape(-1).view(
                                             torch.uint8))):
                raise AssertionError("kernel D differs from its plain twin "
                                     "or from the library chain")
            if r == 4 and z.dtype == torch.bfloat16:
                km = _median_ms(lambda: hp.pack_head_x16(z, r=4))
                pm = _median_ms(lambda: hp.pack_head_plain(z, 4))
                lm = _median_ms(lambda: _head_pack_chain(z, 4))
                print(f"  kernel D bf16 r=4: kernel {km:.4f} ms, plain "
                      f"{pm:.3f} ms, yardstick (library chain: clamp, "
                      f"pixel_shuffle, permutes; never called by the port) "
                      f"{lm:.4f} ms (median, CUDA events)", flush=True)
                bms, by = _bound(*_head_pack_work(z))
                print(f"  kernel D bound {bms:.4f} ms by {by} "
                      f"({100 * bms / km:.1f}% of it)", flush=True)
                report["D"] = {"max_abs_err": 0.0, "ms": km, "plain_ms": pm,
                               "bound_ms": bms, "bound_by": by,
                               "library_ms": None, "library_chain_ms": lm}
        del z32, z, k, p, pix, chain
    report["D"]["max_abs_err"] = worst_d

    worst_e = 0.0
    for bw, nh in ((4096, 3), (1024, 6), (37, 3)):
        q, k, v = (torch.randn((bw, nh, 64, 32), generator=gen,
                               device="cuda") for _ in range(3))
        bias = torch.randn((nh, 64, 64), generator=gen, device="cuda") * 0.2
        flags = torch.randint(0, 4, (bw,), generator=gen, device="cuda",
                              dtype=torch.int32)
        for shift in (0, 4):
            args = (q, k, v, bias, flags)
            k32 = wa.fused_window_attention(*args, shift=shift).float()
            p32 = wa.window_attention_plain(*args, shift=shift).float()
            a16 = (q.bfloat16(), k.bfloat16(), v.bfloat16(), bias, flags)
            k16 = wa.fused_window_attention(*a16, shift=shift).float()
            p16 = wa.window_attention_plain(*a16, shift=shift).float()
            torch.cuda.synchronize()
            err32 = (k32 - p32).abs().max().item()
            e_k = (k16 - p32).abs().max().item()
            e_p = (p16 - p32).abs().max().item()
            ok = err32 <= 1e-4 and e_k <= max(2 * e_p, 0.02)
            print(f"  kernel E BW={bw} nh={nh} shift={shift}: fp32 "
                  f"max|d|={err32:.3e} (tol 1e-4); bf16 |k16-p32|={e_k:.3e} "
                  f"<= max(2*{e_p:.3e}, 0.02): {'ok' if ok else 'FAIL'}",
                  flush=True)
            if not ok:
                raise AssertionError("kernel E disagrees with its plain "
                                     "version")
            worst_e = max(worst_e, err32)
            if shift == 4 and bw == 4096:
                km = _median_ms(lambda: wa.fused_window_attention(
                    *a16, shift=4))
                km32 = _median_ms(lambda: wa.fused_window_attention(
                    *args, shift=4))
                pm = _median_ms(lambda: wa.window_attention_plain(
                    *a16, shift=4))
                mask = _sdpa_mask(torch, bias, flags, 4, torch.bfloat16)
                lm = _median_ms(lambda: torch.nn.functional
                                .scaled_dot_product_attention(
                                    a16[0], a16[1], a16[2], attn_mask=mask))
                bms, by = _bound(*_attention_work(bw, nh, 2))
                print(f"  kernel E bf16 BW={bw} nh={nh}: kernel {km:.3f} "
                      f"ms (bound {bms:.4f} ms by {by}, "
                      f"{100 * bms / km:.1f}% of it), plain {pm:.3f} ms, "
                      f"SDPA with a float mask {lm:.3f} ms (kernel / SDPA "
                      f"{km / lm:.2f}x); fp32 kernel {km32:.3f} ms; "
                      + _occupancy_label(wa.tc_occupancy())
                      + " (median, CUDA events)", flush=True)
                report["E"] = {"ms": km, "plain_ms": pm, "bound_ms": bms,
                               "bound_by": by, "library_ms": lm,
                               "fp32_ms": km32}
                api_args = a16
    report["E"]["max_abs_err"] = worst_e
    # E's run: one call through the ops package's public API
    counters = _zero_counters()
    out = ops.fused_window_attention(*api_args, shift=4)
    torch.cuda.synchronize()
    n8 = {name: f.launches for name, f in counters.items()}
    print(f"  phase 8 ops.fused_window_attention {tuple(out.shape)}: launch "
          f"counts of this call {n8}", flush=True)
    if n8["E"] != 1:
        raise AssertionError(f"the ops API call did not launch kernel E: "
                             f"{n8}")
    return n8


def phase_packed_x(torch, smi, report, pixel_out):
    """Phase 9: the packed-x main path (WAIFU2X_PACK_X=1 for this phase
    only); returns its launch counts."""
    import numpy as np

    from waifu2x_tensorrt_tpu_torch.engine.config import Precision

    saved = os.environ.get("WAIFU2X_PACK_X")
    os.environ["WAIFU2X_PACK_X"] = "1"
    try:
        counters = _zero_counters()
        up = _load(torch, Precision.FP16)
        if not up._pipeline.get((720, 1280))[0].use_pack_x:
            raise AssertionError("the 720p geometry did not route through "
                                 "the packed-x twin")
        frame, frames = _phase5_frames()
        out = up.render(frame)
        same = np.array_equal(out, pixel_out)
        ok, dmax, frac = _golden_gate(out, pixel_out)
        print(f"  phase 9 packed-x render 720p -> {out.shape} {out.dtype}: "
              f"byte-identical to phase 5's pixel-head render: {same} "
              f"(max {dmax}, changed fraction {frac:.2e})", flush=True)
        if not same:
            if not ok:
                raise AssertionError("packed-x frame fails the golden gate "
                                     "against the pixel path")
            print("  phase 9 NOTE: not byte-identical, inside the golden "
                  "gate (max <= 2 LSB, <= 1e-4 changed)", flush=True)
        stream = up.open_stream((720, 1280))
        stream.warm()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = []
        for f in frames:
            outs.extend(stream.submit(f))
        outs.extend(stream.flush())
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n9 = {k: f.launches for k, f in counters.items()}
        if len(outs) != 10 or any(tuple(o.shape) != (2880, 5120, 3)
                                  for o in outs):
            raise AssertionError("packed-x stream returned wrong outputs")
        fps = 10 / dt
        mps = fps * 2880 * 5120 / 1e6
        print(f"  phase 9 packed-x stream: 10 frames in {dt:.3f} s = "
              f"{fps:.3f} frames/s, {mps:.2f} output MP/s; pixel head "
              f"(phase 5, same call) {report['stream']['output_mp_per_s']:.2f}"
              f" output MP/s, on {smi}", flush=True)
        print(f"  phase 9 launch counts (packed-x main path): {n9}",
              flush=True)
        if n9["D"] <= 0 or n9["B"] <= 0 or n9["C"] <= 0:
            raise AssertionError(f"phase 9 did not launch D, B and C: {n9}")
        ok, dmax, frac = _golden_gate(outs[3].cpu().numpy(),
                                      up.render(frames[3]), max_frac=1e-3)
        print(f"  phase 9 streamed frame 3 vs its single-frame render: max "
              f"{dmax} (tol 2), changed fraction {frac:.2e} (tol 1e-03): "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError("packed-x streamed frame differs from its "
                                 "render")
        report["stream_packed_x"] = {"frames_per_s": fps,
                                     "output_mp_per_s": mps,
                                     "seconds_10_frames": dt}
        return n9
    finally:
        if saved is None:
            os.environ.pop("WAIFU2X_PACK_X", None)
        else:
            os.environ["WAIFU2X_PACK_X"] = saved


def _work_ratio(ip, call):
    """t(R) / t(R/2) of kernel F, ``call(reps)``: each time the median of
    three ``time_call`` readings, taken alternately so that both see the
    same clocks. Near 2 when every product runs."""
    full, half = [], []
    for _ in range(3):
        half.append(ip.time_call(lambda: call(ip.R // 2)))
        full.append(ip.time_call(lambda: call(ip.R)))
    return sorted(full)[1] / sorted(half)[1]


def phase_kernel_f(torch, smi, report):
    """Phase 10: kernel F against its plain twin at the probe's shapes;
    then the probe's own run, whose kernel times are printed beside the
    bound, the plain twin and the library calls. Returns the launch counts
    of that run."""
    import numpy as np

    from waifu2x_tensorrt_tpu_torch.ops.mma_probe import (
        fp32_sum_bound,
        mma_probe,
        mma_probe_plain,
    )
    from waifu2x_tensorrt_tpu_torch.probes import int8_probe as ip

    peaks = {"int8": ip.INT8_PEAK, "bf16": ip.BF16_PEAK}
    worst = {"int8": 0.0, "bf16": 0.0}
    times = {}
    rng = np.random.default_rng(0)  # the probe's draws, in its order
    for name, m, k, n in ip.SHAPES:
        a8, b8, abf, bbf = ip.make_inputs(m, k, n, rng, "cuda")
        int_mm, mm = ip.library_calls(a8, b8, abf, bbf)
        for label, a, b, lib in (("bf16", abf, bbf, mm),
                                 ("int8", a8, b8, int_mm)):
            a2 = ip.stack2(a)
            for reps in (3, ip.R):
                got = mma_probe(a2, b, reps)
                want = mma_probe_plain(a2, b, reps)
                err = (got.double() - want.double()).abs().max().item()
                if label == "int8":
                    ok, rule = torch.equal(got, want), "equal"
                else:
                    tol = fp32_sum_bound(a, b)
                    ok = bool(torch.isfinite(got).all()) and err <= tol
                    rule = f"max|d| {err:.3e} <= {tol:.3e}"
                print(f"  kernel F {label} {name} R={reps}: {rule}: "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    raise AssertionError("kernel F disagrees with its plain "
                                         "version")
                worst[label] = max(worst[label], err)
            nbytes = (a2.numel() + b.numel()) * a.element_size() + m * n * 4
            bms, by = _bound(nbytes, tc_flops=2.0 * m * k * n * ip.R,
                             tc_rate=peaks[label])
            times[(name, label)] = {
                "r_ratio": _work_ratio(ip, lambda r: mma_probe(a2, b, r)),
                "plain_ms": ip.time_call(
                    lambda: mma_probe_plain(a2, b, ip.R)),
                "bound_ms": bms, "bound_by": by,
                "library_ms": ip.R * ip.time_call(lib)}

    # the probe's own run: what python -m ...probes.int8_probe prints
    counters = _zero_counters()
    rows_b = ip.run()
    rows_a = ip.run_library()
    torch.cuda.synchronize()
    n10 = {k: f.launches for k, f in counters.items()}
    ip.print_report(rows_b, rows_a, smi)
    print(f"  phase 10 launch counts (the probe's run): {n10}", flush=True)
    if n10["F"] <= 0 or any(v for k, v in n10.items() if k != "F"):
        raise AssertionError(f"the probe's run did not launch kernel F "
                             f"alone: {n10}")
    for r in rows_b:
        for label in ("bf16", "int8"):
            t = times[(r["name"], label)]
            t["ms"] = r[f"{label}_ms"]
            ratio = t.pop("r_ratio")
            share = r[f"{label}_peak_share"]
            call = "_int_mm" if label == "int8" else "bf16 matmul"
            print(f"  kernel F {label} {r['name']} R={ip.R}: kernel "
                  f"{t['ms']:.4f} ms (bound {t['bound_ms']:.4f} ms by "
                  f"{t['bound_by']}; {100 * share:.1f}% of the dense peak), "
                  f"plain {t['plain_ms']:.3f} ms, library (R x one {call}) "
                  f"{t['library_ms']:.4f} ms (median, CUDA events); "
                  f"t(R) / t(R/2) {ratio:.4f}", flush=True)
            if share > 1.05:
                raise AssertionError(f"kernel F {label} {r['name']}: rate "
                                     "above 1.05x the peak, the work was "
                                     "skipped")
            if not 1.8 <= ratio <= 2.2:
                raise AssertionError(f"kernel F {label} {r['name']}: "
                                     f"t(R) / t(R/2) = {ratio:.4f}, outside "
                                     "1.8-2.2: the time does not follow "
                                     "the number of products")
    ideal = ip.SHAPES[0][0]
    report["F"] = dict(times[(ideal, "int8")], max_abs_err=worst["int8"],
                       **{f"bf16_{k}": v
                          for k, v in times[(ideal, "bf16")].items()},
                       bf16_max_abs_err=worst["bf16"],
                       gate_pursue_int8=ip.gate(rows_b))
    return n10


def main() -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    torch = _require_cuda()
    os.environ.pop("WAIFU2X_PACK_X", None)  # phase 5 is the default path
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from waifu2x_tensorrt_tpu_torch.ops import build

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"phase 1 device: {name}; nvidia-smi: {smi}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    lib_path = build.build()
    build.load_library()
    print(f"phase 2 kernel build: {time.perf_counter() - t0:.1f} s "
          f"({lib_path.name})", flush=True)

    report = {}
    print("phase 3 kernels A and B vs plain:", flush=True)
    phase_kernels_ab(torch, report)
    print("phase 4 kernel C vs plain scan:", flush=True)
    phase_kernel_c(torch, report)
    print("phase 5 main path:", flush=True)
    n5, out5 = phase_main_path(torch, smi, report)
    print("phase 6 network, kernel path vs plain path:", flush=True)
    phase_network_gate(torch)
    print("phase 7 fused_block=False:", flush=True)
    n7 = phase_fused_block_false(torch, smi, report)
    print("phase 8 kernels D and E vs plain:", flush=True)
    n8 = phase_kernels_de(torch, report)
    print("phase 9 packed-x main path:", flush=True)
    n9 = phase_packed_x(torch, smi, report, out5)
    print("phase 10 kernel F (int8/bf16 mma probe) vs plain:", flush=True)
    n10 = phase_kernel_f(torch, smi, report)

    src = "waifu2x_tensorrt_tpu_torch/ops/csrc/"
    main_run = ("phase 5: main path, fused_block=True, bf16, tile 256, "
                "batch 16, 720p render + 10 streamed frames")
    a_run = ("phase 7: fused_block=False, bf16, tile 256, batch 16, 4 "
             "streamed 720p frames (5 chunks)")
    e_run = ("phase 8: one call of ops.fused_window_attention (the ops "
             "package API), BW 4096, nh 3, bf16, shift 4")
    px_run = ("phase 9: WAIFU2X_PACK_X=1, otherwise as phase 5: 720p "
              "render + 10 streamed frames")
    f_run = ("phase 10: the probe's run (int8_probe.run and run_library), "
             "4 shapes x 2 types x 12 calls of R = 2048 products; times at "
             "the ideal shape (512, 1024, 512), int8 and bf16_*")
    meta = {
        "A": ("window_attention_qkv", src + "window_attention.cu",
              "waifu2x_tensorrt_tpu/ops/window_attention.py:212",
              n7["A"], a_run),
        "B": ("swin_block", src + "swin_block.cu",
              "waifu2x_tensorrt_tpu/ops/swin_block.py:269", n5["B"],
              main_run),
        "C": ("finalize_gather", src + "finalize_epilogue.cu",
              "waifu2x_tensorrt_tpu/ops/finalize_epilogue.py:201", n5["C"],
              main_run),
        "D": ("head_pack", src + "head_pack.cu",
              "waifu2x_tensorrt_tpu/ops/head_pack.py:120", n9["D"], px_run),
        "E": ("window_attention_heads", src + "window_attention.cu",
              "waifu2x_tensorrt_tpu/ops/window_attention.py:267", n8["E"],
              e_run),
        "F": ("mma_probe", src + "mma_probe.cu",
              "probes/int8_pallas_probe.py:71", n10["F"], f_run),
    }
    kernels = [{"name": meta[k][0], "route": "cuda", "source": meta[k][1],
                "replaces": meta[k][2], "launches": meta[k][3],
                "launches_counted_in": meta[k][4],
                **{key: report[k][key] for key in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")},
                **{key: value for key, value in report[k].items()
                   if key.startswith(("library_chain", "fp32_", "bf16_",
                                      "c192_", "gate_", "wrapper_",
                                      "queued_"))}}
               for k in ("A", "B", "C", "D", "E", "F")]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
