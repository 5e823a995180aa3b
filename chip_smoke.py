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
     byte to B on per-call ones; median times, each dtype beside its own
     bound (fp32 at 67 TFLOP/s), its plain twin and its yardstick: B on
     prepared operands beside a chain of library calls in its dtype
     (layer_norm, linear, SDPA, gelu) that the port never calls, A beside
     ``scaled_dot_product_attention`` with the bias and shift mask as one
     float mask of its dtype; the registers, spills and resident warps of
     the tensor-core and fp32 kernels
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
     of the values changed); every chunk runs as a captured CUDA graph
     (the first call at a chunk shape eagerly, then captured), and the
     launch counts are exact: B 10 a chunk over the render's 2, the warm
     cycle's 9, the warm's 7 tail programs (2, 4, ..., 14 tiles) and the
     stream's 12 chunks, 300 in all; C one a frame, 19
  6. the whole network on the card, kernel path vs all-plain path:
     a. one frame in tf32 (fp32) with the seed-0 weights, through the
        golden gate (max <= 2 LSB, <= 1e-4 of pixels changed), its render
        launching fp32 B 10 times a chunk (20) and C once;
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
     phase 3's rules; times as in phase 3 (bf16 and fp32 E, each beside
     its bound, its plain twin and SDPA in its dtype); then one call of
     E through the
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
 11. cunet/art at full width (the upstream architecture), with seeded
     unit-scale weights read from a weight file (``_cunet_weights``; the
     seed-0 init leaves the frame within 2 LSB of black), kernel C
     finalizing every frame:
     a. 2x noise 1, tile 256, batch 4, bf16 (bench.py config 1b): one
        512 x 512 render, one launch of C; the bf16 frame within 0.02 x
        255 of the card's fp32 frame (the bf16 rule's floor: the model
        has no kernel with a plain twin), the card's fp32 frame against
        the port's CPU fp32 render through the golden gate;
     b. the whole frame as one 548 x 548 tile, batch 16, bf16, 32
        streamed 512 x 512 frames (config 1c), output MP/s;
     c. 1080p, tile 256, batch 16, bf16, 8 streamed frames (config 1d),
        output MP/s; in (b) and (c) one launch of C a frame and one
        streamed frame within 0.02 x 255 of its single-frame render;
     d. the noise-only scale-1 CUNet, tile 256: one render, bf16 within
        0.02 x 255 of fp32
 12. 8-way TTA and whole-frame swin_unet at full width, seed-0 weights:
     a. swin_unet/art_scan 4x noise 3, tile 128, batch 8, bf16, TTA, 512 x
        512 stills (config 3): one frame through B and C; the frame in
        tf32 through B and C against the all-plain path (golden gate, as
        6a); 8 streamed frames (200 steps each), output MP/s, B's and C's
        launches, one frame held against its render as in phase 5;
     b. rect TTA: the whole of a 136 x 200 frame, swin 2x, bf16, through
        B and C; ``open_stream`` returns None for it;
     c. the whole of a 200 x 136 frame (tile 0), swin 2x, tf32, against
        the all-plain path (golden gate);
     d. the dihedral transforms on card tensors: exact round trips, the
        CPU's bytes
 13. the port's CLI (``cli.main``, seed-0 weights, full width), with
     ffmpeg / ffprobe stand-ins (``write_ffmpeg_shims``: raw rgb24 clips
     over pipes) first on PATH for this phase only, decode and encode
     through the native framepipe (built with g++ into build/framepipe/,
     its frames counted):
     a. an 8-frame 720p clip, swin_unet/photo 2x, tile 256, batch 16, bf16
        (bench.py config4): B 10 launches a chunk and C one a frame, warm
        cycle included; each output frame against ``Upscaler.render`` of
        its input as in phase 5; frames/s and output MP/s of the whole
        CLI call (engine load, warm cycle and the shim's pipes included)
        beside phase 5's streamed rate;
     b. the clip with ``--segment-frames 3`` (a stream a segment), then
        again with ``--resume`` (no launch); the stitched clip against
        (a)'s, in bf16 and fp32 (--precision tf32): byte-identical, or in
        bf16 within the golden gate, as printed;
     c. a folder of 8 512 x 512 stills and one 384 x 640 between them,
        swin_unet/art 4x noise 3, tile 256, batch 16, bf16 (config6),
        through the cross-file image stream (three runs); each output
        against its single render, golden gate; ``--metrics-json`` read
        back;
     d. an RGBA still with ``--alpha auto``: 4 channels; RGB against the
        render of ``fill_transparent``, alpha against the rounded channel
        mean of the alpha plane's render (golden gate)
 14. ``.onnx`` artifacts (seeded full-width exports of
     ``tests/torch_mirror.py``, written under build/chip_smoke_onnx/):
     a. swin_unet/art 4x noise 3 (base_dim 96, depths (2, 2, 6, 2, 2),
        exported at tile 256) through the CLI's ``build`` (fp16, batch 16,
        tile 256), cold (no ``.verify.json``, nvcc compiling the kernel
        library into an empty directory) and warm (both cached): exit 0, one
        engine sidecar, ``.verify.json`` max_err <= 1e-4, B 10 launches a
        build (one forward at the profile's corner); seconds of each, and
        the host seconds of parse, shape probe, conversion and
        verification;
     b. phase 5's 10 streamed 720p frames from the ``.onnx`` alone
        (``require_engine=True``: the build's sidecar), the verified path,
        two passes: B 10 a chunk, C one a frame; byte-identical to the
        stream of the weights ``validate --save-npz`` wrote (its gate
        printed), rendered from the ``.npz``;
     c. ``graph_exact``: the frames in tf32 against the verified tf32
        path (golden gate), in fp16 against the verified tf32 frames by
        the bf16 rule (|g16 - v32| <= max(2 |v16 - v32|, 0.02 x 255) in
        u8); B 0, C one a frame; output MP/s of each pass of the verified
        and graph-exact streams, fp16 and tf32, all over the same window;
     d. cunet/art 2x noise 1 (``export_torch_cunet``) through the CLI's
        ``build`` and ``render`` of a 512 x 512 still: C one launch, the
        output against ``Upscaler.render`` of the artifact (golden gate)
 15. compiled programs (``engine/exe_cache.py``: captured CUDA graphs):
     a. the flagship (phase 5's frames) and art_scan TTA (12a's config, 8
        frames): a chunk through its program (eager first call, then a
        replay) byte-identical to the module called eagerly, and the
        frames streamed with eager modules and with captured programs in
        turns (eager, captured, captured, eager): byte-identical streams,
        equal launch counts, output MP/s of each pass;
     b. ``fuse_frame``: the 720p flagship frame as one program, within 1
        LSB of the chunked render (byte-identity printed), a replay
        identical and launching B 20 and C 1; the per-frame loop's output
        MP/s, fused and chunked in turns, beside phase 5's stream;
     c. graph-exact fp16 (phase 14's export) captured against eager, as a;
     d. the memory pool's bytes: each flagship chunk program, the 720p
        whole-frame program, and each further still size (512^2,
        384 x 640, 1080p) with its first call's seconds;
     e. the flagship's ``flops_per_frame`` at 720p: GFLOP per output MP
        beside XLA's 45.44, and phase 5's rate as a share of the dense
        bf16 peak;
     f. ``Upscaler.build`` of the flagship (b16, t256) cold (the kernel
        library compiled into an empty directory and loaded: another
        copy) and warm, its ready seconds by step: library, model and
        weights, first eager call, capture
 16. kernel G (HAT's window attention) against its plain twin at the
     hat4x-480p-stream cell's chunk, (16, 256, 256, 540) qkv, 6 heads of
     30, self with shift 0 and 8 and overlapping (24 x 24 keys), and at
     a rectangular (3, 48, 80) map: bf16 by phase 3's rule; at the chunk
     also as the main path gives it, qkv at the trunk's pitch (3 x 192,
     ``channels`` 180, NaN in the pads; ``_padded_case``): the same rule
     on the real channels, those byte-equal to the pitch-180 launch, the
     output pad zero (the reported max_abs_err is the chunk's); times
     at that chunk, at both pitches, beside the bound
     (``_hat_work``), the plain twin and SDPA with the bias and region
     mask as one float mask; the registers and resident
     CTAs of both instantiations; then hat/photo 4x streaming 720 x 480
     frames (6 tiles a frame, chunks of 16): every ``w2x.model`` span of
     the streamed frames a graph replay launching G 42 times (36 self, 6
     overlapping), all on the trunk's pitch (``padded_G`` 42)
 17. kernel H (cunet's conv epilogue) against its plain twin at the
     cunet2x-1080p-stream cell's largest maps, (16, 476, 476, 64) with
     the leaky ReLU and (16, 444, 444, 64) with it and the skip cropped
     by 16, bf16 and fp32: byte-equal, in place and into another tensor
     (max |d| 0); times beside the bytes bound, the plain twin and the
     torch ops it replaces (``epilogue_ops``, without the twin's copy
     into place); then cunet/art 2x streaming 4 1080p frames (seeded
     unit-scale weights): every ``w2x.model`` span a graph replay
     launching H 22 times
 18. kernel I (HAT's residual sums and their LayerNorm) against its plain
     twin at the hat4x-480p-stream cell's chunk, (16, 256, 256, 180) bf16,
     in its three variants (the norm alone, the add, the scaled add): y
     byte-equal, n within one bf16 ulp (beyond 2^-16 of the terms its
     last step sums, ``_bf16_ulps``), at pitch 180 and, as the main path
     gives it, at the trunk's pitch of 192 with the (180,) weight, s (B,
     192) and NaN in every input's pad (the same on the real channels,
     zeros in the pads of y and n); times beside the bytes bound
     (``_add_norm_work``), the plain twin and ``F.layer_norm`` alone (the
     op most of the twin's time goes to); the registers and resident CTAs
     of each; then hat/photo 4x on the benchmark's seeded weights
     (``benchmark_torch/lib/weights``) streaming 8 of its 720 x 480
     pictures: every ``w2x.model`` span a graph replay launching I 86
     times, all on rows of the trunk's pitch (``padded_I`` 86), and two
     outputs against the benchmark's plain float32
     reference within the cell's limits (``benchmark_torch/limits/
     hat4x-480p-stream.json``: mean and largest absolute byte difference)
 19. kernel J (DAT's channel attention) and kernel G on DAT's split
     windows (heads 0-2 in 8 x 32, 3-5 in 32 x 8; shift 0 and (4, 16))
     against their plain twins at the dat4x-480p-stream cell's chunk,
     (16, 256, 256, 540) bf16, by phase 16's rule, J also byte-equal over
     two calls, and both at the trunk's pitch as phase 16's G (3 x 192,
     ``channels`` 180, NaN pads); times at both pitches beside the bytes
     bound (0.4507 ms), the plain twins
     and, for J, DAT's own torch chain (``_channel_chain``); then
     dat/photo 4x on the benchmark's seeded weights streaming 8 of its
     720 x 480 pictures as phase 18 does (``_cell_stream``): every
     ``w2x.model`` span a graph replay with launches_G 18, rect_G 18,
     launches_J 18 and launches_I 74, each of them also counted as
     padded (the trunk's pitch), and two outputs against the
     benchmark's plain float32 reference within the cell's limits
 20. kernel K (MambaIR's four-direction selective scan) against its plain
     twin at the mambair4x-480p-stream cell's chunk, u (16, 256, 256, 360)
     bf16, R 12, N 16 (``_scan_inputs``: delta about 0.001 to 0.1, A
     from -1 to -16): each direction's fp32 output (the scratch's four
     planes) within 1e-4 of its largest value at every token (the state
     carried across every 32-token stage and every row), the gated bf16
     map LN(y) SiLU(z) within twice the bf16 rounding of the twin's fp32
     result, the same bytes on a second call; its time beside its bound
     (the state updates at
     ``UPDATES_S``) and the twin's one call; then mambair/photo 4x on the
     benchmark's seeded weights streaming 8 of its 720 x 480 pictures as
     phase 18 does: every ``w2x.model`` span a graph replay with
     launches_K 36, launches_I 74 (skip_I 66, padded_I 74), and two
     outputs against the benchmark's plain float32 reference within the
     cell's limits; phase 18 also runs kernel I's skip and skip gate
     (MambaIR's residuals, the per-channel weight k) against the twin

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
are set to 0 just before phases 5, 7 and 9, phase 6a's render, phase 7's
stream, E's API call of phase 8, the probe's run of phase 10 and each
render or stream of phases 11 and 12, and read just after each (phase 5:
kernels B and C; phase 6a: fp32 B and C; phase 7: A; phase 8: E; phase
9: D, B and C; phase 10: F; phase 11: C; phase 12: B and C), and around
each CLI call of phases 13 and 14 and each stream of phase 14 (B and C,
equal to the counts its streams and renders imply); each kernel must
have launched in its run. The ``kernels`` line counts A in phase 7's
stream, and B's and C's rows carry the counts of phases 11-14 as
``launches_*`` keys (B's fp32 count of phase 6a as
``fp32_launches_tf32_frame``; the fp32 kernels' times, bounds and
yardsticks as ``fp32_*`` keys). Any failed check
raises, so the script exits non-zero; the last line is the JSON device
record, printed only when every phase passed. Without a CUDA device it
exits non-zero before printing any result. Kernel wrappers count
launches in Python; a graph replay adds the launches its capture
recorded (``exe_cache``), so the counts of captured paths are those of
the kernels the device ran.
"""

from __future__ import annotations

import argparse
import contextlib
import io
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


def _block_chain(torch, params, c, nh, dtype=None):
    """Kernel B's block as a chain of library calls (F.layer_norm,
    F.linear, SDPA, F.gelu) in ``dtype`` (bf16 unless given; fp32 runs
    with TF32 off, as this script sets it): a yardstick of what PyTorch's
    own kernels take for the block. The port never calls it."""
    import torch.nn.functional as F

    dtype = dtype or torch.bfloat16
    w = {k: (v.t() if k.endswith("_kernel") else v).to(dtype)
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
                    mask32 = _sdpa_mask(torch, bias, flags, 4, torch.float32)
                    if name == "A":
                        km = _median_ms(lambda: kern(*a16, **kw))
                        q, k, v = (x16.view(bw, 64, 3, nh, 32)
                                   .permute(2, 0, 3, 1, 4))
                        lm = _median_ms(
                            lambda: F.scaled_dot_product_attention(
                                q, k, v, attn_mask=mask))
                        q32, k32_, v32 = (inp.view(bw, 64, 3, nh, 32)
                                          .permute(2, 0, 3, 1, 4))
                        lm32 = _median_ms(
                            lambda: F.scaled_dot_product_attention(
                                q32, k32_, v32, attn_mask=mask32))
                        work, work32 = (_attention_work(bw, nh, 2),
                                        _attention_work(bw, nh, 4))
                        extra = {"library_ms": lm, "fp32_library_ms": lm32}
                        label = (f"SDPA with a float mask {lm:.3f} ms "
                                 f"(kernel / SDPA {km / lm:.2f}x); "
                                 + _occupancy_label(wa.tc_occupancy()))
                        label32 = (f"SDPA fp32 with a float mask {lm32:.3f} "
                                   f"ms; " + _occupancy_label(
                                       wa.f32_occupancy(), "fp32 kernel"))
                    else:
                        km = _median_ms(lambda: sb.swin_block_prepared(
                            x16, ops16, flags, shift=4))
                        chain = _block_chain(torch, params, c, nh)
                        lm = _median_ms(lambda: chain(x16, mask))
                        chain32 = _block_chain(torch, params, c, nh,
                                               torch.float32)
                        lm32 = _median_ms(lambda: chain32(inp, mask32))
                        work, work32 = (_block_work(bw, c, nh, 2),
                                        _block_work(bw, c, nh, 4))
                        extra = {"library_ms": None, "library_chain_ms": lm,
                                 "fp32_library_ms": None,
                                 "fp32_library_chain_ms": lm32}
                        label = (f"yardstick, bf16 library chain "
                                 f"(layer_norm, linear, SDPA, gelu; never "
                                 f"called by the port) {lm:.3f} ms")
                        label32 = (f"yardstick, fp32 library chain {lm32:.3f}"
                                   f" ms; " + _occupancy_label(
                                       sb.f32_occupancy(c), "fp32 kernel"))
                    km32 = _median_ms(
                        (lambda: sb.swin_block_prepared(inp, ops32, flags,
                                                        shift=4))
                        if name == "B" else (lambda: kern(*args, **kw)))
                    pm = _median_ms(lambda: plain(*a16, **kw))
                    pm32 = _median_ms(lambda: plain(*args, **kw))
                    bms, by = _bound(*work)
                    b32, by32 = _bound(*work32, tc_rate=FP32_FLOPS)
                    times[(name, c)] = dict(
                        ms=km, plain_ms=pm, bound_ms=bms, bound_by=by,
                        fp32_ms=km32, fp32_plain_ms=pm32, fp32_bound_ms=b32,
                        fp32_bound_by=by32, **extra)
                    print(f"  kernel {name} bf16 BW={bw} C={c}: kernel "
                          f"{km:.3f} ms (bound {bms:.4f} ms by {by}, "
                          f"{100 * bms / km:.1f}% of it), plain {pm:.3f} "
                          f"ms; {label} (median, CUDA events)", flush=True)
                    print(f"  kernel {name} fp32 BW={bw} C={c}: kernel "
                          f"{km32:.3f} ms (bound {b32:.4f} ms by {by32} at "
                          f"3.35 TB/s and 67 TFLOP/s, {100 * b32 / km32:.1f}%"
                          f" of it), plain {pm32:.3f} ms; {label32} "
                          f"(median, CUDA events, TF32 off)", flush=True)
    for name in ("A", "B"):
        report[name] = dict(times[(name, 96)], max_abs_err=worst[name], **{
            f"c192_{k}": v for k, v in times[(name, 192)].items()})
    return times


def _occupancy_label(occ, kind="tensor-core kernel"):
    spill = (f" ({occ['local_bytes']} local bytes)" if "local_bytes" in occ
             else "")
    return (f"{kind}: {occ['registers']} registers a thread{spill}, "
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
    from waifu2x_tensorrt_tpu_torch import ops

    return ops.kernels()


def _upscaler(family, scale, noise, precision, tile, batch, tta=False,
              models_dir=None, device="cuda:0", fused_block=None,
              **load_kw):
    """An ``Upscaler`` loaded through its public ``load``: weights from
    ``models_dir`` when given, else the seeded random init (seed 0)."""
    from waifu2x_tensorrt_tpu_torch.engine.config import RenderConfig
    from waifu2x_tensorrt_tpu_torch.engine.upscaler import Upscaler

    up = Upscaler(models_dir=models_dir or "models",
                  allow_random_init=models_dir is None, device=device)
    cfg = RenderConfig(precision=precision, batch_size=batch, height=tile,
                       width=tile, scaling=scale, overlap=(1 / 16, 1 / 16),
                       tta=tta)
    up.load(family, scale, noise, cfg, fused_block=fused_block, **load_kw)
    return up


def _load(torch, precision, fused_block=None, batch=16):
    """The flagship cell's ``Upscaler`` (swin_unet/art 4x noise 3, tile
    256), seeded random weights."""
    return _upscaler("swin_unet/art", 4, 3, precision, 256, batch,
                     fused_block=fused_block)


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
    counters["B"].direct_launches = 0
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
    direct5 = counters["B"].direct_launches
    if len(outs) != 10 or any(tuple(o.shape) != (2880, 5120, 3)
                              for o in outs):
        raise AssertionError("stream returned wrong outputs")
    fps = 10 / dt
    mps = fps * 2880 * 5120 / 1e6
    print(f"  phase 5 stream: 10 frames in {dt:.3f} s = {fps:.3f} frames/s, "
          f"{mps:.2f} output MP/s on {smi}", flush=True)
    # B: 10 a chunk. The render's chunks [16, 2] (first calls: eager,
    # then captured), the warm cycle's 9 chunks of 16, the warm's one run
    # at each tail a flush can meet (2, 4, ..., 14: 7 programs, so that no
    # capture falls inside the stream) and the stream's 11 chunks of 16
    # and its tail of 4 (replays); C: one a frame, 1 + 8 + 10
    want = {"B": 10 * (2 + 9 + 7 + 12), "C": 19}
    print(f"  phase 5 launch counts (main path, fused_block=True): {n5}; "
          f"B 10 a chunk over the render's 2, the warm cycle's 9, the "
          f"warm's 7 tail programs and the stream's 12 chunks, C one a "
          f"frame: expected {want}", flush=True)
    if {k: n5[k] for k in want} != want or any(n5[k] for k in "ADEF"):
        raise AssertionError(f"phase 5 did not launch kernels B and C "
                             f"alone, as expected: {n5}")
    print(f"  phase 5 kernel B launches on (B, H, W, C) activations: "
          f"{direct5} of {n5['B']}", flush=True)
    if direct5 != n5["B"]:
        raise AssertionError("phase 5 launched kernel B on window copies")
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
    shift=, ws=)`` on its (B, H, W, C) activation in place of kernel B,
    and pipelines made there finalize with the plain scan in place of
    kernel C when ``plain_finalize`` is set."""
    import waifu2x_tensorrt_tpu_torch.engine.renderer as renderer
    import waifu2x_tensorrt_tpu_torch.models.swin_unet as swin
    from waifu2x_tensorrt_tpu_torch.ops.finalize_epilogue import finalize_scan

    saved = (swin.swin_block_bhwc, renderer.make_finalize_epilogue)
    swin.swin_block_bhwc = fn
    if plain_finalize:
        renderer.make_finalize_epilogue = (
            lambda plan, device: lambda *outs: finalize_scan(outs, plan))
    try:
        yield
    finally:
        swin.swin_block_bhwc, renderer.make_finalize_epilogue = saved


def _plain_block(x, operands, **kw):
    """Kernel B's plain twin on a block's activation and prepared
    operands."""
    from waifu2x_tensorrt_tpu_torch.ops.swin_block import (
        swin_block_bhwc_plain,
    )

    return swin_block_bhwc_plain(x, operands, **kw)


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
    up = _load(torch, Precision.TF32)
    counters = _zero_counters()
    got = up.render(frame)  # two chunks (16 + 2 tiles): fp32 B 20, C 1
    n6 = {name: f.launches for name, f in counters.items()}
    with _swin_block_as(_plain_block, plain_finalize=True):
        want = _load(torch, Precision.TF32).render(frame)
    ok, dmax, frac = _golden_gate(got, want)
    print(f"  phase 6a tf32 frame, kernel path vs all-plain path: max "
          f"{dmax} (tol 2), changed fraction {frac:.2e} (tol 1e-04), output "
          f"mean {got.mean():.3f} std {got.std():.3f}; launch counts of the "
          f"kernel path's render {n6}: {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("tf32 golden gate failed")
    if n6 != {"A": 0, "B": 20, "C": 1, "D": 0, "E": 0, "F": 0, "G": 0,
              "H": 0, "I": 0, "J": 0}:
        raise AssertionError(f"phase 6a: not 10 launches of fp32 B a chunk "
                             f"and one of C: {n6}")

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
        with _swin_block_as(_plain_block):
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
    return n6


def phase_kernels_de(torch, report):
    """Phase 8: kernels D and E against their plain twins; returns the
    launch counts of E's one call through the ops package API."""
    from waifu2x_tensorrt_tpu_torch import ops
    from waifu2x_tensorrt_tpu_torch.ops.kernel_math import pixel_shuffle
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
            pix = pixel_shuffle(torch.clamp(z, 0.0, 1.0), r).contiguous()
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
                sdpa = torch.nn.functional.scaled_dot_product_attention
                km = _median_ms(lambda: wa.fused_window_attention(
                    *a16, shift=4))
                km32 = _median_ms(lambda: wa.fused_window_attention(
                    *args, shift=4))
                pm = _median_ms(lambda: wa.window_attention_plain(
                    *a16, shift=4))
                pm32 = _median_ms(lambda: wa.window_attention_plain(
                    *args, shift=4))
                mask = _sdpa_mask(torch, bias, flags, 4, torch.bfloat16)
                lm = _median_ms(lambda: sdpa(*a16[:3], attn_mask=mask))
                mask32 = _sdpa_mask(torch, bias, flags, 4, torch.float32)
                lm32 = _median_ms(lambda: sdpa(q, k, v, attn_mask=mask32))
                bms, by = _bound(*_attention_work(bw, nh, 2))
                b32, by32 = _bound(*_attention_work(bw, nh, 4),
                                   tc_rate=FP32_FLOPS)
                print(f"  kernel E bf16 BW={bw} nh={nh}: kernel {km:.3f} "
                      f"ms (bound {bms:.4f} ms by {by}, "
                      f"{100 * bms / km:.1f}% of it), plain {pm:.3f} ms, "
                      f"SDPA with a float mask {lm:.3f} ms (kernel / SDPA "
                      f"{km / lm:.2f}x); "
                      + _occupancy_label(wa.tc_occupancy())
                      + " (median, CUDA events)", flush=True)
                print(f"  kernel E fp32 BW={bw} nh={nh}: kernel {km32:.3f} "
                      f"ms (bound {b32:.4f} ms by {by32}, "
                      f"{100 * b32 / km32:.1f}% of it), plain {pm32:.3f} ms, "
                      f"SDPA fp32 with a float mask {lm32:.3f} ms (kernel / "
                      f"SDPA {km32 / lm32:.2f}x) (median, CUDA events, TF32 "
                      f"off)", flush=True)
                report["E"] = {"ms": km, "plain_ms": pm, "bound_ms": bms,
                               "bound_by": by, "library_ms": lm,
                               "fp32_ms": km32, "fp32_plain_ms": pm32,
                               "fp32_bound_ms": b32, "fp32_bound_by": by32,
                               "fp32_library_ms": lm32}
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


def _cunet_weights(scale, noise, seed):
    """A models directory under build/ holding seeded unit-scale cunet
    weights (``_unit_scale_params``: kernels N(0, 1/fan_in), biases
    N(0, 0.1)) as the ``.npz`` file ``Upscaler.load`` reads. The seed-0
    init keeps cunet's frame within 2 LSB of black; these weights give it
    content."""
    import numpy as np

    from waifu2x_tensorrt_tpu_torch.models import registry

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_models")
    module, _ = registry.create_model("cunet/art", scale, noise)
    path = registry.weights_path(root, "cunet/art", scale, noise)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **_unit_scale_params(module, seed))
    return root


def _stream_run(torch, up, frames):
    """Warm a stream of the frames' geometry, zero the counters, stream
    the frames; returns (outputs, seconds, launch counts)."""
    stream = up.open_stream(frames[0].shape[:2])
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
    return outs, dt, {k: f.launches for k, f in counters.items()}


def _check_stream(label, up, outs, frames, k, out_hw, bf16_rule=False):
    """Every streamed output has the frame's output shape, and frame k's
    equals its single-frame render within the phase-5 gate (max 2 LSB, at
    most 1e-3 of the values changed), or with ``bf16_rule`` within the bf16
    rule's floor, 0.02 x 255 in u8: with weights that give the frame its
    full range, the other bf16 convolution algorithms cuDNN picks for the
    render's remainder chunk move many values by an LSB or two, while a
    misplaced tile moves whole regions by far more."""
    if len(outs) != len(frames) or any(tuple(o.shape) != (*out_hw, 3)
                                       for o in outs):
        raise AssertionError(f"{label} stream returned wrong outputs")
    got, want = outs[k].cpu().numpy(), up.render(frames[k])
    ok, dmax, frac = _golden_gate(got, want, max_frac=1e-3)
    tol = "2, changed fraction tol 1e-03"
    if bf16_rule:
        ok, tol = dmax <= 0.02 * 255, "0.02 x 255"
    print(f"  {label} streamed frame {k} vs its single-frame render: max "
          f"{dmax} (tol {tol}), changed fraction {frac:.2e}: "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{label}: streamed frame differs from its "
                             "render")


def phase_cunet(torch, smi, report):
    """Phase 11: cunet/art at full width (the upstream architecture) on
    512 x 512 stills and 1080p frames; returns kernel C's launch counts
    of (a)-(d)."""
    import numpy as np

    from waifu2x_tensorrt_tpu_torch.engine.config import Precision

    rng = np.random.default_rng(11)
    frame = rng.integers(0, 256, (512, 512, 3), np.uint8)
    root = _cunet_weights(2, 1, seed=11)
    counts = {}

    # a. tile 256, batch 4, bf16 (bench.py config 1b): one render, one
    # launch of kernel C; the bf16 frame against the card's fp32 frame (TF32
    # off), the card's fp32 frame against the port's CPU fp32 render
    up16 = _upscaler("cunet/art", 2, 1, Precision.FP16, 256, 4,
                     models_dir=root)
    counters = _zero_counters()
    out16 = up16.render(frame)
    n = {k: f.launches for k, f in counters.items()}
    counts["a"] = n["C"]
    out32 = _upscaler("cunet/art", 2, 1, Precision.TF32, 256, 4,
                      models_dir=root).render(frame)
    t0 = time.perf_counter()
    cpu32 = _upscaler("cunet/art", 2, 1, Precision.TF32, 256, 4,
                      models_dir=root, device="cpu").render(frame)
    cpu_s = time.perf_counter() - t0
    e16 = int(np.abs(out16.astype(int) - out32.astype(int)).max())
    ok32, dmax, frac = _golden_gate(out32, cpu32)
    print(f"  phase 11a cunet 2x t256 b4 bf16 render 512^2 -> {out16.shape} "
          f"(mean {out16.mean():.3f}, std {out16.std():.3f}): launch counts "
          f"{n}; bf16 vs card fp32 max {e16} LSB (tol 0.02 x 255); card fp32 "
          f"vs CPU fp32 ({cpu_s:.1f} s) max {dmax} (tol 2), changed "
          f"fraction {frac:.2e} (tol 1e-04): "
          f"{'ok' if ok32 and e16 <= 0.02 * 255 else 'FAIL'}", flush=True)
    if n["C"] != 1 or any(n[k] for k in "ABDEF"):
        raise AssertionError(f"phase 11a: not one launch of kernel C: {n}")
    if out16.shape != (1024, 1024, 3) or e16 > 0.02 * 255 or not ok32:
        raise AssertionError("phase 11a: the cunet frame disagrees")

    # b. the whole frame as one tile (548 x 548 in, 1024 x 1024 out),
    # batch 16, bf16, 32 streamed frames (config 1c)
    up = _upscaler("cunet/art", 2, 1, Precision.FP16, 0, 16,
                   models_dir=root)
    frames = [rng.integers(0, 256, (512, 512, 3), np.uint8)
              for _ in range(32)]
    outs, dt, n = _stream_run(torch, up, frames)
    counts["b"] = n["C"]
    mps_b = len(frames) * 1024 * 1024 / dt / 1e6
    print(f"  phase 11b cunet 2x whole-frame b16 bf16 stream: 32 frames of "
          f"512^2 in {dt:.3f} s = {mps_b:.2f} output MP/s on {smi}; launch "
          f"counts {n}", flush=True)
    if n["C"] != len(frames):
        raise AssertionError(f"phase 11b: not one launch of C a frame: {n}")
    _check_stream("phase 11b", up, outs, frames, 5, (1024, 1024),
                  bf16_rule=True)

    # c. 1080p, tile 256, batch 16, bf16, 8 streamed frames (config 1d)
    up = _upscaler("cunet/art", 2, 1, Precision.FP16, 256, 16,
                   models_dir=root)
    frames = [rng.integers(0, 256, (1080, 1920, 3), np.uint8)
              for _ in range(8)]
    outs, dt, n = _stream_run(torch, up, frames)
    counts["c"] = n["C"]
    tiles = up._pipeline.get((1080, 1920))[2].tile_count
    mps_c = len(frames) * 2160 * 3840 / dt / 1e6
    print(f"  phase 11c cunet 2x 1080p t256 b16 bf16 stream ({tiles} tiles "
          f"a frame): 8 frames in {dt:.3f} s = {mps_c:.2f} output MP/s on "
          f"{smi}; launch counts {n}", flush=True)
    if n["C"] != len(frames):
        raise AssertionError(f"phase 11c: not one launch of C a frame: {n}")
    _check_stream("phase 11c", up, outs, frames, 3, (2160, 3840),
                  bf16_rule=True)

    # d. noise-only scale-1 CUNet, tile 256
    root1 = _cunet_weights(1, 1, seed=12)
    counters = _zero_counters()
    o16 = _upscaler("cunet/art", 1, 1, Precision.FP16, 256, 4,
                    models_dir=root1).render(frame)
    n = {k: f.launches for k, f in counters.items()}
    counts["d"] = n["C"]
    o32 = _upscaler("cunet/art", 1, 1, Precision.TF32, 256, 4,
                    models_dir=root1).render(frame)
    e16 = int(np.abs(o16.astype(int) - o32.astype(int)).max())
    print(f"  phase 11d cunet 1x t256 b4 bf16 render 512^2 -> {o16.shape} "
          f"(mean {o16.mean():.3f}): launch counts {n}; bf16 vs fp32 max "
          f"{e16} LSB (tol 0.02 x 255)", flush=True)
    if o16.shape != (512, 512, 3) or n["C"] != 1 or e16 > 0.02 * 255:
        raise AssertionError("phase 11d: the scale-1 cunet frame disagrees")
    report["cunet"] = {"whole_frame_b16_output_mp_per_s": mps_b,
                       "t256_1080p_b16_output_mp_per_s": mps_c}
    return counts


def phase_tta_whole_frame(torch, smi, report):
    """Phase 12: 8-way TTA and whole-frame swin at full width; returns the
    launch counts of B and C in (a)'s stream, (b) and (c)."""
    import numpy as np

    from waifu2x_tensorrt_tpu_torch.engine.config import Precision
    from waifu2x_tensorrt_tpu_torch.tiling import (
        DIHEDRAL_SIZE,
        dihedral_apply,
        dihedral_inverse,
    )

    rng = np.random.default_rng(12)
    counts = {}

    # a. swin_unet/art_scan 4x noise 3, tile 128, batch 8, bf16, TTA
    # (bench.py config 3): one 512^2 frame through B and C; in fp32 (as
    # phase 6a) the same frame through B and C against the all-plain path
    frame = rng.integers(0, 256, (512, 512, 3), np.uint8)
    args = ("swin_unet/art_scan", 4, 3)
    up = _upscaler(*args, Precision.FP16, 128, 8, tta=True)
    counters = _zero_counters()
    out = up.render(frame)
    n = {k: f.launches for k, f in counters.items()}
    print(f"  phase 12a art_scan 4x t128 b8 bf16 TTA render 512^2 -> "
          f"{out.shape}: launch counts {n}", flush=True)
    if out.shape != (2048, 2048, 3) or n["B"] <= 0 or n["C"] != 1:
        raise AssertionError(f"phase 12a: render did not run B and C: {n}")
    got = _upscaler(*args, Precision.TF32, 128, 8, tta=True).render(frame)
    with _swin_block_as(_plain_block, plain_finalize=True):
        want = _upscaler(*args, Precision.TF32, 128, 8,
                         tta=True).render(frame)
    ok, dmax, frac = _golden_gate(got, want)
    print(f"  phase 12a tf32 TTA frame, kernel path vs all-plain path: max "
          f"{dmax} (tol 2), changed fraction {frac:.2e} (tol 1e-04), mean "
          f"{got.mean():.3f}: {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("phase 12a: TTA golden gate failed")
    frames = [rng.integers(0, 256, (512, 512, 3), np.uint8)
              for _ in range(8)]
    outs, dt, n = _stream_run(torch, up, frames)
    counts["a"] = n
    steps = 8 * up._pipeline.get((512, 512))[2].tile_count
    mps = len(frames) * 2048 * 2048 / dt / 1e6
    print(f"  phase 12a TTA stream: 8 frames ({steps} steps a frame) in "
          f"{dt:.3f} s = {mps:.2f} output MP/s on {smi}; launch counts {n}",
          flush=True)
    if n["B"] <= 0 or n["C"] != len(frames):
        raise AssertionError(f"phase 12a stream did not run B and C: {n}")
    _check_stream("phase 12a", up, outs, frames, 2, (2048, 2048))
    report["tta"] = {"output_mp_per_s": mps, "seconds_8_frames": dt}

    # b. rect TTA: whole frame of a non-square frame, swin 2x (two tile
    # orientations a frame, so no stream)
    rect = rng.integers(0, 256, (136, 200, 3), np.uint8)
    up = _upscaler("swin_unet/art", 2, -1, Precision.FP16, 0, 4, tta=True)
    counters = _zero_counters()
    out = up.render(rect)
    n = {k: f.launches for k, f in counters.items()}
    counts["b"] = n
    stream = up.open_stream((136, 200))
    print(f"  phase 12b rect-TTA whole-frame render 136x200 -> {out.shape}: "
          f"launch counts {n}; open_stream -> {stream}", flush=True)
    if (out.shape != (272, 400, 3) or n["B"] <= 0 or n["C"] != 1
            or stream is not None):
        raise AssertionError("phase 12b: rect-TTA render or stream refusal "
                             "failed")

    # c. whole frame (tile 0) swin 2x of 200x136, against the plain path
    tall = rng.integers(0, 256, (200, 136, 3), np.uint8)
    counters = _zero_counters()
    got = _upscaler("swin_unet/art", 2, -1, Precision.TF32, 0,
                    4).render(tall)
    n = {k: f.launches for k, f in counters.items()}
    counts["c"] = n
    with _swin_block_as(_plain_block, plain_finalize=True):
        want = _upscaler("swin_unet/art", 2, -1, Precision.TF32, 0,
                         4).render(tall)
    ok, dmax, frac = _golden_gate(got, want)
    print(f"  phase 12c whole-frame tf32 render 200x136 -> {got.shape}, "
          f"launch counts {n}; vs all-plain path: max {dmax} (tol 2), "
          f"changed fraction {frac:.2e} (tol 1e-04): "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if got.shape != (400, 272, 3) or n["B"] <= 0 or n["C"] != 1 or not ok:
        raise AssertionError("phase 12c: whole-frame render disagrees")

    # d. the dihedral transforms on card tensors: the round trip is exact
    # and each transform moves the bytes the CPU's does
    for dtype in (torch.bfloat16, torch.float32):
        for shape in ((8, 64, 64, 3), (8, 48, 80, 3)):
            x = torch.randn(shape, generator=torch.Generator().manual_seed(0)
                            ).to(dtype)
            xc = x.cuda()
            for i in range(DIHEDRAL_SIZE):
                fwd = dihedral_apply(xc, i)
                if not (torch.equal(dihedral_inverse(fwd, i), xc)
                        and torch.equal(fwd.cpu(), dihedral_apply(x, i))):
                    raise AssertionError(f"phase 12d: dihedral {i} on "
                                         f"{dtype} {shape} is not exact")
    print("  phase 12d dihedral apply/inverse on card tensors: exact round "
          "trip, equal to the CPU's, 8 transforms x bf16/fp32 x square/rect",
          flush=True)
    return counts


def _expected_launches(up, runs):
    """(B, C) launches of the CLI's streams over ``runs``, a list of
    ((h, w), frames) of same-size frames, each run one stream: a warm cycle
    (``TileStream.warm``: the fewest frames whose tiles fill whole chunks,
    then one model run at each tail a flush can meet) and the run's chunks
    (the flush's remainder included), 10 launches of B a chunk (one a Swin
    block) and one of C a frame."""
    import math

    chunk = up._pipeline.config.batch_size
    b = c = 0
    for hw, n in runs:
        t = up._pipeline.get(hw)[2].tile_count
        warm = chunk // math.gcd(t, chunk)
        tails = warm - 1  # the warm's run at each tail a flush can meet
        b += 10 * (warm * t // chunk + tails + -(-n * t // chunk))
        c += warm + n
    return b, c


@contextlib.contextmanager
def _video_shims(root):
    """The ffmpeg / ffprobe stand-ins first on PATH and the native
    framepipe's reader and writer counted, for the ``with`` block only."""
    from waifu2x_tensorrt_tpu_torch.io import native_pipe

    frames = {"read": 0, "written": 0}

    class Reader(native_pipe.NativeFrameReader):
        def read(self, copy=True):
            f = super().read(copy)
            frames["read"] += f is not None
            return f

    class Writer(native_pipe.NativeFrameWriter):
        def write(self, frame):
            super().write(frame)
            frames["written"] += 1

    saved = (os.environ.get("PATH", ""), os.environ.pop(
        "W2X_NO_NATIVE_PIPE", None), native_pipe.NativeFrameReader,
        native_pipe.NativeFrameWriter)
    os.environ["PATH"] = (f"{write_ffmpeg_shims(root / 'bin')}{os.pathsep}"
                          f"{saved[0]}")
    native_pipe.NativeFrameReader, native_pipe.NativeFrameWriter = (
        Reader, Writer)
    try:
        yield frames
    finally:
        os.environ["PATH"] = saved[0]
        if saved[1] is not None:
            os.environ["W2X_NO_NATIVE_PIPE"] = saved[1]
        native_pipe.NativeFrameReader, native_pipe.NativeFrameWriter = \
            saved[2:]


def _cli(torch, label, argv):
    """One call of the port's CLI (``cli.main``) with the launch counters
    set to 0 just before it; returns (seconds, launch counts). Its console
    goes to a buffer, printed if the call fails."""
    from waifu2x_tensorrt_tpu_torch import cli

    torch.cuda.synchronize()
    counters = _zero_counters()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = {k: f.launches for k, f in counters.items()}
    if rc != 0:
        print(buf.getvalue()[-4000:], file=sys.stderr)
        raise AssertionError(f"{label}: the CLI exited {rc}")
    return dt, n


def _check_launches(label, n, want):
    print(f"  {label} launch counts {n}; B {n['B']} = 10 a chunk, C "
          f"{n['C']} = one a frame, warm cycles included: (B, C) expected "
          f"{want}", flush=True)
    if (n["B"], n["C"]) != want or any(n[k] for k in "ADEF"):
        raise AssertionError(f"{label}: launch counts {n}, expected {want}")


def phase_cli(torch, smi, report):
    """Phase 13: the port's CLI (``cli.main``) on the card, with the ffmpeg
    / ffprobe stand-ins first on PATH (raw rgb24 clips over pipes through
    the native framepipe): (a) a 720p clip, swin_unet/photo 2x (bench.py
    config4), (b) the clip in segments, then resumed, (c) a folder of
    stills through the cross-file image stream, swin_unet/art 4x noise 3
    (config6), (d) an RGBA still with ``--alpha auto``. Returns the launch
    counts of each CLI call."""
    import shutil
    from pathlib import Path

    import numpy as np

    from waifu2x_tensorrt_tpu_torch.engine.config import Precision
    from waifu2x_tensorrt_tpu_torch.io.image import (
        fill_transparent,
        read_image,
        write_image,
    )
    from waifu2x_tensorrt_tpu_torch.utils import native_build

    root = Path(__file__).resolve().parent / "build" / "chip_smoke_cli"
    shutil.rmtree(root, ignore_errors=True)
    (root / "in").mkdir(parents=True)
    rng = np.random.default_rng(13)
    counts = {}

    def argv(model, scale, noise, precision, src, out, *extra):
        (root / out).mkdir(exist_ok=True)
        return ["--model", model, "--scale", str(scale), "--noise",
                str(noise), "--batchSize", "16", "--tileSize", "256",
                "--precision", precision, "--models-dir",
                str(root / "no_weights"), "--allow-random-weights",
                "render", "-i", str(src), "-o", str(root / out), *extra]

    # a. video (bench.py config4): swin_unet/photo 2x, t256, b16, bf16
    clip = rng.integers(0, 256, (8, 720, 1280, 3), np.uint8)
    src = write_raw_clip(root / "in" / "clip.mp4", clip)
    name = "clip(swin_unet_photo)(scale2).mp4"
    photo = ("swin_unet/photo", 2, -1)
    with _video_shims(root) as piped:
        dt, n = _cli(torch, "phase 13a",
                     argv(*photo, "fp16", src, "a_bf16"))
        lib = native_build.load_framepipe()
        if lib is None or piped != {"read": 8, "written": 8}:
            raise AssertionError(f"phase 13a: the native framepipe was not "
                                 f"used: library {lib}, frames {piped}")
        out_a = read_raw_clip(root / "a_bf16" / name, 1440, 2560)
        fps = len(clip) / dt
        mps = fps * 1440 * 2560 / 1e6
        print(f"  phase 13a CLI video, photo 2x t256 b16 bf16, 8 frames of "
              f"720p through the native framepipe ({Path(lib._name).name}, "
              f"{piped['read']} frames read, {piped['written']} written): "
              f"whole CLI call {dt:.3f} s = {fps:.3f} frames/s, {mps:.2f} "
              f"output MP/s (includes the shim's pipes, the engine's load "
              f"and its warm cycle); phase 5's streamed rate in this call "
              f"{report['stream']['output_mp_per_s']:.2f} output MP/s, on "
              f"{smi}", flush=True)
        up = _upscaler(*photo, Precision.FP16, 256, 16)
        _check_launches("phase 13a", n,
                        _expected_launches(up, [((720, 1280), 8)]))
        counts["video"] = n
        if out_a.shape != (8, 1440, 2560, 3):
            raise AssertionError(f"phase 13a: output {out_a.shape}")
        worst = (0, 0.0)
        for i, frame in enumerate(clip):
            ok, dmax, frac = _golden_gate(out_a[i], up.render(frame),
                                          max_frac=1e-3)
            worst = max(worst, (dmax, frac))
            if not ok:
                raise AssertionError(f"phase 13a: frame {i} differs from its "
                                     f"render: max {dmax}, changed {frac}")
        print(f"  phase 13a each output frame vs Upscaler.render of its "
              f"input: worst max {worst[0]} (tol 2), changed fraction "
              f"{worst[1]:.2e} (tol 1e-03), mean {out_a.mean():.3f}: ok",
              flush=True)

        # b. the clip in segments of 3 frames (a stream each), stitched;
        # then --resume renders nothing. bf16, and fp32 (--precision tf32)
        seg = ("--segment-frames", "3")
        dt, n = _cli(torch, "phase 13b",
                     argv(*photo, "fp16", src, "b_bf16", *seg))
        _check_launches("phase 13b segments of 3", n, _expected_launches(
            up, [((720, 1280), 3), ((720, 1280), 3), ((720, 1280), 2)]))
        counts["video_segmented"] = n
        _, n = _cli(torch, "phase 13b resume",
                    argv(*photo, "fp16", src, "b_bf16", *seg, "--resume"))
        if any(n.values()):
            raise AssertionError(f"phase 13b: --resume rendered: {n}")
        counts["video_resume"] = n
        out_b = read_raw_clip(root / "b_bf16" / name, 1440, 2560)
        ok, dmax, frac = _golden_gate(out_b, out_a)
        same16 = np.array_equal(out_b, out_a)
        _cli(torch, "phase 13b fp32", argv(*photo, "tf32", src, "a_fp32"))
        _cli(torch, "phase 13b fp32 segments",
             argv(*photo, "tf32", src, "b_fp32", *seg))
        same32 = (root / "a_fp32" / name).read_bytes() == \
            (root / "b_fp32" / name).read_bytes()
        holds = ("byte-identical in fp32 and in bf16" if same16 and same32
                 else f"fp32 {'byte-identical' if same32 else 'DIFFERS'}; "
                      f"bf16 within the golden gate, max {dmax} (tol 2), "
                      f"changed fraction {frac:.2e} (tol 1e-04)")
        print(f"  phase 13b --segment-frames 3 ({dt:.3f} s), stitched vs "
              f"13a's whole clip: {holds}; --resume rendered nothing "
              f"({n})", flush=True)
        if not (same32 and (same16 or ok)):
            raise AssertionError("phase 13b: the stitched clip differs")

    # c. image folder (bench.py config6): swin_unet/art 4x noise 3, t256,
    # b16, bf16; 8 stills of 512^2 and, in the middle, one of 384 x 640:
    # three runs through the cross-file image stream
    art = ("swin_unet/art", 4, 3)
    folder = root / "in" / "stills"
    folder.mkdir()
    stills = {f"still_{i}": rng.integers(0, 256, (512, 512, 3), np.uint8)
              for i in range(8)}
    stills["still_3b"] = rng.integers(0, 256, (384, 640, 3), np.uint8)
    for stem, img in stills.items():
        write_image(folder / f"{stem}.png", img)
    report_path = root / "c_metrics.json"
    dt, n = _cli(torch, "phase 13c", argv(
        *art, "fp16", folder, "c", "--metrics-json", str(report_path)))
    up = _upscaler(*art, Precision.FP16, 256, 16)
    _check_launches("phase 13c", n, _expected_launches(up, [
        ((512, 512), 4), ((384, 640), 1), ((512, 512), 4)]))
    counts["image_dir"] = n
    metrics = json.loads(report_path.read_text())
    rows = [(Path(f["input"]).stem, f["rc"], f["frames"])
            for f in metrics["files"]]
    if (rows != [(stem, 0, 1) for stem in sorted(stills)]
            or metrics["totals"]["exit_code"] != 0
            or not metrics["config"]["streamed_images"]):
        raise AssertionError(f"phase 13c: metrics report {metrics}")
    worst = (0, 0.0)
    for stem, img in stills.items():
        got = read_image(root / "c" / f"{stem}(swin_unet_art)(noise3)"
                                      f"(scale4).png")
        ok, dmax, frac = _golden_gate(got, up.render(img))
        worst = max(worst, (dmax, frac))
        if not ok:
            raise AssertionError(f"phase 13c: {stem} differs from its "
                                 f"render: max {dmax}, changed {frac}")
    # the host's share: one 2048^2 output through the CLI's PNG writer
    t0 = time.perf_counter()
    write_image(root / "c_png_probe.png", got)
    png_s = time.perf_counter() - t0
    print(f"  phase 13c CLI image folder, art 4x t256 b16 bf16, 9 stills "
          f"through the image stream in {dt:.3f} s ({len(stills) / dt:.3f} "
          f"files/s, PNG decode and encode included; one 2048^2 PNG "
          f"encode alone {png_s:.3f} s); each vs its single render: worst "
          f"max {worst[0]} (tol 2), changed fraction {worst[1]:.2e} (tol "
          f"1e-04); --metrics-json read back: {len(rows)} rows, rc 0, wall "
          f"{metrics['totals']['wall_seconds']} s: ok", flush=True)

    # d. an RGBA still with --alpha auto (the headline model): RGB is the
    # render of fill_transparent(rgb, a), alpha the rounded channel mean
    # of the render of the alpha plane
    rgba = rng.integers(0, 256, (200, 264, 4), np.uint8)
    rgba[..., 3] = 255
    rgba[:80, :, 3] = 0
    write_image(root / "in" / "rgba.png", rgba)
    _, n = _cli(torch, "phase 13d", argv(
        *art, "fp16", root / "in" / "rgba.png", "d", "--alpha", "auto"))
    t = up._pipeline.get((200, 264))[2].tile_count
    _check_launches("phase 13d", n, (2 * 10 * -(-t // 16), 2))
    counts["alpha"] = n
    from PIL import Image

    got = np.asarray(Image.open(
        root / "d" / "rgba(swin_unet_art)(noise3)(scale4).png"))
    want_rgb = up.render(fill_transparent(rgba[..., :3], rgba[..., 3]))
    a_r = up.render(np.repeat(rgba[..., 3:], 3, axis=2))
    want_a = np.clip(np.rint(a_r.astype(np.float32).mean(axis=2)), 0,
                     255).astype(np.uint8)
    ok_rgb, d_rgb, f_rgb = _golden_gate(got[..., :3], want_rgb)
    ok_a, d_a, f_a = _golden_gate(got[..., 3], want_a)
    print(f"  phase 13d --alpha auto RGBA still 200x264 -> {got.shape}: RGB "
          f"vs render(fill_transparent) max {d_rgb}, changed {f_rgb:.2e}; "
          f"alpha vs the rounded mean of the alpha plane's render max {d_a}, "
          f"changed {f_a:.2e} (tol 2, 1e-04); output alpha mean "
          f"{got[320:, :, 3].mean():.3f} under opaque input, "
          f"{got[:320, :, 3].mean():.3f} under transparent: "
          f"{'ok' if ok_rgb and ok_a else 'FAIL'}", flush=True)
    if got.shape != (800, 1056, 4) or not (ok_rgb and ok_a):
        raise AssertionError("phase 13d: the RGBA still disagrees")
    return counts


def _mirror():
    """The torch mirrors' exporters (``tests/torch_mirror.py``: torch and
    numpy only, ``torch.onnx.export(dynamo=False)``, no ``onnx`` package)."""
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_mirror

    return torch_mirror


def _onnx_stream(torch, up, frames, passes=2):
    """(outputs of the first pass as host arrays, output MP/s of each pass,
    launch counts of each pass) of ``passes`` streams of the frames
    (``_stream_run``, each warmed and counted on its own)."""
    first, rates, counts = None, [], []
    for _ in range(passes):
        outs, dt, n = _stream_run(torch, up, frames)
        if first is None:
            first = [o.cpu().numpy() for o in outs]
        rates.append(len(frames) * 2880 * 5120 / 1e6 / dt)
        counts.append(n)
    return first, rates, counts


def _rates(mps):
    return " / ".join(f"{r:.2f}" for r in mps)


def _stream_launches(up, n_frames):
    """(B, C) of a stream of ``n_frames`` frames after its warm cycle:
    10 launches of B a chunk (none for cunet or a parsed graph), one of C
    a frame."""
    t = up._pipeline.get((720, 1280))[2].tile_count
    chunks = -(-n_frames * t // up._pipeline.config.batch_size)
    return 10 * chunks, n_frames


def phase_onnx(torch, smi, report):
    """Phase 14: ``.onnx`` artifacts served by the port. (a) a seeded
    full-width swin_unet/art 4x noise 3 export (``torch_mirror``) through
    the CLI's ``build`` (fp16, batch 16, tile 256), cold (verification and
    a kernel library built afresh) and warm (both cached); (b) 720p frames
    from the ``.onnx`` alone on the verified path (``require_engine``),
    byte-identical to the weights ``validate --save-npz`` wrote, rendered
    from the ``.npz``; (c) ``graph_exact``: tf32 against the verified path
    (golden gate), fp16 by the bf16 rule, output MP/s of both paths; (d) a
    cunet/art 2x noise 1 export through ``build`` and ``render``. Returns
    the launch counts of each run."""
    import json as _json
    import shutil
    from pathlib import Path

    import numpy as np

    from waifu2x_tensorrt_tpu_torch.engine.config import Precision
    from waifu2x_tensorrt_tpu_torch.io.image import read_image, write_image
    from waifu2x_tensorrt_tpu_torch.models import validate
    from waifu2x_tensorrt_tpu_torch.ops import build as kernel_build

    root = Path(__file__).resolve().parent / "build" / "chip_smoke_onnx"
    shutil.rmtree(root, ignore_errors=True)
    models, npz_models = root / "models", root / "npz_models"
    art = models / "swin_unet" / "art" / "noise3_scale4x.onnx"
    art.parent.mkdir(parents=True)
    mirror = _mirror()
    t0 = time.perf_counter()
    mirror.export_torch_swin(art, scale=4, base_dim=96,
                             depths=(2, 2, 6, 2, 2), tile=256, seed=14)
    export_s = time.perf_counter() - t0
    counts = {}
    swin = ("swin_unet/art", 4, 3)

    def argv(model, scale, noise, precision, *cmd, models_dir=models):
        return ["--model", model, "--scale", str(scale), "--noise",
                str(noise), "--batchSize", "16", "--tileSize", "256",
                "--precision", precision, "--models-dir", str(models_dir),
                *cmd]

    # a. build, cold: no .verify.json and the kernel library compiled
    # into an empty directory and loaded from there, a second copy of the
    # library in this process (kernel B sets its own shared-memory limit
    # in each copy); then warm: both cached, the first copy
    saved = kernel_build.BUILD_DIR, kernel_build._lib
    kernel_build.BUILD_DIR, kernel_build._lib = root / "kernels", None
    try:
        cold_s, n_cold = _cli(torch, "phase 14a build (cold)",
                              argv(*swin, "fp16", "build"))
        second_copy = kernel_build._lib
    finally:
        kernel_build.BUILD_DIR, kernel_build._lib = saved
    if second_copy is None or second_copy is saved[1]:
        raise AssertionError("phase 14a: the cold build did not load its "
                             "own copy of the kernel library")
    warm_s, n_warm = _cli(torch, "phase 14a build (warm)",
                          argv(*swin, "fp16", "build"))
    # the host's share of a cold build, step by step
    from waifu2x_tensorrt_tpu_torch.models import onnx_backend, onnx_graph

    steps = {}
    t0 = time.perf_counter()
    graph = onnx_graph.read_graph(art)
    steps["parse"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    arch = onnx_backend.derive_arch(graph)
    steps["shape probe"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    flat = onnx_backend.swin_params_from_graph(graph)
    steps["conversion"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    onnx_backend.verify_swin_conversion(graph, arch, flat)
    steps["verification"] = time.perf_counter() - t0
    sidecars = sorted(p.name for p in art.parent.glob("*.engine.json"))
    rec = _json.loads((art.parent / (art.name + ".verify.json")).read_text())
    mb = art.stat().st_size / 1e6
    print(f"  phase 14a full-width swin_unet/art 4x export ({mb:.1f} MB, "
          f"{export_s:.1f} s) through the CLI's build "
          f"(fp16, b16, t256): cold {cold_s:.2f} s (verification + kernel "
          f"library), warm {warm_s:.2f} s (both cached); sidecar "
          f"{sidecars}; .verify.json max_err {rec.get('max_err')} "
          f"(tol 1e-4); build launches {n_cold} / {n_warm} (the cold one "
          f"from the second copy of the kernel library it built, "
          f"{second_copy._name}); on {smi}", flush=True)
    print("  phase 14a host seconds of the artifact's steps: " + ", ".join(
        f"{k} {v:.2f}" for k, v in steps.items()), flush=True)
    if (len(sidecars) != 1 or not float(rec.get("max_err", 1)) <= 1e-4
            or n_cold["B"] != 10 or n_warm["B"] != 10):
        raise AssertionError(f"phase 14a: build gave sidecars {sidecars}, "
                             f"record {rec}, launches {n_cold} {n_warm}")
    counts["build"] = n_warm

    # b. the .onnx alone on the verified path vs the .npz validate wrote;
    # every rate of (b) and (c) is over phase 5's window: its 10 frames,
    # two passes
    rng = np.random.default_rng(14)
    frames = _phase5_frames()[1]

    def load(models_dir, precision, graph_exact=False, require=False):
        from waifu2x_tensorrt_tpu_torch.engine.config import RenderConfig
        from waifu2x_tensorrt_tpu_torch.engine.upscaler import Upscaler

        up = Upscaler(models_dir=models_dir, device="cuda:0")
        up.load(*swin, RenderConfig(
            precision=precision, batch_size=16, height=256, width=256,
            scaling=4, overlap=(1 / 16, 1 / 16)),
            require_engine=require, graph_exact=graph_exact)
        return up

    # the build's sidecar must satisfy this load (require_engine)
    up = load(models, Precision.FP16, require=True)
    onnx16, mps16, n16v = _onnx_stream(torch, up, frames)
    want = _stream_launches(up, len(frames))
    npz = npz_models / "swin_unet" / "art" / "noise3_scale4x.npz"
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        rc = validate.main([str(art), "--family", "swin_unet/art",
                            "--scale", "4", "--noise", "3", "--tile", "256",
                            "--save-npz", str(npz)])
    if rc != 0:
        print(buf.getvalue()[-3000:], file=sys.stderr)
        raise AssertionError(f"phase 14b: validate exited {rc}")
    gate = [ln for ln in buf.getvalue().splitlines() if ln.startswith("max")]
    npz16, _, _ = _onnx_stream(torch, load(npz_models, Precision.FP16),
                               frames, passes=1)
    same = all(np.array_equal(a, b) for a, b in zip(onnx16, npz16))
    print(f"  phase 14b .onnx alone, verified path, {len(frames)} streamed "
          f"720p frames, two passes: {_rates(mps16)} output MP/s; launches "
          f"{n16v} (B, C each pass) expected {want}; validate --save-npz "
          f"(port modules on the "
          f"card, tile 256): {'; '.join(gate)}; the .npz's stream "
          f"byte-identical to the .onnx's: {same}; mean "
          f"{np.mean(onnx16):.3f}, share of values strictly inside (0, "
          f"255): {np.mean([(o > 0) & (o < 255) for o in onnx16]):.3f}",
          flush=True)
    if (any((n["B"], n["C"]) != want or any(n[k] for k in "ADEF")
            for n in n16v) or not same):
        raise AssertionError(f"phase 14b: launches {n16v} (want {want}), "
                             f"byte-identical {same}")
    counts["verified"] = n16v[0]

    # c. graph-exact: tf32 against the verified path, fp16 by the bf16
    # rule against the verified fp32 frames
    ver32, mps32, _ = _onnx_stream(torch, load(models, Precision.TF32),
                                   frames)
    g32, mps_g32, n32 = _onnx_stream(
        torch, load(models, Precision.TF32, graph_exact=True), frames)
    g16, mps_g16, n16 = _onnx_stream(
        torch, load(models, Precision.FP16, graph_exact=True), frames)
    worst = (0, 0.0)
    for a, b in zip(g32, ver32):
        ok, dmax, frac = _golden_gate(a, b)
        worst = max(worst, (dmax, frac))
        if not ok:
            raise AssertionError(f"phase 14c: tf32 graph-exact frame vs "
                                 f"the verified path: max {dmax}, changed "
                                 f"{frac}")
    d16 = max(int(np.abs(a.astype(int) - b.astype(int)).max())
              for a, b in zip(g16, ver32))
    dver = max(int(np.abs(a.astype(int) - b.astype(int)).max())
               for a, b in zip(onnx16, ver32))
    tol16 = max(2 * dver, 0.02 * 255)
    print(f"  phase 14c graph-exact, {len(frames)} streamed 720p frames: "
          f"tf32 vs the "
          f"verified tf32 path worst max {worst[0]} (tol 2), changed "
          f"{worst[1]:.2e} (tol 1e-04); fp16 vs verified tf32 max {d16} "
          f"(bf16 rule: tol max(2 x {dver}, 0.02 x 255) = {tol16:.2f}); "
          f"launches tf32 {n32}, fp16 {n16} (each pass)", flush=True)
    print(f"  phase 14b/c output MP/s, {len(frames)} streamed 720p frames, "
          f"pass 1 / pass 2: verified fp16 {_rates(mps16)}, graph-exact "
          f"fp16 {_rates(mps_g16)}; verified tf32 {_rates(mps32)}, "
          f"graph-exact tf32 {_rates(mps_g32)}; on {smi}", flush=True)
    for label, nn in (("tf32", n32), ("fp16", n16)):
        if any(n["C"] != len(frames) or any(n[k] for k in "ABDEF")
               for n in nn):
            raise AssertionError(f"phase 14c {label}: launches {nn}")
    if d16 > tol16:
        raise AssertionError(f"phase 14c: fp16 graph-exact max {d16} > "
                             f"{tol16}")
    counts["graph_tf32"], counts["graph_fp16"] = n32[0], n16[0]

    # d. cunet/art 2x noise 1: build, then render a 512^2 still (CLI)
    cu = ("cunet/art", 2, 1)
    cu_art = models / "cunet" / "art" / "noise1_scale2x.onnx"
    cu_art.parent.mkdir(parents=True)
    mirror.export_torch_cunet(cu_art, scale=2, tile=76, seed=14)
    bs, nb = _cli(torch, "phase 14d build", argv(*cu, "fp16", "build"))
    still = rng.integers(0, 256, (512, 512, 3), np.uint8)
    write_image(root / "still.png", still)
    (root / "out").mkdir()
    rs, nr = _cli(torch, "phase 14d render", argv(
        *cu, "fp16", "render", "-i", str(root / "still.png"), "-o",
        str(root / "out")))
    got = read_image(root / "out" / "still(cunet_art)(noise1)(scale2).png")
    from waifu2x_tensorrt_tpu_torch.engine.config import RenderConfig
    from waifu2x_tensorrt_tpu_torch.engine.upscaler import Upscaler

    cu_up = Upscaler(models_dir=models, device="cuda:0")
    cu_up.load(*cu, RenderConfig(precision=Precision.FP16, batch_size=16,
                                 height=256, width=256, scaling=2),
               require_engine=True)
    ok, dmax, frac = _golden_gate(got, cu_up.render(still))
    print(f"  phase 14d cunet/art 2x export: CLI build {bs:.2f} s "
          f"(launches {nb}), CLI render of a 512^2 still {rs:.2f} s -> "
          f"{got.shape}, launches {nr}; vs Upscaler.render of the "
          f"artifact: max {dmax}, changed {frac:.2e} (golden gate): "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if (got.shape != (1024, 1024, 3) or not ok or nr["C"] != 1
            or any(nr[k] for k in "ABDEF")):
        raise AssertionError(f"phase 14d: render {got.shape}, launches "
                             f"{nr}, gate {ok}")
    counts["cunet_render"] = nr
    return counts


@contextlib.contextmanager
def _eager_models(torch, pipeline):
    """Inside the context the pipeline's model programs are their modules
    called eagerly, as every chunk ran before programs were captured."""
    saved = pipeline.model_prog, pipeline.model_prog_px

    def eager(prog):
        def run(tiles):
            with torch.inference_mode():
                return prog.fn(tiles)

        return None if prog is None else run

    pipeline.model_prog, pipeline.model_prog_px = map(eager, saved)
    try:
        yield
    finally:
        pipeline.model_prog, pipeline.model_prog_px = saved


def _captured_vs_eager(torch, label, up, frames, out_mp):
    """One chunk of the first frame's tiles through its program (first
    call: eager, then captured; second call: a replay) and through the
    module called eagerly, byte for byte; then the frames streamed with
    eager models and with captured programs, in turns (eager, captured,
    captured, eager), each pass warmed on its own: output MP/s and the
    launch counts of each pass, and the streams byte for byte."""
    import numpy as np

    pl = up._pipeline
    prep = pl.get(frames[0].shape[:2])[0]
    tiles = prep.flat(torch.from_numpy(frames[0]).cuda())
    chunk = tiles[:pl.config.batch_size]
    prog = pl.model_prog_px if prep.use_pack_x else pl.model_prog
    first, replay = prog(chunk), prog(chunk)
    with torch.inference_mode():
        eager = prog.fn(chunk)
    same_chunk = torch.equal(first, eager) and torch.equal(replay, eager)
    rates, counts, firsts = {"eager": [], "captured": []}, {}, {}
    for mode in ("eager", "captured", "captured", "eager"):
        ctx = (_eager_models(torch, pl) if mode == "eager"
               else contextlib.nullcontext())
        with ctx:
            outs, dt, n = _stream_run(torch, up, frames)
        rates[mode].append(len(frames) * out_mp / dt)
        counts[mode] = n
        firsts.setdefault(mode, [o.cpu().numpy() for o in outs])
    same_stream = all(np.array_equal(a, b) for a, b in
                      zip(firsts["eager"], firsts["captured"]))
    print(f"  {label}: a chunk {tuple(chunk.shape)} captured vs eager "
          f"byte-identical: {same_chunk}; {len(frames)} streamed frames "
          f"byte-identical: {same_stream}; output MP/s eager "
          f"{_rates(rates['eager'])}, captured {_rates(rates['captured'])}"
          f"; launch counts a pass eager {counts['eager']}, captured "
          f"{counts['captured']}", flush=True)
    if not (same_chunk and same_stream) or counts["eager"] != \
            counts["captured"]:
        raise AssertionError(f"{label}: captured programs differ from the "
                             "eager modules")
    return {"eager_mp_per_s": rates["eager"],
            "captured_mp_per_s": rates["captured"],
            "launches_a_pass": counts["captured"]}


def _pool_mb(nbytes):
    return f"{nbytes / 2 ** 20:.1f} MiB"


def phase_programs(torch, smi, report):
    """Phase 15: compiled programs (captured CUDA graphs, the port's
    ``engine/exe_cache.py``). a. captured against eager, flagship and
    art_scan TTA; b. a ``fuse_frame`` 720p render and its per-frame loop;
    c. graph-exact captured against eager (phase 14's export); d. pool
    bytes; e. the flagship's ``flops_per_frame``; f. ``build`` ready
    seconds, cold and warm, by step."""
    import shutil
    from pathlib import Path

    import numpy as np

    from waifu2x_tensorrt_tpu_torch.engine.config import (
        BuildConfig,
        Precision,
    )
    from waifu2x_tensorrt_tpu_torch.engine.upscaler import Upscaler
    from waifu2x_tensorrt_tpu_torch.ops import build as kernel_build
    from waifu2x_tensorrt_tpu_torch.probes.int8_probe import BF16_PEAK

    out = {}
    frame, frames = _phase5_frames()
    flag_mp = 2880 * 5120 / 1e6

    # a. captured vs eager: the flagship stream and art_scan TTA
    up = _load(torch, Precision.FP16)
    out["flagship"] = _captured_vs_eager(torch, "phase 15a flagship", up,
                                         frames, flag_mp)
    rng = np.random.default_rng(15)
    tta_frames = [rng.integers(0, 256, (512, 512, 3), np.uint8)
                  for _ in range(8)]
    tta = _upscaler("swin_unet/art_scan", 4, 3, Precision.FP16, 128, 8,
                    tta=True)
    out["art_scan_tta"] = _captured_vs_eager(
        torch, "phase 15a art_scan TTA", tta, tta_frames, 2048 * 2048 / 1e6)

    # b. fuse_frame: the 720p frame as one program, against the chunked
    # render; the per-frame loop of each over phase 5's 10 frames
    fused = _upscaler("swin_unet/art", 4, 3, Precision.FP16, 256, 16,
                      fuse_frame=True)
    want = up.render(frame)
    got = fused.render(frame)
    counters = _zero_counters()
    again = fused.render(frame)
    n_frame = {k: f.launches for k, f in counters.items()}
    dmax = int(np.abs(got.astype(int) - want.astype(int)).max())
    loops = {"fused": [], "chunked": []}
    for mode in ("chunked", "fused", "fused", "chunked"):
        render = (fused._fused.render if mode == "fused"
                  else up._pipeline.render)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for f in frames:
            render(f)
        torch.cuda.synchronize()
        loops[mode].append(len(frames) * flag_mp / (time.perf_counter() - t0))
    prog = fused._fused.get((720, 1280))
    print(f"  phase 15b fuse_frame 720p render -> {got.shape}: vs the "
          f"chunked render max {dmax} (tol 1), byte-identical "
          f"{dmax == 0}; a replay byte-identical {np.array_equal(got, again)}"
          f", launches a frame {n_frame}; per-frame loop of 10 frames, "
          f"output MP/s: fused {_rates(loops['fused'])}, chunked "
          f"{_rates(loops['chunked'])} (phase 5's stream "
          f"{report['stream']['output_mp_per_s']:.2f}); first call: eager "
          f"{next(iter(prog.graphs.values())).eager_s:.3f} s, capture "
          f"{next(iter(prog.graphs.values())).capture_s:.3f} s", flush=True)
    if (dmax > 1 or not np.array_equal(got, again)
            or (n_frame["B"], n_frame["C"]) != (20, 1)):
        raise AssertionError(f"phase 15b: fuse_frame max {dmax}, launches "
                             f"{n_frame}")
    out["fuse_frame"] = {"max_vs_chunked": dmax, "loop_mp_per_s": loops,
                         "launches_a_frame": n_frame}

    # c. graph-exact (phase 14's export), captured vs eager
    onnx_models = (Path(__file__).resolve().parent / "build" /
                   "chip_smoke_onnx" / "models")
    graph = _upscaler("swin_unet/art", 4, 3, Precision.FP16, 256, 16,
                      models_dir=onnx_models, graph_exact=True)
    out["graph_exact"] = _captured_vs_eager(
        torch, "phase 15c graph-exact fp16", graph, frames, flag_mp)

    # d. pool bytes: the flagship's chunk programs, the 720p frame, and a
    # folder of stills of other sizes (one whole-frame graph each)
    chunk_pools = {g.static_args[0].shape[0]: g.pool_bytes
                   for g in up._pipeline.model_prog.graphs.values()}
    frame_pool = fused._fused.pool.bytes
    sizes, growth = [(512, 512), (384, 640), (1080, 1920)], []
    for hw in sizes:
        before = fused._fused.pool.bytes
        t0 = time.perf_counter()
        fused.render(rng.integers(0, 256, (*hw, 3), np.uint8))
        torch.cuda.synchronize()
        growth.append((fused._fused.pool.bytes - before,
                       time.perf_counter() - t0))
    print(f"  phase 15d pool bytes: flagship chunk programs "
          + ", ".join(f"{n} tiles {_pool_mb(b)}"
                      for n, b in sorted(chunk_pools.items()))
          + f" (one pool: {_pool_mb(up._pipeline.pool.bytes)}); fuse_frame "
          f"720p frame {_pool_mb(frame_pool)}; each further still size "
          + ", ".join(f"{h}x{w} +{_pool_mb(b)} in {t:.2f} s (eager + "
                      f"capture)" for (h, w), (b, t) in zip(sizes, growth))
          + f"; reserved {_pool_mb(torch.cuda.memory_reserved())}",
          flush=True)
    out["pool_bytes"] = {"chunks": chunk_pools,
                         "chunk_pool": up._pipeline.pool.bytes,
                         "fuse_frame_720p": frame_pool,
                         "stills": dict(zip(map(str, sizes), growth))}

    # e. the flagship's FLOPs a frame (the MFU numerator)
    t0 = time.perf_counter()
    flops = up._pipeline.flops_per_frame((720, 1280))
    per_mp = flops / 1e9 / flag_mp
    mfu = report["stream"]["output_mp_per_s"] * per_mp * 1e9 / BF16_PEAK
    print(f"  phase 15e flops_per_frame 720p: {flops / 1e9:.2f} GFLOP "
          f"({per_mp:.2f} GFLOP per output MP; XLA's count of the JAX model "
          f"45.44), counted in {time.perf_counter() - t0:.2f} s; at phase "
          f"5's streamed rate {100 * mfu:.2f}% of the dense bf16 peak, on "
          f"{smi}", flush=True)
    out["flops"] = {"gflop_per_frame": flops / 1e9,
                    "gflop_per_output_mp": per_mp, "mfu_phase5": mfu}

    # f. build ready seconds, cold (the kernel library compiled into an
    # empty directory and loaded from there: another copy) and warm
    root = Path(__file__).resolve().parent / "build" / "chip_smoke_programs"
    shutil.rmtree(root, ignore_errors=True)
    bcfg = BuildConfig(precision=Precision.FP16, min_batch_size=16,
                       opt_batch_size=16, max_batch_size=16, min_width=256,
                       opt_width=256, max_width=256, min_height=256,
                       opt_height=256, max_height=256)
    ready = {}
    for mode in ("cold", "warm"):
        saved = kernel_build.BUILD_DIR, kernel_build._lib
        if mode == "cold":
            kernel_build.BUILD_DIR, kernel_build._lib = root / "kernels", None
        try:
            builder = Upscaler(models_dir=root / "models",
                               allow_random_init=True, device="cuda:0")
            t0 = time.perf_counter()
            builder.build("swin_unet/art", 4, 3, bcfg)
            ready[mode] = {"total": time.perf_counter() - t0,
                           **builder.build_seconds}
        finally:
            kernel_build.BUILD_DIR, kernel_build._lib = saved
    print("  phase 15f build ready seconds (flagship, b16 t256, one "
          "corner): " + "; ".join(
              f"{mode} {r['total']:.2f} = library {r['library']:.2f} + "
              f"model and weights {r['model']:.2f} + first eager call "
              f"{r['eager']:.2f} + capture {r['capture']:.2f} (+ sidecar)"
              for mode, r in ready.items()), flush=True)
    out["build_seconds"] = ready
    report["programs"] = out
    return n_frame


# ffprobe / ffmpeg stand-ins that speak the pipe protocol of the port's
# io/video.py over raw rgb24 clips: a clip is its frames' bytes, with a
# JSON sidecar (<clip>.json: width, height, rate, frames) in place of a
# container header. The encoder writes the raw frames it is piped; the
# concat demuxer joins the listed parts byte for byte.
_FFPROBE_SHIM = """\
import json, sys
meta = json.load(open(sys.argv[-1] + ".json"))
if "-count_frames" in sys.argv:
    print(meta["frames"])
else:
    print("width=%d" % meta["width"])
    print("height=%d" % meta["height"])
    print("r_frame_rate=" + meta["rate"])
    print("nb_frames=%d" % meta["frames"])
"""
_FFMPEG_SHIM = """\
import json, re, shutil, signal, sys
signal.signal(signal.SIGPIPE, signal.SIG_DFL)  # a closed reader ends it
argv = sys.argv[1:]
src = argv[argv.index("-i") + 1]
if "concat" in argv:
    with open(argv[-1], "wb") as out:
        for m in re.finditer(r"^file '(.*)'$", open(src).read(), re.M):
            with open(m.group(1).replace("'\\\\''", "'"), "rb") as part:
                shutil.copyfileobj(part, out)
elif src == "-":
    with open(argv[-1], "wb") as out:
        shutil.copyfileobj(sys.stdin.buffer, out)
else:
    meta = json.load(open(src + ".json"))
    size = meta["width"] * meta["height"] * 3
    a, b = 0, meta["frames"]
    if "-vf" in argv:
        m = re.search(r"trim=start_frame=(\\d+):end_frame=(\\d+)",
                      argv[argv.index("-vf") + 1])
        a, b = int(m.group(1)), int(m.group(2))
    with open(src, "rb") as f:
        f.seek(a * size)
        for _ in range(b - a):
            sys.stdout.buffer.write(f.read(size))
"""


def write_ffmpeg_shims(bin_dir):
    """Write executable ``ffprobe`` and ``ffmpeg`` stand-ins into
    ``bin_dir`` (run by this interpreter); put ``bin_dir`` first on PATH to
    drive the port's video path without a codec."""
    from pathlib import Path

    bin_dir = Path(bin_dir)
    bin_dir.mkdir(parents=True, exist_ok=True)
    for name, body in (("ffprobe", _FFPROBE_SHIM), ("ffmpeg", _FFMPEG_SHIM)):
        path = bin_dir / name
        path.write_text(f"#!{sys.executable}\n{body}")
        path.chmod(0o755)
    return bin_dir


def write_raw_clip(path, frames, rate="30000/1001"):
    """A clip for the shims: the (N, H, W, 3) u8 frames' bytes at ``path``
    and their sidecar beside it."""
    from pathlib import Path

    path = Path(path)
    path.write_bytes(frames.tobytes())
    n, h, w = frames.shape[:3]
    Path(str(path) + ".json").write_text(json.dumps(
        {"width": w, "height": h, "rate": rate, "frames": n}))
    return path


def read_raw_clip(path, h, w):
    """The frames of a raw rgb24 file the encoder shim wrote."""
    import numpy as np

    return np.fromfile(path, np.uint8).reshape(-1, h, w, 3)


def _hat_inputs(torch, b, h, w, c, nh, overlap, seed):
    """Unit-scale (b, h, w, 3c) fp32 qkv and the (rows, nh) fp32 table of
    N(0, 0.2^2) of kernel G's geometry, on the card."""
    from waifu2x_tensorrt_tpu_torch.ops.hat_attention import table_rows

    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, h, w, 3 * c), generator=g, device="cuda")
    table = 0.2 * torch.randn((table_rows(16, overlap), nh), generator=g,
                              device="cuda")
    return qkv, table


def _at_pitch(torch, t, parts, c):
    """``t`` as the main path carries HAT's and DAT's trunk: each of the
    ``parts`` equal blocks of its last axis at the trunk's pitch for c
    (``layers.pitch``), with NaN in the pads (which a kernel must neither
    read into the real channels nor pass on)."""
    import torch.nn.functional as F

    from waifu2x_tensorrt_tpu_torch.models.layers import pitch

    p = pitch(c, t.device)
    return F.pad(t.unflatten(-1, (parts, c)), (0, p - c),
                 value=float("nan")).flatten(-2)


def _padded_case(torch, wide, narrow, c, p32, e_p):
    """The check of a kernel's launch at the trunk's pitch (``wide``, P >
    c channels) against its pitch-c launch ``narrow`` and the fp32 twin
    ``p32``: (|wide - p32| on the real channels, the real channels byte-
    equal to ``narrow``, the pad all zero, ok by phase 3's rule)."""
    real = wide[..., :c]
    e_w = float((real.float() - p32).abs().max())
    equal = torch.equal(real, narrow)
    zero = not wide[..., c:].any()
    return e_w, equal, zero, equal and zero and e_w <= max(2 * e_p, 0.02)


def _hat_work(b, h, w, c, nh, overlap):
    """(bytes, product FLOPs, fp32 FLOPs) of one kernel-G launch over a
    (b, h, w) map at width c: q, k, v read once and the output written
    once in bf16 (the benchmark's ``counts/hat.kernel_g``); q k^T and p v
    at the head dim; ~6 fp32 operations a score."""
    tokens = b * h * w
    keys = (16 + 2 * overlap) ** 2
    return (tokens * 4 * c * 2, 2 * 2 * tokens * keys * c,
            6 * tokens * keys * nh)


def _hat_sdpa(torch, qkv, table, nh, shift, overlap):
    """SDPA over kernel G's windows (pre-split, contiguous (B, nW, nh, N,
    d) q, k and v) with the bias and region mask as one float mask of
    qkv's dtype: a yardstick the port never calls."""
    import torch.nn.functional as F

    from waifu2x_tensorrt_tpu_torch.ops import hat_attention as ha

    b, h, w, c3 = qkv.shape
    c = c3 // 3
    x = torch.roll(qkv, (-shift, -shift), dims=(1, 2)) if shift else qkv
    q = ha._windows(x[..., :c], 16)
    kv = (ha._overlap_windows(x[..., c:], 16, overlap) if overlap
          else ha._windows(x[..., c:], 16))

    def heads(t):
        return t.reshape(*t.shape[:3], nh, -1).transpose(2, 3).contiguous()

    q, k, v = heads(q), heads(kv[..., :c]), heads(kv[..., c:])
    mask = table[ha._index_tensor(16, overlap, qkv.device)].permute(2, 0, 1)
    if shift:
        mask = mask + ha.region_mask(h, w, 16, shift, qkv.device)[:, None]
    mask = mask.to(qkv.dtype).contiguous()
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def phase_kernel_g(torch, smi, report):
    """Phase 16: kernel G against its plain twin, its times, and the HAT
    stream's launch counts."""
    import gc

    import numpy as np

    from waifu2x_tensorrt_tpu_torch.engine.config import Precision
    from waifu2x_tensorrt_tpu_torch.ops import hat_attention as ha
    from waifu2x_tensorrt_tpu_torch.utils import profiling

    gc.collect()  # the earlier phases' programs and pools
    torch.cuda.empty_cache()
    worst = 0.0
    # the cell's chunk of 16 256 x 256 tiles in each geometry (the fp32
    # twin's scores there peak near 50 GB), then a map with borders
    cases = [(16, 256, 256, 0, 0), (16, 256, 256, 8, 0), (16, 256, 256, 0, 4),
             (3, 48, 80, 8, 0), (3, 48, 80, 0, 4)]
    for b, h, w, shift, ov in cases:
        qkv, table = _hat_inputs(torch, b, h, w, 180, 6, ov, seed=h + shift)
        kw = {"num_heads": 6, "shift": shift, "overlap": ov}
        q16 = qkv.bfloat16()
        k16 = ha.hat_attention(q16, table, **kw)
        p32 = ha.hat_attention_plain(qkv, table, **kw)
        del qkv
        torch.cuda.empty_cache()
        p16 = ha.hat_attention_plain(q16, table, **kw).float()
        e_k = float((k16.float() - p32).abs().max())
        e_p = float((p16 - p32).abs().max())
        same = float((k16.float() != p16).float().mean())
        del p16
        torch.cuda.empty_cache()
        ok = e_k <= max(2 * e_p, 0.02)
        label = (f"G {'overlap' if ov else 'self'} ({b}, {h}, {w}, 540) "
                 f"shift {shift}")
        print(f"  phase 16 {label}: |k16-p32|={e_k:.3e} <= max(2*"
              f"{e_p:.3e}, 0.02); values differing from the bf16 twin "
              f"{same:.2e}: {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"phase 16: kernel G {label} disagrees")
        wq = None
        if b == 16:  # the main path's inputs: qkv at the trunk's pitch
            wq = _at_pitch(torch, q16, 3, 180)
            wide = ha.hat_attention(wq, table, channels=180, **kw)
            e_w, equal, zero, ok = _padded_case(torch, wide, k16, 180, p32,
                                                e_p)
            worst = max(worst, e_k, e_w)
            label = (f"G {'overlap' if ov else 'self'} ({b}, {h}, {w}, "
                     f"{wq.shape[-1]}) channels 180 shift {shift}")
            print(f"  phase 16 {label}: |k16-p32|={e_w:.3e} on the real "
                  f"channels; those byte-equal to the pitch-180 launch: "
                  f"{equal}; the pad zero: {zero}: "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            del wide
            if not ok:
                raise AssertionError(f"phase 16: kernel G {label} "
                                     f"disagrees")
        del k16, p32
        torch.cuda.empty_cache()
        if b == 16 and (shift == 8) != bool(ov):
            # times of the shifted self and the overlapping launch
            pm = _median_ms(lambda: ha.hat_attention_plain(q16, table, **kw),
                            iters=3, warmup=1)
            torch.cuda.empty_cache()
            km = _median_ms(lambda: ha.hat_attention(q16, table, **kw))
            wm = _median_ms(lambda: ha.hat_attention(wq, table, channels=180,
                                                     **kw))
            lm = _median_ms(_hat_sdpa(torch, q16, table, 6, shift, ov))
            bms, by = _bound(*_hat_work(16, h, w, 180, 6, ov))
            occ = ha.occupancy(ov)
            key = "overlap" if ov else "self"
            print(f"  phase 16 G {key} (16, {h}, {w}) shift {shift}: "
                  f"{km:.4f} ms (bound {bms:.4f} ms by {by}, "
                  f"{100 * bms / km:.1f}% of it); at the trunk's pitch "
                  f"{wm:.4f} ms ({100 * bms / wm:.1f}%); plain twin "
                  f"{pm:.4f} ms; SDPA with a float mask {lm:.4f} ms; "
                  f"{occ['registers']} registers, {occ['ctas_per_sm']} CTAs "
                  f"an SM", flush=True)
            report.setdefault("G", {})[key] = {
                "ms": km, "padded_ms": wm, "plain_ms": pm, "bound_ms": bms,
                "bound_by": by, "library_ms": lm, **occ}
        del q16, wq, table
        torch.cuda.empty_cache()
    row = report["G"]
    row.update(max_abs_err=worst, **{
        k: row["overlap"][k] for k in ("ms", "padded_ms", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms")})
    self_row = row.pop("self")
    row["self_ms"], row["self_padded_ms"] = (self_row["ms"],
                                             self_row["padded_ms"])
    row.pop("overlap")

    up = _upscaler("hat/photo", 4, -1, Precision.FP16, 256, 16)
    rng = np.random.default_rng(16)
    frames = [rng.integers(0, 256, (480, 720, 3), np.uint8)
              for _ in range(8)]
    session = up.open_stream((480, 720))
    session.warm()
    counters = _zero_counters()
    profiling.reset()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        outs = [o for f in frames for o in session.submit(f)]
        outs += session.flush()
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    spans = [sp.counts for sp in profiling.records() if sp.name == "model"]
    profiling.reset()
    n = {k: w.launches for k, w in counters.items()}
    good = (len(outs) == len(frames) and spans and all(
        c.get("program") == "replay" and c.get("launches_G") == 42
        and c.get("overlap_G") == 6 and c.get("padded_G") == 42
        for c in spans))
    mps = len(frames) * 2880 * 1920 / 1e6 / dt
    print(f"  phase 16 hat/photo 4x stream: {len(frames)} 720 x 480 frames "
          f"in {dt:.3f} s (traced) = {mps:.2f} output MP/s; "
          f"{len(spans)} model spans, each a replay with "
          f"launches_G 42, overlap_G 6 and padded_G 42: "
          f"{'ok' if good else 'FAIL'}; "
          f"launch counts {n}", flush=True)
    if not good or n["G"] != 42 * len(spans):
        raise AssertionError(f"phase 16: the HAT stream's model spans "
                             f"{spans}")
    return n


# kernel H's launches on the cunet2x-1080p-stream cell's path (16 tiles of
# 256), as (key, shape, crop of the skip or None, act, clamp): the largest
# maps, UNet2's conv1 with the leaky ReLU and its conv4_up with the leaky
# ReLU and the skip cropped by 16 (the vector path), and the two C-3
# conv_bottoms (the scalar path): UNet1's, the bias alone, and UNet2's,
# with the cascade's skip cropped by 20 and the clamp
EPILOGUE_CASES = (("", (16, 476, 476, 64), None, True, False),
                  ("skip_", (16, 444, 444, 64), 16, True, False),
                  ("bottom1_", (16, 480, 480, 3), None, False, False),
                  ("bottom2_", (16, 440, 440, 3), 20, False, True))


def _epilogue_label(crop, act, clamp):
    return " + ".join(["act"] * act + [f"skip (crop {crop})"] * (
        crop is not None) + ["clamp"] * clamp) or "bias alone"


def _epilogue_inputs(torch, shape, crop, dtype, seed, specials=False):
    """A bias-free conv output of ``shape``, its bias and a skip grown by
    ``crop`` a side (None: no skip), N(0, 1) on the card. With
    ``specials``, inf, -inf, -0.0 and NaN among the conv values, and in
    channel 0 of the first row a -0.0 bias, conv value and skip value, so
    that the sum is -0.0 where a clamp would make it +0.0."""
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


def _epilogue_work(shape, crop, elem):
    """Bytes of one kernel-H launch: the conv output read and the
    activation written once, the skip's crop (the values added) read once,
    and the bias."""
    n, h, w, c = shape
    values = n * h * w * c
    return (values * (2 if crop is None else 3) + c) * elem


def phase_kernel_h(torch, smi, report):
    """Phase 17: kernel H against its plain twin at the cunet cell's
    largest maps and at its two C-3 conv_bottoms (with inf, -inf, -0.0 and
    NaN), its times, and the cunet 1080p stream's launch counts."""
    import gc

    import numpy as np

    from waifu2x_tensorrt_tpu_torch.engine.config import Precision
    from waifu2x_tensorrt_tpu_torch.ops import cunet_epilogue as ce
    from waifu2x_tensorrt_tpu_torch.utils import profiling

    gc.collect()  # the earlier phases' programs and pools
    torch.cuda.empty_cache()
    row = report["H"] = {"library_ms": None}
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        name = "bf16" if dtype == torch.bfloat16 else "fp32"
        for tag, shape, crop, act, clamp in EPILOGUE_CASES:
            conv, bias, skip = _epilogue_inputs(torch, shape, crop, dtype,
                                                seed=shape[1],
                                                specials=not act)
            kw = {"act": act, "skip": skip, "crop": crop or 0,
                  "clamp": clamp}
            want = ce.bias_act_plain(conv.clone(), bias, **kw)
            got = ce.bias_act(conv.clone(), bias, **kw)
            # NaNs compared by place (their payloads are the hardware's),
            # every other value by its bytes
            nan = torch.isnan(want)
            g, w = got.float()[~nan], want.float()[~nan]
            err = float(torch.where(g == w, 0.0, (g - w).abs()).max())
            bits = torch.int16 if got.element_size() == 2 else torch.int32
            same = (torch.equal(torch.isnan(got), nan)
                    and torch.equal(got.view(bits)[~nan],
                                    want.view(bits)[~nan]))
            del got, want, g, w, nan
            worst = max(worst, err)
            work = conv.clone()
            km = _median_ms(lambda: ce.bias_act(work, bias, **kw))
            pm = _median_ms(lambda: ce.bias_act_plain(work, bias, **kw))
            lm = _median_ms(lambda: ce.epilogue_ops(work, bias, **kw))
            bms, by = _bound(_epilogue_work(shape, crop, conv.element_size()))
            label = _epilogue_label(crop, act, clamp)
            print(f"  phase 17 H {name} {shape} {label}: max |k - twin| "
                  f"{err:.3e} (byte-equal: "
                  f"{'ok' if same else 'FAIL'}); {km:.4f} ms (bound "
                  f"{bms:.4f} ms by {by}, {100 * bms / km:.1f}% of it); "
                  f"plain twin {pm:.4f} ms; the torch ops it replaces "
                  f"{lm:.4f} ms", flush=True)
            if not same:
                raise AssertionError(f"phase 17: kernel H {name} {shape} "
                                     f"{label} is not its twin")
            key = "" if name == "bf16" and not tag else f"{name}_{tag}"
            row.update({f"{key}ms": km, f"{key}plain_ms": pm,
                        f"{key}bound_ms": bms,
                        f"library_chain_{key}ms": lm})
            if not key:
                row["bound_by"] = by
            del conv, bias, skip, work
            torch.cuda.empty_cache()
    row["max_abs_err"] = worst

    root = _cunet_weights(2, 1, seed=11)
    up = _upscaler("cunet/art", 2, 1, Precision.FP16, 256, 16,
                   models_dir=root)
    rng = np.random.default_rng(17)
    frames = [rng.integers(0, 256, (1080, 1920, 3), np.uint8)
              for _ in range(4)]
    session = up.open_stream((1080, 1920))
    session.warm()
    counters = _zero_counters()
    profiling.reset()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        outs = [o for f in frames for o in session.submit(f)]
        outs += session.flush()
        torch.cuda.synchronize()
    spans = [sp.counts for sp in profiling.records() if sp.name == "model"]
    profiling.reset()
    n = {k: w.launches for k, w in counters.items()}
    good = (len(outs) == len(frames) and spans and all(
        c.get("program") == "replay" and c.get("launches_H") == 22
        for c in spans))
    print(f"  phase 17 cunet/art 2x 1080p stream: {len(frames)} frames, "
          f"{len(spans)} model spans, each a replay with launches_H 22: "
          f"{'ok' if good else 'FAIL'}; launch counts {n}", flush=True)
    if not good or n["H"] != 22 * len(spans):
        raise AssertionError(f"phase 17: the cunet stream's model spans "
                             f"{spans}")
    return n


# kernel I at the hat4x-480p-stream cell's chunk of 16 tiles of 256, and
# the maps each variant reads and writes: x (r, z) read once, the sum y
# (not for the norm alone) and its norm n written once
NORM_SHAPE = (16, 256, 256, 180)
NORM_MAPS = {"norm": 2, "add": 4, "scaled": 5, "skip": 4, "skip_gate": 4}


def _add_norm_inputs(torch, shape, variant, seed):
    """bf16 x, r, z, s, weight, bias and k of HAT's scale on the card: a
    residual stream of std 3, terms of std 1, channel weights in (0,
    0.01) (MambaIR's gate: in (0, 1)), LN parameters and the skip weight
    k about 1 and 0 and 1."""
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


def _add_norm_work(shape, variant):
    """Bytes of one kernel-I launch: its maps (``NORM_MAPS``), gamma and
    beta, the (B, C) channel weights of z and the skip weight k, bf16."""
    b, h, w, c = shape
    return 2 * (b * h * w * c * NORM_MAPS[variant] + 2 * c
                + (b * c if variant in ("scaled", "skip_gate") else 0)
                + (c if variant.startswith("skip") else 0))


def _bf16_ulps(torch, got, want, y, weight, bias):
    """The largest distance of the bf16 LayerNorm ``got`` from ``want`` in
    bf16 ulps of ``want``, each ulp grown by 2^-16 of the terms the last
    step sums, |gamma (y - mean) rstd| + |beta|: an fp32-level difference
    of mean and rstd shows as many ulps of a value that cancels to near
    0, where a bf16 error in the terms would be 2^-8 of them."""
    g, w = got.float(), want.float()
    ulp = torch.where(w == 0, 2.0 ** -133,
                      2.0 ** (torch.floor(torch.log2(w.abs())) - 7))
    y = y.float()
    d = (y - y.mean(-1, keepdim=True)) * torch.rsqrt(
        y.var(-1, unbiased=False, keepdim=True) + 1e-5)
    terms = (weight.float() * d).abs() + bias.float().abs()
    return float(((g - w).abs() / (ulp + 2.0 ** -16 * terms)).max())


def phase_kernel_i(torch, smi, report):
    """Phase 18: kernel I against its plain twin at the HAT cell's chunk
    in its three variants, its times, and the HAT stream's launch counts
    and outputs against the benchmark's reference."""
    import gc

    import torch.nn.functional as F

    from waifu2x_tensorrt_tpu_torch.ops import hat_norm as hn

    gc.collect()  # the earlier phases' programs and pools
    torch.cuda.empty_cache()
    row = report["I"] = {}
    worst = 0.0
    c = NORM_SHAPE[-1]
    for mode, variant in enumerate(NORM_MAPS):
        x, r, z, s, w, b, k = _add_norm_inputs(torch, NORM_SHAPE, variant,
                                               seed=18 + mode)
        kw = {"z": z, "s": s, "k": k}
        want_y, want_n = hn.add_norm_plain(x, r, w, b, 1e-5, **kw)
        y, n = hn.add_norm(x, r, w, b, 1e-5, **kw)
        same = torch.equal(y.view(torch.int16), want_y.view(torch.int16))
        ulps = _bf16_ulps(torch, n, want_n, want_y, w, b)
        err = float((n.float() - want_n.float()).abs().max())
        worst = max(worst, err)
        del y, n, want_y, want_n
        torch.cuda.empty_cache()
        km = _median_ms(lambda: hn.add_norm(x, r, w, b, 1e-5, **kw))
        pm = _median_ms(lambda: hn.add_norm_plain(x, r, w, b, 1e-5, **kw))
        lm = _median_ms(lambda: F.layer_norm(x, (c,), w, b, 1e-5))
        bms, by = _bound(_add_norm_work(NORM_SHAPE, variant))
        occ = hn.occupancy(c, mode)
        ok = same and ulps <= 1.0
        print(f"  phase 18 I {variant} {NORM_SHAPE}: y byte-equal to the "
              f"twin: {same}; n within {ulps:.2f} bf16 ulp of it (max |d| "
              f"{err:.3e}): {'ok' if ok else 'FAIL'}; {km:.4f} ms (bound "
              f"{bms:.4f} ms by {by}, {100 * bms / km:.1f}% of it); plain "
              f"twin {pm:.4f} ms; F.layer_norm alone {lm:.4f} ms; "
              f"{occ['registers']} registers, {occ['ctas_per_sm']} CTAs an "
              f"SM", flush=True)
        if not ok:
            raise AssertionError(f"phase 18: kernel I {variant} is not its "
                                 f"twin")
        # the main path's inputs: rows at the trunk's pitch, NaN in the
        # pads of x, r, z and s (B, P)
        xp, rp, zp, sp = (None if t is None else _at_pitch(torch, t, 1, c)
                          for t in (x, r, z, s))
        del x, r, z, s
        torch.cuda.empty_cache()
        kw = {"z": zp, "s": sp, "k": k}
        want_y, want_n = hn.add_norm_plain(xp, rp, w, b, 1e-5, **kw)
        y, n = hn.add_norm(xp, rp, w, b, 1e-5, **kw)
        p = xp.shape[-1]
        same = torch.equal(y[..., :c].contiguous().view(torch.int16),
                           want_y[..., :c].contiguous().view(torch.int16))
        ulps = _bf16_ulps(torch, n[..., :c], want_n[..., :c],
                          want_y[..., :c], w, b)
        err = float((n[..., :c].float() - want_n[..., :c].float()).abs()
                    .max())
        worst = max(worst, err)
        zero = not n[..., c:].any() and (y is xp or not y[..., c:].any())
        del y, n, want_y, want_n
        torch.cuda.empty_cache()
        wm = _median_ms(lambda: hn.add_norm(xp, rp, w, b, 1e-5, **kw))
        wms, _ = _bound(_add_norm_work((*NORM_SHAPE[:3], p), variant))
        wocc = hn.occupancy(p, mode)
        ok = same and ulps <= 1.0 and zero
        print(f"  phase 18 I {variant} {(*NORM_SHAPE[:3], p)} channels {c} "
              f"(NaN pads): y byte-equal to the twin on the real channels: "
              f"{same}; n within {ulps:.2f} bf16 ulp of it (max |d| "
              f"{err:.3e}); the pads of y and n zero: {zero}: "
              f"{'ok' if ok else 'FAIL'}; {wm:.4f} ms (bound of its "
              f"{p}-wide bytes {wms:.4f} ms, {100 * wms / wm:.1f}% of it); "
              f"{wocc['registers']} registers, {wocc['ctas_per_sm']} CTAs "
              f"an SM", flush=True)
        if not ok:
            raise AssertionError(f"phase 18: kernel I {variant} at pitch "
                                 f"{p} is not its twin")
        # the scaled add is the main row (36 of 86 launches, 5 maps)
        key = "" if variant == "scaled" else f"{variant}_"
        row.update({f"{key}ms": km, f"{key}padded_ms": wm,
                    f"{key}plain_ms": pm, f"{key}bound_ms": bms,
                    f"{key}library_ms": lm,
                    f"{key}registers": occ["registers"],
                    f"{key}ctas_per_sm": occ["ctas_per_sm"]})
        if not key:
            row["bound_by"] = by
        del xp, rp, zp, sp, w, b, k
        torch.cuda.empty_cache()
    row["max_abs_err"] = worst
    return _cell_stream(torch, "phase 18", "hat-photo-4x-bf16",
                        "hat4x-480p-stream",
                        {"launches_I": 86, "padded_I": 86},
                        seed=2 ** 31 + 18)


def _cell_stream(torch, label, config_name, cell, want, seed):
    """The benchmark cell's model on its seeded weights (``benchmark_
    torch/lib/weights``, from a seed of the benchmark's size) streaming 8
    of its 720 x 480 pictures: every ``w2x.model`` span a graph replay
    with the counts ``want``, each ``launches_<letter>`` of them also the
    wrapper's count over the spans, and two outputs against the
    benchmark's plain float32 reference within the cell's limits
    (``benchmark_torch/limits/<cell>.json``: mean and largest absolute
    byte difference). Returns the launch counts of the stream."""
    import gc
    from pathlib import Path

    from benchmark_torch.lib import weights as bench_weights
    from benchmark_torch.reference.render import render as reference
    from waifu2x_tensorrt_tpu_torch.engine.config import Precision
    from waifu2x_tensorrt_tpu_torch.utils import profiling

    gc.collect()
    torch.cuda.empty_cache()
    root = Path(__file__).resolve().parent / "benchmark_torch"
    config = json.loads((root / "configs" / f"{config_name}.json")
                        .read_text())
    limits = json.loads((root / "limits" / f"{cell}.json").read_text())
    family = config["family"]
    params = bench_weights.make_params(config, seed, "cuda")
    models = (Path(__file__).resolve().parent / "build"
              / f"chip_smoke_{config['arch']}")
    bench_weights.write_weight_file(models, config, params)
    up = _upscaler(family, config["scale"], config["noise"], Precision.FP16,
                   config["tile"], config["batch"], models_dir=str(models))
    g = bench_weights.generator(seed, 1, "cuda")
    frames = [bench_weights.make_picture((480, 720), g, "cuda")
              for _ in range(8)]
    session = up.open_stream((480, 720))
    session.warm()
    counters = _zero_counters()
    profiling.reset()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        outs = [o for f in frames for o in session.submit(f)]
        outs += session.flush()
        torch.cuda.synchronize()
    spans = [sp.counts for sp in profiling.records() if sp.name == "model"]
    profiling.reset()
    n = {k: f.launches for k, f in counters.items()}
    good = (len(outs) == len(frames) and spans and all(
        sp.get("program") == "replay"
        and all(sp.get(k) == v for k, v in want.items()) for sp in spans)
        and all(n[k[len("launches_"):]] == v * len(spans)
                for k, v in want.items() if k.startswith("launches_")))
    counts = ", ".join(f"{k} {v}" for k, v in want.items())
    print(f"  {label} {family} {config['scale']}x stream: {len(frames)} "
          f"720 x 480 pictures, {len(spans)} model spans, each a replay "
          f"with {counts}: {'ok' if good else 'FAIL'}; launch counts {n}",
          flush=True)
    if not good:
        raise AssertionError(f"{label}: the {family} stream's model spans "
                             f"{spans}")
    del session, up
    gc.collect()
    torch.cuda.empty_cache()
    for k in (0, len(frames) - 1):
        ref = reference(torch.from_numpy(frames[k]).cuda(), params, config)
        d = (outs[k].to(torch.int32) - ref.to(torch.int32)).abs()
        got = {"mean_abs_lsb": float(d.double().mean()),
               "max_abs_lsb": float(d.max())}
        ok = all(got[key] <= limits[key] for key in got)
        print(f"  {label} {family} picture {k} against the plain float32 "
              f"reference: mean |d| {got['mean_abs_lsb']:.4f} LSB (limit "
              f"{limits['mean_abs_lsb']}), max |d| {got['max_abs_lsb']:.0f} "
              f"(limit {limits['max_abs_lsb']:.0f}): "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"{label}: {family} picture {k} outside "
                                 f"the cell's limits")
    return n


def _channel_chain(torch, qkv, tau, nh):
    """DAT's own torch chain for the channel attention (its
    ``Adaptive_Channel_Attention``: ``F.normalize`` of q and k along the
    tokens, q k^T times the temperature, softmax, A v, the permute back)
    in qkv's dtype: a yardstick the port never calls."""
    import torch.nn.functional as F

    b, h, w, c3 = qkv.shape
    c = c3 // 3
    t = qkv.reshape(b, h * w, 3, nh, c // nh).permute(2, 0, 3, 4, 1)
    q, k, v = t.unbind(0)  # (B, nh, d, N)
    temp = tau.to(qkv.dtype)[:, None, None]

    def run():
        a = F.normalize(q, dim=-1) @ F.normalize(k, dim=-1).transpose(-2, -1)
        a = (a * temp).softmax(dim=-1)
        return (a @ v).permute(0, 3, 1, 2).reshape(b, h, w, c)
    return run


def phase_kernel_j(torch, smi, report):
    """Phase 19: kernel J and kernel G's split windows against their plain
    twins at the DAT cell's chunk, their times, and the DAT stream's
    launch counts and outputs against the benchmark's reference."""
    import gc

    from waifu2x_tensorrt_tpu_torch.ops import channel_attention as ca
    from waifu2x_tensorrt_tpu_torch.ops import hat_attention as ha

    gc.collect()  # the earlier phases' programs and pools
    torch.cuda.empty_cache()
    b, h, w, c, nh = 16, 256, 256, 180, 6
    tokens = b * h * w

    # G on DAT's split windows: heads 0-2 in 8 x 32, 3-5 in 32 x 8
    row = report["G"]
    for shift in ((0, 0), (4, 16)):
        qkv, _ = _hat_inputs(torch, b, h, w, c, nh, 0, seed=19 + shift[0])
        g = torch.Generator(device="cuda").manual_seed(19 + shift[1])
        table = 0.2 * torch.randn((ha.table_rows(ha.RECT, 0), nh),
                                  generator=g, device="cuda")
        kw = {"num_heads": nh, "window": ha.RECT, "shift": shift,
              "split": True}
        q16 = qkv.bfloat16()
        k16 = ha.hat_attention(q16, table, **kw)
        p32 = ha.hat_attention_plain(qkv, table, **kw)
        del qkv
        torch.cuda.empty_cache()
        p16 = ha.hat_attention_plain(q16, table, **kw).float()
        e_k = float((k16.float() - p32).abs().max())
        e_p = float((p16 - p32).abs().max())
        same = float((k16.float() != p16).float().mean())
        del p16
        torch.cuda.empty_cache()
        ok = e_k <= max(2 * e_p, 0.02)
        label = f"G split 8x32 / 32x8 ({b}, {h}, {w}, 540) shift {shift}"
        print(f"  phase 19 {label}: |k16-p32|={e_k:.3e} <= max(2*"
              f"{e_p:.3e}, 0.02); values differing from the bf16 twin "
              f"{same:.2e}: {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"phase 19: kernel G {label} disagrees")
        # the main path's inputs: qkv at the trunk's pitch, NaN pads
        wq = _at_pitch(torch, q16, 3, c)
        wide = ha.hat_attention(wq, table, channels=c, **kw)
        e_w, equal, zero, ok = _padded_case(torch, wide, k16, c, p32, e_p)
        label = (f"G split 8x32 / 32x8 ({b}, {h}, {w}, {wq.shape[-1]}) "
                 f"channels {c} shift {shift}")
        print(f"  phase 19 {label}: |k16-p32|={e_w:.3e} on the real "
              f"channels; those byte-equal to the pitch-{c} launch: "
              f"{equal}; the pad zero: {zero}: {'ok' if ok else 'FAIL'}",
              flush=True)
        del wide, k16, p32
        torch.cuda.empty_cache()
        if not ok:
            raise AssertionError(f"phase 19: kernel G {label} disagrees")
        km = _median_ms(lambda: ha.hat_attention(q16, table, **kw))
        wm = _median_ms(lambda: ha.hat_attention(wq, table, channels=c,
                                                 **kw))
        key = "rect_" if any(shift) else "rect_unshifted_"
        row[f"{key}ms"] = km
        row[f"{key}padded_ms"] = wm
        row[f"{key}max_abs_err"] = max(e_k, e_w)
        if any(shift):
            pm = _median_ms(lambda: ha.hat_attention_plain(q16, table, **kw),
                            iters=3, warmup=1)
            bms, by = _bound(*_hat_work(b, h, w, c, nh, 0))
            row.update(rect_plain_ms=pm, rect_bound_ms=bms, rect_bound_by=by)
            print(f"  phase 19 G split shift {shift}: {km:.4f} ms (bound "
                  f"{bms:.4f} ms by {by}, {100 * bms / km:.1f}% of it); at "
                  f"the trunk's pitch {wm:.4f} ms ({100 * bms / wm:.1f}%); "
                  f"plain twin {pm:.4f} ms", flush=True)
        else:
            print(f"  phase 19 G split unshifted: {km:.4f} ms; at the "
                  f"trunk's pitch {wm:.4f} ms", flush=True)
        del q16, wq, table
        torch.cuda.empty_cache()

    # J: correlated q and k, temperatures 1 to 16
    g = torch.Generator(device="cuda").manual_seed(19)
    qkv = torch.randn((b, h, w, 3 * c), generator=g, device="cuda")
    qkv[..., :2 * c] += 0.5 * torch.randn((b, 1, 1, 2 * c), generator=g,
                                          device="cuda")
    tau = torch.tensor([1.0, 2.0, 4.0, 8.0, 12.0, 16.0], device="cuda")
    q16 = qkv.bfloat16()
    k16 = ca.channel_attention(q16, tau, num_heads=nh)
    again = ca.channel_attention(q16, tau, num_heads=nh)
    stable = torch.equal(k16, again)
    p32 = ca.channel_attention_plain(qkv, tau, num_heads=nh)
    del qkv, again
    torch.cuda.empty_cache()
    p16 = ca.channel_attention_plain(q16, tau, num_heads=nh).float()
    e_k = float((k16.float() - p32).abs().max())
    e_p = float((p16 - p32).abs().max())
    same = float((k16.float() != p16).float().mean())
    del p16
    torch.cuda.empty_cache()
    ok = stable and e_k <= max(2 * e_p, 0.02)
    print(f"  phase 19 J ({b}, {h}, {w}, 540): |k16-p32|={e_k:.3e} <= max(2*"
          f"{e_p:.3e}, 0.02); values differing from the bf16 twin "
          f"{same:.2e}; the same bytes on a second call: {stable}: "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("phase 19: kernel J disagrees with its twin")
    # the main path's inputs: qkv at the trunk's pitch, NaN pads
    wq = _at_pitch(torch, q16, 3, c)
    wide = ca.channel_attention(wq, tau, num_heads=nh, channels=c)
    e_w, equal, zero, ok = _padded_case(torch, wide, k16, c, p32, e_p)
    print(f"  phase 19 J ({b}, {h}, {w}, {wq.shape[-1]}) channels {c}: "
          f"|k16-p32|={e_w:.3e} on the real channels; those byte-equal to "
          f"the pitch-{c} call: {equal}; the pad zero: {zero}: "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    del wide, k16, p32
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("phase 19: kernel J at the trunk's pitch "
                             "disagrees with its twin")
    km = _median_ms(lambda: ca.channel_attention(q16, tau, num_heads=nh))
    wm = _median_ms(lambda: ca.channel_attention(wq, tau, num_heads=nh,
                                                 channels=c))
    pm = _median_ms(lambda: ca.channel_attention_plain(q16, tau,
                                                       num_heads=nh),
                    iters=3, warmup=1)
    lm = _median_ms(_channel_chain(torch, q16, tau, nh))
    bms, by = _bound(tokens * 4 * c * 2, tc_flops=2 * 2 * tokens * c * 30)
    print(f"  phase 19 J ({b}, {h}, {w}, 540): {km:.4f} ms (bound "
          f"{bms:.4f} ms by {by}, {100 * bms / km:.1f}% of it); at the "
          f"trunk's pitch {wm:.4f} ms ({100 * bms / wm:.1f}%); plain twin "
          f"{pm:.4f} ms; DAT's torch chain {lm:.4f} ms", flush=True)
    report["J"] = {"max_abs_err": max(e_k, e_w), "ms": km, "padded_ms": wm,
                   "plain_ms": pm, "bound_ms": bms, "bound_by": by,
                   "library_ms": lm}
    del q16, wq, tau
    torch.cuda.empty_cache()
    return _cell_stream(torch, "phase 19", "dat-photo-4x-bf16",
                        "dat4x-480p-stream",
                        {"launches_G": 18, "rect_G": 18, "padded_G": 18,
                         "launches_J": 18, "padded_J": 18,
                         "launches_I": 74, "padded_I": 74},
                        seed=2 ** 31 + 19)


SCAN_SHAPE = (16, 256, 256, 360)  # the mambair4x-480p-stream cell's u


def _scan_inputs(torch, shape, seed):
    """bf16 u and x_dbl (4 x (12 + 2 x 16) a token), the fp32 tables of
    kernel K and SS2D's gate (bf16 z, out_norm's fp32 weight and bias) on
    the card, at the benchmark's seeded scale: u and x_dbl of std 1 (u
    shifted by 0.3, as SiLU leaves it), dt weights N(0, 1 / 12), dt bias
    -4.6 + N(0, 0.5^2) (delta from about 0.001 to 0.1), A from -1 to -16
    (the published init), D and the LN weight about 1."""
    from waifu2x_tensorrt_tpu_torch.ops.selective_scan import RANK, STATE

    g = torch.Generator(device="cuda").manual_seed(seed)
    b, h, w, d = shape
    e = RANK + 2 * STATE

    def randn(*size):
        return torch.randn(size, generator=g, device="cuda")

    u = (0.3 + randn(b, h, w, d)).bfloat16()
    xdbl = randn(b, h, w, 4 * e).bfloat16()
    dtw = randn(4, d, RANK) / RANK ** 0.5
    dtb = -4.6 + 0.5 * randn(4, d)
    a = -torch.arange(1, STATE + 1, device="cuda", dtype=torch.float32
                      ).expand(4, d, STATE).contiguous()
    ds = 1.0 + 0.1 * randn(4, d)
    gate = (randn(b, h, w, d).bfloat16(), 1 + 0.1 * randn(d),
            0.1 * randn(d), 1e-5)
    return u, xdbl, dtw, dtb, a, ds, gate


def _scan_work(shape):
    """(bytes, state updates) of one kernel-K call: u and x_dbl read once,
    y written once, bf16; tokens x 4 x D x 16 updates."""
    from waifu2x_tensorrt_tpu_torch.ops.selective_scan import RANK, STATE

    b, h, w, d = shape
    tokens = b * h * w
    return (2 * tokens * (2 * d + 4 * (RANK + 2 * STATE)),
            tokens * 4 * d * STATE)


UPDATES_S = 132 * 1.98e9 * 32  # benchmark_torch/counts/mambair.UPDATES_S


def phase_kernel_k(torch, smi, report):
    """Phase 20: kernel K against its plain twin at the MambaIR cell's
    chunk, each direction's fp32 output (the scratch planes) and the
    summed bf16 map, its times, kernel I's skip modes in MambaIR's
    stream, and the MambaIR stream's launch counts and outputs against
    the benchmark's reference."""
    import gc

    from waifu2x_tensorrt_tpu_torch.ops import selective_scan as ss

    gc.collect()
    torch.cuda.empty_cache()
    b, h, w, d = SCAN_SHAPE
    ops = _scan_inputs(torch, SCAN_SHAPE, seed=20)
    t0 = time.perf_counter()
    y = ss.selective_scan(*ops)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    again = ss.selective_scan(*ops)
    stable = torch.equal(y.view(torch.int16), again.view(torch.int16))
    del again
    planes = ss._partials(y.device, 4 * y.numel())[:4 * y.numel()].view(
        4, b, h * w, d)
    t0 = time.perf_counter()
    ys = ss.scan_directions(*ops[:6])   # (B, 4, L, D)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    order = ss.scan_order(h, w, y.device)
    worst_dir = 0.0
    lines = []
    for k in range(4):
        want = torch.empty((b, h * w, d), device="cuda")
        want[:, order[k]] = ys[:, k]
        err = float((planes[k] - want).abs().max())
        scale = float(want.abs().max())
        worst_dir = max(worst_dir, err / scale)
        lines.append(f"direction {k} max |d| {err:.3e} of max |y| "
                     f"{scale:.3f}")
        del want
    want_y = ss.combine(ys, h, w, torch.float32, ops[6])
    del ys
    torch.cuda.empty_cache()
    e_k = float((y.float() - want_y).abs().max())
    e_p = float((want_y.bfloat16().float() - want_y).abs().max())
    del want_y
    torch.cuda.empty_cache()
    ok = stable and worst_dir <= 1e-4 and e_k <= 2 * e_p
    print(f"  phase 20 K {SCAN_SHAPE}: each direction's fp32 output "
          f"against the twin's ({'; '.join(lines)}; worst {worst_dir:.2e} "
          f"of its max, limit 1e-4); the gated bf16 map LN(y) SiLU(z) "
          f"|k - p32| {e_k:.3e} <= 2 x the bf16 rounding of the twin's "
          f"{e_p:.3e}; the same bytes on a second call: {stable}: "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("phase 20: kernel K disagrees with its twin")
    km = _median_ms(lambda: ss.selective_scan(*ops))
    nbytes, upd = _scan_work(SCAN_SHAPE)
    bms = 1e3 * max(nbytes / 3.35e12, upd / UPDATES_S)
    by = "updates" if upd / UPDATES_S > nbytes / 3.35e12 else "bytes"
    print(f"  phase 20 K {SCAN_SHAPE}: {km:.4f} ms (bound {bms:.4f} ms by "
          f"{by}, {100 * bms / km:.1f}% of it); "
          f"first call {first_s:.2f} s "
          f"(the library's load included); plain twin {1e3 * plain_s:.1f} "
          f"ms (one call, its chunked closed form)", flush=True)
    report["K"] = {"max_abs_err": e_k, "ms": km, "plain_ms": 1e3 * plain_s,
                   "bound_ms": bms, "bound_by": by, "library_ms": None,
                   "direction_rel_err": worst_dir}
    del ops, y
    torch.cuda.empty_cache()
    return _cell_stream(torch, "phase 20", "mambair-photo-4x-bf16",
                        "mambair4x-480p-stream",
                        {"launches_K": 36, "launches_I": 74,
                         "skip_I": 66, "padded_I": 74},
                        seed=2 ** 31 + 20)


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
    n6 = phase_network_gate(torch)
    print("phase 7 fused_block=False:", flush=True)
    n7 = phase_fused_block_false(torch, smi, report)
    print("phase 8 kernels D and E vs plain:", flush=True)
    n8 = phase_kernels_de(torch, report)
    print("phase 9 packed-x main path:", flush=True)
    n9 = phase_packed_x(torch, smi, report, out5)
    print("phase 10 kernel F (int8/bf16 mma probe) vs plain:", flush=True)
    n10 = phase_kernel_f(torch, smi, report)
    print("phase 11 cunet/art 2x and 1x, full width:", flush=True)
    n11 = phase_cunet(torch, smi, report)
    print("phase 12 TTA and whole-frame swin_unet, full width:", flush=True)
    n12 = phase_tta_whole_frame(torch, smi, report)
    print("phase 13 the CLI: video, segments, image folder, alpha:",
          flush=True)
    t0 = time.perf_counter()
    n13 = phase_cli(torch, smi, report)
    print(f"  phase 13 took {time.perf_counter() - t0:.1f} s", flush=True)
    print("phase 14 .onnx artifacts: build, verified and graph-exact "
          "serving:", flush=True)
    t0 = time.perf_counter()
    n14 = phase_onnx(torch, smi, report)
    print(f"  phase 14 took {time.perf_counter() - t0:.1f} s", flush=True)
    print("phase 15 compiled programs (captured CUDA graphs):", flush=True)
    t0 = time.perf_counter()
    n15 = phase_programs(torch, smi, report)
    print(f"  phase 15 took {time.perf_counter() - t0:.1f} s", flush=True)
    print("phase 16 kernel G (HAT window attention) and the HAT stream:",
          flush=True)
    n16 = phase_kernel_g(torch, smi, report)
    print("phase 17 kernel H (cunet's conv epilogue) and the cunet stream:",
          flush=True)
    n17 = phase_kernel_h(torch, smi, report)
    print("phase 18 kernel I (HAT's residual sums and LayerNorm) and the "
          "HAT stream:", flush=True)
    n18 = phase_kernel_i(torch, smi, report)
    print("phase 19 kernel J (DAT's channel attention), kernel G's split "
          "windows and the DAT stream:", flush=True)
    n19 = phase_kernel_j(torch, smi, report)
    print("phase 20 kernel K (MambaIR's selective scan) and the MambaIR "
          "stream:", flush=True)
    n20 = phase_kernel_k(torch, smi, report)
    # launch counts of the new paths, as extra keys on B's and C's rows
    report["C"].update(
        launches_cunet_t256_still=n11["a"],
        launches_cunet_whole_frame=n11["b"], launches_cunet_1080p=n11["c"],
        launches_cunet_1x=n11["d"], launches_tta=n12["a"]["C"],
        launches_rect_tta=n12["b"]["C"], launches_whole_frame=n12["c"]["C"])
    report["B"].update(
        launches_tta=n12["a"]["B"], launches_rect_tta=n12["b"]["B"],
        launches_whole_frame=n12["c"]["B"])
    for key, n in n13.items():
        report["B"][f"launches_cli_{key}"] = n["B"]
        report["C"][f"launches_cli_{key}"] = n["C"]
    for key, n in n14.items():
        report["B"][f"launches_onnx_{key}"] = n["B"]
        report["C"][f"launches_onnx_{key}"] = n["C"]
    report["B"]["launches_fuse_frame_replay"] = n15["B"]
    report["B"]["fp32_launches_tf32_frame"] = n6["B"]
    report["C"]["launches_fuse_frame_replay"] = n15["C"]
    report["G"]["launches_dat_stream"] = n19["G"]
    report["I"]["launches_dat_stream"] = n19["I"]
    report["I"]["launches_mambair_stream"] = n20["I"]

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
    g_run = ("phase 16: hat/photo 4x, bf16, tile 256, batch 16, 8 "
             "streamed 720 x 480 frames after the warm")
    h_run = ("phase 17: cunet/art 2x noise 1, bf16, tile 256, batch 16, 4 "
             "streamed 1080p frames after the warm")
    i_run = ("phase 18: hat/photo 4x, bf16, tile 256, batch 16, 8 "
             "streamed 720 x 480 pictures after the warm")
    j_run = ("phase 19: dat/photo 4x, bf16, tile 256, batch 16, 8 "
             "streamed 720 x 480 pictures after the warm")
    k_run = ("phase 20: mambair/photo 4x, bf16, tile 256, batch 16, 8 "
             "streamed 720 x 480 pictures after the warm")
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
        "G": ("hat_attention", src + "hat_attention.cu",
              "none (the JAX package has no HAT)", n16["G"], g_run),
        "H": ("bias_act", src + "cunet_epilogue.cu",
              "none (XLA fused cunet's conv epilogue on the TPU)", n17["H"],
              h_run),
        "I": ("add_norm", src + "hat_norm.cu",
              "none (the JAX package has no HAT)", n18["I"], i_run),
        "J": ("channel_attention", src + "dat_channel_attention.cu",
              "none (the JAX package has no DAT)", n19["J"], j_run),
        "K": ("selective_scan", src + "selective_scan.cu",
              "none (the JAX package has no MambaIR)", n20["K"], k_run),
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
                                      "queued_", "launches_", "self_",
                                      "plain_ms_", "registers", "ctas_",
                                      "norm_", "add_", "rect_", "skip_",
                                      "direction_"))}}
               for k in ("A", "B", "C", "D", "E", "F", "G", "H", "I", "J",
                         "K")]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
