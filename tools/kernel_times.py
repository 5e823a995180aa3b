"""Times of kernels A to J through their wrappers on one NVIDIA GPU, by
``chip_smoke.py``'s method, from this or another version of the package.

    python3 tools/kernel_times.py [--root DIR]

Takes the timing method, the inputs and the bounds from ``chip_smoke.py``
(``_median_ms``: per call, the median of 10 samples of 10 calls in a row
under CUDA events) and prints one line per kernel at ``chip_smoke.py``'s
shapes, each beside its bound and its share of it:

- A in bf16 and fp32 at (BW 4096, C 96) and (1024, 192), shift 4, beside
  ``F.scaled_dot_product_attention`` with the bias and the shift mask as
  one float mask of the same dtype (a yardstick the port never calls);
- E in bf16 and fp32 at (BW 4096, nh 3) on the same values, beside SDPA;
- B in bf16 and fp32 on prepared operands at both shapes, beside the
  chain of library calls ``chip_smoke._block_chain`` in the same dtype;
- B in bf16 and fp32 on the model's activations (``swin_block_bhwc``,
  where the version has it) at the same windows, (16, 128, 128, 96) and
  (16, 64, 64, 192), shift 4, beside the windowed kernel plus the roll,
  window split, merge and roll back (torch ops, timed alone) that the
  activation layout replaces;
- each fp32 row against its bound at 67 TFLOP/s (TF32 is off);
- C on the 720p -> 4x plan, alone (``finalize_gather`` on a table built
  once) and through the wrapper per call (table upload included); D in
  bf16 at r 4, (16, 256, 256, 48), beside the chain of library calls
  ``chip_smoke._head_pack_chain`` (clamp, ``pixel_shuffle`` and two
  permutes, D's exact bytes; a yardstick the port never calls);
- F (the int8/bf16 probe) at the probe's ideal and qkv shapes, R 2048,
  bf16 and int8, by the probe's method (``int8_probe.time_call``), each
  with its share of the dense peak, beside R x one bf16 ``matmul`` / one
  ``_int_mm`` (``int8_probe.library_calls``);
- G (HAT's window attention, where the version has it) in bf16 on the
  hat4x-480p-stream cell's (16, 256, 256, 540) qkv, 6 heads of 30, self
  with shift 8 and overlapping, beside its plain twin on the card and SDPA
  over the windows with the bias and region mask as one float mask
  (``chip_smoke._hat_sdpa``, a yardstick the port never calls);
- H (cunet's conv epilogue, where the version has it) in bf16 and fp32
  on the cunet2x-1080p-stream cell's path (``chip_smoke.
  EPILOGUE_CASES``: (16, 476, 476, 64) with the leaky ReLU, (16, 444,
  444, 64) with it and the skip cropped by 16, and the C-3 conv_bottoms
  (16, 480, 480, 3) with the bias alone and (16, 440, 440, 3) with the
  skip cropped by 20 and the clamp), in place, beside its plain twin and
  the torch ops it replaces (``epilogue_ops``);
- I (HAT's residual sums and their LayerNorm, where the version has it)
  on the hat4x-480p-stream cell's chunk (``chip_smoke.NORM_SHAPE``:
  (16, 256, 256, 180) bf16) in each variant (the norm alone, the add, the
  scaled add), beside its plain twin and ``F.layer_norm`` alone on the
  same map;
- G on DAT's split windows (where the version has them: heads 0-2 in 8 x
  32 windows, 3-5 in 32 x 8, shifted by (4, 16)) and J (DAT's channel
  attention, where the version has it) in bf16 on the dat4x-480p-stream
  cell's (16, 256, 256, 540) qkv, 6 heads of 30, each beside its plain
  twin on the card;
- G (self, overlapping, split), I (each variant) and J again with the
  trunk carried at the row pitch HAT and DAT run (``models/layers.pitch``:
  192 for C = 180; where the version has it), each against the bound of
  the same pitch-C work;
- the trunk's library GEMMs (qkv, proj, fc1, fc2 at a chunk's 1,048,576
  tokens) and 3x3 convs (C -> C / 3, C / 3 -> C, C -> C on 16 tiles of
  256) at row pitch C = 180, 184 (C up to a multiple of 8) and 192 (of
  64), each with the kernels the library picked (``torch.profiler``);
  torch alone, so the same for every ``--root``.

It goes through the wrappers only, so ``--root DIR`` can import
``waifu2x_tensorrt_tpu_torch`` from an unpacked other version (``git
archive``) while the method stays this checkout's: run parent, change,
change, parent in one call to compare two versions. Needs a CUDA device
and nvcc; exits 1 without a device.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _rolled_copies(torch, x, shift):
    """What a shifted block did around the windowed kernel B: roll by
    -shift, window split (a copy), window merge (a copy), roll back."""
    b, h, w, c = x.shape
    x = torch.roll(x, (-shift, -shift), dims=(1, 2))
    xw = x.reshape(b, h // 8, 8, w // 8, 8, c).permute(
        0, 1, 3, 2, 4, 5).reshape(-1, 64, c).contiguous()
    out = xw.reshape(b, h // 8, w // 8, 8, 8, c).permute(
        0, 1, 3, 2, 4, 5).reshape(b, h, w, c)
    return torch.roll(out, (shift, shift), dims=(1, 2))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=ROOT)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs  # this checkout's method, inputs and bounds

    sys.path.insert(0, str(args.root.resolve()))
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import waifu2x_tensorrt_tpu_torch as pkg
    from waifu2x_tensorrt_tpu_torch.ops import head_pack as hp
    from waifu2x_tensorrt_tpu_torch.ops import swin_block as sb
    from waifu2x_tensorrt_tpu_torch.ops import window_attention as wa

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; package from {Path(pkg.__file__).parents[1]}",
          flush=True)

    def show(label, fn, work, yardstick=None, yard_name="SDPA"):
        ms = cs._median_ms(fn)
        fp32 = " fp32 " in label
        bms, by = cs._bound(*work, tc_rate=cs.FP32_FLOPS if fp32 else None)
        line = (f"{label}: {ms:.4f} ms (bound {bms:.4f} ms by {by}, "
                f"{100 * bms / ms:.1f}% of it)")
        if yardstick is not None:
            lm = cs._median_ms(yardstick)
            line += (f"; {yard_name} {lm:.4f} ms, kernel / {yard_name} "
                     f"{ms / lm:.2f}x")
        print(line, flush=True)
        return ms

    for bw, c, nh in ((4096, 96, 3), (1024, 192, 6)):
        x, qkv, params, bias, flags = cs._block_inputs(
            torch, bw, c, nh, torch.float32, seed=c + bw)
        masks = {dt: cs._sdpa_mask(torch, bias, flags, 4, dt)
                 for dt in (torch.bfloat16, torch.float32)}
        for inp in (qkv.bfloat16(), qkv):
            name = "bf16" if inp.dtype == torch.bfloat16 else "fp32"
            q, k, v = inp.view(bw, 64, 3, nh, 32).permute(2, 0, 3, 1, 4)
            show(f"kernel A {name} BW {bw} C {c}",
                 lambda: wa.fused_window_attention_qkv(
                     inp, bias, flags, num_heads=nh, shift=4),
                 cs._attention_work(bw, nh, inp.element_size()),
                 lambda: F.scaled_dot_product_attention(
                     q, k, v, attn_mask=masks[inp.dtype]))
        if bw == 4096:  # E on the same values, in its unpacked layout
            heads = [t.reshape(bw, 64, nh, 32).transpose(1, 2).contiguous()
                     for t in qkv.chunk(3, dim=-1)]
            for hs in ([t.bfloat16() for t in heads], heads):
                name = "bf16" if hs[0].dtype == torch.bfloat16 else "fp32"
                show(f"kernel E {name} BW {bw} nh {nh}",
                     lambda: wa.fused_window_attention(
                         *hs, bias, flags, shift=4),
                     cs._attention_work(bw, nh, hs[0].element_size()),
                     lambda: F.scaled_dot_product_attention(
                         *hs, attn_mask=masks[hs[0].dtype]))
        for xs in (x.bfloat16(), x):
            name = "bf16" if xs.dtype == torch.bfloat16 else "fp32"
            ops = sb.block_operands(params, bias, xs.dtype)
            chain = cs._block_chain(torch, params, c, nh, xs.dtype)
            windowed = show(
                f"kernel B {name} BW {bw} C {c} (prepared operands)",
                lambda: sb.swin_block_prepared(xs, ops, flags, shift=4),
                cs._block_work(bw, c, nh, xs.element_size()),
                lambda: chain(xs, masks[xs.dtype]), "library chain")
            side = 128 if c == 96 else 64
            act = xs.reshape(16, side // 8, side // 8, 8, 8, c).permute(
                0, 1, 3, 2, 4, 5).reshape(16, side, side, c).contiguous()
            copies = cs._median_ms(lambda: _rolled_copies(torch, act, 4))
            print(f"kernel B {name} windowed + roll and window copies "
                  f"(16, {side}, {side}, {c}) shift 4: {windowed:.4f} + "
                  f"{copies:.4f} = {windowed + copies:.4f} ms", flush=True)
            if hasattr(sb, "swin_block_bhwc"):
                show(f"kernel B {name} on activations (16, {side}, {side}, "
                     f"{c}) shift 4",
                     lambda: sb.swin_block_bhwc(act, ops, shift=4),
                     cs._block_work(bw, c, nh, xs.element_size()))

    fin, plan, outs = cs._finalize_case(torch)
    work = cs._finalize_work(plan, outs[0].element_size())
    show(f"kernel C alone 720p -> 4x (T {plan.tile_count})",
         cs._finalize_alone(torch, plan, outs)[0], work)
    show(f"kernel C wrapper per call 720p -> 4x (T {plan.tile_count})",
         lambda: fin(*outs), work)
    z = (torch.rand((16, 256, 256, 48), device="cuda") * 1.6
         - 0.3).bfloat16()
    show("kernel D bf16 r 4 (16, 256, 256, 48)",
         lambda: hp.pack_head_x16(z, r=4), cs._head_pack_work(z),
         lambda: cs._head_pack_chain(z, 4), "library chain")

    import numpy as np
    from waifu2x_tensorrt_tpu_torch.ops.mma_probe import mma_probe
    from waifu2x_tensorrt_tpu_torch.probes import int8_probe as ip

    rng = np.random.default_rng(0)  # the probe's draws, in its order
    for name, m, k, n in ip.SHAPES[:2]:
        a8, b8, abf, bbf = ip.make_inputs(m, k, n, rng, "cuda")
        int_mm, mm = ip.library_calls(a8, b8, abf, bbf)
        ops = 2.0 * m * k * n * ip.R
        for label, a, b, lib, peak in (("bf16", abf, bbf, mm, ip.BF16_PEAK),
                                       ("int8", a8, b8, int_mm,
                                        ip.INT8_PEAK)):
            a2 = ip.stack2(a)
            ms = ip.time_call(lambda: mma_probe(a2, b, ip.R))
            lm = ip.R * ip.time_call(lib)
            print(f"kernel F {label} {name} R {ip.R}: {ms:.4f} ms "
                  f"(bound {1e3 * ops / peak:.4f} ms by operations, "
                  f"{100 * ops / (ms * 1e-3) / peak:.1f}% of the dense "
                  f"peak); R x one library call {lm:.4f} ms", flush=True)

    try:
        from waifu2x_tensorrt_tpu_torch.ops import hat_attention as ha
    except ImportError:  # a version without kernel G
        return 0
    _kernel_g(cs, torch, ha, show)
    _library_rows(cs, torch, F)
    try:
        from waifu2x_tensorrt_tpu_torch.ops import cunet_epilogue as ce
    except ImportError:  # a version without kernel H
        return 0
    for dtype in (torch.bfloat16, torch.float32):
        name = "bf16" if dtype == torch.bfloat16 else "fp32"
        for _tag, shape, crop, act, clamp in cs.EPILOGUE_CASES:
            conv, bias, skip = cs._epilogue_inputs(torch, shape, crop, dtype,
                                                   seed=shape[1])
            kw = {"act": act, "skip": skip, "crop": crop or 0,
                  "clamp": clamp}
            pm = cs._median_ms(lambda: ce.bias_act_plain(conv, bias, **kw))
            show(f"kernel H {name} {shape} "
                 f"{cs._epilogue_label(crop, act, clamp)}, plain twin "
                 f"{pm:.4f} ms",
                 lambda: ce.bias_act(conv, bias, **kw),
                 (cs._epilogue_work(shape, crop, conv.element_size()),),
                 lambda: ce.epilogue_ops(conv, bias, **kw), "torch ops")
            del conv, bias, skip
            torch.cuda.empty_cache()
    try:
        from waifu2x_tensorrt_tpu_torch.ops import hat_norm as hn
    except ImportError:  # a version without kernel I
        return 0
    c = cs.NORM_SHAPE[-1]
    for mode, variant in enumerate(cs.NORM_MAPS):
        x, r, z, s, w, b = cs._add_norm_inputs(torch, cs.NORM_SHAPE,
                                               variant, seed=18 + mode)
        kw = {"z": z, "s": s}
        pm = cs._median_ms(lambda: hn.add_norm_plain(x, r, w, b, 1e-5,
                                                     **kw))
        show(f"kernel I bf16 {variant} {cs.NORM_SHAPE}, plain twin "
             f"{pm:.4f} ms",
             lambda: hn.add_norm(x, r, w, b, 1e-5, **kw),
             (cs._add_norm_work(cs.NORM_SHAPE, variant),),
             lambda: F.layer_norm(x, (c,), w, b, 1e-5), "F.layer_norm")
        if hasattr(hn.add_norm, "padded_launches"):
            p = _trunk_pitch()
            px, pr, pz, ps = (None if t is None else F.pad(t, (0, p - c))
                              for t in (x, r, z, s))
            show(f"kernel I bf16 {variant} {cs.NORM_SHAPE} at pitch {p}",
                 lambda: hn.add_norm(px, pr, w, b, 1e-5, z=pz, s=ps),
                 (cs._add_norm_work(cs.NORM_SHAPE, variant),))
            del px, pr, pz, ps
        del x, r, z, s, w, b
        torch.cuda.empty_cache()
    if hasattr(ha, "RECT"):
        _dat_kernels(cs, torch, ha, show)
    return 0


def _dat_kernels(cs, torch, ha, show):
    """G's row on DAT's split windows, shifted, and J's row."""
    from waifu2x_tensorrt_tpu_torch.ops import channel_attention as ca

    qkv, _ = cs._hat_inputs(torch, 16, 256, 256, 180, 6, 0, seed=21)
    q16 = qkv.bfloat16()
    del qkv
    g = torch.Generator(device="cuda").manual_seed(21)
    table = 0.2 * torch.randn((ha.table_rows(ha.RECT, 0), 6), generator=g,
                              device="cuda")
    kw = {"num_heads": 6, "window": ha.RECT, "shift": (4, 16),
          "split": True}
    pm = cs._median_ms(lambda: ha.hat_attention_plain(q16, table, **kw),
                       iters=3, warmup=1)
    show(f"kernel G-rect bf16 8x32 / 32x8 shift (4, 16) (16, 256, 256, "
         f"540), plain twin {pm:.4f} ms",
         lambda: ha.hat_attention(q16, table, **kw),
         cs._hat_work(16, 256, 256, 180, 6, 0))
    wide = _at_trunk_pitch(torch, q16) if _takes_pitch(ha) else None
    if wide is not None:
        show(f"kernel G-rect bf16 8x32 / 32x8 shift (4, 16) at pitch "
             f"{wide.shape[-1] // 3}",
             lambda: ha.hat_attention(wide, table, channels=180, **kw),
             cs._hat_work(16, 256, 256, 180, 6, 0))
    tau = torch.full((6,), 8.0, device="cuda")
    pm = cs._median_ms(lambda: ca.channel_attention_plain(q16, tau,
                                                          num_heads=6),
                       iters=3, warmup=1)
    tokens = 16 * 256 * 256
    work = (tokens * 4 * 180 * 2, 2 * 2 * tokens * 180 * 30, 0)
    show(f"kernel J bf16 (16, 256, 256, 540), plain twin {pm:.4f} ms",
         lambda: ca.channel_attention(q16, tau, num_heads=6), work)
    if wide is not None:
        show(f"kernel J bf16 at pitch {wide.shape[-1] // 3}",
             lambda: ca.channel_attention(wide, tau, num_heads=6,
                                          channels=180), work)


# HAT's and DAT's trunk width and the token GEMMs of a block, (K, N) at
# pitch C, on a chunk of the 480p cells (16 tiles of 256 x 256)
TRUNK = 180
TOKENS = 16 * 256 * 256
TRUNK_GEMMS = (("qkv", TRUNK, 3 * TRUNK), ("proj", TRUNK, TRUNK),
               ("fc1", TRUNK, 2 * TRUNK), ("fc2", 2 * TRUNK, TRUNK))
# the 3x3 convs on the trunk: (Cin, Cout); 60 is the CAB's inner width
TRUNK_CONVS = ((TRUNK, TRUNK // 3), (TRUNK // 3, TRUNK), (TRUNK, TRUNK))


def _pitch(c: int, multiple: int) -> int:
    return -(-c // multiple) * multiple


def _trunk_pitch() -> int:
    """The pitch of the package's HAT and DAT trunk at C = 180."""
    from waifu2x_tensorrt_tpu_torch.models.layers import pitch

    return pitch(TRUNK, "cuda")


def _takes_pitch(ha) -> bool:
    """Does this version's kernel G (and J beside it) take a pitch?"""
    import inspect

    return "channels" in inspect.signature(ha.hat_attention).parameters


def _at_trunk_pitch(torch, qkv):
    """(..., 3C) qkv carried at the trunk's pitch, zero pads."""
    p = _trunk_pitch()
    return torch.nn.functional.pad(qkv.unflatten(-1, (3, TRUNK)),
                                   (0, p - TRUNK)).flatten(-2)


def _device_kernels(torch, fn, top=2):
    """Names of the ``top`` kernels of ``fn`` by device time, one call
    under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(prof.key_averages(),
                  key=lambda e: -getattr(e, "device_time_total",
                                         getattr(e, "cuda_time_total", 0)))
    return [e.key for e in rows[:top]]


def _library_rows(cs, torch, F):
    """The trunk's library GEMMs and 3x3 convs on a chunk of tokens at
    row pitch C = 180 (``a`` / ``w`` rows of 360 bytes: 8- not 16-byte
    aligned), against pitch 184 (C up to a multiple of 8) and 192 (of
    64), a width of 3C as three parts of the pitch, beside the bytes
    bound of the real (pitch-C) work and the kernels the library
    picked."""
    g = torch.Generator(device="cuda").manual_seed(22)

    def rand(*shape):
        return torch.randn(shape, generator=g, device="cuda",
                           dtype=torch.bfloat16)

    for name, k, n in TRUNK_GEMMS:
        work = 2 * (TOKENS * (k + n) + k * n)
        flops = 2 * TOKENS * k * n
        for mult in (1, 8, 64):
            kp = k if k == 2 * TRUNK else _pitch(k, mult)
            np_ = n if n == 2 * TRUNK else (n // TRUNK) * _pitch(TRUNK, mult)
            a, w, b = rand(TOKENS, kp), rand(np_, kp), rand(np_)
            ms = cs._median_ms(lambda: F.linear(a, w, b))
            bms, by = cs._bound(work, flops)
            names = _device_kernels(torch, lambda: F.linear(a, w, b), 1)
            print(f"library GEMM {name} ({TOKENS} x {k}) -> {n} at "
                  f"({TOKENS} x {kp}) -> {np_}: {ms:.4f} ms (bound "
                  f"{bms:.4f} ms by {by} at pitch C, {100 * bms / ms:.1f}% "
                  f"of it); {names[0]}", flush=True)
            del a, w, b
    for cin, cout in TRUNK_CONVS:
        work = 2 * (TOKENS * (cin + cout) + 9 * cin * cout)
        flops = 2 * TOKENS * 9 * cin * cout
        for mult in (1, 8, 64):
            ci = cin if cin != TRUNK else _pitch(cin, mult)
            co = cout if cout != TRUNK else _pitch(cout, mult)
            x = rand(16, ci, 256, 256).contiguous(
                memory_format=torch.channels_last)
            w = rand(co, ci, 3, 3).contiguous(
                memory_format=torch.channels_last)
            b = rand(co)
            ms = cs._median_ms(lambda: F.conv2d(x, w, b, padding=1))
            bms, by = cs._bound(work, flops)
            names = _device_kernels(
                torch, lambda: F.conv2d(x, w, b, padding=1), 3)
            print(f"library conv3x3 {cin} -> {cout} at {ci} -> {co} "
                  f"(16, 256, 256): {ms:.4f} ms (bound {bms:.4f} ms by "
                  f"{by} at pitch C, {100 * bms / ms:.1f}% of it); "
                  f"{' | '.join(names)}", flush=True)
            del x, w, b
    torch.cuda.empty_cache()


def _kernel_g(cs, torch, ha, show):
    """G's rows: self attention with shift 8, and overlapping."""
    for shift, ov in ((8, 0), (0, 4)):
        qkv, table = cs._hat_inputs(torch, 16, 256, 256, 180, 6, ov,
                                    seed=ov + shift)
        q16 = qkv.bfloat16()
        kw = {"num_heads": 6, "shift": shift, "overlap": ov}
        name = "overlapping" if ov else f"self shift {shift}"
        pm = cs._median_ms(lambda: ha.hat_attention_plain(q16, table, **kw),
                           iters=3, warmup=1)
        show(f"kernel G bf16 {name} (16, 256, 256, 540), plain twin "
             f"{pm:.4f} ms",
             lambda: ha.hat_attention(q16, table, **kw),
             cs._hat_work(16, 256, 256, 180, 6, ov),
             cs._hat_sdpa(torch, q16, table, 6, shift, ov))
        if _takes_pitch(ha):
            wide = _at_trunk_pitch(torch, q16)
            show(f"kernel G bf16 {name} at pitch {wide.shape[-1] // 3}",
                 lambda: ha.hat_attention(wide, table, channels=180, **kw),
                 cs._hat_work(16, 256, 256, 180, 6, ov))
            del wide


if __name__ == "__main__":
    sys.exit(main())
