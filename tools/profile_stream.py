"""Profile the port's streamed render of one cell on one NVIDIA GPU.

    python3 tools/profile_stream.py [--cell NAME] [--frames 8]
                                    [--trace PATH] [--root DIR]

Cells (``--cell``, bf16 (the CLI's fp16) unless named ``-tf32``, seeded
random weights, loaded through ``Upscaler``):

- ``flagship`` (default): swin_unet/art 4x noise 3, tile 256, batch 16,
  720p frames (kernel B on every Swin block);
- ``cunet-whole-frame``: cunet/art 2x noise 1, the whole 512 x 512 frame
  as one tile, batch 16 (``chip_smoke.py`` phase 11b, bench.py config 1c);
- ``cunet-1080p``: cunet/art 2x noise 1, tile 256, batch 16, 1080p
  frames (phase 11c, config 1d);
- ``art-scan-tta``: swin_unet/art_scan 4x noise 3, tile 128, batch 8,
  8-way TTA, 512 x 512 frames (phase 12a, config 3);
- ``graph-exact``: the flagship's configuration served from a seeded
  full-width ``.onnx`` export (``tests/torch_mirror.py``, written under
  ``build/profile_stream_models/``) through its own parsed graph
  (``load(..., graph_exact=True)``: ``GraphModule``, torch ops under
  ``torch.func.vmap``; ``chip_smoke.py`` phase 14c);
- ``flagship-tf32``, ``graph-exact-tf32``: the two above in the CLI's
  tf32 precision (fp32 compute, TF32 off in cuBLAS and cuDNN, as the CLI
  sets it): kernel B's fp32 kernel, and the graph's fp32 torch ops;
- ``hat-480p``: hat/photo 4x, tile 256, batch 16, 720 x 480 frames (the
  hat4x-480p-stream cell's model and frames; kernels G and I);
- ``dat-480p``: dat/photo 4x the same way (the dat4x-480p-stream cell's
  model; kernels G, I and J).

Opens a stream for the cell's frames and runs its warm cycle. It first
reads the unprofiled streamed rate twice (outputs kept, host clock ending
in a synchronize): for the flagship, of ``chip_smoke.py`` phase 5's first
frame rendered and its 10 frames streamed, by phase 5's method (the
method and frames are this checkout's, so ``--root`` compares two versions
by one method); for the other cells, of the ``--frames`` frames. Then it
submits ``--frames`` seeded frames and flushes under ``torch.profiler``
(CPU and CUDA activities). Prints, after the card's name and power limit:

- the unprofiled streamed rate, two passes: ms for the frames and output
  MP/s;

- wall ms of the profiled window (host clock, ending in a synchronize),
  device busy ms (union of the intervals of every device event) and the
  device's idle share;
- device time by group (kernels B, C, G, H, I and J, roll, TTA flips,
  copies, convolutions and GEMMs (cuBLAS's Hopper GEMMs are ``nvjet_*``),
  host-to-device copies, the rest), and the 20 device kernels with the
  most time;
- per chunk of the cell's batch: kernel launches (``cudaLaunchKernel``
  calls) and CUDA-graph launches (``cudaGraphLaunch``: a captured chunk
  program's kernels are launched by its replay, not from the host) from
  the host, and the aten operators called most often.

``--root DIR`` imports ``waifu2x_tensorrt_tpu_torch`` from DIR (an
unpacked other commit, to compare two versions in one call). ``--trace``
writes the Chrome trace. Needs a CUDA device; exits 1 without one.
"""

from __future__ import annotations

import argparse
import collections
import subprocess
import sys
import time
from pathlib import Path

GROUPS = (  # (label, substrings of the device event name), first match
    ("kernel B swin_block", ("swin_block",)),
    ("kernel C finalize_gather", ("finalize_gather",)),
    ("kernel G hat_attention", ("hat_attention",)),
    ("kernel H bias_act", ("bias_act",)),
    ("kernel I add_norm", ("add_norm",)),
    ("kernel J channel_attention", ("channel_attention",)),
    ("roll", ("roll_cuda",)),  # not "unrolled_elementwise_kernel"
    ("TTA flips", ("flip",)),
    ("copies (layout, dtype)", ("copy", "Copy")),
    ("host-to-device copies", ("HtoD",)),
    ("convolutions and GEMMs", ("conv", "xmma", "cutlass", "cudnn", "gemm",
                                "sm90_", "nchw", "nhwc", "nvjet")),
)


# name: (family, scale, noise, tile, batch, tta, frame (H, W), precision)
CELLS = {
    "flagship": ("swin_unet/art", 4, 3, 256, 16, False, (720, 1280), "fp16"),
    "cunet-whole-frame": ("cunet/art", 2, 1, 0, 16, False, (512, 512),
                          "fp16"),
    "cunet-1080p": ("cunet/art", 2, 1, 256, 16, False, (1080, 1920), "fp16"),
    "art-scan-tta": ("swin_unet/art_scan", 4, 3, 128, 8, True, (512, 512),
                     "fp16"),
    "graph-exact": ("swin_unet/art", 4, 3, 256, 16, False, (720, 1280),
                    "fp16"),
    "flagship-tf32": ("swin_unet/art", 4, 3, 256, 16, False, (720, 1280),
                      "tf32"),
    "graph-exact-tf32": ("swin_unet/art", 4, 3, 256, 16, False, (720, 1280),
                         "tf32"),
    "hat-480p": ("hat/photo", 4, -1, 256, 16, False, (480, 720), "fp16"),
    "dat-480p": ("dat/photo", 4, -1, 256, 16, False, (480, 720), "fp16"),
}


def _group(name: str) -> str:
    for label, keys in GROUPS:
        if any(k in name for k in keys):
            return label
    return "other (adds, activations, clamp, gather)"


def _busy_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", choices=tuple(CELLS), default="flagship")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--trace", type=Path, default=None)
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[1])
    args = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs  # this checkout's phase-5 frames

    sys.path.insert(0, str(args.root.resolve()))

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_stream: no CUDA device available", file=sys.stderr)
        return 1
    from waifu2x_tensorrt_tpu_torch.engine.config import (
        Precision,
        RenderConfig,
    )
    from waifu2x_tensorrt_tpu_torch.engine.upscaler import Upscaler

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    family, scale, noise, tile, batch, tta, hw, prec = CELLS[args.cell]
    out_px = hw[0] * scale * hw[1] * scale
    print(f"card: {smi}; package from {args.root}; cell {args.cell}: "
          f"{family} {scale}x noise {noise}, tile {tile or 'whole frame'}, "
          f"batch {batch}, tta {tta}, {hw[0]}x{hw[1]} frames, {prec}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False  # as the CLI's tf32
    torch.backends.cudnn.allow_tf32 = False
    cfg = RenderConfig(precision=Precision(prec), batch_size=batch,
                       height=tile, width=tile, scaling=scale,
                       overlap=(1 / 16, 1 / 16), tta=tta)
    if args.cell.startswith("graph-exact"):
        from waifu2x_tensorrt_tpu_torch.models import registry

        models = Path(__file__).resolve().parents[1] / "build" / \
            "profile_stream_models"
        art = registry.weights_path(models, family, scale,
                                    noise).with_suffix(".onnx")
        art.parent.mkdir(parents=True, exist_ok=True)
        cs._mirror().export_torch_swin(art, scale=scale, base_dim=96,
                                       depths=(2, 2, 6, 2, 2), tile=tile,
                                       seed=14)
        up = Upscaler(models_dir=models, device="cuda:0")
        up.load(family, scale, noise, cfg, graph_exact=True)
    else:
        up = Upscaler(allow_random_init=True, device="cuda:0")
        up.load(family, scale, noise, cfg)
    rng = np.random.default_rng(5)
    frames = [rng.integers(0, 256, (*hw, 3), np.uint8)
              for _ in range(args.frames)]
    stream = up.open_stream(hw)
    stream.warm()
    torch.cuda.synchronize()

    if args.cell.startswith("flagship"):
        first, rate_frames = cs._phase5_frames()
        up.render(first)  # as phase 5, which renders a frame first
        label = "phase 5's stream"
    else:
        rate_frames, label = frames, "stream"
    for rep in range(2):
        t0 = time.perf_counter()
        kept = []
        for f in rate_frames:
            kept.extend(stream.submit(f))
        kept.extend(stream.flush())
        torch.cuda.synchronize()
        rate_s = time.perf_counter() - t0
        if len(kept) != len(rate_frames):
            raise AssertionError(f"{len(kept)} outputs for "
                                 f"{len(rate_frames)} frames")
        print(f"{label}, unprofiled, pass {rep + 1}: "
              f"{len(rate_frames)} frames in {rate_s * 1e3:.1f} ms, "
              f"{len(rate_frames) * out_px / rate_s / 1e6:.2f} output "
              "MP/s", flush=True)
        del kept

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        outs = []
        for f in frames:
            outs.extend(stream.submit(f))
        outs.extend(stream.flush())
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if len(outs) != args.frames:
        raise AssertionError(f"{len(outs)} outputs for {args.frames} frames")
    steps = up._pipeline.get(hw)[2].tile_count * (8 if tta else 1)
    chunks = -(-args.frames * steps // batch)

    dev = collections.defaultdict(lambda: [0.0, 0])
    host = collections.Counter()
    intervals = []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            intervals.append((e.time_range.start, e.time_range.end))
            d = dev[e.name]
            d[0] += e.time_range.elapsed_us()
            d[1] += 1
        else:
            host[e.name] += 1
    busy_ms = _busy_us(intervals) / 1e3
    print(f"{args.frames} streamed frames ({chunks} chunks of {batch} "
          f"steps): wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, "
          f"idle {wall_ms - busy_ms:.1f} ms "
          f"({100 * (1 - busy_ms / wall_ms):.1f}% of wall), "
          f"{args.frames * out_px / wall_ms / 1e3:.2f} output MP/s "
          "under the profiler", flush=True)
    groups = collections.defaultdict(lambda: [0.0, 0])
    for name, (us, n) in dev.items():
        g = groups[_group(name)]
        g[0] += us
        g[1] += n
    print("device time by group: ms, events, share of wall")
    for label, (us, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  {label:42s} {us / 1e3:9.3f} {n:6d} "
              f"{100 * us / 1e3 / wall_ms:6.1f}%")
    print("top device kernels: ms, events, name")
    for name, (us, n) in sorted(dev.items(), key=lambda kv: -kv[1][0])[:20]:
        print(f"  {us / 1e3:9.3f} {n:6d}  {name[:110]}")
    launches = sum(n for name, n in host.items() if "LaunchKernel" in name)
    graphs = sum(n for name, n in host.items() if "GraphLaunch" in name)
    print(f"per chunk: {launches / chunks:.1f} kernel launches and "
          f"{graphs / chunks:.1f} graph launches from the host; aten "
          "operators called most often (calls per chunk):")
    aten = [(n, name) for name, n in host.items() if name.startswith("aten::")]
    for n, name in sorted(aten, reverse=True)[:15]:
        print(f"  {n / chunks:8.1f}  {name}")
    if args.trace is not None:
        args.trace.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(args.trace))
        print(f"trace: {args.trace}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
