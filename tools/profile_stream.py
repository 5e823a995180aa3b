"""Profile the port's streamed flagship render on one NVIDIA GPU.

    python3 tools/profile_stream.py [--frames 8] [--trace PATH] [--root DIR]

Loads swin_unet/art 4x noise 3, tile 256, batch 16, bf16 (the CLI's fp16)
with seeded random weights through ``Upscaler`` (kernel B on every Swin
block), opens a stream for 720p frames and runs its warm cycle. It first
renders phase 5's first frame and streams ``chip_smoke.py`` phase 5's 10
frames twice by phase 5's method (unprofiled, outputs kept, host clock
ending in a synchronize; the method and frames are this checkout's, so
``--root`` compares two versions by one method), then submits ``--frames`` seeded 720p frames and flushes under
``torch.profiler`` (CPU and CUDA activities). Prints, after the card's
name and power limit:

- phase 5's streamed rate, two passes: ms for the 10 frames and output
  MP/s;

- wall ms of the profiled window (host clock, ending in a synchronize),
  device busy ms (union of the intervals of every device event) and the
  device's idle share;
- device time by group (kernel B, kernel C, roll, copies, convolutions
  and GEMMs, host-to-device copies, the rest), and the 20 device kernels
  with the most time;
- per 16-tile chunk: kernel launches (``cudaLaunchKernel`` calls) and the
  aten operators called most often.

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
    ("roll", ("roll",)),
    ("copies (layout, dtype)", ("copy", "Copy")),
    ("host-to-device copies", ("HtoD",)),
    ("convolutions and GEMMs", ("conv", "xmma", "cutlass", "cudnn", "gemm",
                                "sm90_", "nchw", "nhwc")),
)


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
    print(f"card: {smi}; package from {args.root}", flush=True)
    up = Upscaler(allow_random_init=True, device="cuda:0")
    cfg = RenderConfig(precision=Precision.FP16, batch_size=16, height=256,
                       width=256, scaling=4, overlap=(1 / 16, 1 / 16))
    up.load("swin_unet/art", 4, 3, cfg)
    rng = np.random.default_rng(5)
    frames = [rng.integers(0, 256, (720, 1280, 3), np.uint8)
              for _ in range(args.frames)]
    stream = up.open_stream((720, 1280))
    stream.warm()
    torch.cuda.synchronize()

    first, rate_frames = cs._phase5_frames()
    up.render(first)  # as phase 5, which renders a frame before its stream
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
        print(f"phase 5's stream, unprofiled, pass {rep + 1}: "
              f"{len(rate_frames)} frames in {rate_s * 1e3:.1f} ms, "
              f"{len(rate_frames) * 2880 * 5120 / rate_s / 1e6:.2f} output "
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
    chunks = -(-args.frames * 18 // 16)  # 720p plans to 18 tiles a frame

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
    print(f"{args.frames} streamed 720p frames ({chunks} chunks of 16 "
          f"tiles): wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, "
          f"idle {wall_ms - busy_ms:.1f} ms "
          f"({100 * (1 - busy_ms / wall_ms):.1f}% of wall), "
          f"{args.frames * 2880 * 5120 / wall_ms / 1e3:.2f} output MP/s "
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
    print(f"per chunk: {launches / chunks:.1f} kernel launches; aten "
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
