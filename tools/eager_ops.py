"""Which torch op launched each device kernel of one eager model chunk, on
one NVIDIA GPU.

    python3 tools/eager_ops.py [--root DIR] [--model cunet/art] [--scale 2]
        [--noise 1] [--precision fp16|tf32] [--batch 16] [--tile 256]
        [--shapes]

Inside a captured CUDA graph a trace sees only kernel names. This loads a
model through ``Upscaler`` (seeded random weights; the defaults are the
cunet2x-1080p-stream cell's model, bf16, tile 256, batch 16), calls its
chunk program's eager function on ``--batch`` seeded tiles of ``--tile``
(once to warm up, then once under ``torch.profiler`` with CPU and CUDA
activities) and puts each device kernel to the aten op that launched it,
named by its path from the outermost aten op (what the model's code
called) to the innermost (what launched the kernel): ``aten::conv2d >
aten::add_`` is a conv's bias add. ``--shapes`` splits each path by the
innermost op's input shapes (a multiply by a scalar apart from one by a
broadcast vector). Kernels launched outside any aten op (the port's own
kernels, through ctypes) are listed by name under "outside any aten op";
the profiler links some of them, and some kernels of aten ops, to CUDA
runtime calls as well, so only events under an aten op are read.

Prints the card's name and power limit, then one line an op path (device
ms of the chunk, launches, share of the chunk's device time) and beneath
it each kernel with its ms, then the chunk's device total. ``--root DIR``
imports ``waifu2x_tensorrt_tpu_torch`` from DIR (an unpacked other
commit), so two versions' splits can be read in one call. Needs a CUDA
device; exits 1 without one.
"""

from __future__ import annotations

import argparse
import collections
import subprocess
import sys
from pathlib import Path


def op_path(e, shapes: bool) -> str | None:
    """The aten ops from the outermost above the profiler event ``e`` down
    to ``e``, joined by " > "; with ``shapes``, ``e``'s input shapes. None
    where no aten op is on the path."""
    names, up = [], e
    while up is not None:
        if up.name.startswith("aten::"):
            names.append(up.name)
        up = up.cpu_parent
    if not names:
        return None
    path = " > ".join(reversed(names))
    if shapes:
        path += f" {[list(s) for s in e.input_shapes or []]}"
    return path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[1])
    ap.add_argument("--model", default="cunet/art")
    ap.add_argument("--scale", type=int, default=2)
    ap.add_argument("--noise", type=int, default=1)
    ap.add_argument("--precision", choices=("fp16", "tf32"), default="fp16")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--tile", type=int, default=256)
    ap.add_argument("--shapes", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(args.root.resolve()))

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("eager_ops: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from waifu2x_tensorrt_tpu_torch.engine.config import (
        Precision,
        RenderConfig,
    )
    from waifu2x_tensorrt_tpu_torch.engine.upscaler import Upscaler

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    precision = Precision(args.precision)
    up = Upscaler(allow_random_init=True, device="cuda:0")
    up.load(args.model, args.scale, args.noise, RenderConfig(
        precision=precision, batch_size=args.batch, height=args.tile,
        width=args.tile, scaling=args.scale, overlap=(1 / 16, 1 / 16)))
    model = up._pipeline.model_prog.fn
    tiles = torch.rand((args.batch, args.tile, args.tile, 3),
                       generator=torch.Generator().manual_seed(18))
    tiles = tiles.to("cuda", precision.dtype)
    with torch.inference_mode():
        model(tiles)  # warm: cuDNN's choices, the kernel library
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=args.shapes) as prof:
            model(tiles)
            torch.cuda.synchronize()
    print(f"card: {smi}; package from {args.root}; {args.model} "
          f"{args.scale}x noise {args.noise}, {args.precision}, one eager "
          f"chunk of {args.batch} tiles of {args.tile}", flush=True)
    by_name = collections.defaultdict(lambda: [0.0, 0])  # us, launches
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name][0] += e.time_range.elapsed_us()
            by_name[e.name][1] += 1
    paths = collections.defaultdict(lambda: collections.defaultdict(
        lambda: [0.0, 0]))
    attributed = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        p = op_path(e, args.shapes)
        if p is None:
            continue
        for k in e.kernels:
            for into in (paths[p][k.name], attributed[k.name]):
                into[0] += k.duration
                into[1] += 1
    for name, (us, n) in by_name.items():
        rest, rest_n = us - attributed[name][0], n - attributed[name][1]
        if rest > 0.5 or rest_n > 0:
            paths["outside any aten op"][name] = [rest, rest_n]
    total = sum(us for us, _n in by_name.values())
    print("op path: device ms of the chunk, launches; kernels (ms)")
    for p, kernels in sorted(paths.items(),
                             key=lambda kv: -sum(v[0] for v in
                                                 kv[1].values())):
        ms = sum(v[0] for v in kernels.values()) / 1e3
        n = sum(v[1] for v in kernels.values())
        print(f"  {p}: {ms:.3f} ms, {n} launches "
              f"({100 * ms * 1e3 / total:.1f}%)", flush=True)
        for name, (us, _k) in sorted(kernels.items(),
                                     key=lambda kv: -kv[1][0]):
            print(f"      {us / 1e3:8.3f}  {name[:150]}")
    print(f"device total of the chunk: {total / 1e3:.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
