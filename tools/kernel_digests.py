"""SHA-256 digests of the kernels' outputs on ``chip_smoke.py``'s inputs,
from this or another version of the package, on one NVIDIA GPU.

    python3 tools/kernel_digests.py [--root DIR] [--dtype bf16|fp32|all]

Runs each kernel through its wrapper and prints one line per case, the
digest of the output's bytes:

- B (on prepared operands) and A at (BW 4096, C 96), (1024, 192) and
  (37, 96), shifts 0 and 4, on ``chip_smoke._block_inputs``; E on the
  same qkv values in its unpacked layout;
- C on ``chip_smoke._finalize_case`` (the 720p -> 4x plan);
- D at r 4 and 2 on phase 8's seeded (16, 256, 256, 3 r^2) values;
- F at the probe's four shapes, 5 serialized products;
- the flagship model (``chip_smoke._load``: swin_unet/art 4x, seeded
  weights) called eagerly on a seeded chunk of 4 tiles of 256, and
  rendering a seeded 720p frame through its captured chunk programs,
  bf16 (the CLI's fp16) and fp32 (tf32);
- cunet/art 2x noise 1 (``chip_smoke._cunet_weights``: seeded unit-scale
  weights; tile 256, batch 16) the same way: called eagerly on a seeded
  chunk of 4 tiles of 256, and rendering a seeded 1080p frame through
  its captured chunk programs, bf16 and fp32. fp32 runs with cuDNN's
  deterministic algorithms: the one cuDNN picks by default for UNet1's
  fp32 transposed-conv head sums in an order that changes from call to
  call, so without them two fp32 runs of one version differ.

bf16 (the default) runs the bf16 and integer paths; fp32 the fp32 ones
(TF32 off). ``--root DIR`` imports ``waifu2x_tensorrt_tpu_torch`` from DIR
(an unpacked other version: ``git archive``) while the inputs stay this
checkout's, so two versions' lines can be compared with ``diff``: equal
lines are byte-identical outputs. Needs a CUDA device and nvcc; exits 1
without a device.
"""

from __future__ import annotations

import argparse
import hashlib
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _digest(t) -> str:
    import torch

    t = t.detach().contiguous()
    torch.cuda.synchronize()
    return hashlib.sha256(t.view(torch.uint8).cpu().numpy().tobytes()
                          ).hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=ROOT)
    ap.add_argument("--dtype", choices=("bf16", "fp32", "all"),
                    default="bf16")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs  # this checkout's inputs

    sys.path.insert(0, str(args.root.resolve()))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_digests: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from waifu2x_tensorrt_tpu_torch.ops import head_pack as hp
    from waifu2x_tensorrt_tpu_torch.ops import swin_block as sb
    from waifu2x_tensorrt_tpu_torch.ops import window_attention as wa
    from waifu2x_tensorrt_tpu_torch.ops.mma_probe import mma_probe
    from waifu2x_tensorrt_tpu_torch.probes import int8_probe as ip

    dtypes = {"bf16": [torch.bfloat16], "fp32": [torch.float32],
              "all": [torch.bfloat16, torch.float32]}[args.dtype]

    def show(label, out):
        print(f"{label}: {_digest(out)}", flush=True)

    for bw, c, nh in ((4096, 96, 3), (1024, 192, 6), (37, 96, 3)):
        x, qkv, params, bias, flags = cs._block_inputs(
            torch, bw, c, nh, torch.float32, seed=c + bw)
        for dt in dtypes:
            name = "bf16" if dt == torch.bfloat16 else "fp32"
            ops = sb.block_operands(params, bias, dt)
            xs, qs = x.to(dt), qkv.to(dt)
            heads = [t.reshape(bw, 64, nh, 32).transpose(1, 2).contiguous()
                     for t in qs.chunk(3, dim=-1)]
            for shift in (0, 4):
                case = f"{name} BW {bw} C {c} shift {shift}"
                show(f"B {case}", sb.swin_block_prepared(xs, ops, flags,
                                                         shift=shift))
                show(f"A {case}", wa.fused_window_attention_qkv(
                    qs, bias, flags, num_heads=nh, shift=shift))
                show(f"E {case}", wa.fused_window_attention(
                    *heads, bias, flags, shift=shift))
    from waifu2x_tensorrt_tpu_torch.engine.config import Precision

    tiles = torch.rand((4, 256, 256, 3), generator=torch.Generator(
    ).manual_seed(15)).cuda()
    frame = np.random.default_rng(15).integers(0, 256, (720, 1280, 3),
                                               np.uint8)
    for dt in dtypes:
        name = "bf16" if dt == torch.bfloat16 else "fp32"
        up = cs._load(torch, Precision.FP16 if dt == torch.bfloat16
                      else Precision.TF32)
        with torch.inference_mode():
            show(f"model swin_unet/art 4x {name} (4, 256, 256, 3)",
                 up._pipeline.model_prog.fn(tiles.to(dt)))
        show(f"render swin_unet/art 4x {name} 720p",
             torch.from_numpy(up.render(frame)))
    root = cs._cunet_weights(2, 1, seed=18)
    frame = np.random.default_rng(18).integers(0, 256, (1080, 1920, 3),
                                               np.uint8)
    for dt in dtypes:
        name = "bf16" if dt == torch.bfloat16 else "fp32"
        torch.backends.cudnn.deterministic = dt == torch.float32
        up = cs._upscaler("cunet/art", 2, 1, Precision.FP16
                          if dt == torch.bfloat16 else Precision.TF32, 256,
                          16, models_dir=root)
        with torch.inference_mode():
            show(f"model cunet/art 2x {name} (4, 256, 256, 3)",
                 up._pipeline.model_prog.fn(tiles.to(dt)))
        show(f"render cunet/art 2x {name} 1080p",
             torch.from_numpy(up.render(frame)))
    torch.backends.cudnn.deterministic = False
    if torch.bfloat16 in dtypes:
        fin, plan, outs = cs._finalize_case(torch)
        show(f"C 720p -> 4x (T {plan.tile_count})", fin(*outs))
        gen = torch.Generator(device="cuda").manual_seed(8)
        for r in (4, 2):
            z = torch.rand((16, 256, 256, 3 * r * r), generator=gen,
                           device="cuda") * 1.6 - 0.3
            for zt in (z.bfloat16(), z):
                show(f"D r {r} {str(zt.dtype)[6:]}", hp.pack_head_x16(zt, r=r))
        rng = np.random.default_rng(0)  # the probe's draws, in its order
        for shape, m, k, n in ip.SHAPES:
            a8, b8, abf, bbf = ip.make_inputs(m, k, n, rng, "cuda")
            for label, a, b in (("bf16", abf, bbf), ("int8", a8, b8)):
                show(f"F {shape} {label}", mma_probe(ip.stack2(a), b, 5))
    return 0


if __name__ == "__main__":
    sys.exit(main())
